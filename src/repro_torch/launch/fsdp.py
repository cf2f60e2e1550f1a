"""Sharded parameters: the port's counterpart of GSPMD placing one
participant's leaves by ``launch.shardings.param_specs``' ``fsdp`` entries.

The reference puts each leaf on its mesh by ``param_specs`` and lets the
partitioner all-gather an ``fsdp``-sharded weight where it is used and
reduce the gradients back to their shards. The port runs one participant's
``data`` positions as *groups* (``launch.mesh.participant_groups``: a
device and a contiguous run of positions; an explicit list may repeat a
device, as a ``ClientsMesh`` may, which is how two groups share one card or
the CPU):

* **Placement.** A parameter whose resolved spec names ``data`` splits
  along that dim into ``n_data`` equal position chunks; a group holds the
  chunks of its positions, concatenated. A dim that ``data`` does not
  divide stays whole (``shardings._resolve``'s fallback), and a whole leaf
  gets one copy on each device of the groups.
* **Gather.** A group's forward reads a block's parameters gathered whole
  on its device (:class:`GroupView`): the training forward gathers inside
  each block's checkpointed function, so the backward's recompute gathers
  again and one block's gathered weights are alive at a time (``lm_head``
  at the loss). Each chunk's gradient flows back, through the gather, to
  the chunk's own device.
* **Gradient fold.** Each group takes its equal share of the batch rows,
  in group order, and its ``n_micro`` microbatches of them. Every
  microbatch's gradient is added, in f32 and in (group, microbatch) order,
  into an accumulator that starts at zero on the owner's device (a whole
  leaf: on each device that holds a copy), which is then divided by
  ``groups * n_micro`` (:func:`step_gradients`). That is
  ``launch.train.step_gradients``' microbatch fold, so two groups of
  ``n_micro`` microbatches are bit-equal to one device's step with
  ``2 * n_micro`` on one device type.

Gradients are taken with ``torch.autograd.grad`` (no ``.grad`` field is
accumulated in the parameters' dtype), and cross-device copies are plain
``Tensor.to`` calls, which PyTorch orders on the streams of the devices
involved: no host synchronization is added between cards (a copy to the
CPU waits for its source, as every device-to-host copy does).
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import logical_rules, participant_groups
from repro_torch.models import transformer as tf


def _names_data(entry) -> bool:
    return entry == "data" or (isinstance(entry, tuple) and "data" in entry)


def n_data_of(mesh, fed_axis: str | None) -> int:
    """The positions a participant has along ``data`` (1 without one)."""
    sizes = shd.axis_sizes_of(mesh)
    return sizes["data"] if "data" in sizes and fed_axis != "data" else 1


def split_dims(model: torch.nn.Module, mesh, fed_axis: str | None) -> dict:
    """``{port parameter name: its dim split over data, or None}`` under
    ``param_specs`` with the FL (``fed_axis``) or dense rules of ``mesh``."""
    leaves = convert.reference_leaves(model)
    specs = shd.param_specs({lf.path: lf.shape for lf in leaves},
                            logical_rules(mesh, fed_axis=fed_axis),
                            shd.axis_sizes_of(mesh))
    out = {}
    for lf in leaves:
        dims = [i - len(lf.lead) for i, e in enumerate(tuple(specs[lf.path]))
                if _names_data(e)]
        for name in lf.names:
            out[name] = dims[0] if dims else None
    return out


def check_groups(groups, n_data: int) -> list:
    """``[(torch.device, range)]``: contiguous runs covering ``n_data``
    positions in order."""
    out, nxt = [], 0
    for dev, pos in groups:
        if pos.step != 1 or pos.start != nxt or len(pos) < 1:
            raise ValueError(f"groups {groups} are not contiguous runs of "
                             f"the {n_data} data positions in order")
        out.append((torch.device(dev), pos))
        nxt = pos.stop
    if nxt != n_data:
        raise ValueError(f"groups {groups} cover {nxt} of {n_data} data "
                         "positions")
    return out


def same_groups(a, b) -> bool:
    return len(a) == len(b) and all(
        da == db and pa == pb for (da, pa), (db, pb) in zip(a, b))


class ShardedLM:
    """One participant's parameters over its groups (module docstring).

    ``chunks[g][name]`` is group ``g``'s tensor of a parameter: its chunk
    along ``dims[name]``, or, for a whole leaf (``dims[name]`` None), the
    copy on the group's device (one tensor per device, shared by the groups
    there). ``meta`` is the model on the meta device: names, shapes and the
    reference's leaves. Tensors are created with ``requires_grad=False``."""

    def __init__(self, cfg: ArchConfig, groups, n_data: int, dims: dict):
        self.cfg = cfg
        self.meta = tf.init_params(cfg, device="meta")
        self.groups = check_groups(groups, n_data)
        self.n_data = n_data
        self.dims = dict(dims)
        self.shapes = {n: tuple(p.shape)
                       for n, p in self.meta.named_parameters()}
        self.dtypes = {n: p.dtype for n, p in self.meta.named_parameters()}
        for name, d in self.dims.items():
            if d is not None and self.shapes[name][d] % n_data:
                raise ValueError(f"{name}: {n_data} data positions do not "
                                 f"divide dim {d} of {self.shapes[name]}")
        self.devices = list(dict.fromkeys(d for d, _ in self.groups))
        whole = {d: {} for d in self.devices}
        self.chunks = [{} for _ in self.groups]
        for name, shape in self.shapes.items():
            for g, (dev, _) in enumerate(self.groups):
                if self.dims[name] is None:
                    if name not in whole[dev]:
                        whole[dev][name] = torch.empty(
                            shape, dtype=self.dtypes[name], device=dev)
                    self.chunks[g][name] = whole[dev][name]
                else:
                    s = list(shape)
                    s[self.dims[name]] = self.extent(g, name)[1]
                    self.chunks[g][name] = torch.empty(
                        s, dtype=self.dtypes[name], device=dev)
        self.whole = whole

    @property
    def device(self) -> torch.device:
        """The lead device: group 0's."""
        return self.groups[0][0]

    def extent(self, g: int, name: str) -> tuple[int, int]:
        """``(offset, length)`` of group ``g``'s chunk along the split dim."""
        d = self.dims[name]
        per = self.shapes[name][d] // self.n_data
        pos = self.groups[g][1]
        return pos.start * per, len(pos) * per

    def view(self, g: int) -> "GroupView":
        """Group ``g``'s view for the forward (made anew: the model keeps
        no reference to it, so dropping the model frees its tensors at
        once, without waiting for the cycle collector)."""
        return GroupView(self, g)

    def tensors(self) -> Iterable[tuple[str, torch.Tensor]]:
        """Every distinct tensor held, ``(name, tensor)``: each chunk, and
        each device's copy of a whole leaf once."""
        for name in self.shapes:
            if self.dims[name] is None:
                for dev in self.devices:
                    yield name, self.whole[dev][name]
            else:
                for c in self.chunks:
                    yield name, c[name]

    def gather(self, g: int, name: str) -> torch.Tensor:
        """``name`` whole on group ``g``'s device, differentiable: the
        chunks copied there and concatenated in group order."""
        d = self.dims[name]
        if d is None:
            return self.chunks[g][name]
        dev = self.groups[g][0]
        return torch.cat([c[name].to(dev) for c in self.chunks], d)

    @torch.no_grad()
    def full(self, name: str, device="cpu") -> torch.Tensor:
        """``name`` whole on ``device`` (no autograd)."""
        d = self.dims[name]
        if d is None:
            return self.chunks[0][name].to(device)
        return torch.cat([c[name].to(device) for c in self.chunks], d)

    def named_full(self, device="cpu"):
        """``(name, whole tensor on device)`` in the model's order, one at a
        time."""
        for name in self.shapes:
            yield name, self.full(name, device)

    @torch.no_grad()
    def load_(self, name: str, value) -> None:
        """Write the whole ``value`` (a tensor or an array) into ``name``'s
        chunks and copies."""
        value = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value)
                                else value)
        if tuple(value.shape) != self.shapes[name]:
            raise ValueError(f"{name}: shape {tuple(value.shape)}, expected "
                             f"{self.shapes[name]}")
        d = self.dims[name]
        if d is None:
            for dev in self.devices:
                self.whole[dev][name].copy_(value)
            return
        for g, c in enumerate(self.chunks):
            off, n = self.extent(g, name)
            c[name].copy_(value.narrow(d, off, n))

    @torch.no_grad()
    def refresh_from(self, src: "ShardedLM") -> None:
        """Copy ``src``'s values into these tensors, chunk by chunk (the
        groups may differ; the layout must not)."""
        if src.dims != self.dims or src.n_data != self.n_data:
            raise ValueError("refresh_from needs the same split layout")
        for name in self.shapes:
            d = self.dims[name]
            if d is None:
                for dev in self.devices:
                    self.whole[dev][name].copy_(src.chunks[0][name])
                continue
            per = self.shapes[name][d] // self.n_data
            for g, (_, pos) in enumerate(self.groups):
                for h, (_, spos) in enumerate(src.groups):
                    lo, hi = max(pos.start, spos.start), min(pos.stop,
                                                            spos.stop)
                    if lo < hi:
                        self.chunks[g][name].narrow(
                            d, (lo - pos.start) * per, (hi - lo) * per).copy_(
                            src.chunks[h][name].narrow(
                                d, (lo - spos.start) * per, (hi - lo) * per))


class _Block:
    """A sub-tree of a group's view (a block, a norm): ``gather()`` gives
    its parameters as the nested ``{name: tensor}`` mapping the model's
    functions read, each gathered whole on the group's device."""

    def __init__(self, lm: ShardedLM, g: int, prefix: str):
        self.lm, self.g, self.prefix = lm, g, prefix
        self.names = [n for n in lm.shapes if n.startswith(prefix)]

    def gather(self) -> dict:
        out: dict = {}
        for name in self.names:
            *path, leaf = name[len(self.prefix):].split(".")
            node = out
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = self.lm.gather(self.g, name)
        return out


def _tree(names) -> dict:
    out: dict = {}
    for name in names:
        node = out
        for key in name.split("."):
            node = node.setdefault(key, {})
    return out


class GroupView:
    """Group ``g``'s view of a :class:`ShardedLM`, read by
    ``transformer.train_loss`` as it reads a ``TransformerLM``: a top-level
    parameter (``embed``, ``lm_head``) is gathered on access, a block list
    is a list of :class:`_Block` s (nested for stacked super-blocks) that the
    forward gathers inside its checkpoints."""

    def __init__(self, lm: ShardedLM, g: int):
        self._lm, self._g = lm, g
        attrs = {}
        for key, sub in _tree(lm.shapes).items():
            attrs[key] = None if not sub else self._node(f"{key}.", sub)
        self._attrs = attrs

    def _node(self, prefix: str, sub: dict):
        if all(k.isdigit() for k in sub):
            return [self._node(f"{prefix}{k}.", sub[k])
                    for k in sorted(sub, key=int)]
        return _Block(self._lm, self._g, prefix)

    def __getattr__(self, key):
        attrs = self.__dict__.get("_attrs", {})
        if key not in attrs:
            raise AttributeError(key)
        v = attrs[key]
        return self._lm.gather(self._g, key) if v is None else v


# ------------------------------------------------------------- construction
def shard(model: tf.TransformerLM, mesh, fed_axis: str | None = None, *,
          p: int = 0, groups=None) -> ShardedLM:
    """``model``'s values placed as participant ``p``'s parameters on
    ``mesh`` (its groups from ``participant_groups``, or ``groups`` given
    explicitly), split by ``param_specs`` under the rules of ``fed_axis``
    (None: the dense step's). The caller may drop ``model`` afterwards."""
    lm = empty(model.cfg, mesh, fed_axis, p=p, groups=groups)
    for name, t in model.named_parameters():
        lm.load_(name, t)
    return lm


def empty(cfg: ArchConfig, mesh, fed_axis: str | None = None, *, p: int = 0,
          groups=None) -> ShardedLM:
    """An uninitialised :class:`ShardedLM` of ``cfg`` placed as
    :func:`shard` places one."""
    meta = tf.init_params(cfg, device="meta")
    if groups is None:
        groups = participant_groups(mesh, fed_axis, p)
    return ShardedLM(cfg, groups, n_data_of(mesh, fed_axis),
                     split_dims(meta, mesh, fed_axis))


def shard_reference(tree: Mapping, cfg: ArchConfig, mesh,
                    fed_axis: str | None = None, *, p: int = 0,
                    groups=None) -> ShardedLM:
    """The reference's ``transformer.init_params(cfg, key)`` tree (numpy or
    any array ``np.asarray`` converts) as sharded parameters, one port
    parameter at a time: no device holds the whole model. Names and shapes
    are checked as ``convert.lm_params_from_jax`` checks them."""
    lm = empty(cfg, mesh, fed_axis, p=p, groups=groups)
    flat = convert._flat_tree(tree)
    targets = convert._stacks((n, n) for n in lm.shapes)
    if sorted(flat) != sorted(targets):
        raise ValueError(f"{cfg.name}: parameter names differ — missing "
                         f"{sorted(set(targets) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(targets))}")
    for ref_name, dests in targets.items():
        arr = np.asarray(flat[ref_name], dtype=np.float32)
        want = convert._lead(dests) + lm.shapes[dests[0][1]]
        if tuple(arr.shape) != want:
            raise ValueError(f"{cfg.name}: {ref_name} has shape "
                             f"{tuple(arr.shape)}, expected {want}")
        for index, name in dests:
            lm.load_(name, np.array(arr[index]))
    return lm


# ---------------------------------------------------------------- gradients
def group_value_and_grad(lm: ShardedLM, g: int, cfg: ArchConfig,
                         batch: dict):
    """``(loss, {(h, name): gradient})`` of group ``g``'s loss on ``batch``
    (on its device): ``h`` the group whose chunk a split parameter's
    gradient belongs to (on that group's device), None for a whole leaf
    (on ``g``'s device). Each in its parameter's dtype; zero where the loss
    does not reach."""
    keys, leaves = [], []
    for name in lm.shapes:
        if lm.dims[name] is None:
            keys.append((None, name))
            leaves.append(lm.chunks[g][name])
        else:
            for h, c in enumerate(lm.chunks):
                keys.append((h, name))
                leaves.append(c[name])
    flags = [t.requires_grad for t in leaves]
    try:
        for t in leaves:
            t.requires_grad_(True)
        with torch.enable_grad():
            loss = tf.train_loss(lm.view(g), cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t, flag in zip(leaves, flags):
            t.requires_grad_(flag)
    return loss.detach(), {
        k: torch.zeros_like(t) if gr is None else gr
        for k, t, gr in zip(keys, leaves, grads)}


class Grads:
    """One participant's gradients in its parameters' layout:
    ``chunks[g][name]`` as :attr:`ShardedLM.chunks` (a whole leaf's
    gradient shared by the groups of a device)."""

    def __init__(self, lm: ShardedLM, chunks: list):
        self.lm, self.chunks = lm, chunks

    def full(self, name: str, device, dtype=None) -> torch.Tensor:
        """``name``'s gradient whole on ``device`` (each chunk cast to
        ``dtype`` on its device first, when given)."""
        def cast(t):
            return t if dtype is None else t.to(dtype)

        d = self.lm.dims[name]
        if d is None:
            return cast(self.chunks[0][name]).to(device)
        return torch.cat([cast(c[name]).to(device) for c in self.chunks], d)


def step_gradients(lm: ShardedLM, cfg: ArchConfig, batch: dict,
                   n_micro: int = 1, *, f32: bool | None = None):
    """``(loss, Grads)`` of one dense step over ``lm``'s groups: the batch
    splits along dim 0 into one equal part a group, each into ``n_micro``
    microbatches; gradients fold in f32 (module docstring) and are divided
    by ``groups * n_micro``, as is the loss (on the lead device). One group
    and one microbatch keep each parameter's dtype unless ``f32``."""
    n_groups = len(lm.groups)
    n = n_groups * n_micro
    f32 = n > 1 if f32 is None else f32
    if n > 1 and not f32:
        raise ValueError("several groups or microbatches fold in f32")
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split over {n_groups} groups "
                         f"x {n_micro} microbatches")
    rows = B // n_groups
    lead = lm.device
    whole = [n for n in lm.shapes if lm.dims[n] is None]
    if not f32:
        loss, gr = group_value_and_grad(
            lm, 0, cfg, {k: v.to(lead) for k, v in batch.items()})
        return loss, Grads(lm, [{n: gr[(None if n in whole else 0, n)]
                                 for n in lm.shapes}])
    # f32 accumulators: a chunk's on its owner, a whole leaf's on each device
    acc = [{n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for n, t in c.items() if lm.dims[n] is not None}
           for c in lm.chunks]
    acc_whole = {d: {n: torch.zeros(lm.shapes[n], dtype=torch.float32,
                                    device=d) for n in whole}
                 for d in lm.devices}
    loss = torch.zeros((), dtype=torch.float32, device=lead)
    for g, (dev, _) in enumerate(lm.groups):
        part = {k: v[g * rows:(g + 1) * rows].to(dev)
                for k, v in batch.items()}
        micro = {k: v.reshape(n_micro, rows // n_micro, *v.shape[1:])
                 for k, v in part.items()}
        for j in range(n_micro):
            mb_loss, gr = group_value_and_grad(
                lm, g, cfg, {k: v[j] for k, v in micro.items()})
            loss = loss + mb_loss.to(lead)
            for (h, name), t in gr.items():
                if h is None:
                    for d, a in acc_whole.items():
                        a[name] += t.to(d).float()
                else:
                    acc[h][name] += t.float()
            del gr
    for a in (*acc, *acc_whole.values()):
        for t in a.values():
            t /= n
    for a, (dev, _) in zip(acc, lm.groups):
        a.update(acc_whole[dev])
    return loss / n, Grads(lm, acc)


@torch.no_grad()
def sgd_update(lm: ShardedLM, grads: Grads, lr: float) -> None:
    """``p = (p.f32 - lr * g.f32).to(p.dtype)`` on every chunk and copy
    (``launch.train.sgd_update``'s arithmetic)."""
    seen = set()
    for g, c in enumerate(lm.chunks):
        for name, p in c.items():
            if id(p) in seen:
                continue
            seen.add(id(p))
            p.copy_((p.float() - lr * grads.chunks[g][name].float())
                    .to(p.dtype))


# ---------------------------------------------------------------- residuals
class ChunkedRow:
    """One participant's residual row of a reference leaf, chunked like
    the leaf's parameters over the participant's groups (the reference's
    ``P(fed_axis, *gspec)``): ``parts[g]`` on group ``g``'s device, split
    along ``dim`` of the stacked leaf; a leaf that is not split is one part
    on the lead device. Reads and writes as a tensor where the FL step and
    the checkpoint need one: ``to``, ``cpu``, ``copy_``."""

    def __init__(self, parts: list, dim: int | None):
        self.parts, self.dim = parts, dim

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def shape(self) -> tuple:
        s = list(self.parts[0].shape)
        if self.dim is not None:
            s[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return tuple(s)

    def to(self, device, dtype=None) -> torch.Tensor:
        """The whole row gathered on ``device`` (then cast to ``dtype``)."""
        out = (self.parts[0].to(device) if self.dim is None
               else torch.cat([p.to(device) for p in self.parts], self.dim))
        return out if dtype is None else out.to(dtype)

    def cpu(self) -> torch.Tensor:
        return self.to("cpu")

    def _offsets(self):
        off = 0
        for p in self.parts:
            n = p.shape[self.dim]
            yield p, off, n
            off += n

    @torch.no_grad()
    def copy_(self, value: torch.Tensor) -> "ChunkedRow":
        """Write the whole row ``value`` into the parts."""
        if self.dim is None:
            self.parts[0].copy_(value)
            return self
        for p, off, n in self._offsets():
            p.copy_(value.narrow(self.dim, off, n))
        return self

    def _slice_dim(self, slice_shape: tuple) -> int:
        sd = self.dim - (len(self.shape) - len(slice_shape))
        if sd < 0:
            raise ValueError(f"a slice {slice_shape} of a row {self.shape} "
                             f"cuts its split dim {self.dim}")
        return sd

    def _views(self, lead: int, slice_shape: tuple, i: int):
        """Each part's piece of slice ``i`` of the row viewed as ``[lead,
        *slice_shape]``, and the split dim within the slice."""
        if self.dim is None:
            return [self.parts[0].reshape((lead,) + slice_shape)[i]], 0
        sd = self._slice_dim(slice_shape)
        shape = list(slice_shape)
        shape[sd] = -1
        return [p.reshape((lead,) + tuple(shape))[i]
                for p in self.parts], sd

    def slice_to(self, lead: int, slice_shape: tuple, i: int,
                 device) -> torch.Tensor:
        """Slice ``i`` whole on ``device``."""
        views, sd = self._views(lead, slice_shape, i)
        if self.dim is None:
            return views[0].to(device)
        return torch.cat([v.to(device) for v in views], sd)

    @torch.no_grad()
    def put_slice(self, lead: int, slice_shape: tuple, i: int,
                  value: torch.Tensor) -> None:
        """Write slice ``i`` (whole ``value``) into the parts."""
        views, sd = self._views(lead, slice_shape, i)
        if self.dim is None:
            views[0].copy_(value)
            return
        off = 0
        for v in views:
            n = v.shape[sd]
            v.copy_(value.narrow(sd, off, n))
            off += n


def residual_rows(lm: ShardedLM, groups, n_fed: int) -> list:
    """Zero bf16 residuals for ``n_fed`` participants, one reference leaf
    at a time (its order): ``rows[leaf][p]`` a :class:`ChunkedRow` over
    participant ``p``'s ``groups[p]``, split as ``lm``'s parameters."""
    out = []
    for lf in convert.reference_leaves(lm.meta):
        d = lm.dims[lf.names[0]]
        dim = None if d is None else d + len(lf.lead)
        row = []
        for p in range(n_fed):
            gs = check_groups(groups[p], lm.n_data)
            if dim is None:
                parts = [torch.zeros(lf.shape, dtype=torch.bfloat16,
                                     device=gs[0][0])]
            else:
                per = lf.shape[dim] // lm.n_data
                parts = []
                for dev, pos in gs:
                    s = list(lf.shape)
                    s[dim] = len(pos) * per
                    parts.append(torch.zeros(s, dtype=torch.bfloat16,
                                             device=dev))
            row.append(ChunkedRow(parts, dim))
        out.append(row)
    return out
