"""Sharded parameters: the port's counterpart of GSPMD placing one
participant's leaves by ``launch.shardings.param_specs``' ``fsdp`` and
``model`` entries.

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

* **The model axis.** Where a group is a row of ``model`` cells (one
  device a model position: ``launch.mesh.participant_groups``' grid), a
  parameter whose spec also names ``model`` splits along that dim into
  ``n_model`` equal chunks, one a cell; a leaf whole along ``model`` keeps
  one copy a device among a group's cells. Cells on one device whose
  blocks are equal share one tensor. The group's positions then compute
  together (``launch/tp.py``), and each block's gradient is first the sum
  of the positions' partials, in position order, in f32. With one model
  position every chunk, gather and fold is the ``data`` split's alone.

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
from repro_torch.launch import tp
from repro_torch.launch.mesh import (group_cells, lead_device,
                                     logical_rules, participant_groups)
from repro_torch.models import transformer as tf


def _names(entry, axis: str) -> bool:
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def n_data_of(mesh, fed_axis: str | None) -> int:
    """The positions a participant has along ``data`` (1 without one)."""
    sizes = shd.axis_sizes_of(mesh)
    return sizes["data"] if "data" in sizes and fed_axis != "data" else 1


def n_model_of(mesh) -> int:
    """The positions a participant has along ``model`` (1 without one)."""
    return shd.axis_sizes_of(mesh).get("model", 1)


def split_dims(model: torch.nn.Module, mesh, fed_axis: str | None,
               axis: str = "data") -> dict:
    """``{port parameter name: its dim split over axis, or None}`` under
    ``param_specs`` with the FL (``fed_axis``) or dense rules of ``mesh``
    (``axis`` ``data`` or ``model``)."""
    leaves = convert.reference_leaves(model)
    specs = shd.param_specs({lf.path: lf.shape for lf in leaves},
                            logical_rules(mesh, fed_axis=fed_axis),
                            shd.axis_sizes_of(mesh))
    out = {}
    for lf in leaves:
        dims = [i - len(lf.lead) for i, e in enumerate(tuple(specs[lf.path]))
                if _names(e, axis)]
        for name in lf.names:
            out[name] = dims[0] if dims else None
    return out


def _group_device(dev):
    if isinstance(dev, (tuple, list)):
        return tuple(torch.device(d) for d in dev)
    return torch.device(dev)


def check_groups(groups, n_data: int) -> list:
    """``[(device or cells, range)]``: contiguous runs covering ``n_data``
    positions in order; either every entry one device or every entry a
    tuple of the same number of cells (one device a model position)."""
    out, nxt = [], 0
    for dev, pos in groups:
        if pos.step != 1 or pos.start != nxt or len(pos) < 1:
            raise ValueError(f"groups {groups} are not contiguous runs of "
                             f"the {n_data} data positions in order")
        out.append((_group_device(dev), pos))
        nxt = pos.stop
    if nxt != n_data:
        raise ValueError(f"groups {groups} cover {nxt} of {n_data} data "
                         "positions")
    if len({len(group_cells(d)) if isinstance(d, tuple) else 0
            for d, _ in out}) > 1:
        raise ValueError(f"groups {groups} mix devices and model cells, or "
                         "cells of different counts")
    return out


def spread(groups) -> bool:
    """Whether ``groups`` split the model: several groups, or a grid of
    model cells."""
    return len(groups) > 1 or isinstance(groups[0][0], (tuple, list))


def row_devices(groups, dim, mdim) -> list:
    """The devices of a :class:`ChunkedRow`'s parts over ``groups`` split
    along ``dim`` (data) and ``mdim`` (model) (:func:`residual_rows`)."""
    out = []
    for dev, _ in (groups if dim is not None else groups[:1]):
        cells = group_cells(dev)
        out += list(cells if mdim is not None else cells[:1])
    return out


def same_groups(a, b) -> bool:
    return len(a) == len(b) and all(
        da == db and pa == pb for (da, pa), (db, pb) in zip(a, b))


class ShardedLM:
    """One participant's parameters over its ``(data group, model
    position)`` grid (module docstring).

    ``cells`` lists the grid's cells ``(g, j, device)`` in group-major
    order; without tensor parallelism (every group one device) a cell is a
    group and ``n_model`` is 1. ``chunks[c][name]`` is cell ``c``'s tensor
    of a parameter: its block along ``dims[name]`` (the data split) and
    ``mdims[name]`` (the model split), a leaf whole along an axis taking
    the whole dim there. Cells on one device whose blocks are equal share
    one tensor (a whole leaf: one copy a device). ``meta`` is the model on
    the meta device: names, shapes and the reference's leaves. Tensors are
    created with ``requires_grad=False``."""

    def __init__(self, cfg: ArchConfig, groups, n_data: int, dims: dict,
                 mdims: dict | None = None):
        self.cfg = cfg
        self.meta = tf.init_params(cfg, device="meta")
        self.groups = check_groups(groups, n_data)
        self.n_data = n_data
        self.dims = dict(dims)
        grid = isinstance(self.groups[0][0], tuple)
        self.n_model = len(self.groups[0][0]) if grid else 1
        self.mdims = ({n: None for n in self.dims}
                      if mdims is None or not grid else dict(mdims))
        self.shapes = {n: tuple(p.shape)
                       for n, p in self.meta.named_parameters()}
        self.dtypes = {n: p.dtype for n, p in self.meta.named_parameters()}
        for name, d in self.dims.items():
            if d is not None and self.shapes[name][d] % n_data:
                raise ValueError(f"{name}: {n_data} data positions do not "
                                 f"divide dim {d} of {self.shapes[name]}")
            md = self.mdims[name]
            if md is not None and (md == d or self.shapes[name][md]
                                   % self.n_model):
                raise ValueError(f"{name}: {self.n_model} model positions "
                                 f"do not split dim {md} of "
                                 f"{self.shapes[name]}")
        self.cells = [(g, j, dev) for g, (devs, _) in enumerate(self.groups)
                      for j, dev in enumerate(group_cells(devs))]
        self.devices = list(dict.fromkeys(d for _, _, d in self.cells))
        self.store = {}         # (name, data part, model part, device)
        self.chunks = [{} for _ in self.cells]
        for name, shape in self.shapes.items():
            for c, (g, j, dev) in enumerate(self.cells):
                key = self.tensor_key(c, name)
                if key not in self.store:
                    s = list(shape)
                    if self.dims[name] is not None:
                        s[self.dims[name]] = self.extent(g, name)[1]
                    if self.mdims[name] is not None:
                        s[self.mdims[name]] = self.mextent(j, name)[1]
                    self.store[key] = torch.empty(
                        s, dtype=self.dtypes[name], device=dev)
                self.chunks[c][name] = self.store[key]

    @property
    def device(self) -> torch.device:
        """The lead device: cell 0's."""
        return self.cells[0][2]

    def cell(self, g: int, j: int) -> int:
        """The index of cell ``(g, j)``."""
        return g * self.n_model + j

    def logical_key(self, c: int, name: str) -> tuple:
        """``(name, data part, model part)`` of cell ``c``'s block: its
        group where ``name`` splits over data, its model position where it
        splits over model, None where it is whole."""
        g, j, _ = self.cells[c]
        return (name, None if self.dims[name] is None else g,
                None if self.mdims[name] is None else j)

    def tensor_key(self, c: int, name: str) -> tuple:
        return self.logical_key(c, name) + (self.cells[c][2],)

    def extent(self, g: int, name: str) -> tuple[int, int]:
        """``(offset, length)`` of group ``g``'s chunk along the data
        split dim."""
        d = self.dims[name]
        per = self.shapes[name][d] // self.n_data
        pos = self.groups[g][1]
        return pos.start * per, len(pos) * per

    def mextent(self, j: int, name: str) -> tuple[int, int]:
        """``(offset, length)`` of model position ``j``'s chunk along the
        model split dim."""
        per = self.shapes[name][self.mdims[name]] // self.n_model
        return j * per, per

    def block(self, c: int, name: str, value: torch.Tensor,
              skip: int = 0) -> torch.Tensor:
        """Cell ``c``'s block of the whole ``value`` of ``name`` (a view);
        ``value`` may lack the parameter's first ``skip`` dims (a slice of
        it that holds its split dims)."""
        g, j, _ = self.cells[c]
        if self.dims[name] is not None:
            value = value.narrow(self.dims[name] - skip,
                                 *self.extent(g, name))
        if self.mdims[name] is not None:
            value = value.narrow(self.mdims[name] - skip,
                                 *self.mextent(j, name))
        return value

    def view(self, g: int) -> "GroupView":
        """Group ``g``'s view for the forward (made anew: the model keeps
        no reference to it, so dropping the model frees its tensors at
        once, without waiting for the cycle collector). Without tensor
        parallelism only; ``launch.tp.GridView`` is a grid's."""
        return GroupView(self, g)

    def tensors(self) -> Iterable[tuple[str, torch.Tensor]]:
        """Every distinct tensor held, ``(name, tensor)``: each chunk, and
        each device's copy of a whole block once."""
        for key, t in self.store.items():
            yield key[0], t

    def gather(self, g: int, name: str) -> torch.Tensor:
        """``name`` on cell ``g``'s device, whole along data,
        differentiable: the chunks of the cell's model position copied
        there and concatenated in group order (without tensor parallelism
        a cell is a group, and this is the whole parameter)."""
        d = self.dims[name]
        if d is None:
            return self.chunks[g][name]
        _, j, dev = self.cells[g]
        return torch.cat([self.chunks[self.cell(h, j)][name].to(dev)
                          for h in range(len(self.groups))], d)

    def _rows(self, name: str, fetch) -> torch.Tensor:
        """``name`` whole from ``fetch(cell)``: blocks concatenated along
        data within a model position, then along model."""
        d, md = self.dims[name], self.mdims[name]
        cols = []
        for j in (range(self.n_model) if md is not None else (0,)):
            parts = [fetch(self.cell(h, j)) for h in (
                range(len(self.groups)) if d is not None else (0,))]
            cols.append(parts[0] if d is None else torch.cat(parts, d))
        return cols[0] if md is None else torch.cat(cols, md)

    @torch.no_grad()
    def full(self, name: str, device="cpu") -> torch.Tensor:
        """``name`` whole on ``device`` (no autograd)."""
        return self._rows(name, lambda c: self.chunks[c][name].to(device))

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
        seen = set()
        for c in range(len(self.cells)):
            t = self.chunks[c][name]
            if id(t) not in seen:
                seen.add(id(t))
                t.copy_(self.block(c, name, value))

    @torch.no_grad()
    def refresh_from(self, src: "ShardedLM") -> None:
        """Copy ``src``'s values into these tensors, chunk by chunk (the
        groups may differ; the layout must not)."""
        if (src.dims != self.dims or src.n_data != self.n_data
                or src.mdims != self.mdims or src.n_model != self.n_model):
            raise ValueError("refresh_from needs the same split layout")
        for (name, gp, jp, _), t in self.store.items():
            d = self.dims[name]
            j = 0 if jp is None else jp
            if d is None:
                t.copy_(src.chunks[src.cell(0, j)][name])
                continue
            per = self.shapes[name][d] // self.n_data
            pos = self.groups[gp][1]
            for h, (_, spos) in enumerate(src.groups):
                lo, hi = max(pos.start, spos.start), min(pos.stop, spos.stop)
                if lo < hi:
                    t.narrow(d, (lo - pos.start) * per, (hi - lo) * per).copy_(
                        src.chunks[src.cell(h, j)][name].narrow(
                            d, (lo - spos.start) * per, (hi - lo) * per))


class _Block:
    """A sub-tree of a group's view (a block, a norm): ``gather()`` gives
    its parameters as the nested ``{name: tensor}`` mapping the model's
    functions read, each gathered whole on the group's device."""

    def __init__(self, lm: ShardedLM, g: int, prefix: str):
        self.lm, self.g, self.prefix = lm, g, prefix

    def gather(self) -> dict:
        return tp.nested(self.lm.shapes, self.prefix,
                         lambda name: self.lm.gather(self.g, name))


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
    mdims = None
    if isinstance(groups[0][0], (tuple, list)):
        if len(groups[0][0]) != n_model_of(mesh):
            raise ValueError(f"groups of {len(groups[0][0])} cells on a mesh "
                             f"of {n_model_of(mesh)} model positions")
        mdims = split_dims(meta, mesh, fed_axis, "model")
    return ShardedLM(cfg, groups, n_data_of(mesh, fed_axis),
                     split_dims(meta, mesh, fed_axis), mdims)


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
    does not reach. Without tensor parallelism (``launch.tp`` has a
    grid's)."""
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


class Tally:
    """The bytes that reads of chunked tensors assembled (``Grads.full``,
    ``ChunkedRow.to``, ``ChunkedRow.slice_to`` given one): a read counts
    the whole tensor it returns when it joined several chunks or moved one
    to another device, and nothing when it returned a chunk where it
    lies."""

    def __init__(self):
        self.bytes = 0

    def count(self, out: torch.Tensor, sources: list) -> None:
        if len(sources) > 1 or any(s.device != out.device for s in sources):
            self.bytes += out.numel() * out.element_size()


class Grads:
    """One participant's gradients in its parameters' layout:
    ``chunks[c][name]`` as :attr:`ShardedLM.chunks` (a whole block's
    gradient shared by the cells of a device)."""

    def __init__(self, lm: ShardedLM, chunks: list):
        self.lm, self.chunks = lm, chunks

    def full(self, name: str, device, dtype=None,
             tally: Tally | None = None) -> torch.Tensor:
        """``name``'s gradient whole on ``device`` (each chunk cast to
        ``dtype`` on its device first, when given)."""
        sources = []

        def fetch(c):
            t = self.chunks[c][name]
            sources.append(t)
            return (t if dtype is None else t.to(dtype)).to(device)

        out = self.lm._rows(name, fetch)
        if tally is not None:
            tally.count(out, sources)
        return out

    def drop(self, names) -> None:
        """Forget the gradients of ``names`` (every cell's chunk)."""
        for chunk in self.chunks:
            for name in names:
                chunk.pop(name, None)


def step_gradients(lm: ShardedLM, cfg: ArchConfig, batch: dict,
                   n_micro: int = 1, *, f32: bool | None = None):
    """``(loss, Grads)`` of one dense step over ``lm``'s groups: the batch
    splits along dim 0 into one equal part a group, each into ``n_micro``
    microbatches; gradients fold in f32 (module docstring) and are divided
    by ``groups * n_micro``, as is the loss (on the lead device). One group
    and one microbatch keep each parameter's dtype unless ``f32``. On a
    grid (``n_model > 1``) a block's gradient is first the f32 sum of its
    model positions' partials (``launch.tp``), rounded to the parameter's
    dtype where nothing more is folded."""
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
    if not f32 and lm.n_model == 1:
        whole = [n for n in lm.shapes if lm.dims[n] is None]
        loss, gr = group_value_and_grad(
            lm, 0, cfg, {k: v.to(lead) for k, v in batch.items()})
        return loss, Grads(lm, [{n: gr[(None if n in whole else 0, n)]
                                 for n in lm.shapes}])
    if lm.n_model > 1:
        value_and_grad = tp.group_value_and_grad
    else:       # one position: its gradient is the block's
        def value_and_grad(lm, g, cfg, part):
            loss, gr = group_value_and_grad(lm, g, cfg, part)
            return loss, {(name, h, None): [t] for (h, name), t in gr.items()}
    targets: dict = {}      # logical block -> the distinct tensors holding it
    for key in lm.store:
        targets.setdefault(key[:3], []).append(key)
    # an f32 accumulator a distinct tensor: a chunk's on its owner, a whole
    # block's on each device holding a copy
    out = ({key: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for key, t in lm.store.items()} if f32 else {})
    loss = torch.zeros((), dtype=torch.float32, device=lead)
    for g, (dev, _) in enumerate(lm.groups):
        dev = lead_device(dev)
        part = {k: v[g * rows:(g + 1) * rows].to(dev)
                for k, v in batch.items()}
        micro = {k: v.reshape(n_micro, rows // n_micro, *v.shape[1:])
                 for k, v in part.items()}
        for j in range(n_micro):
            mb_loss, gr = value_and_grad(
                lm, g, cfg, {k: v[j] for k, v in micro.items()})
            loss = loss + mb_loss.to(lead)
            for key in list(gr):        # one block's f32 sum alive at a time
                parts = gr.pop(key)
                s = tp.fold(parts, parts[0].device, torch.float32)
                for tkey in targets[key]:
                    if f32:
                        out[tkey] += s.to(tkey[3])
                    else:
                        out[tkey] = s.to(tkey[3], lm.dtypes[key[0]])
                del s, parts
            del gr
    if f32:
        for t in out.values():
            t /= n
    for key, t in lm.store.items():     # blocks the loss does not reach
        if key not in out:
            out[key] = torch.zeros_like(t)
    return loss / n, Grads(lm, [
        {name: out[lm.tensor_key(c, name)] for name in lm.shapes}
        for c in range(len(lm.cells))])


@torch.no_grad()
def sgd_update(lm: ShardedLM, grads: Grads, lr: float) -> None:
    """``p = (p.f32 - lr * g.f32).to(p.dtype)`` on every chunk and copy
    (``launch.train.sgd_update``'s arithmetic)."""
    seen = set()
    for c, chunk in enumerate(lm.chunks):
        for name, p in chunk.items():
            if id(p) in seen:
                continue
            seen.add(id(p))
            p.copy_((p.float() - lr * grads.chunks[c][name].float())
                    .to(p.dtype))


# ---------------------------------------------------------------- residuals
class ChunkedRow:
    """One participant's residual row of a reference leaf, chunked like
    the leaf's parameters over the participant's grid (the reference's
    ``P(fed_axis, *gspec)``): ``parts`` in group-major order, split along
    ``dim`` of the stacked leaf over the data groups and along ``mdim``
    over the ``n_model`` model positions (``parts[a * n_model + b]``, or
    ``parts[a]`` / ``parts[b]`` where one axis does not split it); a leaf
    that is not split is one part on the lead device. Reads and writes as
    a tensor where the FL step and the checkpoint need one: ``to``,
    ``cpu``, ``copy_``."""

    def __init__(self, parts: list, dim: int | None, mdim: int | None = None,
                 n_model: int = 1):
        self.parts, self.dim, self.mdim = parts, dim, mdim
        self.n_model = n_model if mdim is not None else 1

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def _grid(self, parts=None) -> list:
        parts = self.parts if parts is None else parts
        m = self.n_model
        return [parts[a * m:(a + 1) * m] for a in range(len(parts) // m)]

    @property
    def shape(self) -> tuple:
        grid = self._grid()
        s = list(self.parts[0].shape)
        if self.dim is not None:
            s[self.dim] = sum(row[0].shape[self.dim] for row in grid)
        if self.mdim is not None:
            s[self.mdim] = sum(p.shape[self.mdim] for p in grid[0])
        return tuple(s)

    @staticmethod
    def _join(grid, dim, mdim, device, tally=None) -> torch.Tensor:
        rows = [row[0].to(device) if mdim is None
                else torch.cat([p.to(device) for p in row], mdim)
                for row in grid]
        out = rows[0] if dim is None else torch.cat(rows, dim)
        if tally is not None:
            tally.count(out, [p for row in grid for p in row])
        return out

    def to(self, device, dtype=None,
           tally: Tally | None = None) -> torch.Tensor:
        """The whole row gathered on ``device`` (then cast to ``dtype``)."""
        out = self._join(self._grid(), self.dim, self.mdim, device, tally)
        return out if dtype is None else out.to(dtype)

    def cell_of(self, i: int) -> tuple[int, int]:
        """Part ``i``'s ``(data group, model position)`` in the
        participant's grid (0 along an axis that does not split the
        row)."""
        return divmod(i, self.n_model)

    def locate(self, cuts: dict):
        """The part that holds the box ``cuts`` (``{dim: (offset,
        length)}`` of the whole row; a dim not named is whole): ``(part
        index, the box's cuts within that part)``, or None when the box
        spans several parts."""
        shape = self.shape
        for i, (p, a, b) in enumerate(self._pieces(self.parts, self.dim,
                                                   self.mdim)):
            local = dict(cuts)
            for d, off in ((self.dim, a), (self.mdim, b)):
                if d is None:
                    continue
                o, n = cuts.get(d, (0, shape[d]))
                if not off <= o <= o + n <= off + p.shape[d]:
                    break
                local[d] = (o - off, n)
            else:
                return i, local
        return None

    def cpu(self) -> torch.Tensor:
        return self.to("cpu")

    def _pieces(self, views, dim, mdim):
        """``(part view, dim offsets)`` of each part within the whole."""
        off_a = 0
        for row in self._grid(views):
            off_b = 0
            for v in row:
                yield v, off_a, off_b
                if mdim is not None:
                    off_b += v.shape[mdim]
            if dim is not None:
                off_a += row[0].shape[dim]

    @staticmethod
    def _narrow(value, dim, mdim, v, off_a, off_b):
        if dim is not None:
            value = value.narrow(dim, off_a, v.shape[dim])
        if mdim is not None:
            value = value.narrow(mdim, off_b, v.shape[mdim])
        return value

    @torch.no_grad()
    def copy_(self, value: torch.Tensor) -> "ChunkedRow":
        """Write the whole row ``value`` into the parts."""
        for p, a, b in self._pieces(self.parts, self.dim, self.mdim):
            p.copy_(self._narrow(value, self.dim, self.mdim, p, a, b))
        return self

    def _slice_dim(self, dim, slice_shape: tuple):
        if dim is None:
            return None
        sd = dim - (len(self.shape) - len(slice_shape))
        if sd < 0:
            raise ValueError(f"a slice {slice_shape} of a row {self.shape} "
                             f"cuts its split dim {dim}")
        return sd

    def _views(self, lead: int, slice_shape: tuple, i: int):
        """Each part's piece of slice ``i`` of the row viewed as ``[lead,
        *slice_shape]``, and the split dims within the slice."""
        sd = self._slice_dim(self.dim, slice_shape)
        smd = self._slice_dim(self.mdim, slice_shape)
        views = []
        for p in self.parts:
            shape = list(slice_shape)
            for x in (sd, smd):
                if x is not None:
                    shape[x] = p.shape[x - len(slice_shape) + p.dim()]
            views.append(p.reshape((lead,) + tuple(shape))[i])
        return views, sd, smd

    def slice_to(self, lead: int, slice_shape: tuple, i: int, device,
                 tally: Tally | None = None) -> torch.Tensor:
        """Slice ``i`` whole on ``device``."""
        views, sd, smd = self._views(lead, slice_shape, i)
        return self._join(self._grid(views), sd, smd, device, tally)

    @torch.no_grad()
    def put_slice(self, lead: int, slice_shape: tuple, i: int,
                  value: torch.Tensor) -> None:
        """Write slice ``i`` (whole ``value``) into the parts."""
        views, sd, smd = self._views(lead, slice_shape, i)
        for v, a, b in self._pieces(views, sd, smd):
            v.copy_(self._narrow(value, sd, smd, v, a, b))


def residual_rows(lm: ShardedLM, groups, n_fed: int) -> list:
    """Zero bf16 residuals for ``n_fed`` participants, one reference leaf
    at a time (its order): ``rows[leaf][p]`` a :class:`ChunkedRow` over
    participant ``p``'s grid ``groups[p]``, split as ``lm``'s parameters
    (a data chunk on its group's lead device where the leaf is whole along
    model; a model chunk on group 0's cell where it is whole along
    data)."""
    out = []
    for lf in convert.reference_leaves(lm.meta):
        name = lf.names[0]
        d, md = lm.dims[name], lm.mdims[name]
        dim = None if d is None else d + len(lf.lead)
        mdim = None if md is None else md + len(lf.lead)
        row = []
        for p in range(n_fed):
            gs = check_groups(groups[p], lm.n_data)
            devs = iter(row_devices(gs, dim, mdim))
            parts = []
            for _, pos in (gs if dim is not None else gs[:1]):
                for _ in range(lm.n_model if mdim is not None else 1):
                    s = list(lf.shape)
                    if dim is not None:
                        s[dim] = len(pos) * (lf.shape[dim] // lm.n_data)
                    if mdim is not None:
                        s[mdim] = lf.shape[mdim] // lm.n_model
                    parts.append(torch.zeros(s, dtype=torch.bfloat16,
                                             device=next(devs)))
            row.append(ChunkedRow(parts, dim, mdim, lm.n_model))
        out.append(row)
    return out
