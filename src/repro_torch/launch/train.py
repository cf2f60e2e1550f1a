"""LM train steps — port of ``repro.launch.train``: the dense step (plain
SGD on the gradient of ``train_loss``, optionally over microbatches) and the
two federated steps (``make_fl_train_step``, ``make_fl_train_step_v2``).

The reference takes ``jax.value_and_grad`` of a pure function of the
parameter tree; the port's parameters live in a ``TransformerLM`` created
with ``requires_grad=False`` (serving), so ``value_and_grad`` turns grad on
for the call and restores it. Gradients are returned by parameter name
(``blocks.0.attn.wq``), in each parameter's dtype;
``convert.lm_tree_to_numpy`` stacks them into the reference's tree.

**The federated step** (``make_fl_train_step``, ``make_fl_train_step_v2``)
is the paper's technique as the collective schedule: each participant along
the federation axis of a logical mesh (``launch/mesh.py``; ``pod`` on the
multi-pod mesh) computes its gradient on its rows of the batch, encodes its
local update ``-lr * g`` per leaf with block-local THGS top-k and the
``jax.random``-keyed sparse pair masks (``core/blocked.py``; the mask key of
leaf ``i`` is ``fold_in(round_key, i)``), and the exchange scatter-adds
every participant's stream with weight ``1 / n_fed`` (one
``ops.stream_scatter_add`` a (sub-)leaf) into the aggregate; the server
update is ``p + server_lr * agg`` in f32. Leaves are the reference's
(``convert.reference_leaves``: stacked, in ``tree_leaves`` order), so leaf
ids, per-leaf ranks and block layouts are the reference's.

One process drives the mesh. Participant ``p`` runs on its pod's device
(``launch.mesh.participant_groups``: one group); the *home* device is where
the parameters live, and there the decode, the scatter launches and the
server update run. A participant whose device is not home computes on a replica
of the parameters, refreshed from them (bit for bit) at the start of each
step's gradient stage. Every participant works at the parameters of the
step's start; a participant's gradients are dropped after its encode, and
the parameters are updated in place once, after the decode. Residuals are
the reference's ``[n_fed, *leaf]`` bf16 leaves on a one-device mesh, and on
a mesh of several devices one row a participant on its device
(:func:`init_fl_residuals`; ``residuals[leaf][p]`` either way), updated in
place. A step is a gradient stage and an exchange stage
(``step.exchange(params, residuals, grads, round_key)``, ``grads`` any
iterable of per-participant gradient dicts), so the exchange can be fed
other gradients. Both steps draw a participant's masks and encode on its
devices, one participant at a time, and bring only its streams home for
the decode. v2 (and v1 under ``REPRO_FL_ALIGNED_BLOCKS=1``) encodes on the
sharding-aligned block view, whose block ``b`` is a box of the leaf
(:func:`aligned_block_cuts`): each block is encoded where the
participant holds it (:meth:`_FLStep.encode_blocks`), and v2 drops each
leaf's gradient once encoded, so one participant's gradients are alive
at a time. Each unit's ``record`` entry counts the bytes gathered from
chunks and the stream bytes read at home. The environment switches keep
the reference's names and defaults: ``REPRO_FL_ALIGNED_BLOCKS`` (v1,
default off) and ``REPRO_FL_V2_GENERIC`` (v2, default off) select the
block layout; ``REPRO_FL_STREAM_REPLICATE`` (a partitioner workaround)
has no meaning in one process and is not read.

**A participant over several devices.** Where a participant's ``data``
positions span several groups, the parameters are a
``launch.fsdp.ShardedLM`` over participant 0's groups (``fsdp.shard``):
each group computes its share of the participant's rows with every block
gathered whole on its device, and the gradients fold in f32 onto the
chunks' owners (``fsdp.step_gradients``: bit-equal to the one-device step
with ``groups x n_micro`` microbatches), so they arrive as f32 sums. The
residual rows are chunked like the parameters (``fsdp.ChunkedRow``, the
reference's ``P(fed_axis, *gspec)``). On the aligned view a block is a
cell's own chunk of gradient and residual, so each cell encodes its
blocks and nothing is gathered, as the reference's pinned
``P(fed_axis, front, None)`` accumulator keeps its encode on each
device's block. A unit of generic row blocks (v1's default; v2 where a
spec has no aligned view, or under ``REPRO_FL_V2_GENERIC=1``) is encoded
on the participant's lead device (its group 0): its gradient and residual
chunks are gathered there in position order and the residual chunks
written back (the reference's GSPMD re-lays such blocks out too). The
streams go home, and each chunk of the aggregate goes to its owner for
the update. A participant whose groups differ from participant 0's
computes on a sharded replica over its own groups, refreshed chunk by
chunk each step. Where a participant's groups are rows of ``model``
cells, its groups compute tensor-parallel (``launch/tp.py``) and every
chunk and residual chunk is split along both axes; every participant
takes one layout (``launch.mesh.participant_grids``).

**Host synchronizations.** The gradient stage copies each participant's
rows of the batch and refreshes the replicas before it enqueues any
gradient work, and it starts a participant's gradients before the previous
participant's encode whenever their devices differ (one gradient set
pending a device): no host sync sits between the gradient stages of
participants on different devices, and on several cards they overlap.
Participants that share a device make their gradients one after the
other, each after the previous one's encode (one gradient set alive, as
on one card). The syncs left are: the ``_stage`` timings, when the caller
asks for them; inside a participant's encode, the small host-to-device
copies of the masks' keys and scalars and the top-k's NaN test (they wait
for that participant's stream); and copies to or from a CPU participant
(its rows, its replica, its stream, its loss).
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import convert
from repro_torch.configs.base import ArchConfig
from repro_torch.core import schedules
from repro_torch.core import streams as se
from repro_torch.core import threefry
from repro_torch.core.blocked import (BlockedStream, block_layout,
                                      decode_blocked_sum,
                                      encode_leaf_blocked,
                                      sharding_aligned_transform)
from repro_torch.core.types import SecureAggConfig, THGSConfig
from repro_torch.launch import fsdp
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import (group_cells, lead_device,
                                     logical_rules, participant_grids,
                                     participant_groups)
from repro_torch.models import transformer as tf


def loss_fn(params: tf.TransformerLM, cfg: ArchConfig,
            batch: dict) -> torch.Tensor:
    return tf.train_loss(params, cfg, batch)


def value_and_grad(params: tf.TransformerLM, cfg: ArchConfig, batch: dict):
    """(loss, {name: gradient}) of ``loss_fn``, the loss detached. A leaf
    the loss does not reach gets a zero gradient, as ``jax.grad`` gives."""
    names, leaves = zip(*params.named_parameters())
    flags = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p, flag in zip(leaves, flags):
            p.requires_grad_(flag)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g
        for n, p, g in zip(names, leaves, grads)}


def micro_batches(n_params: int) -> int:
    """Microbatches a dense step takes for a model of ``n_params``
    parameters (the reference's dry-run rule: the activation footprint
    grows with the model)."""
    if n_params > 50e9:
        return 8
    if n_params > 12e9:
        return 4
    return 2 if n_params > 4e9 else 1


def step_gradients(params: tf.TransformerLM, cfg: ArchConfig, batch: dict,
                   n_micro: int = 1):
    """(loss, {name: gradient}) of one dense step. With ``n_micro > 1`` the
    batch splits along dim 0 into ``n_micro`` microbatches whose gradients
    add up in f32 in microbatch order; loss and gradients are then divided
    by ``n_micro`` (f32 gradients, where ``n_micro == 1`` keeps each
    parameter's dtype)."""
    if n_micro == 1:
        return value_and_grad(params, cfg, batch)
    micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
             for k, v in batch.items()}
    device = next(params.parameters()).device
    loss = torch.zeros((), dtype=torch.float32, device=device)
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.named_parameters()}
    for i in range(n_micro):
        mb_loss, g = value_and_grad(params, cfg,
                                    {k: v[i] for k, v in micro.items()})
        loss = loss + mb_loss
        for n, gi in g.items():
            grads[n] += gi.float()
    for g in grads.values():
        g /= n_micro
    return loss / n_micro, grads


@torch.no_grad()
def sgd_update(params: tf.TransformerLM, grads: dict, lr: float) -> None:
    """``p = (p.f32 - lr * g.f32).to(p.dtype)``, written into the
    parameters (the reference returns a new tree with the same numbers)."""
    for n, p in params.named_parameters():
        p.copy_((p.float() - lr * grads[n].float()).to(p.dtype))


def make_dense_train_step(cfg: ArchConfig, lr: float = 0.01,
                          n_micro: int = 1, mesh=None) -> Callable:
    """``step(params, batch) -> (params, loss)``: one SGD step,
    ``step_gradients`` then ``sgd_update``; the parameters are updated in
    place and returned. Sharded parameters (``launch.fsdp.ShardedLM``) take
    ``fsdp.step_gradients`` and ``fsdp.sgd_update``: the batch rows split
    over their groups. With ``mesh`` (no federation axis) the step checks
    that the parameters are placed on its ``data`` groups: a
    ``TransformerLM`` where the mesh is one group, else a ``ShardedLM``
    made by ``fsdp.shard(model, mesh)``."""
    groups = None if mesh is None else participant_groups(mesh, None)

    def step(params, batch: dict):
        if isinstance(params, fsdp.ShardedLM):
            if groups is not None and not fsdp.same_groups(groups,
                                                           params.groups):
                raise ValueError(f"the parameters lie on groups "
                                 f"{params.groups}, the mesh's are {groups}")
            loss, grads = fsdp.step_gradients(params, cfg, batch, n_micro)
            fsdp.sgd_update(params, grads, lr)
            return params, loss
        if groups is not None and fsdp.spread(groups):
            raise ValueError(f"the mesh spreads the model over groups "
                             f"{groups}: place it with launch.fsdp.shard("
                             "model, mesh) first")
        loss, grads = step_gradients(params, cfg, batch, n_micro)
        sgd_update(params, grads, lr)
        return params, loss

    return step


# ------------------------------------------------------------------ federated
def fl_leaf_plan(leaf_sizes, thgs: THGSConfig, n_blocks: int) -> list:
    """Static per-leaf ``(k_block, n_blocks)`` from the Eq. 1 hierarchical
    schedule, for the reference's leaf sizes in its order."""
    sizes = [int(x) for x in leaf_sizes]
    plan = []
    for size, k in zip(sizes, schedules.leaf_ks(thgs, sizes)):
        nb, _, _ = block_layout(size, n_blocks)
        plan.append((max(1, -(-k // nb)), nb))
    return plan


def init_fl_residuals(params, n_fed: int, mesh=None, fed_axis: str = "pod",
                      groups=None) -> list:
    """Zero per-participant residuals, one a reference leaf (its order),
    bf16: a ``[n_fed, *leaf]`` tensor on the parameters' device (``meta``
    for shape records), or on ``mesh``'s one device; on a mesh of several
    devices, a list of ``n_fed`` rows, row ``p`` on participant ``p``'s
    device. Sharded parameters (``launch.fsdp.ShardedLM``) take rows
    chunked like the parameters over each participant's groups
    (``fsdp.ChunkedRow``; ``groups`` one list a participant, default the
    mesh's, else the parameters' own)."""
    if isinstance(params, fsdp.ShardedLM):
        if groups is None:
            groups = (participant_grids(mesh, fed_axis) if mesh is not None
                      else [params.groups] * n_fed)
        if len(groups) != n_fed:
            raise ValueError(f"{n_fed} participants, {len(groups)} group "
                             "lists")
        return fsdp.residual_rows(params, groups, n_fed)
    leaves = convert.reference_leaves(params)
    if mesh is None:
        devs = [next(params.parameters()).device]
    else:
        if mesh.shape[fed_axis] != n_fed:
            raise ValueError(f"{n_fed} participants on a mesh of "
                             f"{mesh.shape[fed_axis]} along {fed_axis!r}")
        devs = []
        for p in range(n_fed):
            gs = participant_groups(mesh, fed_axis, p)
            if fsdp.spread(gs):
                raise ValueError(
                    f"participant {p} spreads over groups {gs}: shard "
                    "the parameters (launch.fsdp.shard) first")
            devs.append(gs[0][0])
    if len(set(devs)) == 1:
        return [torch.zeros((n_fed,) + leaf.shape, dtype=torch.bfloat16,
                            device=devs[0]) for leaf in leaves]
    return [[torch.zeros(leaf.shape, dtype=torch.bfloat16, device=d)
             for d in devs] for leaf in leaves]


def stacked_residuals(residuals: list) -> list:
    """The residuals in the reference's layout, one ``[n_fed, *leaf]``
    tensor a leaf (a mesh's per-participant rows stacked on the CPU)."""
    return [r if torch.is_tensor(r) else torch.stack([x.cpu() for x in r])
            for r in residuals]


@torch.no_grad()
def load_residuals(residuals: list, stacked: list) -> None:
    """Write ``[n_fed, *leaf]`` tensors into the residuals, each row onto
    its participant's device."""
    for r, src in zip(residuals, stacked):
        for row, s in zip(r, src):
            row.copy_(s)


def _sync(device) -> None:
    for d in (device if isinstance(device, (list, tuple, set)) else
              (device,)):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


@contextlib.contextmanager
def _stage(name: str, timings: dict | None, device):
    """A ``fl.<name>`` profiler span; with ``timings`` the stage's wall ms
    (device synchronized at both ends) add up under ``name``."""
    with record_function(f"fl.{name}"):
        if timings is None:
            yield
            return
        _sync(device)
        t0 = time.perf_counter()
        yield
        _sync(device)
        timings[name] = timings.get(name, 0.0) + (
            time.perf_counter() - t0) * 1e3


def _participant_batches(batch: dict, n_fed: int) -> list:
    """Participant ``p``'s rows of the batch: the ``p``-th of ``n_fed``
    equal parts along dim 0 (the reference shards the batch over the
    federation axis)."""
    B = next(iter(batch.values())).shape[0]
    if B % n_fed:
        raise ValueError(f"batch {B} does not split over {n_fed} "
                         "participants")
    n = B // n_fed
    return [{k: v[p * n:(p + 1) * n] for k, v in batch.items()}
            for p in range(n_fed)]


def _stacked(tensors: dict, leaf) -> torch.Tensor:
    """The reference leaf from the port's tensors (a copy when stacked)."""
    if not leaf.lead:
        return tensors[leaf.names[0]]
    return torch.stack([tensors[n] for n in leaf.names]).reshape(leaf.shape)


def _slice_plan(leaf, spec) -> tuple[int, tuple | None]:
    """The reference v1 step's slice decision for one leaf: the leading
    unsharded dims (all but the last two) merge into ``lead`` slices; a 2-D
    leaf of >= 2**28 elements whose first dim divides by 16 (and is not
    sharded) is cut into 16 chunks. Returns ``(lead, slice_shape)``, lead
    0 when the leaf has neither."""
    shape = leaf.shape
    entries = tuple(spec) + (None,) * len(shape)
    if len(shape) >= 3:
        lead, n = 1, 0
        for di, d in enumerate(shape[:-2]):
            if entries[di] is not None:
                break
            lead *= d
            n += 1
        return lead, tuple(shape[n:])
    if len(shape) == 2 and math.prod(shape) >= 1 << 28 \
            and shape[0] % 16 == 0 and entries[0] is None:
        return 16, (shape[0] // 16, shape[1])
    return 0, None


def _slice_of(tensors: dict, leaf, lead: int, slice_shape: tuple,
              i: int) -> torch.Tensor:
    """Slice ``i`` of the leaf viewed as ``[lead, *slice_shape]``: a view of
    one port parameter (the stacked axes come first, row-major, so slice
    ``i`` lies in parameter ``i // per``)."""
    per = lead // len(leaf.names)
    t = tensors[leaf.names[i // per]]
    return t.reshape((per,) + slice_shape)[i % per]


def _narrow(t: torch.Tensor, cuts: dict) -> torch.Tensor:
    for d, (o, n) in cuts.items():
        t = t.narrow(d, o, n)
    return t


def _box(tensors: dict, leaf, cuts: dict) -> torch.Tensor:
    """The box ``cuts`` (``{dim: (offset, length)}`` of the reference
    leaf, never a stacked dim: ``param_specs`` splits none) from the port's
    tensors of ``leaf``: a view of one parameter, or the stacked
    parameters' boxes stacked (a copy)."""
    nl = len(leaf.lead)
    if any(d < nl for d in cuts):
        raise ValueError(f"{leaf.path}: a cut {cuts} of a stacked dim")
    inner = {d - nl: c for d, c in cuts.items()}
    if not nl:
        return _narrow(tensors[leaf.names[0]], inner)
    parts = [_narrow(tensors[n], inner) for n in leaf.names]
    return torch.stack(parts).reshape(leaf.lead + tuple(parts[0].shape))


def aligned_block_cuts(shape, spec, axis_sizes: dict,
                       intra_axes: tuple) -> list:
    """Each block's box in ``sharding_aligned_transform``'s view (which
    exists for these arguments): ``{dim: (offset, length)}`` along the dims
    the spec splits. The transform keeps the other dims in their order, so
    block ``b`` is that box of the leaf flattened row-major: the box a
    device holds is its block."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    dim_of = {ax: d for d, ax in enumerate(entries) if ax is not None}
    front = [a for a in intra_axes if a in dim_of]
    counts = [axis_sizes[a] for a in front]
    out = []
    for b in range(math.prod(counts)):
        out.append({dim_of[a]: (int(i) * (shape[dim_of[a]] // n),
                                shape[dim_of[a]] // n)
                    for a, i, n in zip(front, np.unravel_index(b, counts),
                                       counts)})
    return out


# elements of blocks that one encode call takes (consecutive blocks on one
# device): bounds the f32 temporaries of a call (accumulator, |acc|, the
# top-k's count, the new blocks) near 0.5 GB each; a larger block goes
# alone
ENCODE_ELEMS = 1 << 27


def _stream_bytes(st) -> int:
    return sum(t.numel() * t.element_size() for t in (st.indices, st.values))


def _neg_lr(g: torch.Tensor, lr: float) -> torch.Tensor:
    """``-lr * g`` in ``g``'s dtype, the scalar rounded to that dtype first
    (JAX's weak-typed scalar)."""
    return g * torch.tensor(-lr, dtype=g.dtype, device=g.device)


@torch.no_grad()
def _update(p: torch.Tensor, agg: torch.Tensor, server_lr: float) -> None:
    """``p = (f32(p) + server_lr * f32(agg)).to(p.dtype)``, in place."""
    a = agg.to(torch.float32)
    if server_lr != 1.0:
        a = a * torch.tensor(server_lr, dtype=torch.float32, device=a.device)
    p.copy_((p.to(torch.float32) + a).to(p.dtype))


class _FLStep:
    """Shared state of both FL steps."""

    def __init__(self, cfg, mesh, fed_axis, thgs, sa, lr, server_lr,
                 n_micro, groups=None):
        self.cfg, self.mesh, self.fed_axis = cfg, mesh, fed_axis
        self.thgs, self.sa = thgs, sa
        self.lr, self.server_lr, self.n_micro = lr, server_lr, n_micro
        self.axis_sizes = shd.axis_sizes_of(mesh)
        self.n_fed = self.axis_sizes[fed_axis]
        self.n_blocks = mesh.size // self.n_fed
        self.rules = logical_rules(mesh, fed_axis=fed_axis)
        self.intra_axes = tuple(a for a in mesh.axis_names if a != fed_axis)
        if groups is None:
            groups = participant_grids(mesh, fed_axis)
        elif len(groups) != self.n_fed:
            raise ValueError(f"{len(groups)} group lists for {self.n_fed} "
                             "participants")
        n_data = fsdp.n_data_of(mesh, fed_axis)
        self.groups = [fsdp.check_groups(gs, n_data) for gs in groups]
        self.devices = [lead_device(gs[0][0]) for gs in self.groups]
        # gradients fold in f32 with microbatches or a participant's groups
        self.f32 = n_micro > 1 or any(len(gs) > 1 for gs in self.groups)
        self.replicas = {}      # device (or groups) -> (params, replica)
        self.timings = None

    def layout(self, params):
        leaves = convert.reference_leaves(params)
        specs = shd.param_specs({lf.path: lf.shape for lf in leaves},
                                self.rules, self.axis_sizes)
        sizes = [math.prod(lf.shape) for lf in leaves]
        return leaves, [specs[lf.path] for lf in leaves], sizes, \
            schedules.leaf_ks(self.thgs, sizes)

    def k_mask(self, size: int, nb: int) -> int:
        if self.sa.enabled and self.n_fed >= 2:
            return max(1, int(size * self.sa.mask_ratio / self.n_fed / nb))
        return 0

    @torch.no_grad()
    def replica(self, params, device):
        """The parameters on ``device``: ``params`` on their own device,
        else the replica there, refreshed from them bit for bit."""
        if device == self.device(params):
            return params
        cached = self.replicas.get(device)
        if cached is None or cached[0] is not params:
            rep = tf.init_params(params.cfg, device="meta").to_empty(
                device=device)
            self.replicas[device] = cached = (params, rep)
        for r, p in zip(cached[1].parameters(), params.parameters()):
            r.copy_(p)
        return cached[1]

    @torch.no_grad()
    def sharded_replica(self, params, p: int):
        """Participant ``p``'s sharded parameters: ``params`` when its
        groups are theirs, else a replica over its groups, refreshed from
        ``params`` chunk by chunk."""
        gs = self.groups[p]
        if fsdp.same_groups(gs, params.groups):
            return params
        key = tuple((str(d), r.start, r.stop) for d, r in gs)
        cached = self.replicas.get(key)
        if cached is None or cached[0] is not params:
            rep = fsdp.ShardedLM(params.cfg, gs, params.n_data, params.dims,
                                 params.mdims)
            self.replicas[key] = cached = (params, rep)
        cached[1].refresh_from(params)
        return cached[1]

    def gradients(self, params, batch: dict) -> Iterable:
        """Each participant's ``(loss, gradients)`` at ``params``, on its
        device: ``{name: gradient}``, or for sharded parameters an
        ``fsdp.Grads`` over the participant's groups (f32 sums when any
        participant has several). A participant's gradients are started
        when the previous one is handed out, or before that when their
        devices differ (module docstring); a device holds one pending
        set."""
        sharded = isinstance(params, fsdp.ShardedLM)
        if sharded:
            models = [self.sharded_replica(params, p)
                      for p in range(self.n_fed)]
            devsets = [{c for d, _ in gs for c in group_cells(d)}
                       for gs in self.groups]
            rows = _participant_batches(batch, self.n_fed)
        else:
            if any(fsdp.spread(gs) for gs in self.groups):
                raise ValueError("a participant spreads over several groups:"
                                 " shard the parameters (launch.fsdp.shard)")
            models = {d: self.replica(params, d) for d in self.devices}
            devsets = [{d} for d in self.devices]
            rows = [{k: v.to(d) for k, v in b.items()} for d, b in
                    zip(self.devices, _participant_batches(batch,
                                                           self.n_fed))]
        pending, nxt = [], 0        # (devices, gradients) started, in order
        for _ in range(self.n_fed):
            while nxt < self.n_fed and all(
                    not devsets[nxt] & ds for ds, _ in pending):
                with _stage("grads", self.timings, sorted(devsets[nxt],
                                                          key=str)):
                    if sharded:
                        out = fsdp.step_gradients(
                            models[nxt], self.cfg, rows[nxt], self.n_micro,
                            f32=self.f32)
                    else:
                        out = step_gradients(models[self.devices[nxt]],
                                             self.cfg, rows[nxt],
                                             self.n_micro)
                pending.append((devsets[nxt], out))
                del out
                rows[nxt] = None
                nxt += 1
            _, out = pending.pop(0)
            yield out
            del out     # no frame holds a gradient while the next is made

    @staticmethod
    def device(params):
        if isinstance(params, fsdp.ShardedLM):
            return params.device
        return next(params.parameters()).device

    def check_row(self, pid: int, res) -> None:
        """Raise unless participant ``pid``'s residual row lies on its
        devices."""
        chunked = isinstance(res, fsdp.ChunkedRow)
        want = (fsdp.row_devices(self.groups[pid], res.dim, res.mdim)
                if chunked else [self.devices[pid]])
        have = [p.device for p in res.parts] if chunked else [res.device]
        if have != want:
            raise ValueError(
                f"participant {pid}'s residuals lie on {have}, the "
                f"participant on {want}: make them with "
                "init_fl_residuals(params, n_fed, mesh)")

    @staticmethod
    def block(pid: int, g, leaf, cut: dict, res):
        """Participant ``pid``'s block ``cut`` (one of
        :func:`aligned_block_cuts`') of a leaf: ``(residual box, gradient
        box)`` on the device that holds the residual box, the first a view
        to write the new residual into. On a chunked row the block is a box
        of one chunk (the aligned view's blocks are the ``fsdp`` placement's
        chunks) and the gradient box the same cell's: nothing is
        gathered."""
        if isinstance(res, fsdp.ChunkedRow):
            where = res.locate(cut)
            if where is None:
                raise ValueError(f"{leaf.path}: block {cut} spans "
                                 f"participant {pid}'s residual chunks")
            i, local = where
            r = _narrow(res.parts[i], local)
            gb = (_box(g.chunks[g.lm.cell(*res.cell_of(i))], leaf, local)
                  if isinstance(g, fsdp.Grads) else _box(g, leaf, cut))
        else:
            r = _narrow(res, cut)
            gb = _box(g, leaf, cut)
        if gb.shape != r.shape:
            raise ValueError(
                f"{leaf.path}: participant {pid}'s gradient block "
                f"{tuple(gb.shape)} is not its residual block "
                f"{tuple(r.shape)}")
        return r, gb.to(r.device)

    def encode_blocks(self, pid: int, g, leaf, cuts: list, m: int, kb: int,
                      km: int, res, signs, masks, dest, *, bf16: bool):
        """Participant ``pid``'s stream of an aligned leaf, each block
        encoded on the device :meth:`block` puts it on: ``f32(residual) +
        f32(-lr * g)`` (``g`` cast to bf16 first with ``bf16``, v2's rule;
        else ``-lr * g`` in ``g``'s dtype, v1's), block-local top-k ∪ the
        mask row ``b`` of ``masks`` (the participant's ``[nb, n_peers *
        km]`` draw, or None, with ``signs`` its ``[1, n_peers]`` signs),
        the new residual block written in place. Consecutive blocks on one
        device share an encode call up to ``ENCODE_ELEMS`` elements (the
        encode is row-local, so the bits are a block's alone). Returns
        ``(int32[nb, k_total] global indices b * m + col, f32 values)`` on
        ``dest``."""
        per = max(1, ENCODE_ELEMS // m)
        idx, vals, batch = [], [], []
        for b, cut in enumerate(cuts):
            r, gb = self.block(pid, g, leaf, cut, res)
            if batch and batch[0][1].device != r.device:
                self._encode_batch(batch, m, kb, km, signs, masks, dest,
                                   bf16, idx, vals)
                batch = []
            batch.append((b, r, gb))
            del r, gb
            if len(batch) == per:   # before the next block's gradient box
                self._encode_batch(batch, m, kb, km, signs, masks, dest,
                                   bf16, idx, vals)
                batch = []
        if batch:
            self._encode_batch(batch, m, kb, km, signs, masks, dest, bf16,
                               idx, vals)
        return torch.cat(idx), torch.cat(vals)

    def _encode_batch(self, batch, m, kb, km, signs, masks, dest, bf16,
                      idx, vals) -> None:
        """One encode call of consecutive blocks ``[(b, residual box,
        gradient box)]`` on one device (:meth:`encode_blocks`); appends
        their stream rows to ``idx`` / ``vals``."""
        f32 = torch.float32
        b0, dev, n = batch[0][0], batch[0][1].device, len(batch)
        # each temporary goes once read: a Yi-6B block is 2.9 GB in f32
        with _stage("encode", self.timings, dev):
            acc = torch.empty((1, n, m), dtype=f32, device=dev)
            for j, (_, r, gb) in enumerate(batch):
                t = (_neg_lr(gb.to(torch.bfloat16).to(f32), self.lr) if bf16
                     else _neg_lr(gb, self.lr).to(f32))
                batch[j] = (None, r, None)
                del gb
                acc[0, j].view(r.shape).copy_(r).add_(t)
                del t
            mk = None if masks is None else tuple(
                x[b0:b0 + n].to(dev)[None] for x in masks)
            st, new = se.encode_batch_blocks(
                acc, kb, pair_signs=None if mk is None else signs,
                k_mask=0 if mk is None else km, masks=mk)
            del acc
            for j, (_, r, _) in enumerate(batch):
                r.copy_(new[0, j].view(r.shape))
            del new
            # the call's rows are blocks b0..: its indices j * m + col
            idx.append((st.indices[0].to(torch.int64) + b0 * m)
                       .to(torch.int32).to(dest))
            vals.append(st.values[0].to(dest))

    def update_param(self, params, named, name: str, value, sl=None) -> None:
        """``_update`` of one parameter by the aggregate ``value`` (whole,
        or slice ``k`` of it viewed as ``[per, *slice_shape]`` with ``sl =
        (per, slice_shape, k)``): in place, or on sharded parameters each
        chunk by its piece of ``value`` on the chunk's device (its block
        along the split dims, which lie within the slice), each copy of a
        whole one by all of it."""
        if named is not None:
            p = named[name]
            if sl is not None:
                p = p.reshape((sl[0],) + sl[1])[sl[2]]
            _update(p, value, self.server_lr)
            return
        seen = set()
        for c, chunk in enumerate(params.chunks):
            t = chunk[name]
            if id(t) in seen:
                continue
            seen.add(id(t))
            if sl is None:
                view, piece = t, params.block(c, name, value)
            else:
                per, slice_shape, k = sl
                lead = len(params.shapes[name]) - len(slice_shape)
                view = t.reshape((per,) + tuple(t.shape[lead:]))[k]
                piece = params.block(c, name, value, lead)
            _update(view, piece.to(t.device), self.server_lr)

    def __call__(self, params, residuals, batch, round_key, *,
                 timings: dict | None = None, record: list | None = None):
        """One step: ``(params, residuals, mean loss)``; both updated in
        place, the loss on the parameters' device. ``timings`` (a dict)
        collects each stage's wall ms, summed over the participants and
        units (``grads``, ``masks``, ``encode``, ``decode``, ``update``);
        ``record`` as :meth:`exchange`'s."""
        self.timings = timings
        home = self.device(params)
        losses = []

        def grads():
            for loss, g in self.gradients(params, batch):
                losses.append(loss.to(home, torch.float32))
                yield g
                del g

        try:
            self.exchange(params, residuals, grads(), round_key,
                          record=record)
        finally:
            self.timings = None
        return params, residuals, torch.stack(losses).mean()


class FLTrainStep(_FLStep):
    """``make_fl_train_step``'s step (the reference's v1: the encode and
    exchange of each participant inside its shard_map region)."""

    def units(self, leaves, specs, sizes, leaf_k) -> list:
        """The step's encode/exchange units in order: ``(leaf_id, (i, lead,
        slice_shape) or None, nb, kb, k_mask, transform)``, one a whole
        leaf or a slice of a large stacked one."""
        use_aligned = os.environ.get("REPRO_FL_ALIGNED_BLOCKS", "0") == "1"
        plan = fl_leaf_plan(sizes, self.thgs, self.n_blocks)
        units = []
        for lid, (leaf, spec, (kb, nb)) in enumerate(zip(leaves, specs,
                                                         plan)):
            tr = (sharding_aligned_transform(leaf.shape, spec,
                                             self.axis_sizes, self.intra_axes)
                  if use_aligned else None)
            if tr is not None:
                nb = tr[2]
                kb = max(1, -(-leaf_k[lid] // nb))
            km = self.k_mask(sizes[lid], nb)
            lead, slice_shape = _slice_plan(leaf, spec)
            if tr is None and lead > 1 and sizes[lid] // lead >= 1 << 20:
                kb_s = max(1, -(-leaf_k[lid] // (nb * lead)))
                km_s = max(1, km // lead) if km else 0
                units += [(lid, (i, lead, slice_shape), nb, kb_s, km_s, None)
                          for i in range(lead)]
            else:
                units.append((lid, None, nb, kb, km, tr))
        return units

    def exchange(self, params, residuals, grads: Iterable, round_key,
                 *, record: list | None = None) -> None:
        """Encode every participant's update leaf by leaf (large stacked
        leaves slice by slice), then decode each (sub-)leaf's streams of all
        participants and update the parameters. ``record`` (a list)
        receives a dict a unit: ``leaf``, ``slice`` (None for a whole leaf),
        ``streams`` (one :class:`BlockedStream` a participant, on its
        device, as encoded), ``agg_absmax`` (a 0-d tensor: the
        aggregate's max magnitude), ``gathered_bytes`` (the gradient and
        residual bytes the unit's encodes assembled from chunks: ``Grads.
        full``, ``ChunkedRow.to`` / ``slice_to``, counted by
        ``fsdp.Tally``) and ``home_bytes`` (the bytes of every
        participant's stream, indices and values, that the decode reads at
        home)."""
        leaves, specs, sizes, leaf_k = self.layout(params)
        dev = self.device(params)
        units = self.units(leaves, specs, sizes, leaf_k)
        streams = [[] for _ in units]
        tallies = [fsdp.Tally() for _ in units]
        pid = 0
        # not enumerate(grads): its reused result tuple would keep the
        # previous participant's gradients while the next are made
        for g in grads:
            for u, unit in enumerate(units):
                streams[u].append(self.encode_unit(
                    unit, leaves[unit[0]], g, residuals, pid, round_key,
                    tally=tallies[u]))
            del g
            pid += 1
        sharded = isinstance(params, fsdp.ShardedLM)
        named = None if sharded else dict(params.named_parameters())
        for u, (lid, sl, nb, kb, km, tr) in enumerate(units):
            leaf = leaves[lid]
            n = (math.prod(sl[2]) if sl is not None else sizes[lid])
            with _stage("decode", self.timings, dev):
                dense = decode_blocked_sum(
                    torch.stack([st.indices.to(dev) for st in streams[u]]),
                    torch.stack([st.values.to(dev) for st in streams[u]]),
                    n, nb, weight=1.0 / self.n_fed, transform=tr)
            if record is not None:
                record.append({"leaf": lid,
                               "slice": None if sl is None else sl[0],
                               "streams": streams[u],
                               "agg_absmax": dense.abs().max(),
                               "gathered_bytes": tallies[u].bytes,
                               "home_bytes": sum(_stream_bytes(st)
                                                 for st in streams[u])})
            streams[u] = None
            # the aggregate takes the gradient's dtype (the parameter's, f32
            # when microbatches or groups add up) before the f32 update
            gdt = (torch.float32 if self.f32
                   else (params.dtypes[leaf.names[0]] if sharded
                         else named[leaf.names[0]].dtype))
            shape = leaf.shape[len(leaf.lead):]
            with _stage("update", self.timings, dev):
                if sl is not None:
                    i, lead, slice_shape = sl
                    per = lead // len(leaf.names)
                    self.update_param(
                        params, named, leaf.names[i // per],
                        dense.reshape(slice_shape).to(gdt),
                        (per, slice_shape, i % per))
                else:
                    parts = dense.to(gdt).reshape((-1,) + tuple(shape))
                    for j, name in enumerate(leaf.names):
                        self.update_param(params, named, name, parts[j])
            del dense

    def encode_unit(self, unit, leaf, g: dict, residuals, pid: int,
                    round_key, tally: fsdp.Tally | None = None) -> object:
        """Participant ``pid``'s stream of one (sub-)leaf, on its device;
        its residual row written in place. An aligned unit encodes each
        block where the participant holds it (:meth:`encode_blocks`); a
        unit of generic row blocks, on the participant's lead device, its
        gradient and residual chunks gathered there (``tally`` counts
        them)."""
        lid, sl, nb, kb, km, tr = unit
        dev = self.devices[pid]
        res = residuals[lid][pid]
        self.check_row(pid, res)
        tally = fsdp.Tally() if tally is None else tally
        if tr is not None:
            masks = signs = None
            if km:
                with _stage("masks", self.timings, dev):
                    m_idx, m_vals, signs_row = self.masks_for(
                        threefry.fold_in(round_key, lid), pid,
                        math.prod(leaf.shape), nb, km, tr, dev)
                masks, signs = (m_idx, m_vals), signs_row[None]
            return BlockedStream(*self.encode_blocks(
                pid, g, leaf, self.block_cuts(leaf), tr[3], kb, km, res,
                signs, masks, dev, bf16=False))
        chunked = isinstance(res, fsdp.ChunkedRow)
        if chunked:     # gather the unit's gradient and residual on dev
            per = 1 if sl is None else sl[1] // len(leaf.names)
            names = leaf.names if sl is None else [leaf.names[sl[0] // per]]
            g = {n: (g.full(n, dev, tally=tally) if isinstance(g, fsdp.Grads)
                     else g[n].to(dev)) for n in names}
        if sl is not None:
            i, lead, slice_shape = sl
            gi = _slice_of(g, leaf, lead, slice_shape, i).to(dev)
            ri = (res.slice_to(lead, slice_shape, i, dev, tally) if chunked
                  else res.reshape((lead,) + slice_shape)[i])
            key = (threefry.fold_in(threefry.fold_in(round_key, lid), i)
                   if km else None)
        else:
            gi = _stacked(g, leaf).to(dev)
            ri = res.to(dev, tally=tally) if chunked else res
            key = threefry.fold_in(round_key, lid) if km else None
        masks = None
        if key is not None:
            with _stage("masks", self.timings, dev):
                masks = self.masks_for(key, pid, gi.numel(), nb, km, tr, dev)
        with _stage("encode", self.timings, dev):
            st, r_new = encode_leaf_blocked(
                _neg_lr(gi, self.lr), ri, kb, nb, mask_key=key,
                k_mask_block=km, n_peers=self.n_fed, self_id=pid,
                mask_lo=self.sa.p, mask_q=self.sa.q, transform=tr,
                masks=masks)
            if chunked and sl is not None:
                res.put_slice(lead, slice_shape, i, r_new)
            elif chunked:
                res.copy_(r_new)
            else:
                ri.copy_(r_new)
        return st

    def block_cuts(self, leaf) -> list:
        """:func:`aligned_block_cuts` of a leaf under the step's rules."""
        spec = shd.param_specs({leaf.path: leaf.shape}, self.rules,
                               self.axis_sizes)[leaf.path]
        return aligned_block_cuts(leaf.shape, spec, self.axis_sizes,
                                  self.intra_axes)

    def masks_for(self, key, pid, size, nb, km, tr, dev):
        """Participant ``pid``'s keyed masks of a (sub-)leaf, the blocked
        layout's ``(m_idx, m_vals, signs_row)``."""
        if tr is not None:
            nb, m = tr[2], tr[3]
        else:
            nb, m, _ = block_layout(size, nb)
        keys_row, signs_row = se.fold_pair_keys_row(key, pid, self.n_fed)
        m_idx, m_vals = se.pairwise_mask_rows(
            keys_row, signs_row, nb, km, m, p=self.sa.p, q=self.sa.q,
            device=dev)
        return m_idx, m_vals, signs_row


class FLTrainStepV2(_FLStep):
    """``make_fl_train_step_v2``'s step: each participant's update encoded
    in place, one participant at a time as its gradients arrive, on the
    sharding-aligned block view (the generic row blocks when the spec has
    none, or with ``REPRO_FL_V2_GENERIC=1``); the exchange one scatter a
    leaf at home. An aligned block is encoded on the device that holds it
    (:meth:`_FLStep.encode_blocks`: a cell's own chunk of gradient and
    residual, the gradient cast to bf16 there), so only the stream rows
    travel home, as the reference's pinned ``P(fed_axis, front, None)``
    accumulator keeps the encode on each device's own block. A leaf of
    generic blocks is encoded whole on the participant's lead device, its
    chunks gathered there where the leaf is split."""

    def exchange(self, params, residuals, grads: Iterable, round_key,
                 *, record: list | None = None) -> None:
        """As :meth:`FLTrainStep.exchange`; a unit is a whole leaf and its
        ``streams`` one :class:`StreamBatch` ``[n_fed, nb, k_total]`` of
        every participant, at home. Each participant's gradients are
        consumed: a leaf's entries leave the participant's dict (or its
        ``fsdp.Grads``' chunks) once the leaf is encoded, and the
        participant is let go before the next one is asked for."""
        leaves, specs, sizes, leaf_k = self.layout(params)
        home = self.device(params)
        generic = os.environ.get("REPRO_FL_V2_GENERIC", "0") == "1"
        n_intra = math.prod(self.axis_sizes[a] for a in self.intra_axes)
        plans = []
        for lid, (leaf, spec) in enumerate(zip(leaves, specs)):
            tr = None if generic else sharding_aligned_transform(
                leaf.shape, spec, self.axis_sizes, self.intra_axes)
            if tr is not None:
                from_b, nb, m = tr[1], tr[2], tr[3]
                cuts = aligned_block_cuts(leaf.shape, spec, self.axis_sizes,
                                          self.intra_axes)
            else:
                nb, m, _ = block_layout(sizes[lid], n_intra)
                from_b = functools.partial(se.from_blocks, size=sizes[lid],
                                           shape=leaf.shape)
                cuts = None
            kb = max(1, min(m, -(-leaf_k[lid] // nb)))
            km = self.k_mask(sizes[lid], nb)
            keys = None
            if km > 0:
                with _stage("masks", self.timings, home):
                    keys = se.fold_pair_key_matrix(
                        threefry.fold_in(round_key, lid), self.n_fed)
            plans.append((from_b, nb, m, kb, km, keys, cuts))
        rows = [[] for _ in leaves]     # each participant's stream, at home
        tallies = [fsdp.Tally() for _ in leaves]
        pid = 0
        for g in grads:     # not enumerate: see FLTrainStep.exchange
            self.encode_participant(pid, g, leaves, plans, residuals, rows,
                                    tallies, home)
            del g       # let the participant go before asking for the next
            pid += 1
        named = (None if isinstance(params, fsdp.ShardedLM)
                 else dict(params.named_parameters()))
        for lid, leaf in enumerate(leaves):
            from_b, nb, m = plans[lid][:3]
            st = se.StreamBatch(torch.stack([r[0] for r in rows[lid]]),
                                torch.stack([r[1] for r in rows[lid]]))
            rows[lid] = None
            with _stage("decode", self.timings, home):
                # the reference divides by n_fed; XLA multiplies by the f32
                # reciprocal under jit (probed), which the weight reproduces
                dense = decode_blocked_sum(st.indices, st.values, nb * m, nb,
                                           weight=1.0 / self.n_fed)
                agg = from_b(dense.reshape(nb, m)).to(torch.float32)
            if record is not None:
                record.append({"leaf": lid, "slice": None, "streams": st,
                               "agg_absmax": dense.abs().max(),
                               "gathered_bytes": tallies[lid].bytes,
                               "home_bytes": _stream_bytes(st)})
            del st, dense
            with _stage("update", self.timings, home):
                parts = agg.reshape((-1,) + leaf.shape[len(leaf.lead):])
                for j, name in enumerate(leaf.names):
                    self.update_param(params, named, name, parts[j])
            del agg, parts

    def encode_participant(self, pid: int, g, leaves, plans, residuals,
                           rows, tallies, home) -> None:
        """Participant ``pid``'s stream of every leaf, appended to
        ``rows[leaf]`` at home; its residual rows written in place and
        each leaf's gradient dropped once encoded."""
        dev = self.devices[pid]
        for lid, leaf in enumerate(leaves):
            from_b, nb, m, kb, km, keys, cuts = plans[lid]
            res = residuals[lid][pid]
            self.check_row(pid, res)
            masks = signs = None
            if keys is not None:
                with _stage("masks", self.timings, dev):
                    masks = se.pairwise_mask_rows(
                        keys[0][pid], keys[1][pid], nb, km, m, p=self.sa.p,
                        q=self.sa.q, device=dev)
                signs = keys[1][pid:pid + 1]
            if cuts is not None:
                idx, vals = self.encode_blocks(
                    pid, g, leaf, cuts, m, kb, km, res, signs, masks, home,
                    bf16=True)
            else:
                idx, vals = self.encode_generic(
                    pid, g, leaf, nb, m, kb, km, res, tallies[lid], signs,
                    masks)
            rows[lid].append((idx.to(home), vals.to(home)))
            if isinstance(g, fsdp.Grads):
                g.drop(leaf.names)
            else:
                for name in leaf.names:
                    g.pop(name, None)

    def encode_generic(self, pid: int, g, leaf, nb: int, m: int, kb: int,
                       km: int, res, tally: fsdp.Tally, signs, masks):
        """Participant ``pid``'s stream of a leaf of generic row blocks,
        encoded whole on its lead device (a chunked leaf's gradient, cast
        to bf16 chunk by chunk, and residual gathered there; the new
        residual written back): ``(int32[nb, k_total], f32[nb,
        k_total])`` there."""
        dev = self.devices[pid]
        f32 = torch.float32
        r = res.to(dev, tally=tally) if isinstance(res, fsdp.ChunkedRow) \
            else res
        gw = ({n: g.full(n, dev, torch.bfloat16, tally) for n in leaf.names}
              if isinstance(g, fsdp.Grads) else g)
        with _stage("encode", self.timings, dev):
            acc = (se.to_blocks(r.to(f32), nb, m) + se.to_blocks(_neg_lr(
                _stacked(gw, leaf).to(dev, torch.bfloat16).to(f32), self.lr),
                nb, m))[None]
            del r, gw
            mk = None if masks is None else (masks[0][None], masks[1][None])
            st, new = se.encode_batch_blocks(
                acc, kb, pair_signs=None if mk is None else signs,
                k_mask=0 if mk is None else km, masks=mk)
            del acc
            res.copy_(se.from_blocks(new[0], math.prod(leaf.shape),
                                     leaf.shape))
        return st.indices[0], st.values[0]


def make_fl_train_step(cfg: ArchConfig, mesh, fed_axis: str,
                       thgs: THGSConfig, sa: SecureAggConfig,
                       lr: float = 0.01, server_lr: float = 1.0,
                       n_micro: int = 1, groups=None) -> FLTrainStep:
    """``step(params, residuals, batch, round_key) -> (params, residuals,
    loss)``: the reference's v1 FL step on a ``LogicalMesh``. ``round_key``
    is a threefry key (``core.threefry.key``). Each participant's groups
    are ``launch.mesh.participant_groups``', or ``groups`` (one list a
    participant, devices may repeat); a participant of several groups
    takes sharded parameters (``launch.fsdp``)."""
    return FLTrainStep(cfg, mesh, fed_axis, thgs, sa, lr, server_lr,
                       n_micro, groups)


def make_fl_train_step_v2(cfg: ArchConfig, mesh, fed_axis: str,
                          thgs: THGSConfig, sa: SecureAggConfig,
                          lr: float = 0.01, server_lr: float = 1.0,
                          n_micro: int = 1, groups=None) -> FLTrainStepV2:
    """The reference's v2 (GSPMD-first) FL step on a ``LogicalMesh``
    (``groups`` as :func:`make_fl_train_step`'s)."""
    return FLTrainStepV2(cfg, mesh, fed_axis, thgs, sa, lr, server_lr,
                         n_micro, groups)
