"""Tensor parallelism over ``model`` inside one participant: the port's
counterpart of GSPMD partitioning the reference's training step by its
``param_specs`` (``launch/shardings.py``) and its model code's activation
constraints (``repro/models/transformer.py``, ``attention.py``, ``moe.py``).

One process drives every position of a participant's ``(data group, model
position)`` grid (``launch.mesh.participant_groups``; the parameters are a
``launch.fsdp.ShardedLM`` over it). A data group's ``m`` model positions
compute its rows together, Megatron-style:

* **Residual stream.** Between blocks it is split by sequence, position
  ``j`` holding rows ``[j T/m, (j+1) T/m)`` (the reference's ``("batch",
  "seq", None)``), where ``m`` divides ``T``; otherwise every position
  holds it whole (bit-equal copies on one device type). Norms run on each
  position's slice; the normed input is all-gathered along the sequence
  before the projections (the reference's ``("batch", None, None)``).
* **Self- and cross-attention.** Position ``j`` runs query heads ``[j H/m,
  (j+1) H/m)`` (the reference's ``"heads"``; an uneven split where ``m``
  does not divide ``H``). ``wq`` is column-parallel: a position reads its
  own ``model`` chunk where the chunk is exactly its heads' columns. ``wk`` /
  ``wv`` are split the same way only where their chunk holds exactly the
  KV heads its queries read (GQA: the split falls on KV-head boundaries and
  the position's query heads map onto its own KV heads, e.g. Yi-6B at
  model 2); otherwise each position gathers ``wk`` / ``wv`` whole at use
  and takes the KV heads its queries need (Granite-20B's single KV head,
  ``model > n_kv``, Yi-6B's 512-wide ``wk`` at model 8 or 16). ``wo`` is
  row-parallel: its partial sums are reduce-scattered back to the sequence
  slices. Cross-attention reads its K/V from the image embeddings, whole on
  every position.
* **Dense MLP.** ``wi`` / ``wi_gate`` / ``wi_up`` column-parallel, ``wo``
  row-parallel, reduce-scattered.
* **MoE, expert-parallel** (the reference's ``"expert"`` axis, which maps
  to ``model``). A dispatch group is a row of the batch at its whole
  length, as in the reference: capacity and the stable sort by expert
  depend on the whole row. Position 0 routes the whole normed rows once
  (the router is whole along ``model``) and broadcasts each token's expert
  ids and gates, so that no two positions can disagree on a near-tie;
  every position derives the dispatch slots from those ids by integer ops
  alone, the same on any device type. Position ``j`` then fills the
  dispatch slots of its own experts ``[j E/m, (j+1) E/m)`` only (each
  assignment's slot from the whole row's sorted order) and runs
  ``wi_gate`` / ``wi_up`` / ``wo`` on its own ``model`` chunk (its span of
  the whole where ``m`` does not divide E). It forms, for every token and
  rank, ``gate * y_expert`` (f32, cast to the model dtype) of its own
  experts and +0.0 elsewhere, and an all-to-all hands each position its
  sequence slice of every position's ``[B, T/m, k, d]`` (an all-gather
  where the stream is whole). Each position takes each rank's value from
  the position owning that rank's expert and folds a token's ``top_k``
  values in ascending expert id from +0.0, as ``moe.apply_moe`` does: the
  exchange moves values and never sums them, so the routed output is
  bit-equal to ``apply_moe``'s on the same rows. The shared experts are a
  dense MLP (column- / row-parallel, reduce-scattered) added after the
  routed output; the aux loss comes from position 0's whole-row
  probabilities.
* **Embedding.** Split by feature (``"embed": (None, "model")``): each
  position looks up its own columns for every token, then an all-to-all
  hands each position its sequence slice of whole rows.
* **Loss.** Vocab-parallel over ``lm_head``: each position computes its
  vocab chunk's logits; the max, the sums of exponentials and the gold
  logit (from the position that owns it) combine on the lead position in
  position order, per 128-token chunk, recomputed in the backward. With
  tied embeddings (xLSTM) ``embed.T`` is split along the contraction, so
  the positions' partial logits are reduced whole at the loss.
* **The Mamba2 mixer, head-split** (the reference's ``"heads"``, which
  maps to ``model``). Each position norms its stream slice and the normed
  rows are all-gathered. Position ``j`` runs SSM heads ``[j H/m, (j+1)
  H/m)`` (uneven where ``m`` does not divide H): it reads the ``in_proj``
  columns of their z, x and dt and of their groups' B and C, and the
  ``conv_w`` / ``conv_b`` channels of their x, B and C
  (``ssm.head_columns``), each from the chunks that hold them
  (:meth:`GridView.cols`: the reference's column split does not fall on
  head boundaries), and ``A_log`` / ``D`` / ``dt_bias`` of its heads;
  the conv, the chunked scan and the z gate run on those heads alone
  (``ssm.ssd_heads``), and ``out_proj`` is row-parallel on their rows,
  its partial sums reduce-scattered back to the stream's slices.
* **The xLSTM cells, head-split.** Position ``j`` runs cell heads ``[j
  H/m, (j+1) H/m)`` on the gathered rows: the sLSTM the four gates'
  ``w_in`` / ``b`` columns of those heads and their ``r`` rows, every
  position's heads advanced in one host loop over ``t`` (so positions on
  two devices run side by side); the mLSTM q, k, v of those heads from
  ``w_qkv``, their i and f columns of ``w_if`` and their ``w_o``
  columns. ``w_out`` is row-parallel, reduce-scattered. A position with
  no head (4 heads over 8 positions) contributes zeros. A recurrence
  depends on its head's columns alone, so splitting by head changes no
  recurrence; only the row-parallel product and the narrower column
  products round otherwise.

Serving over the same grid (``launch/tp_serve.py``) runs these blocks
and collectives forward only, with the flash kernel in the prefill, a KV
cache split by sequence over ``model`` in the decode, and the recurrent
cells' per-position partials and final states (:func:`ssm_partials`,
:func:`xlstm_partials`).

**Collectives, in position order.** :func:`all_gather`,
:func:`reduce_scatter`, :func:`all_reduce`, :func:`all_to_all`,
:func:`broadcast`, :func:`scatter` and :func:`reduce_to` are
``torch.autograd.Function`` s over one tensor a position, each with its
adjoint as its backward (all-gather and reduce-scatter; all-reduce and
itself, the identity on the reduced value; broadcast and reduce;
all-to-all and its inverse); :func:`max_to` (the loss's running max)
carries no gradient. Moves between devices are ``Tensor.to``; no
``torch.distributed``, no host sync between devices. **Every sum adds the
positions' partials in position order, starting from partial 0, in f32,
and rounds once to the partials' dtype.** A result is therefore independent
of where the positions lie: ``m`` positions on one device and on ``m``
devices of one type give the same bits, and replicated activations are
bit-identical on every position.

**Gradients.** Each position reads every parameter through its own leaf
(a detached alias of the stored chunk or copy), so autograd never adds two
positions' contributions itself: :func:`group_value_and_grad` hands
back each block's partial gradients in position order, and
``launch.fsdp.step_gradients`` adds them in that order in f32
(:func:`fold`; the gradient of a leaf replicated across model
positions, such as a norm scale, is the sum of every position's partial;
a routed expert's arises only on the position that owns it, and the MoE
router's only on position 0, which routes),
then folds the sums in (data group, microbatch) order as without tensor
parallelism; one group of one microbatch rounds each sum once to the
parameter's dtype, as one device's step keeps it.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import _split_heads, attend_chunked
from repro_torch.models.layers import apply_norm, apply_rope, embed_lookup

F = torch.nn.functional


# ---------------------------------------------------------------- collectives
def fold(parts, device, dtype=None) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` on ``device``, added in that order in
    f32 and rounded once to ``dtype`` (default ``parts[0]``'s; a new
    tensor)."""
    acc = parts[0].to(device=device, dtype=torch.float32, copy=True)
    for p in parts[1:]:
        acc += p.to(device=device, dtype=torch.float32)
    return acc.to(parts[0].dtype if dtype is None else dtype)


def _pieces(n: int, m: int) -> list:
    """``(offset, length)`` of ``m`` equal pieces of ``n``."""
    per = n // m
    return [(i * per, per) for i in range(m)]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim = dim
        ctx.devices = [x.device for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        return tuple(torch.cat([x.to(d) for x in xs], dim)
                     for d in ctx.devices)

    @staticmethod
    def backward(ctx, *gs):
        out, off = [], 0
        for dev, n in zip(ctx.devices, ctx.sizes):
            out.append(fold([g.narrow(ctx.dim, off, n) for g in gs], dev))
            off += n
        return (None, *out)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, pieces, *parts):
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        return tuple(fold([p.narrow(dim, off, n) for p in parts], dev)
                     for dev, (off, n) in zip(ctx.devices, pieces))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *(torch.cat([g.to(d) for g in gs], ctx.dim)
                              for d in ctx.devices))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.devices = [p.device for p in parts]
        return tuple(fold(parts, d) for d in ctx.devices)

    @staticmethod
    def backward(ctx, *gs):
        return tuple(fold(gs, d) for d in ctx.devices)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split_dim, cat_dim, pieces, *xs):
        ctx.split_dim, ctx.cat_dim = split_dim, cat_dim
        ctx.devices = [x.device for x in xs]
        ctx.sizes = [x.shape[cat_dim] for x in xs]
        return tuple(torch.cat([x.narrow(split_dim, off, n).to(d)
                                for x in xs], cat_dim)
                     for d, (off, n) in zip(ctx.devices, pieces))

    @staticmethod
    def backward(ctx, *gs):
        out, off = [], 0
        for dev, n in zip(ctx.devices, ctx.sizes):
            out.append(torch.cat([g.narrow(ctx.cat_dim, off, n).to(dev)
                                  for g in gs], ctx.split_dim))
            off += n
        return (None, None, None, *out)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, x):
        ctx.device = x.device
        return tuple(x.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *gs):
        return None, fold(gs, ctx.device)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, x):
        ctx.dim, ctx.device = dim, x.device
        return tuple(x.narrow(dim, off, n).to(d, copy=True)
                     for d, (off, n) in zip(devices, _pieces(x.shape[dim],
                                                             len(devices))))

    @staticmethod
    def backward(ctx, *gs):
        return None, None, torch.cat([g.to(ctx.device) for g in gs],
                                     ctx.dim)


class _ReduceTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, device, *parts):
        ctx.devices = [p.device for p in parts]
        return fold(parts, device)

    @staticmethod
    def backward(ctx, g):
        return (None, *(g.to(d, copy=True) for d in ctx.devices))


def all_gather(xs, dim: int) -> list:
    """Every position's ``x`` concatenated along ``dim``, on each position's
    device (backward: reduce-scatter)."""
    return list(_AllGather.apply(dim, *xs))


def reduce_scatter(parts, dim: int, pieces=None) -> list:
    """Position ``i``: the sum of every position's ``i``-th equal piece
    along ``dim``, or its ``pieces[i]`` ``(offset, length)`` (backward:
    all-gather)."""
    if pieces is None:
        pieces = _pieces(parts[0].shape[dim], len(parts))
    return list(_ReduceScatter.apply(dim, pieces, *parts))


def all_reduce(parts) -> list:
    """The sum of the positions' partials on every position (backward: the
    sum of the copies' gradients to every partial)."""
    return list(_AllReduce.apply(*parts))


def all_to_all(xs, split_dim: int, cat_dim: int, pieces=None) -> list:
    """Position ``i``: every position's ``i``-th equal piece along
    ``split_dim``, or its ``pieces[i]`` ``(offset, length)``, concatenated
    along ``cat_dim`` (backward: the inverse exchange)."""
    if pieces is None:
        pieces = _pieces(xs[0].shape[split_dim], len(xs))
    return list(_AllToAll.apply(split_dim, cat_dim, pieces, *xs))


def broadcast(x: torch.Tensor, devices) -> list:
    """``x`` copied to every device (backward: the copies' gradients
    summed onto ``x``'s device)."""
    return list(_Broadcast.apply(tuple(devices), x))


def scatter(x: torch.Tensor, devices, dim: int) -> list:
    """``x``'s equal pieces along ``dim``, one to each device (backward:
    concatenated back)."""
    return list(_Scatter.apply(dim, tuple(devices), x))


def reduce_to(parts, device) -> torch.Tensor:
    """The sum of the positions' partials on ``device`` (backward: the
    gradient copied to every partial)."""
    return _ReduceTo.apply(device, *parts)


def max_to(parts, device) -> torch.Tensor:
    """The elementwise max of the positions' values on ``device``, taken in
    position order; no gradient."""
    return functools.reduce(torch.maximum, [p.detach().to(device)
                                            for p in parts])


def all_max(parts) -> list:
    """:func:`max_to` on every position's device (one exchange: the max
    is exact, so every copy holds the same bits); no gradient."""
    mx = max_to(parts, parts[0].device)
    return [mx.to(p.device) for p in parts]


class _Remat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, n_in, *args):
        ctx.fn, ctx.n_in = fn, n_in
        ctx.save_for_backward(*args[:n_in])
        ctx.params = args[n_in:]
        with torch.no_grad():
            outs = fn(*args[:n_in])
        return tuple(o.clone() if any(o is a for a in args) else o
                     for o in outs)

    @staticmethod
    def backward(ctx, *gouts):
        ins = [a.detach().requires_grad_(a.requires_grad)
               for a in ctx.saved_tensors]
        wrt = [x for x in (*ins, *ctx.params) if x.requires_grad]
        with torch.enable_grad():
            outs = ctx.fn(*ins)
        pairs = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True))
        return (None, None, *(next(grads) if x.requires_grad else None
                              for x in (*ins, *ctx.params)))


def remat(fn, inputs, params=()) -> tuple:
    """``fn(*inputs)`` (a tuple of tensors) saving only ``inputs``: the
    backward recomputes it once, inside this node's own backward, and
    hands back the gradients of ``inputs`` and of ``params`` (the leaves
    ``fn`` reads besides). ``torch.utils.checkpoint``'s saved-tensor hooks
    recompute a frame from whichever device thread unpacks a tensor first,
    and the autograd engine unpacks a frame that spans devices from
    several threads at once."""
    return _Remat.apply(fn, len(inputs), *inputs, *params)


# ------------------------------------------------------------- the grid view
def nested(names, prefix: str, fetch) -> dict:
    """``{name: fetch(name)}`` for the names under ``prefix``, as the
    nested mapping (prefix stripped, split at the dots) that the model's
    functions read."""
    out: dict = {}
    for name in names:
        if name.startswith(prefix):
            *path, leaf = name[len(prefix):].split(".")
            node = out
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = fetch(name)
    return out


def _span(j: int, m: int, n: int) -> tuple[int, int]:
    """Position ``j``'s share ``[lo, hi)`` of ``n`` (heads, columns,
    vocab): equal where ``m`` divides ``n``, else as even as can be."""
    return j * n // m, (j + 1) * n // m


class GridView:
    """Data group ``g``'s view of a grid's parameters: each model
    position reads through aliases of the stored tensors (module
    docstring), gathered on its device. ``reads`` lists ``(position,
    logical key, alias)`` in the order they were made."""

    def __init__(self, lm, g: int):
        self.lm, self.g, self.m = lm, g, lm.n_model
        self.devices = [lm.cells[lm.cell(g, j)][2] for j in range(self.m)]
        self.reads: list = []
        self._alias: dict = {}

    def _read(self, j: int, name: str, h: int, i: int) -> torch.Tensor:
        lm = self.lm
        c = lm.cell(h if lm.dims[name] is not None else self.g,
                    i if lm.mdims[name] is not None else j)
        t = lm.chunks[c][name]
        a = self._alias.get((j, id(t)))
        if a is None:
            a = self._alias[(j, id(t))] = t.detach().requires_grad_(True)
            self.reads.append((j, lm.logical_key(c, name), a))
        return a

    def chunk(self, j: int, name: str, i: int, dim: Optional[int] = None,
              start: int = 0, length: int = 0) -> torch.Tensor:
        """Model chunk ``i`` of ``name`` (all of it where ``model`` does
        not split it), whole along data, on position ``j``'s device; with
        ``dim``, only its ``[start, start + length)`` along ``dim`` (cut
        where the chunk lies, before it moves)."""
        d, dev = self.lm.dims[name], self.devices[j]

        def piece(h):
            t = self._read(j, name, h, i)
            return (t if dim is None else t.narrow(dim, start, length)).to(
                dev)
        if d is None:
            return piece(self.g)
        return torch.cat([piece(h) for h in range(len(self.lm.groups))], d)

    def own(self, j: int, name: str) -> torch.Tensor:
        """What position ``j`` holds of ``name``, whole along data."""
        return self.chunk(j, name, j)

    def whole(self, j: int, name: str) -> torch.Tensor:
        """``name`` whole on position ``j``'s device."""
        md = self.lm.mdims[name]
        if md is None:
            return self.own(j, name)
        return torch.cat([self.chunk(j, name, i) for i in range(self.m)], md)

    def part(self, j: int, name: str, dim: int, lo: int,
             hi: int) -> torch.Tensor:
        """``name``'s ``[lo, hi)`` along ``dim`` on position ``j``'s device:
        its own chunk where that is exactly the chunk, else a slice of the
        whole (gathered at use)."""
        lm = self.lm
        if lm.mdims[name] == dim and lm.mextent(j, name) == (lo, hi - lo):
            return self.own(j, name)
        return self.whole(j, name).narrow(dim, lo, hi - lo)

    def cols(self, j: int, name: str, dim: int, runs) -> torch.Tensor:
        """``name``'s runs ``[(start, stop)]`` along ``dim``, concatenated
        in order on position ``j``'s device. Each run is read from the
        chunks that hold it, each chunk cut to the run where it lies: a
        position moves only what it reads, and reads another position's
        chunk only where a run overlaps it."""
        lm, md = self.lm, self.lm.mdims[name]
        pieces = []
        for a, b in runs:
            if md is None:
                pieces.append(self.own(j, name).narrow(dim, a, b - a))
            elif md != dim:
                pieces.append(torch.cat([self.chunk(j, name, i, dim, a,
                                                    b - a)
                                         for i in range(self.m)], md))
            else:
                per = lm.shapes[name][md] // self.m
                for i in range(a // per, (b - 1) // per + 1):
                    lo, hi = max(a, i * per), min(b, (i + 1) * per)
                    pieces.append(self.chunk(j, name, i, dim, lo - i * per,
                                             hi - lo))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

    def leaves(self, prefix: str) -> list:
        """Every alias a position may read of the parameters under
        ``prefix`` (made here if not yet), for :func:`remat`."""
        lm, out = self.lm, {}
        for name in lm.shapes:
            if name.startswith(prefix):
                for j in range(self.m):
                    for h in range(len(lm.groups)):
                        for i in range(self.m):
                            a = self._read(j, name, h, i)
                            out[id(a)] = a
        return list(out.values())

    def tree(self, j: int, prefix: str) -> dict:
        """The parameters under ``prefix`` whole on position ``j``'s
        device, as the nested mapping the model's functions read."""
        return nested(self.lm.shapes, prefix,
                      lambda name: self.whole(j, name))


class Stream:
    """How a group's residual stream lies on its positions: split by
    sequence where ``m`` divides ``T``, else whole on every position."""

    def __init__(self, devices, t: int):
        self.devices, self.m = list(devices), len(devices)
        self.split = t % self.m == 0

    def gather(self, xs) -> list:
        """Each position's slices whole on every position."""
        return all_gather(xs, 1) if self.split else list(xs)

    def reduce(self, parts) -> list:
        """Row-parallel partial sums back to the stream's layout."""
        return reduce_scatter(parts, 1) if self.split else all_reduce(parts)

    def inputs(self, x: torch.Tensor) -> list:
        """A whole input (no gradient) to the stream's layout."""
        pieces = (_pieces(x.shape[1], self.m) if self.split
                  else [(0, x.shape[1])] * self.m)
        return [x.narrow(1, off, n).to(d)
                for d, (off, n) in zip(self.devices, pieces)]


# ---------------------------------------------------------------- the blocks
def _norms(view: GridView, prefix: str, xs, cfg: ArchConfig) -> list:
    return [apply_norm(view.tree(j, prefix), x, cfg.norm)
            for j, x in enumerate(xs)]


def query_heads(j: int, m: int, cfg: ArchConfig) -> tuple:
    """Position ``j``'s query heads ``[lo, hi)`` and the KV head each
    reads."""
    lo, hi = _span(j, m, cfg.n_heads)
    per_kv = cfg.n_heads // cfg.n_kv_heads
    return lo, hi, [(lo + i) // per_kv for i in range(hi - lo)]


def project_heads(view: GridView, j: int, name: str, x: torch.Tensor,
                  lo: int, hi: int, hd: int) -> torch.Tensor:
    """``x`` times the columns of heads ``[lo, hi)`` of ``name`` (wq, wk,
    wv), split into heads ``[..., hi - lo, hd]``."""
    return _split_heads(x @ view.part(j, name, 1, lo * hd, hi * hd), hi - lo,
                        hd)


def for_queries(k: torch.Tensor, v: torch.Tensor, kmap: list,
                klo: int) -> tuple:
    """K/V of heads ``[klo, ...)`` laid out for the query heads that read
    KV heads ``kmap``: as they are where those are GQA groups, else one a
    query head."""
    nq, nk = len(kmap), k.shape[2]
    if nq % nk or kmap != [klo + i // (nq // nk) for i in range(nq)]:
        sel = torch.tensor([x - klo for x in kmap], device=k.device)
        return k[:, :, sel], v[:, :, sel]
    return k, v


def attention_partials(view: GridView, prefix: str, hs, cfg: ArchConfig, *,
                       causal: bool, window: Optional[int],
                       kv_srcs=None) -> list:
    """Each position's ``wo`` partial sum ``[B, T, d]`` of the attention
    under ``prefix`` (``...attn.``) on its whole normed input ``hs[j]``;
    ``kv_srcs`` (one a position): cross-attention's K/V source, no
    rotation (module docstring)."""
    hd = cfg.hd
    out = []
    for j, h in enumerate(hs):
        b, t, _ = h.shape
        lo, hi, kmap = query_heads(j, view.m, cfg)
        if hi == lo:
            out.append(h.new_zeros((b, t, cfg.d_model)))
            continue
        klo, khi = kmap[0], kmap[-1] + 1
        src = h if kv_srcs is None else kv_srcs[j]
        q = project_heads(view, j, prefix + "wq", h, lo, hi, hd)
        k = project_heads(view, j, prefix + "wk", src, klo, khi, hd)
        v = project_heads(view, j, prefix + "wv", src, klo, khi, hd)
        if kv_srcs is None:
            positions = torch.arange(t, device=h.device)[None, :]
            q = apply_rope(q, positions, cfg.rope)
            k = apply_rope(k, positions, cfg.rope)
        k, v = for_queries(k, v, kmap, klo)
        o = attend_chunked(q, k, v, hd=hd, causal=causal, window=window)
        out.append(o.reshape(b, t, (hi - lo) * hd)
                   @ view.part(j, prefix + "wo", 0, lo * hd, hi * hd))
    return out


def mlp_partials(view: GridView, prefix: str, hs, cfg: ArchConfig, *,
                 width: Optional[int] = None,
                 act: Optional[str] = None) -> list:
    """Each position's ``wo`` partial sum of the dense MLP whose leaves are
    ``prefix`` + ``wi_gate`` / ``wi_up`` / ``wi`` / ``wo`` (``...mlp.``;
    ``...moe.shared_`` for the shared experts, ``width`` their hidden
    width, ``act`` "swiglu"): its share of the hidden columns."""
    width = cfg.d_ff if width is None else width
    act = cfg.act if act is None else act
    out = []
    for j, h in enumerate(hs):
        lo, hi = _span(j, view.m, width)
        if hi == lo:
            out.append(h.new_zeros(h.shape))
            continue
        if act == "swiglu":
            a = (F.silu(h @ view.part(j, prefix + "wi_gate", 1, lo, hi))
                 * (h @ view.part(j, prefix + "wi_up", 1, lo, hi)))
        else:
            a = F.gelu(h @ view.part(j, prefix + "wi", 1, lo, hi),
                       approximate="tanh")
        out.append(a @ view.part(j, prefix + "wo", 0, lo, hi))
    return out


def moe_routed(view: GridView, prefix: str, cfg: ArchConfig, st: Stream,
               hs) -> tuple:
    """The routed experts under ``prefix`` (``...moe.``) over the
    positions, on the whole normed rows ``hs[j]`` (module docstring):
    returns (each position's routed output in the stream's layout, the aux
    loss on position 0). Position 0 routes; the ids and gates are
    broadcast (the gates' gradients come back to position 0 by the
    broadcast's adjoint). Bit-equal to ``moe.apply_moe``'s routed output
    on the same rows, whatever the other positions' router copies hold."""
    spec = cfg.moe
    e, k, m = spec.n_experts, spec.top_k, view.m
    b, t, d = hs[0].shape
    probs, gate_vals, eidx = moe_mod.router(
        {"router": view.own(0, prefix + "router")}, hs[0], spec)
    aux = moe_mod.aux_loss(probs, eidx, spec)
    eidxs = broadcast(eidx, view.devices)
    gates = broadcast(gate_vals, view.devices)
    owner = torch.tensor([j for j in range(m)
                          for _ in range(*_span(j, m, e))])
    cap = moe_mod.capacity(t, spec)
    sends, owners = [], []
    for j, (h, ej, gj) in enumerate(zip(hs, eidxs, gates)):
        lo, hi = _span(j, m, e)
        buf, slot, order = moe_mod._dispatch(h, ej, e, k, cap, (lo, hi))
        slot_u, gate_u, by_e = moe_mod._ranked(slot, order, ej, gj)
        if hi > lo:
            yexp = moe_mod.experts(
                buf, *[view.part(j, prefix + n, 0, lo, hi)
                       for n in ("wi_gate", "wi_up", "wo")])
            flat = yexp.reshape(b, (hi - lo) * cap, d)
            c = torch.stack([moe_mod._gated(flat, slot_u[:, :, r],
                                            gate_u[:, :, r], h.dtype)
                             for r in range(k)], 2)
        else:
            c = h.new_zeros((b, t, k, d))
        sends.append(c[:, :, None])                 # [B, T, 1, k, d]
        owners.append(owner.to(h.device)[ej.gather(2, by_e)])
    got = all_to_all(sends, 1, 2) if st.split else all_gather(sends, 2)
    ys = []
    for j, (g, own) in enumerate(zip(got, owners)):   # g [B, T/m, m, k, d]
        n = g.shape[1]
        own = own.narrow(1, j * n if st.split else 0, n)
        sel = g[:, :, 0]
        for i in range(1, m):
            sel = torch.where((own == i)[..., None], g[:, :, i], sel)
        ys.append(moe_mod.fold_ranks(sel[:, :, r] for r in range(k)))
    return ys, aux


def moe_block(view: GridView, prefix: str, cfg: ArchConfig, st: Stream,
              hs) -> tuple:
    """The MoE layer under ``prefix`` (``...moe.``) over the positions:
    the routed experts (:func:`moe_routed`) plus the shared experts,
    column- / row-parallel and reduced to the stream's layout. Returns
    (each position's output slice, the aux loss on position 0)."""
    ys, aux = moe_routed(view, prefix, cfg, st, hs)
    if cfg.moe.n_shared:
        ss = st.reduce(mlp_partials(
            view, prefix + "shared_", hs, cfg, act="swiglu",
            width=cfg.moe.n_shared * cfg.moe.d_ff_expert))
        ys = [y + s for y, s in zip(ys, ss)]
    return ys, aux


def mlp_block(view: GridView, prefix: str, cfg: ArchConfig, st: Stream,
              xs, aux):
    """``x`` plus the pre-norm MLP (or MoE) of the block under ``prefix``
    on the stream's slices. Returns ``(xs, aux)``."""
    hs = st.gather(_norms(view, prefix + "mlp_norm.", xs, cfg))
    if cfg.family == "moe" and cfg.moe is not None:
        ys, a = moe_block(view, prefix + "moe.", cfg, st, hs)
        aux = aux + a
    else:
        ys = st.reduce(mlp_partials(view, prefix + "mlp.", hs, cfg))
    return [x + y for x, y in zip(xs, ys)], aux


def self_block(view: GridView, prefix: str, cfg: ArchConfig, st: Stream,
               xs, aux, *, causal: bool, window: Optional[int]):
    """Pre-norm attention + MLP (or MoE) on the stream's slices. Returns
    ``(xs, aux)``."""
    hs = st.gather(_norms(view, prefix + "attn_norm.", xs, cfg))
    a = st.reduce(attention_partials(view, prefix + "attn.", hs, cfg,
                                     causal=causal, window=window))
    return mlp_block(view, prefix, cfg, st, [x + y for x, y in zip(xs, a)],
                     aux)


def cross_block(view: GridView, prefix: str, cfg: ArchConfig, st: Stream,
                xs, imgs) -> list:
    hs = st.gather(_norms(view, prefix + "attn_norm.", xs, cfg))
    a = st.reduce(attention_partials(view, prefix + "attn.", hs, cfg,
                                     causal=False, window=None,
                                     kv_srcs=imgs))
    xs = [x + y for x, y in zip(xs, a)]
    hs = st.gather(_norms(view, prefix + "mlp_norm.", xs, cfg))
    ys = st.reduce(mlp_partials(view, prefix + "mlp.", hs, cfg))
    return [x + y for x, y in zip(xs, ys)]


def ssm_head_params(view: GridView, j: int, w: str, cfg: ArchConfig,
                    lo: int, hi: int) -> tuple:
    """Position ``j``'s reads of the mixer ``w`` (``...ssm.``) for SSM
    heads ``[lo, hi)``: (``conv_w`` / ``conv_b`` of their conv channels and
    ``A_log`` / ``D`` / ``dt_bias`` of the heads, the ``in_proj`` column
    runs and the conv channel runs they read; ``ssm.head_columns``)."""
    proj, conv = ssm_mod.head_columns(cfg.d_model, cfg.ssm, lo, hi)
    p = {"conv_w": view.cols(j, w + "conv_w", 1, conv),
         "conv_b": view.cols(j, w + "conv_b", 0, conv),
         **{n: view.cols(j, w + n, 0, [(lo, hi)])
            for n in ("A_log", "D", "dt_bias")}}
    return p, proj, conv


def ssm_partials(view: GridView, prefix: str, cfg: ArchConfig,
                 hs) -> tuple:
    """Each position's ``out_proj`` partial of the Mamba2 mixer under
    ``prefix`` (``ssm_blocks.s.i.``) on its whole normed rows ``hs[j]``,
    each position on its own heads (module docstring), and ``{j: (final
    state [B, h_j, N, P], its in_proj product [B, T, .])}`` of the
    positions with heads."""
    spec, w = cfg.ssm, prefix + "ssm."
    _, n_heads, _ = ssm_mod.dims(cfg.d_model, spec)
    parts, ran = [], {}
    for j, h in enumerate(hs):
        lo, hi = _span(j, view.m, n_heads)
        if hi == lo:
            parts.append(h.new_zeros(h.shape))
            continue
        p, proj, _ = ssm_head_params(view, j, w, cfg, lo, hi)
        zx = h @ view.cols(j, w + "in_proj", 1, proj)
        y, s = ssm_mod.ssd_heads(p, zx, spec, (lo, hi), n_heads)
        ran[j] = (s, zx)
        rows = [(lo * spec.head_dim, hi * spec.head_dim)]
        parts.append(y @ view.cols(j, w + "out_proj", 0, rows))
    return parts, ran


def ssm_mixer(view: GridView, prefix: str, cfg: ArchConfig, st: Stream,
              xs) -> list:
    """``x`` plus the Mamba2 mixer under ``prefix`` (``ssm_blocks.s.i.``)
    on the stream's slices, each position on its own heads (module
    docstring)."""
    hs = st.gather(_norms(view, prefix + "norm.", xs, cfg))
    parts, _ = ssm_partials(view, prefix, cfg, hs)
    return [x + y for x, y in zip(xs, st.reduce(parts))]


def xlstm_partials(view: GridView, prefix: str, cfg: ArchConfig, hs,
                   carries=None) -> tuple:
    """Each position's ``w_out`` partial of the xLSTM cell under ``prefix``
    (``slstm.i.`` or ``mlstm.i.``) on its whole rows ``hs[j]``, each
    position on its own heads (module docstring), and ``{j: the final
    state of its heads}`` of the positions with heads. ``carries[j]``: the
    state its heads start from (a decode step: ``T`` 1, the mLSTM's
    recurrent step); else the cell's initial state."""
    n_heads = cfg.n_heads
    d_inner, dh = xlstm_mod._cell_dims(cfg.d_model, n_heads)
    b, t, _ = hs[0].shape
    spans = {j: _span(j, view.m, n_heads) for j in range(view.m)}
    live = [j for j, (lo, hi) in spans.items() if hi > lo]

    def gates(j, n):        # gate-major columns of j's heads, n gates
        lo, hi = spans[j]
        return [(g * d_inner + lo * dh, g * d_inner + hi * dh)
                for g in range(n)]

    ys, states = {}, {}
    if prefix.startswith("slstm."):
        pres = [xlstm_mod.slstm_pre(
            hs[j], view.cols(j, prefix + "w_in", 1, gates(j, 4)),
            view.cols(j, prefix + "b", 0, gates(j, 4)),
            spans[j][1] - spans[j][0], dh) for j in live]
        rs = [view.cols(j, prefix + "r", 0, [spans[j]]) for j in live]
        outs = xlstm_mod.slstm_scan(pres, rs, [
            xlstm_mod.slstm_init(b, r.shape[0], dh, r.device)
            if carries is None else carries[j] for j, r in zip(live, rs)])
        for j, (h, c) in zip(live, outs):
            ys[j] = h.reshape(b, t, -1).to(hs[j].dtype)
            states[j] = c
    else:
        for j in live:
            lo, hi = spans[j]
            p = {"w_qkv": view.cols(j, prefix + "w_qkv", 1, gates(j, 3)),
                 "w_if": view.cols(j, prefix + "w_if", 1,
                                   [(lo, hi), (n_heads + lo, n_heads + hi)]),
                 "w_o": view.cols(j, prefix + "w_o", 1, [(lo * dh,
                                                           hi * dh)])}
            if carries is None:
                ys[j], states[j] = xlstm_mod.mlstm_heads(p, hs[j], hi - lo,
                                                         dh)
            else:
                ys[j], states[j] = xlstm_mod.mlstm_decode_heads(
                    p, hs[j], carries[j], hi - lo, dh)
    parts = [ys[j] @ view.cols(j, prefix + "w_out", 0,
                               [(spans[j][0] * dh, spans[j][1] * dh)])
             if j in ys else hs[j].new_zeros(hs[j].shape)
             for j in range(view.m)]
    return parts, states


def xlstm_cell(view: GridView, prefix: str, cfg: ArchConfig, st: Stream,
               xs) -> list:
    """``x`` plus the xLSTM cell under ``prefix`` (``slstm.i.`` or
    ``mlstm.i.``) on the stream's slices, each position on its own heads
    (module docstring)."""
    parts, _ = xlstm_partials(view, prefix, cfg, st.gather(xs))
    return [x + y for x, y in zip(xs, st.reduce(parts))]


# -------------------------------------------------------------- the forward
def forward(view: GridView, cfg: ArchConfig, st: Stream, xs, *,
            image_embeds=None):
    """The training forward of ``transformer.forward(..., train=True)``
    over a group's positions: ``xs`` the embedded input in the stream's
    layout. Returns (final-normed slices, aux loss on position 0), with
    the reference's checkpoints (:func:`remat`)."""
    causal = not cfg.encoder_only
    window = cfg.window

    def ckpt(fn, prefixes, *args):
        return remat(fn, args, [a for p in prefixes for a in view.leaves(p)])

    def self_fn(prefix):
        def run(aux, *xs):
            xs, aux = self_block(view, prefix, cfg, st, xs, aux,
                                 causal=causal, window=window)
            return (aux, *xs)
        return run

    aux = torch.zeros((), dtype=torch.float32, device=view.devices[0])
    if cfg.xlstm:
        for i in range(cfg.n_layers):
            xs = xlstm_cell(view, f"{'slstm' if i % 2 == 0 else 'mlstm'}."
                            f"{i // 2}.", cfg, st, xs)
    elif cfg.family == "vlm":
        imgs = [tf._image_embeds(cfg, image_embeds, xs[0].new_empty(0,
                                 device=d)) for d in view.devices]

        def vlm_super(s):
            def run(aux, *xs):
                for i in range(cfg.cross_attn_every):
                    prefix = f"self_blocks.{s}.{i}."
                    aux, *xs = ckpt(self_fn(prefix), [prefix], aux, *xs)
                xs = cross_block(view, f"cross_blocks.{s}.", cfg, st, xs,
                                 imgs)
                return (aux, *xs)
            return run

        for s in range(tf.n_super(cfg)):
            aux, *xs = ckpt(vlm_super(s), [f"self_blocks.{s}.",
                                           f"cross_blocks.{s}."], aux, *xs)
    elif cfg.family == "hybrid":
        def ssm_fn(prefix):
            def run(*xs):
                return tuple(ssm_mixer(view, prefix, cfg, st, xs))
            return run

        def hybrid_super(s):
            def run(aux, *xs):
                for i in range(cfg.shared_attn_every):
                    prefix = f"ssm_blocks.{s}.{i}."
                    xs = ckpt(ssm_fn(prefix), [prefix], *xs)
                return self_fn("shared_block.")(aux, *xs)
            return run

        for s in range(tf.n_super(cfg)):
            aux, *xs = ckpt(hybrid_super(s), [f"ssm_blocks.{s}.",
                                              "shared_block."], aux, *xs)
    else:
        for i in range(cfg.n_layers):
            prefix = f"blocks.{i}."
            aux, *xs = ckpt(self_fn(prefix), [prefix], aux, *xs)
    return _norms(view, "final_norm.", xs, cfg), aux


def embed(view: GridView, cfg: ArchConfig, st: Stream, tokens) -> list:
    """The embedded tokens in the stream's layout: each position looks up
    its own feature columns, then an all-to-all (all-gather where the
    stream is whole) hands out whole rows."""
    if view.lm.mdims["embed"] is None:
        toks = st.inputs(tokens)
        return [embed_lookup(view.own(j, "embed"), t)
                for j, t in enumerate(toks)]
    es = [embed_lookup(view.own(j, "embed"), tokens.to(d))
          for j, d in enumerate(view.devices)]
    return all_to_all(es, 1, 2) if st.split else all_gather(es, 2)


LOSS_CHUNK = 128     # tokens a chunk of the loss (``chunked_ce_loss``'s)


def vocab_parallel_ce(view: GridView, cfg: ArchConfig, hs, labels,
                      chunk: int = LOSS_CHUNK) -> torch.Tensor:
    """``transformer.chunked_ce_loss`` over the positions (module
    docstring): ``hs`` the final hidden whole on every position; the loss
    on position 0, f32."""
    t = hs[0].shape[1]
    chunk = min(chunk, t)
    lead, m = view.devices[0], view.m
    labels = labels.long()
    if cfg.tie_embeddings:
        spans = [_span(j, m, cfg.d_model) for j in range(m)]
        ws = [view.part(j, "embed", 1, lo, hi)
              for j, (lo, hi) in enumerate(spans)]
    else:
        spans = [_span(j, m, cfg.vocab) for j in range(m)]
        ws = [view.part(j, "lm_head", 1, lo, hi)
              for j, (lo, hi) in enumerate(spans)]
    live = [j for j, (lo, hi) in enumerate(spans) if hi > lo]

    def tied_chunk(lx, *args):
        hx, w = args[:m], args[m:]
        logits = reduce_to([hx[j][..., spans[j][0]:spans[j][1]] @ w[j].T
                            for j in live], lead).float()
        lse = torch.logsumexp(logits, -1)
        gold = logits.gather(-1, lx[..., None])[..., 0]
        return (torch.mean(lse - gold),)

    def split_chunk(lx, *args):
        hx, w = args[:m], args[m:]
        logits = {j: (hx[j] @ w[j]).float() for j in live}
        mx = max_to([logits[j].max(-1).values for j in live], lead)
        sums, golds = [], []
        for j in live:
            lo, hi = spans[j]
            lj = logits[j]
            sums.append(torch.exp(lj - mx.to(lj.device)[..., None]).sum(-1))
            y = lx.to(lj.device)
            inside = (y >= lo) & (y < hi)
            gj = lj.gather(-1, (y - lo).clamp(0, hi - lo - 1)[..., None])[
                ..., 0]
            golds.append(torch.where(inside, gj, torch.zeros_like(gj)))
        total, gold = reduce_to(sums, lead), reduce_to(golds, lead)
        return (torch.mean(mx + torch.log(total) - gold),)

    per_chunk = tied_chunk if cfg.tie_embeddings else split_chunk
    losses = [remat(per_chunk, (labels[:, s:s + chunk].to(lead),
                                *[h[:, s:s + chunk] for h in hs], *ws))[0]
              for s in range(0, t // chunk * chunk, chunk)]
    return torch.mean(torch.stack(losses))


def hidden(view: GridView, cfg: ArchConfig, batch: dict) -> tuple:
    """The final hidden state of ``batch`` over a group's model positions:
    ``(stream, each position's slice, aux loss)``."""
    t = batch["labels"].shape[1]
    st = Stream(view.devices, t)
    if cfg.family == "audio":
        xs = st.inputs(batch["frames"].to(tf.DTYPES[cfg.dtype]))
    else:
        xs = embed(view, cfg, st, batch["tokens"])
    hs, aux = forward(view, cfg, st, xs,
                      image_embeds=batch.get("image_embeds"))
    return st, hs, aux


def train_loss(view: GridView, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """``transformer.train_loss`` over a group's model positions, on
    position 0."""
    st, hs, aux = hidden(view, cfg, batch)
    return vocab_parallel_ce(view, cfg, st.gather(hs), batch["labels"]) + aux


def group_value_and_grad(lm, g: int, cfg: ArchConfig, batch: dict):
    """``(loss, {(name, data part, model part): [partial gradients]})`` of
    data group ``g``'s loss on ``batch`` over its model positions: each
    block's partials in position order, in the parameter's dtype
    (``launch.fsdp.step_gradients`` adds them with :func:`fold`; module
    docstring). Blocks the loss does not reach are left out."""
    view = GridView(lm, g)
    with torch.enable_grad():
        loss = train_loss(view, cfg, batch)
        order = sorted(range(len(view.reads)), key=lambda r: view.reads[r][0])
        grads = torch.autograd.grad(loss, [view.reads[r][2] for r in order],
                                    allow_unused=True)
    out: dict = {}
    for r, gr in zip(order, grads):
        if gr is not None:
            out.setdefault(view.reads[r][1], []).append(gr)
    return loss.detach(), out
