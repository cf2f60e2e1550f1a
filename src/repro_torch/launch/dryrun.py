"""Multi-pod dry run on the meta device — port of ``repro.launch.dryrun``.

The one entry point of the port that needs no card: every step is built on
PyTorch's ``meta`` device, where tensors have shapes and dtypes and no
storage, so nothing is allocated and nothing runs on a GPU. For each
(arch x input shape x mesh) combination this

  1. builds the production layout (``make_production_mesh``: data 16 x
     model 16, or pod 2 x data 16 x model 16) and its logical rules, with
     the reference's ``long_500k`` rewrite (the idle batch axes fold into
     the KV cache's sequence sharding);
  2. resolves the parameter, input and (``--fl``) residual specs with
     ``launch/shardings.param_specs`` and ``specs.input_pspecs``;
  3. traces the step on meta tensors under
     ``torch.utils.flop_counter.FlopCounterMode``;
  4. writes ``<out>/<arch>__<shape>__<mesh>[__fl][__kvint8].json``
     atomically, one record per combination.

The port has no XLA compiler, so a record holds what the port can derive,
and each block names its ``source``:

* ``memory.argument_size_in_bytes``: the bytes one device holds of the
  step's arguments (each leaf's shard shape under its spec; the reference's
  ``memory_analysis`` field of that name counts the same buffers).
  ``donated_argument_bytes`` are those the reference donates (train: the
  parameters, and the residuals under ``--fl``; decode: the state). There is
  no buffer assignment, so no output, alias or temp bytes.
* ``cost.flops``: per device, the matmul-class FLOPs counted over the step
  (train: ``train.value_and_grad`` at one call's rows, times the calls of
  the step at the global batch: ``train.micro_batches`` microbatches, and
  each participant under ``--fl``; prefill and decode: ``launch/serve``),
  divided by ``n_devices`` as XLA's per-partition count is. The xLSTM's
  sLSTM is a host loop a time step, so its train and prefill are counted at
  two lengths and the count is carried to the shape's length along the
  line through them (both lengths hold two or more mLSTM chunks, where the
  count is affine in T).
* ``collectives``: the reference's keys (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``, each
  ``{bytes, count}``, and ``total_bytes``), counted from the layout, not
  parsed from a compiled program (:func:`layout_collectives`; the
  tensor-parallel terms traced from ``launch/tp.py`` on a meta grid,
  :func:`tp_collectives`): one device's
  result bytes, as the reference sums the result shapes of its
  per-partition HLO; and ``weight-reads``, the weight bytes a model
  position reads of the others' chunks at use (in ``total_bytes``). Under ``--fl`` the exchange of the stream plan
  (``train.fl_leaf_plan`` / ``fl_train.step_wire_record``: every stream
  entry an int32 index and an f32 value, from every participant) is added
  as one all-gather a leaf, and its totals are kept beside.

Usage::

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh pod --fl

``benchmarks``' roofline port (``repro_torch.bench.paper.roofline``) reads
the records.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs, convert
from repro_torch.core.types import SecureAggConfig, THGSConfig
from repro_torch.launch import fsdp, serve, tp, tp_serve
from repro_torch.launch import shardings as shd
from repro_torch.launch import train
from repro_torch.launch.mesh import (LogicalMesh, logical_rules,
                                     make_production_mesh)
from repro_torch.launch.specs import (SHAPES, _state_leaves, arch_for_shape,
                                      folds, input_pspecs, input_specs, meta)
from repro_torch.models import transformer as tf
from repro_torch.models.sharding import P

DEFAULT_OUT = "experiments/dryrun_torch"
# the two lengths at which a recurrent stack (xLSTM) is counted: two and
# three mLSTM chunks of 256 (one chunk has no inter-chunk products)
RECURRENT_T = (512, 768)
ROUND_KEY_BYTES = 8          # a threefry key: two uint32 words, replicated
# the reference's FL dry-run THGS and mask ratio (repro/launch/dryrun.py)
FL_THGS = THGSConfig(s0=0.01, alpha=0.9, s_min=0.001)
FL_SA = SecureAggConfig(mask_ratio=0.01)

_FLOP_SOURCE = (
    "torch.utils.flop_counter.FlopCounterMode over the step on meta "
    "tensors: matmul-class ops only (mm, addmm, bmm, baddbmm, "
    "convolution, SDPA), elementwise work not counted (XLA's "
    "cost_analysis counts it); attention as the plain version computes it, "
    "every (query, key) product of the square, masked or not")
_MEMORY_SOURCE = (
    "the layout: each parameter, input and residual leaf's shard shape under "
    "launch/shardings.param_specs and specs.input_pspecs on "
    "make_production_mesh (FL residuals under P(fed_axis, *spec)); no "
    "buffer assignment, so no output, alias or temp bytes")


def shard_shape(shape, spec, axis_sizes: dict) -> tuple:
    """One device's block of a ``shape`` array under ``spec``: each dim
    divided by the product of its mesh axes (rounded up, as an uneven XLA
    sharding pads)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n = math.prod(axis_sizes[a] for a in axes)
        out.append(-(-int(dim) // n))
    return tuple(out)


def shard_bytes(shape, dtype, spec, axis_sizes: dict) -> int:
    itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
    return math.prod(shard_shape(shape, spec, axis_sizes)) * itemsize


def step_rules(mesh, shape, fed_axis: str | None) -> dict:
    """``logical_rules`` with the reference's ``long_500k`` rewrite: a
    batch of 1 carries no parallelism, so the idle batch axes fold into the
    KV cache's sequence sharding."""
    rules = logical_rules(mesh, fed_axis=fed_axis)
    if folds(shape.global_batch):
        batch_axes = rules["batch"] if isinstance(rules["batch"], tuple) \
            else (rules["batch"],)
        rules = {**rules,
                 "kv_seq": tuple(a for a in batch_axes if a) + ("model",),
                 "batch": None}
    return rules


def step_layout(cfg, shape, mesh, rules, fl: bool, model=None) -> dict:
    """The step's arguments as ``{argument: [(path, shape, dtype, spec)]}``
    in the reference's argument order (train: params, [residuals, round
    key,] batch; prefill: params, tokens[, image embeds]; decode: params,
    token, state)."""
    model = tf.init_params(cfg, device="meta") if model is None else model
    named = dict(model.named_parameters())
    leaves = convert.reference_leaves(model)
    pspecs = shd.param_specs({lf.path: lf.shape for lf in leaves}, rules,
                             mesh)
    params = [(lf.path, lf.shape, named[lf.names[0]].dtype, pspecs[lf.path])
              for lf in leaves]
    ins = input_specs(cfg, shape)
    ispecs = input_pspecs(cfg, shape, rules)
    if shape.kind == "train":
        batch = [(f"batch.{k}", tuple(v.shape), v.dtype, ispecs["batch"][k])
                 for k, v in ins["batch"].items()]
        if not fl:
            return {"params": params, "batch": batch}
        fed_axis = "pod" if "pod" in mesh.axis_names else "data"
        n_fed = mesh.shape[fed_axis]
        residuals = [(f"residuals.{lf.path}", (n_fed,) + lf.shape,
                      torch.bfloat16, P(fed_axis, *pspecs[lf.path]))
                     for lf in leaves]
        key = [("round_key", (ROUND_KEY_BYTES,), torch.uint8, P())]
        return {"params": params, "residuals": residuals, "batch": batch,
                "round_key": key}
    if shape.kind == "prefill":
        out = {"params": params,
               "tokens": [("tokens", tuple(ins["tokens"].shape),
                           ins["tokens"].dtype, ispecs["tokens"])]}
        if cfg.family == "vlm":
            out["image_embeds"] = [
                ("image_embeds", tuple(ins["image_embeds"].shape),
                 ins["image_embeds"].dtype, ispecs["image_embeds"])]
        return out
    state = _state_leaves(ins["state"])
    return {"params": params,
            "token": [("token", tuple(ins["token"].shape), ins["token"].dtype,
                       ispecs["token"])],
            "state": [(f"state.{i}", tuple(x.shape), x.dtype, s)
                      for i, (x, s) in enumerate(zip(state,
                                                     ispecs["state"]))]}


def memory_summary(layout: dict, mesh, donate: tuple) -> dict:
    sizes = mesh.shape
    per_arg = {name: sum(shard_bytes(shp, dt, spec, sizes)
                         for _, shp, dt, spec in leaves)
               for name, leaves in layout.items()}
    return {"argument_size_in_bytes": sum(per_arg.values()),
            "donated_argument_bytes": sum(per_arg[a] for a in donate),
            "argument_bytes_by_name": per_arg,
            "source": _MEMORY_SOURCE}


def _rows(tensors: dict, rows: int, t: int | None = None) -> dict:
    """Meta stand-ins of ``tensors`` with ``rows`` rows (and ``t`` in place
    of the sequence dim of the token-indexed ones)."""
    out = {}
    for k, v in tensors.items():
        shp = (rows,) + tuple(v.shape[1:])
        if t is not None and k != "image_embeds":
            shp = (rows, t) + shp[2:]
        out[k] = meta(shp, v.dtype)
    return out


def _count(fn) -> tuple[float, dict]:
    fc = FlopCounterMode(display=False)
    with fc:
        fn()
    by_op = {str(k): float(v)
             for k, v in fc.get_flop_counts().get("Global", {}).items()}
    return float(fc.get_total_flops()), by_op


def _count_at(cfg, shape, model, rows: int, t: int) -> tuple[float, dict]:
    """FLOPs of one call of the step at ``rows`` rows of length ``t``."""
    if shape.kind == "train":
        batch = _rows(input_specs(cfg, shape)["batch"], rows, t)
        return _count(lambda: train.value_and_grad(model, cfg, batch))
    ins = _rows(input_specs(cfg, shape), rows, t)
    step = serve.make_prefill_step(cfg, cache_len=t)
    return _count(lambda: step(model, ins["tokens"],
                               ins.get("image_embeds")))


def cost_summary(cfg, shape, model, mesh, fl: bool, n_params: int) -> dict:
    """Counted FLOPs of the whole step, and per device."""
    out = {"source": _FLOP_SOURCE}
    if shape.kind == "decode":
        ins = input_specs(cfg, shape)
        step = serve.make_decode_step(cfg)
        total, by_op = _count(lambda: step(model, ins["token"], ins["state"]))
    else:
        calls = (train.micro_batches(n_params) if shape.kind == "train"
                 else 1)
        if fl:      # each participant's rows, in its microbatches
            calls *= mesh.shape["pod" if "pod" in mesh.axis_names
                                else "data"]
        rows = shape.global_batch // calls
        if cfg.xlstm:
            (t1, t2), T = RECURRENT_T, shape.seq_len
            f1, by1 = _count_at(cfg, shape, model, rows, t1)
            f2, by2 = _count_at(cfg, shape, model, rows, t2)

            def line(a: float, b: float) -> float:
                return a + (b - a) * (T - t1) / (t2 - t1)

            total = line(f1, f2) * calls
            by_op = {k: line(by1.get(k, 0.0), by2.get(k, 0.0)) * calls
                     for k in sorted(set(by1) | set(by2))}
            out["counted_at"] = [[t1, f1], [t2, f2]]
            out["method"] = (
                f"{rows} rows counted at T {t1} and {t2} (the sLSTM steps "
                f"one time step a host call), carried to T {T} along the "
                f"line through them, times {calls} call(s)")
        else:
            total, by_op = _count_at(cfg, shape, model, rows, shape.seq_len)
            total *= calls
            by_op = {k: v * calls for k, v in by_op.items()}
            out["method"] = f"{rows} rows a call, times {calls} call(s)"
        out["calls"] = calls
    out.update(flops=total / mesh.size, flops_total=total,
               flops_by_op=by_op)
    return out


COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")
# the weight bytes a model position reads of other positions' chunks at
# use (launch/tp.py's GridView.chunk with i != j): no reference key (XLA
# lowers such reads to the collectives above), a record entry of its own,
# in total_bytes
WEIGHT_READS = "weight-reads"
COUNTED = COLLECTIVE_OPS + (WEIGHT_READS,)
_COLLECTIVE_SOURCE = (
    "the layout's count, not XLA's (no compiled program): one device's "
    "result bytes a step. FSDP: every parameter leaf sharded over a "
    "data-parallel axis is all-gathered (the shard with those axes "
    "gathered) in the forward and again in the backward, one a stacked "
    "layer a call, and its gradient reduce-scattered once a call; a leaf "
    "replicated over a data-parallel axis has its gradient all-reduced. "
    "Tensor parallel: what launch/tp.py runs, as model position 0 sees it "
    "(tp_collectives: its step traced on a meta grid of the model axis's "
    "positions, each tp collective's forward and adjoint backward counted "
    "where it runs, one row with no layer and with one period of the layer "
    "pattern, at two lengths where T is long, carried along the lines "
    "through them to the rows, depth and T): the all-gathers and "
    "reduce-scatters along the sequence (all-reduces where the model axis "
    "does not divide T), the MoE exchange (an all-to-all of each token's "
    "top-k expert outputs) and "
    "position 0's routing broadcast (a collective-permute), the "
    "embedding's all-to-all, the loss's combine, "
    "the checkpoints' recompute included; and, as weight-reads, the weight "
    "bytes position 0 reads of other positions' chunks (GridView.chunk with "
    "i != j: K/V gathered whole at use, the SSM's and xLSTM's columns that "
    "do not fall in its own chunk), a read at each use, independent of the "
    "rows and T. Prefill and decode: the forward's gathers and the grid "
    "serve steps of launch/tp_serve.py (serve_collectives, every family) "
    "traced the same way at the shape's length and cache, one period of the "
    "layer pattern carried along the depth, xLSTM's prefill at two lengths "
    "carried to T (the prefill's flash attention on each position's heads, "
    "the cache and cross K/V relayout's all-to-all, the recurrent states' "
    "and conv tails' all-gathers along the heads, the last row's hand-off "
    "and the vocab-parallel logits' all-gather, or the tied head's "
    "all-reduce; the decode's q / k / v all-gathers, the cache statistics' "
    "all-reduces, the P.V reduce-scatter by wo's row chunks, the "
    "row-parallel all-reduces, the new recurrent states' all-gathers); "
    "long_500k's decode (one row, its cache over the data axes and model) "
    "traced on a meta grid of every cell kv_seq names (pod x data as "
    "data groups), every group running the row: the cache statistics' "
    "all-reduces and the P.V reduce-scatter over every cell counted once, "
    "a group's own collectives once, group 0's")

# launch/tp.py's collectives under the reference's keys: each Function's
# forward, then its backward (the adjoint), with the index of position 0's
# tensor in what it returns (None: the tensor itself)
_TP_KEYS = {
    "_AllGather": (("all-gather", 0), ("reduce-scatter", 1)),
    "_ReduceScatter": (("reduce-scatter", 0), ("all-gather", 2)),
    "_AllReduce": (("all-reduce", 0), ("all-reduce", 0)),
    "_AllToAll": (("all-to-all", 0), ("all-to-all", 3)),
    "_Broadcast": (("collective-permute", 0), ("collective-permute", 1)),
    "_Scatter": (("collective-permute", 0), ("collective-permute", 2)),
    "_ReduceTo": (("all-reduce", None), ("all-reduce", 1)),
}


@contextlib.contextmanager
def counting_tp(grid: tuple = (1, 1)):
    """While open, each ``launch/tp.py`` collective (and ``max_to``, the
    loss's running max: an all-reduce) adds position 0's result bytes and
    one call under its reference key, and each read position 0 makes of
    another position's weight chunk (``GridView.chunk``, ``i != j``, on
    data group 0's view) its bytes and one read under
    :data:`WEIGHT_READS`, to the yielded ``{op: {"bytes", "count"}}``
    (keys :data:`COUNTED`). A call over one position moves nothing and
    counts nothing. ``grid`` ``(n, m)``: ``n`` data groups of ``m``
    positions serving one row alike (a folded batch, ``launch/tp_serve.py``):
    a collective over every cell counts once; one over a group's
    positions runs in every group alike, and only group 0's, the one cell
    ``(0, 0)`` takes part in, counts."""
    n, m = grid
    counted = {op: {"bytes": 0, "count": 0} for op in COUNTED}
    local = {op: {"bytes": 0, "count": 0} for op in COUNTED}

    def add(op: str, t: torch.Tensor, width: int = 2) -> None:
        if width < 2:
            return
        into = local if n > 1 and width != n * m else counted
        into[op]["bytes"] += t.numel() * t.element_size()
        into[op]["count"] += 1

    def width(*trees) -> int:
        return max(sum(isinstance(x, torch.Tensor) for x in (
            tree if isinstance(tree, tuple) else (tree,))) for tree in trees)

    def wrap(fn, op: str, at):
        def counted_fn(ctx, *args):
            out = fn(ctx, *args)
            add(op, out if at is None else out[at], width(args, out))
            return out
        return staticmethod(counted_fn)

    def max_to(parts, device):
        out = real_max(parts, device)
        add("all-reduce", out, len(parts))
        return out

    def chunk(self, j, name, i, *args):
        out = real_chunk(self, j, name, i, *args)
        if j == 0 and i != 0 and self.g == 0:
            counted[WEIGHT_READS]["bytes"] += out.numel() * out.element_size()
            counted[WEIGHT_READS]["count"] += 1
        return out

    real_max, real_chunk = tp.max_to, tp.GridView.chunk
    saved = [(tp, "max_to", real_max), (tp.GridView, "chunk", real_chunk)]
    for name, ((fop, fat), (bop, bat)) in _TP_KEYS.items():
        cls = getattr(tp, name)
        for attr, op, at in (("forward", fop, fat), ("backward", bop, bat)):
            saved.append((cls, attr, cls.__dict__[attr]))
            setattr(cls, attr, wrap(getattr(cls, attr), op, at))
    tp.max_to = max_to
    tp.GridView.chunk = chunk
    try:
        yield counted
    finally:
        for obj, attr, orig in saved:
            setattr(obj, attr, orig)
        for op, tally in local.items():
            for key, v in tally.items():
                counted[op][key] += v // n


def _tp_traced(cfg, rows: int, t: int, m: int, train: bool) -> dict:
    """:func:`counting_tp` over one call of ``launch/tp.py``'s step (the
    loss and its gradient; else the forward) on a meta grid of ``m`` model
    positions, ``rows`` rows of ``t`` tokens."""
    dev = torch.device("meta")
    lm = fsdp.empty(cfg, LogicalMesh((1, m), ("data", "model"), "meta"),
                    groups=[((dev,) * m, range(0, 1))])
    batch = {k: meta((rows, t), torch.int32) for k in ("tokens", "labels")}
    if cfg.family == "audio":
        batch["frames"] = meta((rows, t, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = meta((rows, cfg.n_image_tokens, cfg.d_model),
                                     tf.DTYPES[cfg.dtype])
    with counting_tp() as counted:
        if train:
            tp.group_value_and_grad(lm, 0, cfg, batch)
        else:
            with torch.no_grad():
                tp.hidden(tp.GridView(lm, 0), cfg, batch)
    return counted


def tp_collectives(cfg, rows: int, t: int, m: int, train: bool) -> dict:
    """``{op: (bytes, count)}`` of one call of ``launch/tp.py``'s training
    step (``train``; else its forward) on ``rows`` rows of ``t`` tokens over
    ``m`` model positions, position 0's (:func:`counting_tp`): one row's
    count (:func:`_tp_row`), its bytes times ``rows`` (every collective
    moves activations that lead with the rows), the weight reads' as they
    are (a read at each use, whatever the rows)."""
    return {op: (nbytes if op == WEIGHT_READS else rows * nbytes, count)
            for op, (nbytes, count) in _tp_row(cfg, t, m, train).items()}


@functools.lru_cache(maxsize=None)
def _tp_row(cfg, t: int, m: int, train: bool) -> dict:
    """:func:`tp_collectives` of one row, traced with no layer and with one
    period of the layer pattern (a VLM's or hybrid's super-block, xLSTM's
    sLSTM and mLSTM, else a layer) and,
    where ``t`` is a multiple of ``L = lcm(LOSS_CHUNK, m)`` above ``2 L``,
    at ``L`` and ``2 L`` tokens; carried to ``cfg``'s depth and ``t`` along
    the lines through them. Each term is a whole number of layers' and loss
    chunks' collectives, each of bytes linear in T and split over ``m`` or
    not as ``t`` is, so the lines are exact."""
    return _carried(lambda c, u: _tp_traced(c, 1, u, m, train), cfg, t,
                    _lengths(t, m))


def _carried(trace, cfg, t: int, ts: tuple) -> dict:
    """``trace(config, length)`` (counted ``{op: {bytes, count}}``) of
    ``cfg`` cut to no period and to one period of its layer pattern
    (:func:`_period`), at the lengths ``ts``, carried to ``cfg``'s depth
    and to ``t`` along the lines through them."""
    period = _period(cfg)
    depth = cfg.n_layers // period
    at = {(n, u): trace(dataclasses.replace(cfg, n_layers=n * period), u)
          for n in (0, 1) for u in dict.fromkeys(ts)}
    return {op: tuple(
        _line(*[_line(at[0, u][op][key], at[1, u][op][key], depth, 0, 1)
                for u in ts], t, *ts)
        for key in ("bytes", "count")) for op in COUNTED}


def serves_on_grid(cfg, shape, rules) -> bool:
    """Whether the dry run counts ``shape``'s serve step as the grid's
    (``launch/tp_serve.py``, every family): prefill and decode with the
    cache's sequence over ``model``, or, where the batch folds
    (``long_500k``), over the data axes and ``model``."""
    kv = rules["kv_seq"]
    return shape.kind in ("prefill", "decode") and (
        kv == "model" or (folds(shape.global_batch) and isinstance(kv, tuple)
                          and kv[-1] == "model"))


def fold_groups(shape, rules, sizes: dict) -> int:
    """The data groups a folded batch's cache spans (the product of the
    sizes of ``kv_seq``'s axes before ``model``; 1 where it does not
    fold)."""
    kv = rules["kv_seq"]
    if not (folds(shape.global_batch) and isinstance(kv, tuple)):
        return 1
    return math.prod(sizes[a] for a in kv if a != "model")


def _serve_traced(cfg, kind: str, t: int, m: int, n: int = 1) -> dict:
    """:func:`counting_tp` over one call of the grid serve step on a meta
    grid of ``n`` data groups of ``m`` model positions, one row: a prefill
    of ``t`` tokens (frames for the audio encoder; the VLM with its image
    embeddings) into a cache of ``t`` slots, or a decode step on a cache
    of ``t`` slots (split over every cell where ``n > 1``: the row
    folds)."""
    dev = torch.device("meta")
    lm = fsdp.empty(cfg, LogicalMesh((n, m), ("data", "model"), "meta"),
                    groups=[((dev,) * m, range(g, g + 1)) for g in range(n)])
    dtype = tf.DTYPES[cfg.dtype]
    with counting_tp((n, m)) as counted:
        if kind == "prefill":
            tokens = (meta((1, t, cfg.d_model), dtype)
                      if cfg.family == "audio" else meta((1, t), torch.int32))
            img = (meta((1, cfg.n_image_tokens, cfg.d_model), dtype)
                   if cfg.family == "vlm" else None)
            tp_serve.prefill(lm, cfg, tokens, t, image_embeds=img)
        else:
            state = tp_serve.init_state(lm, cfg, 1, t)
            tp_serve.decode_step(lm, cfg, meta((1, 1), torch.int32), state)
    return counted


def _period(cfg) -> int:
    """Layers of one period of the layer pattern: a VLM's or hybrid's
    super-block, xLSTM's sLSTM and mLSTM, else a layer."""
    return (cfg.n_layers // tf.n_super(cfg)
            if cfg.family in ("vlm", "hybrid") else 2 if cfg.xlstm else 1)


def _line(a: int, b: int, x: int, x0: int, x1: int) -> int:
    """The value at ``x`` of the line through ``(x0, a)`` and ``(x1, b)``
    (``a`` where the points coincide)."""
    return a if x1 == x0 else a + (b - a) * (x - x0) // (x1 - x0)


def _lengths(t: int, m: int) -> tuple:
    """The two lengths a row is traced at to carry a count to ``t``:
    ``L = lcm(LOSS_CHUNK, m)`` and ``2 L`` where ``t`` is a multiple of
    ``L`` above ``2 L`` (both split over ``m`` as ``t`` is), else ``t``."""
    unit = math.lcm(tp.LOSS_CHUNK, m)
    return (unit, 2 * unit) if t % unit == 0 and t > 2 * unit else (t, t)


@functools.lru_cache(maxsize=None)
def _serve_row(cfg, kind: str, t: int, m: int, n: int = 1) -> dict:
    """:func:`serve_collectives` of one row, traced with no layer and one
    period of the layer pattern and carried along the line through them
    to ``cfg``'s depth (each period runs the same collectives). xLSTM's
    prefill, whose sLSTM steps one token a host call, is traced at two
    lengths (:func:`_lengths`) and carried to ``t`` along the line through
    them: it keeps no cache, so each term is linear in T."""
    ts = _lengths(t, m) if cfg.xlstm and kind == "prefill" else (t, t)
    return _carried(lambda c, u: _serve_traced(c, kind, u, m, n), cfg, t,
                    ts)


def serve_collectives(cfg, rows: int, kind: str, t: int, m: int,
                      n: int = 1) -> dict:
    """``{op: (bytes, count)}`` of one grid serve step (``kind`` prefill
    or decode, ``t`` the prompt's tokens and the cache's slots) on ``rows``
    rows over ``m`` model positions (and ``n`` data groups of one folded
    row), position 0's (:func:`counting_tp`): one row's count, its bytes
    times ``rows``, the weight reads' as they are."""
    return {op: (nbytes if op == WEIGHT_READS else rows * nbytes, count)
            for op, (nbytes, count) in _serve_row(cfg, kind, t, m,
                                                  n).items()}


def _add(out: dict, op: str, nbytes: int, count: int) -> None:
    out[op]["bytes"] += int(nbytes)
    out[op]["count"] += int(count)


def layout_collectives(cfg, shape, mesh, rules, layout: dict, calls: int,
                       n_fed: int = 1) -> dict:
    """The collectives one device runs in a step of ``layout`` on ``mesh``,
    counted from each parameter leaf's spec (``launch/shardings.py``), with
    the reference's keys. ``calls``: the step's calls a device makes (the
    training microbatches; 1 for prefill and decode). ``rules`` name the
    data-parallel axes (``batch``); ``n_fed`` participants split the
    global batch first. A folded batch (``long_500k``, :func:`step_rules`)
    moved those axes into ``kv_seq``: no row splits over them, but the
    weights stay sharded over them (``param_specs``' ``fsdp``) and each
    data group's ``GridView`` gathers its weights, so they are the
    gathers' axes still."""
    sizes = mesh.shape

    def axes(rule):
        return tuple(a for a in (rule if isinstance(rule, tuple) else (rule,))
                     if a and a != "model" and sizes[a] > 1)

    n = fold_groups(shape, rules, sizes)
    dp_axes = axes(rules["batch"])
    gather_axes = dp_axes or (axes(rules["kv_seq"]) if n > 1 else ())
    train_step = shape.kind == "train"
    passes = 2 if train_step else 1            # forward (+ backward)
    out = {op: {"bytes": 0, "count": 0} for op in COUNTED}
    split = n_fed * math.prod(sizes[a] for a in dp_axes) * max(calls, 1)
    rows = -(-shape.global_batch // split)
    t = shape.seq_len if shape.kind != "decode" else 1
    m = sizes.get("model", 1)
    for path, shp, dt, spec in layout["params"]:
        rule = shd.leaf_rule(path, shp)
        stack = math.prod(shp[:len(shp) - len(rule)])
        entries = [e if isinstance(e, tuple) else (e,) for e in spec]
        on = {a for e in entries for a in e if a}
        fsdp = [a for a in gather_axes if a in on]
        if fsdp:
            gathered = P(*[tuple(a for a in e if a and a not in fsdp) or None
                           for e in entries])
            _add(out, "all-gather",
                 passes * calls * shard_bytes(shp, dt, gathered, sizes),
                 passes * calls * stack)
            if train_step:
                _add(out, "reduce-scatter",
                     calls * shard_bytes(shp, dt, spec, sizes), calls * stack)
        if train_step and any(a not in on for a in dp_axes):
            _add(out, "all-reduce", calls * shard_bytes(shp, dt, spec, sizes),
                 calls * stack)
    if m > 1 or n > 1:
        terms = (serve_collectives(cfg, rows, shape.kind, shape.seq_len, m,
                                   n)
                 if serves_on_grid(cfg, shape, rules)
                 else tp_collectives(cfg, rows, t, m, train_step))
        for op, (nbytes, count) in terms.items():
            _add(out, op, calls * nbytes, calls * count)
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    out["source"] = _COLLECTIVE_SOURCE
    return out


def fl_exchange(mesh, n_fed: int, model, collectives: dict) -> dict:
    """The FL step's exchange from its static stream plan, added to a
    participant's ``collectives`` as one all-gather a leaf: a device
    receives every participant's entries of its block."""
    from repro_torch.launch.fl_train import step_wire_record

    leaves = convert.reference_leaves(model)
    sizes = [math.prod(lf.shape) for lf in leaves]
    n_blocks = mesh.size // n_fed
    rec = step_wire_record(0, sizes, FL_THGS, FL_SA, n_fed, n_blocks)
    entries = rec.upload_bits // 64
    out = {op: dict(collectives[op]) for op in COUNTED}
    _add(out, "all-gather", entries * 8 // n_blocks, len(leaves))
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return {**out,
            "stream_exchange_bytes": entries * 8,
            "stream_entries": entries, "participants": n_fed,
            "blocks_per_participant": n_blocks,
            "upload_vs_dense": rec.upload_bits / rec.dense_upload_bits,
            "source": (
                collectives["source"] + "; the FL exchange from "
                "train.fl_leaf_plan / fl_train.step_wire_record: every "
                "participant's stream entries (top-k and mask slots, an "
                "int32 index and an f32 value each), a device's block of "
                "them gathered once a leaf")}


def _write(rec: dict, out_dir: str, tag: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag + ".json")
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f, indent=1, default=str)
    os.replace(path + ".tmp", path)


def run_one(arch: str, shape_name: str, mesh_kind: str, fl: bool = False,
            out_dir: str = DEFAULT_OUT, kv_int8: bool = False) -> dict:
    cfg = configs.get(arch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_dtype="int8")
    shape = SHAPES[shape_name]
    if not cfg.supports_shape(shape_name):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped", "reason": "encoder-only: no decode step"}
        _write(rec, out_dir, f"{arch}__{shape_name}__{mesh_kind}")
        return rec
    mesh = make_production_mesh(multi_pod=(mesh_kind == "pod"),
                                device="meta")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "fl": fl,
           "kv_int8": kv_int8, "n_devices": int(mesh.size)}
    t0 = time.perf_counter()
    try:
        fed_axis = (("pod" if "pod" in mesh.axis_names else "data")
                    if fl else None)
        rules = step_rules(mesh, shape, fed_axis)
        cfg = arch_for_shape(cfg, shape)
        model = tf.init_params(cfg, device="meta")
        n_params = tf.param_count(model)
        fl_train = fl and shape.kind == "train"
        layout = step_layout(cfg, shape, mesh, rules, fl_train, model)
        # the reference donates mutable state: the decode its caches, a
        # train step its params (+ residuals)
        donate = {"decode": ("state",),
                  "train": ("params", "residuals") if fl_train
                  else ("params",)}.get(shape.kind, ())
        memory = memory_summary(layout, mesh, donate)
        build_s = time.perf_counter() - t0
        cost = cost_summary(cfg, shape, model, mesh, fl_train, n_params)
        calls = (train.micro_batches(n_params) if shape.kind == "train"
                 else 1)
        collectives = layout_collectives(
            cfg, shape, mesh, rules, layout, calls,
            n_fed=mesh.shape[fed_axis] if fl_train else 1)
        if fl_train:
            collectives = fl_exchange(mesh, mesh.shape[fed_axis], model,
                                      collectives)
        rec.update(
            status="ok", lower_s=None, compile_s=None,
            build_s=round(build_s, 2),
            count_s=round(time.perf_counter() - t0 - build_s, 2),
            n_params=n_params, memory=memory, cost=cost,
            collectives=collectives)
    except Exception as e:  # a record says what failed; the CLI goes on
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    tag = (f"{arch}__{shape_name}__{mesh_kind}" + ("__fl" if fl else "")
           + ("__kvint8" if kv_int8 else ""))
    _write(rec, out_dir, tag)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Build every (arch x shape x mesh) step on the meta "
                    "device and record its layout bytes and counted FLOPs "
                    "(no card needed).")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "pod", "both"])
    ap.add_argument("--fl", action="store_true",
                    help="the THGS + secure-aggregation federated train "
                         "step")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache variant")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = configs.all_archs() if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "pod"] if args.mesh == "both" else [args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                rec = run_one(arch, shape, mk, fl=args.fl, out_dir=args.out,
                              kv_int8=args.kv_int8)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    arg = rec["memory"]["argument_size_in_bytes"]
                    col = rec["collectives"]["total_bytes"]
                    extra = (f" args/dev={arg / 2**30:.2f}GiB "
                             f"flops/dev={rec['cost']['flops']:.4e} "
                             f"coll/dev={col / 2**30:.2f}GiB "
                             f"count={rec['count_s']:.0f}s")
                elif status == "fail":
                    n_fail += 1
                    extra = " " + rec["error"][:160]
                print(f"[{status:7s}] {arch:24s} {shape:12s} {mk:6s}"
                      f"{' fl' if args.fl else '':3s}{extra}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
