"""Serving over a participant's ``(data group, model position)`` grid: the
prefill and the one-token decode of every family on a
``launch.fsdp.ShardedLM``, the port's counterpart of GSPMD partitioning the
reference's serving steps by ``param_specs`` and ``specs.input_pspecs``
(``repro/launch/dryrun.py`` lowers both on the production meshes).

One process drives every cell, as ``launch/tp.py``'s training step does,
and reuses its collectives (every sum in position order, in f32, rounded
once) and blocks. Each data group serves its own rows (``lm.groups``' share
of the batch, in group order); its ``m`` model positions compute them
together:

* **The decode state** (:class:`GridState`) is placed as
  ``specs.input_pspecs`` places the reference's: rows over the data groups,
  and a KV cache's sequence over ``model`` where it has 1,024 slots or more
  (position ``j`` holds slots ``[j S/m, (j+1) S/m)``, every KV head);
  below that each position holds the cache whole. Each position keeps its
  own copy of the rows' lengths. The VLM's cross K/V follow the same rule
  along the image tokens (split where there are 1,024 or more; a position
  never holds none). The recurrent states (the hybrid's SSM state and conv
  tail, xLSTM's cell states) lie by batch alone, so every position holds
  them whole.
* **A batch of one row** (``specs.folds``, the reference's ``long_500k``
  rewrite: ``batch`` on no axis, ``kv_seq`` over the data axes, then
  ``model``) is served by every data group alike, as ``batch = None``
  replicates it: each group runs the same stream on its own weights'
  reads. The caches' sequence then splits over every cell of the grid in
  ``input_pspecs``' data-major order: cell ``(g, j)``, ``c = g m + j`` of
  ``N = n m``, holds slots ``[c S/N, (c+1) S/N)`` of every KV head (the
  VLM's cross K/V likewise along the image tokens), and a cache read
  combines its statistics over all ``N`` cells in cell order (below); the
  recurrent states stay whole on every cell. A grid whose groups each hold
  one data position can fold; the logits are group 0's.
* **Prefill** (:func:`prefill`). The residual stream, the norms, the MLP
  and the expert-parallel MoE run as in training (``tp.Stream``,
  ``tp.mlp_partials``, ``tp.moe_block``). Attention: position ``j`` runs
  the flash kernel (``kernels.ops.flash_attention``) on its query heads and
  the KV heads they read, and keeps its K/V for the cache. Where each
  position's KV heads are exactly its own ``wk`` / ``wv`` chunk and the
  cache is split, an all-to-all moves them from "my KV heads, every slot"
  to "every KV head, my slots" (the relayout; "my cell's slots" where
  the batch folds: no exchange across groups, each ran the prompt).
  Otherwise (more positions
  than KV heads, a split off KV-head boundaries, or a whole cache) each
  position projects every KV head from ``wk`` / ``wv`` read whole and keeps
  its slots of them: a local narrow, no exchange. The VLM's cross layer
  does the same with the image embeddings (whole on every position) as the
  K/V source, non-causal and unrotated, its K/V relaid along the image
  tokens; the audio encoder's layers run it non-causal and keep no K/V
  (each position projects only the KV heads its queries read). ``wo`` is
  row-parallel, reduced to the stream's layout. The Mamba2 mixer and the
  xLSTM cells run head-split as in training (``tp.ssm_partials``,
  ``tp.xlstm_partials``); each position's heads' final states are
  all-gathered along the heads, in position order, so every copy is whole.
  The last token's row is handed from the position that holds it to the
  others, normed there, and its logits are computed vocab-parallel and
  all-gathered whole (tied embeddings, xLSTM: each position's feature
  columns of ``embed``, the partial logits all-reduced in position order).
* **Decode** (:func:`decode_step`), on a whole ``[B, 1, d]`` stream. Each
  position projects its own ``wq`` / ``wk`` / ``wv`` columns
  (column-parallel), all-gathered whole; the new entry is rotated and, for
  an int8 cache, quantised on every position alike
  (``attention.decode_entry``). The position whose slots hold slot
  ``length`` writes it (``attention.write_slice``). With a split cache
  each position scores every head against its slots; the row max is
  all-reduced, each position forms ``exp(s - max)`` and its sum, the sums
  are all-reduced in position order, and each position's P·V partial
  (probabilities in the model dtype, products in f32) is reduce-scattered
  by ``wo``'s row chunks (by head where ``m`` divides the heads) in
  position order and cast once (``attention.slice_*``): the
  probabilities are ``attend``'s up to the order of one sum, and a
  position with no slot to read adds exactly 0. Where the batch folds the
  three reductions run over every cell of the grid in cell order, and
  position ``j`` of each group receives ``wo``'s row chunk ``j`` of the
  sum. With a whole cache each
  position attends its own query heads (``attention.attend``). The VLM's
  cross read is the same combine over each position's image tokens, every
  token valid. ``wo`` is row-parallel and its ``[B, 1, d]`` partials
  all-reduced in position order; the MLP and MoE run as in training on the
  whole T 1 stream.
* **Recurrent decode.** Each position advances its own heads, reading the
  columns training reads (``tp.ssm_head_params``, ``tp.xlstm_partials``):
  no more weight crosses positions than in training. Its heads' new state
  rows, and for the Mamba2 mixer the conv tail's channels, are then
  all-gathered in position order, so every position's copy is whole again
  and equal to the one device's up to the narrower products: values move,
  none is summed. A B/C channel that heads of several positions read has
  one owner (the position holding its group's first head), which alone
  sends it. ``out_proj`` / ``w_out`` are row-parallel, their partials
  all-reduced in position order.

The audio encoder has no decode: its prefill is the encode, its state
``None``, and a decode step raises ``ValueError``, as on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.launch import specs, tp
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import apply_rope


def check_decode(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for the audio encoder, which has no decode."""
    if cfg.family == "audio":
        raise ValueError(f"decode unsupported for family {cfg.family}")


@dataclasses.dataclass
class GridState:
    """A grid's decode state over data group ``g``'s model positions ``j``
    (module docstring):

    * ``caches[g][i][j]``: the ``KVCache`` of attention call ``i`` (the
      dense and MoE layers; the VLM's self layers, super-block by
      super-block; the hybrid's shared block, once a super-block), written
      in place by :func:`decode_step`;
    * ``cross_kv[g][s][j]`` (VLM): super-block ``s``'s cross ``(k, v)`` of
      position ``j``'s image tokens;
    * ``recurrent[g][i][j]``: layer ``i``'s state, whole: the hybrid's
      ``SSMCache`` of each SSM layer in order, xLSTM's cell state tuple
      (``(c, n, m, h)`` sLSTM, ``(C, n, m)`` mLSTM); replaced by each
      step;
    * ``folded``: a batch of one row, its caches split over every cell
      (:func:`cell_range`)."""
    caches: list
    cache_len: int
    cross_kv: Optional[list] = None
    recurrent: Optional[list] = None
    folded: bool = False

    @property
    def split(self) -> bool:
        """Whether the caches' sequence splits over ``model``."""
        return split_over_model(self.cache_len)


def split_over_model(cache_len: int) -> bool:
    """Whether a cache of ``cache_len`` slots splits by sequence over
    ``model`` (``specs.input_pspecs``' rule)."""
    return cache_len >= specs.KV_SPLIT_SLOTS


def slots(j: int, m: int, cache_len: int) -> tuple[int, int]:
    """Position ``j``'s slots ``[off, off + n)`` as ``(off, n)``."""
    if not split_over_model(cache_len):
        return 0, cache_len
    lo, hi = tp._span(j, m, cache_len)
    return lo, hi - lo


def image_slots(j: int, m: int, n_image: int) -> tuple[int, int]:
    """Position ``j``'s image tokens ``(off, n)`` of the VLM's cross K/V
    (:func:`slots`' rule); ``ValueError`` where a split leaves a position
    none."""
    off, n = slots(j, m, n_image)
    if n == 0:
        raise ValueError(f"{n_image} image tokens split over {m} model "
                         f"positions leave position {j} none")
    return off, n


def cell_range(lm, g: int, folded: bool) -> tuple[int, int]:
    """``(c0, n)``: data group ``g``'s model position ``j`` is cell ``c0 +
    j`` of the ``n`` cells a cache (or the image tokens) splits over: every
    cell of the grid, data-major, where the batch folds, else the group's
    own ``m`` positions."""
    m = lm.n_model
    return (g * m, len(lm.groups) * m) if folded else (0, m)


def group_rows(lm, n_rows: int) -> list:
    """Each data group's ``(first row, rows)`` of a batch of ``n_rows``: a
    share each, or the one row on every group where the batch folds
    (``specs.folds``; each group must then hold one data position)."""
    if specs.folds(n_rows):
        if lm.n_data > 1 and any(len(pos) != 1 for _, pos in lm.groups):
            raise ValueError("a batch of one row folds over the data "
                             "groups only where each holds one data "
                             "position")
        return [(0, 1)] * len(lm.groups)
    if n_rows % lm.n_data:
        raise ValueError(f"batch {n_rows} does not split over {lm.n_data} "
                         "data positions")
    per = n_rows // lm.n_data
    return [(pos.start * per, len(pos) * per) for _, pos in lm.groups]


def leaves_by_kind(cfg: ArchConfig, state: tf.DecodeState) -> tuple:
    """A one-device decode state's leaves as a :class:`GridState` lays them
    out: (the KV caches in call order, the cross ``(k, v)`` a super-block,
    the recurrent states a layer)."""
    if cfg.xlstm:
        s, m = state.caches["s"], state.caches["m"]
        return [], [], [(s if i % 2 == 0 else m)[i // 2]
                        for i in range(len(s) + len(m))]
    if cfg.family == "vlm":
        return ([c for row in state.caches for c in row], state.cross_kv,
                [])
    if cfg.family == "hybrid":
        return (state.caches["attn"], [],
                [c for row in state.caches["ssm"] for c in row])
    return state.caches, [], []


def has_recurrent(cfg: ArchConfig) -> bool:
    """Whether the family's decode state holds recurrent states."""
    return cfg.xlstm or cfg.family == "hybrid"


def init_state(lm, cfg: ArchConfig, batch: int, cache_len: int) -> GridState:
    """An empty decode state (lengths 0, recurrent states at zero, as
    ``transformer.init_decode_state``) for ``batch`` rows of ``cache_len``
    slots over ``lm``'s grid (module docstring), int8 K/V when
    ``cfg.kv_dtype == 'int8'``."""
    check_decode(cfg)
    dtype = tf.DTYPES[cfg.dtype]
    kv_dt = torch.int8 if cfg.kv_dtype == "int8" else dtype
    folded = specs.folds(batch)
    caches, cross, rec = [], [], []
    for g, (_, rows) in enumerate(group_rows(lm, batch)):
        devs = tp.GridView(lm, g).devices
        c0, n_cells = cell_range(lm, g, folded)
        calls, images, layers = leaves_by_kind(cfg, tf.init_decode_state(
            cfg, rows, 1, device="meta"))

        def kv(n, d, dt):
            return torch.zeros((rows, n, cfg.n_kv_heads, cfg.hd), dtype=dt,
                               device=d)

        caches.append([[KVCache(
            k=kv(n, d, kv_dt), v=kv(n, d, kv_dt),
            length=torch.zeros((rows,), dtype=torch.int32, device=d))
            for j, d in enumerate(devs)
            for n in [slots(c0 + j, n_cells, cache_len)[1]]]
            for _ in calls])
        cross.append([[(kv(n, d, dtype), kv(n, d, dtype))
                       for j, d in enumerate(devs)
                       for n in [image_slots(c0 + j, n_cells,
                                             cfg.n_image_tokens)[1]]]
                      for _ in images])
        rec.append([[rebuild(c, [torch.zeros(x.shape, dtype=x.dtype,
                                             device=d) for x in c])
                     for d in devs] for c in layers])
    return GridState(caches=caches, cache_len=cache_len,
                     cross_kv=cross if cfg.family == "vlm" else None,
                     recurrent=rec if has_recurrent(cfg) else None,
                     folded=folded)


def place_state(lm, cfg: ArchConfig, state: tf.DecodeState) -> GridState:
    """A one-device decode state (``transformer.prefill`` /
    ``init_decode_state``'s) laid out over ``lm``'s grid as
    :func:`init_state` lays one out: each cell's rows and slots of every
    KV cache and of the VLM's cross K/V, its own copy of the lengths, the
    recurrent states whole. A split leaf's slice is a view of ``state``'s
    tensor where the cell lies on its device (the grid decode then writes
    ``state``'s storage), else a copy there; a whole leaf is copied to
    every cell."""
    check_decode(cfg)
    calls, images, layers = leaves_by_kind(cfg, state)
    batch = specs._state_leaves(state)[0].shape[0]
    cache_len = calls[0].k.shape[1] if calls else 0
    folded = specs.folds(batch)
    caches, cross, rec = [], [], []
    for g, (r0, rows) in enumerate(group_rows(lm, batch)):
        devs = tp.GridView(lm, g).devices
        c0, n_cells = cell_range(lm, g, folded)

        def take(x, span, d):
            part = x[r0:r0 + rows].narrow(1, *span)
            return part.to(d, copy=part.shape[1] == x.shape[1])

        caches.append([[KVCache(
            k=take(c.k, span, d), v=take(c.v, span, d),
            length=c.length[r0:r0 + rows].to(d, copy=True))
            for j, d in enumerate(devs)
            for span in [slots(c0 + j, n_cells, cache_len)]]
            for c in calls])
        cross.append([[(take(k, span, d), take(v, span, d))
                       for j, d in enumerate(devs)
                       for span in [image_slots(c0 + j, n_cells,
                                                cfg.n_image_tokens)]]
                      for k, v in images])
        rec.append([[rebuild(c, [x[r0:r0 + rows].to(d, copy=True)
                                 for x in c])
                     for d in devs] for c in layers])
    return GridState(caches=caches, cache_len=cache_len,
                     cross_kv=cross if cfg.family == "vlm" else None,
                     recurrent=rec if has_recurrent(cfg) else None,
                     folded=folded)


def rebuild(leaf, tensors) -> tuple:
    """``tensors`` in the tuple type of ``leaf`` (an ``SSMCache``, a cell
    state, a cross ``(k, v)``)."""
    return type(leaf)(*tensors) if hasattr(leaf, "_fields") else tuple(
        tensors)


def state_tensors(state: GridState) -> list:
    """Every tensor the state holds (each position's k, v and lengths, its
    cross K/V and its recurrent states)."""
    out = [t for group in state.caches for layer in group for c in layer
           for t in (c.k, c.v, c.length)]
    for tree in (state.cross_kv, state.recurrent):
        out += [t for group in tree or [] for layer in group
                for leaf in layer for t in leaf]
    return out


def clone_state(state: GridState) -> GridState:
    """A state whose tensors are fresh copies of ``state``'s."""
    def each(tree):
        return None if tree is None else [
            [[rebuild(leaf, [t.clone() for t in leaf]) for leaf in layer]
             for layer in group] for group in tree]

    return dataclasses.replace(
        state, caches=[[[KVCache(k=c.k.clone(), v=c.v.clone(),
                                 length=c.length.clone()) for c in layer]
                        for layer in group] for group in state.caches],
        cross_kv=each(state.cross_kv), recurrent=each(state.recurrent))


# ------------------------------------------------------------------ prefill
def kv_by_exchange(m: int, cfg: ArchConfig, cache_len: int) -> bool:
    """Whether the prefill's K/V reach a cache of ``cache_len`` slots (or
    image tokens) by the all-to-all: the cache is split and each position's
    query heads read exactly its own span of the KV heads (module
    docstring)."""
    if not split_over_model(cache_len):
        return False
    for j in range(m):
        _, _, kmap = tp.query_heads(j, m, cfg)
        if not kmap or (kmap[0], kmap[-1] + 1) != tp._span(j, m,
                                                           cfg.n_kv_heads):
            return False
    return True


def prefill_attention(view, prefix: str, hs, cfg: ArchConfig, *,
                      window: Optional[int], exchange: bool,
                      causal: bool = True, kv_srcs=None,
                      keep: bool = True) -> tuple:
    """Each position's ``wo`` partial of the attention under ``prefix`` on
    its whole normed rows ``hs[j]`` through the flash kernel, and the K/V
    it keeps for the cache ``[B, S, heads, hd]``: its own KV heads where
    they reach the cache by the exchange, else every KV head. ``kv_srcs``
    (one a position): cross-attention's K/V source, nothing rotated.
    Without ``keep`` (an encoder) a position projects only the KV heads
    its queries read and keeps none."""
    hd, n_kv = cfg.hd, cfg.n_kv_heads
    parts, kvs = [], []
    for j, h in enumerate(hs):
        b, t, _ = h.shape
        lo, hi, kmap = tp.query_heads(j, view.m, cfg)
        if not keep and hi == lo:
            parts.append(h.new_zeros((b, t, cfg.d_model)))
            kvs.append(None)
            continue
        ka, kb = ((kmap[0], kmap[-1] + 1) if exchange or not keep
                  else (0, n_kv))
        src = h if kv_srcs is None else kv_srcs[j]
        positions = torch.arange(t, device=h.device)[None, :]

        def rope(x):
            return x if kv_srcs is not None else apply_rope(x, positions,
                                                            cfg.rope)
        k = rope(tp.project_heads(view, j, prefix + "wk", src, ka, kb, hd))
        v = tp.project_heads(view, j, prefix + "wv", src, ka, kb, hd)
        kvs.append((k, v) if keep else None)
        if hi == lo:
            parts.append(h.new_zeros((b, t, cfg.d_model)))
            continue
        q = rope(tp.project_heads(view, j, prefix + "wq", h, lo, hi, hd))
        klo, khi = kmap[0], kmap[-1] + 1
        kq, vq = tp.for_queries(k.narrow(2, klo - ka, khi - klo),
                                v.narrow(2, klo - ka, khi - klo), kmap, klo)
        o = ops.flash_attention(q, kq, vq, causal=causal,
                                window=window if causal else None)
        parts.append(o.reshape(b, t, (hi - lo) * hd)
                     @ view.part(j, prefix + "wo", 0, lo * hd, hi * hd))
    return parts, kvs


def relayout(kvs, m: int, cache_len: int, exchange: bool,
             cells: Optional[tuple] = None) -> tuple:
    """Each position's slots of the prefill's K/V
    (:func:`prefill_attention`; ``cache_len`` slots or image tokens, the
    prompt's first): by the all-to-all, or narrowed where they lie.
    ``cells``: :func:`cell_range`'s ``(c0, n)`` (default the group's
    own)."""
    t = kvs[0][0].shape[1]
    c0, n_cells = cells or (0, m)
    spans = [slots(c0 + j, n_cells, cache_len) for j in range(m)]
    pieces = [(min(off, t), max(0, min(off + n, t) - off))
              for off, n in spans]
    if exchange:
        ks = tp.all_to_all([k for k, _ in kvs], 1, 2, pieces)
        vs = tp.all_to_all([v for _, v in kvs], 1, 2, pieces)
    else:
        ks = [k.narrow(1, *p) for (k, _), p in zip(kvs, pieces)]
        vs = [v.narrow(1, *p) for (_, v), p in zip(kvs, pieces)]
    return ks, vs, spans


def to_cache(kvs, m: int, cache_len: int, exchange: bool,
             cells: Optional[tuple] = None) -> list:
    """Each position's ``KVCache`` of one layer from the prefill's K/V
    (:func:`prefill_attention`): the prompt's slots, zero past them."""
    ks, vs, spans = relayout(kvs, m, cache_len, exchange, cells)
    t = kvs[0][0].shape[1]
    out = []
    for k, v, (_, n) in zip(ks, vs, spans):
        kc = k.new_zeros((k.shape[0], n) + tuple(k.shape[2:]))
        vc = v.new_zeros(kc.shape)
        kc[:, :k.shape[1]] = k
        vc[:, :v.shape[1]] = v
        out.append(KVCache(k=kc, v=vc, length=torch.full(
            (k.shape[0],), t, dtype=torch.int32, device=k.device)))
    return out


def logits(view, cfg: ArchConfig, xs) -> torch.Tensor:
    """The last rows ``xs[j]`` ``[B, 1, d]`` (whole on every position)
    final-normed, their logits vocab-parallel over ``lm_head``'s columns,
    all-gathered whole; with tied embeddings each position's feature
    columns of ``embed`` give partial logits, all-reduced in position
    order. Position 0's copy."""
    hs = tp._norms(view, "final_norm.", xs, cfg)
    parts = []
    if cfg.tie_embeddings:
        for j, h in enumerate(hs):
            lo, hi = tp._span(j, view.m, cfg.d_model)
            parts.append(h[..., lo:hi] @ view.part(j, "embed", 1, lo, hi).T)
        return tp.all_reduce(parts)[0]
    for j, h in enumerate(hs):
        lo, hi = tp._span(j, view.m, cfg.vocab)
        parts.append(h @ view.part(j, "lm_head", 1, lo, hi))
    return tp.all_gather(parts, 2)[0]


def heads_whole(parts, like) -> list:
    """Each position's state rows of its heads ``[B, h_j, ...]`` (None:
    it has none) all-gathered along the heads, in position order: the whole
    state on every position. ``like[j]``: a whole copy's shape, dtype and
    device."""
    return tp.all_gather([
        p if p is not None else torch.zeros(
            (like[j].shape[0], 0) + tuple(like[j].shape[2:]),
            dtype=like[j].dtype, device=like[j].device)
        for j, p in enumerate(parts)], 1)


def conv_whole(view, cfg: ArchConfig, tails) -> list:
    """The whole conv tail ``[B, K-1, C]`` on every position from each
    position's tail of its heads' conv channels (``tails[j]``: their x,
    then their groups' B and C; None where it has no head): x channels
    all-gathered in position order, and each B / C group from its owner,
    the position holding the group's first head (module docstring)."""
    spec = cfg.ssm
    _, n_heads, _ = ssm_mod.dims(cfg.d_model, spec)
    n = spec.d_state
    rep = n_heads // spec.n_groups
    like = next(t for t in tails if t is not None)
    pieces = []
    for j, tail in enumerate(tails):
        if tail is None:
            pieces.append([like.new_zeros(like.shape[:2] + (0,),
                                          device=view.devices[j])] * 3)
            continue
        lo, hi = tp._span(j, view.m, n_heads)
        g_lo, g_hi = ssm_mod.head_groups(lo, hi, n_heads, spec)
        o_lo, o_hi = -(-lo // rep), -(-hi // rep)   # the groups it owns
        d_in, ng = (hi - lo) * spec.head_dim, g_hi - g_lo
        pieces.append([tail[..., :d_in],
                       tail[..., d_in + (o_lo - g_lo) * n:
                            d_in + (o_hi - g_lo) * n],
                       tail[..., d_in + (ng + o_lo - g_lo) * n:
                            d_in + (ng + o_hi - g_lo) * n]])
    return [torch.cat(three, -1) for three in zip(*(
        tp.all_gather([p[k] for p in pieces], 2) for k in range(3)))]


def ssm_prefill(view, prefix: str, cfg: ArchConfig, st, xs) -> tuple:
    """``x`` plus the Mamba2 mixer under ``prefix`` (head-split, as in
    training) and each position's whole ``SSMCache`` of it: the heads'
    final states and the conv tail (the last ``d_conv - 1`` rows' conv
    channels), gathered whole."""
    spec = cfg.ssm
    hs = st.gather(tp._norms(view, prefix + "norm.", xs, cfg))
    parts, ran = tp.ssm_partials(view, prefix, cfg, hs)
    xs = [x + y for x, y in zip(xs, st.reduce(parts))]
    _, n_heads, _ = ssm_mod.dims(cfg.d_model, spec)
    b = hs[0].shape[0]
    like = [hs[j].new_zeros((b, 0, spec.d_state, spec.head_dim),
                            dtype=torch.float32) for j in range(view.m)]
    states = heads_whole([ran[j][0] if j in ran else None
                          for j in range(view.m)], like)
    tails = []
    for j in range(view.m):
        if j not in ran:
            tails.append(None)
            continue
        lo, hi = tp._span(j, view.m, n_heads)
        g_lo, g_hi = ssm_mod.head_groups(lo, hi, n_heads, spec)
        d_in = (hi - lo) * spec.head_dim
        zx = ran[j][1]
        tails.append(zx[:, -(spec.d_conv - 1):,
                        d_in: 2 * d_in + 2 * (g_hi - g_lo) * spec.d_state])
    convs = conv_whole(view, cfg, tails)
    return xs, [ssm_mod.SSMCache(state=s, conv=c)
                for s, c in zip(states, convs)]


def xlstm_prefill(view, prefix: str, cfg: ArchConfig, st, xs) -> tuple:
    """``x`` plus the xLSTM cell under ``prefix`` (head-split, as in
    training) and each position's whole state of it, gathered along the
    heads."""
    parts, finals = tp.xlstm_partials(view, prefix, cfg, st.gather(xs))
    xs = [x + y for x, y in zip(xs, st.reduce(parts))]
    return xs, xlstm_whole(view, cfg, prefix, finals, xs[0].shape[0])


def xlstm_whole(view, cfg: ArchConfig, prefix: str, finals: dict,
                b: int) -> list:
    """Each position's whole cell state from its heads' ``finals[j]``."""
    _, dh = xlstm_mod._cell_dims(cfg.d_model, cfg.n_heads)
    if prefix.startswith("slstm."):
        tails = [(dh,)] * 4
    else:
        tails = [(dh, dh), (dh,), ()]
    comps = []
    for i, tail in enumerate(tails):
        like = [torch.zeros((b, 0) + tail, device=d)
                for d in view.devices]
        comps.append(heads_whole([finals[j][i] if j in finals else None
                                  for j in range(view.m)], like))
    return [tuple(c[j] for c in comps) for j in range(view.m)]


def group_prefill(view, cfg: ArchConfig, tokens: torch.Tensor,
                  cache_len: int, image_embeds=None,
                  cells: Optional[tuple] = None) -> tuple:
    """One data group's prefill: (last-position logits ``[B, 1, V]`` on
    position 0, its caches ``[i][j]``, cross K/V ``[s][j]``, recurrent
    states ``[i][j]``); ``cells``: :func:`cell_range`'s ``(c0, n)`` of the
    cache's split (default the group's own positions)."""
    t = tokens.shape[1]
    audio = cfg.family == "audio"
    if t > cache_len and not audio:
        raise ValueError(f"a prompt of {t} tokens does not fit a cache of "
                         f"{cache_len} slots")
    m = view.m
    c0, n_cells = cells or (0, m)
    if cfg.family == "vlm":
        for j in range(m):
            image_slots(c0 + j, n_cells, cfg.n_image_tokens)
    exchange = kv_by_exchange(m, cfg, cache_len)
    st = tp.Stream(view.devices, t)
    if audio:           # tokens are frame embeddings [B, T, d]
        xs = st.inputs(tokens.to(tf.DTYPES[cfg.dtype]))
    else:
        xs = tp.embed(view, cfg, st, tokens)
    caches, cross, rec = [], [], []

    def self_layer(prefix, xs):
        hs = st.gather(tp._norms(view, prefix + "attn_norm.", xs, cfg))
        parts, kvs = prefill_attention(view, prefix + "attn.", hs, cfg,
                                       window=cfg.window, exchange=exchange,
                                       causal=not audio, keep=not audio)
        xs = [x + a for x, a in zip(xs, st.reduce(parts))]
        del hs, parts
        if not audio:
            caches.append(to_cache(kvs, m, cache_len, exchange, cells))
        del kvs
        xs, _ = tp.mlp_block(view, prefix, cfg, st, xs, 0.0)
        return xs

    if cfg.xlstm:
        for i in range(cfg.n_layers):
            xs, state = xlstm_prefill(view, f"{'slstm' if i % 2 == 0 else
                                                'mlstm'}.{i // 2}.", cfg,
                                      st, xs)
            rec.append(state)
    elif cfg.family == "vlm":
        n_img = cfg.n_image_tokens
        imgs = [tf._image_embeds(cfg, image_embeds, xs[0].new_empty(
            0, device=d)) for d in view.devices]
        cross_ex = kv_by_exchange(m, cfg, n_img)
        for s in range(tf.n_super(cfg)):
            for i in range(cfg.cross_attn_every):
                xs = self_layer(f"self_blocks.{s}.{i}.", xs)
            prefix = f"cross_blocks.{s}."
            hs = st.gather(tp._norms(view, prefix + "attn_norm.", xs, cfg))
            parts, kvs = prefill_attention(
                view, prefix + "attn.", hs, cfg, window=None,
                exchange=cross_ex, causal=False, kv_srcs=imgs)
            xs = [x + a for x, a in zip(xs, st.reduce(parts))]
            del hs, parts
            ks, vs, _ = relayout(kvs, m, n_img, cross_ex, cells)
            cross.append(list(zip(ks, vs)))
            del kvs
            xs, _ = tp.mlp_block(view, prefix, cfg, st, xs, 0.0)
    elif cfg.family == "hybrid":
        for s in range(tf.n_super(cfg)):
            for i in range(cfg.shared_attn_every):
                xs, state = ssm_prefill(view, f"ssm_blocks.{s}.{i}.", cfg,
                                        st, xs)
                rec.append(state)
            xs = self_layer("shared_block.", xs)
    else:       # dense, MoE, the audio encoder
        for i in range(cfg.n_layers):
            xs = self_layer(f"blocks.{i}.", xs)
    last = (tp.broadcast(xs[-1][:, -1:], view.devices) if st.split
            else [x[:, -1:] for x in xs])
    return logits(view, cfg, last), caches, cross, rec


@torch.inference_mode()
def prefill(lm, cfg: ArchConfig, tokens: torch.Tensor, cache_len: int,
            image_embeds: Optional[torch.Tensor] = None) -> tuple:
    """Prompt int[B, T] (the audio encoder: frames ``[B, T, d]``) ->
    (last-position logits ``[B, 1, V]`` on the lead device,
    :class:`GridState`, ``None`` for the encoder): ``transformer.prefill``
    over ``lm``'s grid, each data group on its rows (and the VLM's
    ``image_embeds`` of those rows)."""
    folded = specs.folds(tokens.shape[0])
    outs, caches, cross, rec = [], [], [], []
    for g, (r0, n) in enumerate(group_rows(lm, tokens.shape[0])):
        view = tp.GridView(lm, g)
        img = None if image_embeds is None else image_embeds[r0:r0 + n]
        lg, c, x, r = group_prefill(view, cfg, tokens[r0:r0 + n].to(
            view.devices[0]), cache_len, img, cell_range(lm, g, folded))
        outs.append(lg.to(lm.device))
        caches.append(c)
        cross.append(x)
        rec.append(r)
    if folded:      # every group ran the row: group 0's logits
        outs = outs[:1]
    if cfg.family == "audio":
        return torch.cat(outs, 0), None
    return torch.cat(outs, 0), GridState(
        caches=caches, cache_len=cache_len,
        cross_kv=cross if cfg.family == "vlm" else None,
        recurrent=rec if has_recurrent(cfg) else None, folded=folded)


# ------------------------------------------------------------------- decode
def share(view, j: int, name: str, dim: int) -> tuple:
    """Position ``j``'s share of ``name`` along ``dim`` and its ``(offset,
    length)`` there: its own ``model`` chunk where ``model`` splits that
    dim, else its even span of the whole leaf it holds (never another
    position's chunk)."""
    lm = view.lm
    if lm.mdims[name] == dim:
        return view.own(j, name), lm.mextent(j, name)
    lo, hi = tp._span(j, view.m, lm.shapes[name][dim])
    return view.own(j, name).narrow(dim, lo, hi - lo), (lo, hi - lo)


def columns(view, prefix: str, hs, names) -> list:
    """Each of ``names`` (``wq``, ``wk``, ``wv`` under ``prefix``) from the
    positions' own columns (column-parallel), all-gathered whole:
    ``[B, 1, heads, hd]`` on every position."""
    return [tp.all_gather([h @ share(view, j, prefix + name, 1)[0]
                           for j, h in enumerate(hs)], 2) for name in names]


def combine(views, prefix: str, qs, att, lengths, offs, cfg: ArchConfig,
            window: Optional[int], dtype) -> list:
    """Each cell's ``wo`` partial of the read of a cache split by sequence
    over the cells of ``views`` (one data group's positions, or every
    group's where the batch folds; module docstring), in cell order:
    ``qs[c]`` the whole query, ``att[c]`` the cell's slots' K/V from
    ``offs[c]`` in the model dtype, ``lengths[c]`` the rows' lengths (None:
    every slot read). Position ``j`` of each group receives ``wo``'s row
    chunk ``j`` of the P·V sum."""
    hd = cfg.hd
    scores = [attn.slice_scores(qj, ka, lj, off, hd=hd, window=window)
              for qj, (ka, _), lj, off in zip(qs, att, lengths, offs)]
    mx = tp.all_max([x.float().amax(-1) for x in scores])
    es = [attn.slice_exp(x, mj) for x, mj in zip(scores, mx)]
    del scores
    total = tp.all_reduce([sj for _, sj in es])
    pv = [attn.slice_pv(e, tot, va).flatten(2)
          for (e, _), tot, (_, va) in zip(es, total, att)]
    del es
    wos = [share(view, j, prefix + "wo", 0) for view in views
           for j in range(view.m)]
    os_ = tp.reduce_scatter(pv, 2, [piece for _, piece in wos])
    return [o.to(dtype) @ w for o, (w, _) in zip(os_, wos)]


def combined(views, folded: bool, prefix: str, qs, att, lengths, offs,
             cfg: ArchConfig, window: Optional[int], dtype) -> list:
    """:func:`combine` over every group's cells at once where ``folded``,
    else over each group's alone; the per-cell lists are every group's
    positions in order. Each group's partials."""
    m, groups = views[0].m, list(range(len(views)))
    parts = [None] * len(qs)
    for gs in [groups] if folded else [[g] for g in groups]:
        cells = [g * m + j for g in gs for j in range(m)]
        out = combine([views[g] for g in gs], prefix, *[
            [x[c] for c in cells] for x in (qs, att, lengths, offs)],
            cfg, window, dtype)
        for c, part in zip(cells, out):
            parts[c] = part
    return [parts[g * m:(g + 1) * m] for g in range(len(views))]


def own_heads(view, prefix: str, hs, qs, att, masks,
              cfg: ArchConfig) -> list:
    """Each position's ``wo`` partial of its own query heads' read of a
    whole cache (``att[j]`` its K/V, ``masks[j]`` the slots read)."""
    parts = []
    for j, (qj, (ka, va), mask) in enumerate(zip(qs, att, masks)):
        lo, hi, kmap = tp.query_heads(j, view.m, cfg)
        if hi == lo:
            parts.append(hs[j].new_zeros(hs[j].shape))
            continue
        klo, khi = kmap[0], kmap[-1] + 1
        kq, vq = tp.for_queries(ka[:, :, klo:khi], va[:, :, klo:khi],
                                kmap, klo)
        o = attn.attend(qj[:, :, lo:hi], kq, vq, mask, cfg.hd)
        parts.append(o.reshape(o.shape[0], 1, (hi - lo) * cfg.hd)
                     @ view.part(j, prefix + "wo", 0, lo * cfg.hd,
                                 hi * cfg.hd))
    return parts


def grid_attention(views, prefix: str, hss, cachess, cfg: ArchConfig,
                   cache_len: int, folded: bool) -> list:
    """Each data group's position partials of ``wo`` ``[B, 1, d]`` of one
    decode step's attention under ``prefix`` on its whole normed rows
    ``hss[g][j]``; writes the new entry into the cell holding its slot and
    advances every cell's lengths (module docstring). With a split cache
    the P·V partials are reduce-scattered by ``wo``'s row chunks (by head
    where ``m`` divides the heads), so no position reads another's ``wo``;
    the statistics combine over every group's cells where ``folded``."""
    hd, m = cfg.hd, views[0].m
    dtype = hss[0][0].dtype
    qs, att, lengths, offs = [], [], [], []
    for view, hs, caches in zip(views, hss, cachess):
        q, k, v = [[x.reshape(x.shape[0], 1, -1, hd) for x in xs]
                   for xs in columns(view, prefix, hs, ("wq", "wk", "wv"))]
        entries = [attn.decode_entry(qj, kj, vj, c.length, rope=cfg.rope,
                                     kv_dtype=c.k.dtype)
                   for qj, kj, vj, c in zip(q, k, v, caches)]
        c0, n_cells = cell_range(view.lm, view.g, folded)
        for j, ((qj, kn, vn), c) in enumerate(zip(entries, caches)):
            off = slots(c0 + j, n_cells, cache_len)[0]
            attn.write_slice(c, kn, vn, off)
            att.append(attn.attended(c, dtype))
            qs.append(qj)
            lengths.append(c.length)
            offs.append(off)
    if split_over_model(cache_len):
        parts = combined(views, folded, prefix, qs, att, lengths, offs, cfg,
                         cfg.window, dtype)
    else:
        parts = [own_heads(view, prefix, hss[g], qs[g * m:(g + 1) * m],
                           att[g * m:(g + 1) * m], [
            attn.decode_valid(c.length, 0, ka.shape[1],
                              cfg.window)[:, None, None, None]
            for c, (ka, _) in zip(cachess[g], att[g * m:(g + 1) * m])], cfg)
            for g, view in enumerate(views)]
    for caches in cachess:
        for c in caches:
            c.length += 1
    return parts


def grid_cross(views, prefix: str, hss, kvss, cfg: ArchConfig,
               folded: bool) -> list:
    """Each data group's position partials of ``wo`` of one decode step's
    cross read under ``prefix`` on the whole normed rows ``hss[g][j]``,
    ``kvss[g][j]`` the cell's image tokens' K/V: the split combine with
    every token valid (over every group's cells where ``folded``), or each
    position's own heads over the whole K/V, unmasked."""
    hd, m, n_img = cfg.hd, views[0].m, cfg.n_image_tokens
    qs, offs = [], []
    for view, hs in zip(views, hss):
        [q] = columns(view, prefix, hs, ("wq",))
        qs += [x.reshape(x.shape[0], 1, -1, hd) for x in q]
        c0, n_cells = cell_range(view.lm, view.g, folded)
        offs += [image_slots(c0 + j, n_cells, n_img)[0] for j in range(m)]
    if split_over_model(n_img):
        return combined(views, folded, prefix, qs,
                        [kv for kvs in kvss for kv in kvs],
                        [None] * len(qs), offs, cfg, None, hss[0][0].dtype)
    return [own_heads(view, prefix, hs, qs[g * m:(g + 1) * m], kvs,
                      [None] * m, cfg)
            for g, (view, hs, kvs) in enumerate(zip(views, hss, kvss))]


def ssm_decode(view, prefix: str, cfg: ArchConfig, st, xs, states) -> tuple:
    """``x`` plus one decode step of the Mamba2 mixer under ``prefix`` on
    the whole T 1 stream, each position on its own heads from its whole
    ``SSMCache`` ``states[j]``; the new caches, whole again (module
    docstring)."""
    spec, w = cfg.ssm, prefix + "ssm."
    _, n_heads, _ = ssm_mod.dims(cfg.d_model, spec)
    hs = tp._norms(view, prefix + "norm.", xs, cfg)
    parts, rows, tails = [], [], []
    for j, (h, c) in enumerate(zip(hs, states)):
        lo, hi = tp._span(j, view.m, n_heads)
        if hi == lo:
            parts.append(h.new_zeros(h.shape))
            rows.append(None)
            tails.append(None)
            continue
        p, proj, conv = tp.ssm_head_params(view, j, w, cfg, lo, hi)
        y, s, tail = ssm_mod.ssd_decode_heads(
            p, h @ view.cols(j, w + "in_proj", 1, proj),
            torch.cat([c.conv[..., a:b] for a, b in conv], -1),
            c.state[:, lo:hi], spec, (lo, hi), n_heads)
        parts.append(y @ view.cols(j, w + "out_proj", 0, [
            (lo * spec.head_dim, hi * spec.head_dim)]))
        rows.append(s)
        tails.append(tail)
    xs = [x + y for x, y in zip(xs, st.reduce(parts))]
    new = heads_whole(rows, [c.state for c in states])
    convs = conv_whole(view, cfg, tails)
    return xs, [ssm_mod.SSMCache(state=s, conv=c)
                for s, c in zip(new, convs)]


def xlstm_decode(view, prefix: str, cfg: ArchConfig, st, xs,
                 states) -> tuple:
    """``x`` plus one decode step of the xLSTM cell under ``prefix``, each
    position on its own heads from its whole state ``states[j]``; the new
    states, whole again."""
    carries = {}
    for j in range(view.m):
        lo, hi = tp._span(j, view.m, cfg.n_heads)
        carries[j] = tuple(x[:, lo:hi] for x in states[j])
    parts, finals = tp.xlstm_partials(view, prefix, cfg, xs, carries)
    xs = [x + y for x, y in zip(xs, st.reduce(parts))]
    return xs, xlstm_whole(view, cfg, prefix, finals, xs[0].shape[0])


def group_decode(view, cfg: ArchConfig, token: torch.Tensor, caches,
                 cache_len: int, cross=None, rec=None) -> torch.Tensor:
    """One data group's decode step (:func:`grid_decode`): logits
    ``[B, 1, V]`` on position 0; ``caches[i][j]`` written in place,
    ``rec[i]`` replaced."""
    return grid_decode([view], cfg, [token], [caches], cache_len, [cross],
                       [rec], False)[0]


def grid_decode(views, cfg: ArchConfig, tokens, caches, cache_len: int,
                cross, rec, folded: bool) -> list:
    """The data groups' decode step, layer by layer in lockstep: each
    group's logits ``[B, 1, V]`` on its position 0; ``caches[g][i][j]``
    written in place, ``rec[g][i]`` replaced. A cache read combines over
    every group's cells where ``folded``."""
    groups = range(len(views))
    sts = [tp.Stream(view.devices, 1) for view in views]
    xss = [tp.embed(view, cfg, st, tok)
           for view, st, tok in zip(views, sts, tokens)]
    calls = [iter(c) for c in caches]

    def norms(prefix):
        return [tp._norms(view, prefix + "attn_norm.", xs, cfg)
                for view, xs in zip(views, xss)]

    def close(prefix, partss):      # the row-parallel reduce, then the MLP
        for g, parts in enumerate(partss):
            xs = [x + a for x, a in zip(xss[g], sts[g].reduce(parts))]
            xss[g], _ = tp.mlp_block(views[g], prefix, cfg, sts[g], xs, 0.0)

    def self_layer(prefix):
        close(prefix, grid_attention(views, prefix + "attn.", norms(prefix),
                                     [next(c) for c in calls], cfg,
                                     cache_len, folded))

    if cfg.xlstm:
        for i in range(cfg.n_layers):
            prefix = f"{'slstm' if i % 2 == 0 else 'mlstm'}.{i // 2}."
            for g in groups:
                xss[g], rec[g][i] = xlstm_decode(views[g], prefix, cfg,
                                                 sts[g], xss[g], rec[g][i])
    elif cfg.family == "vlm":
        for s in range(tf.n_super(cfg)):
            for i in range(cfg.cross_attn_every):
                self_layer(f"self_blocks.{s}.{i}.")
            prefix = f"cross_blocks.{s}."
            close(prefix, grid_cross(views, prefix + "attn.", norms(prefix),
                                     [cross[g][s] for g in groups], cfg,
                                     folded))
    elif cfg.family == "hybrid":
        per = cfg.shared_attn_every
        for s in range(tf.n_super(cfg)):
            for i in range(per):
                li = s * per + i
                for g in groups:
                    xss[g], rec[g][li] = ssm_decode(
                        views[g], f"ssm_blocks.{s}.{i}.", cfg, sts[g], xss[g],
                        rec[g][li])
            self_layer("shared_block.")
    else:
        for i in range(cfg.n_layers):
            self_layer(f"blocks.{i}.")
    return [logits(view, cfg, xs) for view, xs in zip(views, xss)]


@torch.inference_mode()
def decode_step(lm, cfg: ArchConfig, token: torch.Tensor,
                state: GridState) -> tuple:
    """One token int[B, 1] -> (logits ``[B, 1, V]`` on the lead device,
    ``state``): ``transformer.decode_step`` over ``lm``'s grid; the
    state's caches are written and advanced in place, its recurrent states
    replaced. A batch of one row runs on every data group (its caches
    split over every cell); the logits are group 0's. The audio encoder
    raises ``ValueError``."""
    check_decode(cfg)
    rows = group_rows(lm, token.shape[0])
    views = [tp.GridView(lm, g) for g in range(len(rows))]
    none = [None] * len(views)
    outs = grid_decode(
        views, cfg, [token[r0:r0 + n].to(view.devices[0])
                     for (r0, n), view in zip(rows, views)],
        state.caches, state.cache_len,
        none if state.cross_kv is None else state.cross_kv,
        none if state.recurrent is None else state.recurrent, state.folded)
    if state.folded:
        outs = outs[:1]
    return torch.cat([o.to(lm.device) for o in outs], 0), state
