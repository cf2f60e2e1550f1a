"""Serving over a participant's ``(data group, model position)`` grid: the
prefill and the one-token decode of the dense and MoE families on a
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
  own copy of the rows' lengths.
* **Prefill** (:func:`prefill`). The residual stream, the norms, the MLP
  and the expert-parallel MoE run as in training (``tp.Stream``,
  ``tp.mlp_partials``, ``tp.moe_block``). Attention: position ``j`` runs
  the flash kernel (``kernels.ops.flash_attention``) on its query heads and
  the KV heads they read, and keeps its K/V for the cache. Where each
  position's KV heads are exactly its own ``wk`` / ``wv`` chunk and the
  cache is split, an all-to-all moves them from "my KV heads, every slot"
  to "every KV head, my slots" (the relayout). Otherwise (more positions
  than KV heads, a split off KV-head boundaries, or a whole cache) each
  position projects every KV head from ``wk`` / ``wv`` read whole and keeps
  its slots of them: a local narrow, no exchange. ``wo`` is row-parallel,
  reduced to the stream's layout. The last token's row is handed from the
  position that holds it to the others, normed there, and its logits are
  computed vocab-parallel and all-gathered whole.
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
  position with no slot to read adds exactly 0. With a whole cache each
  position attends its own query heads (``attention.attend``). ``wo`` is
  row-parallel and its ``[B, 1, d]`` partials all-reduced in position
  order; the MLP and MoE run as in training on the whole T 1 stream.

The families whose serving state is not a KV cache a layer (VLM, hybrid,
xLSTM, audio) are refused with a ``ValueError``; none runs whole on one
position.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.launch import specs, tp
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import apply_rope

def serves(cfg: ArchConfig) -> bool:
    """Whether the grid steps serve ``cfg``'s family."""
    return cfg.family in ("dense", "moe") and not cfg.xlstm


def check_family(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a family the grid steps do not serve."""
    if not serves(cfg):
        raise ValueError(f"{cfg.name}: the grid serving steps serve the "
                         f"dense and MoE families, not {cfg.family!r}")


@dataclasses.dataclass
class GridState:
    """A grid's decode caches: ``caches[g][i][j]`` the ``KVCache`` of
    layer ``i`` on data group ``g``'s model position ``j`` (its rows, and
    its slots where ``split``), written in place by :func:`decode_step`."""
    caches: list
    cache_len: int

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


def group_rows(lm, n_rows: int) -> list:
    """Each data group's ``(first row, rows)`` of a batch of ``n_rows``."""
    if n_rows % lm.n_data:
        raise ValueError(f"batch {n_rows} does not split over {lm.n_data} "
                         "data positions")
    per = n_rows // lm.n_data
    return [(pos.start * per, len(pos) * per) for _, pos in lm.groups]


def init_state(lm, cfg: ArchConfig, batch: int, cache_len: int) -> GridState:
    """Empty caches (length 0) for ``batch`` rows of ``cache_len`` slots
    over ``lm``'s grid (module docstring), int8 K/V when ``cfg.kv_dtype ==
    'int8'``."""
    check_family(cfg)
    kv_dt = torch.int8 if cfg.kv_dtype == "int8" else tf.DTYPES[cfg.dtype]
    caches = []
    for g, (_, rows) in enumerate(group_rows(lm, batch)):
        devs = tp.GridView(lm, g).devices
        caches.append([[KVCache(
            k=torch.zeros((rows, n, cfg.n_kv_heads, cfg.hd), dtype=kv_dt,
                          device=d),
            v=torch.zeros((rows, n, cfg.n_kv_heads, cfg.hd), dtype=kv_dt,
                          device=d),
            length=torch.zeros((rows,), dtype=torch.int32, device=d))
            for j, d in enumerate(devs)
            for n in [slots(j, lm.n_model, cache_len)[1]]]
            for _ in range(cfg.n_layers)])
    return GridState(caches=caches, cache_len=cache_len)


def state_tensors(state: GridState) -> list:
    """Every tensor the state holds (each position's k, v and lengths)."""
    return [t for group in state.caches for layer in group for c in layer
            for t in (c.k, c.v, c.length)]


# ------------------------------------------------------------------ prefill
def kv_by_exchange(m: int, cfg: ArchConfig, cache_len: int) -> bool:
    """Whether the prefill's K/V reach the cache by the all-to-all: the
    cache is split and each position's query heads read exactly its own
    span of the KV heads (module docstring)."""
    if not split_over_model(cache_len):
        return False
    for j in range(m):
        _, _, kmap = tp.query_heads(j, m, cfg)
        if not kmap or (kmap[0], kmap[-1] + 1) != tp._span(j, m,
                                                           cfg.n_kv_heads):
            return False
    return True


def prefill_attention(view, prefix: str, hs, cfg: ArchConfig, *,
                      window: Optional[int], exchange: bool) -> tuple:
    """Each position's ``wo`` partial of the attention under ``prefix`` on
    its whole normed rows ``hs[j]`` through the flash kernel, and the K/V
    it keeps for the cache ``[B, T, heads, hd]``: its own KV heads where
    they reach the cache by the exchange, else every KV head."""
    hd, n_kv = cfg.hd, cfg.n_kv_heads
    parts, kvs = [], []
    for j, h in enumerate(hs):
        b, t, _ = h.shape
        lo, hi, kmap = tp.query_heads(j, view.m, cfg)
        ka, kb = (kmap[0], kmap[-1] + 1) if exchange else (0, n_kv)
        positions = torch.arange(t, device=h.device)[None, :]
        k = apply_rope(tp.project_heads(view, j, prefix + "wk", h, ka, kb,
                                        hd), positions, cfg.rope)
        v = tp.project_heads(view, j, prefix + "wv", h, ka, kb, hd)
        kvs.append((k, v))
        if hi == lo:
            parts.append(h.new_zeros((b, t, cfg.d_model)))
            continue
        q = apply_rope(tp.project_heads(view, j, prefix + "wq", h, lo, hi,
                                        hd), positions, cfg.rope)
        klo, khi = kmap[0], kmap[-1] + 1
        kq, vq = tp.for_queries(k.narrow(2, klo - ka, khi - klo),
                                v.narrow(2, klo - ka, khi - klo), kmap, klo)
        o = ops.flash_attention(q, kq, vq, causal=True, window=window)
        parts.append(o.reshape(b, t, (hi - lo) * hd)
                     @ view.part(j, prefix + "wo", 0, lo * hd, hi * hd))
    return parts, kvs


def to_cache(kvs, m: int, cache_len: int, exchange: bool) -> list:
    """Each position's ``KVCache`` of one layer from the prefill's K/V
    (:func:`prefill_attention`): the prompt's slots, zero past them."""
    t = kvs[0][0].shape[1]
    spans = [slots(j, m, cache_len) for j in range(m)]
    pieces = [(min(off, t), max(0, min(off + n, t) - off))
              for off, n in spans]
    if exchange:
        ks = tp.all_to_all([k for k, _ in kvs], 1, 2, pieces)
        vs = tp.all_to_all([v for _, v in kvs], 1, 2, pieces)
    else:
        ks = [k.narrow(1, *p) for (k, _), p in zip(kvs, pieces)]
        vs = [v.narrow(1, *p) for (_, v), p in zip(kvs, pieces)]
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
    all-gathered whole; position 0's copy."""
    hs = tp._norms(view, "final_norm.", xs, cfg)
    parts = []
    for j, h in enumerate(hs):
        lo, hi = tp._span(j, view.m, cfg.vocab)
        parts.append(h @ view.part(j, "lm_head", 1, lo, hi))
    return tp.all_gather(parts, 2)[0]


def group_prefill(view, cfg: ArchConfig, tokens: torch.Tensor,
                  cache_len: int) -> tuple:
    """One data group's prefill: (last-position logits ``[B, 1, V]`` on
    position 0, each layer's caches over the positions)."""
    t = tokens.shape[1]
    if t > cache_len:
        raise ValueError(f"a prompt of {t} tokens does not fit a cache of "
                         f"{cache_len} slots")
    m = view.m
    exchange = kv_by_exchange(m, cfg, cache_len)
    st = tp.Stream(view.devices, t)
    xs = tp.embed(view, cfg, st, tokens)
    caches = []
    for i in range(cfg.n_layers):
        prefix = f"blocks.{i}."
        hs = st.gather(tp._norms(view, prefix + "attn_norm.", xs, cfg))
        parts, kvs = prefill_attention(view, prefix + "attn.", hs, cfg,
                                       window=cfg.window, exchange=exchange)
        xs = [x + a for x, a in zip(xs, st.reduce(parts))]
        del hs, parts
        caches.append(to_cache(kvs, m, cache_len, exchange))
        del kvs
        xs, _ = tp.mlp_block(view, prefix, cfg, st, xs, 0.0)
    last = (tp.broadcast(xs[-1][:, -1:], view.devices) if st.split
            else [x[:, -1:] for x in xs])
    return logits(view, cfg, last), caches


@torch.inference_mode()
def prefill(lm, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: int) -> tuple:
    """Prompt int[B, T] -> (last-position logits ``[B, 1, V]`` on the lead
    device, :class:`GridState`): ``transformer.prefill`` over ``lm``'s
    grid, each data group on its rows."""
    check_family(cfg)
    outs, caches = [], []
    for g, (r0, n) in enumerate(group_rows(lm, tokens.shape[0])):
        view = tp.GridView(lm, g)
        lg, c = group_prefill(view, cfg, tokens[r0:r0 + n].to(
            view.devices[0]), cache_len)
        outs.append(lg.to(lm.device))
        caches.append(c)
    return torch.cat(outs, 0), GridState(caches=caches, cache_len=cache_len)


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


def decode_attention(view, prefix: str, hs, caches, cfg: ArchConfig,
                     cache_len: int) -> list:
    """Each position's ``wo`` partial ``[B, 1, d]`` of one decode step's
    attention under ``prefix`` on the whole normed rows ``hs[j]``; writes
    the new entry into the position holding its slot and advances every
    position's lengths (module docstring). With a split cache the P·V
    partials are reduce-scattered by ``wo``'s row chunks (by head where
    ``m`` divides the heads), so no position reads another's ``wo``."""
    hd, m = cfg.hd, view.m
    dtype = hs[0].dtype
    q, k, v = [[x.reshape(x.shape[0], 1, -1, hd) for x in tp.all_gather(
        [h @ share(view, j, prefix + name, 1)[0] for j, h in enumerate(hs)],
        2)] for name in ("wq", "wk", "wv")]
    entries = [attn.decode_entry(qj, kj, vj, c.length, rope=cfg.rope,
                                 kv_dtype=c.k.dtype)
               for qj, kj, vj, c in zip(q, k, v, caches)]
    offs = [slots(j, m, cache_len)[0] for j in range(m)]
    att = []
    for (_, kn, vn), c, off in zip(entries, caches, offs):
        attn.write_slice(c, kn, vn, off)
        att.append(attn.attended(c, dtype))
    parts = []
    if split_over_model(cache_len):
        scores = [attn.slice_scores(qj, ka, c.length, off, hd=hd,
                                    window=cfg.window)
                  for (qj, _, _), (ka, _), c, off in zip(entries, att,
                                                         caches, offs)]
        mx = tp.all_max([x.float().amax(-1) for x in scores])
        es = [attn.slice_exp(x, mj) for x, mj in zip(scores, mx)]
        del scores
        total = tp.all_reduce([sj for _, sj in es])
        pv = [attn.slice_pv(e, tot, va).flatten(2)
              for (e, _), tot, (_, va) in zip(es, total, att)]
        del es
        wos = [share(view, j, prefix + "wo", 0) for j in range(m)]
        os_ = tp.reduce_scatter(pv, 2, [piece for _, piece in wos])
        parts = [o.to(dtype) @ w for o, (w, _) in zip(os_, wos)]
    else:
        for j, ((qj, _, _), (ka, va), c) in enumerate(zip(entries, att,
                                                          caches)):
            lo, hi, kmap = tp.query_heads(j, m, cfg)
            if hi == lo:
                parts.append(hs[j].new_zeros(hs[j].shape))
                continue
            klo, khi = kmap[0], kmap[-1] + 1
            kq, vq = tp.for_queries(ka[:, :, klo:khi], va[:, :, klo:khi],
                                    kmap, klo)
            mask = attn.decode_valid(c.length, 0, ka.shape[1],
                                     cfg.window)[:, None, None, None]
            o = attn.attend(qj[:, :, lo:hi], kq, vq, mask, hd)
            parts.append(o.reshape(o.shape[0], 1, (hi - lo) * hd)
                         @ view.part(j, prefix + "wo", 0, lo * hd, hi * hd))
    for c in caches:
        c.length += 1
    return parts


def group_decode(view, cfg: ArchConfig, token: torch.Tensor, caches,
                 cache_len: int) -> torch.Tensor:
    """One data group's decode step: logits ``[B, 1, V]`` on position 0;
    ``caches[i][j]`` written in place."""
    st = tp.Stream(view.devices, 1)
    xs = tp.embed(view, cfg, st, token)
    for i in range(cfg.n_layers):
        prefix = f"blocks.{i}."
        hs = tp._norms(view, prefix + "attn_norm.", xs, cfg)
        parts = decode_attention(view, prefix + "attn.", hs, caches[i], cfg,
                                 cache_len)
        xs = [x + a for x, a in zip(xs, st.reduce(parts))]
        xs, _ = tp.mlp_block(view, prefix, cfg, st, xs, 0.0)
    return logits(view, cfg, xs)


@torch.inference_mode()
def decode_step(lm, cfg: ArchConfig, token: torch.Tensor,
                state: GridState) -> tuple:
    """One token int[B, 1] -> (logits ``[B, 1, V]`` on the lead device,
    ``state``): ``transformer.decode_step`` over ``lm``'s grid; the
    state's caches are written and advanced in place."""
    check_family(cfg)
    outs = []
    for g, (r0, n) in enumerate(group_rows(lm, token.shape[0])):
        view = tp.GridView(lm, g)
        outs.append(group_decode(
            view, cfg, token[r0:r0 + n].to(view.devices[0]),
            state.caches[g], state.cache_len).to(lm.device))
    return torch.cat(outs, 0), state
