"""GQA attention: causal/sliding-window/non-causal self-attention,
cross-attention, prefill and single-token decode (port of
``repro.models.attention``).

GQA is computed natively: queries are grouped ``[B,T,kv,group,hd]`` against
the un-repeated K/V. The prefill's attention product goes through
``kernels.ops.flash_attention`` (the hand-written CUDA kernel on the card),
where the reference calls ``attend_chunked``, its XLA stand-in for the
Pallas flash kernel. The decode attends over the whole pre-allocated cache
with a validity mask in plain PyTorch (``attend``), as the reference does;
on a grid each position runs the same arithmetic on its slice of a cache
split by sequence, the softmax statistics combined across positions (the
pieces at the end of this module, ``launch/tp_serve.py``).

Training (``train=True``) runs the reference's own ``attend_chunked`` in
plain PyTorch under autograd: neither the flash kernel nor the Pallas one
has a backward, and ``ops.flash_attention`` refuses inputs that require
grad.

The flash kernel keeps scores and probabilities in f32, as the Pallas kernel
does; the reference's ``attend`` computes the scores in the model dtype and
casts the probabilities to it before the PV product. In f32 the two agree to
rounding; in bf16 the prefill differs from the reference model by bf16
rounding of the scores and probabilities.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.layers import Params, apply_rope, dense_init

NEG_INF = -1e30
KV_QSCALE = 0.05  # int8 KV quantization step (beyond-paper decode option)


@dataclasses.dataclass
class KVCache:
    """One layer's decode cache. The decode writes into ``k``/``v`` and
    advances ``length`` in place."""
    k: torch.Tensor        # [B, S, kv, hd]
    v: torch.Tensor        # [B, S, kv, hd]
    length: torch.Tensor   # int32[B] valid prefix length


def init_attention(generator: Optional[torch.Generator], d: int, n_heads: int,
                   n_kv: int, hd: int, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        "wq": dense_init(generator, d, n_heads * hd, dtype, device),
        "wk": dense_init(generator, d, n_kv * hd, dtype, device),
        "wv": dense_init(generator, d, n_kv * hd, dtype, device),
        "wo": dense_init(generator, n_heads * hd, d, dtype, device),
    })


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _q_groups(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,T,H,hd] -> [B,T,kv,g,hd] — GQA grouping without repeating K/V."""
    b, t, h, hd = q.shape
    return q.reshape(b, t, n_kv, h // n_kv, hd)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor], hd: int) -> torch.Tensor:
    """GQA attention. q: [B,T,H,hd]; k,v: [B,S,kv,hd] (kv divides H); mask
    broadcastable to [B,1,1,T,S]. Scores in the model dtype, softmax in f32,
    probabilities cast back before the PV product. Returns [B,T,H,hd]."""
    b, t, h, _ = q.shape
    n_kv = k.shape[2]
    qg = _q_groups(q, n_kv)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k) / (hd ** 0.5)
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, h, hd)


def causal_mask(t: int, s: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """[t, s] lower-triangular (optionally banded) mask; s >= t aligned at
    the end."""
    qi = torch.arange(t, device=device)[:, None] + (s - t)
    ki = torch.arange(s, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m


# Query-chunk size above which training never materializes the full [T, S]
# scores: the reference's XLA stand-in for the flash kernel.
CHUNK_Q = 1024


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   hd: int, causal: bool,
                   window: Optional[int]) -> torch.Tensor:
    """Memory-bounded GQA attention for training: ``attend`` over query
    chunks of ``CHUNK_Q``, each under a non-reentrant ``checkpoint`` (the
    backward recomputes a chunk's scores instead of saving them). A chunk's
    query positions start at its offset, keys at 0 (T = S, as in the
    reference); the window applies only when causal."""
    b, t, h, _ = q.shape
    s = k.shape[1]
    if t <= CHUNK_Q:
        mask = (causal_mask(t, s, window, device=q.device)[None, None, None]
                if causal else None)
        return attend(q, k, v, mask, hd)
    if t % CHUNK_Q:
        raise ValueError(f"T={t} must divide by CHUNK_Q={CHUNK_Q}")
    k_pos = torch.arange(s, device=q.device)[None, :]

    def one(qi: torch.Tensor, start: int) -> torch.Tensor:
        m = None
        if causal:
            q_pos = start + torch.arange(CHUNK_Q, device=q.device)[:, None]
            m = k_pos <= q_pos
            if window is not None:
                m &= k_pos > q_pos - window
            m = m[None, None, None]
        return attend(qi, k, v, m, hd)

    return torch.cat([checkpoint(one, q[:, start:start + CHUNK_Q], start,
                                 use_reentrant=False)
                      for start in range(0, t, CHUNK_Q)], 1)


def _qkv(p: Params, x: torch.Tensor, positions: torch.Tensor, *,
         n_heads: int, n_kv: int, hd: int, rope: str):
    q = _split_heads(x @ p["wq"], n_heads, hd)
    k = _split_heads(x @ p["wk"], n_kv, hd)
    v = _split_heads(x @ p["wv"], n_kv, hd)
    return apply_rope(q, positions, rope), apply_rope(k, positions, rope), v


def self_attention(
    p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int, hd: int,
    rope: str = "default", causal: bool = True, window: Optional[int] = None,
    positions: Optional[torch.Tensor] = None, train: bool = False,
) -> torch.Tensor:
    """Full-sequence self attention: the flash kernel (a prefill without a
    cache), or ``attend_chunked`` under autograd when ``train``."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _qkv(p, x, positions, n_heads=n_heads, n_kv=n_kv, hd=hd,
                   rope=rope)
    if train:
        out = attend_chunked(q, k, v, hd=hd, causal=causal, window=window)
    else:
        # the reference applies no mask, so no window, when not causal
        out = ops.flash_attention(q, k, v, causal=causal,
                                  window=window if causal else None)
    return out.reshape(b, t, n_heads * hd) @ p["wo"]


def cross_kv(p: Params, kv_src: torch.Tensor, *, n_kv: int,
             hd: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The K/V a cross-attention layer projects from ``kv_src`` (e.g. image
    embeddings), ``[B, S, kv, hd]`` each: what the decode state caches."""
    return (_split_heads(kv_src @ p["wk"], n_kv, hd),
            _split_heads(kv_src @ p["wv"], n_kv, hd))


def cross_attention(p: Params, x: torch.Tensor, kv_src: torch.Tensor, *,
                    n_heads: int, n_kv: int, hd: int,
                    kv: Optional[tuple] = None,
                    train: bool = False) -> torch.Tensor:
    """x attends to kv_src with no mask and no positional rotation; the
    product goes through the flash kernel (non-causal), or
    ``attend_chunked`` under autograd when ``train``. ``kv``: the K/V
    already projected from ``kv_src`` (``cross_kv``)."""
    b, t, _ = x.shape
    q = _split_heads(x @ p["wq"], n_heads, hd)
    k, v = kv if kv is not None else cross_kv(p, kv_src, n_kv=n_kv, hd=hd)
    if train:
        out = attend_chunked(q, k, v, hd=hd, causal=False, window=None)
    else:
        out = ops.flash_attention(q, k, v, causal=False)
    return out.reshape(b, t, n_heads * hd) @ p["wo"]


def decode_cross_attention(p: Params, x: torch.Tensor, kv: tuple, *,
                           n_heads: int, hd: int) -> torch.Tensor:
    """One decode step's cross read: ``attend`` over the cached image K/V
    with no mask, as the reference's decode does."""
    b, t, _ = x.shape
    q = _split_heads(x @ p["wq"], n_heads, hd)
    out = attend(q, kv[0], kv[1], None, hd)
    return out.reshape(b, t, n_heads * hd) @ p["wo"]


def decode_self_attention(
    p: Params, x: torch.Tensor, cache: KVCache, *, n_heads: int, n_kv: int,
    hd: int, rope: str = "default", window: Optional[int] = None,
) -> tuple[torch.Tensor, KVCache]:
    """One-token decode: x [B, 1, d]; writes position ``cache.length`` of
    each row into the cache in place and advances the length.

    The reference merges the new K/V by a one-hot blend over the whole cache
    (``k * (1 - oh) + oh * k_new``), which for finite values equals writing
    the one slot; the port writes it in place (the counterpart of the
    reference's donated buffers). A row whose cache is full (length >= S)
    gets no write, as the one-hot then matches no slot.
    """
    b, t, _ = x.shape
    if t != 1:
        raise ValueError(f"decode step consumes exactly one new token, got {t}")
    q, k_new, v_new = decode_entry(
        _split_heads(x @ p["wq"], n_heads, hd),
        _split_heads(x @ p["wk"], n_kv, hd),
        _split_heads(x @ p["wv"], n_kv, hd), cache.length, rope=rope,
        kv_dtype=cache.k.dtype)
    write_slice(cache, k_new, v_new, 0)
    k_att, v_att = attended(cache, x.dtype)
    mask = decode_valid(cache.length, 0, cache.k.shape[1],
                        window)[:, None, None, None]  # [B,1,1,1,S]
    out = attend(q, k_att, v_att, mask, hd)
    out = out.reshape(b, 1, n_heads * hd) @ p["wo"]
    cache.length += 1
    return out, cache


def prefill_cache(
    p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int, hd: int,
    rope: str = "default", window: Optional[int] = None,
    cache_len: Optional[int] = None,
) -> tuple[torch.Tensor, KVCache]:
    """Prefill: full causal attention AND the cache for subsequent decode
    (K/V in the model dtype, zero past ``t``)."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _qkv(p, x, positions, n_heads=n_heads, n_kv=n_kv, hd=hd,
                   rope=rope)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    out = out.reshape(b, t, n_heads * hd) @ p["wo"]
    s = cache_len or t
    kc = k.new_zeros((b, s, n_kv, hd))
    vc = v.new_zeros((b, s, n_kv, hd))
    kc[:, :t] = k
    vc[:, :t] = v
    length = torch.full((b,), t, dtype=torch.int32, device=x.device)
    return out, KVCache(k=kc, v=vc, length=length)


# ------------------------------------------- the decode over a cache's slice
# What one position of a grid runs on its own slots ``[off, off + S_j)`` of
# a cache split by sequence (``launch/tp_serve.py``; the reference's
# ``kv_seq`` flash-decode). Each piece is ``decode_self_attention``'s
# arithmetic on that slice (it runs the first four on the whole cache,
# ``off`` 0); the softmax statistics combine across positions between the
# last three (:func:`slice_scores` -> the max -> :func:`slice_exp` -> the
# sum -> :func:`slice_pv`).
def quantize_kv(x: torch.Tensor) -> torch.Tensor:
    """K/V as an int8 cache stores them (``KV_QSCALE`` steps)."""
    return torch.clamp(torch.round(x.float() / KV_QSCALE), -127,
                       127).to(torch.int8)


def decode_entry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor, *, rope: str,
                 kv_dtype: torch.dtype) -> tuple:
    """The new token's q / k / v ``[B, 1, heads, hd]`` rotated at each
    row's ``length``, K/V as a cache of ``kv_dtype`` stores them."""
    pos = length[:, None]
    q, k = apply_rope(q, pos, rope), apply_rope(k, pos, rope)
    if kv_dtype == torch.int8:
        k, v = quantize_kv(k), quantize_kv(v)
    return q, k, v


def write_slice(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                off: int) -> None:
    """Write each row's new entry at slot ``cache.length`` into the slots
    ``[off, off + S_j)`` that ``cache.k`` / ``cache.v`` hold: only where
    that slot lies in them, so a full row (length >= S) lies in no slice
    and gets no write, as in ``decode_self_attention``."""
    b, s = cache.k.shape[:2]
    local = cache.length.long() - off
    inside = ((local >= 0) & (local < s))[:, None, None]
    rows = torch.arange(b, device=cache.k.device)
    slot = local.clamp(0, s - 1)
    cache.k[rows, slot] = torch.where(inside, k_new[:, 0], cache.k[rows, slot])
    cache.v[rows, slot] = torch.where(inside, v_new[:, 0], cache.v[rows, slot])


def attended(cache: KVCache, dtype) -> tuple:
    """The cache's K/V in the model ``dtype`` (an int8 cache dequantised)."""
    if cache.k.dtype == torch.int8:
        return cache.k.to(dtype) * KV_QSCALE, cache.v.to(dtype) * KV_QSCALE
    return cache.k, cache.v


def decode_valid(length: torch.Tensor, off: int, s: int,
                 window: Optional[int]) -> torch.Tensor:
    """``[B, s]``: which of slots ``[off, off + s)`` a row's decode reads
    (the new slot included; the last ``window`` slots with a window)."""
    ki = off + torch.arange(s, device=length.device)[None, :]
    valid = ki <= length[:, None]
    if window is not None:
        valid &= ki > (length[:, None] - window)
    return valid


def slice_scores(q: torch.Tensor, k: torch.Tensor,
                 length: Optional[torch.Tensor], off: int, *, hd: int,
                 window: Optional[int]) -> torch.Tensor:
    """``attend``'s scores of the new token's q ``[B, 1, H, hd]`` against
    the slice's keys ``[B, S_j, kv, hd]`` (slots from ``off``):
    ``[B, kv, g, 1, S_j]`` in the model dtype, ``NEG_INF`` at a slot the
    row does not read (``length`` None: every slot is read, as by the
    cross-attention's decode)."""
    scores = torch.einsum("btkgd,bskd->bkgts", _q_groups(q, k.shape[2]),
                          k) / (hd ** 0.5)
    if length is None:
        return scores
    mask = decode_valid(length, off, k.shape[1], window)[:, None, None, None]
    return torch.where(mask, scores, torch.tensor(
        NEG_INF, dtype=scores.dtype, device=scores.device))


def slice_exp(scores: torch.Tensor, mx: torch.Tensor) -> tuple:
    """``exp(s - max)`` in f32 over the slice and its sum along the slots,
    ``mx`` the max over every position's slots (``[B, kv, g, 1]``). A slice
    with no slot to read adds exactly 0 (``exp(NEG_INF - max)`` is 0)."""
    e = torch.exp(scores.float() - mx[..., None])
    return e, e.sum(-1)


def slice_pv(e: torch.Tensor, total: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """The slice's P·V partial ``[B, 1, H, hd]`` in f32: the probabilities
    ``e / total`` (``total`` the sum over every position) cast to the
    model dtype as ``attend`` casts them, their products with the slice's
    values added in f32; the positions' partials add and round once."""
    b, n_kv, g = e.shape[:3]
    probs = (e / total[..., None]).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs.float(), v.float())
    return out.reshape(b, 1, n_kv * g, v.shape[-1])
