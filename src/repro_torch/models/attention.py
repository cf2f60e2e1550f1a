"""GQA attention: causal/sliding-window/non-causal self-attention,
cross-attention, prefill and single-token decode (port of
``repro.models.attention``).

GQA is computed natively: queries are grouped ``[B,T,kv,group,hd]`` against
the un-repeated K/V. The prefill's attention product goes through
``kernels.ops.flash_attention`` (the hand-written CUDA kernel on the card),
where the reference calls ``attend_chunked``, its XLA stand-in for the
Pallas flash kernel. The decode attends over the whole pre-allocated cache
with a validity mask in plain PyTorch (``attend``), as the reference does.

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


def _qkv(p: Params, x: torch.Tensor, positions: torch.Tensor, *,
         n_heads: int, n_kv: int, hd: int, rope: str):
    q = _split_heads(x @ p["wq"], n_heads, hd)
    k = _split_heads(x @ p["wk"], n_kv, hd)
    v = _split_heads(x @ p["wv"], n_kv, hd)
    return apply_rope(q, positions, rope), apply_rope(k, positions, rope), v


def self_attention(
    p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int, hd: int,
    rope: str = "default", causal: bool = True, window: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence self attention (prefill without a cache)."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _qkv(p, x, positions, n_heads=n_heads, n_kv=n_kv, hd=hd,
                   rope=rope)
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
                    kv: Optional[tuple] = None) -> torch.Tensor:
    """x attends to kv_src with no mask and no positional rotation; the
    product goes through the flash kernel (non-causal). ``kv``: the K/V
    already projected from ``kv_src`` (``cross_kv``)."""
    b, t, _ = x.shape
    q = _split_heads(x @ p["wq"], n_heads, hd)
    k, v = kv if kv is not None else cross_kv(p, kv_src, n_kv=n_kv, hd=hd)
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
    pos = cache.length[:, None]  # [B,1]
    q, k_new, v_new = _qkv(p, x, pos, n_heads=n_heads, n_kv=n_kv, hd=hd,
                           rope=rope)

    s = cache.k.shape[1]
    quant = cache.k.dtype == torch.int8
    if quant:  # int8 cache: quantize the new entry, store it in int8
        k_new = torch.clamp(torch.round(k_new.float() / KV_QSCALE),
                            -127, 127).to(torch.int8)
        v_new = torch.clamp(torch.round(v_new.float() / KV_QSCALE),
                            -127, 127).to(torch.int8)
    rows = torch.arange(b, device=x.device)
    slot = cache.length.clamp(max=s - 1).long()
    fits = (cache.length < s)[:, None, None]
    cache.k[rows, slot] = torch.where(fits, k_new[:, 0], cache.k[rows, slot])
    cache.v[rows, slot] = torch.where(fits, v_new[:, 0], cache.v[rows, slot])
    if quant:
        k_att = cache.k.to(x.dtype) * KV_QSCALE
        v_att = cache.v.to(x.dtype) * KV_QSCALE
    else:
        k_att, v_att = cache.k, cache.v

    ki = torch.arange(s, device=x.device)[None, :]
    valid = ki <= cache.length[:, None]  # includes the newly written slot
    if window is not None:
        valid &= ki > (cache.length[:, None] - window)
    mask = valid[:, None, None, None, :]  # [B,1,1,1,S]

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
