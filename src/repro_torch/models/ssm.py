"""Mamba2 (SSD, state space duality) block: the chunked-parallel prefill and
the one-step decode (port of ``repro.models.ssm``).

Scalar-per-head decay (a_t = exp(dt_t * A_h)), a multi-head state S in
R^{N x P}. The prefill runs the chunked SSD algorithm: a quadratic,
attention-like form inside chunks of length Q and a linear recurrence of the
state across chunks (the reference's ``lax.scan``, a loop here). The decode
is the O(1) recurrent update carried in ``SSMCache``.

Multi-operand einsums are written as products of two operands (the reference
lets XLA order them): a left-to-right contraction would build a
``[B, nc, Q, Q, H, P]`` intermediate at full width. The sums run in another
order than XLA's, so f32 results agree to rounding (tests state the
tolerance).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SSMSpec
from repro_torch.models.layers import Params, const_init, dense_init, normal_init


class SSMCache(NamedTuple):
    state: torch.Tensor    # [B, H, N, P] f32
    conv: torch.Tensor     # [B, d_conv-1, conv_channels] rolling conv context


def dims(d_model: int, spec: SSMSpec):
    d_inner = spec.expand * d_model
    n_heads = d_inner // spec.head_dim
    conv_ch = d_inner + 2 * spec.n_groups * spec.d_state
    return d_inner, n_heads, conv_ch


def init_ssm(generator: Optional[torch.Generator], d_model: int,
             spec: SSMSpec, dtype, device) -> nn.ParameterDict:
    d_inner, n_heads, conv_ch = dims(d_model, spec)
    proj_out = 2 * d_inner + 2 * spec.n_groups * spec.d_state + n_heads
    return nn.ParameterDict({
        "in_proj": dense_init(generator, d_model, proj_out, dtype, device),
        "conv_w": normal_init(generator, (spec.d_conv, conv_ch), 0.1, dtype,
                              device),
        "conv_b": const_init(torch.zeros(conv_ch), dtype, device),
        "A_log": const_init(torch.log(torch.linspace(1.0, 16.0, n_heads)),
                            torch.float32, device),
        "D": const_init(torch.ones(n_heads), torch.float32, device),
        "dt_bias": const_init(torch.zeros(n_heads), torch.float32, device),
        "out_proj": dense_init(generator, d_inner, d_model, dtype, device),
    })


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, spec: SSMSpec):
    gn = spec.n_groups * spec.d_state
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: 2 * d_inner + 2 * gn]
    dt = zxbcdt[..., 2 * d_inner + 2 * gn:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: [B, T, C]; w: [K, C]."""
    k, t = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + t, :] * w[i] for i in range(k))
    return F.silu(out + b)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def chunk_len(t: int, chunk: int) -> int:
    """The reference's chunk: ``chunk``, or for a length it does not divide,
    the largest divisor of t that is <= chunk (it sets the rounding)."""
    if t % chunk == 0:
        return chunk
    return next(d for d in range(min(chunk, t), 0, -1) if t % d == 0)


def _heads(xbc: torch.Tensor, d_inner: int, spec: SSMSpec, n_heads: int):
    """xs ``[..., H, P]`` and B, C repeated from their groups to the heads
    ``[..., H, N]``."""
    g, n = spec.n_groups, spec.d_state
    lead = xbc.shape[:-1]
    xs = xbc[..., :d_inner].reshape(*lead, n_heads, spec.head_dim)
    bv = xbc[..., d_inner: d_inner + g * n].reshape(*lead, g, n)
    cv = xbc[..., d_inner + g * n:].reshape(*lead, g, n)
    rep = n_heads // g
    return (xs, bv.repeat_interleave(rep, dim=-2),
            cv.repeat_interleave(rep, dim=-2))


def ssd_forward(p: Params, x: torch.Tensor, spec: SSMSpec,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan. x: [B, T, d_model] -> (y, final state [B,H,N,P])."""
    b, t, d_model = x.shape
    d_inner, n_heads, _ = dims(d_model, spec)
    n, pdim = spec.d_state, spec.head_dim
    q = chunk_len(t, spec.chunk)
    nc = t // q

    z, xbc, dt = _split_proj(x @ p["in_proj"], d_inner, spec)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, bh, ch = _heads(xbc, d_inner, spec, n_heads)          # [B,T,H,.]

    dtv = softplus(dt.float() + p["dt_bias"])                 # [B,T,H]
    a = -torch.exp(p["A_log"])                                # [H] (< 0)
    loga = dtv * a                                            # log decay

    def ch_(u):
        return u.reshape(b, nc, q, *u.shape[2:])
    xs_c, b_c, c_c, loga_c, dt_c = map(ch_, (xs, bh, ch, loga, dtv))
    xs_f = xs_c.float()

    cum = torch.cumsum(loga_c, dim=2)                         # [B,nc,Q,H]
    # intra-chunk (attention-like) term; the mask goes on BEFORE the exp
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [B,nc,Qq,Qk,H]
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    rel = rel.masked_fill(~causal[None, None, :, :, None], -math.inf)
    gamma = torch.exp(rel)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", c_c, b_c) * gamma
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp",
                           scores * dt_c[:, :, None, :, :], xs_f)

    # per-chunk input -> state contribution
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # [B,nc,Q,H]
    chunk_state = torch.einsum("bcqhn,bcqhp->bchnp",
                               b_c.float() * (dt_c * decay_to_end)[..., None],
                               xs_f)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # [B,nc,H]

    s = (init_state if init_state is not None
         else torch.zeros((b, n_heads, n, pdim), dtype=torch.float32,
                          device=x.device))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    s_prevs = torch.stack(s_prevs, 1)                         # [B,nc,H,N,P]

    # inter-chunk: the carried state's contribution to each position
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           c_c.float() * torch.exp(cum)[..., None], s_prevs)
    y = (y_intra + y_inter).reshape(b, t, n_heads, pdim)
    y = y + xs * p["D"][None, None, :, None]
    y = y.reshape(b, t, d_inner).to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"], s


def ssd_decode_step(p: Params, x: torch.Tensor, cache: SSMCache,
                    spec: SSMSpec):
    """One-token recurrent update. x: [B, 1, d_model] -> (y, new cache)."""
    b, _, d_model = x.shape
    d_inner, n_heads, _ = dims(d_model, spec)

    z, xbc, dt = _split_proj(x @ p["in_proj"], d_inner, spec)
    # rolling causal conv: context = the last (K-1) inputs + the current one
    ctx = torch.cat([cache.conv, xbc], dim=1)                 # [B,K,C]
    xbc_t = F.silu(torch.einsum("bkc,kc->bc", ctx, p["conv_w"])
                   + p["conv_b"])
    new_conv = ctx[:, 1:, :]
    xs, bh, ch = _heads(xbc_t, d_inner, spec, n_heads)         # [B,H,.]

    dtv = softplus(dt[:, 0].float() + p["dt_bias"])           # [B,H]
    a = torch.exp(dtv * (-torch.exp(p["A_log"])))             # [B,H]
    xs_f = xs.float()
    s = cache.state * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", bh.float() * dtv[..., None], xs_f)
    y = torch.einsum("bhn,bhnp->bhp", ch.float(), s)
    y = y + xs_f * p["D"][None, :, None]
    y = y.reshape(b, 1, d_inner).to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], SSMCache(state=s, conv=new_conv)


def init_cache(batch: int, d_model: int, spec: SSMSpec, dtype,
               device) -> SSMCache:
    _, n_heads, conv_ch = dims(d_model, spec)
    return SSMCache(
        state=torch.zeros((batch, n_heads, spec.d_state, spec.head_dim),
                          dtype=torch.float32, device=device),
        conv=torch.zeros((batch, spec.d_conv - 1, conv_ch), dtype=dtype,
                         device=device))
