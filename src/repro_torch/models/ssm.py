"""Mamba2 (SSD, state space duality) block: the chunked-parallel prefill and
the one-step decode (port of ``repro.models.ssm``).

Scalar-per-head decay (a_t = exp(dt_t * A_h)), a multi-head state S in
R^{N x P}. The prefill runs the chunked SSD algorithm: a quadratic,
attention-like form inside chunks of length Q and a linear recurrence of the
state across chunks (the reference's ``lax.scan``, a loop here). The decode
is the O(1) recurrent update carried in ``SSMCache``.

Heads do not mix between the two projections, so the prefill and the
decode step are written on a range of heads (:func:`ssd_heads`,
:func:`ssd_decode_heads`, given the ``in_proj`` columns and conv channels
those heads read, :func:`head_columns`): ``ssd_forward`` and
``ssd_decode_step`` run them on every head, and ``launch/tp.py`` /
``launch/tp_serve.py`` run each model position's heads on its own.

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


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, spec: SSMSpec,
                n_groups: Optional[int] = None):
    gn = (spec.n_groups if n_groups is None else n_groups) * spec.d_state
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: 2 * d_inner + 2 * gn]
    dt = zxbcdt[..., 2 * d_inner + 2 * gn:]
    return z, xbc, dt


def head_groups(lo: int, hi: int, n_heads: int,
                spec: SSMSpec) -> tuple[int, int]:
    """The B/C groups ``[g_lo, g_hi)`` that heads ``[lo, hi)`` read."""
    per = n_heads // spec.n_groups
    return lo // per, (hi - 1) // per + 1


def head_columns(d_model: int, spec: SSMSpec, lo: int,
                 hi: int) -> tuple[list, list]:
    """What heads ``[lo, hi)`` read, as ``[(start, stop)]`` runs in order:
    of ``in_proj``'s columns (their z, x, their groups' B and C, their dt)
    and of the conv's channels (``conv_w`` / ``conv_b``: their x, B, C).
    Adjacent runs are merged."""
    d_inner, n_heads, _ = dims(d_model, spec)
    p, n = spec.head_dim, spec.d_state
    gn = spec.n_groups * n
    g_lo, g_hi = head_groups(lo, hi, n_heads, spec)
    conv = [(lo * p, hi * p), (d_inner + g_lo * n, d_inner + g_hi * n),
            (d_inner + gn + g_lo * n, d_inner + gn + g_hi * n)]
    proj = ([(lo * p, hi * p)] + [(d_inner + a, d_inner + b) for a, b in conv]
            + [(2 * d_inner + 2 * gn + lo, 2 * d_inner + 2 * gn + hi)])
    return _merge_runs(proj), _merge_runs(conv)


def _merge_runs(runs) -> list:
    """``[(start, stop)]`` with each run that starts where the last one
    stops joined to it."""
    out: list = []
    for a, b in runs:
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


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


def _heads(xbc: torch.Tensor, spec: SSMSpec, heads: tuple[int, int],
           n_heads: int):
    """xs ``[..., h, P]`` of heads ``[lo, hi)`` of ``n_heads`` and B, C
    repeated from their groups to those heads ``[..., h, N]``; ``xbc``
    holds the heads' x channels, then B and C of their groups
    (:func:`head_groups`)."""
    lo, hi = heads
    n = spec.d_state
    g_lo, g_hi = head_groups(lo, hi, n_heads, spec)
    ng, d_in = g_hi - g_lo, (hi - lo) * spec.head_dim
    lead = xbc.shape[:-1]
    xs = xbc[..., :d_in].reshape(*lead, hi - lo, spec.head_dim)
    bv = xbc[..., d_in: d_in + ng * n].reshape(*lead, ng, n)
    cv = xbc[..., d_in + ng * n:].reshape(*lead, ng, n)
    rep = n_heads // spec.n_groups
    off = lo - g_lo * rep
    return (xs, bv.repeat_interleave(rep, dim=-2).narrow(-2, off, hi - lo),
            cv.repeat_interleave(rep, dim=-2).narrow(-2, off, hi - lo))


def ssd_forward(p: Params, x: torch.Tensor, spec: SSMSpec,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan. x: [B, T, d_model] -> (y, final state [B,H,N,P])."""
    _, n_heads, _ = dims(x.shape[-1], spec)
    y, s = ssd_heads(p, x @ p["in_proj"], spec, (0, n_heads), n_heads,
                     init_state)
    return y @ p["out_proj"], s


def ssd_heads(p: Params, zxbcdt: torch.Tensor, spec: SSMSpec,
              heads: tuple[int, int], n_heads: int,
              init_state: Optional[torch.Tensor] = None):
    """The mixer between its two projections, on heads ``[lo, hi)`` of
    ``n_heads``: ``zxbcdt [B, T, .]`` the input's product with the
    ``in_proj`` columns those heads read (:func:`head_columns`), ``p``'s
    ``conv_w`` / ``conv_b`` their conv channels and ``A_log`` / ``D`` /
    ``dt_bias`` their entries. Returns (the gated output ``[B, T, (hi -
    lo) P]`` in ``zxbcdt``'s dtype, final state ``[B, hi - lo, N, P]``).
    Heads do not mix: each one's output depends on its own columns
    alone."""
    b, t, _ = zxbcdt.shape
    lo, hi = heads
    nh = hi - lo
    g_lo, g_hi = head_groups(lo, hi, n_heads, spec)
    n, pdim = spec.d_state, spec.head_dim
    d_in = nh * pdim
    q = chunk_len(t, spec.chunk)
    nc = t // q

    z, xbc, dt = _split_proj(zxbcdt, d_in, spec, g_hi - g_lo)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, bh, ch = _heads(xbc, spec, heads, n_heads)            # [B,T,h,.]

    dtv = softplus(dt.float() + p["dt_bias"])                 # [B,T,h]
    a = -torch.exp(p["A_log"])                                # [h] (< 0)
    loga = dtv * a                                            # log decay

    def ch_(u):
        return u.reshape(b, nc, q, *u.shape[2:])
    xs_c, b_c, c_c, loga_c, dt_c = map(ch_, (xs, bh, ch, loga, dtv))
    xs_f = xs_c.float()

    cum = torch.cumsum(loga_c, dim=2)                         # [B,nc,Q,h]
    # intra-chunk (attention-like) term; the mask goes on BEFORE the exp
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [B,nc,Qq,Qk,h]
    causal = torch.ones((q, q), dtype=torch.bool,
                        device=zxbcdt.device).tril()
    rel = rel.masked_fill(~causal[None, None, :, :, None], -math.inf)
    gamma = torch.exp(rel)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", c_c, b_c) * gamma
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp",
                           scores * dt_c[:, :, None, :, :], xs_f)

    # per-chunk input -> state contribution
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # [B,nc,Q,h]
    chunk_state = torch.einsum("bcqhn,bcqhp->bchnp",
                               b_c.float() * (dt_c * decay_to_end)[..., None],
                               xs_f)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # [B,nc,h]

    s = (init_state if init_state is not None
         else torch.zeros((b, nh, n, pdim), dtype=torch.float32,
                          device=zxbcdt.device))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    s_prevs = torch.stack(s_prevs, 1)                         # [B,nc,h,N,P]

    # inter-chunk: the carried state's contribution to each position
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           c_c.float() * torch.exp(cum)[..., None], s_prevs)
    y = (y_intra + y_inter).reshape(b, t, nh, pdim)
    y = y + xs * p["D"][None, None, :, None]
    y = y.reshape(b, t, d_in).to(zxbcdt.dtype)
    return y * F.silu(z), s


def ssd_decode_step(p: Params, x: torch.Tensor, cache: SSMCache,
                    spec: SSMSpec):
    """One-token recurrent update. x: [B, 1, d_model] -> (y, new cache)."""
    _, n_heads, _ = dims(x.shape[-1], spec)
    y, s, new_conv = ssd_decode_heads(p, x @ p["in_proj"], cache.conv,
                                      cache.state, spec, (0, n_heads),
                                      n_heads)
    return y @ p["out_proj"], SSMCache(state=s, conv=new_conv)


def ssd_decode_heads(p: Params, zxbcdt: torch.Tensor, conv: torch.Tensor,
                     state: torch.Tensor, spec: SSMSpec,
                     heads: tuple[int, int], n_heads: int):
    """The one-token step between the two projections on heads ``[lo,
    hi)`` of ``n_heads`` (as :func:`ssd_heads` for the prefill):
    ``zxbcdt [B, 1, .]`` the token's product with the heads' ``in_proj``
    columns, ``conv [B, K-1, .]`` the rolling context of their conv
    channels, ``state [B, hi - lo, N, P]`` theirs. Returns (the gated
    output ``[B, 1, (hi - lo) P]``, the new state, the new context)."""
    b = zxbcdt.shape[0]
    lo, hi = heads
    g_lo, g_hi = head_groups(lo, hi, n_heads, spec)
    d_in = (hi - lo) * spec.head_dim

    z, xbc, dt = _split_proj(zxbcdt, d_in, spec, g_hi - g_lo)
    # rolling causal conv: context = the last (K-1) inputs + the current one
    ctx = torch.cat([conv, xbc], dim=1)                       # [B,K,C]
    xbc_t = F.silu(torch.einsum("bkc,kc->bc", ctx, p["conv_w"])
                   + p["conv_b"])
    new_conv = ctx[:, 1:, :]
    xs, bh, ch = _heads(xbc_t, spec, heads, n_heads)          # [B,h,.]

    dtv = softplus(dt[:, 0].float() + p["dt_bias"])           # [B,h]
    a = torch.exp(dtv * (-torch.exp(p["A_log"])))             # [B,h]
    xs_f = xs.float()
    s = state * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", bh.float() * dtv[..., None], xs_f)
    y = torch.einsum("bhn,bhnp->bhp", ch.float(), s)
    y = y + xs_f * p["D"][None, :, None]
    y = y.reshape(b, 1, d_in).to(zxbcdt.dtype) * F.silu(z)
    return y, s, new_conv


def init_cache(batch: int, d_model: int, spec: SSMSpec, dtype,
               device) -> SSMCache:
    _, n_heads, conv_ch = dims(d_model, spec)
    return SSMCache(
        state=torch.zeros((batch, n_heads, spec.d_state, spec.head_dim),
                          dtype=torch.float32, device=device),
        conv=torch.zeros((batch, spec.d_conv - 1, conv_ch), dtype=dtype,
                         device=device))
