"""xLSTM blocks (arXiv:2405.04517): sLSTM (scalar memory, exponential gating
with a stabilizer) and mLSTM (matrix memory, covariance update); port of
``repro.models.xlstm``.

Prefill:
  * mLSTM runs in the chunked-parallel form: the per-step matrix state
    C [dh, dh] exists only per chunk. The unstabilized chunked math equals
    the stabilized recurrence (the stabilizer cancels; h = Cq / max(|n.q|,
    1)), so the state it returns carries m = 0.
  * sLSTM has no parallel form (a true nonlinear recurrence): a loop over
    the T steps on the host, where the reference runs ``lax.scan``. The
    reference's remat chunks (``CHUNK_T``) only save memory in its backward
    and change no value, so the loop has none.

Heads do not mix inside a cell: the sLSTM's recurrence is written for
several sets of heads advanced in one loop (:func:`slstm_scan`) and the
mLSTM's prefill and decode step on a set of heads (:func:`mlstm_heads`,
:func:`mlstm_decode_heads`), given those heads' columns, so
``launch/tp.py`` and ``launch/tp_serve.py`` run each model position's
heads on its own.

Decode: O(1) recurrent steps for both cells, carrying (c, n, m, h) and
(C, n, m). Blocks alternate sLSTM (even index) and mLSTM (odd). The
configuration's d_ff = 0: each cell carries its own factor-2 up/down
projection. Multi-operand einsums are written as two-operand products.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (Params, const_init, dense_init,
                                       floor_at, normal_init)

CHUNK_M = 256   # mLSTM chunked-parallel chunk length


def _cell_dims(d_model: int, n_heads: int, factor: int = 2):
    d_inner = factor * d_model
    dh = d_inner // n_heads
    return d_inner, dh


def init_slstm(generator: Optional[torch.Generator], d_model: int,
               n_heads: int, dtype, device) -> nn.ParameterDict:
    d_inner, dh = _cell_dims(d_model, n_heads)
    return nn.ParameterDict({
        "w_in": dense_init(generator, d_model, 4 * d_inner, dtype, device),
        "r": normal_init(generator, (n_heads, dh, 4 * dh), 0.05, dtype,
                         device),
        "b": const_init(torch.zeros(4 * d_inner), dtype, device),
        "w_out": dense_init(generator, d_inner, d_model, dtype, device),
    })


def init_mlstm(generator: Optional[torch.Generator], d_model: int,
               n_heads: int, dtype, device) -> nn.ParameterDict:
    d_inner, _ = _cell_dims(d_model, n_heads)
    return nn.ParameterDict({
        "w_qkv": dense_init(generator, d_model, 3 * d_inner, dtype, device),
        "w_if": dense_init(generator, d_model, 2 * n_heads, dtype, device),
        "w_o": dense_init(generator, d_model, d_inner, dtype, device),
        "w_out": dense_init(generator, d_inner, d_model, dtype, device),
    })


# ------------------------------------------------------------------- sLSTM
def _slstm_step(r: torch.Tensor, n_heads: int, dh: int):
    def step(carry, pre_t):  # pre_t: [B, 4, H, dh] f32
        c, n, m, h = carry
        bsz = h.shape[0]
        rec = torch.einsum("bhd,hde->bhe", h, r).reshape(bsz, n_heads, 4, dh)
        rec = rec.movedim(2, 1)                             # [B,4,H,dh]
        zt, it, ft, ot = (pre_t[:, j] + rec[:, j] for j in range(4))
        m_new = torch.maximum(ft + m, it)                   # stabilizer
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(ft + m - m_new)
        c_new = f_g * c + i_g * torch.tanh(zt)
        n_new = f_g * n + i_g
        h_new = torch.sigmoid(ot) * c_new / floor_at(n_new, 1e-6)
        return c_new, n_new, m_new, h_new

    return step


def slstm_pre(x: torch.Tensor, w_in: torch.Tensor, b: torch.Tensor,
              n_heads: int, dh: int) -> torch.Tensor:
    """The gates' input pre-activations ``[B, T, 4, H, dh]`` f32 of the
    ``n_heads`` heads whose ``w_in`` / ``b`` columns are given (gate-major:
    each gate's columns of those heads in turn)."""
    bsz, t, _ = x.shape
    return (x @ w_in + b).reshape(bsz, t, 4, n_heads, dh).float()


def slstm_init(bsz: int, n_heads: int, dh: int, device) -> tuple:
    """The state without a cache: c = m = h = 0, n = 1."""
    zeros = torch.zeros((bsz, n_heads, dh), dtype=torch.float32,
                        device=device)
    return (zeros, torch.ones_like(zeros), zeros, zeros)


def slstm_scan(pres, rs, carries) -> list:
    """Several sets of heads' recurrences advanced together, one host loop
    over T (each set's step at ``t`` before any set's at ``t + 1``): set
    ``k`` its pre-activations ``pres[k] [B, T, 4, h, dh]``, its ``r``
    rows ``rs[k] [h, dh, 4 dh]`` and its state ``carries[k]``. Returns each
    set's ``(h [B, T, h, dh] f32, final (c, n, m, h))``."""
    steps = [_slstm_step(r.float(), r.shape[0], r.shape[1]) for r in rs]
    carries, hs = list(carries), [[] for _ in pres]
    for i in range(pres[0].shape[1]):
        for k, (step, pre) in enumerate(zip(steps, pres)):
            carries[k] = step(carries[k], pre[:, i])
            hs[k].append(carries[k][3])
    return [(torch.stack(h, 1), c) for h, c in zip(hs, carries)]


def slstm_forward(p: Params, x: torch.Tensor, n_heads: int,
                  cache: Optional[tuple] = None):
    """x: [B,T,d] -> (y, final (c, n, m, h)). Without a cache the state
    starts at c = m = h = 0, n = 1."""
    b, t, _ = x.shape
    d_inner, dh = _cell_dims(x.shape[-1], n_heads)
    pre = slstm_pre(x, p["w_in"], p["b"], n_heads, dh)
    carry = (slstm_init(b, n_heads, dh, x.device) if cache is None
             else tuple(cache))
    [(h, carry)] = slstm_scan([pre], [p["r"]], [carry])
    y = h.reshape(b, t, d_inner).to(x.dtype)
    return y @ p["w_out"], carry


# ------------------------------------------------------------------- mLSTM
def _mlstm_proj(p: Params, x: torch.Tensor, n_heads: int, dh: int):
    """q, k, v, the gates and o of the ``n_heads`` heads whose ``w_qkv``
    (``(3, h, dh)``), ``w_if`` (``(2, h)``) and ``w_o`` columns ``p``
    holds."""
    b, t, _ = x.shape
    qkv = (x @ p["w_qkv"]).reshape(b, t, 3, n_heads, dh)
    gif = (x @ p["w_if"]).reshape(b, t, 2, n_heads).float()
    o = torch.sigmoid(x @ p["w_o"]).reshape(b, t, n_heads, dh)
    q = qkv[:, :, 0].float()
    k = qkv[:, :, 1].float() * (dh ** -0.5)
    v = qkv[:, :, 2].float()
    logi = gif[:, :, 0]                      # input gate pre-act (exp gate)
    logf = F.logsigmoid(gif[:, :, 1])        # forget gate in log space
    return q, k, v, logi, logf, o


def mlstm_forward(p: Params, x: torch.Tensor, n_heads: int,
                  cache: Optional[tuple] = None):
    """Chunked-parallel mLSTM. x: [B,T,d] -> (y, (C, n, m)), m zeros (the
    chunked form is unstabilized-exact; the decode step re-stabilizes from
    m = 0)."""
    _, dh = _cell_dims(x.shape[-1], n_heads)
    y, state = mlstm_heads(p, x, n_heads, dh, cache)
    return y @ p["w_out"], state


def mlstm_heads(p: Params, x: torch.Tensor, n_heads: int, dh: int,
                cache: Optional[tuple] = None):
    """The mLSTM between its projections on the ``n_heads`` heads whose
    ``w_qkv`` / ``w_if`` / ``w_o`` columns ``p`` holds (:func:`_mlstm_proj`):
    (the gated output ``[B, T, h dh]`` in ``x``'s dtype, (C, n, m)). Heads
    do not mix."""
    b, t, _ = x.shape
    q, k, v, logi, logf, o = _mlstm_proj(p, x, n_heads, dh)

    if cache is None:
        c0 = torch.zeros((b, n_heads, dh, dh), dtype=torch.float32,
                         device=x.device)
        n0 = torch.zeros((b, n_heads, dh), dtype=torch.float32,
                         device=x.device)
    else:
        c0, n0, m0 = cache
        # the unstabilized state is exp(m) times the stabilized one
        c0 = c0 * torch.exp(m0)[..., None, None]
        n0 = n0 * torch.exp(m0)[..., None]

    qn = CHUNK_M if (t % CHUNK_M == 0 and t >= CHUNK_M) else t
    nc = t // qn

    def chunked(a):
        return a.reshape(b, nc, qn, *a.shape[2:])

    qc, kc, vc = map(chunked, (q, k, v))
    lic, lfc = map(chunked, (logi, logf))

    csum = torch.cumsum(lfc, dim=2)                   # [B,nc,Q,H]
    total = csum[:, :, -1, :]                         # [B,nc,H]

    # intra-chunk: w_ab = exp(b_a - b_b + logi_b) for b <= a; the mask goes
    # on BEFORE the exp
    rel = (csum[:, :, :, None, :] - csum[:, :, None, :, :]
           + lic[:, :, None, :, :])
    causal = torch.ones((qn, qn), dtype=torch.bool, device=x.device).tril()
    rel = rel.masked_fill(~causal[None, None, :, :, None], -torch.inf)
    w = torch.exp(rel)
    qk = torch.einsum("zcahd,zcbhd->zcabh", qc, kc)   # [B,nc,Qa,Qb,H]
    scores = qk * w
    y_intra = torch.einsum("zcabh,zcbhd->zcahd", scores, vc)
    den_intra = torch.sum(scores, dim=3)              # [B,nc,Qa,H]

    # chunk state contributions
    wst = torch.exp(total[:, :, None, :] - csum + lic)  # [B,nc,Q,H]
    cc = torch.einsum("bcqhv,bcqhk->bchvk", vc * wst[..., None], kc)
    ncq = torch.einsum("bcqh,bcqhk->bchk", wst, kc)

    cs, ns = c0, n0
    c_prevs, n_prevs = [], []
    for c in range(nc):
        c_prevs.append(cs)
        n_prevs.append(ns)
        decay = torch.exp(total[:, c])[..., None, None]
        cs = cs * decay + cc[:, c]
        ns = ns * decay[..., 0] + ncq[:, c]
    c_prevs = torch.stack(c_prevs, 1)                 # [B,nc,H,dh,dh]
    n_prevs = torch.stack(n_prevs, 1)                 # [B,nc,H,dh]

    eb = torch.exp(csum)[..., None]                   # [B,nc,Q,H,1]
    y_inter = torch.einsum("bcqhk,bchvk->bcqhv", eb * qc, c_prevs)
    den_inter = torch.einsum("bcqhk,bchk->bcqh", eb * qc, n_prevs)

    den = floor_at(torch.abs(den_intra + den_inter), 1.0)
    h = (y_intra + y_inter) / den[..., None]
    h = h.reshape(b, t, n_heads, dh)
    y = (o.float() * h).reshape(b, t, n_heads * dh).to(x.dtype)
    m_f = torch.zeros((b, n_heads), dtype=torch.float32, device=x.device)
    return y, (cs, ns, m_f)


def mlstm_decode_step(p: Params, x: torch.Tensor, cache: tuple,
                      n_heads: int):
    """O(1) stabilized recurrent step. x: [B,1,d] -> (y, (C, n, m))."""
    _, dh = _cell_dims(x.shape[-1], n_heads)
    y, state = mlstm_decode_heads(p, x, cache, n_heads, dh)
    return y @ p["w_out"], state


def mlstm_decode_heads(p: Params, x: torch.Tensor, cache: tuple,
                       n_heads: int, dh: int):
    """The step between the projections on the ``n_heads`` heads whose
    ``w_qkv`` / ``w_if`` / ``w_o`` columns ``p`` holds and whose state
    ``cache`` is: (the gated output ``[B, 1, h dh]``, (C, n, m))."""
    b = x.shape[0]
    q, k, v, logi, logf, o = _mlstm_proj(p, x, n_heads, dh)
    c, n, m = cache
    it, ft = logi[:, 0], logf[:, 0]                   # [B,H]
    m_new = torch.maximum(ft + m, it)
    i_g = torch.exp(it - m_new)[..., None]
    f_g = torch.exp(ft + m - m_new)[..., None]
    q0, k0, v0 = q[:, 0], k[:, 0], v[:, 0]
    c_new = f_g[..., None] * c + i_g[..., None] * (v0[..., :, None]
                                                   * k0[..., None, :])
    n_new = f_g * n + i_g * k0
    num = torch.einsum("bhvk,bhk->bhv", c_new, q0)
    # h = Cq / max(|n.q|, 1) in unstabilized terms == stabilized with exp(-m)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n_new, q0)),
                        torch.exp(-m_new))
    h = num / den[..., None]
    y = (o[:, 0].float() * h).reshape(b, 1, n_heads * dh).to(x.dtype)
    return y, (c_new, n_new, m_new)
