"""Mixture-of-Experts layer: shared + routed experts, sort-based capacity
dispatch (port of ``repro.models.moe``).

Token-choice top-k routing (DeepSeek-MoE / Llama-4 style). Within each
dispatch group (a row of the batch) the token -> expert assignments are
sorted by expert (a stable sort), each assignment's position inside its
expert's segment comes from ``searchsorted``, and assignments past the
static capacity are dropped. Expert weights carry a leading E axis; the
expert products are batched matrix products.

Order and bits, as in the reference:

* the router's top-k keeps ``lax.top_k``'s tie order (the lower expert id
  first), through a stable descending sort;
* a slot of the dispatch buffer holds one assignment (slots are unique), so
  the dispatch is a plain indexed write;
* the combine folds each token's ``top_k`` contributions in the reference's
  slot order (ascending expert id), in the model dtype, starting at +0.0.
  No float atomics: CUDA's accumulating scatters would add them in an order
  that changes from run to run (ROADMAP Queue 3).

The dispatch takes an expert span, and the router, the expert products and
the fold are functions of their own, so that ``launch/tp.py`` can run a
model position's own experts on the whole rows and fold the exchanged
contributions with the same bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoESpec
from repro_torch.models.layers import (Params, dense_init, floor_at,
                                       stacked_dense_init)


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor  # load-balance auxiliary loss (Switch-style)


def init_moe(generator: Optional[torch.Generator], d: int, spec: MoESpec,
             act: str, dtype, device) -> nn.ParameterDict:
    """The router in f32 and the experts ``[E, d_in, d_out]`` in ``dtype``.
    The reference broadcasts one drawn matrix to all E experts; the port
    draws each expert on its own at the same scale, so a token sent to the
    wrong expert shows."""
    e, f = spec.n_experts, spec.d_ff_expert
    p = {
        "router": dense_init(generator, d, e, torch.float32, device),
        "wi_gate": stacked_dense_init(generator, e, d, f, dtype, device),
        "wi_up": stacked_dense_init(generator, e, d, f, dtype, device),
        "wo": stacked_dense_init(generator, e, f, d, dtype, device),
    }
    if spec.n_shared:
        fs = spec.n_shared * f
        p["shared_wi_gate"] = dense_init(generator, d, fs, dtype, device)
        p["shared_wi_up"] = dense_init(generator, d, fs, dtype, device)
        p["shared_wo"] = dense_init(generator, fs, d, dtype, device)
    return nn.ParameterDict(p)


def capacity(n_tokens: int, spec: MoESpec) -> int:
    """Slots an expert holds in a group of ``n_tokens``: rounded up to 8 (as
    the reference rounds, which sets which tokens drop)."""
    c = int(math.ceil(n_tokens * spec.top_k / spec.n_experts
                      * spec.capacity_factor))
    return max(8, -(-c // 8) * 8)


def route(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    index. Returns (values, int64 indices)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    eidx = order[..., :k]
    return probs.gather(-1, eidx), eidx


def _dispatch(x: torch.Tensor, eidx: torch.Tensor, e: int, k: int, cap: int,
              span: Optional[tuple] = None):
    """Every group's sort-based dispatch at once. x ``[G, t, d]``, eidx
    ``[G, t, k]`` -> (buf ``[G, n, cap, d]``, slot ``[G, t*k]`` in sorted
    order with ``n * cap`` marking an assignment the buffer does not hold,
    order). ``span`` ``(lo, hi)``: fill only experts ``[lo, hi)`` (``n =
    hi - lo``; default all E). An assignment's place in its expert's
    segment comes from the whole group's sorted order either way, so the
    capacity drops are the same for every span."""
    g, t, d = x.shape
    lo, hi = (0, e) if span is None else span
    flat_e = eidx.reshape(g, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    stok = order // k                                  # the assignment's token
    arange_e = torch.arange(e, device=x.device).expand(g, e).contiguous()
    seg_start = torch.searchsorted(se, arange_e)
    pos = torch.arange(t * k, device=x.device) - seg_start.gather(1, se)
    n = hi - lo
    keep = pos < cap
    if span is not None:
        keep = keep & (se >= lo) & (se < hi)
    slot = torch.where(keep, (se - lo) * cap + pos, n * cap)  # overflow slot
    buf = x.new_zeros((g, n * cap + 1, d))
    rows = torch.arange(g, device=x.device)[:, None]
    buf[rows, slot] = x[rows, stok]
    return buf[:, :-1].reshape(g, n, cap, d), slot, order


def _ranked(slot: torch.Tensor, order: torch.Tensor, eidx: torch.Tensor,
            gate_vals: torch.Tensor):
    """Each token's slots and gates in (token, rank) order, its experts
    ascending: (slots ``[G, t, k]``, gates ``[G, t, k]``, the ranks' order
    ``by_e``)."""
    g, t, k = eidx.shape
    slot_u = torch.empty_like(slot).scatter_(1, order, slot).view(g, t, k)
    by_e = torch.argsort(eidx, dim=-1, stable=True)
    return slot_u.gather(2, by_e), gate_vals.gather(2, by_e), by_e


def _gated(flat: torch.Tensor, sj: torch.Tensor, gj: torch.Tensor,
           dtype) -> torch.Tensor:
    """``gate * y_expert`` ``[G, t, d]`` of one rank (f32, cast to
    ``dtype``): +0.0 where ``flat`` ``[G, n, d]`` holds no slot ``sj``."""
    g, t = sj.shape
    n, d = flat.shape[1:]
    got = flat.gather(1, sj.clamp(max=n - 1)[..., None].expand(g, t, d))
    got = torch.where((sj < n)[..., None], got,
                      torch.zeros((), dtype=got.dtype, device=got.device))
    return (gj[..., None] * got).to(dtype)


def _combine(yexp: torch.Tensor, slot: torch.Tensor, order: torch.Tensor,
             eidx: torch.Tensor, gate_vals: torch.Tensor, e: int, cap: int,
             dtype) -> torch.Tensor:
    """y ``[G, t, d]``: each token's kept contributions ``gate * y_expert``
    (f32, cast to ``dtype``), folded in ascending expert id from +0.0."""
    g, t, k = eidx.shape
    d = yexp.shape[-1]
    flat = yexp.reshape(g, e * cap, d)
    slot_u, gate_u, _ = _ranked(slot, order, eidx, gate_vals)
    return fold_ranks(_gated(flat, slot_u[:, :, j], gate_u[:, :, j], dtype)
                      for j in range(k))


def fold_ranks(contribs) -> torch.Tensor:
    """A token's ``top_k`` contributions (ascending expert id, an iterable:
    made one at a time) added in that order from +0.0, in their dtype."""
    y = None
    for c in contribs:
        y = (torch.zeros_like(c) if y is None else y) + c
    return y


def router(p: Params, x: torch.Tensor, spec: MoESpec):
    """The router on whole rows x ``[B, T, d]``: (probs ``[B, T, E]`` f32,
    normalised gates ``[B, T, k]``, expert ids ``[B, T, k]``)."""
    logits = x.float() @ p["router"]                          # [B, T, E]
    probs = torch.softmax(logits, -1)
    gate_vals, eidx = route(probs, spec.top_k)                # [B, T, k]
    gate_vals = gate_vals / floor_at(gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, eidx


def aux_loss(probs: torch.Tensor, eidx: torch.Tensor,
             spec: MoESpec) -> torch.Tensor:
    """The load-balance aux loss (mean prob * fraction routed,
    Switch-style) of whole rows."""
    b, t, k = eidx.shape
    e = spec.n_experts
    me = probs.mean((0, 1))                                   # [E]
    # the routed count per expert as an integer scatter (``bincount`` has
    # no meta-device kernel, and the dry run traces this layer there)
    flat_e = eidx.reshape(-1)
    ce = torch.zeros(e, dtype=torch.int64, device=eidx.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e)).float() / (b * t * k)
    return spec.router_aux_weight * e * torch.sum(me * ce)


def experts(buf: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
            wo: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLU on their slots: buf ``[G, n, cap, d]``,
    weights ``[n, ...]`` -> ``[G, n, cap, d]``."""
    h = torch.einsum("gecd,edf->gecf", buf, wi_gate)
    h = F.silu(h) * torch.einsum("gecd,edf->gecf", buf, wi_up)
    return torch.einsum("gecf,efd->gecd", h, wo)


def apply_moe(p: Params, x: torch.Tensor, spec: MoESpec) -> MoEOut:
    """x ``[B, T, d]`` -> ``[B, T, d]``; B is the dispatch-group axis."""
    t = x.shape[1]
    e, k = spec.n_experts, spec.top_k
    probs, gate_vals, eidx = router(p, x, spec)
    aux = aux_loss(probs, eidx, spec)

    cap = capacity(t, spec)
    buf, slot, order = _dispatch(x, eidx, e, k, cap)          # [B,E,cap,d]
    yexp = experts(buf, p["wi_gate"], p["wi_up"], p["wo"])
    y = _combine(yexp, slot, order, eidx, gate_vals, e, cap, x.dtype)

    if "shared_wi_gate" in p:
        y = y + (F.silu(x @ p["shared_wi_gate"])
                 * (x @ p["shared_wi_up"])) @ p["shared_wo"]
    return MoEOut(y=y, aux_loss=aux)
