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
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoESpec
from repro_torch.models.layers import Params, dense_init, stacked_dense_init


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


def _dispatch(x: torch.Tensor, eidx: torch.Tensor, e: int, k: int, cap: int):
    """Every group's sort-based dispatch at once. x ``[G, t, d]``, eidx
    ``[G, t, k]`` -> (buf ``[G, E, cap, d]``, slot ``[G, t*k]`` in sorted
    order with ``e * cap`` marking a dropped assignment, order)."""
    g, t, d = x.shape
    flat_e = eidx.reshape(g, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    stok = order // k                                  # the assignment's token
    arange_e = torch.arange(e, device=x.device).expand(g, e).contiguous()
    seg_start = torch.searchsorted(se, arange_e)
    pos = torch.arange(t * k, device=x.device) - seg_start.gather(1, se)
    slot = torch.where(pos < cap, se * cap + pos, e * cap)   # overflow slot
    buf = x.new_zeros((g, e * cap + 1, d))
    rows = torch.arange(g, device=x.device)[:, None]
    buf[rows, slot] = x[rows, stok]
    return buf[:, :-1].reshape(g, e, cap, d), slot, order


def _combine(yexp: torch.Tensor, slot: torch.Tensor, order: torch.Tensor,
             eidx: torch.Tensor, gate_vals: torch.Tensor, e: int, cap: int,
             dtype) -> torch.Tensor:
    """y ``[G, t, d]``: each token's kept contributions ``gate * y_expert``
    (f32, cast to ``dtype``), folded in ascending expert id from +0.0."""
    g, t, k = eidx.shape
    d = yexp.shape[-1]
    flat = yexp.reshape(g, e * cap, d)
    # back to (token, rank) order, then each token's experts ascending
    slot_u = torch.empty_like(slot).scatter_(1, order, slot).view(g, t, k)
    by_e = torch.argsort(eidx, dim=-1, stable=True)
    slot_u = slot_u.gather(2, by_e)
    gate_u = gate_vals.gather(2, by_e)
    y = torch.zeros((g, t, d), dtype=dtype, device=yexp.device)
    for j in range(k):
        sj = slot_u[:, :, j]
        got = flat.gather(1, sj.clamp(max=e * cap - 1)[..., None]
                          .expand(g, t, d))
        got = torch.where((sj < e * cap)[..., None], got,
                          torch.zeros((), dtype=got.dtype, device=got.device))
        y = y + (gate_u[:, :, j, None] * got).to(dtype)
    return y


def apply_moe(p: Params, x: torch.Tensor, spec: MoESpec) -> MoEOut:
    """x ``[B, T, d]`` -> ``[B, T, d]``; B is the dispatch-group axis."""
    b, t, d = x.shape
    e, k = spec.n_experts, spec.top_k

    logits = x.float() @ p["router"]                          # [B, T, E]
    probs = torch.softmax(logits, -1)
    gate_vals, eidx = route(probs, k)                         # [B, T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance aux loss (mean prob * fraction routed, Switch-style)
    me = probs.mean((0, 1))                                   # [E]
    ce = torch.bincount(eidx.reshape(-1), minlength=e).float() / (b * t * k)
    aux = spec.router_aux_weight * e * torch.sum(me * ce)

    cap = capacity(t, spec)
    buf, slot, order = _dispatch(x, eidx, e, k, cap)          # [B,E,cap,d]
    h = torch.einsum("gecd,edf->gecf", buf, p["wi_gate"])
    h = F.silu(h) * torch.einsum("gecd,edf->gecf", buf, p["wi_up"])
    yexp = torch.einsum("gecf,efd->gecd", h, p["wo"])
    y = _combine(yexp, slot, order, eidx, gate_vals, e, cap, x.dtype)

    if "shared_wi_gate" in p:
        y = y + (F.silu(x @ p["shared_wi_gate"])
                 * (x @ p["shared_wi_up"])) @ p["shared_wo"]
    return MoEOut(y=y, aux_loss=aux)
