"""Sparsity-rate schedules: paper Eq. 1 (hierarchical) and Eq. 2
(time-varying) — port of ``repro.core.schedules``. Host-side Python."""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core.types import THGSConfig, quantize_k


def layer_rates(cfg: THGSConfig, n_layers: int) -> list[float]:
    """Eq. 1: s_1 = s0; s_i = max(s_{i-1} * alpha, s_min), in leaf order."""
    rates: list[float] = []
    for i in range(n_layers):
        if i == 0:
            rates.append(cfg.s0)
            continue
        s_next = rates[-1] * cfg.alpha
        rates.append(s_next if s_next > cfg.s_min else cfg.s_min)
    return rates


def round_rate(
    cfg: THGSConfig,
    base_rate: float,
    t: int,
    total_rounds: int,
    loss_prev: float | None,
    loss_curr: float | None,
) -> float:
    """Eq. 2: R <- (alpha + beta - t/T) * R, clamped to [r_min, 1].

    beta = (loss_prev - loss_curr) / |loss_curr| (Alg. 2 line 8), clipped to
    [-1, 1]; 0 without loss history.
    """
    if not cfg.time_varying:
        return base_rate
    if loss_prev is None or loss_curr is None or abs(loss_curr) < 1e-12:
        beta = 0.0
    else:
        beta = (loss_prev - loss_curr) / abs(loss_curr)
        beta = max(-1.0, min(1.0, beta))
    factor = cfg.alpha_t + beta - (t / max(total_rounds, 1))
    r = base_rate * factor
    return max(cfg.r_min, min(1.0, r))


def leaf_ks(
    cfg: THGSConfig,
    leaf_sizes: Sequence[int],
    t: int = 0,
    total_rounds: int = 1,
    loss_prev: float | None = None,
    loss_curr: float | None = None,
) -> list[int]:
    """Per-leaf top-k counts for round ``t`` (hierarchical x time-varying)."""
    per_layer = layer_rates(cfg, len(leaf_sizes))
    ks = []
    for size, s in zip(leaf_sizes, per_layer):
        r = round_rate(cfg, s, t, total_rounds, loss_prev, loss_curr)
        k = max(1, int(math.ceil(size * r)))
        ks.append(quantize_k(k, size, cfg.k_levels))
    return ks
