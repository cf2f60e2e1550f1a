"""Frozen copies of the paper's bit accounting (``repro_torch/core/costs.py``,
paper §5.2, Eq. 6-8) and of the THGS sparsity schedules
(``repro_torch/core/schedules.py``, Eq. 1-2, with ``core/types.quantize_k``).

The paper counts a sparse element as 96 bits (a 64-bit value and a 32-bit
index) and a dense element as 64 bits. A client's unified stream has ``k``
top-k slots and ``k_mask`` slots towards each of its ``C - 1`` peers.
"""
from __future__ import annotations

import math
from typing import Sequence

PAPER_VALUE_BITS = 64
PAPER_INDEX_BITS = 32


def upload_bits_sparse(ks: Sequence[int], k_masks: Sequence[int],
                       n_pairs: int) -> int:
    """One client's upload of one round (Eq. 6)."""
    return (sum(ks) + n_pairs * sum(k_masks)) * (PAPER_VALUE_BITS
                                                 + PAPER_INDEX_BITS)


def upload_bits_dense(model_size: int) -> int:
    return model_size * PAPER_VALUE_BITS


def round_upload_bits(ks: Sequence[int], k_masks: Sequence[int], *,
                      n_clients: int, n_survivors: int) -> int:
    """The survivors' upload of one sparse round."""
    return n_survivors * upload_bits_sparse(ks, k_masks,
                                            max(n_clients - 1, 0))


def round_dense_bits(model_size: int, n_clients: int) -> int:
    """Dense FedAvg's upload for the same participants."""
    return n_clients * upload_bits_dense(model_size)


# ---------------------------------------------------------------- schedules
def quantize_k(k: int, size: int, levels: int) -> int:
    """Snap k to one of ``levels`` geometric levels of ``size``."""
    if k <= 1:
        return 1
    if k >= size:
        return size
    pos = math.log(k) / math.log(size)
    snapped = round(pos * levels) / levels
    return max(1, min(size, int(round(size ** snapped))))


def layer_rates(thgs: dict, n_layers: int) -> list:
    """Eq. 1: s_1 = s0; s_i = max(s_{i-1} * alpha, s_min), in leaf order."""
    rates: list = []
    for i in range(n_layers):
        if i == 0:
            rates.append(thgs["s0"])
            continue
        s_next = rates[-1] * thgs["alpha"]
        rates.append(s_next if s_next > thgs["s_min"] else thgs["s_min"])
    return rates


def round_rate(thgs: dict, base_rate: float, t: int, total_rounds: int,
               loss_prev, loss_curr) -> float:
    """Eq. 2: R <- (alpha_t + beta - t/T) * R, clamped to [r_min, 1]."""
    if not thgs["time_varying"]:
        return base_rate
    if loss_prev is None or loss_curr is None or abs(loss_curr) < 1e-12:
        beta = 0.0
    else:
        beta = (loss_prev - loss_curr) / abs(loss_curr)
        beta = max(-1.0, min(1.0, beta))
    factor = thgs["alpha_t"] + beta - (t / max(total_rounds, 1))
    return max(thgs["r_min"], min(1.0, base_rate * factor))


def leaf_ks(thgs: dict, leaf_sizes: Sequence[int], t: int, total_rounds: int,
            loss_prev, loss_curr) -> list:
    """Per-leaf top-k counts for round ``t``."""
    ks = []
    for size, s in zip(leaf_sizes, layer_rates(thgs, len(leaf_sizes))):
        r = round_rate(thgs, s, t, total_rounds, loss_prev, loss_curr)
        k = max(1, int(math.ceil(size * r)))
        ks.append(quantize_k(k, size, thgs["k_levels"]))
    return ks


def k_mask_for(size: int, mask_ratio: float, n_clients: int) -> int:
    """Eq. 4: mask slots a pair a leaf."""
    if n_clients < 2:
        return 0
    return max(1, int(size * mask_ratio / n_clients))
