"""Frozen copies of the port's federated partitions and client batching
(``repro_torch/data/federated.py``) and of its counter-based cohort sampler
(``repro_torch/sim/sampler.py::ClientSampler``, uniform mode with dropout).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

_COHORT_TAG = 0xC0
_DROPOUT_TAG = 0xD0


def iid(y: np.ndarray, n_clients: int, *, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    idx = rs.permutation(len(y))
    return {c: np.sort(part) for c, part in
            enumerate(np.array_split(idx, n_clients))}


def noniid_label_k(y: np.ndarray, n_clients: int, k: int, *,
                   seed: int) -> dict:
    """The paper's Non-IID-k: every client sees exactly k distinct labels."""
    rs = np.random.RandomState(seed)
    classes = np.unique(y)
    n_classes = len(classes)
    if not 1 <= k <= n_classes:
        raise ValueError(f"need 1 <= k <= {n_classes}, got {k}")
    client_classes = [
        [classes[(c + j) % n_classes] for j in range(k)]
        for c in range(n_clients)]
    want = {cls: [c for c in range(n_clients) if cls in client_classes[c]]
            for cls in classes}
    out = {c: [] for c in range(n_clients)}
    for cls in classes:
        idx = np.where(y == cls)[0]
        rs.shuffle(idx)
        takers = want[cls]
        if not takers:
            continue
        for taker, part in zip(takers, np.array_split(idx, len(takers))):
            out[taker].append(part)
    return {c: np.sort(np.concatenate(parts)) if parts else np.array([], int)
            for c, parts in out.items()}


def client_batches(x: np.ndarray, y: np.ndarray, idx: np.ndarray,
                   batch: int, steps: int, *, seed: int):
    """Stacked [steps, batch, ...] arrays for one client's local round."""
    rs = np.random.RandomState(seed)
    take = rs.choice(idx, size=steps * batch, replace=len(idx) < steps * batch)
    xb = x[take].reshape(steps, batch, *x.shape[1:])
    yb = y[take].reshape(steps, batch)
    return xb, yb


class ClientSampler:
    """Cohort of ``cohort`` distinct clients a round, uniform, pure in
    ``(seed, round)``; dropouts drawn apart and clamped to ``min_survivors``."""

    def __init__(self, n_clients: int, cohort: int, *,
                 dropout_rate: float = 0.0, seed: int):
        if not 1 <= cohort <= n_clients:
            raise ValueError(f"need 1 <= cohort <= n_clients, "
                             f"got {cohort} vs {n_clients}")
        self.n_clients = n_clients
        self.cohort = cohort
        self.dropout_rate = float(dropout_rate)
        self.seed = int(seed)

    def _rng(self, tag: int, round_t: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, tag, round_t])

    def cohort_for(self, round_t: int) -> np.ndarray:
        rng = self._rng(_COHORT_TAG, round_t)
        chosen = rng.choice(self.n_clients, size=self.cohort, replace=False)
        return np.sort(chosen.astype(int))

    def dropouts_for(self, round_t: int, cohort: Sequence[int],
                     min_survivors: int = 1) -> list:
        if self.dropout_rate <= 0.0:
            return []
        cohort = [int(c) for c in cohort]
        keep = max(1, int(min_survivors))
        rng = self._rng(_DROPOUT_TAG, round_t)
        drop = [c for c, u in zip(cohort, rng.random(len(cohort)))
                if u < self.dropout_rate]
        excess = len(drop) - (len(cohort) - keep)
        if excess > 0:
            drop = drop[excess:]
        return drop
