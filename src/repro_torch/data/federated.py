"""Federated data partitioning (paper §5 experimental protocol) — numpy copy
of ``repro.data.federated``.

Two non-IID schemes:
  * ``noniid_label_k`` — the paper's Non-IID-n: each client holds samples from
    exactly n of the 10 label classes (sample-allocation-matrix construction).
  * ``dirichlet`` — the standard Dir(alpha) partition for sensitivity studies.
Plus ``iid`` uniform shuffling. All return {client_id: index array}.
"""
from __future__ import annotations

import numpy as np


def iid(y: np.ndarray, n_clients: int, *, seed: int = 0) -> dict[int, np.ndarray]:
    rs = np.random.RandomState(seed)
    idx = rs.permutation(len(y))
    return {c: np.sort(part) for c, part in
            enumerate(np.array_split(idx, n_clients))}


def noniid_label_k(y: np.ndarray, n_clients: int, k: int, *,
                   seed: int = 0) -> dict[int, np.ndarray]:
    """Paper's Non-IID-k: every client sees exactly k distinct labels.

    Each class's samples are split into shards; each client draws shards from k
    classes assigned round-robin so all classes stay covered.
    """
    rs = np.random.RandomState(seed)
    classes = np.unique(y)
    n_classes = len(classes)
    assert 1 <= k <= n_classes
    # class list per client, round-robin offset so coverage is balanced
    client_classes = [
        [classes[(c + j) % n_classes] for j in range(k)] for c in range(n_clients)
    ]
    # shard each class among the clients that want it
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


def dirichlet(y: np.ndarray, n_clients: int, alpha: float = 0.5, *,
              seed: int = 0) -> dict[int, np.ndarray]:
    rs = np.random.RandomState(seed)
    out = {c: [] for c in range(n_clients)}
    for cls in np.unique(y):
        idx = np.where(y == cls)[0]
        rs.shuffle(idx)
        props = rs.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for c, part in enumerate(np.split(idx, cuts)):
            out[c].append(part)
    return {c: np.sort(np.concatenate(parts)) for c, parts in out.items()}


def client_batches(x: np.ndarray, y: np.ndarray, idx: np.ndarray,
                   batch: int, steps: int, *, seed: int = 0):
    """Stacked [steps, batch, ...] arrays for one client's local round."""
    rs = np.random.RandomState(seed)
    take = rs.choice(idx, size=steps * batch, replace=len(idx) < steps * batch)
    xb = x[take].reshape(steps, batch, *x.shape[1:])
    yb = y[take].reshape(steps, batch)
    return xb, yb
