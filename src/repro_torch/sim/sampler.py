"""Counter-based client sampling and dropout injection — numpy copy of
``repro.sim.sampler``.

Every draw is keyed by ``(seed, round)`` through a fresh
``numpy.random.Generator`` — there is no sequential RNG state to carry between
rounds. That makes the schedule a pure function of the config: round ``t``'s
cohort is identical whether the run started at round 0 or resumed from a
checkpoint at round ``t - 1``, and two simulations with the same seed replay
the same participation trace (the seeded-determinism contract tested in
tests/test_sim.py).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

# Domain-separation tags so the cohort draw and the dropout draw of the same
# round never consume the same stream.
_COHORT_TAG = 0xC0
_DROPOUT_TAG = 0xD0


class ClientSampler:
    """Deterministic per-round cohort sampler with dropout injection.

    Parameters
    ----------
    n_clients : int
        Total client population.
    cohort : int
        Clients selected every round. The cohort size is *fixed* for the whole
        run: every round stacks exactly ``cohort`` client batches, so every
        round's tensors have one shape.
    mode : {'uniform', 'weighted'}
        ``uniform`` samples without replacement with equal probability;
        ``weighted`` biases selection by ``weights`` (e.g. local data counts),
        still without replacement.
    weights : mapping of int -> float, optional
        Per-client selection weights for ``mode='weighted'``; missing clients
        default to 0 (never sampled). Weights must be non-negative and leave
        at least ``cohort`` clients with positive weight.
    dropout_rate : float
        Per-round probability that each sampled client's upload is lost
        *after* mask agreement. At least one client always survives.
    seed : int
        Root seed; all draws derive from ``(seed, tag, round)``.
    """

    def __init__(
        self,
        n_clients: int,
        cohort: int,
        *,
        mode: str = "uniform",
        weights: Optional[Mapping[int, float]] = None,
        dropout_rate: float = 0.0,
        seed: int = 0,
    ):
        if not 1 <= cohort <= n_clients:
            raise ValueError(f"need 1 <= cohort <= n_clients, "
                             f"got {cohort} vs {n_clients}")
        if mode not in ("uniform", "weighted"):
            raise ValueError(f"unknown sampler mode {mode!r}")
        self.n_clients = n_clients
        self.cohort = cohort
        self.mode = mode
        self.dropout_rate = float(dropout_rate)
        self.seed = int(seed)
        if mode == "weighted":
            w = np.zeros(n_clients, np.float64)
            for c, v in (weights or {}).items():
                if float(v) < 0.0:
                    raise ValueError(
                        f"weighted sampling got negative weight {v!r} for "
                        f"client {c}: weights must be >= 0 (they normalize "
                        "to selection probabilities)")
                w[int(c)] = float(v)
            if (w > 0).sum() < cohort:
                raise ValueError(
                    f"weighted sampling needs >= {cohort} clients with "
                    f"positive weight, got {(w > 0).sum()}")
            self._p = w / w.sum()
        else:
            self._p = None

    def _rng(self, tag: int, round_t: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, tag, round_t])

    def cohort_for(self, round_t: int) -> np.ndarray:
        """The round's participants: sorted int array of exactly ``cohort``
        distinct client ids. Pure in ``(seed, round_t)``."""
        rng = self._rng(_COHORT_TAG, round_t)
        chosen = rng.choice(self.n_clients, size=self.cohort, replace=False,
                            p=self._p)
        return np.sort(chosen.astype(int))

    def dropouts_for(self, round_t: int, cohort: Sequence[int],
                     min_survivors: int = 1) -> list[int]:
        """Which of the round's participants drop after mask agreement.

        Each participant drops independently with ``dropout_rate``; the draw
        is then clamped so at least ``min_survivors`` participants stay alive
        (lowest-id drops are revived first). The default 1 is the FL
        invariant core/fedavg.py asserts; the engine raises it to the Shamir
        threshold ``sa.t_for(cohort)`` when secure aggregation is on, so an
        injected dropout never exceeds what Bonawitz recovery can unmask
        (below t the real protocol aborts the round — secagg/protocol.py).
        The clamp does not perturb the underlying counter-based draw: the
        same (seed, round) always drops the same prefix-clamped set.
        """
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
