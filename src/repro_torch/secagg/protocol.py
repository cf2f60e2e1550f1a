"""The Bonawitz-style secure-aggregation round protocol (paper Alg. 2) —
port of ``repro.secagg.protocol``.

Phases: 0 advertise DH keys; 1 Shamir-share the private keys (threshold
``t = sa.t_for(C)``); 2 hand the per-pair counter seeds to the batched encode;
3 for each dropped client, reconstruct its key from ``t`` survivors' shares,
re-derive the survivor<->dropped seeds and cancel the unpaired masks. Fewer
than ``t`` survivors raises :class:`ThresholdError`.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import masks
from repro_torch.core.types import SecureAggConfig
from repro_torch.secagg import shamir


class ThresholdError(RuntimeError):
    """Survivors fell below the Shamir threshold — the round cannot unmask."""


@dataclasses.dataclass(frozen=True)
class RoundProtocol:
    """One round's key agreement + secret sharing + recovery state."""

    sa: SecureAggConfig
    participants: tuple
    round_t: int
    t: int
    publics: Mapping[int, int]
    shares: Mapping[int, Mapping[int, int]]
    privs: Mapping[int, int]

    @classmethod
    def setup(cls, sa: SecureAggConfig, participants: Sequence[int],
              round_t: int) -> "RoundProtocol":
        """Phases 0-1: advertise key pairs, Shamir-share the private keys."""
        parts = tuple(sorted(int(c) for c in participants))
        if len(set(parts)) != len(parts):
            raise ValueError(f"duplicate participant ids: {parts}")
        if len(parts) < 2:
            raise ValueError("secure aggregation needs >= 2 participants")
        t = sa.t_for(len(parts))
        publics, shares, privs = {}, {}, {}
        points = [u + 1 for u in parts]
        for u in parts:
            x_u = masks.dh_private(sa.seed, u)
            privs[u] = x_u
            publics[u] = masks.dh_public(x_u)
            shares[u] = shamir.share(
                x_u, points, t, tag=f"{sa.seed}:{u}:{round_t}")
        return cls(sa=sa, participants=parts, round_t=round_t, t=t,
                   publics=publics, shares=shares, privs=privs)

    def pair_seed_matrix(self):
        """Phase 2 inputs: ``(seeds int64[C, C] of uint32 values, signs
        f32[C, C])`` from this protocol's key state."""
        parts = self.participants
        return masks.seed_matrix_from_keys(
            parts, [self.privs[u] for u in parts],
            [self.publics[u] for u in parts], self.round_t)

    def recover_seeds(self, survivors: Sequence[int],
                      dropped: Sequence[int]) -> torch.Tensor:
        """Phase 3: reconstruct dropped clients' keys, re-derive pair seeds.

        Returns an int64 [C, C] matrix of uint32 seeds filled only at
        survivor<->dropped entries. Raises :class:`ThresholdError` below
        ``t`` survivors, ValueError on a key that fails its public-key check.
        """
        surv = sorted(int(c) for c in survivors)
        drop = sorted(int(c) for c in dropped)
        known = set(self.participants)
        if not set(surv) <= known or not set(drop) <= known:
            raise ValueError("survivors/dropped must be round participants")
        if set(surv) & set(drop):
            raise ValueError("a client cannot both survive and drop")
        if len(surv) < self.t:
            raise ThresholdError(
                f"{len(surv)} survivors < threshold t={self.t}: "
                "the dropped clients' masks cannot be reconstructed")
        pos = {u: i for i, u in enumerate(self.participants)}
        C = len(self.participants)
        seeds = np.zeros((C, C), np.int64)
        for d in drop:
            # exactly t survivors' shares (costs.recovery_upload_bits)
            pts = {v + 1: self.shares[d][v + 1] for v in surv[:self.t]}
            x_d = shamir.reconstruct(pts)
            if masks.dh_public(x_d) != self.publics[d]:
                raise ValueError(
                    f"reconstructed key of client {d} fails the public-key "
                    "check — corrupted share?")
            for s in surv:
                secret = pow(self.publics[s], x_d, masks.DH_PRIME)
                sd = masks.seed_from_secret(secret, self.round_t)
                seeds[pos[s], pos[d]] = sd
                seeds[pos[d], pos[s]] = sd
        return torch.from_numpy(seeds)

    # ------------------------------------------------------------ accounting
    @property
    def n_phase1_shares(self) -> int:
        """Shares crossing the wire in phase 1 (self-share stays local)."""
        C = len(self.participants)
        return C * (C - 1)

    def n_recovery_shares(self, n_dropped: int) -> int:
        """Shares uploaded by survivors to unmask ``n_dropped`` clients."""
        return self.t * n_dropped
