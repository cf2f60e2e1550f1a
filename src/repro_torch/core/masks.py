"""Pairwise-mask key agreement and pair seeds (paper §3.2) — port of the
control-plane part of ``repro.core.masks``.

Clients a<b agree through a toy-parameter Diffie-Hellman exchange over
GF(2^61-1) on a pair secret; each round both derive the same uint32 counter
seed from it, which drives the counter-based mask streams
(``kernels/ops.pair_mask_streams``). Host-side Python integers throughout.
"""
from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.types import SecureAggConfig

# toy-parameter DH group (not a secure choice; the arithmetic is real)
DH_PRIME = (1 << 61) - 1   # Mersenne prime; also the Shamir field (secagg)
DH_GEN = 5


def dh_private(seed: int, u: int) -> int:
    """Client ``u``'s simulated DH private key in [1, DH_PRIME - 1)."""
    h = hashlib.sha256(f"dhpriv:{seed}:{u}".encode()).digest()
    return int.from_bytes(h[:16], "little") % (DH_PRIME - 2) + 1


def dh_public(x: int) -> int:
    """g^x mod p — the advertised public key."""
    return pow(DH_GEN, x, DH_PRIME)


def dh_agree(seed: int, a: int, b: int) -> int:
    """Shared pair secret g^(x_a x_b), computed from a's side."""
    return pow(dh_public(dh_private(seed, b)), dh_private(seed, a), DH_PRIME)


def seed_from_secret(secret: int, round_t: int) -> int:
    """Per-round uint32 mask seed from a pair secret."""
    h = hashlib.sha256(f"mask:{secret}:{round_t}".encode()).digest()
    return int.from_bytes(h[:4], "little")


def pair_seed(cfg: SecureAggConfig, a: int, b: int, round_t: int) -> int:
    """The round's uint32 counter seed for the unordered pair (a, b)."""
    return seed_from_secret(dh_agree(cfg.seed, a, b), round_t)


def seed_matrix_from_keys(ids: Sequence[int], privs: Sequence[int],
                          pubs: Sequence[int], round_t: int):
    """[C, C] pair seeds + Bonawitz signs from ordered key lists.

    ``seeds[i, j] = seed_from_secret(pubs[j] ** privs[i] mod p, round_t)``,
    symmetric, filled once per unordered pair; the diagonal (self pair) is
    seed 0 with sign 0. Returns ``(seeds int64[C, C] holding uint32 values,
    signs f32[C, C])`` on the CPU.
    """
    n = len(ids)
    if not (len(privs) == len(pubs) == n):
        raise ValueError("ids, privs, pubs must be aligned")
    seeds = np.zeros((n, n), np.int64)
    signs = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(i + 1, n):
            secret = pow(pubs[j], privs[i], DH_PRIME)
            sd = seed_from_secret(secret, round_t)
            seeds[i, j] = seeds[j, i] = sd
            sgn = 1.0 if ids[i] < ids[j] else -1.0
            signs[i, j] = sgn
            signs[j, i] = -sgn
    return torch.from_numpy(seeds), torch.from_numpy(signs)
