"""Pairwise encryption masks with sparse support (paper §3.2, Eq. 3-5) —
port of ``repro.core.masks``.

Clients a<b agree through a toy-parameter Diffie-Hellman exchange over
GF(2^61-1) on a pair secret; each round both derive the same uint32 counter
seed from it, which drives the counter-based mask streams
(``kernels/ops.pair_mask_streams``). The key agreement is host-side Python
integers throughout.

:func:`pair_mask` and :func:`client_masks` are the *single-pair reference*:
one pair's sparse mask (``k_mask`` index/value slots, the leaf id folded into
the seed, the Bonawitz sign by id order) drawn by one flat per-pair launch
on the card or by its plain version on the CPU, bit-exact against the
reference's draws. The production data plane draws every pair of every
client in one launch (``streams.mask_streams_round``).

:func:`pair_key` is the legacy ``jax.random`` pair key (dense Bonawitz
baseline, the keyed mask path), drawn with the port of threefry
(``core/threefry.py``).
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.types import SecureAggConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

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


def pair_key(cfg: SecureAggConfig, a: int, b: int,
             round_t: int) -> torch.Tensor:
    """Legacy ``jax.random`` pair key of ``(a, b)`` for a round (the dense
    Bonawitz baseline and the keyed mask path): ``fold_in(key(secret mod
    (2**31 - 1)), round_t)``, the same from both ends; int64 ``[2]`` on the
    CPU."""
    secret = dh_agree(cfg.seed, a, b)
    return threefry.fold_in(threefry.key(secret % (2 ** 31 - 1)), round_t)


class PairMask(NamedTuple):
    """One pair's sparse mask: ``k_mask`` (index, signed value) slots.

    ``indices`` are flat positions and MAY repeat (mod-size collisions of
    the counter stream): both endpoints draw identical duplicates, so each
    slot cancels against its twin, and the unified-stream encode transmits
    the gradient value only at a position's first occurrence.
    """

    indices: torch.Tensor  # int32[k_mask] support positions (may repeat)
    values: torch.Tensor   # f32[k_mask] signed mask values in +-[p, p+q)


def pair_mask(cfg: SecureAggConfig, a: int, b: int, round_t: int,
              leaf_id: int, size: int, k_mask: int, *,
              device="cuda") -> PairMask:
    """Mask of client ``a`` towards client ``b`` for one leaf, one round,
    on ``device``.

    Deterministic in (unordered pair, round, leaf): both endpoints draw the
    same (indices, |values|); the endpoint with the smaller id adds +values,
    the other -values, so the sums cancel.
    """
    dev = torch.device(device)
    seed = kref.fold_leaf_seed(
        torch.tensor([pair_seed(cfg, a, b, round_t)], dtype=torch.int64,
                     device=dev), leaf_id)
    sign = torch.tensor([1.0 if a < b else -1.0], dtype=torch.float32,
                        device=dev)
    idx, vals = ops.pair_mask_streams(seed, sign, nb=1, k_mask=k_mask,
                                      m=size, p=cfg.p, q=cfg.q)
    return PairMask(indices=idx[0, 0], values=vals[0, 0])


def client_masks(cfg: SecureAggConfig, client: int, others: Sequence[int],
                 round_t: int, leaf_id: int, size: int, k_mask: int, *,
                 device="cuda") -> PairMask:
    """Concatenated masks of ``client`` towards every other participant,
    one :func:`pair_mask` (one launch on the card) a peer, in ``others``'
    order."""
    parts = [pair_mask(cfg, client, b, round_t, leaf_id, size, k_mask,
                       device=device)
             for b in others if b != client]
    if not parts:
        z = torch.zeros((0,), dtype=torch.int32, device=device)
        return PairMask(indices=z, values=torch.zeros(
            (0,), dtype=torch.float32, device=device))
    return PairMask(indices=torch.cat([p.indices for p in parts]),
                    values=torch.cat([p.values for p in parts]))
