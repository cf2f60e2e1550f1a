"""Frozen copy of the sparse pair masks' key agreement and counter streams
(``repro_torch/core/masks.py``, ``repro_torch/kernels/ref.py``: paper §3.2,
Eq. 3-5), in numpy uint32 arithmetic.

Clients agree on a pair secret through a toy-parameter Diffie-Hellman
exchange over GF(2^61 - 1); each round both ends derive the same uint32
counter seed from it; a leaf's id is folded into the seed; the seed drives
two murmur streams, one for the mask's support and one for its magnitudes.
A client's slots towards itself carry no mask and point at a position its
top-k already holds, so its support is its top-k and its masks towards each
peer.
"""
from __future__ import annotations

import hashlib

import numpy as np

DH_PRIME = (1 << 61) - 1
DH_GEN = 5
IDX_SALT = 0x9E3779B9
VAL_SALT = 0x85EBCA6B
LEAF_SALT = 0xA511E9B3


def dh_private(seed: int, u: int) -> int:
    h = hashlib.sha256(f"dhpriv:{seed}:{u}".encode()).digest()
    return int.from_bytes(h[:16], "little") % (DH_PRIME - 2) + 1


def dh_public(x: int) -> int:
    return pow(DH_GEN, x, DH_PRIME)


def seed_from_secret(secret: int, round_t: int) -> int:
    h = hashlib.sha256(f"mask:{secret}:{round_t}".encode()).digest()
    return int.from_bytes(h[:4], "little")


def seed_matrix(sa_seed: int, ids, round_t: int):
    """[C, C] pair seeds (uint32) and Bonawitz signs (+1 for the smaller id)."""
    ids = [int(u) for u in ids]
    n = len(ids)
    privs = [dh_private(sa_seed, u) for u in ids]
    pubs = [dh_public(x) for x in privs]
    seeds = np.zeros((n, n), np.uint32)
    signs = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(i + 1, n):
            sd = seed_from_secret(pow(pubs[j], privs[i], DH_PRIME), round_t)
            seeds[i, j] = seeds[j, i] = sd
            sgn = 1.0 if ids[i] < ids[j] else -1.0
            signs[i, j], signs[j, i] = sgn, -sgn
    return seeds, signs


def mix32(x: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit avalanche, uint32 lanes."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        x = x ^ (x >> np.uint32(16))
    return x


def fold_leaf_seed(seeds: np.ndarray, leaf_id: int) -> np.ndarray:
    leaf = mix32(np.uint32((int(leaf_id) + LEAF_SALT) & 0xFFFFFFFF))
    return mix32(np.asarray(seeds, np.uint32) ^ leaf)


def pair_stream(seed: int, k_mask: int, m: int, *, p: float, q: float):
    """One pair's ``k_mask`` support positions in ``[0, m)`` and unsigned
    magnitudes ``p + q * u`` (u on the 2^-24 grid)."""
    c = np.arange(k_mask, dtype=np.uint32)
    with np.errstate(over="ignore"):
        base_i = mix32(np.uint32(seed) ^ np.uint32(IDX_SALT))
        base_v = mix32(np.uint32(seed) ^ np.uint32(VAL_SALT))
        idx = mix32(base_i + c) % np.uint32(m)
        u = (mix32(base_v + c) >> np.uint32(8)).astype(np.float32) / np.float32(
            2 ** 24)
    return idx.astype(np.int64), (np.float32(p) + np.float32(q) * u)


def client_mask_support(seeds: np.ndarray, leaf_id: int, i: int,
                        k_mask: int, m: int, *, p: float, q: float) -> np.ndarray:
    """Every position of client ``i``'s mask slots of one leaf, towards each
    peer ``j != i``."""
    folded = fold_leaf_seed(seeds[i], leaf_id)
    return np.concatenate([pair_stream(int(s), k_mask, m, p=p, q=q)[0]
                           for j, s in enumerate(folded) if j != i])
