"""Shamir secret sharing over GF(2^61 - 1) — dropout recovery's control
plane (port of ``repro.secagg.shamir``; host-side Python integers).

Any ``t`` shares reconstruct a client's DH private key exactly; coefficients
come from a sha256 counter stream keyed by the share ``tag`` so runs
reproduce.
"""
from __future__ import annotations

import hashlib
from typing import Mapping, Sequence

from repro_torch.core.masks import DH_PRIME as PRIME


def _coeff(tag: str, j: int) -> int:
    h = hashlib.sha256(f"shamir-coeff:{tag}:{j}".encode()).digest()
    return int.from_bytes(h[:16], "little") % PRIME


def share(secret: int, xs: Sequence[int], t: int, *, tag: str) -> dict:
    """Split ``secret`` into one share per point of ``xs``, threshold ``t``.
    Returns ``{x: poly(x) mod PRIME}``."""
    xs = [int(x) for x in xs]
    if not 1 <= t <= len(xs):
        raise ValueError(f"need 1 <= t <= n shares, got t={t}, n={len(xs)}")
    if len(set(xs)) != len(xs) or any(x % PRIME == 0 for x in xs):
        raise ValueError("share points must be distinct and nonzero mod PRIME")
    coeffs = [secret % PRIME] + [_coeff(tag, j) for j in range(1, t)]
    out = {}
    for x in xs:
        acc = 0
        for c in reversed(coeffs):   # Horner
            acc = (acc * x + c) % PRIME
        out[x] = acc
    return out


def reconstruct(shares: Mapping[int, int]) -> int:
    """Lagrange interpolation at 0 over ``t`` (or more) shares."""
    pts = [(int(x) % PRIME, int(y) % PRIME) for x, y in shares.items()]
    if len({x for x, _ in pts}) != len(pts):
        raise ValueError("duplicate share points")
    secret = 0
    for i, (xi, yi) in enumerate(pts):
        num = den = 1
        for j, (xj, _) in enumerate(pts):
            if i == j:
                continue
            num = (num * (-xj)) % PRIME
            den = (den * (xi - xj)) % PRIME
        secret = (secret + yi * num * pow(den, PRIME - 2, PRIME)) % PRIME
    return secret
