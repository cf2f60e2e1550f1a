"""Every input the benchmark makes is a pure function of ``--seed``. The
frozen generators take 32-bit seeds, so a run's seed (any whole number) is
mixed down to one base seed first, and each draw's seed is derived from it.
"""
from __future__ import annotations

import numpy as np

_BASE_TAG = 0xFEDB
# the generators add up to 10**4 and client batches multiply by 7919
BASE_LIMIT = 2 ** 31 - 10_001


def base_seed(seed: int) -> int:
    """A 31-bit seed from any whole number, through numpy's SeedSequence."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, _BASE_TAG])
    return int(rng.integers(1, BASE_LIMIT))


def batch_seed(base: int, round_t: int, client: int) -> int:
    """The seed of one client's batches in one round, as the port's engine
    derives it, folded into 32 bits."""
    return (base * 7919 + round_t * 1000 + int(client)) % 2 ** 32
