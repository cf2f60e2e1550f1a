"""Frozen copy of the port's synthetic dataset generator
(``repro_torch/data/datasets.py::make_dataset``), so that the benchmark's
inputs do not move when the program's generator does.

Each class has a fixed random prototype image; a sample is its class's
prototype plus a low-rank distortion and noise, at the shapes and class count
of the paper's datasets (the real images are not in the repository).
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    shape: tuple           # per-sample shape (NHWC)
    n_classes: int


SPECS = {s.name: s for s in (
    DatasetSpec("mnist", (28, 28, 1), 10),
    DatasetSpec("fashion_mnist", (28, 28, 1), 10),
    DatasetSpec("cifar10", (32, 32, 3), 10),
)}


def make_dataset(spec: DatasetSpec, n: int, *, seed: int,
                 noise: float = 0.35, train: bool = True):
    """Returns (x: float32[n, *shape], y: int32[n]); ``seed`` < 2**32 - 10**4."""
    digest = zlib.crc32(f"{spec.name}/17".encode())
    rng = np.random.RandomState(digest % (2**31))
    protos = rng.randn(spec.n_classes, *spec.shape).astype(np.float32)
    dirs = rng.randn(spec.n_classes, 4, *spec.shape).astype(np.float32) * 0.5

    rs = np.random.RandomState(seed + (0 if train else 10_000))
    y = rs.randint(0, spec.n_classes, size=n).astype(np.int32)
    coef = rs.randn(n, 4).astype(np.float32)
    x = protos[y]
    x = x + np.einsum("nk,nk...->n...", coef, dirs[y])
    x = x + noise * rs.randn(*x.shape).astype(np.float32)
    return x.astype(np.float32), y
