"""Synthetic datasets with the shapes/classes of the paper's benchmarks —
numpy copy of ``repro.data.datasets`` (the port imports nothing of
``repro``).

The container is offline, so MNIST / Fashion-MNIST / CIFAR-10 are replaced by a
deterministic class-prototype generative model: each class c has a fixed random
prototype image; a sample is prototype + structured low-rank distortion + noise.
Learnable (a linear probe separates classes), non-trivial (prototypes overlap),
and fully reproducible — see DESIGN.md §7 dataset note.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    shape: tuple           # per-sample shape
    n_classes: int
    n_train: int
    n_test: int


MNIST = DatasetSpec("mnist", (28, 28, 1), 10, 60_000, 10_000)
FASHION_MNIST = DatasetSpec("fashion_mnist", (28, 28, 1), 10, 60_000, 10_000)
CIFAR10 = DatasetSpec("cifar10", (32, 32, 3), 10, 50_000, 10_000)

SPECS = {s.name: s for s in (MNIST, FASHION_MNIST, CIFAR10)}


def make_dataset(spec: DatasetSpec, n: int | None = None, *, seed: int = 0,
                 noise: float = 0.35, train: bool = True):
    """Returns (x: float32[n, *shape], y: int32[n])."""
    n = n if n is not None else (spec.n_train if train else spec.n_test)
    # stable digest, NOT builtin hash(): str hashing is salted per process
    # (PYTHONHASHSEED), which made the class prototypes — and so every
    # accuracy — differ between otherwise identical runs
    digest = zlib.crc32(f"{spec.name}/17".encode())
    rng = np.random.RandomState(digest % (2**31))
    protos = rng.randn(spec.n_classes, *spec.shape).astype(np.float32)
    # low-rank distortion directions per class
    dirs = rng.randn(spec.n_classes, 4, *spec.shape).astype(np.float32) * 0.5

    rs = np.random.RandomState(seed + (0 if train else 10_000))
    y = rs.randint(0, spec.n_classes, size=n).astype(np.int32)
    coef = rs.randn(n, 4).astype(np.float32)
    x = protos[y]
    x = x + np.einsum("nk,nk...->n...", coef, dirs[y])
    x = x + noise * rs.randn(*x.shape).astype(np.float32)
    return x.astype(np.float32), y


def make_lm_tokens(vocab: int, n_seqs: int, seq_len: int, *, seed: int = 0):
    """Synthetic token streams with local structure (order-2 Markov-ish) so an LM
    can reduce loss below uniform; labels are next-token shifted."""
    rs = np.random.RandomState(seed)
    # block-structured transition: token t+1 ~ (a*t + b) mod vocab with noise
    a = rs.randint(1, 7, size=n_seqs)
    b = rs.randint(0, vocab, size=n_seqs)
    t0 = rs.randint(0, vocab, size=n_seqs)
    toks = np.zeros((n_seqs, seq_len + 1), np.int32)
    toks[:, 0] = t0
    for i in range(seq_len):
        nxt = (a * toks[:, i] + b) % vocab
        flip = rs.rand(n_seqs) < 0.15
        nxt = np.where(flip, rs.randint(0, vocab, size=n_seqs), nxt)
        toks[:, i + 1] = nxt
    return toks[:, :-1], toks[:, 1:]
