"""Shared timing helpers for the bench suites (port of
``repro.bench.timing``).

PyTorch returns before the card has finished, so every timed callable ends
with :func:`sync` on its device: a host clock without it would time the
enqueue, not the work. The first warm-up call of a suite also absorbs the
``nvcc`` build of the kernels it launches.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def sync(device) -> None:
    """Wait for the work queued on ``device``: ``torch.cuda.synchronize``
    on a CUDA device, nothing on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_us(fn: Callable[[], object], reps: int, *, warmup: int = 1) -> float:
    """Mean wall-clock microseconds per call after ``warmup`` calls.

    The callable must end with :func:`sync` on its device.
    """
    for _ in range(max(warmup, 0)):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def measure(fn: Callable[[], object], reps: int, *, warmup: int = 1) -> float:
    """Min-of-reps wall-clock microseconds per call — the suites' timer.

    The gate compares against committed baselines with a 3x slowdown bound,
    and a mean over 2-3 reps of a sub-millisecond op trips it on one OS
    scheduler stall; the *min* of ``max(3, reps)`` single-rep timings is
    what the op costs. The ``warmup`` calls absorb the kernels' build, the
    allocator and the library handles.
    """
    for _ in range(max(warmup, 0)):
        fn()
    return min(time_us(fn, 1, warmup=0) for _ in range(max(3, reps)))


def entry(name: str, us: float, derived: str = "", *, reps: int = 0) -> dict:
    """One normalized BENCH entry (us == 0.0 marks an info-only row)."""
    e = {"name": name, "us_per_call": float(us), "derived": str(derived)}
    if reps:
        e["reps"] = int(reps)
    return e
