"""Double-buffered weights for the inference server (port of
``repro.serving.hot_swap.WeightBuffers``).

Two weight slots: the *active* slot answers every request, the *staging*
slot receives new weights off the serve path; ``swap()`` is a pointer flip
under a lock between batches, so old weights keep serving until the new
ones are complete. ``active_step`` never goes back. The checkpoint watcher
that stages published checkpoints (``CheckpointWatcher``) waits for the
port's checkpoint slice (ROADMAP Queue 1, slice F).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional

import torch
from torch import nn

Params = Any   # an nn.Module or a {name: tensor} mapping


def _wait_resident(params: Params) -> None:
    """Block until every CUDA tensor of ``params`` is written."""
    tensors = (params.parameters() if isinstance(params, nn.Module)
               else params.values())
    devices = {}
    for t in tensors:
        if t.is_cuda:
            devices[t.device] = True
    for device in devices:
        torch.cuda.synchronize(device)


class WeightBuffers:
    """The two weight slots + the active pointer."""

    def __init__(self, params: Params, step: int = 0):
        self._slots: list[Optional[Params]] = [params, None]
        self._steps: list[int] = [int(step), -1]
        self._active = 0
        self._staged = False
        self._lock = threading.Lock()

    @property
    def active_params(self) -> Params:
        with self._lock:
            return self._slots[self._active]

    @property
    def active_step(self) -> int:
        with self._lock:
            return self._steps[self._active]

    @property
    def staged_step(self) -> Optional[int]:
        """Step resident in the staging slot, whether or not swapped yet."""
        with self._lock:
            s = self._steps[1 - self._active]
            return s if s >= 0 else None

    @property
    def has_staged(self) -> bool:
        with self._lock:
            return self._staged

    def stage(self, step: int, params: Params) -> None:
        """Put ``params`` in the inactive slot and mark it swappable. Blocks
        until its tensors are written on the device — callers keep this OFF
        the serve path."""
        _wait_resident(params)
        with self._lock:
            self._slots[1 - self._active] = params
            self._steps[1 - self._active] = int(step)
            self._staged = True

    def swap(self) -> float:
        """Flip the active pointer onto the staged slot; returns the pause
        in microseconds (the only instant the serve loop is 'down')."""
        t0 = time.perf_counter()
        with self._lock:
            if not self._staged:
                raise RuntimeError("swap() with nothing staged")
            self._active = 1 - self._active
            self._staged = False
        return (time.perf_counter() - t0) * 1e6
