"""Double-buffered weight hot-swap (port of ``repro.serving.hot_swap``).

Two weight slots: the *active* slot answers every request, the *staging*
slot receives new weights off the serve path; ``swap()`` is a pointer flip
under a lock between batches, so old weights keep serving until the new
ones are complete. ``active_step`` never goes back.

:class:`CheckpointWatcher` polls a publish directory and stages each newer
complete checkpoint (``checkpoint.latest_published_step`` skips an npz whose
manifest is missing or truncated, so a crash mid-publish leaves the server
on the last good step). On the card the staging is:

1. host work in the loader thread: ``np.load`` into page-locked tensors;
2. the copy to the card on the watcher's own ``torch.cuda.Stream``
   (``non_blocking``), then an event recorded on that stream;
3. a wait on that event alone — not on the device, whose default stream may
   hold a training round's queued kernels — and only then the buffer is
   marked staged.

The copies are allocated on the watcher's stream and read on the serve
stream (the device's default stream), so each is marked with
``record_stream``: a retired slot's memory is not reused before the serve
stream's work queued up to its release has run.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterator, Mapping, Optional

import torch
from torch import nn

from repro_torch import checkpoint

Params = Any   # an nn.Module or a (nested) {name: tensor} mapping


def _tensors(params: Params) -> Iterator[torch.Tensor]:
    if isinstance(params, nn.Module):
        yield from params.parameters()
    elif isinstance(params, Mapping):
        for v in params.values():
            yield from _tensors(v)
    elif isinstance(params, torch.Tensor):
        yield params


def _cuda_device(params: Params) -> Optional[torch.device]:
    return next((t.device for t in _tensors(params) if t.is_cuda), None)


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
        until the work queued so far on the current stream of their device
        (the copy that wrote them) has run — not on the whole device;
        callers keep this OFF the serve path."""
        device = _cuda_device(params)
        if device is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
            ready.synchronize()
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


class CheckpointWatcher:
    """Polls a publish directory and stages new checkpoints for swapping
    (module docstring).

    ``like`` is a params tree on the serving device (its leaves give each
    staged leaf's device and dtype). ``restore_fn(step)`` replaces the
    staging above with any function that returns the step's params.
    ``last_stage`` holds the newest staging's step and its host load and
    copy times in ms (host clock; the copy's until its event completed).
    """

    def __init__(self, ckpt_dir: str, like: Params, buffers: WeightBuffers,
                 metrics=None,
                 restore_fn: Optional[Callable[[int], Params]] = None,
                 poll_interval_s: float = 0.05):
        self.ckpt_dir = ckpt_dir
        self.like = like
        self.buffers = buffers
        self.metrics = metrics
        self.poll_interval_s = poll_interval_s
        self._restore = restore_fn
        self._stream: Optional[torch.cuda.Stream] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.latest_seen: Optional[int] = None   # newest complete step found
        self.last_stage: Optional[dict] = None

    def _stage_step(self, step: int) -> None:
        if self._restore is not None:
            self.buffers.stage(step, self._restore(step))
            return
        device = _cuda_device(self.like)
        t0 = time.perf_counter()
        host = checkpoint.read_host(self.ckpt_dir, step, self.like,
                                    pin_memory=device is not None)
        t1 = time.perf_counter()
        if device is None:
            self.buffers.stage(step, host)
        else:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            serve_stream = torch.cuda.default_stream(device)
            with torch.cuda.stream(self._stream):
                params = checkpoint.map_leaves(
                    lambda h, leaf: h.to(leaf.device, non_blocking=True),
                    host, self.like)
                for t in _tensors(params):
                    t.record_stream(serve_stream)
                # waits on this stream's event: the copy, not the device
                self.buffers.stage(step, params)
        t2 = time.perf_counter()
        self.last_stage = {"step": step, "load_ms": (t1 - t0) * 1e3,
                           "copy_ms": (t2 - t1) * 1e3}

    # ---------------------------------------------------------------- polling
    def poll_once(self) -> Optional[int]:
        """One poll: stage the newest complete step if it beats both the
        active and any already-staged step. Returns the staged step or None.
        Safe to call inline (tests) or from the loader thread."""
        newest = checkpoint.latest_published_step(self.ckpt_dir)
        if newest is None:
            return None
        self.latest_seen = newest
        staged = self.buffers.staged_step
        horizon = max(self.buffers.active_step,
                      staged if staged is not None else -1)
        if newest <= horizon:
            return None
        self._stage_step(newest)
        return newest

    def maybe_swap(self) -> Optional[int]:
        """Between-batches hook: flip onto a staged buffer when one is
        resident. Returns the new active step, or None if nothing swapped."""
        if not self.buffers.has_staged:
            return None
        pause_us = self.buffers.swap()
        step = self.buffers.active_step
        if self.metrics is not None:
            self.metrics.record_swap(step, pause_us)
        return step

    # ----------------------------------------------------------- loader thread
    def start(self) -> None:
        """Run the poll loop in a daemon loader thread (staging happens
        there; swapping stays with the serve loop)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="ckpt-watcher", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except (OSError, ValueError, KeyError):
                # a reader racing the publisher can lose (a partial listing
                # or file); the next poll sees a consistent directory
                pass
            self._stop.wait(self.poll_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
