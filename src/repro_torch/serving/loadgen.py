"""Load-generator harness for the inference server (DESIGN.md §16; port of
``repro.serving.loadgen``, unchanged but for its imports).

Open-loop arrival at a configured QPS: request ``i`` is *scheduled* at
``t0 + i / qps`` regardless of how previous requests fared — the honest way
to measure serving latency under load (a closed loop hides queueing by
slowing the offered rate to match the server). Payloads are drawn from a
fixed pool cycled by request index, so a run is deterministic in everything
but wall-clock timing.

Latency is stamped by the server itself (submit -> response); the generator
only paces, submits, and finally *drains* — every submitted request is
waited on, and one that never completes (or raised) counts as an error.
Zero dropped requests is a CI-gated invariant of the serve smoke.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.server import InferenceServer


class LoadGenerator:
    """Open-loop request generator against one :class:`InferenceServer`."""

    def __init__(self, server: InferenceServer, payloads: Sequence[np.ndarray],
                 qps: float, metrics: Optional[ServingMetrics] = None,
                 wait_timeout_s: float = 60.0):
        if qps <= 0:
            raise ValueError(f"qps must be > 0, got {qps}")
        if not len(payloads):
            raise ValueError("need a non-empty payload pool")
        self.server = server
        self.payloads = payloads
        self.qps = float(qps)
        self.metrics = metrics if metrics is not None else server.metrics
        self.wait_timeout_s = wait_timeout_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tickets: list = []
        self._t0: Optional[float] = None

    # ------------------------------------------------------------------ runs
    def run(self, n_requests: Optional[int] = None,
            duration_s: Optional[float] = None) -> int:
        """Pace requests until ``n_requests`` sent, ``duration_s`` elapsed,
        or ``stop()`` — then drain. Returns the number submitted."""
        t0 = time.perf_counter()
        self._t0 = t0
        i = 0
        while not self._stop.is_set():
            if n_requests is not None and i >= n_requests:
                break
            if duration_s is not None and \
                    time.perf_counter() - t0 >= duration_s:
                break
            target = t0 + i / self.qps
            delay = target - time.perf_counter()
            if delay > 0:
                # wait() (not sleep) so stop() interrupts the pacing promptly
                if self._stop.wait(delay):
                    break
            self._tickets.append(
                self.server.submit(self.payloads[i % len(self.payloads)]))
            i += 1
        self.metrics.wall_s = time.perf_counter() - t0
        return i

    def drain(self) -> int:
        """Wait out every in-flight request; returns the error count
        (timeouts + adapter exceptions). Request errors are recorded by the
        server; only a never-served timeout is recorded here."""
        errors = 0
        for t in self._tickets:
            try:
                t.wait(self.wait_timeout_s)
            except TimeoutError:
                self.metrics.record_error()
                errors += 1
            except Exception:
                errors += 1      # adapter error: already counted server-side
        self._tickets = []
        if self._t0 is not None:
            # pacing start -> fully drained; the CLI overwrites this with the
            # whole train+serve wall clock after everything stops
            self.metrics.wall_s = time.perf_counter() - self._t0
        return errors

    # ------------------------------------------------------------- threading
    def start(self, n_requests: Optional[int] = None,
              duration_s: Optional[float] = None) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, kwargs={"n_requests": n_requests,
                                     "duration_s": duration_s},
            name="loadgen", daemon=True)
        self._thread.start()

    def stop(self) -> int:
        """Stop pacing, join, drain. Returns the drain error count."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.wait_timeout_s)
            self._thread = None
        return self.drain()
