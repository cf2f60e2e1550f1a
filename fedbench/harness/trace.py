"""The traced window: ``torch.profiler`` over it, its Chrome trace read back
into host spans and device intervals, and the device's busy time as the
union of the intervals in which a kernel, a copy or a memset ran.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

import torch

WINDOW_SPAN = "fedbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """What the readers see of a traced window.

    ``spans[name]``: the host intervals ``(start_us, end_us)`` of each
    ``record_function`` span inside the window; ``device``: ``(name,
    start_us, end_us)`` of each device operation inside it; ``window_s``,
    ``busy_s``."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} window spans")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window = (w0, w1)
        self.window_s = (w1 - w0) / 1e6
        self.spans: dict = {}
        self.device: list = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0 = float(e["ts"])
            t1 = t0 + float(e["dur"])
            if t1 <= w0 or t0 >= w1:
                continue
            cat = e.get("cat")
            if cat == "user_annotation" and e["name"] != WINDOW_SPAN:
                self.spans.setdefault(e["name"], []).append((t0, t1))
            elif cat in _DEVICE_CATS:
                self.device.append((e["name"], max(t0, w0), min(t1, w1)))
        self.device.sort(key=lambda d: d[1])
        self.busy = _union(self.device)
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6

    def span_s(self, name: str) -> float | None:
        """Total host seconds of one span's occurrences, None if absent."""
        if name not in self.spans:
            return None
        return sum(b - a for a, b in self.spans[name]) / 1e6

    def device_s(self, *patterns: str) -> float:
        """Device seconds of the operations whose name holds a pattern."""
        return sum(b - a for n, a, b in self.device
                   if any(p in n for p in patterns)) / 1e6

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle time
        by the innermost host span open at each gap's start."""
        ops: dict = {}
        for n, a, b in self.device:
            ops[n] = ops.get(n, 0.0) + (b - a) / 1e6
        gaps: dict = {}
        prev = self.window[0]
        for a, b in self.busy + [(self.window[1], self.window[1])]:
            if a > prev:
                label = self._host_at(prev)
                gaps[label] = gaps.get(label, 0.0) + (a - prev) / 1e6
            prev = max(prev, b)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in idle]}

    def _host_at(self, t: float) -> str:
        """The span that opened last before ``t`` and is still open (spans
        nest at most a few deep), else "window"."""
        if not hasattr(self, "_starts"):
            flat = sorted((a, b, n) for n, s in self.spans.items()
                          for a, b in s)
            self._flat = flat
            self._starts = [a for a, _, _ in flat]
        i = bisect.bisect_right(self._starts, t)
        for a, b, name in reversed(self._flat[max(0, i - 8):i]):
            if b > t:
                return name
        return "window"


def _union(intervals: list) -> list:
    out: list = []
    for _, a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the block when ``enabled``; yields a holder whose ``trace``
    is the :class:`Trace` once the block has closed."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    holder.trace = Trace(doc["traceEvents"] if isinstance(doc, dict) else doc)
