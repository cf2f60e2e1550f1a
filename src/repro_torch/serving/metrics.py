"""Serving metrics: the ``repro.serve/v1`` JSON document + its validator.

A copy of ``repro.serving.metrics`` (the port imports nothing of
``repro``): the document, its schema and its validation are the same, so
either package's validator accepts the other's documents.

One :class:`ServingMetrics` instance rides along the whole serve loop
(server, hot-swap watcher, load generator all record into it, under one
lock) and renders to a single schema'd document that CI asserts on — the
same design as ``repro.bench.schema`` / ``repro.lint.report``: no jax
imports here, the validator must run without a backend.

Document shape::

    {
      "schema": "repro.serve/v1",
      "wall_s": 12.3,
      "requests": {"submitted": 400, "served": 400, "errors": 0},
      "latency_us": {"p50": 812.0, "p99": 4310.0, "mean": 990.1,
                     "max": 8120.4, "n": 400},
      "qps": {"offered": 50.0, "sustained": 49.2},
      "batches": {"count": 61, "mean_fill": 6.5},
      "swaps": {"count": 3, "pause_us": {"p50": 8.1, "max": 40.2},
                "steps": [1, 2, 3]},
      "staleness": {"mean": 0.21, "max": 1, "samples": 61},
      "checkpoints": {"served_steps": {"0": 120, "1": 160, "2": 120}},
      "tokens": {"generated": 0, "tok_s": 0.0}      # LM adapters only
    }

``staleness`` is measured at serve time, per batch: how many published
steps the weights answering this batch lag the newest complete checkpoint
(0 = serving the freshest model).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional

SCHEMA_VERSION = "repro.serve/v1"


def percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile of an ascending list (0 <= q <= 100)."""
    if not sorted_vals:
        return float("nan")
    rank = max(0, min(len(sorted_vals) - 1,
                      int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[rank])


class ServingMetrics:
    """Thread-safe accumulator for one serve run (see module docstring)."""

    def __init__(self, offered_qps: float = 0.0):
        self._lock = threading.Lock()
        self.offered_qps = float(offered_qps)
        self.submitted = 0
        self.served = 0
        self.errors = 0
        self.latencies_us: list[float] = []
        self.batch_fills: list[int] = []
        self.swap_pauses_us: list[float] = []
        self.swap_steps: list[int] = []
        self.staleness: list[int] = []
        self.served_by_step: dict[int, int] = {}
        self.tokens_generated = 0
        self.wall_s = 0.0

    # ------------------------------------------------------------- recording
    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_served(self, latency_us: float, step: int,
                      tokens: int = 0) -> None:
        with self._lock:
            self.served += 1
            self.latencies_us.append(float(latency_us))
            self.served_by_step[int(step)] = \
                self.served_by_step.get(int(step), 0) + 1
            self.tokens_generated += int(tokens)

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_batch(self, fill: int, active_step: int,
                     latest_step: Optional[int]) -> None:
        with self._lock:
            self.batch_fills.append(int(fill))
            if latest_step is not None:
                self.staleness.append(max(0, int(latest_step) - int(active_step)))

    def record_swap(self, step: int, pause_us: float) -> None:
        with self._lock:
            self.swap_steps.append(int(step))
            self.swap_pauses_us.append(float(pause_us))

    # -------------------------------------------------------------- document
    def summary(self) -> dict:
        with self._lock:
            lats = sorted(self.latencies_us)
            pauses = sorted(self.swap_pauses_us)
            wall = max(self.wall_s, 1e-9)
            doc = {
                "schema": SCHEMA_VERSION,
                "wall_s": float(self.wall_s),
                "requests": {
                    "submitted": self.submitted,
                    "served": self.served,
                    "errors": self.errors,
                },
                "latency_us": {
                    "p50": percentile(lats, 50),
                    "p99": percentile(lats, 99),
                    "mean": (sum(lats) / len(lats)) if lats else float("nan"),
                    "max": lats[-1] if lats else float("nan"),
                    "n": len(lats),
                },
                "qps": {
                    "offered": self.offered_qps,
                    "sustained": self.served / wall,
                },
                "batches": {
                    "count": len(self.batch_fills),
                    "mean_fill": (sum(self.batch_fills) / len(self.batch_fills)
                                  if self.batch_fills else 0.0),
                },
                "swaps": {
                    "count": len(self.swap_steps),
                    "pause_us": {
                        "p50": percentile(pauses, 50),
                        "max": pauses[-1] if pauses else 0.0,
                    },
                    "steps": list(self.swap_steps),
                },
                "staleness": {
                    "mean": (sum(self.staleness) / len(self.staleness)
                             if self.staleness else 0.0),
                    "max": max(self.staleness) if self.staleness else 0,
                    "samples": len(self.staleness),
                },
                "checkpoints": {
                    "served_steps": {str(k): v for k, v in
                                     sorted(self.served_by_step.items())},
                },
                "tokens": {
                    "generated": self.tokens_generated,
                    "tok_s": self.tokens_generated / wall,
                },
            }
        return doc

    def to_json(self, path: str) -> str:
        doc = self.summary()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path


def validate_metrics(doc: dict) -> list[str]:
    """Schema errors ([] = valid); cross-checks the counts like
    ``repro.lint.report`` does (served + errors == submitted after a drained
    run, swap count == len(steps), latency n == served)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    if doc.get("schema") != SCHEMA_VERSION:
        errs.append(f"schema must be {SCHEMA_VERSION!r}, "
                    f"got {doc.get('schema')!r}")
    for key, fields in (
            ("requests", ("submitted", "served", "errors")),
            ("latency_us", ("p50", "p99", "mean", "max", "n")),
            ("qps", ("offered", "sustained")),
            ("batches", ("count", "mean_fill")),
            ("swaps", ("count", "pause_us", "steps")),
            ("staleness", ("mean", "max", "samples")),
            ("checkpoints", ("served_steps",)),
            ("tokens", ("generated", "tok_s")),
    ):
        block = doc.get(key)
        if not isinstance(block, dict):
            errs.append(f"missing {key!r} object")
            continue
        for f in fields:
            if f not in block:
                errs.append(f"{key}.{f} missing")
    if errs:
        return errs
    req = doc["requests"]
    for f in ("submitted", "served", "errors"):
        if not isinstance(req[f], int) or req[f] < 0:
            errs.append(f"requests.{f} must be an int >= 0")
    if not errs and req["served"] + req["errors"] != req["submitted"]:
        errs.append(
            f"counts do not reconcile: served {req['served']} + errors "
            f"{req['errors']} != submitted {req['submitted']} (undrained run?)")
    if doc["latency_us"]["n"] != req["served"]:
        errs.append(f"latency_us.n {doc['latency_us']['n']} != "
                    f"requests.served {req['served']}")
    sw = doc["swaps"]
    if not isinstance(sw["steps"], list) or sw["count"] != len(sw["steps"]):
        errs.append("swaps.count != len(swaps.steps)")
    served_sum = sum(doc["checkpoints"]["served_steps"].values())
    if served_sum != req["served"]:
        errs.append(f"checkpoints.served_steps sums to {served_sum} != "
                    f"requests.served {req['served']}")
    return errs


def load_metrics(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    errs = validate_metrics(doc)
    if errs:
        raise ValueError(f"{path}: invalid serve document: " + "; ".join(errs))
    return doc
