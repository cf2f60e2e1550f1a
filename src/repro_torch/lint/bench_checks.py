"""RPL002 — bench suites must time through ``timing.measure`` (port of
``repro.lint.bench_checks``).

The perf gate compares every ``--quick`` run against committed
``BENCH_torch_*.json`` baselines with a 3x slowdown bound; a mean over 2-3
reps of a sub-millisecond op trips it on a single OS scheduler stall.
``repro_torch/bench/timing.py``'s ``measure`` (min-of-reps, the card
synchronized around each rep) is the canonical suite timer.

Scope: ``*_bench.py`` modules under ``repro_torch/bench/``, where the
reference's rule looks under ``repro/bench/`` (``timing.py`` itself is the
sanctioned ``perf_counter`` call site and is out of scope).
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.lint.core import (Check, Finding, LintContext, SourceFile,
                                   register)
from repro_torch.lint.determinism import _call_name


@register
class BenchTiming(Check):
    id = "RPL002"
    title = "bench suite times outside timing.measure"
    rationale = (
        "the 3x gate needs min-of-reps timings; raw perf_counter or "
        "mean-of-reps time_us trips it on one scheduler stall"
    )

    def applies(self, src: SourceFile) -> bool:
        if "repro_torch/bench/" not in src.path:
            return False
        return src.path.endswith("_bench.py")

    def run(self, src: SourceFile, ctx: LintContext) -> Iterator[Finding]:
        saw_measure = False
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            if name == "measure":
                saw_measure = True
            elif name == "time_us":
                yield self.finding(
                    src,
                    node,
                    "suite times with mean-of-reps time_us(); use "
                    "timing.measure (min-of-reps)",
                )
            elif name == "perf_counter":
                yield self.finding(
                    src,
                    node,
                    "suite reads perf_counter directly; time through "
                    "timing.measure (min-of-reps)",
                )
        if not saw_measure:
            yield Finding(
                self.id,
                src.path,
                1,
                1,
                "bench suite never calls timing.measure — entries must be "
                "min-of-reps timings",
            )
