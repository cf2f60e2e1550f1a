"""repro_torch.bench — the port's machine-readable performance trajectory
(port of ``repro.bench``).

``python -m repro_torch.bench`` times the hot paths on the card (the
federated round, the aggregation kernels, the flat-vs-tree cohort sweep and
the serving path) and writes schema'd ``repro.bench/v1`` documents —
``BENCH_torch_round.json`` / ``BENCH_torch_agg.json`` /
``BENCH_torch_cohort.json`` / ``BENCH_torch_serve.json`` — that ``--gate``
compares a fresh run against. Entry names equal the reference's for the same
workload; the baselines are the port's own, recorded on the card: the
reference's ``BENCH_*.json`` are CPU numbers of another machine.

The paper-table drivers (``bench/paper/``: table1, table2, fig1, fig3 on
``repro_torch.sim``) run through ``--csv --only ...``. The roofline table
waits for the datacenter layer (slice I).

Import discipline: this module and ``schema`` import no torch at module
level, so a gate-only run touches no device; the suites are imported
lazily.
"""
from __future__ import annotations

from repro_torch.bench.schema import (SCHEMA_VERSION, gate_compare,
                                      iter_entries, make_doc, validate_doc)

# JSON suites: name -> (module under repro_torch.bench, default output file)
JSON_SUITES = {
    "round": ("repro_torch.bench.round_bench", "BENCH_torch_round.json"),
    "agg": ("repro_torch.bench.agg_bench", "BENCH_torch_agg.json"),
    "cohort": ("repro_torch.bench.cohort_bench", "BENCH_torch_cohort.json"),
    "serve": ("repro_torch.bench.serve_bench", "BENCH_torch_serve.json"),
}

# CSV-only paper-table suites: name -> (module, function)
LEGACY_SUITES = {
    "table1": ("repro_torch.bench.paper.table1", "run"),
    "table2": ("repro_torch.bench.paper.table2", "run"),
    "fig1": ("repro_torch.bench.paper.fig1", "run"),
    "fig3": ("repro_torch.bench.paper.fig3", "run"),
}


def run_suite(name: str, quick: bool = False, device="cuda") -> list[dict]:
    """Run one suite by name on ``device``; returns normalized entry
    dicts."""
    import importlib

    if name in JSON_SUITES:
        mod = importlib.import_module(JSON_SUITES[name][0])
        return mod.entries(quick=quick, device=device)
    if name in LEGACY_SUITES:
        mod_name, fn_name = LEGACY_SUITES[name]
        mod = importlib.import_module(mod_name)
        rows = getattr(mod, fn_name)(quick=quick, device=device)
        return [{"name": n, "us_per_call": float(us), "derived": str(d)}
                for n, us, d in rows]
    raise KeyError(
        f"unknown suite {name!r}; know {sorted(JSON_SUITES)} + "
        f"{sorted(LEGACY_SUITES)}")


__all__ = [
    "JSON_SUITES", "LEGACY_SUITES", "SCHEMA_VERSION", "gate_compare",
    "iter_entries", "make_doc", "run_suite", "validate_doc",
]
