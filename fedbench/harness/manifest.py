"""Find everything a cell needs by name: ``BENCHMARK.json`` at the root of
the checkout, ``fedbench/workloads/<cell>.json`` (its configuration, its
traffic and the limits its outputs are held to),
``fedbench/configs/<config>.json``, ``fedbench/traffic/<traffic>.json`` and
one reader ``fedbench/metrics/<metric>.py`` a per-layer metric.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return _load(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry of the manifest, with its workload, configuration
    and traffic files loaded and its metrics listed: ``end_to_end`` (trace
    off) and ``per_layer`` (trace on), each the manifest's entries that name
    the cell or name no cells."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    bench = root / "fedbench"
    work = _load(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if work[key] != entry[key]:
            raise ValueError(f"{name}: the workload file's {key} "
                             f"{work[key]!r} is not the manifest's "
                             f"{entry[key]!r}")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return {
        "name": name, "chips": entry["chips"], "workload": work,
        "config": _load(bench / "configs" / f"{entry['config']}.json"),
        "traffic": _load(bench / "traffic" / f"{entry['traffic']}.json"),
        "end_to_end": mine(man["end_to_end"]),
        "per_layer": mine(man["per_layer"]),
        "run_seconds": man["run_seconds"],
    }


def reader(metric: str, root: Path = ROOT):
    """The ``read(trace, ctx)`` function of a per-layer metric's file."""
    path = root / "fedbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "fedbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
