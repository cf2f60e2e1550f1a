"""The benchmark of the PyTorch/CUDA port, one run of one cell.

    python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Set-up makes every input from ``--seed``,
warms up the cell's own shapes and drives its first steps, the window then
measures for ``--seconds``, and the outputs of the timed path are held to the
plain reference in ``fedbench/reference``. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also close standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; the
    program from the checkout's ``src``; no library loads JAX by itself."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_ext")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def banned_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``repro_torch`` is the port, and passes)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED))


def _driver(traffic: dict):
    """The traffic's driver, ``fedbench/harness/<driver>.py``, by name."""
    import importlib
    return importlib.import_module(f"fedbench.harness.{traffic['driver']}")


def result(cell: dict, out: dict, *, trace: bool, device) -> dict:
    """The contract's last line from a driver's outcome."""
    import torch

    from fedbench.harness.manifest import reader
    metrics = {}
    if trace:
        tr = out["trace"]
        ctx = dict(out["ctx"], window_s=tr.window_s, busy_s=tr.busy_s,
                   cell=cell["name"])
        for m in cell["per_layer"]:
            value = reader(m["name"])(tr, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            if m["name"] not in out["metrics"]:
                raise RuntimeError(f"{cell['name']} did not measure "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": out["metrics"][m["name"]],
                                  "unit": m["unit"]}
    limits = cell["workload"]["limits"]
    checks = {name: {"value": v, "limit": limits[name]}
              for name, v in out["checks"].items()}
    dev = torch.device(device)
    line = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": out["attempted"], "failed": out["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if trace:
        line["device"]["busy_s"] = out["trace"].busy_s
        line["device"]["window_s"] = out["trace"].window_s
        line["breakdown"] = out["trace"].breakdown()
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    """One run on the first CUDA device."""
    ap = argparse.ArgumentParser(prog="fedbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"error: no program under {ROOT / 'src'}", file=sys.stderr)
        return 2
    _environment()

    import torch

    from fedbench.harness import manifest
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"error: {cell['name']} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = "cuda:0"
    out = _driver(cell["traffic"]).run(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=device, t_start=T_START)
    banned = banned_modules()
    if banned:
        print(f"error: the run loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    line = result(cell, out, trace=bool(args.trace), device=device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
