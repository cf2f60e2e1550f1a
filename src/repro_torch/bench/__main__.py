"""CLI for the port's benchmark suites and the regression gate.

    python -m repro_torch.bench --quick            # BENCH_torch_<suite>.json (cwd)
    python -m repro_torch.bench --quick --out B.json   # one combined document
    python -m repro_torch.bench --gate B.json      # compare vs the baselines
    python -m repro_torch.bench --csv --only table2,agg   # CSV rows
    python -m repro_torch.bench --device cpu --quick --out B.json

The suites run on ``--device`` (default ``cuda``); without a card they fail
unless ``--device cpu`` is given: there is no fallback from one to the
other. The gate's default baselines are the port's own
``BENCH_torch_*.json`` in the cwd, never the reference's ``BENCH_*.json``:
the entry names are the same, the machines are not.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _write_json(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


def main(argv=None) -> int:
    from repro_torch.bench import schema

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench",
        description="Run the port's perf suites / gate a run against the "
                    "baselines.")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized workloads (the committed baselines are "
                         "quick-mode; entry names encode the size)")
    ap.add_argument("--only", default=None,
                    help="comma-separated suites; JSON suites: "
                         "round,agg,cohort,serve; CSV-only: "
                         "table1,table2,fig1,fig3")
    ap.add_argument("--out", default=None,
                    help="write ONE combined JSON document here instead of "
                         "per-suite BENCH_torch_<suite>.json files in the "
                         "cwd")
    ap.add_argument("--csv", action="store_true",
                    help="print 'name,us_per_call,derived' CSV rows "
                         "instead of writing JSON")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the suites run (default cuda; cpu runs the "
                         "plain PyTorch versions of the kernels)")
    ap.add_argument("--gate", default=None, metavar="CURRENT_JSON",
                    help="gate mode: compare this document against the "
                         "baselines and exit 1 on regression (runs nothing)")
    ap.add_argument("--baseline", action="append", default=None,
                    help="baseline document(s) for --gate (default: "
                         "BENCH_torch_round.json BENCH_torch_agg.json "
                         "BENCH_torch_cohort.json BENCH_torch_serve.json)")
    ap.add_argument("--max-slowdown", type=float,
                    default=schema.DEFAULT_MAX_SLOWDOWN,
                    help="gate threshold (default %(default)s; generous — "
                         "host timings are noisy)")
    args = ap.parse_args(argv)

    from repro_torch.bench import JSON_SUITES, LEGACY_SUITES

    if args.gate is not None:
        current = schema.load_doc(args.gate)
        baselines = [schema.load_doc(p) for p in (
            args.baseline or [f for _, f in JSON_SUITES.values()])]
        failures, compared = schema.gate_compare(
            current, baselines, max_slowdown=args.max_slowdown)
        if compared == 0:
            print("bench gate: no comparable entries — baseline stale? "
                  "(quick vs full runs never share entry names)",
                  file=sys.stderr)
            return 1
        for line in failures:
            print(f"bench gate REGRESSION: {line}", file=sys.stderr)
        print(f"bench gate: {compared} entries compared, "
              f"{len(failures)} regression(s) at >{args.max_slowdown:.1f}x")
        return 1 if failures else 0

    from repro_torch.bench import make_doc, run_suite

    chosen = args.only.split(",") if args.only else list(JSON_SUITES)
    if args.csv and args.out:
        print("error: --csv and --out are mutually exclusive (CSV mode "
              "writes no JSON; refresh baselines without --csv)",
              file=sys.stderr)
        return 2
    unknown = [c for c in chosen if c not in {**JSON_SUITES,
                                              **LEGACY_SUITES}]
    if unknown:
        print(f"error: unknown suite(s) {unknown}; know "
              f"{sorted(JSON_SUITES)} + {sorted(LEGACY_SUITES)}",
              file=sys.stderr)
        return 2
    if not args.csv:
        legacy = [c for c in chosen if c in LEGACY_SUITES]
        if legacy:
            print(f"error: {legacy} are CSV-only suites; add --csv",
                  file=sys.stderr)
            return 2
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device: the suites run on the card; pass "
              "--device cpu to run the plain PyTorch versions on the CPU "
              "(its times are CPU times, never the card's)", file=sys.stderr)
        return 1

    results: dict[str, list[dict]] = {}
    failures = 0
    if args.csv:
        print("name,us_per_call,derived")
    for name in chosen:
        try:
            entries = run_suite(name, quick=args.quick, device=args.device)
        except Exception as e:  # keep the suite going; report the failure
            if args.csv:
                print(f"{name}/ERROR,0,{type(e).__name__}:{e}", flush=True)
                failures += 1
                continue
            raise
        results[name] = entries
        if args.csv:
            for e in entries:
                print(f"{e['name']},{e['us_per_call']:.1f},{e['derived']}",
                      flush=True)
    if args.csv:
        return 1 if failures else 0

    if args.out:
        doc = make_doc(None, suites=results, quick=args.quick,
                       device=args.device)
        _write_json(args.out, doc)
        print(f"wrote {args.out} "
              f"({sum(len(v) for v in results.values())} entries)")
    else:
        for name, entries in results.items():
            path = JSON_SUITES[name][1]
            _write_json(path, make_doc(entries, suite=name, quick=args.quick,
                                       device=args.device))
            print(f"wrote {path} ({len(entries)} entries)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
