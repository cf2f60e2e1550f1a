"""The dry-run and roofline markdown tables from the port's dry-run records
(port of ``benchmarks/make_experiments_tables.py``).

    PYTHONPATH=src python -m repro_torch.bench.paper.experiments_tables \\
        [--dir experiments/dryrun_torch]

prints markdown to stdout. The port's records have no compile time, HLO
collectives or compiled memory: the columns are the argument bytes a device
holds, the FL stream exchange and the seconds the FLOP count took.
"""
from __future__ import annotations

import argparse

from repro_torch.bench.paper.roofline import (DRYRUN_DIR, load_records,
                                              roofline_row)


def fmt_gib(b) -> str:
    return "n/a" if b is None else f"{b / 2**30:.2f}"


def _key(r: dict) -> tuple:
    return (r["arch"], r["shape"], r["mesh"], r.get("fl", False))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.paper.experiments_tables")
    ap.add_argument("--dir", default=DRYRUN_DIR)
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    ok = [r for r in recs if r.get("status") == "ok"]
    skipped = [r for r in recs if r.get("status") == "skipped"]
    failed = [r for r in recs if r.get("status") == "fail"]

    print("### Dry-run summary (meta device)\n")
    print(f"- built OK: **{len(ok)}**, structural skips: {len(skipped)} "
          f"(encoder-only decode), failures: **{len(failed)}**\n")
    print("| arch | shape | mesh | fl | args/dev GiB | exchange GiB "
          "| FLOPs/dev | count s |")
    print("|---|---|---|---|---|---|---|---|")
    for r in sorted(ok, key=_key):
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
              f"| {'y' if r.get('fl') else ''} "
              f"| {fmt_gib(r['memory']['argument_size_in_bytes'])} "
              f"| {fmt_gib(r['collectives'].get('stream_exchange_bytes'))} "
              f"| {r['cost']['flops']:.4e} | {r.get('count_s', 0):.0f} |")
    for r in skipped:
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} |  | skip "
              f"(encoder-only) |  |  |  |")
    for r in sorted(failed, key=_key):
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
              f"| {'y' if r.get('fl') else ''} | fail: "
              f"{r['error'][:80]} |  |  |  |")

    print("\n### Roofline on the H100 (single-pod 16x16 unless noted)\n")
    print("| arch | shape | fl | t_compute s | t_memory s | t_coll s "
          "| bottleneck | useful FLOP ratio | args/dev GiB |")
    print("|---|---|---|---|---|---|---|---|---|")
    for rec in sorted(ok, key=_key):
        if rec["mesh"] != "single" and not rec.get("fl"):
            continue
        r = roofline_row(rec)
        t_coll = ("n/a" if r["t_collective_s"] is None
                  else f"{r['t_collective_s']:.4f}")
        print(f"| {r['arch']} | {r['shape']}"
              f"{' (pod)' if rec['mesh'] == 'pod' else ''} "
              f"| {'y' if r['fl'] else ''} "
              f"| {r['t_compute_s']:.4f} | {r['t_memory_s']:.4f} "
              f"| {t_coll} | {r['bottleneck']} "
              f"| {r['useful_ratio']:.2f} "
              f"| {r['arg_mem_per_device_gib']:.2f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
