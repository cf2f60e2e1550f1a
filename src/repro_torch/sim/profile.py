"""Where a round's time goes, on the card.

    python -m repro_torch.sim.profile --preset table2_quick \
        --out profile_table2_quick.json
    python -m repro_torch.sim.profile --preset table2 --model cifar_vgg16 \
        --dataset cifar10 --rounds 2
    python -m repro_torch.sim.profile --preset codec_sweep_quick --arm int8
    python -m repro_torch.sim.profile --preset tree_quick
    python -m repro_torch.sim.profile --preset async_quick

Runs the preset once to warm up (kernel builds, cuBLAS, allocator), then
again under ``torch.profiler`` with a per-round hook that synchronizes and
reads the host clock. Prints and writes as JSON: the per-round wall times,
the device time of the busiest kernels by name and of the port's own CUDA
kernels, the CPU time of each round stage (the ``round.*`` spans of
``core/fedavg.py``) and the device's busy share of the profiled window
(kernel time over wall time; one stream, so kernels do not overlap). Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.kernels import ops
from repro_torch.sim import presets
from repro_torch.sim.engine import simulation_for


def _device_us(evt, self_only: bool) -> float:
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sim.profile")
    ap.add_argument("--preset", default="table2_quick",
                    help="a preset, or a codec or DP sweep with --arm")
    ap.add_argument("--arm", default=None,
                    help="the arm of a sweep preset (a codec, or a DP arm "
                         "label such as off or z0.6)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--model", default=None, help="override the model")
    ap.add_argument("--dataset", default=None, help="override the dataset")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: the profile needs a CUDA device", file=sys.stderr)
        return 1
    if args.preset in presets.SWEEPS:
        cfg = presets.sweep_configs(args.preset)[args.arm or "int8"]
    elif args.preset in presets.DP_SWEEPS:
        cfg = presets.dp_sweep_configs(args.preset)[args.arm or "z0.6"]
    else:
        cfg = presets.get(args.preset)
    cfg = cfg.replace(out_json=None)
    for field in ("rounds", "model", "dataset"):
        if getattr(args, field) is not None:
            cfg = cfg.replace(**{field: getattr(args, field)})
    simulation_for(cfg.replace(rounds=1), device="cuda").run()   # warm-up

    sim = simulation_for(cfg, device="cuda")
    round_s: list = []
    mark = [0.0]

    def hook(r, info):
        torch.cuda.synchronize()
        now = time.perf_counter()
        round_s.append(now - mark[0])
        mark[0] = now

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = mark[0] = time.perf_counter()
        res = sim.run(hooks=[hook])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    kernels, spans = [], {}
    for evt in prof.key_averages():
        dev = _device_us(evt, self_only=True)
        on_cuda = "CUDA" in str(getattr(evt, "device_type", ""))
        if evt.key.startswith("round."):
            # a span appears twice: its host range and its device range
            span = spans.setdefault(evt.key, {"count": evt.count})
            if on_cuda:
                span["device_range_ms"] = _device_us(evt, False) / 1e3
            else:
                span["cpu_ms"] = evt.cpu_time_total / 1e3
        elif dev > 0 and on_cuda:
            kernels.append({"name": evt.key, "device_ms": dev / 1e3,
                            "count": evt.count})
    kernels.sort(key=lambda k: -k["device_ms"])
    port = [k for k in kernels if any(n in k["name"] for n in ops.KERNELS)]
    busy = sum(k["device_ms"] for k in kernels) / (wall * 1e3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    doc = {
        "preset": args.preset, "name": cfg.name, "codec": cfg.codec,
        "model": cfg.model, "card": smi,
        "device": torch.cuda.get_device_name(0),
        "rounds": cfg.rounds, "wall_s": wall,
        "round_s": round_s, "round_s_median": statistics.median(round_s),
        "final_acc": res.final_acc,
        "upload_vs_dense_paper": res.ledger.totals("paper")["upload_vs_dense"],
        "launches": counts, "device_busy_share": busy,
        "spans": spans, "port_kernels": port, "kernels": kernels[:25],
    }
    print(f"[profile] {cfg.name} {cfg.model} on {smi}: rounds={cfg.rounds} "
          f"wall_s={wall:.4f} round_s_median={doc['round_s_median']:.4f} "
          f"device_busy_share={busy:.4f} launches={counts}")
    for name, sp in sorted(spans.items()):
        print(f"[profile] span {name}: {sp}")
    for k in port + kernels[:12]:
        print(f"[profile] kernel {k['device_ms']:10.3f} ms x{k['count']:5d} "
              f"{k['name'][:90]}")
    if args.out:
        d = os.path.dirname(args.out)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
