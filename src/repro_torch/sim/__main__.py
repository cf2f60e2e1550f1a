"""CLI for the port's simulation engine.

    python -m repro_torch.sim --preset table2_quick
    python -m repro_torch.sim --preset ci_smoke --device cpu
    python -m repro_torch.sim --list

Runs the named preset (with any overrides) on the CUDA device, prints
per-eval progress and the ledger under both bit accountings in the
reference CLI's format, and writes the JSON ledger to ``--out`` (or the
preset's default path). Without a CUDA device it exits non-zero unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.sim import presets
from repro_torch.sim.engine import Simulation, resolve_device
from repro_torch.sim.ledger import mib


def _progress_hook(round_t: int, info: dict) -> None:
    if "acc" in info:
        rec = info["record"]
        drop = f" dropped={list(info['dropped'])}" if info["dropped"] else ""
        print(f"round {round_t + 1:4d}  acc={info['acc']:.3f}  "
              f"loss={info['loss']:.4f}  "
              f"upload={mib(rec.upload_bits):.2f} MiB "
              f"({rec.compression:.1f}x vs dense){drop}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim",
        description="Run a named federated-simulation preset on the port.")
    ap.add_argument("--preset", default=None,
                    help=f"one of: {', '.join(presets.names())}")
    ap.add_argument("--list", action="store_true",
                    help="list presets and exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="JSON ledger path (default: the preset's out_json)")
    args = ap.parse_args(argv)

    if args.list or not args.preset:
        for name in presets.names():
            cfg = presets.get(name)
            mech = ("thgs+sa" if cfg.thgs and cfg.sa.enabled
                    else "thgs" if cfg.thgs else "dense")
            print(f"{name:22s} {cfg.model}/{cfg.dataset} "
                  f"{cfg.partition:9s} rounds={cfg.rounds:<3d} "
                  f"cohort={cfg.clients_per_round}/{cfg.n_clients} {mech}")
        return 0 if args.list else 2

    try:
        cfg = presets.get(args.preset)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    over = {}
    if args.rounds is not None:
        over["rounds"] = args.rounds
    if args.out is not None:
        over["out_json"] = args.out
    cfg = cfg.replace(**over)

    sim = Simulation(cfg, device=device)
    print(f"# preset={args.preset} model={cfg.model} dataset={cfg.dataset} "
          f"partition={cfg.partition} rounds={cfg.rounds} "
          f"cohort={cfg.clients_per_round}/{cfg.n_clients} "
          f"device={device}", flush=True)
    res = sim.run(hooks=[_progress_hook])

    for acct in ("paper", "tpu"):
        t = res.ledger.totals(acct)
        print(f"[{acct:5s}] upload {t['upload_mib']:9.2f} MiB vs dense "
              f"{t['dense_upload_mib']:9.2f} MiB -> "
              f"{t['upload_vs_dense']:6.1%} of FedAvg "
              f"({t['compression_x']:.1f}x)")
        if t["share_upload_bits"] or t["recovery_upload_bits"]:
            print(f"[{acct:5s}] secagg control: shares "
                  f"{mib(t['share_upload_bits']):.4f} MiB + recovery "
                  f"{mib(t['recovery_upload_bits']):.4f} MiB -> total "
                  f"{t['total_upload_vs_dense']:6.1%} of FedAvg")
    print(f"final_acc={res.final_acc:.3f}  wall={res.wall_s:.1f}s")
    if cfg.out_json:
        path = res.to_json(cfg.out_json)
        print(f"ledger written to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
