"""CLI for the port's simulation engine.

    python -m repro_torch.sim --preset table2_quick
    python -m repro_torch.sim --preset ci_smoke --device cpu
    python -m repro_torch.sim --preset codec_sweep_quick --quick
    python -m repro_torch.sim --preset dp_quick
    python -m repro_torch.sim --preset table2_quick --codec int8
    python -m repro_torch.sim --preset tree_quick
    python -m repro_torch.sim --preset async_quick
    python -m repro_torch.sim --preset ci_smoke --topology tree --tree-groups 4
    python -m repro_torch.sim --preset ci_smoke --ckpt-dir ck --ckpt-every 1
    python -m repro_torch.sim --preset table2_quick --shard-clients on
    python -m repro_torch.sim --list

Runs the named preset (with any overrides) on the CUDA device, prints
per-eval progress and the ledger under both bit accountings in the
reference CLI's format (and the composed (ε, δ) of a DP run), and writes the
JSON ledger to ``--out`` (or the preset's default path). With
``--ckpt-dir`` it checkpoints every ``--ckpt-every`` rounds and, run again,
resumes from the newest checkpoint there (``--no-resume`` starts over); the
reference's checkpoints resume too. ``--shard-clients`` (default: the
preset's, 'auto') splits the cohort over the local CUDA devices when more
than one divides it; the header then names ``clients_mesh=<n>dev``, and 'on'
without such a mesh exits 1. A codec sweep
(``codec_sweep[_quick]``) or a DP sweep (``dp_frontier[_quick]``) runs every
arm and writes one combined JSON. Without a CUDA device it exits non-zero
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from repro_torch.core.codecs import CODECS
from repro_torch.core.dp import DPConfig
from repro_torch.sim import presets
from repro_torch.sim.engine import (Simulation, resolve_device,
                                    simulation_for)
from repro_torch.sim.ledger import mib


def _progress_hook(round_t: int, info: dict) -> None:
    if "acc" in info:
        rec = info["record"]
        drop = f" dropped={list(info['dropped'])}" if info["dropped"] else ""
        print(f"round {round_t + 1:4d}  acc={info['acc']:.3f}  "
              f"loss={info['loss']:.4f}  "
              f"upload={mib(rec.upload_bits):.2f} MiB "
              f"({rec.compression:.1f}x vs dense){drop}", flush=True)


def _quick(over: dict, cfg) -> dict:
    """The reference's ``--quick`` shrink: 3 rounds, small data, eval
    every round."""
    over.setdefault("rounds", min(3, cfg.rounds))
    over.setdefault("n_train", min(600, cfg.n_train))
    over.setdefault("n_test", min(200, cfg.n_test))
    over["eval_every"] = 1
    return over


def _sweep_overrides(args, cfg) -> dict:
    """Overrides that apply to every arm of a sweep (the sweep owns its own
    axis: no --codec, no --dp-*)."""
    over = {}
    if args.rounds is not None:
        over["rounds"] = args.rounds
    if args.seed is not None:
        over["seed"] = args.seed
    if args.dropout is not None:
        over["dropout_rate"] = args.dropout
    if args.shard_clients is not None:
        over["shard_clients"] = args.shard_clients
    if args.quick:
        _quick(over, cfg)
    return over


def _write_sweep(name: str, runs: dict, out: str | None) -> None:
    out = out or f"experiments/sim/{name}.json"
    d = os.path.dirname(out)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"name": name, "runs": runs}, f, indent=2, default=float)
    os.replace(tmp, out)
    print(f"sweep ledger written to {out}")


def _run_arms(args, arms: dict, axis: str, device) -> dict:
    runs: dict[str, dict] = {}
    for label, cfg in arms.items():
        cfg = cfg.replace(**_sweep_overrides(args, cfg))
        print(f"# sweep={args.preset} arm {axis}={label} rounds={cfg.rounds} "
              f"cohort={cfg.clients_per_round}/{cfg.n_clients} "
              f"device={device}", flush=True)
        res = Simulation(cfg, device=device).run(resume=False,
                                                 hooks=[_progress_hook])
        runs[label] = res.summary()
    return runs


def _run_codec_sweep(args, device) -> int:
    """Every codec arm of a sweep (same protocol and seed, secure
    aggregation off in every arm), then the upload of each against the f32
    arm under both accountings."""
    if args.codec is not None:
        print("error: --codec conflicts with a sweep preset "
              "(the sweep runs every codec)", file=sys.stderr)
        return 2
    runs = _run_arms(args, presets.sweep_configs(args.preset), "codec",
                     device)
    print(f"\n# {args.preset}: upload vs f32 baseline")
    for acct in ("paper", "tpu"):
        base = runs["f32"]["ledger"][acct]["upload_bits"] if "f32" in runs \
            else None
        for codec, summ in runs.items():
            t = summ["ledger"][acct]
            rel = (f"  ({t['upload_bits'] / base:6.1%} of f32)"
                   if base else "")
            print(f"[{acct:5s}] {codec:5s} upload {t['upload_mib']:9.2f} MiB "
                  f"acc={summ['final_acc']:.3f}{rel}")
    _write_sweep(args.preset, runs, args.out)
    return 0


def _run_dp_sweep(args, device) -> int:
    """Every noise-multiplier arm of a DP frontier sweep (the z=0 arm runs
    without dp), then the privacy/accuracy/communication frontier."""
    runs = _run_arms(args, presets.dp_sweep_configs(args.preset), "dp",
                     device)
    print(f"\n# {args.preset}: privacy/accuracy/communication frontier")
    for label, summ in runs.items():
        t = summ["ledger"]["paper"]
        priv = summ["ledger"].get("privacy")
        eps = (f"eps={priv['epsilon']:8.3f} at delta={priv['delta']:g}"
               if priv else "eps=   inf (no noise)  ")
        print(f"{label:6s} {eps}  acc={summ['final_acc']:.3f}  "
              f"upload={t['upload_mib']:.2f} MiB "
              f"({t['upload_vs_dense']:.1%} of dense)")
    _write_sweep(args.preset, runs, args.out)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim",
        description="Run a named federated-simulation preset on the port.")
    ap.add_argument("--preset", default=None,
                    help=f"one of: {', '.join(presets.names())}, or a sweep")
    ap.add_argument("--list", action="store_true",
                    help="list presets and exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--dropout", type=float, default=None,
                    help="override dropout_rate")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint into (and resume from) this directory")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="checkpoint every N rounds")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore existing checkpoints")
    ap.add_argument("--out", default=None,
                    help="JSON ledger path (default: the preset's out_json)")
    ap.add_argument("--quick", action="store_true",
                    help="shrink the run (3 rounds, 600 train / 200 test "
                         "samples, eval every round)")
    ap.add_argument("--shard-clients", choices=("auto", "on", "off"),
                    default=None,
                    help="client-parallel rounds over the local devices "
                         "(default: the preset's setting)")
    ap.add_argument("--codec", choices=CODECS, default=None,
                    help="stream wire codec; a non-f32 codec on a secagg "
                         "preset turns secure aggregation off (masks cancel "
                         "only on the f32 grid)")
    ap.add_argument("--topology", choices=("flat", "tree"), default=None,
                    help="aggregation topology; 'tree' is bit-equal to "
                         "'flat'")
    ap.add_argument("--tree-groups", type=int, default=None,
                    help="sub-aggregators for --topology tree (0 = auto, "
                         "about the square root of the cohort)")
    ap.add_argument("--dp-sigma", type=float, default=None,
                    help="DP cohort-sum noise multiplier z (0: no noise)")
    ap.add_argument("--dp-clip", type=float, default=None,
                    help="DP per-client L2 clip S")
    ap.add_argument("--dp-delta", type=float, default=None,
                    help="DP accountant target delta (default 1e-5)")
    args = ap.parse_args(argv)

    if args.list or not args.preset:
        for name in presets.names():
            cfg = presets.get(name)
            mech = ("thgs+sa" if cfg.thgs and cfg.sa.enabled
                    else "thgs" if cfg.thgs else "dense")
            print(f"{name:22s} {cfg.model}/{cfg.dataset} "
                  f"{cfg.partition:9s} rounds={cfg.rounds:<3d} "
                  f"cohort={cfg.clients_per_round}/{cfg.n_clients} {mech}")
        for name, arm_codecs in sorted(presets.SWEEPS.items()):
            print(f"{name:22s} sweep over codecs: {', '.join(arm_codecs)}")
        for name, sigmas in sorted(presets.DP_SWEEPS.items()):
            print(f"{name:22s} sweep over dp noise z: "
                  f"{', '.join(f'{z:g}' for z in sigmas)}")
        return 0 if args.list else 2

    sweep = (_run_codec_sweep if args.preset in presets.SWEEPS
             else _run_dp_sweep if args.preset in presets.DP_SWEEPS
             else None)
    if sweep is None:
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
    if sweep is not None:
        try:
            return sweep(args, device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    over = {}
    if args.rounds is not None:
        over["rounds"] = args.rounds
    if args.seed is not None:
        over["seed"] = args.seed
    if args.dropout is not None:
        over["dropout_rate"] = args.dropout
    if args.ckpt_dir is not None:
        over["ckpt_dir"] = args.ckpt_dir
    if args.ckpt_every is not None:
        over["ckpt_every"] = args.ckpt_every
    if args.out is not None:
        over["out_json"] = args.out
    if args.topology is not None:
        over["topology"] = args.topology
    if args.tree_groups is not None:
        over["tree_groups"] = args.tree_groups
    if args.shard_clients is not None:
        over["shard_clients"] = args.shard_clients
    if (args.dp_sigma is not None or args.dp_clip is not None
            or args.dp_delta is not None):
        dp_over = {}
        if args.dp_sigma is not None:
            dp_over["sigma"] = args.dp_sigma
        if args.dp_clip is not None:
            dp_over["clip"] = args.dp_clip
        if args.dp_delta is not None:
            dp_over["delta"] = args.dp_delta
        over["dp"] = dataclasses.replace(cfg.dp or DPConfig(), **dp_over)
    if args.codec is not None:
        over["codec"] = args.codec
        if args.codec != "f32" and cfg.sa.enabled:
            print(f"# NOTE: codec={args.codec} disables secure aggregation "
                  "for this run — sparse pair masks cancel bit-exactly only "
                  "on the f32 grid", flush=True)
            over["sa"] = dataclasses.replace(cfg.sa, enabled=False)
    if args.quick:
        _quick(over, cfg)
    cfg = cfg.replace(**over)

    try:
        sim = simulation_for(cfg, device=device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    mesh_note = (f" clients_mesh={sim.mesh.size}dev"
                 if sim.mesh is not None else "")
    codec_note = f" codec={cfg.codec}" if cfg.codec != "f32" else ""
    mode_note = (f" mode=async buffer={sim.buffer} "
                 f"max_staleness={cfg.max_staleness}"
                 if cfg.mode == "async" else "")
    topo_note = (f" topology=tree groups={cfg.tree_groups or 'auto'}"
                 if cfg.topology == "tree" else "")
    dp_note = (f" dp=clip{cfg.dp.clip:g}/z{cfg.dp.sigma:g}"
               if cfg.dp is not None and cfg.dp.active else "")
    print(f"# preset={args.preset} model={cfg.model} dataset={cfg.dataset} "
          f"partition={cfg.partition} rounds={cfg.rounds} "
          f"cohort={cfg.clients_per_round}/{cfg.n_clients}"
          f"{mesh_note}{codec_note}{mode_note}{topo_note}{dp_note} "
          f"device={device}",
          flush=True)
    res = sim.run(resume=not args.no_resume, hooks=[_progress_hook])

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
    priv = res.ledger.privacy()
    if priv is not None:
        print(f"[dp   ] eps={priv['epsilon']:.3f} at delta={priv['delta']:g} "
              f"over {priv['rounds']} noised round(s) "
              f"(clip={priv['clip']:g}, z={priv['noise_multiplier']:g})")
    print(f"final_acc={res.final_acc:.3f}  wall={res.wall_s:.1f}s")
    if cfg.out_json:
        path = res.to_json(cfg.out_json)
        print(f"ledger written to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
