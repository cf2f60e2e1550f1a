"""CLI: the continuous train -> checkpoint -> hot-swap serving loop (port of
``python -m repro.serving``).

    python -m repro_torch.serving --preset table2_quick --quick --qps 50 \\
        --out serve_metrics.json

Trains a sync ``repro_torch.sim`` preset in the main thread while an
inference server (a background thread) answers classifier requests paced by
an open-loop load generator (another thread). Every finished round publishes
the params (``publish_params_hook``); the server's ``CheckpointWatcher``
stages each on its own thread — on the card through its own CUDA stream —
and the server swaps between batches. After training the loop waits until
the final published step is active, drains the load generator and writes
one ``repro.serve/v1`` metrics document.

It runs on ``cuda`` unless ``--device cpu`` is given, and exits non-zero
without a CUDA device, when any request was dropped or errored, or (unless
``--allow-no-swap``) when no hot swap happened.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving",
        description="Concurrent federated training + hot-swap serving.")
    ap.add_argument("--preset", default="table2_quick",
                    help="repro_torch.sim preset to train "
                         "(default %(default)s)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--quick", action="store_true",
                    help="shrink the training run (3 rounds, small data)")
    ap.add_argument("--qps", type=float, default=50.0,
                    help="offered load (open loop; default %(default)s)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="server batch size (default %(default)s)")
    ap.add_argument("--publish-dir", default=None,
                    help="checkpoint publish directory (default: a "
                         "temporary one, removed at the end)")
    ap.add_argument("--publish-every", type=int, default=1,
                    help="publish every N rounds (default %(default)s)")
    ap.add_argument("--out", default=None,
                    help="write the repro.serve/v1 metrics JSON here")
    ap.add_argument("--settle-s", type=float, default=30.0,
                    help="max wait for the final checkpoint swap")
    ap.add_argument("--allow-no-swap", action="store_true",
                    help="exit 0 even when no hot swap happened")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    from repro_torch import serving
    from repro_torch.sim import Simulation, presets, publish_params_hook
    from repro_torch.sim.engine import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        cfg = presets.get(args.preset)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if cfg.mode != "sync":
        print(f"error: preset {args.preset!r} is mode={cfg.mode!r}; the "
              "serve loop trains the sync engine", file=sys.stderr)
        return 2
    over: dict = {"ckpt_dir": None, "ckpt_every": 0, "out_json": None}
    if args.rounds is not None:
        over["rounds"] = args.rounds
    if args.seed is not None:
        over["seed"] = args.seed
    if args.quick:
        over.setdefault("rounds", min(3, cfg.rounds))
        over["n_train"] = min(600, cfg.n_train)
        over["n_test"] = min(200, cfg.n_test)
        over["eval_every"] = 1
    cfg = cfg.replace(**over)

    owns_dir = args.publish_dir is None
    publish_dir = args.publish_dir or tempfile.mkdtemp(prefix="repro_serve_")
    sim = Simulation(cfg, device=device)
    # the server starts on the sim's own initial weights (a copy: training
    # never writes the tensors the server reads)
    init_params = {n: p.detach().clone()
                   for n, p in sim.model.params().items()}

    metrics = serving.ServingMetrics(offered_qps=args.qps)
    buffers = serving.WeightBuffers(init_params, step=0)
    watcher = serving.CheckpointWatcher(publish_dir, init_params, buffers,
                                        metrics=metrics)
    server = serving.InferenceServer(
        serving.ClassifierAdapter(sim.model, args.max_batch),
        watcher=watcher, metrics=metrics)
    # request pool: the sim's own test split, cycled by request index
    payloads = sim.xt.cpu().numpy()
    loadgen = serving.LoadGenerator(server, payloads, args.qps,
                                    metrics=metrics)

    print(f"# serve: preset={args.preset} rounds={cfg.rounds} "
          f"model={cfg.model} qps={args.qps:g} max_batch={args.max_batch} "
          f"device={device} publish_dir={publish_dir}", flush=True)
    t0 = time.perf_counter()
    watcher.start()
    server.start()
    loadgen.start()                      # open loop until stopped
    try:
        res = sim.run(resume=False,
                      hooks=[publish_params_hook(publish_dir,
                                                 every=args.publish_every)])
        train_s = time.perf_counter() - t0
        served_training = metrics.served
        # settle: serve until the final published checkpoint is active
        deadline = time.perf_counter() + args.settle_s
        target = cfg.rounds - (cfg.rounds % max(1, args.publish_every))
        while (buffers.active_step < target
               and time.perf_counter() < deadline):
            time.sleep(0.05)
    finally:
        loadgen.stop()                   # pace off + drain every in-flight
        server.stop()
        watcher.stop()
        if owns_dir:
            shutil.rmtree(publish_dir, ignore_errors=True)
    metrics.wall_s = time.perf_counter() - t0

    doc = metrics.summary()
    errs = serving.validate_metrics(doc)
    if errs:
        print("metrics schema errors: " + "; ".join(errs), file=sys.stderr)
        return 1
    req, lat, sw = doc["requests"], doc["latency_us"], doc["swaps"]
    print(f"trained {cfg.rounds} rounds in {train_s:.3f} s "
          f"(final_acc={res.final_acc:.3f}) while serving {req['served']} "
          f"requests, {served_training} of them before training ended "
          f"({doc['qps']['sustained']:.1f}/s sustained, "
          f"{req['errors']} errors)")
    print(f"latency p50={lat['p50']:.0f}us p99={lat['p99']:.0f}us  "
          f"swaps={sw['count']} (pause p50={sw['pause_us']['p50']:.1f}us "
          f"max={sw['pause_us']['max']:.1f}us)  "
          f"staleness mean={doc['staleness']['mean']:.2f} "
          f"max={doc['staleness']['max']}  active_step={buffers.active_step}")
    if args.out:
        metrics.to_json(args.out)
        print(f"metrics written to {args.out}")
    if req["errors"]:
        print(f"error: {req['errors']} dropped/errored request(s)",
              file=sys.stderr)
        return 1
    if not sw["count"] and not args.allow_no_swap:
        print("error: no hot swap happened (training published nothing the "
              "server picked up)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
