"""Serving example: the batched inference server on an LM workload (port of
``examples/serve_llm.py``).

Requests (fixed-length token prompts) flow through
:class:`repro_torch.serving.InferenceServer` with an
:class:`~repro_torch.serving.LMAdapter` (batched prefill through the flash
kernel + greedy decode with the KV cache written in place), paced by the
open-loop :class:`~repro_torch.serving.LoadGenerator`; the run prints the
``repro.serve/v1`` latency/throughput summary. Weights are random, drawn from
``torch.Generator(device).manual_seed(0)`` at the reference's scales, on the
reduced config the JAX example serves.

Run:  PYTHONPATH=src python -m repro_torch.serving.serve_llm --arch yi-6b
(``--device cpu`` takes the plain PyTorch versions of the kernels; without
it the run needs a CUDA device and exits 1 when there is none).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs, serving
from repro_torch.data import make_lm_tokens
from repro_torch.models import transformer as tf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serving.serve_llm")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4,
                    help="server max_batch (the fixed batch shape)")
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--n-new", type=int, default=16)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--qps", type=float, default=40.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run the plain PyTorch "
              "versions of the kernels", file=sys.stderr)
        return 1

    cfg = configs.reduced(configs.get(args.arch))
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    gen = torch.Generator(device=device).manual_seed(0)
    params = tf.init_params(cfg, gen)
    prompts, _ = make_lm_tokens(cfg.vocab, args.requests, args.prompt_len,
                                seed=1)
    prompts = np.asarray(prompts, np.int32)

    metrics = serving.ServingMetrics(offered_qps=args.qps)
    adapter = serving.LMAdapter(cfg, args.batch, args.prompt_len, args.n_new)
    server = serving.InferenceServer(adapter, params, metrics=metrics)
    loadgen = serving.LoadGenerator(server, prompts, args.qps, metrics=metrics)

    t0 = time.perf_counter()
    server.start()
    try:
        loadgen.run(n_requests=args.requests)
        errors = loadgen.drain()
    finally:
        server.stop()
    dt = time.perf_counter() - t0

    doc = metrics.summary()
    print(f"arch={cfg.name} (reduced)  max_batch={args.batch} "
          f"prompt={args.prompt_len} new={args.n_new} device={device}")
    # replay a few requests synchronously so the output is showable
    for i in range(min(args.requests, args.batch)):
        out = server.submit(prompts[i])
        server.step(block=True)
        print(f"  req{i}: prompt={list(map(int, prompts[i][:8]))}... "
              f"-> generated={list(map(int, out.wait(30.0)))}")
    lat = doc["latency_us"]
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the CPU")
    print(f"{doc['tokens']['generated']} tokens for {doc['requests']['served']}"
          f" requests in {dt:.2f}s ({doc['tokens']['generated'] / dt:.1f}"
          f" tok/s on {where}, {errors} errors)")
    print(f"latency p50={lat['p50'] / 1e3:.1f}ms p99={lat['p99'] / 1e3:.1f}ms "
          f"mean_fill={doc['batches']['mean_fill']:.2f}")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
