"""Serving benchmarks (suite key ``serve`` -> BENCH_torch_serve.json; port of
``repro.bench.serve_bench``).

The serving-path trajectory of DESIGN.md §16, four timed regions:

* ``serve/infer_*`` — the classifier batch
  (:class:`~repro_torch.serving.server.ClassifierAdapter` on the Table-1
  MLP): one fixed-shape ``[max_batch, ...]`` apply, the server's data plane.
* ``serve/swap_pause`` — the double-buffered weight hot swap
  (``hot_swap.WeightBuffers``): staging happens off the serve path, so the
  pause a request can observe is the pointer flip alone. Reported as the min
  of the swap's own pause stamps; it sits far below the gate's 20 µs noise
  floor by construction.
* ``serve/e2e_p50`` / ``serve/e2e_p99`` — end-to-end request latency
  (submit -> response) through the real server thread + open-loop loadgen
  at a fixed offered QPS, min over reps of each run's nearest-rank
  percentile; a ``serve/sustained_qps`` info row carries the achieved
  throughput of the best rep.
* ``serve/decode_*`` — batched greedy generation
  (:class:`~repro_torch.serving.server.LMAdapter`, the KV cache written in
  place) on the reduced Yi-6B config: one prefill (the flash kernel's f32
  instance at head dim 64 on the card) + ``n_new - 1`` decode steps;
  derived reports tok/s.

All timed entries are min-of-reps (``timing.measure`` or the min over
per-run statistics); the e2e rows assert the zero-dropped-requests invariant
before reporting, so a broken server can't publish a latency. Each rep's
server, adapter and weights are freed before the next suite runs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.bench.timing import entry, measure, sync
from repro_torch.data import make_lm_tokens
from repro_torch.models import transformer as tf
from repro_torch.models.paper_models import build_model
from repro_torch.serving import (ClassifierAdapter, InferenceServer,
                                 LMAdapter, LoadGenerator, ServingMetrics,
                                 WeightBuffers)
from repro_torch.serving.metrics import percentile

MODEL = "mnist_mlp"
ARCH = "yi_6b"
MAX_BATCH = 8


def _classifier(seed: int, device):
    model = build_model(MODEL).init_(torch.Generator().manual_seed(seed))
    params = {n: p.detach().to(device) for n, p in model.params().items()}
    return model, params


def _classifier_entries(reps: int, device) -> list[dict]:
    model, params = _classifier(0, device)
    adapter = ClassifierAdapter(model, MAX_BATCH)
    rng = np.random.RandomState(0)
    stack = torch.from_numpy(
        rng.randn(MAX_BATCH, *model.input_shape).astype(np.float32))

    def infer():
        out = adapter.infer(params, stack)
        sync(device)
        return out

    us = measure(infer, reps)
    rows = [entry(f"serve/infer_{MODEL}_b{MAX_BATCH}", us,
                  f"{MAX_BATCH / (us / 1e6):.0f}_req_per_s", reps=reps)]

    # hot-swap pause: stage off-path, then flip; min of the swap's own stamps
    buffers = WeightBuffers(params, step=0)
    pauses = []
    for _ in range(max(3, reps)):
        buffers.stage(buffers.active_step + 1, params)
        pauses.append(buffers.swap())
    rows.append(entry("serve/swap_pause", min(pauses),
                      "pointer_flip_between_batches", reps=max(3, reps)))
    return rows


def _e2e_rep(model, params, n_req: int, qps: float):
    """One serve run: server thread + open-loop loadgen, no training.
    Returns (p50_us, p99_us, sustained_qps)."""
    metrics = ServingMetrics(offered_qps=qps)
    server = InferenceServer(ClassifierAdapter(model, MAX_BATCH), params,
                             metrics=metrics)
    rng = np.random.RandomState(1)
    payloads = rng.randn(32, *model.input_shape).astype(np.float32)
    gen = LoadGenerator(server, payloads, qps, metrics=metrics)
    server.start()
    try:
        n = gen.run(n_requests=n_req)
        errors = gen.drain()
    finally:
        server.stop()
    if errors or metrics.errors:
        raise AssertionError(
            f"e2e bench dropped requests ({errors} drain errors, "
            f"{metrics.errors} server errors)")
    if metrics.served != n:
        raise AssertionError(f"e2e bench served {metrics.served} of {n} "
                             "submitted requests")
    lats = sorted(metrics.latencies_us)
    # wall_s is stamped by the loadgen (pacing start -> fully drained)
    sustained = metrics.served / max(metrics.wall_s, 1e-9)
    return (percentile(lats, 50), percentile(lats, 99), sustained)


def _e2e_entries(n_req: int, qps: float, reps: int, device) -> list[dict]:
    model, params = _classifier(1, device)
    runs = [_e2e_rep(model, params, n_req, qps) for _ in range(max(3, reps))]
    p50 = min(r[0] for r in runs)
    p99 = min(r[1] for r in runs)
    sustained = max(r[2] for r in runs)
    tag = f"{MODEL}_q{qps:g}"
    return [
        entry(f"serve/e2e_p50_{tag}", p50, f"n{n_req}_per_run",
              reps=max(3, reps)),
        entry(f"serve/e2e_p99_{tag}", p99, f"n{n_req}_per_run",
              reps=max(3, reps)),
        entry(f"serve/sustained_qps_{tag}", 0.0,
              f"{sustained:.0f}_req_per_s_offered{qps:g}"),
    ]


def _decode_entries(batch: int, prompt_len: int, n_new: int, reps: int,
                    device) -> list[dict]:
    cfg = configs.reduced(configs.get(ARCH))
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            device=device)
    adapter = LMAdapter(cfg, batch, prompt_len, n_new)
    prompts, _ = make_lm_tokens(cfg.vocab, batch, prompt_len, seed=1)
    stack = torch.from_numpy(np.asarray(prompts, np.int32))

    def generate():
        out = adapter.infer(params, stack)
        sync(device)
        return out

    us = measure(generate, reps)
    del adapter, params
    toks = batch * n_new
    return [entry(f"serve/decode_{ARCH}_b{batch}_n{n_new}", us,
                  f"{toks / (us / 1e6):.0f}_tok_per_s", reps=reps)]


def entries(quick: bool = False, device="cuda") -> list[dict]:
    device = torch.device(device)
    if quick:
        reps, n_req, qps, n_new = 3, 120, 150.0, 8
    else:
        reps, n_req, qps, n_new = 5, 400, 200.0, 16
    out = _classifier_entries(reps, device)
    out += _e2e_entries(n_req, qps, reps, device)
    out += _decode_entries(4, 16, n_new, reps, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out

