"""Driver of the ``lm_step`` traffic: the port's dense LM training step,
``repro_torch.launch.train.make_dense_train_step``, back to back.

Set-up draws the weights on the device from the seed in one call, in the
configuration's dtype, and loads them into the port's model; every step
trains on a batch of its own, uniform token ids drawn on the device from
(seed, step). The first ``check_steps`` steps, which the reference follows
afterwards, are the warm-up, through the window's own step; the window then
runs whole steps until its time is up (the step under way at the deadline
is finished) and ``train_tokens_per_s`` is the tokens of its steps over
their time.
"""
from __future__ import annotations

import contextlib
import math
import time

import torch

from fedbench.frozen import counts, seeds
from fedbench.harness.trace import WINDOW_SPAN, traced
from fedbench.reference.rounds import precision
from fedbench.reference import transformer as ref_lm


def batch(config: dict, traffic: dict, base: int, step: int, device) -> dict:
    """Step ``step``'s tokens and next-token labels, ``[B, T]`` each."""
    g = torch.Generator(device=device).manual_seed(
        (base * 1_000_003 + step) % 2 ** 63)
    ids = torch.randint(0, config["vocab"],
                        (traffic["batch"], traffic["seq"] + 1),
                        generator=g, device=device, dtype=torch.int64)
    return {"tokens": ids[:, :-1].to(torch.int32),
            "labels": ids[:, 1:].to(torch.int32)}


def weights(config: dict, base: int, device, dtype=None) -> dict:
    gen = torch.Generator(device=device).manual_seed(base)
    return ref_lm.init_params(config, gen, device,
                              dtype or getattr(torch, config["dtype"]))


class Program:
    """The port's model loaded with the benchmark's weights, and its step."""

    def __init__(self, config: dict, traffic: dict, base: int, device):
        import dataclasses

        from repro_torch import configs
        from repro_torch.launch import train
        from repro_torch.models import transformer as tf
        self.train = train
        arch = configs.get(config["port_config"])
        over = {k: config[k] for k in ("n_layers", "d_model", "n_heads",
                                       "n_kv_heads", "d_ff", "vocab",
                                       "dtype")}
        self.arch = dataclasses.replace(arch, **over)
        model = tf.init_params(self.arch, device="meta").to_empty(
            device=device)
        mine = weights(config, base, device)
        have = dict(model.named_parameters())
        if {n: tuple(p.shape) for n, p in have.items()} != {
                n: tuple(t.shape) for n, t in mine.items()}:
            raise ValueError("the port's model is not the configuration's")
        with torch.no_grad():
            for n, p in have.items():
                p.copy_(mine[n])
        del mine
        self.model = model
        self.step = train.make_dense_train_step(
            self.arch, lr=traffic["lr"], n_micro=traffic["n_micro"])

    @contextlib.contextmanager
    def capturing(self, into: list):
        """Keep each step's loss and per-leaf gradient norms."""
        inner = self.train.step_gradients

        def keep(*a, **kw):
            value, grads = inner(*a, **kw)
            into.append((float(value), {n: float(g.double().norm())
                                        for n, g in grads.items()}))
            return value, grads
        self.train.step_gradients = keep
        try:
            yield
        finally:
            self.train.step_gradients = inner

    def change_norms(self, config: dict, base: int, device) -> dict:
        """Each leaf's norm of its change from the initial weights (drawn
        again from the seed)."""
        start = weights(config, base, device)
        out = {n: float((p.double() - start[n].double()).norm())
               for n, p in self.model.named_parameters()}
        del start
        return out


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    config, traffic = cell["config"], cell["traffic"]
    base = seeds.base_seed(seed)
    prog = Program(config, traffic, base, device)
    n_check = traffic["check_steps"]
    checked = check_steps(prog, config, traffic, base, device)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    s, done, failed = n_check, 0, 0
    limit = traffic["trace_steps"] if trace else None
    with traced(trace) as tr:
        with torch.profiler.record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            while True:
                # the step returns the model too: keep no name bound to it
                value = prog.step(prog.model,
                                  batch(config, traffic, base, s, device))[1]
                if not math.isfinite(float(value)):
                    failed += 1
                s, done = s + 1, done + 1
                over = time.perf_counter() - t0 >= seconds
                if over or (limit is not None and done >= limit):
                    break
            _sync(device)
            window_s = time.perf_counter() - t0
    peak = int(torch.cuda.max_memory_allocated(device)) \
        if torch.device(device).type == "cuda" else 0
    tokens = traffic["batch"] * traffic["seq"]
    out = {
        "attempted": done, "failed": failed, "memory_peak_bytes": peak,
        "metrics": {"train_tokens_per_s": tokens * done / window_s,
                    "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
        "trace": tr.trace,
        "ctx": {"units": done,
                "unit_flops": counts.lm_step_flops(config, traffic["batch"],
                                                   traffic["seq"]),
                "peak_flops": counts.PEAK_FLOPS[config["dtype"]],
                "launches": []},
    }
    del prog
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = follow(config, traffic, base, device)
    out["checks"] = compare(checked, ref)
    return out


def check_steps(prog: Program, config: dict, traffic: dict, base: int,
                device) -> dict:
    """Set-up's first steps through the window's own step, kept for the
    reference: each step's loss and gradient norms (``steps``) and each
    leaf's change norm after them (``change``)."""
    steps: list = []
    with prog.capturing(steps):
        for s in range(traffic["check_steps"]):
            prog.step(prog.model, batch(config, traffic, base, s, device))
    return {"steps": steps, "change": prog.change_norms(config, base, device)}


def follow(config: dict, traffic: dict, base: int, device, *,
           prec: str = "float32", fault: str | None = None) -> dict:
    """The reference's own steps from the initial weights on the same
    batches: each step's loss and gradient norms, and the change norms."""
    params = weights(config, base, device, torch.float32)
    steps = []
    with precision("float32"):
        for s in range(traffic["check_steps"]):
            b = batch(config, traffic, base, s, device)
            rows = slice(0, traffic["batch"] // 2) \
                if fault == "half_batch" else None
            value, norms = ref_lm.sgd_step(
                config, params, b["tokens"], b["labels"], traffic["lr"],
                prec=prec, rows=rows, alter=fault == "altered")
            steps.append((value, norms))
    start = weights(config, base, device, torch.float32)
    change = {n: float((params[n].double() - start[n].double()).norm())
              for n in params}
    return {"steps": steps, "change": change}


def compare(prog: dict, ref: dict) -> dict:
    """- ``loss_gap``: the worst step's relative gap of the loss;
    - ``grad_gap``: the first step's gradient, the worst leaf's norm gap;
    - ``change_gap``: the change over the steps, the worst leaf's norm gap.
    Norm gaps over the reference's norm of the leaf or of the median leaf,
    whichever is larger, over the leaves whose reference gradient is at
    least a thousandth of the median leaf's."""
    import statistics
    loss = max(abs(a[0] - b[0]) / abs(b[0])
               for a, b in zip(prog["steps"], ref["steps"]))
    g_ref = ref["steps"][0][1]
    med = statistics.median(g_ref.values())
    leaves = [n for n, v in g_ref.items() if v >= 1e-3 * med]

    def gap(p, r):
        m = statistics.median(r[n] for n in leaves)
        return max(abs(p[n] - r[n]) / max(r[n], m) if max(r[n], m) > 0
                   else (0.0 if p[n] == 0 else math.inf) for n in leaves)
    return {"loss_gap": loss, "grad_gap": gap(prog["steps"][0][1], g_ref),
            "change_gap": gap(prog["change"], ref["change"])}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
