"""Driver of the ``fl_round`` traffic: the paper's synchronous round,
``repro_torch.core.fedavg.run_round``, back to back over a fixed horizon.

Set-up makes every input from the seed with the frozen generators (the
dataset, the Non-IID partition, each round's cohort and each participant's
batches for the whole horizon, on the device) and the weights on the device;
it builds the port's simulation engine for the cell, whose model, loss,
settings and backend policy the round runs under, drives the round state
through the traffic's first ``check_rounds`` rounds, which the reference
follows afterwards, and hands the same state to the window. The window
replays the horizon: after its last round it starts again from the initial
state, so every window plays the same rounds in the same order.
``upload_pct`` is counted over the first whole horizon, from the streams the
round emits (its ``leaf_hook``), and the window runs on until that horizon
is done.

After the window the checked rounds' local SGD is held to the reference one
step at a time (:func:`check_local`), and their server side is redone by the
reference on the round's own local updates.
"""
from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from fedbench.frozen import accounting, counts, datasets, federated, seeds
from fedbench.harness.trace import WINDOW_SPAN, traced
from fedbench.reference import rounds as ref_round
from fedbench.reference import vgg


def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """Every input of a run: base seed, weights, and for each round of the
    horizon its cohort and its stacked batches ``x[C, steps, B, ...]``,
    ``y[C, steps, B]`` on ``device``."""
    base = seeds.base_seed(seed)
    spec = datasets.SPECS[traffic["dataset"]]
    if tuple(spec.shape) != tuple(config["input_shape"]):
        raise ValueError(f"{traffic['dataset']} images are {spec.shape}, the "
                         f"configuration takes {config['input_shape']}")
    x, y = datasets.make_dataset(spec, traffic["n_train"], seed=base)
    if traffic["partition"] == "noniid":
        parts = federated.noniid_label_k(y, traffic["n_clients"],
                                         traffic["noniid_k"], seed=base)
    else:
        parts = federated.iid(y, traffic["n_clients"], seed=base)
    sampler = federated.ClientSampler(
        traffic["n_clients"], traffic["clients_per_round"], seed=base)
    rounds = []
    for r in range(traffic["horizon"]):
        cohort = [int(c) for c in sampler.cohort_for(r)]
        xb, yb = zip(*(federated.client_batches(
            x, y, parts[c], traffic["local_batch"], traffic["local_steps"],
            seed=seeds.batch_seed(base, r, c)) for c in cohort))
        rounds.append((cohort,
                       torch.from_numpy(np.stack(xb)).to(device),
                       torch.from_numpy(np.stack(yb).astype(np.int64))
                       .to(device)))
    gen = torch.Generator(device=device).manual_seed(base)
    return {"base": base, "rounds": rounds,
            "params0": vgg.init_params(config, gen, device)}


class Program:
    """The port's round under the cell's settings, and the facts of the
    streams it emitted, one list a round (``emitted``)."""

    def __init__(self, config: dict, traffic: dict, base: int, device):
        from repro_torch.core import fedavg
        from repro_torch.core.types import SecureAggConfig, THGSConfig
        from repro_torch.sim import SimConfig, Simulation
        t, s = traffic.get("thgs"), traffic.get("secagg")
        # the port's own entry: its engine sets the backend policy (TF32,
        # cuDNN's algorithms) and builds the model, loss and settings
        sim = Simulation(SimConfig(
            name="fedbench", model=config["model"],
            dataset=traffic["dataset"], partition=traffic["partition"],
            noniid_k=traffic["noniid_k"], n_train=traffic["n_train"],
            rounds=traffic["horizon"], n_clients=traffic["n_clients"],
            clients_per_round=traffic["clients_per_round"],
            local_steps=traffic["local_steps"],
            local_batch=traffic["local_batch"],
            local_lr=traffic["local_lr"], server_lr=traffic["server_lr"],
            thgs=None if t is None else THGSConfig(**t),
            sa=(SecureAggConfig(enabled=False) if s is None
                else SecureAggConfig(seed=base, **s)),
            seed=base, shard_clients="off"), device=device)
        want = vgg.leaf_shapes(config)
        have = {n: tuple(p.shape) for n, p in sim.model.params().items()}
        if have != want:
            raise ValueError(f"the port's {config['model']} is not the "
                             f"configuration: {have} != {want}")
        self.fedavg = fedavg
        self.loss_fn, self.fed, self.bits = sim.loss_fn, sim.fed, sim.bits
        self.thgs, self.sa = sim.cfg.thgs, sim.cfg.sa
        self.emitted: list = []

    def fresh(self, params0: dict):
        return self.fedavg.init_state(
            {n: p.clone() for n, p in params0.items()}, self.fed)

    def _hook(self, leaf_id, name, info):
        self.emitted[-1].append(
            (min(int(info["k"]), info["size"]), info["size"],
             int(info["streams"].indices.shape[0]),
             int(info["streams"].indices.shape[-1])))

    @contextlib.contextmanager
    def capturing(self, into: list):
        """Keep each local-SGD call's (deltas, losses) on the CPU while the
        block runs: the check rounds' own local updates."""
        inner = self.fedavg.batched_client_update

        def keep(*a, **kw):
            deltas, losses = inner(*a, **kw)
            into.append(({n: d.detach().cpu() for n, d in deltas.items()},
                         [float(v) for v in losses.tolist()]))
            return deltas, losses
        self.fedavg.batched_client_update = keep
        try:
            yield
        finally:
            self.fedavg.batched_client_update = inner

    def local_sgd(self, params: dict, xs, ys, steps: int) -> tuple:
        """The round's own local-SGD call: every client ``steps`` steps from
        ``params`` on its first ``steps`` batches of ``xs[C, steps', ...]``;
        (deltas ``{name: [C, ...]}``, mean losses [C])."""
        deltas, losses = self.fedavg.batched_client_update(
            params, (xs[:, :steps], ys[:, :steps]), self.loss_fn, steps,
            self.fed.local_lr)
        return deltas, [float(v) for v in losses.tolist()]

    def round(self, state, rnd):
        cohort, xs, ys = rnd
        self.emitted.append([])
        batches = {c: (xs[i], ys[i]) for i, c in enumerate(cohort)}
        return self.fedavg.run_round(
            state, batches, self.loss_fn, self.fed, self.thgs, self.sa,
            bits=self.bits, leaf_hook=self._hook if self.thgs else None)


def upload_pct(emitted: list, model_size: int, cohort: int) -> float:
    """Bits uploaded over dense FedAvg's for the same rounds, under the
    frozen paper accounting, from each leaf's stream: ``k`` top-k slots and
    ``(slots - k) / C`` mask slots towards each peer."""
    up = dense = 0
    for leaves in emitted:
        ks, kms = [], []
        for k, size, C, slots in leaves:
            if (slots - k) % C:
                raise ValueError(f"a stream of {slots} slots is not k {k} "
                                 f"plus {C} equal mask blocks")
            ks.append(k)
            kms.append((slots - k) // C)
        up += accounting.round_upload_bits(ks, kms, n_clients=cohort,
                                           n_survivors=cohort)
        dense += accounting.round_dense_bits(model_size, cohort)
    return 100.0 * up / dense


def launches(emitted: list, cohort: int) -> list:
    """The port's kernel launches of the given rounds with their bytes: a
    decode a leaf, the pair masks once a round."""
    out = []
    for leaves in emitted:
        if not leaves:
            continue
        kms = []
        for k, size, C, slots in leaves:
            out.append({"kernel": "stream_scatter_add", "flops": 0,
                        "bytes": counts.stream_scatter_add_bytes(C * slots,
                                                                 size)})
            kms.append((slots - k) // C)
        if any(kms):
            out.append({"kernel": "pair_mask_streams",
                        "flops": counts.pair_mask_streams_ops(cohort, cohort,
                                                              kms),
                        "bytes": counts.pair_mask_streams_bytes(cohort, cohort,
                                                                kms)})
    return out


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    config, traffic = cell["config"], cell["traffic"]
    inputs = make_inputs(config, traffic, seed, device)
    prog = Program(config, traffic, inputs["base"], device)
    rounds, H = inputs["rounds"], traffic["horizon"]
    n_check = traffic["check_rounds"]

    state, checked = check_rounds(prog, inputs, n_check)
    r, done, failed = n_check, 0, 0
    limit = traffic["trace_rounds"] if trace else None
    _sync(device)
    setup_s = time.perf_counter() - t_start

    with traced(trace) as tr:
        with torch.profiler.record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            while True:
                if r == H:
                    state, r = prog.fresh(inputs["params0"]), 0
                state = prog.round(state, rounds[r])
                cohort = rounds[r][0]
                if not all(math.isfinite(state.losses[c]) for c in cohort):
                    failed += 1
                r, done = r + 1, done + 1
                over = time.perf_counter() - t0 >= seconds
                if limit is not None and (done >= limit or over):
                    break
                if limit is None and over and len(prog.emitted) >= H:
                    break
            _sync(device)
            window_s = time.perf_counter() - t0
    peak = _peak(device)
    model_size = sum(v.numel() for v in inputs["params0"].values())
    C = traffic["clients_per_round"]
    out = {
        "attempted": done, "failed": failed, "memory_peak_bytes": peak,
        "metrics": {"round_ms": 1e3 * window_s / done, "setup_s": setup_s,
                    "peak_mem_gib": peak / 2 ** 30},
        "trace": tr.trace,
        "ctx": {"units": done, "unit_flops": counts.vgg_round_flops(
                    config, traffic),
                "peak_flops": counts.PEAK_FLOPS[config["dtype"]],
                "launches": launches(prog.emitted[-done:], C)},
    }
    if traffic.get("thgs") is not None:
        out["metrics"]["upload_pct"] = upload_pct(prog.emitted[:H],
                                                  model_size, C)
    # the program's state goes before the reference runs
    params0 = {n: v.detach().cpu() for n, v in inputs["params0"].items()}
    starts = [params0] + checked["params"][:-1]
    del state, inputs
    prog.emitted.clear()
    _free(device)
    checks = check_local(prog, config, traffic, starts, rounds[:n_check],
                         checked["updates"], device)
    cohorts = [c for c, _, _ in rounds[:n_check]]
    del rounds, prog
    _free(device)
    ref = ref_round.follow_rounds(
        config, traffic, params0,
        [(c, d, ls) for c, (d, ls) in zip(cohorts, checked["updates"])],
        base=seeds.base_seed(seed), device=device)
    checks.update(ref_round.server_gaps(params0, checked["params"], ref))
    out["checks"] = checks
    return out


def check_rounds(prog: Program, inputs: dict, n: int):
    """Set-up's first ``n`` rounds through the window's own round call, the
    round state handed on; kept for the reference: each round's local
    updates and losses (``updates``) and the params after it (``params``)."""
    state = prog.fresh(inputs["params0"])
    checked = {"updates": [], "params": []}
    with prog.capturing(checked["updates"]):
        for r in range(n):
            state = prog.round(state, inputs["rounds"][r])
            checked["params"].append({k: v.detach().cpu()
                                      for k, v in state.params.items()})
    return state, checked


def check_local(prog, config: dict, traffic: dict, starts: list,
                rounds: list, updates: list, device) -> dict:
    """Local SGD of each checked round held to the reference one step at a
    time, from the program's own state: for k = 1 .. K the program's
    local-SGD call of k steps from the round's start (``starts``) on the
    round's first k batches; its step k, the update past the call of k - 1
    steps, and the loss it adds, are held to the reference's one step from
    the params the program reached after k - 1 (``step_loss_gap``,
    ``step_update_gap``). The round's own local updates (``updates``,
    captured in the round) are then held to the call of K steps
    (``routing_gap``): the round gave each client its own batches, in
    order, every step. ``prog`` is the program, or in calibration the
    reference put in its place."""
    K = traffic["local_steps"]
    worst = {"step_loss_gap": 0.0, "step_update_gap": 0.0,
             "routing_gap": 0.0}
    for start, (_, xs, ys), got in zip(starts, rounds, updates):
        p0 = {n: v.to(device) for n, v in start.items()}
        C = xs.shape[0]
        prev = {n: torch.zeros((C,) + v.shape, device=device)
                for n, v in p0.items()}
        m_prev = [0.0] * C
        for k in range(1, K + 1):
            deltas, m = prog.local_sgd(p0, xs, ys, k)
            gaps = ref_round.step_gaps(config, traffic, {
                "params": {n: p0[n] + prev[n] for n in p0},
                "deltas": {n: deltas[n] - prev[n] for n in p0},
                "losses": [k * a - (k - 1) * b for a, b in zip(m, m_prev)],
                "x": xs[:, k - 1], "y": ys[:, k - 1]}, device=device)
            for name, v in gaps.items():
                worst[name] = max(worst[name], v)
            prev, m_prev = deltas, m
        worst["routing_gap"] = max(worst["routing_gap"], ref_round.routing_gap(
            got, ({n: v.detach().cpu() for n, v in prev.items()}, m_prev)))
        del p0, prev
    return worst


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
