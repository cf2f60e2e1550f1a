"""Plain rounds of the paper's protocol on the program's own local updates:
THGS top-k with error feedback (Alg. 1, Eq. 1-2), sparse pair masks (Eq.
3-5) and the server's update; plain local SGD; and the numbers that
``correct`` is decided on.

Local SGD at the cell's settings is chaotic in f32: one step's gradient
already moves by up to a few per cent between two f32 programs (a max-pool
whose window holds two near-equal values routes its gradient by the last
bit, and the last block pools 2x2 maps), and five steps at lr 0.05 carry
that to tens of per cent, between two plain references too. So the
reference follows the program's own state: it takes each local step from
the parameters the program reached before it (:func:`step_gaps`), and it
redoes the server's side of each round on the program's own local updates
(:func:`follow_rounds`).

A client's unified stream transmits its accumulator ``residual + delta`` at
the union of its top-k positions and its mask slots' positions (the masks
of a pair cancel in the server's sum, so the sum is the accumulators over
each client's support); the transmitted positions leave its residual. With
THGS off the round is dense FedAvg: the mean of the deltas.

``precision`` is the reference's own ("float32", TF32 off) or the control's
("tf32"). Faults of the timed path, planted in the reference put in its
place: in local SGD (:data:`LOCAL_FAULTS`, :func:`local_sgd`)
"half_batch" (every step on half its batch, the mean over the rest) and
"stale_batch" (the steps after the first on the first step's batch); in
the round, "swapped" (each client trained on the next client's batches,
applied by the caller); on the server's side (:data:`SERVER_FAULTS`,
:func:`follow_rounds`) "no_exchange" (the server sums the first
participant's stream alone) and "altered" (one transmitted value of the
first participant altered by +1 in every leaf). Imports nothing of the
program.
"""
from __future__ import annotations

import contextlib
import math
import statistics

import numpy as np
import torch

from fedbench.frozen import accounting, secagg_masks
from fedbench.reference import vgg

LOCAL_FAULTS = ("half_batch", "stale_batch")
SERVER_FAULTS = ("no_exchange", "altered")


@contextlib.contextmanager
def precision(name: str):
    """TF32 off for "float32", on for the control's "tf32"."""
    tf32 = name == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _support(acc: torch.Tensor, k: int, mask_pos: np.ndarray | None):
    """Boolean support of one client's leaf: its top-|acc| positions and its
    mask positions."""
    flat = acc.reshape(-1)
    sup = torch.zeros(flat.numel(), dtype=torch.bool, device=flat.device)
    sup[torch.topk(flat.abs(), min(k, flat.numel()), sorted=False).indices] = True
    if mask_pos is not None:
        sup[torch.from_numpy(mask_pos).to(flat.device)] = True
    return sup.reshape(acc.shape)


def local_sgd(config: dict, traffic: dict, params: dict, xs, ys, *,
              prec: str = "float32", fault: str | None = None,
              device="cuda") -> dict:
    """Every client's local SGD over its batches ``xs[C, steps, B, ...]``,
    all from ``params``: ``{"deltas": {name: [C, ...]}, "losses": [C]}``,
    each loss the mean over the steps, as the program reports it."""
    if fault is not None and fault not in LOCAL_FAULTS:
        raise ValueError(f"unknown local fault {fault!r}")
    params = {n: v.to(device, torch.float32) for n, v in params.items()}
    out, losses = [], []
    with precision(prec):
        for ci in range(xs.shape[0]):
            x, y = xs[ci].to(device), ys[ci].to(device)
            if fault == "half_batch":
                x, y = x[:, : x.shape[1] // 2], y[:, : y.shape[1] // 2]
            elif fault == "stale_batch":
                x, y = x[:1].expand(x.shape), y[:1].expand(y.shape)
            d, lv = vgg.local_sgd(config, params, x, y, traffic["local_lr"])
            out.append(d)
            losses.append(lv)
    return {"deltas": {n: torch.stack([d[n] for d in out]) for n in params},
            "losses": losses}


def step_gaps(config: dict, traffic: dict, step: dict,
              device="cuda") -> dict:
    """One local step of every client, held to the reference's step from
    the same parameters on the same batch. ``step``: the parameters each
    client started the step from (``params``, ``{name: [C, ...]}``), the
    program's update (``deltas``, the same shapes) and loss (``losses``,
    [C]) of the step, and its batch (``x [C, B, ...]``, ``y [C, B]``).

    - ``step_loss_gap``: the worst client's relative gap of the loss;
    - ``step_update_gap``: the worst client's worst leaf's norm gap of the
      update, over the leaves the reference's update moves."""
    loss = upd = 0.0
    with precision("float32"):
        for ci in range(step["x"].shape[0]):
            p = {n: v[ci].to(device, torch.float32)
                 for n, v in step["params"].items()}
            d, lv = vgg.local_sgd(config, p, step["x"][ci:ci + 1].to(device),
                                  step["y"][ci:ci + 1].to(device),
                                  traffic["local_lr"])
            loss = max(loss, abs(step["losses"][ci] - lv) / abs(lv))
            mine = {n: v[ci] for n, v in step["deltas"].items()}
            upd = max(upd, max(_gaps(mine, d, {n: torch.zeros_like(v)
                                               for n, v in d.items()})))
    return {"step_loss_gap": loss, "step_update_gap": upd}


def follow_rounds(config: dict, traffic: dict, params0: dict, rounds: list,
                  *, base: int, fault: str | None = None,
                  device="cuda") -> list:
    """The server's side of the first rounds, on the program's own local
    updates: ``rounds[r] = (cohort, {name: deltas [C, ...]}, losses [C])``.
    Returns the params after each round (on the CPU)."""
    if fault is not None and fault not in SERVER_FAULTS:
        raise ValueError(f"unknown server fault {fault!r}")
    thgs, sa = traffic.get("thgs"), traffic.get("secagg")
    names = list(vgg.leaf_shapes(config))
    params = {n: params0[n].to(device, torch.float32) for n in names}
    sizes = [params[n].numel() for n in names]
    residuals: dict = {}
    last_loss: dict = {}
    out = []
    for t, (cohort, deltas, losses) in enumerate(rounds):
        cohort = [int(c) for c in cohort]
        C = len(cohort)
        senders = cohort[:1] if fault == "no_exchange" else cohort
        if thgs is None:
            agg = {n: sum(deltas[n][cohort.index(c)].to(device)
                          for c in senders) / C for n in names}
            if fault == "altered":
                for n in names:
                    agg[n].view(-1)[0] += 1.0 / C
        else:
            prev = [last_loss[c] for c in cohort if c in last_loss]
            loss_prev = sum(prev) / len(prev) if prev else None
            loss_curr = sum(losses) / C
            ks = accounting.leaf_ks(thgs, sizes, t, traffic["horizon"],
                                    loss_prev, loss_curr)
            seeds = None
            if sa is not None and C >= 2:
                seeds, _ = secagg_masks.seed_matrix(base, cohort, t)
            agg = {}
            for leaf_id, (n, k, size) in enumerate(zip(names, ks, sizes)):
                total = torch.zeros_like(params[n])
                for ci, c in enumerate(cohort):
                    d = deltas[n][ci].to(device, torch.float32)
                    res = residuals.get(c, {}).get(n)
                    acc = d if res is None else res + d
                    pos = None
                    if seeds is not None:
                        km = accounting.k_mask_for(size, sa["mask_ratio"], C)
                        pos = secagg_masks.client_mask_support(
                            seeds, leaf_id, ci, km, size, p=sa["p"], q=sa["q"])
                    sup = _support(acc, k, pos)
                    sent = torch.where(sup, acc, 0.0)
                    if fault == "altered" and ci == 0:
                        first = int(torch.nonzero(sup.reshape(-1))[0])
                        sent.view(-1)[first] += 1.0
                    if c in senders:
                        total = total + sent
                    residuals.setdefault(c, {})[n] = acc - sent
                agg[n] = total / C
        last_loss.update(zip(cohort, losses))
        params = {n: params[n] + traffic["server_lr"] * agg[n] for n in names}
        out.append({n: v.detach().cpu() for n, v in params.items()})
    return out


# ------------------------------------------------------------ the numbers
def leaf_norms(tree: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tree.items()}


def moved_leaves(ref_update: dict) -> list:
    """Leaves the reference moves: an update norm at least a thousandth of
    the median leaf's (a conv bias under BatchNorm moves by round-off)."""
    norms = leaf_norms(ref_update)
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= 1e-3 * med]


def norm_gaps(prog: dict, ref: dict, leaves: list) -> list:
    """Each leaf's gap between the two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    pn, rn = leaf_norms({n: prog[n] for n in leaves}), leaf_norms(
        {n: ref[n] for n in leaves})
    med = statistics.median(rn.values())
    return [abs(pn[n] - rn[n]) / max(rn[n], med) for n in leaves]


def _gaps(prog: dict, ref: dict, base: dict, leaves=None) -> list:
    p0 = {n: v.double() for n, v in base.items()}
    rd = {n: ref[n].double() - p0[n] for n in p0}
    leaves = leaves if leaves is not None else moved_leaves(rd)
    return norm_gaps({n: prog[n].double() - p0[n] for n in p0}, rd, leaves)


def routing_gap(round_updates: tuple, chain_updates: tuple) -> float:
    """The round's own local updates, ``(deltas {name: [C, ...]}, losses
    [C])``, against those of the same local-SGD call on the batches the
    benchmark gave each client: the worst client's worst leaf's norm of the
    difference over the norm of that leaf or of the median leaf, whichever
    is larger, or the worst relative gap of the losses. 0 where the round
    handed every client its own batches, in order."""
    (rd, rl), (cd, cl) = round_updates, chain_updates
    def ratio(a: float, b: float) -> float:
        return a / b if b > 0 else (0.0 if a == 0 else math.inf)
    worst = max(ratio(abs(a - b), abs(b)) for a, b in zip(rl, cl))
    for ci in range(len(cl)):
        norms = {n: float(v[ci].double().norm()) for n, v in cd.items()}
        med = statistics.median(norms.values())
        worst = max(worst, max(ratio(
            float((rd[n][ci].double() - cd[n][ci].double()).norm()),
            max(norms[n], med)) for n in cd))
    return worst


def server_gaps(params0: dict, prog: list, ref: list) -> dict:
    """The program's params after each checked round (``prog``) against the
    reference's rounds on the program's own local updates (``ref``).

    - ``round_gap``: the worst round's worst leaf's norm gap of the
      server's update (each round from the params both sides started it
      at);
    - ``change_gap``: the worst leaf's norm gap of the change over all the
      rounds.

    Norm gaps are over the leaves the reference's first update moves."""
    leaves = moved_leaves({n: ref[0][n].double() - params0[n].double()
                           for n in params0})
    starts = [params0] + ref[:-1]
    rnd = max(max(_gaps(prog[r], ref[r], starts[r], leaves))
              for r in range(len(ref)))
    change = max(_gaps(prog[-1], ref[-1], params0, leaves))
    return {"round_gap": rnd, "change_gap": change}
