"""Paper Fig. 1 (+Fig. 2): aggregation-model accuracy under sparsification
at s = 1 (dense), 0.1, 0.01, 0.001 — IID and Non-IID (port of
``benchmarks/fig1_sparsity_accuracy.py``), on ``repro_torch.sim``."""
from __future__ import annotations

from repro_torch.bench.paper.common import simulate
from repro_torch.core.types import SecureAggConfig, THGSConfig


def run(quick: bool = False, device="cuda"):
    rows = []
    proto = dict(rounds=10 if quick else 24, n_clients=10, clients_per_round=5,
                 n_train=1200 if quick else 3000, n_test=400, eval_every=2)
    sweeps = [None, 0.1, 0.01] if quick else [None, 0.1, 0.01, 0.001]
    for noniid in (None, 4):
        tag = "iid" if noniid is None else f"noniid{noniid}"
        for s in sweeps:
            thgs = None if s is None else THGSConfig(
                s0=s, alpha=1.0, s_min=s, time_varying=False)
            r = simulate("mnist_mlp", "mnist", thgs=thgs,
                         sa=SecureAggConfig(enabled=False),
                         noniid_k=noniid, device=device, **proto)
            comp = r.ledger.totals("paper")["compression_x"] or 1.0
            rows.append((
                f"fig1/{tag}/s={s if s else 'dense'}",
                r.wall_s / r.rounds * 1e6,
                f"final_acc={r.final_acc:.3f};"
                f"acc_curve={','.join(f'{a:.2f}' for a in r.accuracies)};"
                f"compression_x={comp:.1f}"))
    return rows
