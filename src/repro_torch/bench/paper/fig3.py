"""Paper Fig. 3: THGS (hierarchical, time-varying) vs conventional flat
sparsification under Non-IID-4/6/8, attenuation beta in {0.2, 0.5, 0.8}
(port of ``benchmarks/fig3_thgs_vs_flat.py``), on ``repro_torch.sim``. The
paper's claim: THGS >= flat everywhere, and the gap to dense closes as
beta -> 0.8."""
from __future__ import annotations

from repro_torch.bench.paper.common import simulate
from repro_torch.core.types import THGSConfig


def run(quick: bool = False, device="cuda"):
    rows = []
    proto = dict(rounds=12 if quick else 20, n_clients=10, clients_per_round=5,
                 n_train=1500 if quick else 3000, n_test=400, eval_every=2)
    noniids = (4,) if quick else (4, 6, 8)
    betas = (0.8,) if quick else (0.2, 0.5, 0.8)
    for k in noniids:
        dense = simulate("mnist_mlp", "mnist", thgs=None, noniid_k=k,
                         device=device, **proto)
        rows.append((f"fig3/noniid{k}/dense", dense.wall_s / dense.rounds * 1e6,
                     f"final_acc={dense.final_acc:.3f}"))
        for beta in betas:
            flat = simulate(  # conventional: one global rate, no hierarchy
                "mnist_mlp", "mnist",
                thgs=THGSConfig(s0=0.05, alpha=1.0, s_min=0.05,
                                alpha_t=beta, time_varying=True),
                noniid_k=k, device=device, **proto)
            thgs = simulate(  # ours: hierarchical layer schedule (Eq. 1)
                "mnist_mlp", "mnist",
                thgs=THGSConfig(s0=0.08, alpha=0.6, s_min=0.02,
                                alpha_t=beta, time_varying=True),
                noniid_k=k, device=device, **proto)
            rows.append((
                f"fig3/noniid{k}/beta={beta}",
                thgs.wall_s / thgs.rounds * 1e6,
                f"flat_acc={flat.final_acc:.3f};thgs_acc={thgs.final_acc:.3f};"
                f"dense_acc={dense.final_acc:.3f};"
                f"thgs_beats_flat={thgs.final_acc >= flat.final_acc - 0.02}"))
    return rows
