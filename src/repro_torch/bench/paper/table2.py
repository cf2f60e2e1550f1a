"""Paper Table 2: upload communication cost to reach 95% of the final
convergence accuracy under Non-IID — FedAvg vs FedProx vs ours (THGS +
sparse secure aggregation) (port of ``benchmarks/table2_comm_cost.py``). The
paper's headline: ours = 2.9%-18.9% of FedAvg upload at sparsity 0.01.

Each arm is one ``repro_torch.sim`` Simulation on ``device`` whose
CommLedger gives the cumulative rounds-to-target upload bits (paper
accounting).
"""
from __future__ import annotations

from repro_torch.bench.paper.common import simulate
from repro_torch.core.types import SecureAggConfig, THGSConfig
from repro_torch.sim.ledger import mib


def _protocol(quick):
    return dict(rounds=12 if quick else 28, n_clients=10,
                clients_per_round=5, noniid_k=4,
                n_train=1500 if quick else 4000, n_test=400,
                eval_every=2)


def run(quick: bool = False, device="cuda"):
    rows = []
    proto = _protocol(quick)
    for model, dataset in (("mnist_mlp", "mnist"),
                           ("mnist_mlp", "fashion_mnist"),
                           ("mnist_cnn", "mnist")):
        if quick and dataset == "fashion_mnist":
            continue
        runs = {}
        runs["fedavg"] = simulate(model, dataset, thgs=None, device=device,
                                  **proto)
        runs["fedprox"] = simulate(model, dataset, thgs=None,
                                   algorithm="fedprox", device=device,
                                   **proto)
        runs["ours"] = simulate(
            model, dataset,
            thgs=THGSConfig(s0=0.05, alpha=0.9, s_min=0.01),
            sa=SecureAggConfig(mask_ratio=0.01), device=device, **proto)

        # rounds to reach 95% of the dense final accuracy (Table 2 protocol)
        target = 0.95 * runs["fedavg"].final_acc
        base_r = (runs["fedavg"].rounds_to_reach(target)
                  or runs["fedavg"].rounds)
        base_bits = runs["fedavg"].ledger.upload_bits_through(base_r)
        for name, r in runs.items():
            reach = r.rounds_to_reach(target)
            rounds_used = reach or r.rounds
            bits = r.ledger.upload_bits_through(rounds_used)
            ratio = bits / base_bits
            rows.append((
                f"table2/{model}-{dataset}/{name}",
                r.wall_s / r.rounds * 1e6,
                f"acc={r.final_acc:.3f};rounds_to_95pct={reach};"
                f"upload_MiB={mib(bits):.1f};vs_fedavg={ratio:.3f};"
                f"compression_x={1/max(ratio,1e-9):.1f}"))
    return rows
