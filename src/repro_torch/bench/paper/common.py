"""Protocol -> ``repro_torch.sim`` adapter for the paper-scale drivers (port
of ``benchmarks/common.py``).

The multi-round driver is ``repro_torch.sim.Simulation``; this module only
translates the drivers' protocol kwargs (the paper's §5 setup: client
population, Non-IID partitioning, local steps and batch sizes follow the
paper; rounds and dataset sizes are reduced) into a :class:`SimConfig` equal
field for field to the reference's, and runs it on ``device``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.types import SecureAggConfig, THGSConfig
from repro_torch.sim import SimConfig, SimResult, Simulation


def sim_config(
    model_name: str = "mnist_mlp",
    dataset: str = "mnist",
    *,
    thgs: Optional[THGSConfig],
    sa: SecureAggConfig = SecureAggConfig(enabled=False),
    algorithm: str = "fedavg",
    rounds: int = 30,
    n_clients: int = 20,
    clients_per_round: int = 5,
    noniid_k: Optional[int] = None,
    n_train: int = 4000,
    n_test: int = 800,
    local_steps: int = 5,
    local_batch: int = 50,
    lr: float = 0.05,
    eval_every: int = 3,
    seed: int = 0,
    label: str = "",
) -> SimConfig:
    """The drivers' protocol-kwarg surface, as a SimConfig."""
    return SimConfig(
        name=label or f"{model_name}:{algorithm}"
        f"{':thgs' if thgs else ''}{':sa' if sa.enabled else ''}",
        model=model_name,
        dataset=dataset,
        partition="iid" if noniid_k is None else "noniid",
        noniid_k=noniid_k if noniid_k is not None else 4,
        n_train=n_train,
        n_test=n_test,
        rounds=rounds,
        n_clients=n_clients,
        clients_per_round=clients_per_round,
        local_steps=local_steps,
        local_batch=local_batch,
        local_lr=lr,
        algorithm=algorithm,
        prox_mu=0.01 if algorithm == "fedprox" else 0.0,
        thgs=thgs,
        sa=sa,
        eval_every=eval_every,
        seed=seed,
    )


def simulate(model_name: str = "mnist_mlp", dataset: str = "mnist", *,
             device="cuda", **protocol) -> SimResult:
    """Build the SimConfig and run it through the sim engine on
    ``device``."""
    return Simulation(sim_config(model_name, dataset, **protocol),
                      device=device).run()
