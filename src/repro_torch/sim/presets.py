"""Named experiment presets for ``python -m repro_torch.sim`` — the presets of
``repro.sim.presets`` that this slice of the port runs (sync, flat, f32, no
DP). Each is the reference's configuration field for field.
"""
from __future__ import annotations

from repro_torch.core.types import SecureAggConfig, THGSConfig
from repro_torch.sim.config import SimConfig

# the paper's mechanism settings used across Table 2 (s = 0.01 regime)
_THGS = THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
_SA = SecureAggConfig(mask_ratio=0.01)


def _table2(quick: bool) -> dict:
    """The Table 2 protocol (Non-IID-4, 10 clients, 5 per round)."""
    return dict(
        partition="noniid", noniid_k=4, n_clients=10, clients_per_round=5,
        rounds=12 if quick else 28, n_train=1500 if quick else 4000,
        n_test=400, eval_every=2, local_steps=5, local_batch=50,
        local_lr=0.05)


PRESETS: dict[str, SimConfig] = {
    "quickstart": SimConfig(
        name="quickstart", partition="noniid", noniid_k=4,
        n_clients=10, clients_per_round=5, rounds=30, n_train=4000,
        n_test=800, eval_every=5, thgs=_THGS, sa=_SA),
    # Table 2 "ours" arm: the paper's round, the port's main path
    "table2_quick": SimConfig(
        name="table2_quick", thgs=_THGS, sa=_SA,
        out_json="experiments/sim/table2_quick.json", **_table2(True)),
    "table2": SimConfig(
        name="table2", thgs=_THGS, sa=_SA,
        out_json="experiments/sim/table2.json", **_table2(False)),
    "table2_fedavg_quick": SimConfig(
        name="table2_fedavg_quick", thgs=None,
        sa=SecureAggConfig(enabled=False),
        out_json="experiments/sim/table2_fedavg_quick.json", **_table2(True)),
    "fig1_s001_quick": SimConfig(
        name="fig1_s001_quick", partition="iid", n_clients=10,
        clients_per_round=5, rounds=10, n_train=1200, n_test=400,
        eval_every=2, sa=SecureAggConfig(enabled=False),
        thgs=THGSConfig(s0=0.01, alpha=1.0, s_min=0.01, time_varying=False),
        out_json="experiments/sim/fig1_s001_quick.json"),
    # secure-aggregation protocol with injected dropout and recovery
    "secagg_quick": SimConfig(
        name="secagg_quick", partition="noniid", noniid_k=4, n_clients=12,
        clients_per_round=6, rounds=8, n_train=1200, n_test=400,
        eval_every=2, local_steps=3, local_batch=32, thgs=_THGS,
        sa=SecureAggConfig(mask_ratio=0.01, threshold=0.6),
        dropout_rate=0.25, seed=11,
        out_json="experiments/sim/secagg_quick.json"),
    "dropout_quick": SimConfig(
        name="dropout_quick", partition="noniid", noniid_k=4, n_clients=12,
        clients_per_round=5, rounds=8, n_train=1200, n_test=400,
        eval_every=2, thgs=_THGS, sa=_SA, sampler="weighted",
        weight_by_data_count=True, dropout_rate=0.2,
        out_json="experiments/sim/dropout_quick.json"),
    "ci_smoke": SimConfig(
        name="ci_smoke", partition="noniid", noniid_k=4, n_clients=6,
        clients_per_round=4, rounds=3, n_train=400, n_test=200,
        local_steps=2, local_batch=16, eval_every=1, thgs=_THGS, sa=_SA,
        out_json="experiments/sim/ci_smoke.json"),
}


def names() -> list[str]:
    return sorted(PRESETS)


def get(name: str) -> SimConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {', '.join(names())}"
        ) from None
