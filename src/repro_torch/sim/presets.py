"""Named experiment presets for ``python -m repro_torch.sim`` — the presets of
``repro.sim.presets`` that the port runs (synchronous flat and tree, async),
and the codec and DP sweeps. Each is the reference's configuration field for
field.
"""
from __future__ import annotations

from repro_torch.core.dp import DPConfig
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
    # FedBuff-style async: buffered staleness-weighted updates with
    # counter-based staleness draws; the ledger carries the staleness facts
    "async_quick": SimConfig(
        name="async_quick", partition="noniid", noniid_k=4, n_clients=12,
        clients_per_round=4, rounds=8, n_train=1200, n_test=400,
        eval_every=2, local_steps=3, local_batch=32, thgs=_THGS,
        sa=SecureAggConfig(enabled=False), mode="async", buffer_size=4,
        max_staleness=3, seed=5,
        out_json="experiments/sim/async_quick.json"),
    # hierarchical decode over 3 sub-aggregators, bit-equal to flat, on a
    # multi-round secagg + dropout path
    "tree_quick": SimConfig(
        name="tree_quick", partition="noniid", noniid_k=4, n_clients=12,
        clients_per_round=6, rounds=8, n_train=1200, n_test=400,
        eval_every=2, local_steps=3, local_batch=32, thgs=_THGS,
        sa=SecureAggConfig(mask_ratio=0.01, threshold=0.6),
        dropout_rate=0.25, seed=11, topology="tree", tree_groups=3,
        out_json="experiments/sim/tree_quick.json"),
    # distributed DP under secure aggregation: the secagg_quick protocol with
    # per-client L2 clipping and grid-rounded Gaussian noise under the pair
    # masks; the ledger carries the composed (epsilon, delta)
    "dp_quick": SimConfig(
        name="dp_quick", partition="noniid", noniid_k=4, n_clients=12,
        clients_per_round=6, rounds=8, n_train=1200, n_test=400,
        eval_every=2, local_steps=3, local_batch=32, thgs=_THGS,
        sa=SecureAggConfig(mask_ratio=0.01, threshold=0.6),
        dropout_rate=0.25, seed=11,
        dp=DPConfig(clip=1.0, sigma=0.6, delta=1e-5),
        out_json="experiments/sim/dp_quick.json"),
    "ci_smoke": SimConfig(
        name="ci_smoke", partition="noniid", noniid_k=4, n_clients=6,
        clients_per_round=4, rounds=3, n_train=400, n_test=200,
        local_steps=2, local_batch=16, eval_every=1, thgs=_THGS, sa=_SA,
        out_json="experiments/sim/ci_smoke.json"),
}


# Codec sweeps: one Table-2-protocol run per wire codec. Every arm, the f32
# baseline included, runs with secure aggregation off, so the arms differ
# by wire codec alone (quantized codecs are rejected under secagg).
SWEEPS: dict[str, tuple[str, ...]] = {
    "codec_sweep_quick": ("f32", "int8", "int4", "1bit"),
    "codec_sweep": ("f32", "int8", "int4", "1bit"),
}


def sweep_configs(name: str) -> dict[str, SimConfig]:
    """The per-codec arms of a named sweep, keyed by codec."""
    try:
        arm_codecs = SWEEPS[name]
    except KeyError:
        raise KeyError(
            f"unknown sweep {name!r}; available: {', '.join(sorted(SWEEPS))}"
        ) from None
    quick = name.endswith("_quick")
    return {
        codec: SimConfig(
            name=f"{name}_{codec}", thgs=_THGS,
            sa=SecureAggConfig(enabled=False), codec=codec, **_table2(quick))
        for codec in arm_codecs
    }


# Privacy-frontier sweeps: one dp_quick-protocol run per noise multiplier z
# (the z=0 "off" arm runs without dp). Dropout is off, so the frontier is not
# confounded by survivor variance.
DP_SWEEPS: dict[str, tuple[float, ...]] = {
    "dp_frontier_quick": (0.0, 0.3, 0.6, 1.2),
    "dp_frontier": (0.0, 0.3, 0.6, 1.2),
}


def dp_sweep_configs(name: str) -> dict[str, SimConfig]:
    """The per-noise-multiplier arms of a named DP sweep, keyed by arm label
    ('off' for z=0, else 'z<value>')."""
    try:
        sigmas = DP_SWEEPS[name]
    except KeyError:
        raise KeyError(
            f"unknown dp sweep {name!r}; available: "
            f"{', '.join(sorted(DP_SWEEPS))}") from None
    quick = name.endswith("_quick")
    base = dict(
        partition="noniid", noniid_k=4, n_clients=12, clients_per_round=6,
        rounds=8 if quick else 24, n_train=1200 if quick else 4000,
        n_test=400, eval_every=2, local_steps=3, local_batch=32,
        thgs=_THGS, sa=SecureAggConfig(mask_ratio=0.01, threshold=0.6),
        dropout_rate=0.0, seed=11)
    out = {}
    for z in sigmas:
        label = "off" if z == 0.0 else f"z{z:g}"
        dp = None if z == 0.0 else DPConfig(clip=1.0, sigma=z, delta=1e-5)
        out[label] = SimConfig(name=f"{name}_{label}", dp=dp, **base)
    return out


def names() -> list[str]:
    return sorted(PRESETS)


def get(name: str) -> SimConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {', '.join(names())}"
        ) from None
