"""Simulation configuration — port of ``repro.sim.config``.

A :class:`SimConfig` names one multi-round federated run: model, dataset and
partition, the federated protocol, THGS / secure aggregation, sampling and
dropout, evaluation cadence and output path. The fields and their defaults
are the reference's, so ``to_dict()`` writes the same ledger ``config``
block. ``validate()`` refuses, with ``ValueError``, every option and
combination the reference's ``validate()`` refuses, and nothing else.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.codecs import CODECS, reject_codec_with_masks
from repro_torch.core.dp import DPConfig, reject_codec_with_noise
from repro_torch.core.types import FedConfig, SecureAggConfig, THGSConfig

PARTITIONS = ("iid", "noniid", "dirichlet")
SAMPLERS = ("uniform", "weighted")
ACCOUNTINGS = ("paper", "tpu")
SHARD_CLIENTS = ("auto", "on", "off")
TOPOLOGIES = ("flat", "tree")
MODES = ("sync", "async")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Everything a ``repro_torch.sim.Simulation`` needs, as one record
    (field meanings as in the reference's ``SimConfig``)."""

    name: str = "sim"
    # model + data
    model: str = "mnist_mlp"
    dataset: str = "mnist"
    partition: str = "iid"
    noniid_k: int = 4
    dirichlet_alpha: float = 0.5
    n_train: int = 4000
    n_test: int = 800
    # federated protocol (paper §5)
    rounds: int = 30
    n_clients: int = 20
    clients_per_round: int = 5
    local_steps: int = 5
    local_batch: int = 50
    local_lr: float = 0.05
    server_lr: float = 1.0
    algorithm: str = "fedavg"
    prox_mu: float = 0.0
    # mechanisms
    thgs: Optional[THGSConfig] = None
    sa: SecureAggConfig = SecureAggConfig(enabled=False)
    codec: str = "f32"
    dp: Optional[DPConfig] = None
    # scheduling
    sampler: str = "uniform"
    weight_by_data_count: bool = False
    dropout_rate: float = 0.0
    eval_every: int = 3
    seed: int = 0
    shard_clients: str = "auto"
    topology: str = "flat"
    tree_groups: int = 0
    mode: str = "sync"
    buffer_size: int = 0
    max_staleness: int = 4
    # accounting + I/O
    accounting: str = "paper"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    out_json: Optional[str] = None

    def fed(self) -> FedConfig:
        return FedConfig(
            n_clients=self.n_clients,
            clients_per_round=self.clients_per_round,
            local_steps=self.local_steps,
            local_batch=self.local_batch,
            local_lr=self.local_lr,
            server_lr=self.server_lr,
            prox_mu=self.prox_mu,
            rounds=self.rounds,
            algorithm=self.algorithm,
        )

    def validate(self) -> None:
        if self.partition not in PARTITIONS:
            raise ValueError(f"partition must be one of {PARTITIONS}, "
                             f"got {self.partition!r}")
        if self.sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, "
                             f"got {self.sampler!r}")
        if self.accounting not in ACCOUNTINGS:
            raise ValueError(f"accounting must be one of {ACCOUNTINGS}, "
                             f"got {self.accounting!r}")
        if self.shard_clients not in SHARD_CLIENTS:
            raise ValueError(f"shard_clients must be one of {SHARD_CLIENTS}, "
                             f"got {self.shard_clients!r}")
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"topology must be one of {TOPOLOGIES}, "
                             f"got {self.topology!r}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        if not (1 <= self.clients_per_round <= self.n_clients):
            raise ValueError("need 1 <= clients_per_round <= n_clients, got "
                             f"{self.clients_per_round} vs {self.n_clients}")
        if not (0.0 <= self.dropout_rate <= 1.0):
            raise ValueError(f"dropout_rate in [0, 1], got {self.dropout_rate}")
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if self.algorithm not in ("fedavg", "fedprox"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.codec not in CODECS:
            raise ValueError(f"codec must be one of {CODECS}, "
                             f"got {self.codec!r}")
        if self.codec != "f32" and self.thgs is None:
            raise ValueError(
                f"codec {self.codec!r} requires THGS sparse streams "
                "(thgs=None runs the dense baseline, which has no stream "
                "wire to quantize)")
        # the shared guard (core/codecs.py, repro.lint RPL003)
        reject_codec_with_masks(self.codec, self.sa.enabled)
        if self.dp is not None and self.dp.active:
            self.dp.validate()
            if self.thgs is None:
                raise ValueError(
                    "dp requires THGS sparse streams (the DP noise rides "
                    "the unified stream's transmitted slots)")
            reject_codec_with_noise(self.codec, self.dp.sigma)
            if self.mode == "async":
                raise ValueError(
                    "dp cannot run with mode='async': the noise scale "
                    "sigma*clip/sqrt(C) is calibrated to a round-synchronous "
                    "cohort, which a streaming buffer breaks")
            if self.weight_by_data_count:
                raise ValueError(
                    "dp cannot run with weight_by_data_count: data-count "
                    "weights scale each client's contribution past the clip "
                    "bound, breaking the sensitivity analysis (use uniform "
                    "weights)")
        if self.topology == "tree" and self.thgs is None:
            raise ValueError(
                "topology='tree' requires THGS sparse streams (dense rounds "
                "have no stream decode to shard across sub-aggregators)")
        if self.tree_groups < 0:
            raise ValueError(f"tree_groups must be >= 0 (0 = auto), "
                             f"got {self.tree_groups}")
        if self.mode == "async":
            if self.thgs is None:
                raise ValueError(
                    "mode='async' requires THGS sparse streams (the async "
                    "path exercises the sparse-stream data plane)")
            if self.sa.enabled:
                raise ValueError(
                    "mode='async' cannot run secure aggregation: pair masks "
                    "are agreed round-synchronously among a known cohort, "
                    "which a streaming buffer breaks")
            if self.dropout_rate > 0:
                raise ValueError(
                    "mode='async' has no dropout: a buffer only ever holds "
                    "reports that arrived (set dropout_rate=0)")
            B = self.buffer_size or self.clients_per_round
            if not (1 <= B <= self.n_clients):
                raise ValueError(
                    f"need 1 <= buffer_size <= n_clients, got {B} vs "
                    f"{self.n_clients}")
            if self.max_staleness < 0:
                raise ValueError(
                    f"max_staleness must be >= 0, got {self.max_staleness}")
            if self.shard_clients == "on":
                raise ValueError(
                    "mode='async' runs the serial update path; "
                    "shard_clients='on' cannot be honoured (use 'auto' or "
                    "'off')")
        elif self.buffer_size:
            raise ValueError("buffer_size is only meaningful with "
                             "mode='async'")
        if self.thgs is not None:
            self.thgs.validate()

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
