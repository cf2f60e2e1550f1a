"""The multi-round federated simulation engine — port of
``repro.sim.engine``: the synchronous ``Simulation`` (flat or tree decode),
the FedBuff-style ``AsyncSimulation`` and ``simulate()``.

``Simulation`` owns data synthesis and partitioning, the per-round cohort
schedule and dropout injection (sampler.py), the round itself
(``core.fedavg.run_round``), the communication ledger and eval hooks. With
``shard_clients`` ('auto' by default) it splits the fixed-shape cohort over a
1-D ``clients`` mesh of local devices (``launch/mesh.py``) when more than one
device divides the cohort; 'on' insists, 'off' runs the serial round. It runs
on ``cuda`` unless the caller passes ``device="cpu"``; it never falls back
from one to the other. Every float in the round is f32: on the card, TF32 is
switched off for matmuls and convolutions.

Initial parameters come from the port's own ``PaperModel.init_`` under an
explicit ``torch.Generator`` seeded with ``cfg.seed`` (drawn on the CPU, so
the CPU and the card start from the same weights), or are injected with
``init_params`` — a reference-layout ``{outer: {inner: array}}`` tree, e.g.
the JAX package's initial params, for parity runs.

``AsyncSimulation`` drains a buffer of distinct client reports per server
step; each report trained from a parameter version ``tau`` steps old, with
``tau`` drawn counter-based from ``(seed, 0xA5, step)`` as the reference
draws it, out of a ring of the last ``max_staleness + 1`` versions.

Checkpoint/resume: with ``cfg.ckpt_dir`` and ``cfg.ckpt_every``, every
``ckpt_every`` rounds the engine saves params and residuals (and the async
ring) through ``checkpoint.store`` in the reference's format, then a JSON
sidecar ``sim_<round>.json`` (client losses, accuracies, losses, ledger
entries). ``run(resume=True)`` picks up from the newest consistent (npz,
sidecar) pair — one the reference wrote too — and, under the same
``rounds`` horizon, replays the uninterrupted run bit for bit: every draw
is a pure function of (seed, round, client). ``publish_params_hook``
publishes the post-round params for a serving ``CheckpointWatcher``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.convert import params_from_jax
from repro_torch.core import costs
from repro_torch.core.fedavg import (FederatedState, init_state,
                                     run_async_update, run_round)
from repro_torch.data.datasets import SPECS, make_dataset
from repro_torch.data.federated import (client_batches, dirichlet, iid,
                                        noniid_label_k)
from repro_torch.launch.mesh import clients_mesh_for, local_device_count
from repro_torch.models.paper_models import (accuracy, build_model,
                                             cross_entropy_loss)
from repro_torch.sim.config import SimConfig
from repro_torch.sim.ledger import CommLedger
from repro_torch.sim.sampler import ClientSampler

# hook(round_t, info) with info keys:
#   state, cohort, dropped, loss, record, acc (only on eval rounds)
RoundHook = Callable[[int, dict], None]


def publish_params_hook(publish_dir: str, every: int = 1) -> RoundHook:
    """A :data:`RoundHook` that publishes the post-round global params (the
    bare ``{name: tensor}`` dict, not the training state) with
    ``checkpoint.publish`` at step ``round + 1``, every ``every`` rounds:
    the trainer only drops complete checkpoints, and the server's
    ``CheckpointWatcher`` polls them up."""
    def hook(round_t: int, info: dict) -> None:
        if (round_t + 1) % max(1, every) == 0:
            checkpoint.publish(publish_dir, round_t + 1,
                               info["state"].params)

    return hook


def resolve_device(device) -> torch.device:
    """``cuda`` (the default everywhere) or an explicit ``cpu``; a CUDA
    request without a card raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch versions on the CPU")
    return dev


@dataclasses.dataclass
class SimResult:
    """Outcome of one simulation: metric trajectories + the comm ledger."""

    name: str
    rounds: int
    eval_every: int
    accuracies: list
    losses: list
    wall_s: float
    ledger: CommLedger
    config: dict

    @property
    def final_acc(self) -> float:
        """Mean of the last three eval points (the Table 2 convergence acc)."""
        return float(np.mean(self.accuracies[-3:])) if self.accuracies else 0.0

    def summary(self) -> dict:
        return {
            "name": self.name,
            "rounds": self.rounds,
            "eval_every": self.eval_every,
            "final_acc": self.final_acc,
            "accuracies": [float(a) for a in self.accuracies],
            "losses": [float(x) for x in self.losses],
            "wall_s": self.wall_s,
            "config": self.config,
            "ledger": self.ledger.summary(),
        }

    def to_json(self, path: str) -> str:
        return self.ledger.to_json(path, extra={
            k: v for k, v in self.summary().items() if k != "ledger"})


class Simulation:
    """Config-driven multi-round federated simulation (module docstring).

    ``leaf_hook`` (attribute, default None) is handed to every round's
    ``run_round`` — a probe on each leaf's streams and decoded sum.
    """

    sim_mode = "sync"   # the cfg.mode this class runs (see simulate())

    def __init__(self, cfg: SimConfig, *, device="cuda", init_params=None):
        cfg.validate()
        if cfg.mode != self.sim_mode:
            raise ValueError(
                f"{type(self).__name__} runs mode={self.sim_mode!r} but the "
                f"config asks for mode={cfg.mode!r}; use simulate() (or "
                "AsyncSimulation directly) for async configs")
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = build_model(cfg.model)
        if init_params is not None:
            self.model = params_from_jax(init_params, cfg.model)
        else:
            self.model.init_(torch.Generator().manual_seed(cfg.seed))
        self.model = self.model.to(self.device)
        spec = SPECS[cfg.dataset]
        x, y = make_dataset(spec, cfg.n_train, seed=cfg.seed)
        xt, yt = make_dataset(spec, cfg.n_test, seed=cfg.seed + 1,
                              train=False)
        self.x, self.y = x, y
        self.xt = torch.from_numpy(xt).to(self.device)
        self.yt = torch.from_numpy(yt.astype(np.int64)).to(self.device)
        if cfg.partition == "iid":
            self.parts = iid(y, cfg.n_clients, seed=cfg.seed)
        elif cfg.partition == "noniid":
            self.parts = noniid_label_k(y, cfg.n_clients, cfg.noniid_k,
                                        seed=cfg.seed)
        else:
            self.parts = dirichlet(y, cfg.n_clients, cfg.dirichlet_alpha,
                                   seed=cfg.seed)
        self.data_counts = {c: int(len(idx)) for c, idx in self.parts.items()}
        self.sampler = ClientSampler(
            cfg.n_clients, cfg.clients_per_round, mode=cfg.sampler,
            weights=self.data_counts if cfg.sampler == "weighted" else None,
            dropout_rate=cfg.dropout_rate, seed=cfg.seed)
        self.fed = cfg.fed()
        self.bits = (costs.PAPER_BITS if cfg.accounting == "paper"
                     else costs.TPU_BITS)
        self.loss_fn = cross_entropy_loss(self.model)
        self.client_weights = (self.data_counts if cfg.weight_by_data_count
                               else None)
        # injected dropout stays within what secure aggregation can recover:
        # at least the Shamir threshold t of the cohort survives
        self.min_survivors = (
            cfg.sa.t_for(cfg.clients_per_round)
            if cfg.thgs is not None and cfg.sa.enabled else 1)
        # client-parallel rounds: the cohort split over a 1-D clients mesh
        # of local devices when they allow it ('auto'), or must ('on');
        # tests may assign ``sim.mesh`` directly (e.g. shards that share
        # one device, launch/mesh.py)
        self.mesh = None
        if cfg.shard_clients != "off":
            self.mesh = clients_mesh_for(cfg.clients_per_round,
                                         self.device.type)
            if cfg.shard_clients == "on" and self.mesh is None:
                raise RuntimeError(
                    "shard_clients='on' but no usable clients mesh: "
                    f"{local_device_count(self.device.type)} "
                    f"{self.device.type} device(s) for a cohort of "
                    f"{cfg.clients_per_round} (need more than one device "
                    "and a device count dividing the cohort)")
        self.ledger = CommLedger()
        self.leaf_hook = None

    def _fresh_state(self) -> FederatedState:
        params = {n: p.detach().clone()
                  for n, p in self.model.params().items()}
        return init_state(params, self.fed)

    def _batches_for(self, round_t: int, cohort: Sequence[int]) -> dict:
        """Fixed-shape [steps, batch, ...] stacks for every cohort member,
        seeded by (seed, round, client) exactly as the reference."""
        cfg = self.cfg
        out = {}
        for c in cohort:
            xb, yb = client_batches(
                self.x, self.y, self.parts[int(c)], cfg.local_batch,
                cfg.local_steps,
                seed=cfg.seed * 7919 + round_t * 1000 + int(c))
            out[int(c)] = (torch.from_numpy(xb).to(self.device),
                           torch.from_numpy(yb.astype(np.int64))
                           .to(self.device))
        return out

    def _step(self, r: int, state: FederatedState):
        """One synchronous round: returns the new state and the hook info
        of the round (cohort, dropped)."""
        cfg = self.cfg
        cohort = self.sampler.cohort_for(r)
        assert len(cohort) == cfg.clients_per_round, (
            "fixed-cohort contract violated: "
            f"{len(cohort)} != {cfg.clients_per_round}")
        dropped = self.sampler.dropouts_for(
            r, cohort, min_survivors=self.min_survivors)
        batches = self._batches_for(r, cohort)
        state = run_round(
            state, batches, self.loss_fn, self.fed, cfg.thgs, cfg.sa,
            bits=self.bits, client_weights=self.client_weights,
            dropped=dropped, leaf_hook=self.leaf_hook, codec=cfg.codec,
            dp=cfg.dp, topology=cfg.topology, tree_groups=cfg.tree_groups,
            mesh=self.mesh)
        return state, {"cohort": cohort, "dropped": dropped}

    # ------------------------------------------------------------ checkpoint
    def _sidecar_path(self, step: int) -> str:
        return os.path.join(self.cfg.ckpt_dir, f"sim_{step:08d}.json")

    # the four hooks AsyncSimulation extends to keep its version ring
    def _ckpt_tree(self, state: FederatedState) -> dict:
        return {"params": state.params, "residuals": state.residuals}

    def _ckpt_like(self, state: FederatedState, meta: dict) -> dict:
        return {"params": state.params, "residuals": state.residuals}

    def _load_ckpt_tree(self, state: FederatedState, tree: dict) -> None:
        state.params = tree["params"]
        state.residuals = tree["residuals"]

    def _sidecar_extra(self) -> dict:
        return {}

    def _save_ckpt(self, round_done: int, state: FederatedState,
                   accs: list, losses: list) -> None:
        checkpoint.save(self.cfg.ckpt_dir, round_done, self._ckpt_tree(state))
        sidecar = {
            "round": round_done,
            "client_losses": {str(c): float(v)
                              for c, v in state.losses.items()},
            "accuracies": [float(a) for a in accs],
            "losses": [float(x) for x in losses],
            "ledger_entries": self.ledger.summary()["entries"],
        }
        sidecar.update(self._sidecar_extra())
        # tmp + rename: a crash mid-write never leaves a truncated sidecar
        # shadowing the last good (npz, sidecar) pair
        path = self._sidecar_path(round_done)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sidecar, f)
        os.replace(tmp, path)

    def _try_resume(self, state: FederatedState,
                    accs: list, losses: list) -> int:
        """Restore the newest consistent checkpoint; returns the round to
        start from (0 without one)."""
        cfg = self.cfg
        if not cfg.ckpt_dir:
            return 0
        # newest (npz, sidecar) pair: an npz whose sidecar never got written
        # is skipped, and a sidecar that does not parse counts as missing
        step, meta = None, None
        for s in sorted(checkpoint.saved_steps(cfg.ckpt_dir), reverse=True):
            if not os.path.exists(self._sidecar_path(s)):
                continue
            try:
                with open(self._sidecar_path(s)) as f:
                    meta = json.load(f)
            except (ValueError, OSError) as e:
                warnings.warn(
                    f"unreadable checkpoint sidecar {self._sidecar_path(s)} "
                    f"({e}); falling back to an older checkpoint",
                    RuntimeWarning, stacklevel=2)
                continue
            step = s
            break
        if step is None:
            return 0
        if step > cfg.rounds:
            raise ValueError(
                f"checkpoint at round {step} > rounds={cfg.rounds}; "
                "refusing to resume past the configured horizon")
        tree = checkpoint.restore(cfg.ckpt_dir, step,
                                  like=self._ckpt_like(state, meta))
        self._load_ckpt_tree(state, tree)
        state.losses = {int(c): float(v)
                        for c, v in meta["client_losses"].items()}
        state.round = step
        accs[:] = meta["accuracies"]
        losses[:] = meta["losses"]
        self.ledger.entries = CommLedger.from_entry_dicts(
            meta["ledger_entries"]).entries
        return step

    # ------------------------------------------------------------------- run
    def run(self, *, resume: bool = True,
            hooks: Sequence[RoundHook] = ()) -> SimResult:
        """Run to ``cfg.rounds``; with ``resume`` (the default) from the
        newest checkpoint in ``cfg.ckpt_dir`` when there is one."""
        cfg = self.cfg
        self.ledger = CommLedger()
        state = self._fresh_state()
        accs: list = []
        losses: list = []
        start = self._try_resume(state, accs, losses) if resume else 0
        t0 = time.perf_counter()
        for r in range(start, cfg.rounds):
            state, step = self._step(r, state)
            rec = state.comm_log[-1]
            self.ledger.record(rec)
            loss = float(np.mean([state.losses[int(c)]
                                  for c in step["cohort"]]))
            losses.append(loss)
            info = {"state": state, **step, "loss": loss, "record": rec}
            if (r + 1) % max(1, cfg.eval_every) == 0:
                acc = accuracy(self.model, state.params, self.xt, self.yt)
                accs.append(acc)
                info["acc"] = acc
            if (cfg.ckpt_dir and cfg.ckpt_every
                    and (r + 1) % cfg.ckpt_every == 0):
                self._save_ckpt(r + 1, state, accs, losses)
            for hook in hooks:
                hook(r, info)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.state = state
        return SimResult(
            name=cfg.name,
            rounds=cfg.rounds,
            eval_every=cfg.eval_every,
            accuracies=accs,
            losses=losses,
            wall_s=time.perf_counter() - t0,
            ledger=self.ledger,
            config=cfg.to_dict(),
        )


class AsyncSimulation(Simulation):
    """FedBuff-style async simulation (module docstring): each server step
    ``t`` drains ``B = cfg.buffer_size or cfg.clients_per_round`` distinct
    reports through ``core.fedavg.run_async_update``; each update's taus
    land on its ledger entry and in the hook info as ``staleness``. The
    ``leaf_hook`` probe is the synchronous round's only."""

    sim_mode = "async"
    _STALENESS_TAG = 0xA5

    def __init__(self, cfg: SimConfig, *, device="cuda", init_params=None):
        super().__init__(cfg, device=device, init_params=init_params)
        self.buffer = cfg.buffer_size or cfg.clients_per_round
        # distinct reports per buffer (sampled like a cohort, without
        # replacement): a duplicate would clobber the residual write-back
        self.sampler = ClientSampler(
            cfg.n_clients, self.buffer, mode=cfg.sampler,
            weights=self.data_counts if cfg.sampler == "weighted" else None,
            dropout_rate=0.0, seed=cfg.seed)
        self.versions: list = []   # parameter ring, newest last
        self.mesh = None           # async runs the serial update path

    def _fresh_state(self) -> FederatedState:
        state = super()._fresh_state()
        self.versions = [state.params]
        return state

    # ------------------------------------------------- checkpoint ring hooks
    def _ckpt_tree(self, state: FederatedState) -> dict:
        d = super()._ckpt_tree(state)
        d["ring"] = {str(i): v for i, v in enumerate(self.versions)}
        return d

    def _ckpt_like(self, state: FederatedState, meta: dict) -> dict:
        like = super()._ckpt_like(state, meta)
        like["ring"] = {str(i): state.params
                        for i in range(int(meta["ring_len"]))}
        return like

    def _load_ckpt_tree(self, state: FederatedState, tree: dict) -> None:
        super()._load_ckpt_tree(state, tree)
        ring = tree["ring"]
        self.versions = [ring[str(i)] for i in range(len(ring))]

    def _sidecar_extra(self) -> dict:
        return {"ring_len": len(self.versions)}

    def _staleness_for(self, round_t: int) -> list[int]:
        """Counter-based staleness draws for server step ``round_t``:
        uniform over ``[0, min(t, ring - 1, max_staleness)]``."""
        hi = min(round_t, len(self.versions) - 1, self.cfg.max_staleness)
        rng = np.random.default_rng(
            [self.cfg.seed, self._STALENESS_TAG, round_t])
        return [int(t) for t in rng.integers(0, hi + 1, size=self.buffer)]

    def _step(self, r: int, state: FederatedState):
        cfg = self.cfg
        cohort = self.sampler.cohort_for(r)
        assert len(cohort) == self.buffer, (
            f"fixed-buffer contract violated: {len(cohort)} != {self.buffer}")
        taus = self._staleness_for(r)
        batches = self._batches_for(r, cohort)
        client_params = {int(c): self.versions[-1 - tau]
                         for c, tau in zip(cohort, taus)}
        state = run_async_update(
            state, batches, client_params, self.loss_fn, self.fed, cfg.thgs,
            bits=self.bits,
            staleness={int(c): tau for c, tau in zip(cohort, taus)},
            client_weights=self.client_weights, codec=cfg.codec,
            topology=cfg.topology, tree_groups=cfg.tree_groups)
        self.versions = (self.versions
                         + [state.params])[-(cfg.max_staleness + 1):]
        return state, {"cohort": cohort, "dropped": (), "staleness": taus}


def simulation_for(cfg: SimConfig, *, device="cuda",
                   init_params=None) -> Simulation:
    """The engine for ``cfg.mode``: ``Simulation`` (sync) or
    ``AsyncSimulation``."""
    cls = AsyncSimulation if cfg.mode == "async" else Simulation
    return cls(cfg, device=device, init_params=init_params)


def simulate(cfg: SimConfig, *, device="cuda", init_params=None,
             **run_kw) -> SimResult:
    """Build the engine for ``cfg.mode`` and run it."""
    return simulation_for(cfg, device=device,
                          init_params=init_params).run(**run_kw)
