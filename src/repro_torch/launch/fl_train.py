"""Federated training of an LM on the datacenter mesh — port of
``examples/federated_llm_training.py``.

Trains an LM (``--arch``, reduced width by default) with the THGS + sparse
secure-aggregation FL step (``launch/train.py::make_fl_train_step``) on the
debug mesh (pod 2 x data 2 x model 2: two participants of four blocks
each, driven by this one process on ``--device``, or placed by
``--devices``: one device a pod, one a (pod, data) position, or one a
(pod, data, model) position, the parameters on the first). A pod whose two
data positions lie on two devices holds its parameters sharded over them
(``launch/fsdp.py``); one whose model positions lie on several devices
runs tensor-parallel over them (``launch/tp.py``). Each
participant is one financial institution. Params and THGS residuals resume
from the latest checkpoint in ``--ckpt`` (the reference's on-disk format:
params whole, residuals ``[n_fed, *leaf]``, each row, or its chunks,
restored onto its participant's devices), and
the run's exchange volume is written to ``<ckpt>/comm_ledger.json`` under
the reference's accounting (``costs.TPU_BITS``: f32 values, int32
indices).

Run::

    PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu \\
        --steps 20
    python -m repro_torch.launch.fl_train --devices cuda:0,cuda:1
    python -m repro_torch.launch.fl_train --devices cuda:0,cuda:1,cuda:2,cuda:3
    python -m repro_torch.launch.fl_train \
        --devices cuda:0,cuda:1,cuda:2,cuda:3,cuda:4,cuda:5,cuda:6,cuda:7
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch import checkpoint, configs, convert
from repro_torch.core import costs, threefry
from repro_torch.core.types import SecureAggConfig, THGSConfig
from repro_torch.data import make_lm_tokens
from repro_torch.launch import fsdp
from repro_torch.launch.mesh import make_debug_mesh, participant_groups
from repro_torch.launch.train import (fl_leaf_plan, init_fl_residuals,
                                      load_residuals, make_fl_train_step,
                                      stacked_residuals)
from repro_torch.models import transformer as tf
from repro_torch.sim import CommLedger, mib


def step_wire_record(step_t: int, leaf_sizes, thgs: THGSConfig,
                     sa: SecureAggConfig, n_fed: int, n_blocks: int):
    """One CommRecord for a datacenter FL step from the step's static plan:
    per leaf, ``nb`` blocks of ``kb`` top-k slots plus ``k_mask_block`` mask
    slots a block toward each of the ``n_fed - 1`` peers."""
    sizes = [int(s) for s in leaf_sizes]
    ks, k_masks = [], []
    for size, (kb, nb) in zip(sizes, fl_leaf_plan(sizes, thgs, n_blocks)):
        ks.append(nb * kb)
        k_masks.append(
            nb * max(1, int(size * sa.mask_ratio / n_fed / nb))
            if (sa.enabled and n_fed >= 2) else 0)
    return costs.round_record(step_t, sum(sizes), ks, k_masks,
                              n_clients=n_fed, bits=costs.TPU_BITS)


def params_tree(model) -> dict:
    """The parameters as the reference's leaves ``{path: stacked
    tensor}``, the checkpoint's ``params`` tree (sharded parameters
    gathered whole on the CPU)."""
    leaves = convert.reference_leaves(model)
    named = (dict(model.named_full()) if isinstance(model, fsdp.ShardedLM)
             else dict(model.named_parameters()))
    return {leaf.path: (torch.stack([named[n] for n in leaf.names])
                        .reshape(leaf.shape) if leaf.lead
                        else named[leaf.names[0]])
            for leaf in leaves}


def fl_state(model, residuals: list) -> dict:
    """The checkpoint's tree: ``params`` and the residuals in the
    reference's ``[n_fed, *leaf]`` layout (dotted leaf paths are the
    reference's tree levels on disk); sharded parameters and chunked rows
    are written whole, in that same layout."""
    return {"params": params_tree(model),
            "residuals": {lf.path: r for lf, r in zip(
                convert.reference_leaves(model), stacked_residuals(residuals))}}


def load_fl_state(model, residuals: list, tree: dict) -> None:
    """Write a restored :func:`fl_state` tree into the parameters and the
    residuals (each row, or its chunks, onto its participant's
    devices)."""
    load_params_tree(model, tree["params"])
    load_residuals(residuals, [tree["residuals"][lf.path]
                               for lf in convert.reference_leaves(model)])


def parse_devices(spec: str) -> list:
    """``--devices``: comma-separated devices, one a pod, one a (pod, data)
    or one a (pod, data, model) position. A ``cuda`` device must exist:
    nothing moves to the CPU in its place."""
    devs = [torch.device(d.strip()) for d in spec.split(",")]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for d in devs:
        if d.type == "cuda" and (d.index or 0) >= n:
            raise ValueError(f"{d}: this host has {n} CUDA device(s)")
    return devs


def cli_mesh(devices: list | None, device):
    """The debug mesh (pod 2, data 2, model 2) placed by ``--devices`` (2,
    4 or 8 of them: one a pod, a (pod, data) or a (pod, data, model)
    position), else every position on ``device``."""
    placed = None
    if devices:
        if len(devices) not in (2, 4, 8):
            raise ValueError(
                f"--devices takes 2 devices (one a pod), 4 (one a (pod, "
                f"data) position) or 8 (one a (pod, data, model) position), "
                f"not {len(devices)}")
        placed = np.empty(len(devices), dtype=object)
        placed[:] = devices
        placed = placed.reshape({2: (2,), 4: (2, 2), 8: (2, 2, 2)}[
            len(devices)])
    return make_debug_mesh(2, 2, multi_pod=True, devices=placed,
                           device=device)


@torch.no_grad()
def load_params_tree(model, tree: dict) -> None:
    """Write ``{path: stacked tensor}`` into the model's parameters (or
    into sharded parameters' chunks)."""
    sharded = isinstance(model, fsdp.ShardedLM)
    named = None if sharded else dict(model.named_parameters())
    for leaf in convert.reference_leaves(model):
        t = tree[leaf.path]
        parts = t.reshape((-1,) + leaf.shape[len(leaf.lead):])
        for j, name in enumerate(leaf.names):
            if sharded:
                model.load_(name, parts[j])
            else:
                named[name].copy_(parts[j])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_fl_ckpt"))
    ap.add_argument("--log-every", type=int, default=10,
                    help="print the loss every N steps")
    ap.add_argument("--device", default="cuda",
                    help="the one device of every pod")
    ap.add_argument("--devices", default=None,
                    help="comma-separated, one device a pod (e.g. "
                    "cuda:0,cuda:1), one a (pod, data) position (4, e.g. "
                    "cuda:0,cuda:1,cuda:2,cuda:3) or one a (pod, data, "
                    "model) position (8); the parameters live on the first")
    args = ap.parse_args(argv)
    try:
        devices = parse_devices(args.devices or args.device)
    except ValueError as e:
        print(f"{e}: pass --device cpu", file=sys.stderr)
        return 1
    device = devices[0]
    try:
        mesh = cli_mesh(devices if args.devices else None, device)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    fed_axis = "pod"
    n_fed = mesh.shape[fed_axis]
    n_blocks = mesh.size // n_fed

    gen = torch.Generator(device=device).manual_seed(0)
    params = tf.init_params(cfg, gen, device=device)
    leaves = convert.reference_leaves(params)
    if any(fsdp.spread(participant_groups(mesh, fed_axis, p))
           for p in range(n_fed)):
        params = fsdp.shard(params, mesh, fed_axis)
    residuals = init_fl_residuals(params, n_fed, mesh, fed_axis)

    thgs = THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
    sa = SecureAggConfig(mask_ratio=0.01)
    step = make_fl_train_step(cfg, mesh, fed_axis, thgs, sa, lr=args.lr)
    # each institution's private corpus -> distinct token stream statistics
    toks, labels = make_lm_tokens(cfg.vocab, args.batch, args.seq, seed=0)
    batch = {"tokens": torch.from_numpy(np.asarray(toks, np.int32)),
             "labels": torch.from_numpy(np.asarray(labels, np.int32))}
    batch = {k: v.to(device) for k, v in batch.items()}

    # resume from the latest checkpoint: the THGS error-feedback residuals
    # are part of the training state
    start = checkpoint.latest_step(args.ckpt) or 0
    if start:
        load_fl_state(params, residuals, checkpoint.restore(
            args.ckpt, start, like=fl_state(params, residuals)))
        print(f"resumed from {args.ckpt} at step {start}")

    ledger = CommLedger()
    rec = step_wire_record(0, [math.prod(lf.shape) for lf in leaves], thgs,
                           sa, n_fed, n_blocks)
    for i in range(start, args.steps):
        _, _, loss = step(params, residuals, batch, threefry.key(i))
        ledger.record(dataclasses.replace(rec, round=i))
        if (i + 1) % args.log_every == 0:
            print(f"step {i + 1:4d}  loss={float(loss):.4f}", flush=True)

    checkpoint.save(args.ckpt, args.steps, fl_state(params, residuals))
    print(f"checkpoint written to {args.ckpt} "
          f"(step {checkpoint.latest_step(args.ckpt)})")
    t = ledger.totals("tpu")
    if ledger.entries:
        print(f"federation exchange (tpu accounting): "
              f"{mib(t['upload_bits']):.1f} MiB uploaded vs "
              f"{mib(t['dense_upload_bits']):.1f} MiB dense "
              f"-> {t['upload_vs_dense']:.1%} ({t['compression_x']:.1f}x)")
    ledger.to_json(os.path.join(args.ckpt, "comm_ledger.json"),
                   extra={"arch": args.arch, "steps": args.steps})
    return 0


if __name__ == "__main__":
    sys.exit(main())
