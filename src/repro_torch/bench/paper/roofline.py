"""Roofline from the dry-run records on the H100's constants (port of
``benchmarks/roofline.py``).

For each (arch x shape x mesh) record of ``launch/dryrun.py`` in
``experiments/dryrun_torch/``::

    compute term    = model FLOPs / (chips x PEAK_FLOPS_BF16)   989e12
    memory term     = HBM bytes   / (chips x HBM_BW)            3.35e12
    collective term = bytes       / (chips x INTER_NODE_BW)     50e9

on one H100 SXM a position (``launch/mesh.py``: the NVIDIA data sheets).
The collective term takes the inter-node rate, not NVLink's 450 GB/s: the
production meshes span nodes of 8, and the FL exchange crosses the pod
(federation) axis, between nodes. Its bytes are the record's
``collectives.total_bytes``, as the reference's: the dry run counts them
from the layout (FSDP gathers and gradient reductions, tensor-parallel
all-reduces, and under ``--fl`` the stream exchange); a record whose
``total_bytes`` is null gives no collective term, not a zero one.

Two FLOP figures, as in the reference: the analytic ``model_flops`` (6·N·D
train, 2·N·D prefill, 2·N_active a token plus attention over the cache for
decode; the trustworthy number) and the record's counted FLOPs, whose ratio
flags remat and redundant work. The counted figure is the dry run's
FlopCounterMode trace over every layer, microbatch and participant, where
XLA's cost analysis counts a loop body once: ``scan_correction`` is 1.
``n_params`` comes from the model built on the meta device.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch import configs
from repro_torch.launch.mesh import HBM_BW, INTER_NODE_BW, PEAK_FLOPS_BF16
from repro_torch.launch.specs import SHAPES, arch_for_shape
from repro_torch.launch.train import micro_batches

DRYRUN_DIR = "experiments/dryrun_torch"


def active_params(cfg, n_total: int) -> int:
    if cfg.moe is None:
        return n_total
    m = cfg.moe
    # remove the routed experts that are not among top_k (+ keep shared)
    expert_p = 3 * cfg.d_model * m.d_ff_expert
    routed_total = cfg.n_layers * m.n_experts * expert_p
    routed_active = cfg.n_layers * m.top_k * expert_p
    return n_total - routed_total + routed_active


def model_flops(cfg, shape, n_params: int) -> float:
    tokens = shape.global_batch * shape.seq_len
    n_act = active_params(cfg, n_params)
    if shape.kind == "train":
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        return 2.0 * n_act * tokens
    # decode: one token per sequence + attention over the cache
    flops = 2.0 * n_act * shape.global_batch
    if not cfg.encoder_only and cfg.family not in ("ssm",):
        win = cfg.window or shape.seq_len
        ctx = min(shape.seq_len, win)
        flops += (4.0 * shape.global_batch * ctx * cfg.n_heads * cfg.hd
                  * cfg.n_layers)
    return flops


def analytic_hbm_bytes(cfg, shape, n_params: int, fl: bool) -> float:
    """Per-step global HBM traffic estimate (weights + activations +
    caches)."""
    tokens = shape.global_batch * shape.seq_len
    d = cfg.d_model
    bpe = 2  # bf16
    if shape.kind == "train":
        # fwd+bwd: read params twice, write grads, plus ~14 activation
        # round-trips per token per layer (norm/attn/mlp read+write, remat x2)
        act = 14 * tokens * d * bpe * cfg.n_layers
        return 3 * n_params * bpe + act
    if shape.kind == "prefill":
        act = 8 * tokens * d * bpe * cfg.n_layers
        return n_params * bpe + act
    # decode: weights (active) + full KV/state cache read + one-slot write
    n_act = active_params(cfg, n_params)
    if cfg.family == "ssm" and cfg.xlstm:
        dh = 2 * d // cfg.n_heads
        cache = (cfg.n_layers // 2 * shape.global_batch * cfg.n_heads * dh
                 * dh * 4)
    elif cfg.family == "hybrid":
        d_inner = cfg.ssm.expand * d
        h = d_inner // cfg.ssm.head_dim
        cache = (cfg.n_layers * shape.global_batch * h * cfg.ssm.d_state
                 * cfg.ssm.head_dim * 4)
        n_super = cfg.n_layers // cfg.shared_attn_every
        cache += (n_super * shape.global_batch * shape.seq_len
                  * cfg.n_kv_heads * cfg.hd * 2 * bpe)
    elif cfg.encoder_only:
        cache = 0
    else:
        win = cfg.window or shape.seq_len
        ctx = min(shape.seq_len, win)
        cache = (cfg.n_layers * shape.global_batch * ctx * cfg.n_kv_heads
                 * cfg.hd * 2 * bpe)
    return n_act * bpe + cache


def n_micro_for(n_params: int) -> int:
    """The dry run's microbatch rule (``train.micro_batches``)."""
    return micro_batches(n_params)


def scan_correction(cfg, shape, n_params: int) -> float:
    """1: the dry run's trace counts every layer, microbatch and
    participant, where the reference multiplies XLA's once-counted loop
    bodies by their trip counts."""
    return 1.0


def meta_param_count(cfg) -> int:
    from repro_torch.models import transformer as tf

    return tf.param_count(tf.init_params(cfg, device="meta"))


def load_records(dryrun_dir: str = DRYRUN_DIR) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def roofline_row(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    shape = SHAPES[rec["shape"]]
    cfg = arch_for_shape(configs.get(rec["arch"]), shape)
    chips = rec["n_devices"]
    n_params = meta_param_count(cfg)
    mf = model_flops(cfg, shape, n_params)
    hbm = analytic_hbm_bytes(cfg, shape, n_params, rec.get("fl", False))
    corr = scan_correction(cfg, shape, n_params)
    coll = rec["collectives"].get("total_bytes")
    coll = None if coll is None else coll * corr
    counted = rec["cost"].get("flops", 0.0) * chips * corr
    terms = {"compute": mf / (chips * PEAK_FLOPS_BF16),
             "memory": hbm / (chips * HBM_BW)}
    if coll is not None:
        terms["collective"] = coll / (chips * INTER_NODE_BW)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "fl": rec.get("fl", False), "chips": chips, "n_params": n_params,
        "model_flops": mf, "counted_flops": counted,
        "useful_ratio": mf / counted if counted else float("nan"),
        "hbm_bytes": hbm, "collective_bytes": coll,
        "t_compute_s": terms["compute"], "t_memory_s": terms["memory"],
        "t_collective_s": terms.get("collective"),
        "bottleneck": max(terms, key=terms.get),
        "arg_mem_per_device_gib": rec["memory"].get(
            "argument_size_in_bytes", 0) / 2**30,
    }


def run(quick: bool = False, device="cuda", dryrun_dir: str = DRYRUN_DIR):
    """One CSV row a dry-run record with status ok; ``quick`` and
    ``device`` change nothing (no card is used)."""
    rows = []
    for rec in load_records(dryrun_dir):
        r = roofline_row(rec)
        if r is None:
            continue
        t_coll = ("n/a" if r["t_collective_s"] is None
                  else f"{r['t_collective_s']:.6f}s")
        rows.append((
            f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}"
            + ("/fl" if r["fl"] else ""), r["t_compute_s"] * 1e6,
            f"t_compute={r['t_compute_s']:.6f}s;"
            f"t_memory={r['t_memory_s']:.6f}s;t_collective={t_coll};"
            f"bottleneck={r['bottleneck']};"
            f"model_tflops={r['model_flops'] / 1e12:.1f};"
            f"useful_ratio={r['useful_ratio']:.2f};"
            f"args_dev={r['arg_mem_per_device_gib']:.2f}GiB"))
    return rows
