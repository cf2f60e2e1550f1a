"""Input shapes and their specs for every (arch x input shape) pair — port
of ``repro.launch.specs``.

The four assigned shapes::

    train_4k     seq=4096    global_batch=256   (training step)
    prefill_32k  seq=32768   global_batch=32    (inference prefill)
    decode_32k   seq=32768   global_batch=128   (one-token decode, 32k KV cache)
    long_500k    seq=524288  global_batch=1     (one-token decode, 500k context)

:func:`input_specs` gives meta-device tensors of the step's data arguments
(the reference's ``ShapeDtypeStruct`` stand-ins); the decode state is the
port's own (``transformer.init_decode_state``: one cache a layer where the
reference stacks the layers), so its specs are per layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.sharding import P


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# a KV cache's sequence splits over ``kv_seq`` from this many slots (the
# reference's rule); a shorter cache is whole on every ``model`` position
KV_SPLIT_SLOTS = 1024


def folds(global_batch: int) -> bool:
    """Whether a batch of ``global_batch`` rows folds the idle batch axes
    into the KV cache's sequence split (the reference's ``long_500k``
    rewrite in ``repro/launch/dryrun.py``): a batch of 1 carries no
    parallelism, so ``batch`` maps to no axis and ``kv_seq`` to the batch
    axes, then ``model``."""
    return global_batch == 1


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def arch_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    if shape.name == "long_500k":
        return cfg.long_context_variant()
    return cfg


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict[str, Any]:
    """Meta-device stand-ins for the step function's data arguments."""
    b, t = shape.global_batch, shape.seq_len
    dt = tf.DTYPES[cfg.dtype]
    i32 = torch.int32
    if shape.kind == "train":
        batch: dict[str, Any] = {"labels": meta((b, t), i32)}
        if cfg.family == "audio":
            batch["frames"] = meta((b, t, cfg.d_model), dt)
        else:
            batch["tokens"] = meta((b, t), i32)
        if cfg.family == "vlm":
            batch["image_embeds"] = meta((b, cfg.n_image_tokens, cfg.d_model),
                                         dt)
        return {"batch": batch}
    if shape.kind == "prefill":
        toks = (meta((b, t, cfg.d_model), dt) if cfg.family == "audio"
                else meta((b, t), i32))
        out = {"tokens": toks}
        if cfg.family == "vlm":
            out["image_embeds"] = meta((b, cfg.n_image_tokens, cfg.d_model),
                                       dt)
        return out
    return {"token": meta((b, 1), i32),
            "state": tf.init_decode_state(cfg, b, t, device="meta")}


def batch_pspec(rules: dict, ndim: int, seq_dim: int | None = None) -> P:
    spec = [None] * ndim
    spec[0] = rules["batch"]
    if seq_dim is not None and rules.get("seq"):
        spec[seq_dim] = rules["seq"]
    return P(*spec)


def _state_leaves(tree) -> list:
    """The decode state's tensors, in its structure's order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _state_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _state_leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _state_leaves(getattr(tree, f.name))]
    if tree is None:
        return []
    return [x for v in tree for x in _state_leaves(v)]


def input_pspecs(cfg: ArchConfig, shape: InputShape, rules: dict) -> Any:
    """Specs matching :func:`input_specs`; the decode state's as a list,
    one a tensor of ``_state_leaves`` order: the batch dim (the first of the
    global batch's size) over the batch axes, and a KV cache's sequence dim
    (>= 1024 slots, right after the batch) over ``kv_seq``."""
    bspec = rules["batch"]
    if shape.kind == "train":
        batch = {"labels": P(bspec, None)}
        if cfg.family == "audio":
            batch["frames"] = P(bspec, rules["seq"], None)
        else:
            batch["tokens"] = P(bspec, None)
        if cfg.family == "vlm":
            batch["image_embeds"] = P(bspec, None, None)
        return {"batch": batch}
    if shape.kind == "prefill":
        toks = (P(bspec, rules["seq"], None) if cfg.family == "audio"
                else P(bspec, None))
        out = {"tokens": toks}
        if cfg.family == "vlm":
            out["image_embeds"] = P(bspec, None, None)
        return out

    def spec_for(leaf: torch.Tensor) -> P:
        names = [None] * leaf.dim()
        for i, d in enumerate(leaf.shape):
            if d == shape.global_batch:
                names[i] = bspec
                if leaf.dim() > i + 1 and leaf.shape[i + 1] >= KV_SPLIT_SLOTS:
                    names[i + 1] = rules["kv_seq"]
                break
        return P(*names)

    state = input_specs(cfg, shape)["state"]
    return {"token": P(bspec, None),
            "state": [spec_for(x) for x in _state_leaves(state)]}
