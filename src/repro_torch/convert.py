"""Parameter exchange with the reference layout.

The port's modules hold every leaf in the reference's name, shape and order
(``models/paper_models.py``, ``models/transformer.py``), so a parameter tree
of the JAX package, converted to numpy, loads by a plain checked copy.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.paper_models import PaperModel, build_model


def _flat_tree(tree: Mapping, prefix: str = "") -> dict:
    """Nested mappings (or already flat ``{"a.b": leaf}``) ->
    ``{"a.b.c": leaf}``."""
    out = {}
    for key, sub in tree.items():
        name = f"{prefix}{key}"
        if isinstance(sub, Mapping):
            out.update(_flat_tree(sub, name + "."))
        else:
            out[name] = sub
    return out


def params_from_jax(tree: Mapping, model_name: str) -> PaperModel:
    """A ``model_name`` module holding the arrays of ``tree`` (numpy or any
    array convertible by ``np.asarray``), checked leaf by leaf: the names
    must be exactly the model's and every shape must match."""
    model = build_model(model_name)
    flat = _flat_tree(tree)
    want = model.leaf_names()
    if sorted(flat) != sorted(want):
        missing = sorted(set(want) - set(flat))
        extra = sorted(set(flat) - set(want))
        raise ValueError(f"{model_name}: parameter names differ — missing "
                         f"{missing}, unexpected {extra}")
    with torch.no_grad():
        for name, p in model.params().items():
            arr = np.array(flat[name], dtype=np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{model_name}: {name} has shape "
                                 f"{tuple(arr.shape)}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    return model


def lm_params_from_jax(tree: Mapping, cfg: ArchConfig,
                       device="cpu") -> tf.TransformerLM:
    """A ``TransformerLM`` holding the arrays of the reference's
    ``transformer.init_params(cfg, key)`` tree (numpy or any array that
    ``np.asarray`` converts). The reference stacks the blocks on a leading
    layer axis; layer ``i`` of ``params["blocks"]`` loads into
    ``blocks[i]``. Every name and shape is checked; weights keep the
    ``[d_in, d_out]`` layout."""
    model = tf.init_params(cfg, device=device)
    flat = _flat_tree(tree)
    targets = {}                     # reference name -> [(layer, param)]
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            targets.setdefault("blocks." + ".".join(parts[2:]), []).append(
                (int(parts[1]), p))
        else:
            targets[name] = [(None, p)]
    if sorted(flat) != sorted(targets):
        missing = sorted(set(targets) - set(flat))
        extra = sorted(set(flat) - set(targets))
        raise ValueError(f"{cfg.name}: parameter names differ — missing "
                         f"{missing}, unexpected {extra}")
    with torch.no_grad():
        for name, dests in targets.items():
            arr = np.asarray(flat[name], dtype=np.float32)
            for layer, p in dests:
                want = tuple(p.shape) if layer is None else \
                    (cfg.n_layers,) + tuple(p.shape)
                if tuple(arr.shape) != want:
                    raise ValueError(f"{cfg.name}: {name} has shape "
                                     f"{tuple(arr.shape)}, expected {want}")
                src = arr if layer is None else arr[layer]
                p.copy_(torch.from_numpy(np.array(src)))
    return model
