"""Parameter exchange with the reference layout.

The port's modules hold every leaf in the reference's name, shape and order
(``models/paper_models.py``), so a parameter tree of the JAX package,
converted to numpy, loads by a plain checked copy.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.paper_models import PaperModel, build_model


def _flat_items(tree: Mapping) -> dict:
    """``{outer: {inner: array}}`` or ``{"outer.inner": array}`` -> flat."""
    out = {}
    for outer, sub in tree.items():
        if isinstance(sub, Mapping):
            for inner, arr in sub.items():
                out[f"{outer}.{inner}"] = arr
        else:
            out[str(outer)] = sub
    return out


def params_from_jax(tree: Mapping, model_name: str) -> PaperModel:
    """A ``model_name`` module holding the arrays of ``tree`` (numpy or any
    array convertible by ``np.asarray``), checked leaf by leaf: the names
    must be exactly the model's and every shape must match."""
    model = build_model(model_name)
    flat = _flat_items(tree)
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

