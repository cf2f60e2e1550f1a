"""Parameter exchange with the reference layout.

The port's modules hold every leaf in the reference's name, shape and order
(``models/paper_models.py``, ``models/transformer.py``), so a parameter tree
of the JAX package, converted to numpy, loads by a plain checked copy.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

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


def _stacks(named) -> dict:
    """``(port name, leaf)`` pairs -> ``{reference name: [(index, leaf)]}``:
    the numeric parts of ``self_blocks.1.2.attn.wq`` index the reference's
    stacked axes of ``self_blocks.attn.wq``."""
    groups: dict = {}
    for name, leaf in named:
        parts = name.split(".")
        index = tuple(int(x) for x in parts if x.isdigit())
        ref_name = ".".join(x for x in parts if not x.isdigit())
        groups.setdefault(ref_name, []).append((index, leaf))
    return groups


def _lead(items) -> tuple:
    """The stacked axes' sizes: one past the largest index on each."""
    return tuple(max(ix[a] for ix, _ in items) + 1
                 for a in range(len(items[0][0])))


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
    ``np.asarray`` converts), for every family.

    The reference stacks repeated blocks on leading axes: ``blocks`` and the
    xLSTM ``slstm`` / ``mlstm`` on one (the layer), the VLM's
    ``self_blocks`` and the hybrid's ``ssm_blocks`` on two (super-block,
    layer in it), ``cross_blocks`` on one; ``shared_block`` is one block.
    The port's name ``self_blocks.1.2.attn.wq`` loads
    ``tree["self_blocks"]["attn"]["wq"][1, 2]``. A MoE expert leaf keeps its
    E axis after the layer axis. Every name and every shape is checked;
    weights keep the ``[d_in, d_out]`` layout."""
    model = tf.init_params(cfg, device=device)
    flat = _flat_tree(tree)
    targets = _stacks(model.named_parameters())
    if sorted(flat) != sorted(targets):
        missing = sorted(set(targets) - set(flat))
        extra = sorted(set(flat) - set(targets))
        raise ValueError(f"{cfg.name}: parameter names differ — missing "
                         f"{missing}, unexpected {extra}")
    with torch.no_grad():
        for name, dests in targets.items():
            arr = np.asarray(flat[name], dtype=np.float32)
            want = _lead(dests) + tuple(dests[0][1].shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"{cfg.name}: {name} has shape "
                                 f"{tuple(arr.shape)}, expected {want}")
            for index, p in dests:
                p.copy_(torch.from_numpy(np.array(arr[index])))
    return model


def lm_tree_to_numpy(model_or_grads, cfg: ArchConfig) -> dict:
    """The inverse of ``lm_params_from_jax``: a ``TransformerLM`` (or a
    ``{name: tensor}`` mapping with its parameter names, such as the
    gradients of ``launch.train.value_and_grad``) as the reference's nested
    tree of numpy arrays, repeated blocks stacked on their leading axes
    (``self_blocks.1.2.attn.wq`` at ``tree["self_blocks"]["attn"]["wq"][1,
    2]``, a MoE expert axis after the layer axis). Values are float32 (numpy
    has no bfloat16; the widening is exact), so
    ``lm_params_from_jax(lm_tree_to_numpy(m, cfg), cfg)`` holds ``m``'s
    values bit for bit. Sharded parameters (``launch.fsdp.ShardedLM``) are
    gathered whole, one parameter at a time (``launch.fsdp.shard_reference``
    is the way back)."""
    if hasattr(model_or_grads, "named_full"):
        named = model_or_grads.named_full()
    elif isinstance(model_or_grads, torch.nn.Module):
        named = model_or_grads.named_parameters()
    else:
        named = model_or_grads.items()
    tree: dict = {}
    for ref_name, items in _stacks(named).items():
        lead = _lead(items)
        arr = np.zeros(lead + tuple(items[0][1].shape), np.float32)
        if len(items) != int(np.prod(lead, dtype=np.int64)):
            raise ValueError(f"{cfg.name}: {ref_name} has {len(items)} "
                             f"blocks for a stack of {lead}")
        for index, t in items:
            arr[index] = t.detach().float().cpu().numpy()
        node = tree
        *path, leaf = ref_name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


class RefLeaf(NamedTuple):
    """One leaf of the reference's parameter tree, seen from the port."""

    path: str      # the reference's dotted tree path, "blocks.mlp.wi_gate"
    shape: tuple   # its (stacked) shape: lead + the port parameter's shape
    lead: tuple    # the stacked axes' sizes; () for an unstacked leaf
    names: tuple   # the port parameters it stacks, in row-major order


def reference_leaves(model: torch.nn.Module) -> list[RefLeaf]:
    """The reference's leaves of a ``TransformerLM`` in
    ``jax.tree_util.tree_leaves`` order (dict keys sorted at every level),
    each with the port parameters it stacks (``blocks.mlp.wi_gate`` stacks
    ``blocks.0.mlp.wi_gate`` ... ``blocks.31.mlp.wi_gate`` on a leading
    layer axis). This order is the FL step's leaf id: it keys the pair
    masks, picks each leaf's rate of the Eq. 1 hierarchy and orders the
    residual tree. Sharded parameters (``launch.fsdp.ShardedLM``) give the
    leaves of their ``meta`` model."""
    model = getattr(model, "meta", model)
    named = [(n, (n, tuple(p.shape))) for n, p in model.named_parameters()]
    out = []
    for path, items in _stacks(named).items():
        lead = _lead(items)
        if len(items) != int(np.prod(lead, dtype=np.int64)):
            raise ValueError(f"{path} has {len(items)} blocks for a stack "
                             f"of {lead}")
        items = sorted(items, key=lambda it: it[0])
        shape = lead + items[0][1][1]
        out.append(RefLeaf(path, shape, lead,
                           tuple(name for _, (name, _) in items)))
    return sorted(out, key=lambda leaf: tuple(leaf.path.split(".")))
