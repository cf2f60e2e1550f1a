"""Numpy checkpointer — port of ``repro.checkpoint.store``, in the
reference's on-disk format, so a checkpoint written by either package
restores in the other, bit for bit.

A tree is nested mappings of tensors: the engine's ``{"params": {name:
tensor}, "residuals": {client: {name: tensor}}}`` and the async ring
``{"ring": {"0": params, ...}}``. ``save`` writes ``<dir>/step_<n>.npz``
(every leaf on the host, keyed by its flattened tree path) and then the
manifest ``<dir>/step_<n>.json`` (``{"step", "leaves": {key: {shape,
dtype}}}``), each through a tmp file and ``os.replace``, the manifest last.

Leaf keys are the reference's: JAX's key path, each level ``[repr(key)]``
joined by ``::``. A string key is ``['k']`` and an int key (a client id)
``[k]``; a dotted name of the port's flat parameter dicts (``l0.w``) is the
reference's two levels, ``['l0']::['w']``. Leaves are written in JAX's
flatten order (keys sorted at each level). bf16 (no numpy dtype) is widened
to f32 on disk and cast back to the ``like`` leaf's dtype on restore.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

Tree = Any   # nested mappings of tensors

_SEP = "::"
_NUMPY_FLOATS = (torch.float64, torch.float32, torch.float16)


def _levels(key) -> list:
    """The reference's tree levels of one mapping key: a dotted string is
    one level a part, an int one level."""
    if isinstance(key, str):
        return key.split(".")
    return [int(key)]


def _key(levels: tuple) -> str:
    return _SEP.join(f"[{lv!r}]" for lv in levels)


def _flatten(tree: Tree, levels: tuple = ()) -> list:
    """``[(levels, key, leaf)]`` in JAX's flatten order."""
    if not isinstance(tree, Mapping):
        return [(levels, _key(levels), tree)]
    out = []
    for k, sub in tree.items():
        out += _flatten(sub, levels + tuple(_levels(k)))
    return sorted(out, key=lambda item: item[0])


def _map_keyed(fn: Callable, tree: Tree, levels: tuple = ()) -> Tree:
    """``fn(key, leaf)`` over every leaf, keeping the structure."""
    if isinstance(tree, Mapping):
        return {k: _map_keyed(fn, v, levels + tuple(_levels(k)))
                for k, v in tree.items()}
    return fn(_key(levels), tree)


def map_leaves(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn(leaf, *same_leaf_of_rest)`` over every leaf, keeping the
    structure of ``tree``."""
    if isinstance(tree, Mapping):
        return {k: map_leaves(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype.is_floating_point and t.dtype not in _NUMPY_FLOATS:
            t = t.float()          # bf16 and the like: f32 on disk
        return t.cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Tree) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {key: _to_numpy(leaf) for _, key, leaf in _flatten(tree)}
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp.npz"    # .npz suffix: np.savez appends none
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
    }
    # the manifest marks the step complete: tmp + rename, so a crash
    # mid-dump never leaves a truncated one
    mpath = os.path.join(ckpt_dir, f"step_{step:08d}.json")
    mtmp = mpath + ".tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, mpath)
    return path


def saved_steps(ckpt_dir: str) -> list[int]:
    """The steps of every ``step_<n>.npz`` in ``ckpt_dir``, unordered."""
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(m.group(1)) for f in os.listdir(ckpt_dir)
            if (m := re.match(r"step_(\d+)\.npz$", f))]


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = saved_steps(ckpt_dir)
    return max(steps) if steps else None


# --------------------------------------------------- publish / subscribe
# The serving loop treats a checkpoint directory as a single-writer,
# many-reader channel: the trainer publishes steps with ``publish`` (a plain
# ``save``: the manifest, written last and atomically, marks the step
# complete) and readers poll ``latest_published_step``, which surfaces only
# steps whose manifest exists and parses. A crash mid-publish (npz without a
# manifest) or a truncated manifest leaves the step invisible.

def publish(ckpt_dir: str, step: int, tree: Tree) -> str:
    """Atomically publish ``tree`` as ``step`` for polling subscribers."""
    return save(ckpt_dir, step, tree)


def _manifest_ok(ckpt_dir: str, step: int) -> bool:
    mpath = os.path.join(ckpt_dir, f"step_{step:08d}.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    return isinstance(manifest, dict) and manifest.get("step") == step


def latest_published_step(ckpt_dir: str,
                          after: Optional[int] = None) -> Optional[int]:
    """Newest complete step in ``ckpt_dir`` (npz present, manifest present
    and parseable), or None; with ``after``, only steps greater than it."""
    for s in sorted(saved_steps(ckpt_dir), reverse=True):
        if after is not None and s <= after:
            return None
        if _manifest_ok(ckpt_dir, s):
            return s
    return None


def _load(ckpt_dir: str, step: int, like: Tree,
          place: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
          ) -> Tree:
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as data:
        def leaf_of(key, leaf):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            return place(torch.from_numpy(arr).to(leaf.dtype), leaf)

        return _map_keyed(leaf_of, like)


def read_host(ckpt_dir: str, step: int, like: Tree, *,
              pin_memory: bool = False) -> Tree:
    """The checkpoint as host tensors of ``like``'s structure and dtypes
    (page-locked with ``pin_memory``, for an asynchronous copy)."""
    return _load(ckpt_dir, step, like,
                 lambda t, _: t.pin_memory() if pin_memory else t)


def restore(ckpt_dir: str, step: int, like: Tree) -> Tree:
    """Rebuild a tree of ``like``'s structure from disk, each leaf on the
    device and in the dtype of ``like``'s leaf. A leaf missing from the
    checkpoint raises ``KeyError``, a shape mismatch ``ValueError``."""
    return _load(ckpt_dir, step, like, lambda t, leaf: t.to(leaf.device))
