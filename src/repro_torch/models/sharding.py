"""Logical-axis sharding annotations — port of ``repro.models.sharding``.

The reference's model code calls ``shard(x, 'batch', None, 'model')`` with
*logical* axis names, and the launcher installs a mapping from logical names
to mesh axes; outside a mesh the calls are identity. The port runs a mesh in
one process, which holds whole tensors, so :func:`shard` keeps the rank
check and returns its input. The port's model code does not call it; the
rules are read by the layout helpers (``launch/shardings.py``,
``launch/specs.py``) through :func:`spec`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

import torch

_state = threading.local()


class PartitionSpec(tuple):
    """A sharding spec: one entry a dim, ``None`` (replicated), a mesh axis
    name or a tuple of them; ``P('data', None)`` as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def _mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: dict[str, Union[str, tuple, None]]):
    """Install ``rules`` (logical name -> mesh axis, a tuple of axes, or
    None) and ``mesh`` for the block, restoring the previous pair after."""
    prev_r, prev_m = _rules(), _mesh()
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev_r, prev_m


def spec(*logical: Optional[str]) -> PartitionSpec:
    """The mesh spec of a tensor whose dims carry these logical names."""
    rules = _rules() or {}
    return P(*[rules.get(ax) if ax is not None else None for ax in logical])


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x`` itself: one process holds the whole tensor. Inside a mesh the
    number of names must equal ``x``'s rank, as in the reference."""
    if _mesh() is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"rank mismatch: {len(logical)} names for shape "
                         f"{tuple(x.shape)}")
    return x


def param_sharding(path_names: Sequence[Optional[str]]) -> PartitionSpec:
    return spec(*path_names)
