"""Parameter PartitionSpecs by leaf-name rules — port of
``repro.launch.shardings``, as pure layout over the reference's leaf paths.

Weights shard the contraction-input dim over the ``fsdp`` logical axis and
the parallel dim over ``model``; stacked layer dims stay replicated. The
rules are keyed on the leaf's last name, so every family resolves from one
table. A leaf path is the reference's dotted tree path
(``blocks.mlp.wi_gate``; ``convert.reference_leaves``).

Two differences from the reference: the mesh's axis sizes reach
:func:`_resolve` as an argument, where the reference sets the module global
``_AXIS_SIZES`` inside ``param_specs``; and ``named`` (specs to
``NamedSharding``s) has no counterpart, since one process holds every tensor
whole.
"""
from __future__ import annotations

from typing import Mapping, Optional

from repro_torch.core.streams import CLIENT_AXIS, shard_client_tree  # noqa: F401
from repro_torch.models.sharding import P

# leaf name -> logical spec for its LAST len(spec) dims (leading dims None)
_RULES: dict[str, tuple] = {
    # embeddings / heads: the embed table shards its feature dim
    "embed": (None, "model"),
    "lm_head": ("fsdp", "vocab"),
    # attention projections (d_in, d_out-parallel)
    "wq": ("fsdp", "model"),
    "wk": ("fsdp", "model"),
    "wv": ("fsdp", "model"),
    "wo": ("model", "fsdp"),
    # dense MLP
    "wi": ("fsdp", "model"),
    "wi_gate": ("fsdp", "model"),
    "wi_up": ("fsdp", "model"),
    # moe (rank-3 expert weights resolved below by rank)
    "router": ("fsdp", None),
    "shared_wi_gate": ("fsdp", "model"),
    "shared_wi_up": ("fsdp", "model"),
    "shared_wo": ("model", "fsdp"),
    # ssm
    "in_proj": ("fsdp", "model"),
    "out_proj": ("model", "fsdp"),
    "conv_w": (None, "model"),
    "A_log": ("heads",),
    "D": ("heads",),
    "dt_bias": ("heads",),
    # xlstm
    "w_in": ("fsdp", "model"),
    "w_qkv": ("fsdp", "model"),
    "w_if": ("fsdp", None),
    "w_o": ("fsdp", "model"),
    "w_out": ("model", "fsdp"),
    "r": (None, "model", None),
    # norms / biases
    "scale": (None,),
    "bias": (None,),
    "b": (None,),
}

_MOE_RANK3 = {
    "wi_gate": ("expert", "fsdp", None),
    "wi_up": ("expert", "fsdp", None),
    "wo": ("expert", None, "fsdp"),
}


def leaf_rule(path: str, shape) -> tuple:
    """The logical names of the leaf's trailing dims that its rule covers
    (all its dims, unnamed, where no rule matches); the dims before them
    are stacked layers (replicated)."""
    keys = path.split(".")
    name = keys[-1]
    base: Optional[tuple] = None
    if "moe" in keys and name in _MOE_RANK3:
        base = _MOE_RANK3[name]
    elif name in _RULES:
        base = _RULES[name]
    if base is None:
        base = (None,) * len(shape)
    return tuple(base[-len(shape):]) if len(base) > len(shape) else base


def _leaf_logical(path: str, shape) -> tuple:
    """Logical names of every dim of the leaf at dotted ``path``."""
    base = leaf_rule(path, shape)
    return (None,) * (len(shape) - len(base)) + tuple(base)


def _resolve(logical: tuple, rules: dict, shape: tuple,
             axis_sizes: Mapping[str, int]) -> P:
    """Logical names -> mesh spec; a dim that the target axes do not divide
    stays replicated."""
    phys = []
    for ax, dim in zip(logical, shape):
        target = rules.get(ax) if ax is not None else None
        if target is None:
            phys.append(None)
            continue
        n = 1
        for t in (target if isinstance(target, tuple) else (target,)):
            n *= axis_sizes.get(t, 1)
        phys.append(target if dim % max(n, 1) == 0 else None)
    return P(*phys)


def axis_sizes_of(mesh) -> dict:
    """``{axis name: size}`` of a mesh (``launch.mesh.LogicalMesh``) or an
    already explicit mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def param_specs(leaf_shapes: Mapping[str, tuple], rules: dict,
                mesh) -> dict:
    """``{path: PartitionSpec}`` for ``{path: shape}`` (the reference's leaf
    paths, in its order) on ``mesh`` (a ``LogicalMesh`` or its axis
    sizes)."""
    sizes = axis_sizes_of(mesh)
    return {path: _resolve(_leaf_logical(path, shape), rules, tuple(shape),
                           sizes)
            for path, shape in leaf_shapes.items()}
