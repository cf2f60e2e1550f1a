"""Core datatypes for THGS + sparse secure aggregation (port of
``repro.core.types``).

Every stream size (``k`` for top-k, ``k_mask`` per pair) is a Python int
decided host-side from the sparsity schedules.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class SparseStream:
    """Static-shape sparse encoding of one tensor (one THGS layer/leaf).

    ``indices`` index into the flattened tensor; ``values`` carry
    ``acc[idx] * first_occurrence + mask`` per slot (``core/streams.py``).
    Duplicate indices are allowed; scatter-add semantics resolve them.
    """

    indices: torch.Tensor  # int32[k_total]
    values: torch.Tensor   # f32[k_total]

    @property
    def k(self) -> int:
        return self.indices.shape[-1]


@dataclasses.dataclass(frozen=True)
class THGSConfig:
    """Time-varying hierarchical gradient sparsification (Alg. 1, Eq. 1-2)."""

    s0: float = 0.1            # initial (layer-1) sparsity rate, Eq. 1
    alpha: float = 0.8         # per-layer attenuation factor, Eq. 1
    s_min: float = 0.01        # lower bound of the layer schedule, Eq. 1
    # Eq. 2 time-varying round schedule: R <- (alpha_t + beta - t/T) * R
    time_varying: bool = True
    alpha_t: float = 0.8       # constant attenuation factor of Eq. 2
    r_min: float = 0.001       # lower bound of the round schedule
    # Selector: 'exact' top-k | 'sampled' threshold from a subsample |
    # 'local' per-block top-k (the caller pre-blocks; 'exact' on a block)
    selector: str = "exact"
    sample_frac: float = 0.01  # for selector='sampled'
    # k values are quantized to this many geometric levels
    k_levels: int = 16

    def validate(self) -> None:
        if not (0.0 < self.s0 <= 1.0):
            raise ValueError(f"s0 must be in (0,1], got {self.s0}")
        if not (0.0 < self.alpha <= 1.0):
            raise ValueError(f"alpha must be in (0,1], got {self.alpha}")
        if self.s_min <= 0 or self.s_min > self.s0:
            raise ValueError(f"need 0 < s_min <= s0, got {self.s_min} vs {self.s0}")
        if self.selector not in ("exact", "sampled", "local"):
            raise ValueError(f"unknown selector {self.selector!r}")


@dataclasses.dataclass(frozen=True)
class SecureAggConfig:
    """Sparse-mask secure aggregation (Alg. 2, Eq. 3-5)."""

    enabled: bool = True
    # Eq. 4: per-pair mask support fraction = mask_ratio / x participants
    mask_ratio: float = 0.01
    # uniform mask distribution support [p, p + q) (paper §3.2)
    p: float = -1.0
    q: float = 2.0
    seed: int = 0x5EC0DE
    # Shamir threshold fraction (Bonawitz t-of-n)
    threshold: float = 0.6

    def k_mask_for(self, size: int, n_clients: int) -> int:
        if not self.enabled or n_clients < 2:
            return 0
        return max(1, int(size * self.mask_ratio / n_clients))

    def t_for(self, n_clients: int) -> int:
        """Shamir threshold t for an n-client cohort (>= 2, <= n)."""
        if n_clients < 2:
            return 0
        # epsilon-nudged ceil: 0.55 * 100 is 55.00000000000001 in binary
        return min(n_clients,
                   max(2, math.ceil(self.threshold * n_clients - 1e-9)))


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Federated optimization settings (paper §5 protocol)."""

    n_clients: int = 100
    clients_per_round: int = 10
    local_steps: int = 5
    local_batch: int = 50
    local_lr: float = 0.1
    server_lr: float = 1.0
    prox_mu: float = 0.0          # FedProx proximal coefficient (0 => FedAvg)
    rounds: int = 100             # T in Eq. 2
    algorithm: str = "fedavg"     # 'fedavg' | 'fedprox'


@dataclasses.dataclass
class CommRecord:
    """Bit accounting for one aggregation round (Eq. 6-8).

    Totals are under the round's ``BitModel``; the slot-level facts (``ks``,
    ``k_masks``, participant/survivor counts, Shamir ``threshold``, model
    size) let the ledger re-derive any accounting. ``staleness`` keeps the
    reference's schema at its synchronous default (async rounds are not
    ported yet).
    """

    round: int = 0
    upload_bits: int = 0
    download_bits: int = 0
    dense_upload_bits: int = 0
    share_upload_bits: int = 0
    share_download_bits: int = 0
    recovery_upload_bits: int = 0
    n_clients: int = 0
    n_survivors: int = 0
    threshold: int = 0
    model_size: int = 0
    ks: tuple = ()
    k_masks: tuple = ()
    codec: str = "f32"
    leaf_sizes: tuple = ()
    staleness: tuple = ()
    dp_clip: float = 0.0
    dp_sigma: float = 0.0
    dp_delta: float = 0.0

    @property
    def compression(self) -> float:
        return self.dense_upload_bits / max(self.upload_bits, 1)


def quantize_k(k: int, size: int, levels: int) -> int:
    """Snap k to one of ``levels`` geometric levels of ``size``."""
    if k <= 1:
        return 1
    if k >= size:
        return size
    pos = math.log(k) / math.log(size)  # in (0, 1)
    snapped = round(pos * levels) / levels
    return max(1, min(size, int(round(size ** snapped))))


def _tree_leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def tree_size(tree) -> int:
    """Elements over every tensor of a tree (e.g. a ``{name: tensor}``
    parameter dict)."""
    return sum(x.numel() for x in _tree_leaves(tree))


def tree_zeros_like(tree, dtype=None):
    """A tree of zeros of the tree's shapes and devices, in ``dtype`` or
    each tensor's own."""
    if isinstance(tree, dict):
        return {k: tree_zeros_like(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_zeros_like(v, dtype) for v in tree)
    return torch.zeros_like(tree, dtype=dtype or tree.dtype)
