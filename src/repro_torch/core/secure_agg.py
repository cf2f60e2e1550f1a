"""Secure aggregation with sparse encryption masks (paper Alg. 2, Eq. 5) —
port of the single-client protocol reference of ``repro.core.secure_agg``.

One client's unified stream for one leaf::

    idx   = concat(topk_idx, mask_support_idx)       # k + (x-1)*k_mask slots
    vals  = acc[idx] * first_occurrence(idx) + mask_vals
    resid = acc with every transmitted position zeroed (Alg. 2 line 17)

The encode itself is the stream engine's single implementation
(``streams.unified_stream_rows``) on the 1-block view of one client.

:func:`encode_update` encodes a whole update leaf by leaf,
:func:`aggregate_streams` decodes every client's streams of a leaf in one
scatter, and :func:`dense_masked_update` is the classic dense Bonawitz
baseline (full-size pairwise masks from the ``jax.random`` pair keys,
``core/threefry.py``), which the dense secure-aggregation round uses.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core import streams as se
from repro_torch.core import threefry
from repro_torch.core.masks import PairMask, client_masks, pair_key
from repro_torch.core.types import SecureAggConfig, SparseStream, THGSConfig


class EncodedLeaf(NamedTuple):
    stream: SparseStream
    residual: torch.Tensor


def encode_leaf(grad: torch.Tensor, residual: torch.Tensor, k: int,
                thgs: THGSConfig, mask: PairMask | None) -> EncodedLeaf:
    """Error-feedback accumulate -> top-k ∪ mask support -> unified stream,
    on the device of ``grad``.

    ``mask`` is the client's concatenated pair masks (``masks.client_masks``)
    or None. Returns the stream (int32 flat indices, f32 values, ``k +
    k_mask_total`` slots) and the new residual in ``residual``'s shape and
    dtype. The top-k is ``thgs.selector``'s ('local' is 'exact' on the
    one block).
    """
    acc = (residual + grad).to(torch.float32)
    flat = acc.reshape(1, 1, -1)             # [C=1, nb=1, m=size] block view
    if mask is not None and mask.indices.shape[0] > 0:
        m_idx = mask.indices[None, None, :]
        m_vals = mask.values[None, None, :]
    else:
        m_idx = m_vals = None
    ones = torch.ones((1,), dtype=torch.float32, device=acc.device)
    idx, vals, new_acc = se.unified_stream_rows(
        flat, k, m_idx, m_vals, selector=thgs.selector,
        sample_frac=thgs.sample_frac, weight=ones)
    return EncodedLeaf(
        stream=SparseStream(indices=idx[0, 0].to(torch.int32),
                            values=vals[0, 0]),
        residual=new_acc[0, 0].reshape(acc.shape).to(residual.dtype),
    )


def _leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def encode_update(update, residuals, ks: Sequence[int], thgs: THGSConfig,
                  sa: SecureAggConfig, client: int,
                  participants: Sequence[int], round_t: int):
    """Encode a whole update (a ``{name: tensor}`` dict in leaf order, or a
    list), leaf ``i`` with ``ks[i]`` and, under secure aggregation, the
    client's masks towards every other participant. Returns (streams,
    new residuals in ``update``'s structure)."""
    leaves = _leaves(update)
    res_leaves = _leaves(residuals)
    assert len(leaves) == len(res_leaves) == len(ks)
    streams, new_res = [], []
    for leaf_id, (g, r, k) in enumerate(zip(leaves, res_leaves, ks)):
        mask = None
        if sa.enabled and len(participants) >= 2:
            k_mask = sa.k_mask_for(g.numel(), len(participants))
            mask = client_masks(sa, client, participants, round_t, leaf_id,
                                g.numel(), k_mask, device=g.device)
        enc = encode_leaf(g, r, k, thgs, mask)
        streams.append(enc.stream)
        new_res.append(enc.residual)
    if isinstance(update, dict):
        return streams, dict(zip(update, new_res))
    return streams, new_res


def aggregate_streams(client_streams, leaf_shapes, leaf_dtypes,
                      weights: Sequence[float] | None = None) -> list:
    """Server decode and sum: every client's stream of a leaf (zero-padded
    to the longest: index 0, value 0) in ONE scatter
    (``streams.decode_sum_blocks``), weighted server-side (exact only for
    uniform weights; weighted FL weights client-side at encode). Returns
    each leaf's sum in its shape and dtype."""
    n_clients = len(client_streams)
    if weights is None:
        weights = [1.0 / n_clients] * n_clients
    dev = client_streams[0][0].indices.device
    w = torch.tensor(weights, dtype=torch.float32, device=dev)
    out = []
    for leaf_id, shape in enumerate(leaf_shapes):
        size = 1
        for d in shape:
            size *= d
        ks = [client_streams[c][leaf_id].indices.shape[0]
              for c in range(n_clients)]
        k_max = max(ks)
        pad = torch.nn.functional.pad
        idx = torch.stack([
            pad(client_streams[c][leaf_id].indices, (0, k_max - ks[c]))
            for c in range(n_clients)])[:, None, :]
        vals = torch.stack([
            pad(client_streams[c][leaf_id].values.to(torch.float32),
                (0, k_max - ks[c]))
            for c in range(n_clients)])[:, None, :]
        dense = se.decode_sum_blocks(se.StreamBatch(indices=idx, values=vals),
                                     1, size, weights=w)
        out.append(dense.reshape(shape).to(leaf_dtypes[leaf_id]))
    return out


def dense_masked_update(update_leaf: torch.Tensor, sa: SecureAggConfig,
                        client: int, participants: Sequence[int],
                        round_t: int, leaf_id: int) -> torch.Tensor:
    """Classic (non-sparse) Bonawitz masking of a dense update leaf, the SA
    baseline: for every other participant ``b``, ``uniform(fold_in(
    pair_key(client, b), leaf_id), [size], p, p + q)`` added with sign +1
    when ``client < b``, else -1. Every element is transmitted; the masks
    cancel in the plain sum. f32, on the leaf's device."""
    flat = update_leaf.reshape(-1).to(torch.float32)
    for b in participants:
        if b == client:
            continue
        k = threefry.fold_in(pair_key(sa, client, b, round_t), leaf_id)
        mag = threefry.uniform(k, flat.shape, sa.p, sa.p + sa.q,
                               device=flat.device)
        sign = torch.tensor(1.0 if client < b else -1.0, dtype=torch.float32,
                            device=flat.device)
        flat = flat + sign * mag
    return flat.reshape(update_leaf.shape)
