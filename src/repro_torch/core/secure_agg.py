"""Secure aggregation with sparse encryption masks (paper Alg. 2, Eq. 5) —
port of the single-client protocol reference of ``repro.core.secure_agg``.

One client's unified stream for one leaf::

    idx   = concat(topk_idx, mask_support_idx)       # k + (x-1)*k_mask slots
    vals  = acc[idx] * first_occurrence(idx) + mask_vals
    resid = acc with every transmitted position zeroed (Alg. 2 line 17)

The encode itself is the stream engine's single implementation
(``streams.unified_stream_rows``) on the 1-block view of one client.

This slice ports :class:`EncodedLeaf` and :func:`encode_leaf` only, what the
``agg`` bench suite's per-client loop needs. The rest of the reference
module (``encode_update``, ``aggregate_streams``, ``dense_masked_update``)
comes with slice I1 (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import streams as se
from repro_torch.core.masks import PairMask
from repro_torch.core.types import SparseStream, THGSConfig


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
    dtype. Only the 'exact' selector is ported (slice I2 brings the others).
    """
    if thgs.selector != "exact":
        raise NotImplementedError(
            f"selector {thgs.selector!r} is not ported to repro_torch yet; "
            "it comes with slice I2 (ROADMAP.md, Queue 1)")
    acc = (residual + grad).to(torch.float32)
    flat = acc.reshape(1, 1, -1)             # [C=1, nb=1, m=size] block view
    if mask is not None and mask.indices.shape[0] > 0:
        m_idx = mask.indices[None, None, :]
        m_vals = mask.values[None, None, :]
    else:
        m_idx = m_vals = None
    ones = torch.ones((1,), dtype=torch.float32, device=acc.device)
    idx, vals, new_acc = se.unified_stream_rows(flat, k, m_idx, m_vals,
                                                weight=ones)
    return EncodedLeaf(
        stream=SparseStream(indices=idx[0, 0].to(torch.int32),
                            values=vals[0, 0]),
        residual=new_acc[0, 0].reshape(acc.shape).to(residual.dtype),
    )
