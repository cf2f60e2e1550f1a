"""Block layouts of the datacenter path — port of ``repro.core.blocked``.

The production FL step splits each leaf into ``n_blocks`` contiguous blocks
(one a device of a participant in the reference's mesh) and runs the stream
engine's encode per block: block-local THGS top-k ∪ the keyed pair masks
(``streams.encode_client_blocks``). This module owns the layout:
``block_layout`` (generic padded row blocks) and
:func:`sharding_aligned_transform` (the view in which block ``i`` is device
``i``'s shard).

The port runs a participant in one process, so the layout depends only on
the logical mesh shape, and ``block_sharding`` (the reference's sharding
constraint on the block view) is accepted and ignored: a single process
holds whole tensors. :func:`decode_blocked_sum` scatters through
``kernels/ops.stream_scatter_add``: on the card the hand-written kernel,
which folds each position in slot order, as the reference's ``.at[].add``
does on the CPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import streams as se
from repro_torch.core.streams import block_layout
from repro_torch.kernels import ops

__all__ = ["BlockedStream", "block_layout", "sharding_aligned_transform",
           "encode_leaf_blocked", "decode_blocked_sum"]


class BlockedStream(NamedTuple):
    indices: torch.Tensor   # int32[n_blocks, k_total] global flat indices
    values: torch.Tensor    # f32[n_blocks, k_total]


def sharding_aligned_transform(shape, pspec, axis_sizes: dict,
                               intra_order: tuple):
    """Blocked view of a sharded leaf in which block ``i`` is device
    ``i``'s shard: each dim the spec shards is split into ``(axis_size,
    dim / axis_size)``, the axis-sized dims move to the front (in
    ``intra_order``) and the rest flattens.

    Returns ``(to_blocks, from_blocks, n_blocks, m, front_axes)``, or None
    when the spec has a multi-axis entry or a dim that does not divide
    (the caller takes the generic layout) or shards nothing."""
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    split_shape, perm_front, rest_positions = [], {}, []
    pos = 0
    for d, ax in zip(shape, spec):
        if ax is None:
            split_shape.append(d)
            rest_positions.append(pos)
            pos += 1
        elif isinstance(ax, str) and ax in axis_sizes \
                and d % axis_sizes[ax] == 0:
            n = axis_sizes[ax]
            split_shape += [n, d // n]
            perm_front[ax] = pos
            rest_positions.append(pos + 1)
            pos += 2
        else:
            return None
    front = [perm_front[a] for a in intra_order if a in perm_front]
    if not front:
        return None
    perm = front + rest_positions
    n_blocks = math.prod(axis_sizes[a] for a in intra_order
                         if a in perm_front)
    m = math.prod(split_shape[i] for i in rest_positions)
    inv_perm = sorted(range(len(perm)), key=perm.__getitem__)
    shape = tuple(shape)

    def to_blocks(x):
        return x.reshape(split_shape).permute(perm).reshape(n_blocks, m)

    def from_blocks(b):
        mid = [split_shape[i] for i in perm]
        return b.reshape(mid).permute(inv_perm).reshape(shape)

    front_axes = tuple(a for a in intra_order if a in perm_front)
    return to_blocks, from_blocks, n_blocks, m, front_axes


def encode_leaf_blocked(
    g: torch.Tensor,
    residual: torch.Tensor,
    k_block: int,
    n_blocks: int,
    *,
    mask_key: torch.Tensor | None = None,
    k_mask_block: int = 0,
    n_peers: int = 0,
    self_id: int | None = None,
    mask_lo: float = -1.0,
    mask_q: float = 2.0,
    block_sharding=None,
    transform=None,
    masks: tuple | None = None,
) -> tuple[BlockedStream, torch.Tensor]:
    """Error-feedback accumulate, then block-local top-k ∪ pairwise mask
    support, on ``g``'s device.

    ``acc = f32(residual) + f32(g)`` in the ``[n_blocks, m]`` view (the
    generic zero-padded row blocks, or ``transform``'s). With a mask key,
    participant ``self_id`` of ``n_peers`` takes its row of
    ``streams.fold_pair_keys_row(mask_key, self_id, n_peers)``: the pair
    masks cancel in the participants' sum. ``masks`` is that row's
    ``(m_idx, m_vals, signs_row)`` drawn beforehand (the FL step times the
    draws apart). ``block_sharding`` is ignored (one process holds the
    whole leaf). Returns the stream and the new residual in ``residual``'s
    shape and dtype."""
    size = g.numel()
    if transform is not None:
        to_b, from_b, n_blocks, m = transform[:4]
    else:
        n_blocks, m, _ = block_layout(size, n_blocks)

        def to_b(x):
            return se.to_blocks(x, n_blocks, m)

        from_b = None
    k_block = int(min(k_block, m))
    blocks = (to_b(residual).to(torch.float32)
              + to_b(g).to(torch.float32))
    keys_row = signs_row = drawn = None
    if mask_key is not None and k_mask_block > 0 and n_peers >= 2:
        if masks is not None:
            *drawn, signs_row = masks
        else:
            keys_row, signs_row = se.fold_pair_keys_row(mask_key, self_id,
                                                        n_peers)
    else:
        k_mask_block = 0
    global_idx, vals, new_blocks = se.encode_client_blocks(
        blocks, k_block, pair_keys_row=keys_row, pair_signs_row=signs_row,
        k_mask=k_mask_block, mask_p=mask_lo, mask_q=mask_q, masks=drawn)
    if from_b is not None:
        new_resid = from_b(new_blocks)
    else:
        new_resid = new_blocks.reshape(-1)[:size].reshape(g.shape)
    return (BlockedStream(indices=global_idx, values=vals),
            new_resid.to(residual.dtype))


def decode_blocked_sum(streams_idx: torch.Tensor, streams_vals: torch.Tensor,
                       size: int, n_blocks: int, weight: float,
                       block_sharding=None, transform=None) -> torch.Tensor:
    """Scatter-add gathered streams ``[n_fed, nb, k]`` (participant-major,
    then block, then slot: the slot order of the fold) times ``f32(weight)``
    into the dense ``[nb, m]`` view, through ``ops.stream_scatter_add`` (one
    launch). Returns the leaf (``transform``'s inverse) or the flat
    ``f32[size]``. ``block_sharding`` is ignored."""
    if transform is not None:
        from_b, nb, m = transform[1], transform[2], transform[3]
    else:
        nb, m, _ = block_layout(size, n_blocks)
        from_b = None
    vals = streams_vals.reshape(-1).to(torch.float32)
    vals = vals * torch.tensor(weight, dtype=torch.float32,
                               device=vals.device)
    dense = ops.stream_scatter_add(streams_idx.reshape(-1), vals,
                                   size=nb * m)
    if from_b is not None:
        return from_b(dense.reshape(nb, m))
    return dense[:size]
