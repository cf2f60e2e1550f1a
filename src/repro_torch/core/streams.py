"""The unified sparse-stream engine (paper Alg. 1/2, Eq. 5) — port of
``repro.core.streams``: the encode, the flat and the hierarchical (tree)
decode, the wire codecs, the DP release and the client-sharded leaf.

A stream for one leaf is a static-shape pair ``(indices, values)``:

    indices : int32[C, n_blocks, k_total]  global indices row*m + col into the
                                           padded [n_blocks, m] block view
    values  : f32  [C, n_blocks, k_total]  w·acc[idx]·first_occurrence + mask

with a leading client axis. ``n_blocks == 1, m == size`` is the flat per-leaf
stream of the paper's single-host protocol. The encode is written batched over
the client axis (the reference vmaps a per-client program); the decode
flattens every client's gated stream into one index/value vector and
scatter-adds it in one pass through ``kernels/ops.stream_scatter_add``; the
tree decode splits that pass over sub-aggregators that each own a contiguous
index range of the dense buffer, one launch each, combined by concatenation.

Pairwise masks are counter-based: per-pair uint32 seeds (DH-derived,
Shamir-recoverable; ``secagg/protocol.py``) drive the murmur streams of the
pair-mask kernel. :func:`mask_streams_round` makes every leaf's masks of a
round in one launch (``kernels/ops.pair_mask_segments``: the leaf-seed fold,
the triangle mirror, the signs and the per-client layout inside the kernel)
from the round's seed and sign matrices, copied to the card once
(:func:`round_matrices`); the encode takes them through ``masks=``. Client
weights scale the gradient part of the values before masking, so weighted
aggregation keeps mask cancellation exact. Dropout recovery regenerates
every survivor->dropped pair mask from the reconstructed seeds and subtracts
it: :func:`recovery_streams_round`, one more launch a dropout round for every
leaf, handed to the decode through ``recovery=``. The per-leaf functions
(:func:`mask_streams_all_pairs`, :func:`dropout_cancel_streams_seeded`) are
the counterparts of the reference's and the round functions' plain version
on the CPU.

Every operation keeps the reference's float order so the data plane is
bit-equal to it on shared inputs: top-k ties resolve to the lower index
(a stable descending sort, as ``lax.top_k``), the first-occurrence gate sorts
stably, and the decode folds each position in slot order.

A non-f32 ``codec`` quantizes each client's stream values row-wise, absorbs
the quantization error into the error feedback, and sends the stream
through the packed uint32 word wire (``core/codecs.py``: one
``bitpack_rows`` and one ``bitunpack_rows`` launch per leaf, each over the
index and the value stream). ``dp_sigma
> 0`` switches the encode to the DP release shape (``core/dp.py``): the
data slots release the round's public common support, mask slots carry
masks only, and grid-rounded noise is added to every released slot.

The client-parallel round (:func:`encode_decode_leaf_sharded`, DESIGN.md
§11) splits the cohort over a 1-D ``clients`` mesh of devices driven by one
process (``launch/mesh.py``): each shard encodes its clients on its device,
its rows of the pair masks from ONE row launch of the pair-mask kernel a
round (:func:`mask_streams_rows_round`) and, under a codec, its packed
words from one ``bitpack_rows`` launch a leaf; the wire payload is gathered
in client order onto the decode device (:func:`all_gather_round`, the one
collective) and decoded once there, bit-equal to the serial round.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import codecs
from repro_torch.core import dp as dp_mod
from repro_torch.core import masks
from repro_torch.core import sparsify
from repro_torch.core import threefry
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref


# the 1-D mesh axis of the client-parallel round (``launch/mesh.py``)
CLIENT_AXIS = "clients"


class StreamBatch(NamedTuple):
    """Stacked unified streams: leading axis = clients."""

    indices: torch.Tensor  # int32[C, n_blocks, k_total]
    values: torch.Tensor   # f32  [C, n_blocks, k_total]


# --------------------------------------------------------------------- layout
def block_layout(size: int, n_blocks: int) -> tuple[int, int, int]:
    """(n_blocks, block_len, padded) — small leaves collapse to one block."""
    if size < 4 * n_blocks:
        n_blocks = 1
    m = -(-size // n_blocks)
    return n_blocks, m, n_blocks * m


def to_blocks(x: torch.Tensor, n_blocks: int, m: int) -> torch.Tensor:
    """Flat/leaf tensor -> padded [n_blocks, m] row-major block view."""
    flat = x.reshape(-1)
    pad = n_blocks * m - flat.shape[0]
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(n_blocks, m)


def from_blocks(blocks: torch.Tensor, size: int, shape: tuple) -> torch.Tensor:
    return blocks.reshape(-1)[:size].reshape(shape)


# ------------------------------------------------------- first-occurrence gate
# per row (last axis): True iff the slot is its index's first occurrence
first_occurrence_rows = sparsify.first_occurrence_mask


# ------------------------------------------------------------- selector stage
def select_topk_rows(acc: torch.Tensor, k: int, selector: str = "exact",
                     sample_frac: float = 0.01) -> torch.Tensor:
    """[..., m] -> int64[..., k] per-row top-|.| indices, in ``lax.top_k``
    order (descending magnitude, NaN the largest, ties to the lower index).

    'sampled' gates each row by its own sample threshold, as the
    reference's per-row ``vmap`` of ``sparsify._sampled_topk`` (every row's
    sample top-k in one ``torch.topk``); 'exact' and 'local' take the whole
    row (the caller pre-blocks for 'local')."""
    a = acc.abs()
    if selector == "sampled":
        return sparsify._sampled_topk(a, k, sample_frac)[1]
    return sparsify._exact_topk(a, k)[1]


# ----------------------------------------------------- THE unified-stream core
def unified_stream_rows(
    acc: torch.Tensor,                   # f32[C, nb, m] accumulators
    k: int,
    mask_idx: torch.Tensor | None,       # int[C, nb, k_mask_total] | None
    mask_vals: torch.Tensor | None,      # f32[C, nb, k_mask_total] | None
    *,
    selector: str = "exact",
    sample_frac: float = 0.01,
    weight: torch.Tensor,                # f32[C] client-side weights
    dp_support: torch.Tensor | None = None,  # int[nb, k] public support
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All clients, one leaf: ``top-k(|acc|) ∪ support(mask)`` (Eq. 5).

    Returns ``(idx, vals, new_acc)``: ``idx`` the per-row column indices
    (int64), ``vals = weight·acc[idx]·first_occurrence + mask`` and
    ``new_acc`` with every transmitted position zeroed.

    ``selector`` and ``sample_frac`` pick the top-k
    (:func:`select_topk_rows`). ``dp_support`` is the DP release shape: the
    ``k`` data slots release that public support instead of the top-k, mask
    slots carry no gradient value, and ``new_acc`` zeroes only the released
    support.
    """
    C, nb, m = acc.shape
    k = int(min(k, m))
    if dp_support is not None:
        idx_t = dp_support.to(torch.int64).expand(C, nb, k)
    else:
        idx_t = select_topk_rows(acc, k, selector, sample_frac)
    zeros = torch.zeros((C, nb, k), dtype=torch.float32, device=acc.device)
    if mask_idx is not None and mask_idx.shape[-1] > 0:
        idx = torch.cat([idx_t, mask_idx.to(torch.int64)], -1)
        mvals = torch.cat([zeros, mask_vals], -1)
    else:
        idx, mvals = idx_t, zeros
    first = first_occurrence_rows(idx)
    if dp_support is not None:
        # a mask slot that is its index's first occurrence must not carry
        # the (un-noised) gradient value out beside the masks
        first[..., k:] = False
    gvals = torch.gather(acc, -1, idx)
    # the reference's ``w * g * first + mask``, which XLA lowers to a select
    # on ``first``: a gated slot carries +0.0, never a signed zero
    vals = torch.where(first, weight[:, None, None] * gvals, 0.0) + mvals
    new_acc = acc.scatter(-1, idx_t if dp_support is not None else idx, 0.0)
    return idx, vals, new_acc


# ------------------------------------------------------------- pairwise masks
def pair_seed_matrix(sa, participant_ids, round_t: int):
    """Host-side ``[C, C]`` counter seeds and Bonawitz signs of the round's
    pairs, derived from the federation seed without the round protocol:
    ``seeds[i, j] = masks.pair_seed(sa, ids[i], ids[j], round_t)``, one key
    derivation per participant and one modexp per unordered pair. The
    diagonal is seed 0 with sign 0. Returns ``(seeds int64 holding uint32
    values, signs f32)`` on the CPU."""
    ids = list(participant_ids)
    privs = [masks.dh_private(sa.seed, u) for u in ids]
    pubs = [masks.dh_public(x) for x in privs]
    return masks.seed_matrix_from_keys(ids, privs, pubs, round_t)


def _fold_seeds(seeds: torch.Tensor, leaf_id: int | None) -> torch.Tensor:
    seeds = kref.as_u32(seeds)
    return kref.fold_leaf_seed(seeds, leaf_id) if leaf_id is not None \
        else seeds


def _client_mask_layout(idx: torch.Tensor, mag: torch.Tensor,
                        signs: torch.Tensor, nb: int,
                        k_mask: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``[C, C, nb, k_mask]`` pair streams -> the per-client layout
    ``[C, nb, C * k_mask]`` (peer-major within a row), signs applied."""
    cr, n = idx.shape[:2]
    vals = signs.to(torch.float32)[:, :, None, None] * mag
    idx = idx.permute(0, 2, 1, 3)
    vals = vals.permute(0, 2, 1, 3)
    return (idx.reshape(cr, nb, n * k_mask),
            vals.reshape(cr, nb, n * k_mask))


def mask_streams_all_pairs(
    pair_seeds: torch.Tensor,   # [C, C] uint32 counter seeds (0 on diagonal)
    pair_signs: torch.Tensor,   # f32[C, C] Bonawitz signs (0 on diagonal)
    nb: int,
    k_mask: int,
    m: int,
    *,
    p: float,
    q: float,
    leaf_id: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every client's concatenated pair-mask streams of one leaf.

    The seed matrix is symmetric and a stream's idx/|val| depend only on the
    seed, so each unordered pair (upper triangle with the diagonal) is
    generated once and mirrored; signs are applied outside the generator, so
    the mirrored copy is the exact negation. Returns ``(idx int32[C, nb,
    C*k_mask], vals f32[C, nb, C*k_mask])``.
    """
    device = pair_seeds.device
    C = pair_seeds.shape[0]
    seeds = _fold_seeds(pair_seeds, leaf_id)
    iu, ju = np.triu_indices(C)
    tri = np.zeros((C, C), np.int64)
    tri[iu, ju] = np.arange(len(iu))
    tri[ju, iu] = tri[iu, ju]
    iu_t = torch.as_tensor(iu, device=device)
    ju_t = torch.as_tensor(ju, device=device)
    tri_t = torch.as_tensor(tri, device=device)
    idx_u, mag_u = ops.pair_mask_streams(
        seeds[iu_t, ju_t],
        torch.ones(len(iu), dtype=torch.float32, device=device),
        nb=nb, k_mask=k_mask, m=m, p=p, q=q)
    return _client_mask_layout(idx_u[tri_t], mag_u[tri_t],
                               pair_signs.to(device), nb, k_mask)


def round_matrices(device, seeds: torch.Tensor, *floats) -> tuple:
    """A round's seed matrix and f32 tensors (the sign matrix, ``alive``)
    on ``device`` in ONE host-to-device copy: ``(seeds as int32 lanes
    holding the uint32 bits, *floats as f32)``, each of its own shape,
    views into one buffer."""
    host = [kref.i32_lanes(kref.as_u32(seeds))] + [
        torch.as_tensor(x).to(torch.float32).view(torch.int32)
        for x in floats]
    buf = torch.cat([h.reshape(-1) for h in host]).to(device)
    out, o = [], 0
    for h in host:
        view = buf[o:o + h.numel()].view(h.shape)
        out.append(view.view(torch.float32) if out else view)
        o += h.numel()
    return tuple(out)


def mask_streams_round(
    pair_seeds: torch.Tensor,   # [C, C] uint32 counter seeds (0 on diagonal)
    pair_signs: torch.Tensor,   # f32[C, C] Bonawitz signs (0 on diagonal)
    leaves,                     # one (nb, k_mask, m, leaf_id) per leaf
    *,
    p: float,
    q: float,
) -> list:
    """Every leaf's pair-mask streams of a round: one ``(m_idx, m_vals)``
    per leaf, bit-equal to ``mask_streams_all_pairs(..., leaf_id=l)``. On
    the card ONE launch of the pair-mask kernel (per 64 leaves) makes all of
    them in the per-client layout; on the CPU the per-leaf function runs
    for each leaf."""
    if pair_seeds.device.type != "cuda":
        return [mask_streams_all_pairs(pair_seeds, pair_signs, nb, k_mask, m,
                                       p=p, q=q, leaf_id=leaf_id)
                for nb, k_mask, m, leaf_id in leaves]
    return ops.pair_mask_segments(pair_seeds, pair_signs, list(leaves), p=p,
                                  q=q, mirror=True)


def mask_streams_rows_round(
    seeds_rows: torch.Tensor,   # [C_loc, C] a shard's rows of the seed matrix
    signs_rows: torch.Tensor,   # f32[C_loc, C] the matching sign rows
    leaves,                     # one (nb, k_mask, m, leaf_id) per leaf
    *,
    p: float,
    q: float,
) -> list:
    """One shard's pair-mask streams of every leaf of a round: one
    ``(m_idx, m_vals)`` per leaf, ``[C_loc, nb, C * k_mask]``, the rows of
    :func:`mask_streams_round`'s output for the shard's clients. On the card
    ONE launch of the pair-mask kernel (per 64 leaves) with ``rows = C_loc``
    and ``peers = C``, no mirror: each seed is read at its own (global)
    pair, so the stream is the one the mirrored square launch draws for
    it."""
    return ops.pair_mask_segments(seeds_rows, signs_rows, list(leaves), p=p,
                                  q=q, mirror=False)


def mask_streams_rows(
    seeds_rows: torch.Tensor,   # [C_loc, C] a shard's rows of the seed matrix
    signs_rows: torch.Tensor,   # f32[C_loc, C] the matching sign rows
    nb: int,
    k_mask: int,
    m: int,
    *,
    p: float,
    q: float,
    leaf_id: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A row slice of :func:`mask_streams_all_pairs` for one leaf: the
    shard's clients' pair-mask streams in the per-client layout
    ``(idx int32[C_loc, nb, C*k_mask], vals f32[C_loc, nb, C*k_mask])``.
    A stream depends only on its seed and the seed matrix is symmetric, so
    the rows are bit-equal to the mirrored full-matrix pass."""
    return mask_streams_rows_round(seeds_rows, signs_rows,
                                   [(nb, k_mask, m, leaf_id)], p=p, q=q)[0]


def recovery_streams_round(
    recovery_seeds: torch.Tensor,   # [C, C] uint32 (survivor<->dropped)
    pair_signs: torch.Tensor,       # f32[C, C]
    alive: torch.Tensor,            # bool or 0/1 [C]
    leaves,                         # one (nb, k_mask, m, leaf_id) per leaf
    *,
    p: float,
    q: float,
) -> list:
    """Every leaf's dropout-recovery streams of a round: one
    :class:`StreamBatch` per leaf, bit-equal to
    ``dropout_cancel_streams_seeded(..., leaf_id=l)``. On the card ONE
    launch (per 64 leaves), the gate and the global indices inside the
    kernel; on the CPU the per-leaf function runs for each leaf."""
    if recovery_seeds.device.type != "cuda":
        return [dropout_cancel_streams_seeded(
            recovery_seeds, pair_signs, alive, nb, k_mask, m, p=p, q=q,
            leaf_id=leaf_id) for nb, k_mask, m, leaf_id in leaves]
    out = ops.pair_mask_segments(recovery_seeds, pair_signs, list(leaves),
                                 p=p, q=q, alive=alive)
    return [StreamBatch(indices=i, values=v) for i, v in out]


# ------------------------------------------ the jax.random-keyed mask path
def pair_key_matrix(sa, participant_ids, round_t: int):
    """Host-side ``[C, C]`` legacy pair keys and signs: ``keys[i, j] =
    masks.pair_key(sa, ids[i], ids[j], round_t)`` (int64 ``[C, C, 2]``),
    ``signs[i, j]`` +1 when ids[i] < ids[j], -1 when >, 0 on the
    diagonal."""
    ids = list(participant_ids)
    n = len(ids)
    keys = torch.stack([torch.stack([masks.pair_key(sa, ids[i], ids[j],
                                                    round_t)
                                     for j in range(n)]) for i in range(n)])
    signs = torch.tensor(
        [[0.0 if i == j else (1.0 if ids[i] < ids[j] else -1.0)
          for j in range(n)] for i in range(n)], dtype=torch.float32)
    return keys, signs


def fold_pair_key_matrix(mask_key: torch.Tensor, n: int):
    """``[n, n]`` pair keys and signs of positional participants 0..n-1:
    ``fold_in(fold_in(mask_key, min(i, j)), max(i, j))``, the same from both
    ends of a pair; signs +1 for i < j, -1 for i > j, 0 on the diagonal."""
    keys = torch.stack([fold_pair_keys_row(mask_key, i, n)[0]
                        for i in range(n)])
    signs = torch.tensor(
        [[0.0 if i == j else (1.0 if i < j else -1.0) for j in range(n)]
         for i in range(n)], dtype=torch.float32)
    return keys, signs


def fold_pair_keys_row(mask_key: torch.Tensor, self_id: int, n: int):
    """Participant ``self_id``'s row of :func:`fold_pair_key_matrix`:
    ``(keys int64[n, 2], signs f32[n])``. The self slot's sign is -0.0,
    the reference's ``where(self < peer, 1, -1) * (self != peer)``."""
    self_id = int(self_id)
    keys = [threefry.fold_in(threefry.fold_in(mask_key, min(self_id, peer)),
                             max(self_id, peer)) for peer in range(n)]
    signs = torch.tensor([-0.0 if peer == self_id else
                          (1.0 if self_id < peer else -1.0)
                          for peer in range(n)], dtype=torch.float32)
    return torch.stack(keys), signs


def pairwise_mask_rows(
    pair_keys_row: torch.Tensor,   # int64[n_peers, 2] this client's keys
    signs_row: torch.Tensor,       # f32[n_peers], 0 for the self slot
    nb: int,
    k_mask: int,
    m: int,
    *,
    p: float,
    q: float,
    leaf_id: int | None = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One client's concatenated mask support and values over all peers,
    on ``device``: per peer (its key folded with ``leaf_id`` when given,
    then split into an index and a value key) ``k_mask`` positions a block
    from ``randint(0, m)`` and magnitudes from ``uniform(p, p + q)``, times
    the sign. Returns ``(idx int32[nb, n_peers*k_mask], vals f32[nb,
    n_peers*k_mask])``, peer-major within a row."""
    n = pair_keys_row.shape[0]
    device = torch.device(device) if device is not None else \
        signs_row.device
    # every peer's three draws (randint's high and low bits, uniform's
    # bits) in one threefry pass; the keys derived on the host, where they
    # live (``core/threefry.py``: key math on Python ints), so neither
    # ``.tolist()`` waits for the card
    hi, lo, val = [], [], []
    # repro-lint: disable-next=RPL006
    for k0, k1 in pair_keys_row.tolist():
        if leaf_id is not None:
            k0, k1 = threefry.threefry2x32(k0, k1, 0, leaf_id & threefry.M32)
        # repro-lint: disable-next=RPL006
        k_i, k_v = threefry.split([k0, k1]).tolist()
        h, l_ = threefry.randint_keys(k_i)
        hi.append(h)
        lo.append(l_)
        val.append(k_v)
    bits = threefry.random_bits(torch.tensor(hi + lo + val), (nb, k_mask),
                                device=device)
    pidx = threefry.randint_from_bits(bits[:n], bits[n:2 * n], 0, m)
    pval = threefry.uniform_from_bits(bits[2 * n:], p, p + q)
    pval = signs_row.to(device, torch.float32)[:, None, None] * pval
    return (pidx.permute(1, 0, 2).reshape(nb, n * k_mask),
            pval.permute(1, 0, 2).reshape(nb, n * k_mask))


def encode_client_blocks(
    acc: torch.Tensor,                        # f32[nb, m] one accumulator
    k: int,
    *,
    selector: str = "exact",
    sample_frac: float = 0.01,
    pair_keys_row: torch.Tensor | None = None,   # int64[n_peers, 2]
    pair_signs_row: torch.Tensor | None = None,  # f32[n_peers], 0 = self
    k_mask: int = 0,
    mask_p: float = -1.0,
    mask_q: float = 2.0,
    leaf_id: int | None = None,
    weight: float = 1.0,
    masks: tuple | None = None,   # (m_idx, m_vals) of pairwise_mask_rows
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One client's encode with keyed masks: the pair masks of
    :func:`pairwise_mask_rows` (or ``masks``, drawn from the same keys
    beforehand), the self slots pointed at the block's top-1 position (so
    the first-occurrence gate zeroes them), then the unified stream.
    Returns ``(global_idx int32[nb, k_total], vals, new_acc)``,
    ``global_idx = row * m + col``."""
    nb, m = acc.shape
    masks_ = None
    if masks is not None and k_mask > 0:
        masks_ = tuple(x[None] for x in masks)
    elif pair_keys_row is not None and k_mask > 0:
        masks_ = tuple(x[None] for x in pairwise_mask_rows(
            pair_keys_row, pair_signs_row, nb, k_mask, m, p=mask_p, q=mask_q,
            leaf_id=leaf_id, device=acc.device))
    st, new_acc = encode_batch_blocks(
        acc[None], k, selector=selector, sample_frac=sample_frac,
        pair_signs=None if masks_ is None else pair_signs_row[None],
        k_mask=k_mask if masks_ is not None else 0, masks=masks_,
        weights=torch.full((1,), weight, dtype=torch.float32,
                           device=acc.device))
    return st.indices[0], st.values[0], new_acc[0]


# ------------------------------------------------------------- batched encode
def encode_batch_blocks(
    acc: torch.Tensor,                       # f32[C, nb, m]
    k: int,
    *,
    selector: str = "exact",
    sample_frac: float = 0.01,
    pair_seeds: torch.Tensor | None = None,  # [C, C] uint32 counter seeds
    pair_signs: torch.Tensor | None = None,  # f32[C, C]
    pair_keys: torch.Tensor | None = None,   # int64[C, C, 2] keyed path
    k_mask: int = 0,
    mask_p: float = -1.0,
    mask_q: float = 2.0,
    leaf_id: int | None = None,
    weights: torch.Tensor | None = None,     # f32[C]
    dp_support: torch.Tensor | None = None,  # int[nb, k] public support
    masks: tuple | None = None,              # (m_idx, m_vals) precomputed
) -> tuple[StreamBatch, torch.Tensor]:
    """Batched client encode: the leaf's pair masks (``masks``, from
    :func:`mask_streams_round`, or generated here from ``pair_seeds``, or
    from the legacy ``jax.random`` ``pair_keys`` one client at a time), then
    the unified stream of every client. Returns (StreamBatch with global
    indices row*m + col, new_acc [C, nb, m]). ``dp_support`` (one support
    for every client) selects the DP release shape."""
    C, nb, m = acc.shape
    dev = acc.device
    if weights is None:
        weights = torch.ones((C,), dtype=torch.float32, device=dev)
    m_idx = m_vals = None
    # a shard's rows pair its clients with the whole cohort: the mask
    # streams exist when the cohort (the peers), not the shard, has two
    peers = C if pair_signs is None else pair_signs.shape[-1]
    if (masks is not None or pair_seeds is not None
            or pair_keys is not None) and k_mask > 0 and peers >= 2:
        signs = pair_signs.to(dev, torch.float32)
        if masks is None and pair_seeds is None:
            rows_ = [pairwise_mask_rows(pair_keys[c], signs[c], nb, k_mask,
                                        m, p=mask_p, q=mask_q,
                                        leaf_id=leaf_id, device=dev)
                     for c in range(C)]
            masks = (torch.stack([r[0] for r in rows_]),
                     torch.stack([r[1] for r in rows_]))
        m_idx, m_vals = masks if masks is not None else \
            mask_streams_all_pairs(pair_seeds.to(dev), signs, nb, k_mask, m,
                                   p=mask_p, q=mask_q, leaf_id=leaf_id)
        if dp_support is None:
            # Inactive (self) slots carry zero mask value; point their
            # support at the block's top-1 position so the first-occurrence
            # gate zeroes the slot entirely — a random index there would
            # transmit the raw gradient unmasked. Under DP mask slots carry
            # no gradient at all, and this override would leak
            # argmax(|acc|) through a transmitted index.
            top1 = torch.argmax(acc.abs(), -1).to(torch.int32)[..., None]
            col_active = torch.repeat_interleave(signs != 0.0, k_mask,
                                                 dim=-1)[:, None, :]
            m_idx = torch.where(col_active, m_idx, top1)
    idx, vals, new_acc = unified_stream_rows(
        acc, k, m_idx, m_vals, selector=selector, sample_frac=sample_frac,
        weight=weights.to(dev), dp_support=dp_support)
    rows = torch.arange(nb, dtype=torch.int64, device=dev)[None, :, None]
    gidx = (rows * m + idx).to(torch.int32)
    return StreamBatch(indices=gidx, values=vals), new_acc


# ----------------------------------------------------- wire-format codec stage
def codec_wire_stage(gidx, vals, new_acc, weights, m: int, codec: str):
    """The client-side codec stage, mask-free rounds only: quantize the
    batched stream values row-wise, absorb the quantization error into the
    error-feedback accumulator (transmitted positions were just zeroed; they
    now carry ``(sent - wire) / weight``), and sort each row by column for
    the delta-packed index wire. Returns ``(cols int32[C, nb, k] sorted,
    q int32[C, nb, k], scales f32[C, nb], new_acc)``: the wire path is int32
    lanes from here to ``dequantize_rows``."""
    C = gidx.shape[0]
    w = (weights.to(vals.device, torch.float32) if weights is not None
         else torch.ones((C,), dtype=torch.float32, device=vals.device))
    q, scales = codecs.quantize_rows(vals, codec)
    cols = gidx.to(torch.int32) % m
    # ``vals - q * scale`` with ONE rounding, as the reference's XLA fuses it
    # into an FMA: in f64 the product is exact (|q| < 2^8, a 24-bit scale)
    # and, for int8/int4, so is the difference (|vals - q*scale| <= scale/2
    # puts the two within a factor of two unless q == 0), so the cast back
    # rounds once; a 1bit difference may round twice, inside that codec's
    # tolerance
    err = (vals.to(torch.float64) - q.to(torch.float64)
           * scales.to(torch.float64)[..., None]).to(torch.float32)
    err = err / torch.where(w == 0.0, 1.0, w)[:, None, None]
    # a codec row is the top-k alone: its columns are distinct, so the
    # scatter_add is one add per position, as the reference's .at[].add
    # repro-lint: disable-next=RPL004
    new_acc = new_acc.scatter_add(-1, cols.to(torch.int64), err)
    order = torch.argsort(cols, dim=-1, stable=True)
    return (torch.gather(cols, -1, order), torch.gather(q, -1, order),
            scales, new_acc)


def codec_wire_roundtrip(cols_s, q_s, scales, m: int, codec: str):
    """Pack -> unpack -> dequantize one batched stream, so every round runs
    the exact uint32 word wire. Lossless: the same sorted columns come back
    and the values sit on the quantization lattice. Returns ``(cols
    int32[C, nb, k], vq f32[C, nb, k])``."""
    iw, vw = codecs.pack_stream_rows(cols_s, q_s, m=m, codec=codec)
    cols2, q2 = codecs.unpack_stream_rows(iw, vw, k=q_s.shape[-1], m=m,
                                          codec=codec)
    return cols2, codecs.dequantize_rows(q2, scales)


def _encode_accumulators(
    updates: torch.Tensor,
    residuals: torch.Tensor,
    *,
    k: int,
    nb: int,
    m: int,
    selector: str,
    sample_frac: float,
    pair_seeds: torch.Tensor | None,
    pair_signs: torch.Tensor | None,
    k_mask: int,
    mask_p: float,
    mask_q: float,
    leaf_id: int,
    weights: torch.Tensor | None,
    codec: str,
    dp_sigma: float,
    dp_seeds: torch.Tensor | None,
    dp_support_seed: int,
    masks: tuple | None,
) -> tuple[StreamBatch, torch.Tensor]:
    """The encode of :func:`encode_leaf_batch` before its codec stage, for
    the rows it is given (the whole cohort, or one shard's clients with
    their rows of the sign matrix): ``acc = residuals + updates`` in f32,
    the unified stream of every row, the DP noise. Returns (the f32
    StreamBatch, new_acc ``[rows, nb, m]``). The callers reject a codec
    under masks."""
    dp_on = dp_sigma > 0.0
    dp_support = None
    C = updates.shape[0]
    if dp_on:
        dp_mod.reject_codec_with_noise(codec, dp_sigma)
        if dp_seeds is None:
            raise ValueError("dp_sigma > 0 requires dp_seeds")
        dp_support = dp_mod.common_support(
            dp_support_seed, nb, min(int(k), m), m, leaf_id,
            device=updates.device)
    acc = (residuals.to(torch.float32) + updates.to(torch.float32))
    acc = torch.stack([to_blocks(acc[c], nb, m) for c in range(C)])
    streams, new_acc = encode_batch_blocks(
        acc, k, selector=selector, sample_frac=sample_frac,
        pair_seeds=pair_seeds, pair_signs=pair_signs,
        k_mask=k_mask, mask_p=mask_p, mask_q=mask_q, leaf_id=leaf_id,
        weights=weights, dp_support=dp_support, masks=masks)
    if dp_on:
        streams = StreamBatch(
            indices=streams.indices,
            values=dp_mod.add_stream_noise(
                streams.values, dp_seeds, sigma=dp_sigma, leaf_id=leaf_id,
                k_data=min(int(k), m)))
    return streams, new_acc


def _global_stream(cols: torch.Tensor, vals: torch.Tensor, nb: int,
                   m: int) -> StreamBatch:
    """Block-local columns ``[C, nb, k]`` -> the global ``row * m + col``
    stream."""
    rows = torch.arange(nb, dtype=torch.int32,
                        device=cols.device)[None, :, None]
    return StreamBatch(indices=(rows * m + cols).to(torch.int32),
                       values=vals)


def _residual_rows(new_acc: torch.Tensor, size: int, leaf_shape: tuple,
                   dtype) -> torch.Tensor:
    """``[C, nb, m]`` block views -> ``[C, *leaf_shape]`` residuals."""
    return torch.stack([from_blocks(new_acc[c], size, leaf_shape)
                        for c in range(new_acc.shape[0])]).to(dtype)


def encode_leaf_batch(
    updates: torch.Tensor,        # [C, *leaf_shape] stacked client updates
    residuals: torch.Tensor,      # [C, *leaf_shape] stacked error feedback
    *,
    k: int,
    nb: int,
    m: int,
    size: int,
    selector: str = "exact",
    sample_frac: float = 0.01,
    pair_seeds: torch.Tensor | None = None,
    pair_signs: torch.Tensor | None = None,
    k_mask: int = 0,
    mask_p: float = -1.0,
    mask_q: float = 2.0,
    leaf_id: int = 0,
    weights: torch.Tensor | None = None,
    codec: str = "f32",
    dp_sigma: float = 0.0,
    dp_seeds: torch.Tensor | None = None,
    dp_support_seed: int = 0,
    masks: tuple | None = None,
) -> tuple[StreamBatch, torch.Tensor]:
    """Leaf-level encode: accumulate -> block view -> batched encode.

    The server's per-leaf entry: ``acc = residuals + updates`` in f32, the
    unified stream of every client (``k`` top-k slots plus ``k_mask`` mask
    slots per pair per block, ``leaf_id`` folded into every pair seed), and
    the new error feedback with the transmitted positions zeroed.
    ``selector`` ('exact', 'sampled' or 'local') and ``sample_frac`` are
    ``THGSConfig``'s: the top-k of each block row. Returns
    ``(StreamBatch int32/f32[C, nb, k + C*k_mask], new_residuals)``.
    ``masks`` (this leaf's entry of :func:`mask_streams_round`) replaces
    the generation from ``pair_seeds``; ``pair_signs`` is still needed.

    ``codec`` (``core/codecs.py``): a non-f32 codec quantizes the values
    (error absorbed into the returned residuals) and runs the packed wire
    round trip; it requires ``k_mask == 0``. ``dp_sigma`` > 0 is the
    per-client DP noise stddev (``DPConfig.sigma_client``): the data slots
    release the public support drawn from ``dp_support_seed`` and every
    released slot gets noise from ``dp_seeds`` (uint32[C], one per client),
    both folded with ``leaf_id``. It requires the f32 codec; 0 skips every
    DP operation.
    """
    # the codec x secagg rejection lives in ONE place (repro.lint RPL003)
    codecs.reject_codec_with_masks(codec, k_mask)
    streams, new_acc = _encode_accumulators(
        updates, residuals, k=k, nb=nb, m=m, selector=selector,
        sample_frac=sample_frac, pair_seeds=pair_seeds,
        pair_signs=pair_signs, k_mask=k_mask, mask_p=mask_p, mask_q=mask_q,
        leaf_id=leaf_id, weights=weights, codec=codec, dp_sigma=dp_sigma,
        dp_seeds=dp_seeds, dp_support_seed=dp_support_seed, masks=masks)
    if codec != "f32":
        cols, q, scales, new_acc = codec_wire_stage(
            streams.indices, streams.values, new_acc, weights, m, codec)
        cols, vq = codec_wire_roundtrip(cols, q, scales, m, codec)
        streams = _global_stream(cols, vq, nb, m)
    return streams, _residual_rows(new_acc, size, tuple(updates.shape[1:]),
                                   residuals.dtype)


# ------------------------------------------------------------- server decode
def _scatter_flat(flat_idx: torch.Tensor, flat_vals: torch.Tensor,
                  padded: int) -> torch.Tensor:
    return ops.stream_scatter_add(flat_idx, flat_vals, size=padded)


def _flatten_round_stream(
    streams: StreamBatch,
    alive: torch.Tensor | None,
    weights: torch.Tensor | None,
    extra: StreamBatch | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The round's single flat (idx, vals) stream: per-client gating
    applied, recovery streams appended after the clients' slots."""
    C = streams.indices.shape[0]
    dev = streams.values.device
    gate = torch.ones((C,), dtype=torch.float32, device=dev)
    if weights is not None:
        gate = gate * weights.to(dev, torch.float32)
    if alive is not None:
        gate = gate * alive.to(dev, torch.float32)
    vals = streams.values * gate[:, None, None]
    flat_idx = streams.indices.reshape(-1)
    flat_vals = vals.reshape(-1)
    if extra is not None:
        flat_idx = torch.cat([flat_idx, extra.indices.reshape(-1)])
        flat_vals = torch.cat(
            [flat_vals, extra.values.reshape(-1).to(torch.float32)])
    return flat_idx, flat_vals


def decode_sum_blocks(
    streams: StreamBatch,
    nb: int,
    m: int,
    *,
    alive: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    extra: StreamBatch | None = None,
) -> torch.Tensor:
    """Scatter-add every client's stream into the dense [nb*m] buffer in one
    kernel launch. Returns f32[nb*m]."""
    flat_idx, flat_vals = _flatten_round_stream(streams, alive, weights,
                                                extra)
    return _scatter_flat(flat_idx, flat_vals, nb * m)


def dropout_cancel_streams_seeded(
    pair_seeds: torch.Tensor,   # [C, C] uint32 seeds (survivor<->dropped used)
    pair_signs: torch.Tensor,   # f32[C, C]
    alive: torch.Tensor,        # bool[C]
    nb: int,
    k_mask: int,
    m: int,
    *,
    p: float,
    q: float,
    leaf_id: int | None = None,
) -> StreamBatch:
    """Bonawitz dropout recovery for one leaf: regenerate every
    survivor->dropped pair mask from the (Shamir-reconstructed) seeds and
    emit its negation; pairs outside ``alive[s] & ~alive[d]`` contribute
    zeros."""
    dev = alive.device
    C = pair_seeds.shape[0]
    alive_f = alive.to(torch.float32)
    seeds = _fold_seeds(pair_seeds.to(dev), leaf_id).reshape(C * C)
    idx, vals = ops.pair_mask_streams(
        seeds, pair_signs.to(dev, torch.float32).reshape(C * C),
        nb=nb, k_mask=k_mask, m=m, p=p, q=q)
    gates = (alive_f[:, None] * (1.0 - alive_f[None, :])).reshape(C * C)
    vals = -gates[:, None, None] * vals
    rows = torch.arange(nb, dtype=torch.int32, device=dev)[None, :, None]
    return StreamBatch(indices=rows * m + idx, values=vals)


def dropout_cancel_streams(
    pair_keys: torch.Tensor,    # int64[C, C, 2] keys used at encode time
    pair_signs: torch.Tensor,   # f32[C, C]
    alive: torch.Tensor,        # bool[C]
    nb: int,
    k_mask: int,
    m: int,
    *,
    p: float,
    q: float,
    leaf_id: int | None = None,
) -> StreamBatch:
    """Bonawitz dropout recovery on the keyed path: every pair's mask
    regenerated from the pair keys and negated, gated by ``alive[s] &
    ~alive[d]`` (``[C * C, nb, k_mask]``, global indices), on ``alive``'s
    device."""
    dev = alive.device
    C = pair_keys.shape[0]
    alive_f = alive.to(torch.float32)
    idx, vals = pairwise_mask_rows(
        pair_keys.reshape(C * C, 2), pair_signs.reshape(C * C), nb, k_mask,
        m, p=p, q=q, leaf_id=leaf_id, device=dev)
    idx = idx.reshape(nb, C * C, k_mask).permute(1, 0, 2)
    vals = vals.reshape(nb, C * C, k_mask).permute(1, 0, 2)
    gates = (alive_f[:, None] * (1.0 - alive_f[None, :])).reshape(C * C)
    rows = torch.arange(nb, dtype=torch.int32, device=dev)[None, :, None]
    return StreamBatch(indices=rows * m + idx,
                       values=-gates[:, None, None] * vals)


def decode_leaf_batch(
    streams: StreamBatch,
    *,
    nb: int,
    m: int,
    size: int,
    alive: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    pair_seeds: torch.Tensor | None = None,
    pair_signs: torch.Tensor | None = None,
    k_mask: int = 0,
    mask_p: float = -1.0,
    mask_q: float = 2.0,
    leaf_id: int = 0,
    recovery: StreamBatch | None = None,
) -> torch.Tensor:
    """Server decode for one leaf: survivor-gated scatter-add, plus the
    cancellation of reconstructed masks when ``alive`` marks dropouts and
    ``pair_seeds`` (the Shamir-recovered ones) are given, or ``recovery``
    (this leaf's entry of :func:`recovery_streams_round`).

    ``weights`` scales whole streams server-side — correct only for uniform
    protocols; weighted FL applies weights client-side at encode. Returns
    f32[size]: the survivors' weighted sparse sum, masks cancelled; the
    caller normalizes by the survivors' total weight.
    """
    extra = recovery
    if extra is None and alive is not None and pair_seeds is not None \
            and k_mask > 0:
        extra = dropout_cancel_streams_seeded(
            pair_seeds, pair_signs, alive, nb, k_mask, m,
            p=mask_p, q=mask_q, leaf_id=leaf_id)
    dense = decode_sum_blocks(streams, nb, m, alive=alive, weights=weights,
                              extra=extra)
    return dense[:size]


# ------------------------------------------- hierarchical (tree) decode
def tree_splits(padded: int, n_groups: int) -> tuple[int, ...]:
    """Near-even contiguous index-range boundaries ``(0, ..., padded)`` for
    ``n_groups`` sub-aggregators (clamped to ``[1, padded]``); group ``g``
    owns ``[splits[g], splits[g+1])``. Any monotone boundary tuple is a
    valid partition for :func:`decode_sum_tree`."""
    G = max(1, min(int(n_groups), int(padded)))
    base, rem = divmod(int(padded), G)
    bounds = [0]
    for g in range(G):
        bounds.append(bounds[-1] + base + (1 if g < rem else 0))
    return tuple(bounds)


def tree_group_count(tree_groups: int, cohort: int) -> int:
    """The tree's sub-aggregator count: ``tree_groups``, or for 0 about the
    square root of the cohort (Python's ``round``, at least 2)."""
    if tree_groups > 0:
        return tree_groups
    return max(2, int(round(cohort ** 0.5)))


def _scatter_range(flat_idx: torch.Tensor, flat_vals: torch.Tensor,
                   lo: int, hi: int) -> torch.Tensor:
    """One sub-aggregator's partial: the slots landing in ``[lo, hi)``,
    folded in the round stream's slot order (one kernel launch).

    Out-of-range slots are redirected to a dump slot at position ``width``
    (buffer ``width + 1``, sliced off on return) with value +0.0, not zeroed
    in place: an in-range position must never receive a redirected +0.0
    (``-0.0 + 0.0 == +0.0`` would flip the sign of a -0.0 partial and break
    bit-equality with the flat decode)."""
    width = hi - lo
    in_range = (flat_idx >= lo) & (flat_idx < hi)
    local = torch.where(in_range, flat_idx - lo, width)
    vals = torch.where(in_range, flat_vals, 0.0)
    return _scatter_flat(local, vals, width + 1)[:width]


def decode_sum_tree(
    streams: StreamBatch,
    nb: int,
    m: int,
    *,
    splits,
    alive: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    extra: StreamBatch | None = None,
) -> torch.Tensor:
    """Hierarchical decode: each group of ``splits`` (``G + 1`` monotone
    boundaries, :func:`tree_splits`) scatter-adds the round stream's slots
    that land in its index range; the partials are concatenated. Each
    position is owned by one group, which folds its contributions in the
    flat decode's slot order, so the result is bit-equal to
    :func:`decode_sum_blocks` for any partition: the combine adds nothing.
    Returns f32[nb*m]."""
    splits = tuple(int(b) for b in splits)
    if len(splits) < 2 or splits[0] != 0 or splits[-1] != nb * m or \
            any(b < a for a, b in zip(splits, splits[1:])):
        raise ValueError(
            f"splits must be monotone boundaries (0, ..., {nb * m}), "
            f"got {splits}")
    flat_idx, flat_vals = _flatten_round_stream(streams, alive, weights,
                                                extra)
    parts = [_scatter_range(flat_idx, flat_vals, lo, hi)
             for lo, hi in zip(splits[:-1], splits[1:]) if hi > lo]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def decode_leaf_tree(
    streams: StreamBatch,
    *,
    nb: int,
    m: int,
    size: int,
    splits,
    alive: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    pair_seeds: torch.Tensor | None = None,
    pair_signs: torch.Tensor | None = None,
    k_mask: int = 0,
    mask_p: float = -1.0,
    mask_q: float = 2.0,
    leaf_id: int = 0,
    recovery: StreamBatch | None = None,
) -> torch.Tensor:
    """Hierarchical twin of :func:`decode_leaf_batch`: the same arguments
    plus ``splits``, and a bit-equal result. Dropout recovery streams join
    the round stream before the range routing, so each sub-aggregator
    cancels the reconstruction masks landing in its own range."""
    extra = recovery
    if extra is None and alive is not None and pair_seeds is not None \
            and k_mask > 0:
        extra = dropout_cancel_streams_seeded(
            pair_seeds, pair_signs, alive, nb, k_mask, m,
            p=mask_p, q=mask_q, leaf_id=leaf_id)
    dense = decode_sum_tree(streams, nb, m, splits=splits, alive=alive,
                            weights=weights, extra=extra)
    return dense[:size]


# ----------------------------------------------------- the stream exchange
def _tree_map(fn, *trees):
    """``fn`` over the tensors of trees of one structure (dicts, tuples,
    named tuples, lists; None stays None)."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def all_gather_round(shards: list, device):
    """Gather one round's wire payload: every shard's tree (one structure,
    leading axis its clients), concatenated leaf by leaf in shard order onto
    ``device`` — the ONE collective of the sparse exchange. Shard 0's
    clients come first, so the result is the serial round's client order."""
    return _tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]),
                     *shards)


def gather_streams(streams: list, device) -> StreamBatch:
    """Gather every shard's stream into the round's stacked
    :class:`StreamBatch` on ``device``."""
    idx, vals = all_gather_round([(s.indices, s.values) for s in streams],
                                 device)
    return StreamBatch(indices=idx, values=vals)


# ----------------------------------------- client-parallel (sharded) round
def can_shard_clients(mesh, n_clients: int) -> bool:
    """True iff ``mesh`` can host a client-parallel round for this cohort:
    a ``clients`` mesh of more than one shard whose size divides the cohort
    (shards are equal). Callers run the serial round otherwise."""
    if mesh is None or getattr(mesh, "axis_name", None) != CLIENT_AXIS:
        return False
    return mesh.size > 1 and n_clients % mesh.size == 0


def shard_client_tree(tree, mesh) -> list:
    """Split a client-stacked tree (leading axis = clients) into the mesh's
    shards: one tree per shard, in shard order, each leaf its shard's
    ``C / size`` rows on the shard's device (a view where the device is the
    leaf's own)."""
    sizes = []
    _tree_map(lambda x: sizes.append(x.shape[0]), tree)
    C = sizes[0]
    if any(n != C for n in sizes) or C % mesh.size:
        raise ValueError(f"cannot split leading axes {sorted(set(sizes))} "
                         f"over {mesh.size} shards")
    c_loc = C // mesh.size
    return [_tree_map(lambda x, s=s, d=d: x[s * c_loc:(s + 1) * c_loc].to(d),
                      tree) for s, d in enumerate(mesh.devices)]


def shard_map_clients(f, mesh, n_clients: int, *shards) -> list:
    """Run the per-shard body ``f(i0, device, *args)`` for every shard, in
    shard order: ``i0 = s * C_loc`` is the shard's first client in the
    cohort, ``args`` its entries of each list in ``shards`` (from
    :func:`shard_client_tree`). Returns the bodies' results in shard order.
    The shards run one after the other from this process; shards on
    distinct devices overlap, as each launches onto its own device's
    stream."""
    c_loc = n_clients // mesh.size
    return [f(s * c_loc, dev, *(sh[s] for sh in shards))
            for s, dev in enumerate(mesh.devices)]


def encode_leaf_shards(
    mesh,
    update_shards: list,       # per shard [C_loc, *leaf_shape]
    residual_shards: list,     # per shard [C_loc, *leaf_shape]
    *,
    k: int,
    nb: int,
    m: int,
    size: int,
    selector: str = "exact",
    sample_frac: float = 0.01,
    pair_signs: torch.Tensor | None = None,
    masks: list | None = None,
    k_mask: int = 0,
    leaf_id: int = 0,
    weights: torch.Tensor | None = None,
    codec: str = "f32",
    dp_sigma: float = 0.0,
    dp_seeds: torch.Tensor | None = None,
    dp_support_seed: int = 0,
) -> tuple[list, list]:
    """The client side of the sharded leaf: each shard encodes its
    ``C_loc`` clients on its device — top-k ∪ its rows of the pair masks
    (``masks[s]``, this leaf's entry of the shard's
    :func:`mask_streams_rows_round`, with its rows of ``pair_signs``), the
    first-occurrence gate, the weights, under DP the shared public support
    and its clients' noise (``dp_seeds[i0:i0 + C_loc]``), and under a
    quantized codec the wire stage and ONE ``bitpack_rows`` launch for both
    wire streams. Returns (the wire payload of each shard: its
    :class:`StreamBatch`, or ``(index words, value words, scales)`` under a
    codec; each shard's new residuals ``[C_loc, *leaf_shape]``)."""
    C = sum(u.shape[0] for u in update_shards)
    if masks is None or k_mask <= 0:
        masks, k_mask = None, 0
    codecs.reject_codec_with_masks(codec, k_mask)

    def body(i0, dev, upd, res):
        c_loc = upd.shape[0]
        rows = slice(i0, i0 + c_loc)
        w = None if weights is None else weights[rows].to(dev)
        signs = None if masks is None else \
            pair_signs[rows].to(dev, torch.float32)
        streams, new_acc = _encode_accumulators(
            upd, res, k=k, nb=nb, m=m, selector=selector,
            sample_frac=sample_frac, pair_seeds=None, pair_signs=signs,
            k_mask=k_mask, mask_p=-1.0, mask_q=2.0, leaf_id=leaf_id,
            weights=w, codec=codec, dp_sigma=dp_sigma,
            dp_seeds=None if dp_seeds is None else dp_seeds[rows].to(dev),
            dp_support_seed=dp_support_seed,
            masks=None if masks is None else masks[i0 // c_loc])
        if codec != "f32":
            # the per-row quantize is shard-local and the same on both
            # paths; the packed words themselves travel
            cols, q, scales, new_acc = codec_wire_stage(
                streams.indices, streams.values, new_acc, w, m, codec)
            iw, vw = codecs.pack_stream_rows(cols, q, m=m, codec=codec)
            payload = (iw, vw, scales)
        else:
            payload = streams
        return payload, _residual_rows(new_acc, size, tuple(upd.shape[1:]),
                                       res.dtype)

    out = shard_map_clients(body, mesh, C, update_shards, residual_shards)
    return [o[0] for o in out], [o[1] for o in out]


def gather_payload(payloads: list, device, *, k: int, nb: int, m: int,
                   codec: str = "f32") -> StreamBatch:
    """The server side of the exchange: gather every shard's wire payload
    onto ``device`` in client order and, under a codec, unpack the gathered
    words (ONE ``bitunpack_rows`` launch for both wire streams) and
    dequantize. Returns the round's stacked stream, bit-equal to the serial
    encode's."""
    if codec == "f32":
        return gather_streams(payloads, device)
    iw, vw, scales = all_gather_round(payloads, device)
    cols, q = codecs.unpack_stream_rows(iw, vw, k=min(int(k), m), m=m,
                                        codec=codec)
    return _global_stream(cols, codecs.dequantize_rows(q, scales), nb, m)


def encode_decode_leaf_sharded(
    mesh,
    updates,                   # [C, *leaf_shape], or one [C_loc, ...] a shard
    residuals,                 # the same, the error feedback
    *,
    k: int,
    nb: int,
    m: int,
    size: int,
    selector: str = "exact",
    sample_frac: float = 0.01,
    pair_seeds: torch.Tensor | None = None,
    pair_signs: torch.Tensor | None = None,
    recovery_seeds: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    k_mask: int = 0,
    mask_p: float = -1.0,
    mask_q: float = 2.0,
    leaf_id: int = 0,
    weights: torch.Tensor | None = None,
    codec: str = "f32",
    topology: str = "flat",
    tree_groups: int = 0,
    dp_sigma: float = 0.0,
    dp_seeds: torch.Tensor | None = None,
    dp_support_seed: int = 0,
    masks: list | None = None,
    recovery: StreamBatch | None = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, StreamBatch]:
    """Client-parallel encode + decode for one leaf: the sharded twin of
    the ``encode_leaf_batch`` -> ``decode_leaf_batch`` pair, and the leaf
    step of ``run_round(mesh=...)``.

    Clients are split over the ``clients`` mesh (``updates`` and
    ``residuals`` stacked, or already one tensor a shard); each shard runs
    the encode for its clients (:func:`encode_leaf_shards`), and the server
    reduction is ONE gather of the sparse streams (the packed words under a
    codec) followed by the decode, run once on ``device`` (default the
    mesh's first). The reference replicates that decode on every device only
    because a shard_map output is replicated; in one process a copy per
    device buys nothing. The same flat stream in the same client order
    reaches the same slot-order scatter, so the result is bit-equal to the
    serial pair.

    The pair masks are ``masks`` (one entry a shard, this leaf's of the
    shard's :func:`mask_streams_rows_round`), or else made here from each
    shard's rows of ``pair_seeds`` by the same row launch. A dropout round
    (``alive``) gates the survivors and cancels the dropped clients' masks
    with ``recovery`` (this leaf's entry of :func:`recovery_streams_round`),
    or else with the streams that function makes from ``recovery_seeds``.
    ``topology='tree'`` decodes over :func:`tree_group_count` groups. An
    absent operand is None: no placeholder is needed.

    Requires ``can_shard_clients(mesh, C)``. Returns ``(dense f32[size],
    new_residuals [C, *leaf_shape], the gathered stream)``, all on
    ``device``; the caller normalizes by the survivors' total weight and
    carries the dropped clients' accumulators, as with the serial pair.
    """
    device = mesh.devices[0] if device is None else device
    if isinstance(updates, torch.Tensor):
        updates = shard_client_tree(updates, mesh)
        residuals = shard_client_tree(residuals, mesh)
    C = sum(u.shape[0] for u in updates)
    assert can_shard_clients(mesh, C), (
        f"mesh {mesh} cannot shard {C} clients; use encode_leaf_batch")
    if topology not in ("flat", "tree"):
        raise ValueError(f"unknown topology {topology!r}")
    with_masks = (masks is not None or pair_seeds is not None) \
        and k_mask > 0 and C >= 2
    codecs.reject_codec_with_masks(codec, k_mask if with_masks else 0)
    leaf = [(nb, k_mask, m, leaf_id)]
    with record_function("round.encode"):
        if with_masks and masks is None:
            masks = shard_map_clients(
                lambda i0, d, u: mask_streams_rows_round(
                    pair_seeds[i0:i0 + u.shape[0]].to(d),
                    pair_signs[i0:i0 + u.shape[0]].to(d, torch.float32),
                    leaf, p=mask_p, q=mask_q)[0], mesh, C, updates)
        payloads, new_res = encode_leaf_shards(
            mesh, updates, residuals, k=k, nb=nb, m=m, size=size,
            selector=selector, sample_frac=sample_frac,
            pair_signs=pair_signs, masks=masks if with_masks else None,
            k_mask=k_mask if with_masks else 0, leaf_id=leaf_id,
            weights=weights, codec=codec, dp_sigma=dp_sigma,
            dp_seeds=dp_seeds, dp_support_seed=dp_support_seed)
    with record_function("round.gather"):
        gathered = gather_payload(payloads, device, k=k, nb=nb, m=m,
                                  codec=codec)
    with record_function("round.decode"):
        if recovery is None and alive is not None and with_masks \
                and recovery_seeds is not None:
            recovery = recovery_streams_round(
                recovery_seeds.to(device),
                pair_signs.to(device, torch.float32), alive.to(device),
                leaf, p=mask_p, q=mask_q)[0]
        alive_d = None if alive is None else alive.to(device)
        if topology == "tree":
            dense = decode_sum_tree(
                gathered, nb, m, alive=alive_d, extra=recovery,
                splits=tree_splits(nb * m, tree_group_count(tree_groups, C)))
        else:
            dense = decode_sum_blocks(gathered, nb, m, alive=alive_d,
                                      extra=recovery)
    with record_function("round.gather"):
        new_res = all_gather_round(new_res, device)
    return dense[:size], new_res, gathered
