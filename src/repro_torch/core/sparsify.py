"""THGS sparsification primitives (paper Alg. 1) — port of
``repro.core.sparsify``.

Per leaf (== per layer, "hierarchical"): accumulate the incoming gradient
into the error-feedback residual, select the top-k of the accumulated
magnitude, emit the selected (indices, values) and keep the remainder as the
new residual.

Selection strategies:
  * 'exact'   — the top-k of the whole leaf, in ``lax.top_k``'s order:
                descending magnitude, NaN the largest, ties to the lower
                index.
  * 'sampled' — a threshold from a strided subsample's top-k; magnitudes
                below it are gated to 0 and the top-k of the gated
                magnitudes is kept, in the same order. The sample's size
                and stride, and the sample's rank of the threshold, are the
                reference's integer arithmetic, so the kept set is the
                reference's bit for bit.
  * 'local'   — the caller splits the leaf across shards or blocks and runs
                'exact' on each with its share of k.

Every function here works on the last axis, so a batch of rows (the stream
engine's ``[C, nb, m]`` accumulators) takes one call: every row's sample
top-k is one ``torch.topk`` over ``[rows, S]``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import SparseStream, THGSConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref


class LeafSparsification(NamedTuple):
    stream: SparseStream     # top-k indices/values of the accumulated grad
    residual: torch.Tensor   # same shape as the leaf; acc with top-k zeroed
    threshold: torch.Tensor  # scalar delta actually used


def _top_k(a: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` of magnitudes ``a`` (no negative values) over the last
    axis: ``(values in a's dtype, int64 indices)``, descending, NaN the
    largest, ties to the lower index — a stable descending sort's first
    ``k``.

    ``torch.topk``'s tie order differs, so it only finds each row's k-th
    largest magnitude ``t``: the kept set is every element above ``t`` and
    the lowest-index elements equal to ``t`` up to ``k``, then sorted
    stably by magnitude. The same indices as the full sort at a fraction of
    its cost on long rows (a 262M-element leaf); a row set with NaN takes
    the full sort. Half-precision magnitudes are compared in f32, which
    holds them exactly."""
    x = a if a.dtype in (torch.float32, torch.float64) else a.float()
    m = x.shape[-1]
    if k >= m or bool(torch.isnan(x).any()):
        idx = torch.sort(x, dim=-1, descending=True,
                         stable=True).indices[..., :k]
        return torch.gather(a, -1, idx), idx
    t = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > t
    tied = x == t
    need = k - above.sum(-1, keepdim=True)
    keep = above | (tied & (torch.cumsum(tied, -1, dtype=torch.int32)
                            <= need))
    idx = keep.nonzero()[:, -1].reshape(*x.shape[:-1], k)
    order = torch.sort(torch.gather(x, -1, idx), dim=-1, descending=True,
                       stable=True).indices
    idx = torch.gather(idx, -1, order)
    return torch.gather(a, -1, idx), idx


def _exact_topk(flat_abs: torch.Tensor, k: int):
    return _top_k(flat_abs, k)


def _kth_largest(x: torch.Tensor, ks: int) -> torch.Tensor:
    """Each row's ``ks``-th largest value ``[..., 1]``, NaN the largest (as
    ``lax.top_k`` ranks it): one ``torch.topk`` over every row, NaN counted
    apart so the answer does not rest on how ``topk`` orders NaN."""
    nan = torch.isnan(x)
    t = torch.topk(torch.where(nan, torch.inf, x), ks, dim=-1).values
    n_nan = nan.sum(-1, keepdim=True)
    return torch.where(n_nan >= ks, torch.nan, t[..., -1:])


def _sampled_topk(flat_abs: torch.Tensor, k: int, sample_frac: float):
    """Estimate the k-th magnitude from a strided subsample, then compact.

    The sample is every ``stride``-th element of a row, ``stride = n // m``
    for ``m = max(int(n * f), min(n, 1024))``; the threshold is the sample's
    ``ks``-th largest for ``ks = int(k * S / n)`` (within ``[1, S]``).
    Magnitudes below it are gated to 0 (a NaN threshold gates every element,
    and so does a NaN magnitude), and exactly k entries come back from the
    top-k of the gated magnitudes: the exact top-k whenever the estimate is
    at or below the true k-th value; otherwise the gated zeros fill the
    remaining slots from the lowest index up.
    """
    n = flat_abs.shape[-1]
    m = max(int(n * sample_frac), min(n, 1024))
    stride = max(n // m, 1)
    x = flat_abs if flat_abs.dtype in (torch.float32, torch.float64) \
        else flat_abs.float()
    sample = x[..., ::stride]
    S = sample.shape[-1]
    ks = max(1, min(S, int(k * S / n)))
    thresh = _kth_largest(sample, ks)
    gated = torch.where(flat_abs >= thresh.to(flat_abs.dtype), flat_abs,
                        torch.zeros((), dtype=flat_abs.dtype,
                                    device=flat_abs.device))
    return _top_k(gated, k)


def sparsify_leaf(grad: torch.Tensor, residual: torch.Tensor, k: int,
                  cfg: THGSConfig) -> LeafSparsification:
    """One THGS layer step: error-feedback accumulate -> top-k -> residual.

    ``acc = (residual + grad)`` in ``grad``'s dtype; ``values`` and the new
    residual keep it. ``threshold`` is the k-th selected magnitude (under
    'sampled' it may be a gated 0)."""
    acc = (residual + grad).to(grad.dtype)
    flat = acc.reshape(-1)
    k = int(min(k, flat.shape[0]))
    abs_flat = flat.abs()
    if cfg.selector == "sampled":
        top_vals_abs, idx = _sampled_topk(abs_flat, k, cfg.sample_frac)
    else:  # 'exact' and 'local' (the caller pre-shards for 'local')
        top_vals_abs, idx = _exact_topk(abs_flat, k)
    return LeafSparsification(
        stream=SparseStream(indices=idx.to(torch.int32), values=flat[idx]),
        residual=flat.index_fill(0, idx, 0.0).reshape(acc.shape),
        threshold=top_vals_abs[-1],
    )


def densify(stream: SparseStream, size: int,
            dtype=torch.float32) -> torch.Tensor:
    """Scatter a stream back to a dense flat vector (server-side decode).

    Every position folds its entries in slot order from +0.0, as the
    reference's scatter does on the CPU; a negative index counts from the
    end and one still outside ``[0, size)`` is dropped, as JAX's scatter
    normalizes and drops. An f32 decode goes through
    ``ops.stream_scatter_add`` (the scatter kernel on the card), any other
    dtype through the plain fold in that dtype."""
    idx = stream.indices.reshape(-1).to(torch.int64)
    idx = torch.where(idx < 0, idx + size, idx)
    valid = (idx >= 0) & (idx < size)
    vals = stream.values.reshape(-1).to(dtype)
    if dtype == torch.float32:
        return ops.stream_scatter_add(
            torch.where(valid, idx, -1).to(torch.int32), vals, size=size)
    return kref.scatter_fold_by_rank(idx[valid], vals[valid], size,
                                     dtype=dtype)


def first_occurrence_mask(indices: torch.Tensor) -> torch.Tensor:
    """Per slot of the last axis: True iff the slot is the first occurrence
    of its index.

    A stable sort puts duplicates of an index on consecutive ranks in slot
    order, so a slot is first iff its sorted predecessor differs; the
    verdicts are scattered back to slot order."""
    order = torch.argsort(indices, dim=-1, stable=True)
    sorted_idx = torch.gather(indices, -1, order)
    is_first = torch.cat(
        [torch.ones_like(sorted_idx[..., :1], dtype=torch.bool),
         sorted_idx[..., 1:] != sorted_idx[..., :-1]], -1)
    return torch.zeros_like(is_first).scatter(-1, order, is_first)


def member_of(query: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Boolean per query slot: does the index appear anywhere in ``table``?

    Sorted-table binary search (O(q log t)) on flat int indices, the
    position clipped to the table as the reference clips it."""
    st = torch.sort(table.reshape(-1)).values
    pos = torch.searchsorted(st, query.to(st.dtype))
    pos = pos.clamp(0, st.shape[0] - 1)
    return st[pos] == query.to(st.dtype)
