"""Stream wire-format codecs: quantized values + delta-packed sparse indices
(port of ``repro.core.codecs``).

The codec stage sits after the unified-stream encode: per block row it
quantizes the ``k`` stream values to a low-bit integer grid (``int8``/
``int4`` symmetric amax scaling, ``1bit`` sign with the row's mean magnitude
as scale), the caller absorbs the quantization error into the error-feedback
residuals, and both streams are packed dense: values as two's-complement
fields of ``value_bits`` bits, indices sorted and delta-encoded at
``index_width(m)`` bits, into uint32 words through
``kernels/ops.bitpack_segments`` (one launch of the CUDA kernel on the card
packs both streams of a leaf, int32 lanes in and out). ``f32`` is the
passthrough codec and the only one that composes with sparse-mask secure
aggregation: pair masks cancel bit-exactly only on the f32 2^-24 grid.

Bit-exactness against the reference, whose encode runs under ``jax.jit``:
XLA rewrites a division by a constant into a multiply by its f32
reciprocal, so the int8/int4 scale is ``amax * f32(1/qmax)`` and the 1bit
scale ``sum(|v|) * f32(1/k)``, written out here as such multiplies by a
tensor on the values' device (PyTorch's CUDA division by a Python number
takes the reciprocal too, its CPU division does not: the explicit multiply
gives one answer on both). ``torch.round`` rounds half to even, as
``jnp.round``. The 1bit sum runs in another order than XLA's, so that
scale agrees to a few ulp only (tests/test_torch_codecs.py states the
tolerance).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import packed_words

CODECS = ("f32", "int8", "int4", "1bit")
VALUE_BITS = {"int8": 8, "int4": 4, "1bit": 1}
_QMAX = {"int8": 127, "int4": 7}
SCALE_BITS = 32   # one f32 scale per block row rides alongside the words


def value_bits(codec: str) -> int:
    """Bits per packed value field (quantized codecs only)."""
    return VALUE_BITS[codec]


def index_width(m: int) -> int:
    """Bits per delta-encoded index field for block length ``m``: sorted
    rows keep every delta (and the leading index) in ``[0, m)``."""
    return max(1, math.ceil(math.log2(max(m, 2))))


def wire_bits(k: int, size: int, codec: str) -> int:
    """Exact packed wire size of one client's stream for one ``nb == 1``
    leaf: word-padded indices + word-padded values + the row scale."""
    if codec not in CODECS or codec == "f32":
        raise ValueError(f"wire_bits needs a quantized codec, got {codec!r}")
    return (32 * packed_words(k, index_width(size))
            + 32 * packed_words(k, value_bits(codec))
            + SCALE_BITS)


def reject_codec_with_masks(codec: str, k_mask: int | bool) -> None:
    """THE codec x secure-aggregation guard (``repro.lint`` RPL003 binds the
    port too): every public entry point taking a ``codec`` and a
    secure-aggregation parameter routes the pair through here. ``k_mask`` is
    truthy when masks are in play; quantized codecs leave the f32 2^-24 grid
    the pair masks cancel on, so the pair is rejected."""
    if codec != "f32" and k_mask:
        raise ValueError(
            f"codec {codec!r} cannot run under sparse-mask secure "
            "aggregation: pair masks cancel bit-exactly only on the f32 "
            "2^-24 grid (DESIGN.md §12); use codec='f32' until integer-grid "
            "masked quantization lands")


# ------------------------------------------------------------- value codecs
def _recip(n: int, like: torch.Tensor) -> torch.Tensor:
    """f32(1/n) as a tensor on ``like``'s device."""
    return torch.tensor(1.0 / n, dtype=torch.float32, device=like.device)


def quantize_rows(vals: torch.Tensor, codec: str):
    """Quantize f32[..., k] row-wise -> ``(q int32[..., k] in [-qmax, qmax],
    scales f32[...])``; ``dequantize_rows(q, scales)`` is the wire value."""
    if codec == "1bit":
        scales = vals.abs().sum(-1) * _recip(vals.shape[-1], vals)
        q = torch.where(vals >= 0, 1, -1).to(torch.int32)
        return q, scales
    qmax = _QMAX[codec]
    scales = vals.abs().amax(-1) * _recip(qmax, vals)
    safe = torch.where(scales > 0, scales, 1.0)
    q = torch.clamp(torch.round(vals / safe[..., None]), -qmax, qmax)
    return q.to(torch.int32), scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int32[..., k] lattice points x f32[...] row scales -> f32[..., k]. One
    multiply: type promotion converts q to f32 inside it (exactly, |q| <
    2^24), the same bits as ``q.to(f32) * scale``."""
    return q * scales[..., None]


# ----------------------------------------------------------- wire pack/unpack
def pack_stream_rows(cols: torch.Tensor, q: torch.Tensor, *, m: int,
                     codec: str):
    """Pack sorted per-row stream slots onto the wire.

    ``cols`` int[..., k] block-local indices, ascending per row; ``q``
    int[..., k] quantized values. Returns ``(iwords, vwords)``, uint32
    words as int32 lanes (the same bits; ``.numpy().astype(np.uint32)``
    reads them as words): indices delta-encoded then packed at
    ``index_width(m)`` bits, values two's-complement at
    ``value_bits(codec)`` bits (1bit: the field is ``q > 0``). Both streams
    go through ONE ``ops.bitpack_segments`` call (one launch on the card),
    whose kernel takes the low bits of every field: a sorted row's deltas
    lie in ``[0, m)`` and a negative ``q`` is its own two's complement, so
    nothing is masked here.
    """
    lead, k = cols.shape[:-1], cols.shape[-1]
    c2 = cols.reshape(-1, k).to(torch.int32)
    deltas = torch.cat([c2[:, :1], c2[:, 1:] - c2[:, :-1]], 1)
    q2 = q.reshape(-1, k).to(torch.int32)
    u = torch.clamp(q2, 0, 1) if codec == "1bit" else q2
    iwords, vwords = ops.bitpack_segments(
        [deltas, u], widths=[index_width(m), value_bits(codec)])
    return (iwords.reshape(*lead, iwords.shape[-1]),
            vwords.reshape(*lead, vwords.shape[-1]))


def unpack_stream_rows(iwords: torch.Tensor, vwords: torch.Tensor, *,
                       k: int, m: int, codec: str):
    """Inverse of :func:`pack_stream_rows`: words (int32 or int64 lanes) ->
    ``(cols int32[..., k] sorted, q int32[..., k])``, both streams through
    ONE ``ops.bitunpack_segments`` call."""
    lead = iwords.shape[:-1]
    vb = value_bits(codec)
    d, u = ops.bitunpack_segments(
        [iwords.reshape(-1, iwords.shape[-1]),
         vwords.reshape(-1, vwords.shape[-1])],
        ks=[k, k], widths=[index_width(m), vb])
    cols = torch.cumsum(d, -1, dtype=torch.int32)
    if codec == "1bit":
        q = 2 * u - 1
    else:
        half = 1 << (vb - 1)              # sign-extend the vb-bit field
        q = (u ^ half) - half
    return cols.reshape(*lead, k), q.reshape(*lead, k)
