"""Communication-cost accounting (paper §5.2, Eq. 6-8) — port of
``repro.core.costs``.

The paper counts a sparse element as 96 bit (64-bit value + 32-bit index) and
a dense element as 64 bit; the f32 wire is 64 bit sparse and 32 bit dense.
Both accountings are reported. A quantized codec's wire is its packed words
(``core/codecs.wire_bits``), the same under both accountings.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core import codecs
from repro_torch.core.types import CommRecord


@dataclasses.dataclass(frozen=True)
class BitModel:
    """Wire format of one transmitted element."""

    value_bits: int = 64
    index_bits: int = 32

    def sparse_bits(self, k_total: int) -> int:
        return k_total * (self.value_bits + self.index_bits)

    def dense_bits(self, size: int) -> int:
        return size * self.value_bits

    def share_bits(self) -> int:
        """One Shamir share: a 64-bit field element plus its tag."""
        return 64 + self.index_bits


PAPER_BITS = BitModel(value_bits=64, index_bits=32)   # Eq. 6: 96 bit / element
TPU_BITS = BitModel(value_bits=32, index_bits=32)     # f32 + int32


def upload_bits_sparse(ks: Sequence[int], k_masks: Sequence[int], n_pairs: int,
                       bits: BitModel = PAPER_BITS, *, codec: str = "f32",
                       leaf_sizes: Sequence[int] = ()) -> int:
    """Per-client upload bits for one sparse round (Eq. 6): ``sum(ks) +
    n_pairs * sum(k_masks)`` unified-stream slots (the gated self-pair slot
    is never on the wire). A quantized ``codec`` uploads its packed words
    instead, per leaf from ``(k, leaf size)`` — ``leaf_sizes`` aligned with
    ``ks`` is then required."""
    if codec != "f32":
        codecs.reject_codec_with_masks(codec, any(km > 0 for km in k_masks))
        if len(leaf_sizes) != len(ks):
            raise ValueError(
                "quantized-codec accounting needs leaf_sizes aligned with "
                f"ks, got {len(leaf_sizes)} vs {len(ks)}")
        return sum(codecs.wire_bits(k, s, codec)
                   for k, s in zip(ks, leaf_sizes))
    return bits.sparse_bits(sum(ks) + n_pairs * sum(k_masks))


def upload_bits_dense(model_size: int, bits: BitModel = PAPER_BITS) -> int:
    return bits.dense_bits(model_size)


def share_upload_bits(n_clients: int, bits: BitModel = PAPER_BITS) -> int:
    """Phase-1 Shamir traffic: ``C·(C-1)`` shares (self-share stays local)."""
    return n_clients * max(n_clients - 1, 0) * bits.share_bits()


def recovery_upload_bits(threshold: int, n_dropped: int,
                         bits: BitModel = PAPER_BITS) -> int:
    """Phase-3 unmasking: ``threshold`` shares per dropped client."""
    return threshold * n_dropped * bits.share_bits()


def round_record(
    round_t: int,
    model_size: int,
    ks: Sequence[int],
    k_masks: Sequence[int],
    n_clients: int,
    bits: BitModel = PAPER_BITS,
    *,
    n_survivors: Optional[int] = None,
    threshold: int = 0,
    codec: str = "f32",
    leaf_sizes: Sequence[int] = (),
    staleness: Sequence[int] = (),
    dp_clip: float = 0.0,
    dp_sigma: float = 0.0,
    dp_delta: float = 0.0,
) -> CommRecord:
    """Eq. 7-8 accounting for one sparse round: survivors upload their
    streams toward ``n_clients - 1`` peers, every participant downloads the
    dense model; secure-aggregation control traffic (phase-1 shares, phase-3
    recovery shares) is charged separately when any ``k_masks`` > 0.
    ``codec`` switches the upload to packed-word accounting. ``staleness``
    (the per-report taus of an async update; empty on synchronous rounds)
    and the ``dp_*`` facts (clip S, noise multiplier z, target δ; 0.0 =
    off) are stored only: neither changes the bits."""
    if codec != "f32":
        codecs.reject_codec_with_masks(codec, any(km > 0 for km in k_masks))
    surv = n_clients if n_survivors is None else n_survivors
    up = surv * upload_bits_sparse(ks, k_masks, max(n_clients - 1, 0), bits,
                                   codec=codec, leaf_sizes=leaf_sizes)
    dense = n_clients * upload_bits_dense(model_size, bits)
    secagg = any(km > 0 for km in k_masks)
    share_up = share_upload_bits(n_clients, bits) if secagg else 0
    recovery_up = (recovery_upload_bits(threshold, n_clients - surv, bits)
                   if secagg else 0)
    return CommRecord(
        round=round_t,
        upload_bits=up,
        download_bits=dense,
        dense_upload_bits=dense,
        share_upload_bits=share_up,
        share_download_bits=share_up,
        recovery_upload_bits=recovery_up,
        n_clients=n_clients,
        n_survivors=surv,
        threshold=threshold if secagg else 0,
        model_size=model_size,
        ks=tuple(int(k) for k in ks),
        k_masks=tuple(int(k) for k in k_masks),
        codec=codec,
        leaf_sizes=tuple(int(s) for s in leaf_sizes),
        staleness=tuple(int(t) for t in staleness),
        dp_clip=float(dp_clip),
        dp_sigma=float(dp_sigma),
        dp_delta=float(dp_delta),
    )


def dense_round_record(
    round_t: int,
    model_size: int,
    n_clients: int,
    bits: BitModel = PAPER_BITS,
    *,
    n_survivors: Optional[int] = None,
) -> CommRecord:
    """One dense (no-THGS) round: survivors upload the full delta."""
    surv = n_clients if n_survivors is None else n_survivors
    return CommRecord(
        round=round_t,
        upload_bits=surv * upload_bits_dense(model_size, bits),
        download_bits=n_clients * upload_bits_dense(model_size, bits),
        dense_upload_bits=n_clients * upload_bits_dense(model_size, bits),
        n_clients=n_clients,
        n_survivors=surv,
        model_size=model_size,
    )


def total_upload_to_convergence(n_rounds: int, per_round_bits: int) -> int:
    """Eq. 7: ``c = n_rounds * (C*K) * c_up``, with ``per_round_bits``
    already summed over the C*K selected clients."""
    return n_rounds * per_round_bits
