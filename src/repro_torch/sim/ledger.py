"""The communication-cost ledger: per-round bits, both accountings, JSON —
port of ``repro.sim.ledger`` (same ``summary()`` / JSON schema).

The ledger keeps the slot-level facts of each round's ``CommRecord`` and
replays ``core.costs``'s Eq. 6-8 under both accountings (``PAPER_BITS``
96-bit sparse elements, ``TPU_BITS`` the f32 wire), with the
secure-aggregation control traffic reported beside the gradient upload.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

from repro_torch.core import costs
from repro_torch.core.types import CommRecord

ACCOUNTINGS = {"paper": costs.PAPER_BITS, "tpu": costs.TPU_BITS}


def mib(bits: float) -> float:
    """Bits -> MiB (the unit of the paper's Table 2)."""
    return bits / 8 / 2**20


@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    """Slot-level facts of one round, independent of any BitModel. The
    codec, staleness and DP fields keep the reference's schema at their
    inactive defaults."""

    round: int
    n_clients: int
    n_survivors: int
    model_size: int
    ks: tuple
    k_masks: tuple
    threshold: int = 0
    codec: str = "f32"
    leaf_sizes: tuple = ()
    staleness: tuple = ()
    dp_clip: float = 0.0
    dp_sigma: float = 0.0
    dp_delta: float = 0.0

    @property
    def sparse(self) -> bool:
        return bool(self.ks)

    @property
    def secagg(self) -> bool:
        return any(km > 0 for km in self.k_masks)

    def upload_bits(self, bits: costs.BitModel) -> int:
        """Round gradient upload (Eq. 6 x survivors, or dense x survivors)."""
        if self.sparse:
            return self.n_survivors * costs.upload_bits_sparse(
                self.ks, self.k_masks, max(self.n_clients - 1, 0), bits)
        return self.n_survivors * costs.upload_bits_dense(
            self.model_size, bits)

    def download_bits(self, bits: costs.BitModel) -> int:
        return self.n_clients * costs.upload_bits_dense(self.model_size, bits)

    def dense_upload_bits(self, bits: costs.BitModel) -> int:
        return self.n_clients * costs.upload_bits_dense(self.model_size, bits)

    def share_upload_bits(self, bits: costs.BitModel) -> int:
        if not self.secagg:
            return 0
        return costs.share_upload_bits(self.n_clients, bits)

    def share_download_bits(self, bits: costs.BitModel) -> int:
        return self.share_upload_bits(bits)

    def recovery_upload_bits(self, bits: costs.BitModel) -> int:
        if not self.secagg:
            return 0
        return costs.recovery_upload_bits(
            self.threshold, self.n_clients - self.n_survivors, bits)

    @classmethod
    def from_record(cls, rec: CommRecord) -> "LedgerEntry":
        return cls(round=rec.round, n_clients=rec.n_clients,
                   n_survivors=rec.n_survivors or rec.n_clients,
                   model_size=rec.model_size,
                   ks=tuple(rec.ks), k_masks=tuple(rec.k_masks),
                   threshold=int(rec.threshold), codec=str(rec.codec),
                   leaf_sizes=tuple(rec.leaf_sizes),
                   staleness=tuple(int(t) for t in rec.staleness),
                   dp_clip=float(rec.dp_clip), dp_sigma=float(rec.dp_sigma),
                   dp_delta=float(rec.dp_delta))


class CommLedger:
    """Accumulates per-round communication and emits run-level summaries."""

    def __init__(self, entries: Optional[Sequence[LedgerEntry]] = None):
        self.entries: list[LedgerEntry] = list(entries or [])

    def record(self, rec: CommRecord) -> LedgerEntry:
        if rec.model_size <= 0:
            raise ValueError(
                "CommRecord carries no slot-level facts (model_size == 0); "
                "was it built by costs.round_record/dense_round_record?")
        entry = LedgerEntry.from_record(rec)
        self.entries.append(entry)
        return entry

    def __len__(self) -> int:
        return len(self.entries)

    def totals(self, accounting: str = "paper") -> dict:
        """Run totals under one accounting (keys as in the reference)."""
        bits = ACCOUNTINGS[accounting]
        up = sum(e.upload_bits(bits) for e in self.entries)
        down = sum(e.download_bits(bits) for e in self.entries)
        dense = sum(e.dense_upload_bits(bits) for e in self.entries)
        share_up = sum(e.share_upload_bits(bits) for e in self.entries)
        share_down = sum(e.share_download_bits(bits) for e in self.entries)
        recovery_up = sum(e.recovery_upload_bits(bits) for e in self.entries)
        total_up = up + share_up + recovery_up
        return {
            "accounting": accounting,
            "rounds": len(self.entries),
            "upload_bits": up,
            "download_bits": down,
            "dense_upload_bits": dense,
            "share_upload_bits": share_up,
            "share_download_bits": share_down,
            "recovery_upload_bits": recovery_up,
            "total_upload_bits": total_up,
            "upload_mib": mib(up),
            "dense_upload_mib": mib(dense),
            "upload_vs_dense": up / dense if dense else 0.0,
            "total_upload_vs_dense": total_up / dense if dense else 0.0,
            "compression_x": dense / up if up else 0.0,
        }

    def summary(self) -> dict:
        """Both accountings side by side, plus the raw slot facts (no
        ``privacy`` block: DP is not ported yet)."""
        return {
            "paper": self.totals("paper"),
            "tpu": self.totals("tpu"),
            "entries": [dataclasses.asdict(e) for e in self.entries],
        }

    def to_json(self, path: str, *, extra: Optional[dict] = None) -> str:
        """Write the ledger (and optional run metadata) atomically: dump to
        ``path + '.tmp'`` and rename over the target."""
        payload = {"ledger": self.summary()}
        if extra:
            payload.update(extra)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, default=float)
        os.replace(tmp, path)
        return path
