"""The communication-cost ledger: per-round bits, both accountings, JSON —
port of ``repro.sim.ledger`` (same ``summary()`` / JSON schema).

The ledger keeps the slot-level facts of each round's ``CommRecord`` and
replays ``core.costs``'s Eq. 6-8 under both accountings (``PAPER_BITS``
96-bit sparse elements, ``TPU_BITS`` the f32 wire), with the
secure-aggregation control traffic reported beside the gradient upload. A
quantized codec's rounds are charged their packed words; DP runs carry a
``privacy`` block (per-round and composed (ε, δ)); an async run's entries
carry each update's staleness taus.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Iterable, Optional, Sequence

from repro_torch.core import costs
from repro_torch.core import dp as dp_mod
from repro_torch.core.types import CommRecord

ACCOUNTINGS = {"paper": costs.PAPER_BITS, "tpu": costs.TPU_BITS}


def mib(bits: float) -> float:
    """Bits -> MiB (the unit of the paper's Table 2)."""
    return bits / 8 / 2**20


@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    """Slot-level facts of one round, independent of any BitModel.
    ``staleness`` holds the per-report taus of an async update (empty on
    synchronous rounds); it is a fact only and changes no bits."""

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

    @property
    def dp(self) -> bool:
        """Did the round run the DP plane (clip and/or noise)?"""
        return self.dp_clip > 0.0 or self.dp_sigma > 0.0

    def dp_z_eff(self) -> float:
        """Survivor-aware noise multiplier of the round's sum: each of the
        C participants adds ``z * S / sqrt(C)`` and only the d survivors'
        noise reaches the aggregate, so ``z * sqrt(d / C)``; 0.0 without
        noise."""
        if self.dp_sigma <= 0.0 or self.n_clients <= 0:
            return 0.0
        return self.dp_sigma * math.sqrt(self.n_survivors / self.n_clients)

    def upload_bits(self, bits: costs.BitModel) -> int:
        """Round gradient upload (Eq. 6 x survivors, or dense x survivors)."""
        if self.sparse:
            return self.n_survivors * costs.upload_bits_sparse(
                self.ks, self.k_masks, max(self.n_clients - 1, 0), bits,
                codec=self.codec, leaf_sizes=self.leaf_sizes)
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

    def total_upload_bits(self, bits: costs.BitModel) -> int:
        """Gradient upload plus the secure-aggregation control traffic."""
        return (self.upload_bits(bits) + self.share_upload_bits(bits)
                + self.recovery_upload_bits(bits))

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

    def extend(self, recs: Iterable[CommRecord]) -> None:
        for rec in recs:
            self.record(rec)

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

    def upload_bits_through(self, n_rounds: int,
                            accounting: str = "paper") -> int:
        """Cumulative upload bits over the first ``n_rounds`` rounds (the
        rounds-to-target-accuracy costing of Table 2)."""
        bits = ACCOUNTINGS[accounting]
        return sum(e.upload_bits(bits) for e in self.entries[:n_rounds])

    def per_round(self, accounting: str = "paper") -> list[dict]:
        """One row of bits a round under one accounting."""
        bits = ACCOUNTINGS[accounting]
        return [
            {
                "round": e.round,
                "n_clients": e.n_clients,
                "n_survivors": e.n_survivors,
                "sparse": e.sparse,
                "secagg": e.secagg,
                "upload_bits": e.upload_bits(bits),
                "download_bits": e.download_bits(bits),
                "dense_upload_bits": e.dense_upload_bits(bits),
                "share_upload_bits": e.share_upload_bits(bits),
                "share_download_bits": e.share_download_bits(bits),
                "recovery_upload_bits": e.recovery_upload_bits(bits),
                "total_upload_bits": e.total_upload_bits(bits),
            }
            for e in self.entries
        ]

    def privacy(self, delta: Optional[float] = None) -> Optional[dict]:
        """The run's privacy accounting, or None without DP: per-round
        Gaussian-mechanism (ε, δ) at ``dp_z_eff`` and their RDP composition
        over the run. A clipped round without noise makes ε infinite.
        ``delta`` overrides the recorded target δ."""
        if not any(e.dp for e in self.entries):
            return None
        if delta is None:
            delta = next((e.dp_delta for e in self.entries
                          if e.dp_delta > 0.0), 1e-5)
        z_effs = [e.dp_z_eff() for e in self.entries]
        per_round = [
            {
                "round": e.round,
                "z": e.dp_sigma,
                "z_eff": z,
                "clip": e.dp_clip,
                "epsilon": dp_mod.round_epsilon(z, delta),
            }
            for e, z in zip(self.entries, z_effs)
        ]
        return {
            "delta": float(delta),
            "epsilon": dp_mod.compose_epsilon(z_effs, delta),
            "rounds": len(self.entries),
            "clip": max((e.dp_clip for e in self.entries), default=0.0),
            "noise_multiplier": max(
                (e.dp_sigma for e in self.entries), default=0.0),
            "per_round": per_round,
        }

    def summary(self) -> dict:
        """Both accountings side by side, plus the raw slot facts; DP runs
        add the ``privacy`` block."""
        out = {
            "paper": self.totals("paper"),
            "tpu": self.totals("tpu"),
            "entries": [dataclasses.asdict(e) for e in self.entries],
        }
        priv = self.privacy()
        if priv is not None:
            out["privacy"] = priv
        return out

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

    @classmethod
    def from_entry_dicts(cls, dicts: Sequence[dict]) -> "CommLedger":
        """Rebuild from ``summary()['entries']`` (the resume path); reads
        the reference's entries too."""
        return cls([LedgerEntry(round=int(d["round"]),
                                n_clients=int(d["n_clients"]),
                                n_survivors=int(d["n_survivors"]),
                                model_size=int(d["model_size"]),
                                ks=tuple(int(k) for k in d["ks"]),
                                k_masks=tuple(int(k) for k in d["k_masks"]),
                                threshold=int(d.get("threshold", 0)),
                                codec=str(d.get("codec", "f32")),
                                leaf_sizes=tuple(
                                    int(s) for s in d.get("leaf_sizes", ())),
                                staleness=tuple(
                                    int(t) for t in d.get("staleness", ())),
                                dp_clip=float(d.get("dp_clip", 0.0)),
                                dp_sigma=float(d.get("dp_sigma", 0.0)),
                                dp_delta=float(d.get("dp_delta", 0.0)))
                    for d in dicts])
