"""Distributed differential privacy under secure aggregation (port of
``repro.core.dp``).

Per round, each client

1. clips its error-feedback accumulator ``residual + delta`` — the
   encoder's actual input — to a global L2 bound ``S`` (``DPConfig.clip``),
   so the bound covers the full stream it emits;
2. releases gradient values only on the round's PUBLIC common support
   (``kernels/ref.dp_support_stream_ref``): ``k`` positions per block drawn
   from (dp seed, round, leaf), the same for every client and independent
   of the data, so the transmitted indices leak nothing; pair-mask slots
   carry masks only;
3. adds grid-rounded Gaussian noise to each released slot under its pair
   masks, on the masks' f32-exact 2^-24 grid
   (``kernels/ref.dp_noise_stream_ref``), so masks cancel and noise
   survives exactly in the server's scatter-add.

Per-client noise is ``z * S / sqrt(C)`` for noise multiplier ``z =
DPConfig.sigma`` over a ``C``-client cohort; the accountant composes the
survivor-aware multiplier ``z * sqrt(d / C)`` per round
(``sim/ledger.CommLedger.privacy``). Uniform client weights are required.

Seeds come from sha256 of (dp seed, round, client) and (dp seed, round),
exactly as the reference derives them, so both packages draw the same
support. The noise uses PyTorch's f32 ``log``/``cos``, whose last bit may
differ from XLA's: the noise then moves by a grid step on a few slots
(tests/test_torch_dp.py measures the share). The clip factor's norm sums
in another order than XLA's, so it agrees to a few ulp. ``sigma == 0`` and
``clip == inf`` skip every DP operation: such rounds are bit-identical to
rounds without DP. No kernel computes the noise or the clip: they are plain
PyTorch on the tensors' device, as in the reference (plain XLA there).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Distributed-DP knobs for one federated run.

    ``clip`` is the per-client global-L2 bound S (inf disables clipping);
    ``sigma`` the noise multiplier z of the cohort sum; ``delta`` the
    accountant's target δ. The defaults are the identity.
    """

    clip: float = math.inf
    sigma: float = 0.0
    delta: float = 1e-5
    seed: int = 0xD1FFC0DE

    @property
    def clips(self) -> bool:
        return math.isfinite(self.clip)

    @property
    def noised(self) -> bool:
        return self.sigma > 0.0

    @property
    def active(self) -> bool:
        return self.clips or self.noised

    def validate(self) -> None:
        if not (self.clip > 0.0):
            raise ValueError(f"dp.clip must be positive, got {self.clip}")
        if self.sigma < 0.0:
            raise ValueError(f"dp.sigma must be >= 0, got {self.sigma}")
        if self.noised and not self.clips:
            raise ValueError(
                "dp.sigma > 0 requires a finite dp.clip: the noise scale is "
                "sigma * clip / sqrt(C), and unclipped updates have no "
                "sensitivity bound to calibrate against")
        if not (0.0 < self.delta < 1.0):
            raise ValueError(f"dp.delta must be in (0, 1), got {self.delta}")

    def sigma_client(self, cohort: int) -> float:
        """Per-client noise stddev so the full-cohort sum carries z*S."""
        if not self.noised:
            return 0.0
        return self.sigma * self.clip / math.sqrt(max(1, cohort))

    def client_seeds(self, round_t: int,
                     client_ids: Sequence[int]) -> np.ndarray:
        """uint32[C] noise-stream seeds of one round's participants:
        sha256 of (dp seed, round, client)."""
        out = np.empty(len(client_ids), np.uint32)
        for i, c in enumerate(client_ids):
            h = hashlib.sha256(
                f"dpnoise:{self.seed}:{round_t}:{int(c)}".encode()).digest()
            out[i] = int.from_bytes(h[:4], "little")
        return out

    def support_seed(self, round_t: int) -> np.uint32:
        """uint32 seed of one round's public common release support:
        sha256 of (dp seed, round), shared by the cohort."""
        h = hashlib.sha256(
            f"dpsupport:{self.seed}:{round_t}".encode()).digest()
        return np.uint32(int.from_bytes(h[:4], "little"))


# ------------------------------------------------------------------ clipping
def clip_client_updates(updates: Mapping[str, torch.Tensor], *,
                        clip: float) -> dict[str, torch.Tensor]:
    """Per-client global-L2 clip of stacked client leaves (leading axis C),
    in leaf order. ``factor = min(1, clip / norm)`` in f32; clients inside
    the bound get exactly 1.0, a bitwise no-op."""
    leaves = list(updates.values())
    C = leaves[0].shape[0]
    sq = sum(torch.sum(x.to(torch.float32).square().reshape(C, -1), 1)
             for x in leaves)
    norm = torch.sqrt(sq)
    clip_t = torch.tensor(clip, dtype=torch.float32, device=norm.device)
    factor = torch.clamp_max(clip_t / torch.clamp_min(norm, 1e-30), 1.0)

    def scale(x):
        f = factor.reshape((-1,) + (1,) * (x.dim() - 1))
        return (x.to(torch.float32) * f).to(x.dtype)

    return {n: scale(x) for n, x in updates.items()}


# ------------------------------------------------------------ noise injection
def add_stream_noise(values: torch.Tensor, dp_seeds: torch.Tensor, *,
                     sigma: float, leaf_id: int,
                     k_data: int) -> torch.Tensor:
    """Add grid-rounded Gaussian noise to the ``k_data`` released slots of
    each block of a batched stream ``f32[C, nb, k_total]`` (mask slots stay
    noise-free), from the per-(round, client) seeds folded with the leaf."""
    seeds = kref.fold_leaf_seed(dp_seeds.to(values.device), leaf_id)
    noise = kref.dp_noise_stream_ref(seeds, values.shape[-2], int(k_data),
                                     sigma=float(sigma))
    pad = values.shape[-1] - int(k_data)
    if pad:
        noise = torch.nn.functional.pad(noise, (0, pad))
    return values + noise


def common_support(support_seed, nb: int, k: int, m: int, leaf_id: int, *,
                   device=None) -> torch.Tensor:
    """int32[nb, k] public common release support of one (round, leaf)."""
    seed = torch.tensor(int(support_seed) & kref.M32, dtype=torch.int64,
                        device=device)
    return kref.dp_support_stream_ref(kref.fold_leaf_seed(seed, leaf_id),
                                      nb, k, m)


def reject_codec_with_noise(codec: str, sigma: float) -> None:
    """DP noise composes only on the f32 grid; a quantized wire codec would
    re-grid the noised values. One shared rejection (the RPL003 rule)."""
    if sigma > 0.0 and codec != "f32":
        raise ValueError(
            f"codec {codec!r} cannot carry DP noise: grid-exact noise "
            "composition requires the f32 wire (codec='f32')")


# ------------------------------------------------------- privacy accounting
RDP_ALPHAS: tuple[float, ...] = (
    1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 3.5, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0,
    16.0, 20.0, 24.0, 32.0, 48.0, 64.0, 96.0, 128.0, 256.0, 512.0)


def gaussian_rdp(noise_multiplier: float, alpha: float) -> float:
    """RDP of the Gaussian mechanism at order alpha: alpha / (2 z^2)."""
    if noise_multiplier <= 0.0:
        return math.inf
    return alpha / (2.0 * noise_multiplier ** 2)


def compose_epsilon(noise_multipliers: Sequence[float], delta: float) -> float:
    """(ε at δ) of adaptively composed Gaussian mechanisms: additive RDP
    over rounds, then ``min_α [Σ α/(2 z²) + log(1/δ)/(α−1)]``. A round
    without noise makes it infinite; no rounds give 0."""
    zs = [float(z) for z in noise_multipliers]
    if not zs:
        return 0.0
    if any(z <= 0.0 for z in zs):
        return math.inf
    if not (0.0 < delta < 1.0):
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    inv_2z2 = sum(1.0 / (2.0 * z * z) for z in zs)
    return min(alpha * inv_2z2 + math.log(1.0 / delta) / (alpha - 1.0)
               for alpha in RDP_ALPHAS)


def round_epsilon(noise_multiplier: float, delta: float) -> float:
    """Single-round (ε at δ) of one Gaussian mechanism."""
    return compose_epsilon([noise_multiplier], delta)
