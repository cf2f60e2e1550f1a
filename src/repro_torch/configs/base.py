"""Architecture config schema for the assigned model zoo: a copy of
``repro.configs.base`` (plain dataclasses; the port imports nothing of
``repro``).

Every assigned architecture gets one module in this package defining ``CONFIG``
with the exact dimensions from the assignment sheet (source cited per file), plus
``reduced()`` — the <=2-layer, d_model<=512, <=4-expert variant the smoke tests run
on CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int            # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0         # shared (always-on) experts, same d_ff_expert each
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2           # d_inner = expand * d_model
    head_dim: int = 64        # mamba2 SSD head dim P
    chunk: int = 256          # SSD chunk length
    n_groups: int = 1         # B/C groups


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""          # citation from the assignment sheet
    head_dim: Optional[int] = None           # default d_model // n_heads
    rope: str = "default"                    # default | 2d | none
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    act: str = "swiglu"                      # swiglu | gelu
    tie_embeddings: bool = False
    encoder_only: bool = False               # hubert: no causal mask, no decode
    # sliding-window attention (sub-quadratic variant for long_500k)
    window: Optional[int] = None             # None = full attention
    # VLM: one cross-attention layer after every `cross_attn_every` self-attn layers
    cross_attn_every: Optional[int] = None
    n_image_tokens: int = 1024               # stub frontend output length
    # hybrid (zamba2): mamba backbone + shared attention block cadence
    shared_attn_every: Optional[int] = None  # apply shared transformer block every N ssm layers
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    # xlstm: alternate sLSTM (even) / mLSTM (odd) blocks
    xlstm: bool = False
    dtype: str = "bfloat16"
    # decode KV cache storage: 'bf16' (default) | 'int8' (beyond-paper:
    # halves the decode memory/HBM term; dequantized on the fly)
    kv_dtype: str = "bf16"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    def supports_shape(self, shape_name: str) -> bool:
        """Which of the four assigned input shapes this arch runs (skips in DESIGN.md §5)."""
        if shape_name in ("decode_32k", "long_500k") and self.encoder_only:
            return False   # encoder-only: no decode step
        return True

    def long_context_variant(self) -> "ArchConfig":
        """long_500k needs sub-quadratic attention: SSM/hybrid archs are already
        O(1)-state; attention archs switch to the sliding-window variant."""
        if self.family in ("ssm",) and not self.xlstm:
            return self
        if self.window is not None or self.family == "ssm":
            return self
        return dataclasses.replace(self, window=8192)

    def validate(self) -> None:
        assert self.n_heads % self.n_kv_heads == 0, "GQA requires heads % kv == 0"
        if self.family == "moe":
            assert self.moe is not None
        if self.family in ("ssm", "hybrid") and not self.xlstm:
            assert self.ssm is not None


def reduced(cfg: ArchConfig, **over) -> ArchConfig:
    """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts, small vocab."""
    small: dict = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else cfg.d_ff,
        vocab=min(cfg.vocab, 512),
        head_dim=64 if cfg.head_dim else None,
        n_image_tokens=min(cfg.n_image_tokens, 16),
        dtype="float32",
    )
    small["n_kv_heads"] = max(1, min(small["n_kv_heads"], small["n_heads"]))
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 128),
            n_shared=min(cfg.moe.n_shared, 1),
        )
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, chunk=16, head_dim=32)
    if cfg.cross_attn_every is not None:
        small["cross_attn_every"] = 1
    if cfg.shared_attn_every is not None:
        small["shared_attn_every"] = 1
    if cfg.window is not None:
        small["window"] = min(cfg.window, 32)
    small.update(over)
    return dataclasses.replace(cfg, **small)
