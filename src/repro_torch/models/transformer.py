"""The decoder-only LM: parameters, prefill and one-token decode (port of
``repro.models.transformer``, dense family).

The parameters mirror the reference's tree: ``embed`` [V, d], ``lm_head``
[d, V] (absent when embeddings are tied), ``final_norm`` and one block per
layer, each ``{attn_norm, attn: {wq, wk, wv, wo}, mlp_norm, mlp}``. The
reference stacks the blocks on a leading layer axis and scans over them; the
port holds an ``nn.ModuleList`` and loops. Every prefill layer's attention
runs through the flash kernel (``models/attention.py``).

Serving runs under ``torch.inference_mode()``. Families other than
``dense`` (MoE, VLM cross-attention, hybrid SSM, xLSTM, the audio encoder)
are refused with ``NotImplementedError`` until their slice is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_init,
                                       init_mlp, init_norm)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LATER = "the LM slice G2 of the port (ROADMAP Queue 1)"


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not build yet."""
    if cfg.family != "dense" or cfg.xlstm:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            f"{' (xLSTM)' if cfg.xlstm else ''} is not ported yet; the port "
            f"serves the dense family, the rest waits for {LATER}")
    if cfg.cross_attn_every is not None:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention layers wait for {LATER}")
    if cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.name}: encoder-only models wait for {LATER}")
    if cfg.dtype not in DTYPES:
        raise ValueError(f"{cfg.name}: dtype {cfg.dtype!r} not in "
                         f"{sorted(DTYPES)}")
    if cfg.kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"{cfg.name}: kv_dtype {cfg.kv_dtype!r} not in "
                         "('bf16', 'int8')")


class TransformerLM(nn.Module):
    """A dense decoder-only LM's parameters in the reference's layout."""

    def __init__(self, cfg: ArchConfig,
                 generator: Optional[torch.Generator] = None, *,
                 device="cuda"):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = DTYPES[cfg.dtype]
        g = generator
        self.embed = embed_init(g, cfg.vocab, cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            # the reference draws [V, d] and transposes it
            self.lm_head = nn.Parameter(
                embed_init(g, cfg.vocab, cfg.d_model, dtype, device).T
                .contiguous(), requires_grad=False)
        self.final_norm = init_norm(cfg.d_model, cfg.norm, dtype, device)
        self.blocks = nn.ModuleList(
            self._init_block(g, cfg, dtype, device)
            for _ in range(cfg.n_layers))

    @staticmethod
    def _init_block(g, cfg: ArchConfig, dtype, device) -> nn.ModuleDict:
        return nn.ModuleDict({
            "attn_norm": init_norm(cfg.d_model, cfg.norm, dtype, device),
            "attn": attn.init_attention(g, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd, dtype,
                                        device),
            "mlp_norm": init_norm(cfg.d_model, cfg.norm, dtype, device),
            "mlp": init_mlp(g, cfg.d_model, cfg.d_ff, cfg.act, dtype, device),
        })


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> TransformerLM:
    """The model with weights drawn from ``generator`` at the reference's
    scales, on ``device`` (default: the generator's, else CUDA). On the
    meta device nothing is drawn: shapes only."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    return TransformerLM(cfg, generator, device=device)


def lm_head_weight(params: TransformerLM, cfg: ArchConfig) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def embed_tokens(params: TransformerLM, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens.long()]


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


# ------------------------------------------------------------- block forward
def _self_block(p: nn.ModuleDict, cfg: ArchConfig, x: torch.Tensor, *,
                causal: bool, window: Optional[int]):
    """Pre-norm attention + MLP. Returns (x, aux_loss); aux is 0 for the
    dense family."""
    h = apply_norm(p["attn_norm"], x, cfg.norm)
    x = x + attn.self_attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
        rope=cfg.rope, causal=causal, window=window)
    h = apply_norm(p["mlp_norm"], x, cfg.norm)
    x = x + apply_mlp(p["mlp"], h, cfg.act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.inference_mode()
def forward(params: TransformerLM, cfg: ArchConfig, h: torch.Tensor, *,
            window: Optional[int] = None):
    """Full-stack forward of an embedded input h [B,T,d]. Returns
    (final-normed hidden, total aux loss)."""
    window = window if window is not None else cfg.window
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for bp in params.blocks:
        h, a = _self_block(bp, cfg, h, causal=True, window=window)
        aux = aux + a
    return apply_norm(params.final_norm, h, cfg.norm), aux


# ------------------------------------------------------------------- serving
@dataclasses.dataclass
class DecodeState:
    caches: list            # one KVCache per layer


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      device="cuda") -> DecodeState:
    """Empty caches (length 0) for ``batch`` rows of ``cache_len`` slots,
    int8 when ``cfg.kv_dtype == 'int8'``."""
    check_supported(cfg)
    kv_dt = torch.int8 if cfg.kv_dtype == "int8" else DTYPES[cfg.dtype]
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return DecodeState(caches=[
        KVCache(k=torch.zeros(shape, dtype=kv_dt, device=device),
                v=torch.zeros(shape, dtype=kv_dt, device=device),
                length=torch.zeros((batch,), dtype=torch.int32,
                                   device=device))
        for _ in range(cfg.n_layers)])


@torch.inference_mode()
def prefill(params: TransformerLM, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: int):
    """Prompt int[B, T] -> (last-position logits [B, 1, V], DecodeState
    with every layer's cache filled to T)."""
    h = embed_tokens(params, cfg, tokens)
    caches = []
    for bp in params.blocks:
        hn = apply_norm(bp["attn_norm"], h, cfg.norm)
        a, cache = attn.prefill_cache(
            bp["attn"], hn, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            hd=cfg.hd, rope=cfg.rope, window=cfg.window, cache_len=cache_len)
        h = h + a
        hn = apply_norm(bp["mlp_norm"], h, cfg.norm)
        h = h + apply_mlp(bp["mlp"], hn, cfg.act)
        caches.append(cache)
    h = apply_norm(params.final_norm, h[:, -1:], cfg.norm)
    return h @ lm_head_weight(params, cfg), DecodeState(caches=caches)


@torch.inference_mode()
def decode_step(params: TransformerLM, cfg: ArchConfig, token: torch.Tensor,
                state: DecodeState):
    """One token int[B, 1] -> (logits [B, 1, V], state); every layer's cache
    is written and advanced in place."""
    h = embed_tokens(params, cfg, token)
    for bp, cache in zip(params.blocks, state.caches):
        hn = apply_norm(bp["attn_norm"], h, cfg.norm)
        a, _ = attn.decode_self_attention(
            bp["attn"], hn, cache, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            hd=cfg.hd, rope=cfg.rope, window=cfg.window)
        h = h + a
        hn = apply_norm(bp["mlp_norm"], h, cfg.norm)
        h = h + apply_mlp(bp["mlp"], hn, cfg.act)
    h = apply_norm(params.final_norm, h, cfg.norm)
    return h @ lm_head_weight(params, cfg), state
