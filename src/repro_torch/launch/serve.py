"""Serving steps: prefill (prompt -> logits + caches) and one-token decode
(port of ``repro.launch.serve``).

The reference jits both steps and donates the decode state so the KV cache
updates in place; the port runs them eagerly and the decode writes the cache
in place itself (``models/attention.py::decode_self_attention``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf


def make_prefill_step(cfg: ArchConfig, cache_len: int) -> Callable:
    def step(params, tokens, image_embeds=None):
        return tf.prefill(params, cfg, tokens, cache_len,
                          image_embeds=image_embeds)

    return step


def make_decode_step(cfg: ArchConfig) -> Callable:
    def step(params, token, state):
        return tf.decode_step(params, cfg, token, state)

    return step


def next_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy int32[B, 1] token from logits ``[B, T, V]`` (the last position
    is the prediction) or ``[B, V]``."""
    if logits.dim() == 3:
        logits = logits[:, -1, :]
    return torch.argmax(logits, -1)[:, None].to(torch.int32)


def greedy_generate(params, cfg: ArchConfig, prompt: torch.Tensor, n_new: int,
                    cache_len: int) -> torch.Tensor:
    """Host-driven greedy loop: prompt int[B, T] -> int32[B, n_new]."""
    logits, state = make_prefill_step(cfg, cache_len)(params, prompt)
    step = make_decode_step(cfg)
    tok = next_token(logits)
    out = [tok]
    for _ in range(n_new - 1):
        logits, state = step(params, tok, state)
        tok = next_token(logits)
        out.append(tok)
    return torch.cat(out, dim=1)
