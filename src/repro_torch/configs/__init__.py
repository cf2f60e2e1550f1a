"""Assigned-architecture registry: ``get(name)`` / ``--arch <id>`` (copy of
``repro.configs``). The port builds and serves every family of the ten
(``models/transformer.py``): dense, MoE, VLM cross-attention, the audio
encoder, the hybrid Mamba2 model and xLSTM.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, MoESpec, SSMSpec, reduced

ARCHS = [
    "xlstm_125m",
    "chatglm3_6b",
    "yi_6b",
    "llama32_vision_90b",
    "hubert_xlarge",
    "zamba2_7b",
    "granite_20b",
    "deepseek_moe_16b",
    "yi_9b",
    "llama4_scout_17b_a16e",
]

_ALIAS = {
    "xlstm-125m": "xlstm_125m",
    "chatglm3-6b": "chatglm3_6b",
    "yi-6b": "yi_6b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-7b": "zamba2_7b",
    "granite-20b": "granite_20b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "yi-9b": "yi_9b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
}


def get(name: str) -> ArchConfig:
    mod_name = _ALIAS.get(name, name)
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIAS)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg: ArchConfig = mod.CONFIG
    cfg.validate()
    return cfg


def all_archs() -> list[str]:
    return list(ARCHS)


__all__ = ["ArchConfig", "MoESpec", "SSMSpec", "reduced", "get", "all_archs", "ARCHS"]
