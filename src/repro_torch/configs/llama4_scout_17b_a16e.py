"""Llama-4-Scout-17B-16E — MoE top-1, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E].

Long-context layers use chunked attention; modeled as the sliding-window variant
for long_500k (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    moe=MoESpec(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
