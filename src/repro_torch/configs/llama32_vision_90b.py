"""Llama-3.2-Vision-90B — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].

100 decoder layers as 20 super-blocks of (4 self-attn + 1 cross-attn); the ViT
vision encoder + projector are a stub — input_specs() supplies image_embeds at
d_model (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, cross_attn_every=4, n_image_tokens=1024,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
