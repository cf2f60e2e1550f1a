"""Zamba2-7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 Mamba2 layers in 9 super-blocks; one shared-weight attention+MLP block is
invoked after every 9 SSM layers (DESIGN.md §5 structural notes).
"""
from repro_torch.configs.base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, shared_attn_every=9,
    ssm=SSMSpec(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    source="arXiv:2411.15242",
)
