"""Granite-20B-Code — llama-arch, MQA kv=1 [arXiv:2405.04324]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, act="gelu",  # gpt-bigcode lineage: gelu MLP, MQA
    source="arXiv:2405.04324",
)
