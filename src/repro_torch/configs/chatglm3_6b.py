"""ChatGLM3-6B — RoPE 2d, GQA kv=2 [arXiv:2406.12793]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, rope="2d",
    source="arXiv:2406.12793",
)
