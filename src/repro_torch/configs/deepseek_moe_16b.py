"""DeepSeek-MoE-16B — 2 shared + 64 routed top-6, fine-grained [arXiv:2401.06066]."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    moe=MoESpec(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    source="arXiv:2401.06066",
)
