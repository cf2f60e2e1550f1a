"""Yi-9B — llama-arch GQA, depth-extended Yi-6B [arXiv:2403.04652]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000,
    source="arXiv:2403.04652",
)
