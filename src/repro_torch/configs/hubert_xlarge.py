"""HuBERT-XLarge — encoder-only, wav2vec2 arch [arXiv:2106.07447].

Conv feature extractor is a stub (input_specs() supplies frame embeddings);
vocab=504 is the masked-prediction codebook. No decode shapes (encoder-only).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio", encoder_only=True,
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504, norm="layernorm", act="gelu", rope="none",
    source="arXiv:2106.07447",
)
