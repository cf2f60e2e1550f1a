"""xLSTM-125M — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm", xlstm=True,
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0,  # assignment: gating/projection lives inside the cell (proj factor 2)
    vocab=50304, rope="none", tie_embeddings=True,
    source="arXiv:2405.04517",
)
