"""xLSTM-1.3B [arXiv:2405.04517]: sLSTM + mLSTM blocks, 7:1 ratio."""
from repro_torch.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, chunk=256),
    norm="layernorm", tie_embeddings=True, sub_quadratic=True,
    notes="d_ff=0: mLSTM/sLSTM blocks carry their own projections.",
)
