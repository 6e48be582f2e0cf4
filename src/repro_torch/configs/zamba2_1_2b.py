"""Zamba2-1.2B [arXiv:2411.15242; hf]: Mamba2 backbone + shared attention
block interleaved (single weight set, applied at two points per period)."""
from repro_torch.config import ModelConfig, SSMConfig

_P = ["mamba2"] * 19
_P[5] = _P[12] = "mamba2_attn"

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000,
    head_dim=64,
    block_pattern=tuple(_P),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True, sub_quadratic=True,
)
