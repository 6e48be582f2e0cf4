"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-plus]: GQA, no-bias,
parallel attention/FFN blocks, LayerNorm."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792, vocab=256000,
    head_dim=128, rope_theta=75000000.0, parallel_block=True,
    norm="layernorm", tie_embeddings=True,
)
