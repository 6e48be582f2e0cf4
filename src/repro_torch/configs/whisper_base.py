"""Whisper-base [arXiv:2212.04356]: encoder-decoder, conv frontend STUBBED
(input_specs provides (B, 1500, d) frame embeddings)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865,
    enc_dec=True, norm="layernorm", act="gelu", tie_embeddings=True,
)
