"""Chameleon-34B [arXiv:2405.09818]: early-fusion VLM — VQ image tokens share
the text vocab, so the backbone is a dense LM; frontend stubbed (input_specs
provides token ids).  QK-norm for stability (paper §2)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536,
    head_dim=128, qk_norm=True,
)
