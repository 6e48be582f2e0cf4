"""Llama-3-405B [arXiv:2407.21783]: GQA, 128k vocab."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248, vocab=128256,
    head_dim=128, rope_theta=500000.0,
    notes="Training states need >16GiB/chip on 256 chips; fits at 512 with "
          "ZeRO over pod axis + bf16 optimizer states (see EXPERIMENTS.md).",
)
