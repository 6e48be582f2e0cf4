"""ChatGLM3-6B [arXiv:2406.12793; hf]: 2d-RoPE (half-dim rotary), GQA kv=2."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696, vocab=65024,
    rope_fraction=0.5,
)
