"""Mixtral-8x22B [arXiv:2401.04088; hf]: 8 experts top-2, sliding-window
attention (window 4096) => sub-quadratic decode, long_500k runs with a ring
KV cache."""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768,
    head_dim=128, rope_theta=1000000.0, window=4096,
    block_pattern=("attn_moe",),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
    sub_quadratic=True,
    notes="8 experts < 16 model shards => 'tp' expert layout (dropless).",
)
