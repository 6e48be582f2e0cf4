"""Kimi K2 1T-A32B [arXiv:2501.kimi2, paper table]: trillion-param MoE,
384 experts top-8 + 1 shared expert, expert d_ff=2048."""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840,
    head_dim=128,
    block_pattern=("attn_moe",),
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048, n_shared_experts=1),
    notes="1T total / ~32B active; EP=16 over 'model' (24 experts/shard).",
)
