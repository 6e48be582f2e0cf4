"""Architecture registry: one module per arch the port serves.

``get(name)`` returns the ModelConfig; ``ARCHS`` lists the ids; ``reduced``
shrinks an arch to a CPU-sized model of the same family and topology.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.config import ModelConfig

ARCHS = ["llama3.2-3b"]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get(name: str) -> ModelConfig:
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[name]}").CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink an arch config to a CPU-trainable size, same family/topology
    (the same shrink as the JAX package's ``launch.train.reduced``)."""
    kw = dict(n_layers=len(cfg.block_pattern), d_model=128, n_heads=4,
              n_kv_heads=min(4, cfg.n_kv_heads), d_ff=256 if cfg.d_ff else 0,
              vocab=512, head_dim=32)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4, top_k=2,
                                        d_ff_expert=128)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    if cfg.xlstm:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, chunk=32)
    if cfg.window:
        kw["window"] = 64
    return cfg.replace(**kw)
