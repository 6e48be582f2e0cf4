"""Architecture registry: one module per assigned architecture.

``get(name)`` returns the ModelConfig; ``ARCHS`` lists all ids;
``shapes_for(name)`` and ``cells()`` give the (arch x shape) cells that
apply (long_500k only for sub-quadratic archs), as in the JAX package;
``reduced`` shrinks an arch to a CPU-sized model of the same family and
topology.  Every arch is here as data; the port's model runs the dense
``"attn"`` ones (``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig

ARCHS = [
    "xlstm-1.3b",
    "llama3.2-3b",
    "command-r-plus-104b",
    "llama3-405b",
    "chatglm3-6b",
    "zamba2-1.2b",
    "chameleon-34b",
    "whisper-base",
    "kimi-k2-1t-a32b",
    "mixtral-8x22b",
]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get(name: str) -> ModelConfig:
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[name]}").CONFIG


def shapes_for(name: str) -> List[ShapeConfig]:
    cfg = get(name)
    return [s for s in SHAPES.values()
            if not (s.name == "long_500k" and not cfg.sub_quadratic)]


def cells() -> List[tuple]:
    """All (arch, shape) dry-run cells, including skip markers."""
    out = []
    for a in ARCHS:
        cfg = get(a)
        for s in SHAPES.values():
            out.append((a, s.name, s.name == "long_500k" and not cfg.sub_quadratic))
    return out


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
