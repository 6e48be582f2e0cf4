"""Carry the JAX package's parameters over to the port.

``params_from_jax`` takes the tree ``repro.models.transformer.init`` returns,
with every array already turned into numpy (the tests do that, so this
module never sees JAX), and returns the port's parameter dict:

  * ``params["layers"]`` in JAX is a tuple over the block pattern whose
    leaves are stacked over ``n_periods``; it is unstacked into one dict per
    layer, in layer order (period j, kind i -> layer j * len(pattern) + i);
  * weight matrices keep the JAX layout ``(d_in, d_out)``, which the port's
    ``dense`` multiplies as ``x @ w`` -- nothing is transposed;
  * the tied embedding stays one ``(vocab, d_model)`` matrix, used for the
    lookup and, transposed at the call, for the logits; an untied model
    keeps its ``unembed`` ``(d_model, vocab)``.

Matrices are cast to ``dtype`` (default ``cfg.dtype``); vectors (norm
scales and biases) stay f32, as the JAX model reads them.

``cache_from_jax`` takes the end-aligned cache ``repro.models.transformer.
init_cache`` builds (a tuple over the block pattern of ``{"attn": (K, V)}``,
leaves stacked over periods, as numpy) and returns the port's list of
per-layer (K, V) rows ``(B, L, Hkv, hd)``, in the same layer order.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, torch_dtype


def _tensor(a, device, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    t = torch.from_numpy(np.array(a, dtype=np.float32))   # a writable copy
    return t.to(device=device, dtype=dtype if a.ndim >= 2 else torch.float32)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """JAX parameter tree (numpy leaves) -> the port's parameters."""
    dt = dtype if dtype is not None else torch_dtype(cfg.dtype)
    period = cfg.block_pattern
    stacked = tree["layers"]
    if len(stacked) != len(period):
        raise ValueError(f"layers tree has {len(stacked)} kinds, pattern is {period}")
    layers = [_map(stacked[i], lambda a, j=j: _tensor(np.asarray(a)[j], device, dt))
              for j in range(cfg.n_periods) for i in range(len(period))]
    out = {"embed": _map(tree["embed"], lambda a: _tensor(a, device, dt)),
           "layers": layers,
           "final_norm": _map(tree["final_norm"], lambda a: _tensor(a, device, dt))}
    if cfg.tie_embeddings and "unembed" in out["embed"]:
        raise ValueError("a tied-embedding config has no separate unembed matrix")
    return out


def cache_from_jax(tree: Any, cfg: ModelConfig, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> list:
    """JAX end-aligned cache (numpy leaves) -> the port's per-layer (K, V)
    list.  ``dtype`` defaults to the leaves' own (bf16 as JAX stores it,
    carried over exactly)."""
    period = cfg.block_pattern
    if len(tree) != len(period) or any(k != "attn" for k in period):
        raise ValueError(f"cache tree has {len(tree)} kinds for pattern {period}; "
                         f"only 'attn' caches are ported")

    def one(a, j):
        a = np.asarray(a)[j]
        bf16 = a.dtype.name == "bfloat16"    # numpy has no bf16: widen exactly
        t = torch.from_numpy(np.array(a, dtype=np.float32 if bf16 else a.dtype))
        return t.to(device=device, dtype=dtype or (torch.bfloat16 if bf16 else t.dtype))

    return [tuple(one(a, j) for a in tree[i]["attn"])
            for j in range(cfg.n_periods) for i in range(len(period))]
