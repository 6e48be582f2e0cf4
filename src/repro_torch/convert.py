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

``train_state_from_jax`` takes the JAX train state (``{"params", "opt":
{"m", "v", "step"[, "master"]}}`` as numpy) and returns the port's: the
parameters through ``params_from_jax`` in f32 (JAX's master dtype; bf16 when
the state keeps an f32 ``master``), the moments and master copy unstacked
the same way in their own dtypes, the step an int32 0-d tensor.

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
from repro_torch.tree import tree_map


def _tensor(a, device, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    t = torch.from_numpy(np.array(a, dtype=np.float32))   # a writable copy
    return t.to(device=device, dtype=dtype if a.ndim >= 2 else torch.float32)


def _keep_dtype(a, device) -> torch.Tensor:
    """numpy leaf -> tensor of the same dtype (bf16 carried over exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":    # numpy has no bf16: widen exactly
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _unstack(tree: dict, cfg: ModelConfig, fn) -> dict:
    """A JAX parameter-shaped tree -> the port's layout, ``fn`` on each leaf."""
    period = cfg.block_pattern
    stacked = tree["layers"]
    if len(stacked) != len(period):
        raise ValueError(f"layers tree has {len(stacked)} kinds, pattern is {period}")
    layers = [tree_map(lambda a, j=j: fn(np.asarray(a)[j]), stacked[i])
              for j in range(cfg.n_periods) for i in range(len(period))]
    return {"embed": tree_map(fn, tree["embed"]), "layers": layers,
            "final_norm": tree_map(fn, tree["final_norm"])}


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """JAX parameter tree (numpy leaves) -> the port's parameters."""
    dt = dtype if dtype is not None else torch_dtype(cfg.dtype)
    out = _unstack(tree, cfg, lambda a: _tensor(a, device, dt))
    if cfg.tie_embeddings and "unembed" in out["embed"]:
        raise ValueError("a tied-embedding config has no separate unembed matrix")
    return out


def train_state_from_jax(state: dict, cfg: ModelConfig, device="cuda") -> dict:
    """JAX train state (numpy leaves) -> the port's train state."""
    keep = lambda a: _keep_dtype(a, device)
    opt = state["opt"]
    if "master" in opt:               # bf16 params beside an f32 master copy
        params = _unstack(state["params"], cfg, keep)
    else:
        params = params_from_jax(state["params"], cfg, device, dtype=torch.float32)
    out_opt = {"m": _unstack(opt["m"], cfg, keep), "v": _unstack(opt["v"], cfg, keep),
               "step": torch.tensor(int(opt["step"]), dtype=torch.int32, device=device)}
    if "master" in opt:
        out_opt["master"] = _unstack(opt["master"], cfg, keep)
    return {"params": params, "opt": out_opt}


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
        t = _keep_dtype(np.asarray(a)[j], device)
        return t if dtype is None else t.to(dtype)

    return [tuple(one(a, j) for a in tree[i]["attn"])
            for j in range(cfg.n_periods) for i in range(len(period))]
