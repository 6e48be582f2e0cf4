"""Carry the JAX package's parameters, train states and caches over to the
port.

``params_from_jax`` takes the tree ``repro.models.transformer.init`` (or
``repro.models.encdec.init``) returns, with every array already turned
into numpy (the tests do that, so this module never sees JAX), and returns
the port's parameter dict:

  * ``params["layers"]`` in JAX is a tuple over the block pattern whose
    leaves are stacked over ``n_periods``; it is unstacked into one dict per
    layer, in layer order (period j, kind i -> layer j * len(pattern) + i).
    The enc-dec's ``enc_layers`` / ``dec_layers``, stacked over the layers,
    become lists the same way; Zamba2's ``shared_attn`` is not stacked;
  * weight matrices keep the JAX layout ``(d_in, d_out)``, which the port's
    ``dense`` multiplies as ``x @ w`` -- nothing is transposed;
  * the tied embedding stays one ``(vocab, d_model)`` matrix, used for the
    lookup and, transposed at the call, for the logits; an untied model
    keeps its ``unembed`` ``(d_model, vocab)``.

Matrices (and the (E, ., .) expert leaves) are cast to ``dtype`` (default
``cfg.dtype``); vectors (norm scales and biases) stay f32, as the JAX model
reads them, and so do the leaves JAX keeps in f32 whatever the dtype
(``F32_LEAVES``: the MoE router, the Mamba2 conv weights and its A_log /
D / dt_bias, the enc-dec positional tables).

``train_state_from_jax`` takes the JAX train state (``{"params", "opt":
{"m", "v", "step"[, "master"]}}`` as numpy) and returns the port's: the
parameters through ``params_from_jax`` in f32 (JAX's master dtype; bf16 when
the state keeps an f32 ``master``), the moments and master copy unstacked
the same way in their own dtypes, the step an int32 0-d tensor.

``cache_from_jax`` takes an end-aligned cache (``repro.models.transformer.
init_cache``: a tuple over the block pattern of per-kind dicts, leaves
stacked over periods; ``repro.models.encdec.init_cache``: ``{"attn": (K,
V)}`` stacked over the decoder layers) and returns the port's per-layer
list: a (K, V) pair for an attention layer, the state dict for a recurrent
one (``models/transformer.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, torch_dtype
from repro_torch.tree import leaves_with_path, tree_map, tree_unflatten

F32_LEAVES = frozenset({"router", "conv_w", "A_log", "D", "dt_bias", "enc_pos", "dec_pos"})


def _tensor(a, device, dtype: torch.dtype, name: str = "") -> torch.Tensor:
    a = np.asarray(a)
    t = torch.from_numpy(np.array(a, dtype=np.float32))   # a writable copy
    keep = a.ndim < 2 or name in F32_LEAVES
    return t.to(device=device, dtype=torch.float32 if keep else dtype)


def _keep_dtype(a, device) -> torch.Tensor:
    """numpy leaf -> tensor of the same dtype (bf16 carried over exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":    # numpy has no bf16: widen exactly
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map_named(fn: Callable, tree):
    """``fn(leaf, name)`` over a tree, ``name`` the leaf's last dict key."""
    pairs = leaves_with_path(tree)
    return tree_unflatten(tree, [fn(leaf, next((k for k in reversed(path)
                                                 if isinstance(k, str)), ""))
                                 for path, leaf in pairs])


def _unstack(tree: dict, cfg: ModelConfig, fn: Callable) -> dict:
    """A JAX parameter-shaped tree -> the port's layout, ``fn(leaf, name)``
    on each leaf."""
    out = {}
    for key, sub in tree.items():
        if key == "layers":
            period = cfg.block_pattern
            if len(sub) != len(period):
                raise ValueError(f"layers tree has {len(sub)} kinds, pattern is {period}")
            out[key] = [_map_named(lambda a, n, j=j: fn(np.asarray(a)[j], n), sub[i])
                        for j in range(cfg.n_periods) for i in range(len(period))]
        elif key in ("enc_layers", "dec_layers"):
            out[key] = [_map_named(lambda a, n, j=j: fn(np.asarray(a)[j], n), sub)
                        for j in range(cfg.n_layers)]
        elif isinstance(sub, dict):
            out[key] = _map_named(fn, sub)
        else:
            out[key] = fn(sub, key)
    return out


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """JAX parameter tree (numpy leaves) -> the port's parameters."""
    dt = dtype if dtype is not None else torch_dtype(cfg.dtype)
    out = _unstack(tree, cfg, lambda a, n: _tensor(a, device, dt, n))
    if cfg.tie_embeddings and "unembed" in out["embed"]:
        raise ValueError("a tied-embedding config has no separate unembed matrix")
    return out


def train_state_from_jax(state: dict, cfg: ModelConfig, device="cuda") -> dict:
    """JAX train state (numpy leaves) -> the port's train state."""
    keep = lambda a, n: _keep_dtype(a, device)
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
    """JAX end-aligned cache (numpy leaves) -> the port's per-layer list.
    ``dtype`` casts the attention K/V (default: the leaves' own, bf16 as JAX
    stores it, carried over exactly); state leaves keep their dtype."""
    def kv(pair, j):
        ts = tuple(_keep_dtype(np.asarray(a)[j], device) for a in pair)
        return ts if dtype is None else tuple(t.to(dtype) for t in ts)

    def state(sub, j):
        return tree_map(lambda a: _keep_dtype(np.asarray(a)[j], device), sub)

    if cfg.enc_dec:
        return [kv(tree["attn"], j) for j in range(cfg.n_layers)]
    period = cfg.block_pattern
    if len(tree) != len(period):
        raise ValueError(f"cache tree has {len(tree)} kinds for pattern {period}")
    out = []
    for j in range(cfg.n_periods):
        for i, kind in enumerate(period):
            c = tree[i]
            if kind in ("attn", "attn_moe"):
                out.append(kv(c["attn"], j))
            else:
                out.append({k: (kv(v, j) if k == "shared_attn" else state(v, j))
                            for k, v in c.items()})
    return out
