"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of the JAX package's ``models/xlstm.py``.  The mLSTM runs through
the chunked linear-recurrence engine of ``models/ssm.py``: gated linear
attention with a normaliser channel, state S = sum_j (prod f) i_j k_j (x)
[v_j, 1], output h = (q.S)[:dv] / max(|q.S|[dv], 1), with sigmoid input and
forget gates (log-sigmoid decays).  The sLSTM keeps per-channel scalar
state with exponential gating and the stabiliser m (starting at -1e30), as
a Python loop over time (JAX's ``lax.scan``).

Under a mesh ctx the blocks run as ``models/ssm.py``'s do: tensor-parallel
(projections gathered, the mLSTM engine in ``engine_specs(nh, hd)``'s
layout -- xLSTM-1.3B's 4 heads split on ``model`` = 2 or 4, its dk 1024 on
8 -- the norm on the gathered output, the row-parallel down projection),
or replicated over ``model``.  The reference's sLSTM takes no ctx: GSPMD
computes it from the parameters' specs; here the recurrence, which is
elementwise in the channels, runs on the rank's channels where ``model``
splits them, the layout of its cache (``cache_specs``).  The mLSTM decode
step runs in its cache's layout (heads over ``model`` where they divide).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.core.dseq import all_gather_dim, copy_d
from repro_torch.models.ssm import (sharded_engine, chunked_linear_attention, linear_attention_step,
                                    model_slice, relayout, replicated_block, split_dim,
                                    tensor_parallel)

Params = dict
M_INIT = -1e30          # the sLSTM stabiliser's start


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    d_in = int(cfg.xlstm.proj_factor * d)
    nh = cfg.n_heads
    return d, d_in, nh, d_in // nh


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_init(gen: Optional[torch.Generator], cfg: ModelConfig,
               dtype: Optional[torch.dtype] = None) -> Params:
    d, d_in, nh, _ = _dims(cfg)
    return {
        "up_proj": L.dense_init(gen, d, 2 * d_in, cfg, dtype=dtype),     # x and gate z
        "wq": L.dense_init(gen, d_in, d_in, cfg, dtype=dtype),
        "wk": L.dense_init(gen, d_in, d_in, cfg, dtype=dtype),
        "wv": L.dense_init(gen, d_in, d_in, cfg, dtype=dtype),
        "w_gates": L.dense_init(gen, d_in, 2 * nh, cfg, dtype=dtype),    # i, f per head
        "norm": L.norm_init(d_in, cfg, L._device(gen)),
        "down_proj": L.dense_init(gen, d_in, d, cfg, dtype=dtype),
    }


def mlstm_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[dict] = None, ctx=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, d) -> (B, S, d).  ``cache``: {"ssm": (B, nh, hd, hd + 1)}."""
    d, d_in, nh, hd = _dims(cfg)
    if ctx is not None:
        if tensor_parallel(ctx):
            return _mlstm_tp(p, x, cfg, cache, ctx)
        shapes = {"up_proj": (d, 2 * d_in), "wq": (d_in, d_in), "wk": (d_in, d_in),
                  "wv": (d_in, d_in), "w_gates": (d_in, 2 * nh), "down_proj": (d_in, d)}
        return replicated_block(mlstm_block, "mlstm", p, x, cfg, cache, ctx, shapes,
                                {"ssm": split_dim(cache["ssm"] if cache is not None else None,
                                                  nh, 1)})
    b, s, _ = x.shape
    xi, z = torch.chunk(L.dense(x, p["up_proj"], cfg), 2, dim=-1)
    q = L.dense(xi, p["wq"], cfg).reshape(b, s, nh, hd) / math.sqrt(hd)
    k = L.dense(xi, p["wk"], cfg).reshape(b, s, nh, hd)
    v = L.dense(xi, p["wv"], cfg).reshape(b, s, nh, hd)
    i_raw, f_raw = torch.chunk(L.dense(xi, p["w_gates"], cfg).float(), 2, dim=-1)  # (B, S, nh)
    log_f = F.logsigmoid(f_raw)
    i_g = torch.sigmoid(i_raw)
    # the normaliser channel: v' = [v, 1]
    v_ext = torch.cat([v, torch.ones((b, s, nh, 1), dtype=v.dtype, device=v.device)], dim=-1)

    if cache is not None and s == 1:
        y, state = linear_attention_step(cache["ssm"], q[:, 0], k[:, 0], v_ext[:, 0],
                                         log_f[:, 0], i_g[:, 0])
        y = y[:, None]
        new_cache = {"ssm": state}
    else:
        y, state = chunked_linear_attention(
            q, k, v_ext, log_f, i_g, chunk=cfg.xlstm.chunk,
            state0=cache["ssm"] if cache is not None else None, mm_bf16=cfg.xlstm.mm_bf16)
        new_cache = {"ssm": state} if cache is not None else None

    num, den = y[..., :hd], y[..., hd:]
    h = num.float() / torch.clamp(torch.abs(den.float()), min=1.0)
    h = h.reshape(b, s, d_in).to(L._dtype(cfg))
    h = L.apply_norm(p["norm"], h, cfg)
    h = h * F.silu(z.float()).to(h.dtype)
    return L.dense(h, p["down_proj"], cfg), new_cache


def _mlstm_tp(p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Optional[dict], ctx
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """``mlstm_block`` tensor-parallel over ``model`` (``models/ssm.py``'s
    recipe)."""
    d, d_in, nh, hd = _dims(cfg)
    b, s, _ = x.shape
    xm = copy_d(x, ctx.model_axis, ctx.mesh)
    xi, z = torch.chunk(L.col_product(xm, p["up_proj"], ("mlstm", "up_proj"), (d, 2 * d_in),
                                      cfg, ctx), 2, dim=-1)

    def col(name, n_out):
        return L.col_product(xi, p[name], ("mlstm", name), (d_in, n_out), cfg, ctx)

    q = col("wq", d_in).reshape(b, s, nh, hd) / math.sqrt(hd)
    k = col("wk", d_in).reshape(b, s, nh, hd)
    v = col("wv", d_in).reshape(b, s, nh, hd)
    i_raw, f_raw = torch.chunk(col("w_gates", 2 * nh).float(), 2, dim=-1)
    log_f = F.logsigmoid(f_raw)
    i_g = torch.sigmoid(i_raw)
    v_ext = torch.cat([v, torch.ones((b, s, nh, 1), dtype=v.dtype, device=v.device)], dim=-1)
    cache_dim = split_dim(cache["ssm"] if cache is not None else None, nh, 1)

    if cache is not None and s == 1:
        # the decode step in the cache's layout
        hs = (lambda t: model_slice(t, 1, ctx)) if cache_dim else (lambda t: t)
        y, state = linear_attention_step(cache["ssm"], hs(q[:, 0]), hs(k[:, 0]),
                                         hs(v_ext[:, 0]), hs(log_f[:, 0]), hs(i_g[:, 0]))
        y = relayout(y, cache_dim, None, ctx)[:, None]
        new_cache = {"ssm": state}
    else:
        y, state = sharded_engine(q, k, v_ext, log_f, i_g, hd, ctx, chunk=cfg.xlstm.chunk,
                           state0=cache["ssm"] if cache is not None else None,
                           state_dim=cache_dim, mm_bf16=cfg.xlstm.mm_bf16)
        new_cache = {"ssm": state} if cache is not None else None

    num, den = y[..., :hd], y[..., hd:]
    h = num.float() / torch.clamp(torch.abs(den.float()), min=1.0)
    h = h.reshape(b, s, d_in).to(L._dtype(cfg))
    h = L.apply_norm(L.replicated_params(p["norm"], ctx), h, cfg)
    h = h * F.silu(z.float()).to(h.dtype)
    return L.row_product(h, p["down_proj"], ("mlstm", "down_proj"), (d_in, d), cfg,
                         ctx), new_cache


def mlstm_init_cache(batch: int, cfg: ModelConfig, device) -> dict:
    _, _, nh, hd = _dims(cfg)
    return {"ssm": torch.zeros((batch, nh, hd, hd + 1), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_init(gen: Optional[torch.Generator], cfg: ModelConfig,
               dtype: Optional[torch.dtype] = None) -> Params:
    d = cfg.d_model
    return {
        "w_in": L.dense_init(gen, d, 4 * d, cfg, dtype=dtype),   # z, i, f, o pre-activations
        "norm": L.norm_init(d, cfg, L._device(gen)),
        "proj": L.dense_init(gen, d, d, cfg, dtype=dtype),
    }


def _slstm_step(carry, zt, it, ft, ot):
    c, n, m = carry
    m_new = torch.maximum(ft + m, it)
    c = torch.exp(ft + m - m_new) * c + torch.exp(it - m_new) * zt
    n = torch.exp(ft + m - m_new) * n + torch.exp(it - m_new)
    h = ot * c / torch.clamp(n, min=1e-6)
    return (c, n, m_new), h


def slstm_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[dict] = None, ctx=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, d) -> (B, S, d).  ``cache``: {"c", "n", "m"}, each (B, d)
    f32.  ``ctx``: the module docstring."""
    b, s, d = x.shape
    tp = ctx is not None and tensor_parallel(ctx)
    if ctx is not None and not tp:
        return replicated_block(slstm_block, "slstm", p, x, cfg, cache, ctx,
                                {"w_in": (d, 4 * d), "proj": (d, d)},
                                dict.fromkeys("cnm", split_dim(cache["c"] if cache is not None
                                                               else None, d, 1)))
    if tp:
        xm = copy_d(x, ctx.model_axis, ctx.mesh)
        pre = L.col_product(xm, p["w_in"], ("slstm", "w_in"), (d, 4 * d), cfg, ctx).float()
    else:
        pre = L.dense(x, p["w_in"], cfg).float()
    z, i_raw, f_raw, o_raw = torch.chunk(pre, 4, dim=-1)           # (B, S, d) each
    z = torch.tanh(z)
    o = torch.sigmoid(o_raw)
    split = tp and d % ctx.model_size == 0           # the rank's channels, as its cache's
    if split:
        z, i_raw, f_raw, o = (model_slice(t, 2, ctx) for t in (z, i_raw, f_raw, o))
    start = cache if cache is not None else slstm_init_cache(b, cfg, x.device, z.shape[-1])
    carry = (start["c"], start["n"], start["m"])
    hs = []
    for t in range(s):
        carry, ht = _slstm_step(carry, z[:, t], i_raw[:, t], f_raw[:, t], o[:, t])
        hs.append(ht)
    h = torch.stack(hs, dim=1)
    if split:
        h = all_gather_dim(h, ctx.model_axis, -1, ctx.mesh)
    new_cache = dict(zip(("c", "n", "m"), carry)) if cache is not None else None
    if not tp:
        h = L.apply_norm(p["norm"], h.to(L._dtype(cfg)), cfg)
        return L.dense(h, p["proj"], cfg), new_cache
    h = L.apply_norm(L.replicated_params(p["norm"], ctx), h.to(L._dtype(cfg)), cfg)
    return L.row_product(h, p["proj"], ("slstm", "proj"), (d, d), cfg, ctx), new_cache


def slstm_init_cache(batch: int, cfg: ModelConfig, device, d: Optional[int] = None) -> dict:
    """c, n (0) and m (-1e30), each (batch, d) f32 (default d: d_model)."""
    d = d or cfg.d_model
    return {"c": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "m": torch.full((batch, d), M_INIT, dtype=torch.float32, device=device)}
