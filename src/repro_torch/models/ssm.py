"""Mamba2 (SSD) blocks and the chunked linear-recurrence engine.

The port of the JAX package's ``models/ssm.py``, function for function.
The recurrence h_i = a_i h_{i-1} + g_i k_i (x) v_i is computed chunk by
chunk (chunk L): inside a chunk the contributions are dense (L x L) masked
decay products, and the state crosses chunks in a Python loop over the
S / L chunks (JAX's ``lax.scan``).  The statistics (cumulative log-decay,
gates, the state) are f32; the L x L products take the input dtype only
with ``mm_bf16`` and are f32 otherwise, with f32 accumulation either way.
The decay is masked before ``exp`` (above the diagonal it is positive and
would overflow).  The same engine runs the mLSTM (``models/xlstm.py``).

Decode is the O(1) recurrence step on the carried state.  Under a mesh ctx
the engine's head / feature sharding (JAX's ``engine_specs``) is not
ported: the blocks raise (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

Params = dict


def refuse_ctx(ctx, what: str) -> None:
    """The recurrent blocks run on one process only (ROADMAP queue 1, item
    6: the SSM and xLSTM engines under a mesh ctx)."""
    if ctx is not None:
        raise NotImplementedError(
            f"{what} under a mesh ctx (the engine's head/feature sharding, JAX's "
            f"engine_specs) is not ported (ROADMAP queue 1, item 6)")


def _mm(spec: str, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``einsum`` of operands rounded to ``dtype``, accumulated and returned
    in f32 (JAX's ``preferred_element_type=f32``): the rounded operands are
    widened, which is exact."""
    return torch.einsum(spec, a.to(dtype).float(), b.to(dtype).float())


def chunked_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             log_a: torch.Tensor, gate: torch.Tensor, *, chunk: int,
                             state0: Optional[torch.Tensor] = None,
                             mm_bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """y[i] = sum_{j<=i} exp(cum_i - cum_j) gate_j (q_i . k_j) v_j (+ carry).

    q, k (B, S, H, dk); v (B, S, H, dv); log_a, gate (B, S, H).  Returns
    (y (B, S, H, dv) in v's dtype, final state (B, H, dk, dv) f32)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    lc = min(chunk, s)
    if s % lc:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {lc}")
    f32 = torch.float32
    mm = torch.bfloat16 if mm_bf16 else f32
    state = state0 if state0 is not None else \
        torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
    below = torch.tril(torch.ones((lc, lc), dtype=torch.bool, device=q.device))
    ys = []
    for lo in range(0, s, lc):
        qq, kk, vv = q[:, lo:lo + lc], k[:, lo:lo + lc], v[:, lo:lo + lc]
        la, g = log_a[:, lo:lo + lc].float(), gate[:, lo:lo + lc].float()
        cum = torch.cumsum(la, dim=1)                            # (b, L, h) inclusive
        # intra-chunk: M[b,h,i,j] = (q_i . k_j) exp(cum_i - cum_j) g_j, j <= i
        scores = _mm("bihd,bjhd->bhij", qq, kk, mm)
        decay = cum[:, :, None, :] - cum[:, None, :, :]          # (b, i, j, h)
        decay = decay.masked_fill(~below[None, :, :, None], float("-inf"))
        m = scores * torch.exp(decay).permute(0, 3, 1, 2) * g.permute(0, 2, 1)[:, :, None, :]
        y_intra = _mm("bhij,bjhv->bihv", m, vv, mm)
        # inter-chunk: exp(cum_i) q_i . S_prev
        y_inter = torch.einsum("bihd,bhdv->bihv", qq.float(), state) * torch.exp(cum)[..., None]
        # S = exp(cum_L) S + sum_j exp(cum_L - cum_j) g_j k_j (x) v_j
        last = cum[:, -1:, :]
        w = torch.exp(last - cum) * g
        state = state * torch.exp(last[:, 0])[:, :, None, None] + \
            _mm("bjhd,bjhv->bhdv", kk.float() * w[..., None], vv, mm)
        ys.append(y_intra + y_inter)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return y.to(v.dtype), state


def linear_attention_step(state: torch.Tensor, q, k, v, log_a, gate
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  state (B, H, dk, dv) f32; q, k (B, H, dk); v (B, H,
    dv); log_a, gate (B, H).  Returns (y (B, H, dv), new state)."""
    a = torch.exp(log_a.float())[:, :, None, None]
    upd = torch.einsum("bhd,bhv->bhdv", k.float() * gate.float()[..., None], v.float())
    state = state * a + upd
    y = torch.einsum("bhd,bhdv->bhv", q.float(), state)
    return y.to(v.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------
def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return s, d_in, d_in // s.head_dim


def mamba2_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                dtype: Optional[torch.dtype] = None) -> Params:
    """The block's parameters as JAX draws them: ``A_log`` 0 (A = -1),
    ``D`` 1 and ``dt_bias`` -2 (softplus(-2) ~ 0.13) in f32, and the conv
    weights in the parameter dtype whatever ``dtype`` asks (the conv reads
    them in f32)."""
    s, d_in, nh = _dims(cfg)
    d = cfg.d_model
    dev = L._device(gen)
    conv_ch = d_in + 2 * s.d_state
    f32 = torch.float32
    return {
        "in_proj": L.dense_init(gen, d, 2 * d_in + 2 * s.d_state + nh, cfg, dtype=dtype),
        "conv_w": L._normal(gen, (s.conv_width, conv_ch), 1.0 / math.sqrt(s.conv_width),
                            L._pdtype(cfg)),
        "A_log": torch.zeros((nh,), dtype=f32, device=dev),
        "D": torch.ones((nh,), dtype=f32, device=dev),
        "dt_bias": torch.full((nh,), -2.0, dtype=f32, device=dev),
        "norm": L.norm_init(d_in, cfg, dev),
        "out_proj": L.dense_init(gen, d_in, d, cfg, dtype=dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, cache: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv.  x (B, S, C); w (W, C).  With ``cache`` (the
    last W-1 inputs) the window is seeded from it instead of zeros and the
    rolled cache is returned (S == 1: decode; S > 1: the fused prefill)."""
    wlen = w.shape[0]
    b, s, c = x.shape
    prev = cache if cache is not None else \
        torch.zeros((b, wlen - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)                 # (B, W-1+S, C)
    y = sum(xp[:, i:i + s].float() * w[i].float() for i in range(wlen))
    return y.to(x.dtype), (xp[:, s:] if cache is not None else None)


def mamba2_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 cache: Optional[dict] = None, ctx=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, d) -> (B, S, d).  ``cache``: {"conv": (B, W-1, C), "ssm":
    (B, H, dk, dv)}; S == 1 with a cache is the decode step, S > 1 the fused
    prefill (the chunk scan seeded from the cached state)."""
    refuse_ctx(ctx, "mamba2_block")
    s, d_in, nh = _dims(cfg)
    b, seq, _ = x.shape
    zxbcdt = L.dense(x, p["in_proj"], cfg)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_in, d_in + 2 * s.d_state, nh], dim=-1)

    new_cache = {}
    xbc, conv_new = _causal_conv(xbc, p["conv_w"], cache["conv"] if cache is not None else None)
    xbc = F.silu(xbc.float()).to(xbc.dtype)
    if cache is not None:
        new_cache["conv"] = conv_new

    xh = xbc[..., :d_in].reshape(b, seq, nh, s.head_dim)
    bmat = xbc[..., d_in:d_in + s.d_state]                       # (B, S, dk), shared heads
    cmat = xbc[..., d_in + s.d_state:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])               # (B, S, nh)
    log_a = -torch.exp(p["A_log"]) * dt
    q = cmat[:, :, None, :].expand(b, seq, nh, s.d_state)
    k = bmat[:, :, None, :].expand(b, seq, nh, s.d_state)

    if cache is not None and seq == 1:
        y, new_cache["ssm"] = linear_attention_step(cache["ssm"], q[:, 0], k[:, 0], xh[:, 0],
                                                    log_a[:, 0], dt[:, 0])
        y = y[:, None]
    else:
        y, state = chunked_linear_attention(
            q, k, xh, log_a, dt, chunk=s.chunk,
            state0=cache["ssm"] if cache is not None else None, mm_bf16=s.mm_bf16)
        if cache is not None:
            new_cache["ssm"] = state

    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, seq, d_in).to(L._dtype(cfg))
    y = y * F.silu(z.float()).to(y.dtype)
    y = L.apply_norm(p["norm"], y, cfg)
    return L.dense(y, p["out_proj"], cfg), (new_cache if cache is not None else None)


def mamba2_init_cache(batch: int, cfg: ModelConfig, device, dtype: torch.dtype) -> dict:
    """The block's decode state: the conv's last W-1 inputs in ``dtype``
    and the SSM state in f32, zeros."""
    s, d_in, nh = _dims(cfg)
    return {"conv": torch.zeros((batch, s.conv_width - 1, d_in + 2 * s.d_state), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, nh, s.d_state, s.head_dim), dtype=torch.float32,
                               device=device)}
