"""The default model module: the plain reference of the attention models
that a configuration file without a ``reference`` key describes, in float32
with TF32 off.  A configuration whose layers this module lacks names a
module of its own (``spec.model_module``), with the same ``logits``
signature and a ``leaf_plan`` (here: ``weights.leaf_plan``).

It follows a configuration file's ``model`` block and the weight tree that
``weights.make`` lays out, and imports only torch: no kernel, cache,
batching or code of the program.  One sequence at a time, layer by layer:
RMSNorm, grouped-query attention (causal, with the block's window if it
has one) with RoPE on the first ``rope_fraction`` of each head (the
rotated part split in halves, as the configuration file states), and a
SwiGLU MLP or a top-k MoE layer (softmax over the k picked router logits,
the picked experts' SwiGLU outputs summed with those weights).  Attention
runs in blocks of query rows so that an 8k prompt fits.

``fp8=True`` is the control: every linear layer's operands rounded to
float8 e4m3 with one scale a tensor (what a serving stack that quantises
its matrix products computes), everything else as above.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch

Q_BLOCK = 1024        # query rows of attention at a time
E4M3_MAX = 448.0


@contextmanager
def strict_f32():
    """float32 products without TF32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = E4M3_MAX / t.abs().max().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def _linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    w = w.float()
    if fp8:
        x, w = _fp8(x), _fp8(w)
    return x @ w


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, model: dict) -> torch.Tensor:
    """x (T, H, hd) at positions pos (T,)."""
    hd = x.shape[-1]
    rot = int(hd * model.get("rope_fraction", 1.0))
    rot -= rot % 2
    half = rot // 2
    if half == 0:
        return x
    inv = model.get("rope_theta", 10000.0) ** (
        -torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = pos.double()[:, None] * inv                           # (T, half)
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:rot]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos, x[..., rot:]], dim=-1)


def _attention(q, k, v, window) -> torch.Tensor:
    """q (T, Hq, hd), k and v (T, Hkv, hd), causal from position 0."""
    t, hq, hd = q.shape
    hkv = k.shape[1]
    q = q.reshape(t, hkv, hq // hkv, hd) / math.sqrt(hd)
    out = torch.empty_like(q)
    pos = torch.arange(t, device=q.device)
    for lo in range(0, t, Q_BLOCK):
        hi = min(t, lo + Q_BLOCK)
        s = torch.einsum("qgrd,kgd->grqk", q[lo:hi], k[:hi])
        vis = pos[:hi][None] <= pos[lo:hi, None]
        if window is not None:
            vis &= pos[lo:hi, None] - pos[:hi][None] < window
        s = s.masked_fill(~vis, float("-inf"))
        out[lo:hi] = torch.einsum("grqk,kgd->qgrd", torch.softmax(s, dim=-1), v[:hi])
    return out.reshape(t, hq * hd)


def _swiglu(x, w_gate, w_up, w_down, fp8: bool) -> torch.Tensor:
    g = _linear(x, w_gate, fp8)
    return _linear(torch.nn.functional.silu(g) * _linear(x, w_up, fp8), w_down, fp8)


def _moe(x, p, moe: dict, fp8: bool) -> torch.Tensor:
    logits = x @ p["router"].float()
    top_v, top_i = torch.topk(logits, moe["top_k"], dim=-1)
    weights = torch.softmax(top_v, dim=-1)
    out = torch.zeros_like(x)
    for e in range(moe["n_experts"]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel():
            y = _swiglu(x[rows], p["w_gate"][e], p["w_up"][e], p["w_down"][e], fp8)
            out.index_add_(0, rows, y * weights[rows, slot, None])
    return out


def logits(params: dict, model: dict, tokens: torch.Tensor, n_out: int, *,
           fp8: bool = False) -> torch.Tensor:
    """f32 logits (n_out, vocab) at the last ``n_out`` positions of the
    sequence ``tokens`` (T,), each predicting the token after it."""
    for key, want in (("norm", "rmsnorm"), ("act", "swiglu")):
        if model.get(key, want) != want:
            raise NotImplementedError(f"the reference has no {key}={model[key]!r}")
    if model.get("qk_norm") or model.get("parallel_block") or model.get("tie_embeddings") \
            or model.get("logit_softcap"):
        raise NotImplementedError("the reference has no qk_norm, parallel block, tied "
                                  "embeddings or logit softcap")
    d, hq, hkv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // hq
    eps = model.get("norm_eps", 1e-5)
    pattern = model.get("block_pattern", ["attn"])
    t = tokens.shape[0]
    pos = torch.arange(t, device=tokens.device)
    with strict_f32():
        h = params["embed"]["embedding"][tokens.long()].float()
        for i, p in enumerate(params["layers"]):
            x = _rms(h, p["ln1"]["scale"], eps)
            a = p["attn"]
            q = _rope(_linear(x, a["wq"], fp8).reshape(t, hq, hd), pos, model)
            k = _rope(_linear(x, a["wk"], fp8).reshape(t, hkv, hd), pos, model)
            v = _linear(x, a["wv"], fp8).reshape(t, hkv, hd)
            h = h + _linear(_attention(q, k, v, model.get("window")), a["wo"], fp8)
            x = _rms(h, p["ln2"]["scale"], eps)
            if pattern[i % len(pattern)] == "attn":
                m = p["mlp"]
                h = h + _swiglu(x, m["w_gate"], m["w_up"], m["w_down"], fp8)
            else:
                h = h + _moe(x, p["moe"], model["moe"], fp8)
        x = _rms(h[t - n_out:], params["final_norm"]["scale"], eps)
        return _linear(x, params["embed"]["unembed"], fp8)
