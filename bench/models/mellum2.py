"""The plain reference of Mellum2-12B-A2.5B (JetBrains'
``Mellum2-12B-A2.5B-Instruct``), in float32 with TF32 off, importing only
torch: no kernel, cache, batching or code of the program.

It follows the published ``config.json`` as a configuration file's
``model`` block states it, over the weight tree that ``leaf_plan`` lays
out (the benchmark's layout for attention layers with routed experts, as
``bench/weights.py`` makes it).  One sequence at a time, layer by layer:

  * RMSNorm (eps 1e-6) before attention and before the experts, and
    before the untied output head;
  * grouped-query attention, 32 query heads over 4 key/value heads of
    128, no bias.  The layers whose ``layer_windows`` entry is a number
    are sliding-window layers: a query at position q sees keys k with
    q - 1024 < k <= q.  The others see every earlier key;
  * RoPE at base 500,000 on the whole head, rotated in halves.  On the
    full layers it is YaRN's (HF ``rope_type: yarn``): frequency i of the
    64 is ``theta^(-2i/128)`` blended with the same over ``factor`` by the
    ramp between the pairs that turn ``beta_fast`` and ``beta_slow``
    times over the original 8,192 positions, and cos and sin are scaled
    by ``attention_factor``.  The sliding layers keep the plain rotation;
  * 64 routed experts, each a SwiGLU of width 896: a softmax over all 64
    router logits, the top 8, their probabilities renormalised to sum to
    1 (``norm_topk_prob``), the picked experts' outputs summed with those
    weights.  No shared expert, every layer sparse.

Departures from the published model, on both sides of the comparison:
random weights from the seed; no multi-token-prediction head (the
catalog's summary mentions one; the published config has no key for it);
the router's logits in float32 like everything else here.

``fp8=True`` is the control: every linear layer's operands rounded to
float8 e4m3 with one scale a tensor, everything else as above.
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


def leaf_plan(model: dict) -> list:
    """Every leaf as (path, shape, "matrix" | "vector", std): the embedding
    (std 0.02) and the head, then a layer's norm scales (std 0: 1 + 0.1 z),
    attention projections, router (an f32 vector leaf) and the experts'
    (E, d, ff) and (E, ff, d) matrices, then the final norm."""
    d, hq, hkv, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], model["head_dim"]
    moe = model["moe"]
    e, ff = moe["n_experts"], moe["d_ff_expert"]
    plan = [(("embed", "embedding"), (model["vocab"], d), "matrix", 0.02),
            (("embed", "unembed"), (d, model["vocab"]), "matrix", 1 / math.sqrt(d))]
    for i in range(model["n_layers"]):
        lp = ("layers", i)
        plan += [(lp + ("ln1", "scale"), (d,), "vector", 0.0),
                 (lp + ("attn", "wq"), (d, hq * hd), "matrix", 1 / math.sqrt(d)),
                 (lp + ("attn", "wk"), (d, hkv * hd), "matrix", 1 / math.sqrt(d)),
                 (lp + ("attn", "wv"), (d, hkv * hd), "matrix", 1 / math.sqrt(d)),
                 (lp + ("attn", "wo"), (hq * hd, d), "matrix", 1 / math.sqrt(hq * hd)),
                 (lp + ("ln2", "scale"), (d,), "vector", 0.0),
                 (lp + ("moe", "router"), (d, e), "vector", 1 / math.sqrt(d)),
                 (lp + ("moe", "w_gate"), (e, d, ff), "matrix", 1 / math.sqrt(d)),
                 (lp + ("moe", "w_up"), (e, d, ff), "matrix", 1 / math.sqrt(d)),
                 (lp + ("moe", "w_down"), (e, ff, d), "matrix", 1 / math.sqrt(ff))]
    plan.append((("final_norm", "scale"), (d,), "vector", 0.0))
    return plan


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


def inv_freq(hd: int, theta: float, yarn=None) -> torch.Tensor:
    """The 64 rotary frequencies (float64): ``theta^(-2i/hd)``, or YaRN's
    blend of them with the same over ``factor`` (``yarn`` as the
    configuration file states it)."""
    base = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    if yarn is None:
        return base

    def turns(n):       # the pair that turns n times over the original context
        return hd * math.log(yarn["original_max_position_embeddings"] / (n * 2 * math.pi)) / (
            2 * math.log(theta))
    lo = max(math.floor(turns(yarn["beta_fast"])), 0)
    hi = min(math.ceil(turns(yarn["beta_slow"])), hd - 1)
    ramp = ((torch.arange(hd // 2, dtype=torch.float64) - lo) / (hi - lo)).clamp(0, 1)
    return base / yarn["factor"] * ramp + base * (1 - ramp)


def _rope(x: torch.Tensor, pos: torch.Tensor, freq: torch.Tensor, scale: float) -> torch.Tensor:
    """x (T, H, hd) at positions pos (T,), rotated in halves."""
    half = x.shape[-1] // 2
    ang = pos.double()[:, None] * freq.to(x.device)                  # (T, half)
    cos = (torch.cos(ang) * scale).float()[:, None]
    sin = (torch.sin(ang) * scale).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, window) -> torch.Tensor:
    """q (T, Hq, hd), k and v (T, Hkv, hd), causal from position 0, keys
    older than ``window`` masked where it is a number."""
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


def _experts(x, p, moe: dict, fp8: bool) -> torch.Tensor:
    """A softmax over every router logit, the top k renormalised, the
    picked experts' SwiGLU outputs summed with those weights."""
    probs = torch.softmax(x @ p["router"].float(), dim=-1)
    top_p, top_i = torch.topk(probs, moe["top_k"], dim=-1)
    weights = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(moe["n_experts"]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel():
            xe = x[rows]
            g = _linear(xe, p["w_gate"][e], fp8)
            y = _linear(torch.nn.functional.silu(g) * _linear(xe, p["w_up"][e], fp8),
                        p["w_down"][e], fp8)
            out.index_add_(0, rows, y * weights[rows, slot, None])
    return out


def logits(params: dict, model: dict, tokens: torch.Tensor, n_out: int, *,
           fp8: bool = False) -> torch.Tensor:
    """f32 logits (n_out, vocab) at the last ``n_out`` positions of the
    sequence ``tokens`` (T,), each predicting the token after it."""
    d, hq, hkv, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], model["head_dim"]
    eps = model["norm_eps"]
    windows = model["layer_windows"]
    yarn = model.get("yarn")
    plain = inv_freq(hd, model["rope_theta"])
    scaled = inv_freq(hd, model["rope_theta"], yarn)
    t = tokens.shape[0]
    pos = torch.arange(t, device=tokens.device)
    with strict_f32():
        h = params["embed"]["embedding"][tokens.long()].float()
        for i, p in enumerate(params["layers"]):
            window = windows[i % len(windows)]
            freq, scale = (plain, 1.0) if window is not None or yarn is None else (
                scaled, yarn["attention_factor"])
            x = _rms(h, p["ln1"]["scale"], eps)
            a = p["attn"]
            q = _rope(_linear(x, a["wq"], fp8).reshape(t, hq, hd), pos, freq, scale)
            k = _rope(_linear(x, a["wk"], fp8).reshape(t, hkv, hd), pos, freq, scale)
            v = _linear(x, a["wv"], fp8).reshape(t, hkv, hd)
            h = h + _linear(_attention(q, k, v, window), a["wo"], fp8)
            h = h + _experts(_rms(h, p["ln2"]["scale"], eps), p["moe"], model["moe"], fp8)
        x = _rms(h[t - n_out:], params["final_norm"]["scale"], eps)
        return _linear(x, params["embed"]["unembed"], fp8)
