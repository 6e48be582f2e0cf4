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

Decode is the O(1) recurrence step on the carried state.

Under a mesh ctx (inside one rank, the input replicated over ``model``) a
block runs in one of two ways:

  * tensor-parallel (``model`` splits its weights): the column-parallel
    projections' outputs are gathered, the engine runs in the layout of
    ``engine_specs`` -- the rank's heads, or (heads not divisible) the
    rank's slice of the q/k feature dim dk, its partial q.k scores and
    q.S inter-chunk terms summed over ``model`` once a chunk -- and the
    output leaves through the row-parallel projection, summed over
    ``model`` (``layers.col_product`` / ``row_product``).  The depthwise
    conv runs on the rank's channels when ``model`` splits them.
  * replicated (``engine_replicate``, or pure data parallelism): the
    weights are whole on every rank of the model group (gathered over the
    fsdp axes) and the block is the one-process function on the rank's
    rows.
A cache is held in ``launch/specs.py::cache_specs``'s layout (the conv
window's channels and the SSM state's heads over ``model`` where they
divide); the decode step runs in that layout and the chunk scan moves the
state into its own and back (``relayout``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.dseq import all_gather_dim, copy_d, reduce_sum
from repro_torch.models import layers as L

Params = dict


def engine_specs(nh: int, dk: int, ctx):
    """The chunk engine's sharding (JAX's ``engine_specs``): (heads axis,
    dk axis).  Heads over ``model`` when they divide (Mamba2: 64 heads),
    else the q/k feature dim dk (mLSTM: 4 heads of dk 1024), whose partial
    scores are summed over ``model`` once a chunk; none under
    ``engine_replicate`` or ``dp_over_model``."""
    if ctx is None:
        return None, None
    if getattr(ctx, "engine_replicate", False) or getattr(ctx, "dp_over_model", False):
        return None, None
    msz = ctx.model_size
    if nh % msz == 0:
        return ctx.model_axis, None
    if dk % msz == 0:
        return None, ctx.model_axis
    return None, None


def tensor_parallel(ctx) -> bool:
    """Whether a recurrent block under ``ctx`` runs tensor-parallel (else
    replicated over ``model``, or with no ctx on one process)."""
    return ctx is not None and L._tp_axis(ctx) is not None and not ctx.engine_replicate


def relayout(t: Optional[torch.Tensor], src: Optional[int], dst: Optional[int], ctx
             ) -> Optional[torch.Tensor]:
    """``t`` split over ``model`` on dim ``src`` (None: whole) -> split on
    dim ``dst``: gathered, then the rank's slice taken."""
    if t is None or src == dst:
        return t
    if src is not None:
        t = all_gather_dim(t, ctx.model_axis, src, ctx.mesh)
    if dst is not None:
        n = t.shape[dst] // ctx.model_size
        t = t.narrow(dst, ctx.mesh.index(ctx.model_axis) * n, n)
    return t


def model_slice(t: torch.Tensor, dim: int, ctx) -> torch.Tensor:
    """The rank's block of ``t`` along ``dim``, split over ``model``."""
    return relayout(t, None, dim, ctx)


def partial_sum(ctx):
    """``psum(a, b)``: two partial tensors summed over ``model`` in one
    all-reduce (``reduceD("sum")``), the sums used by every rank; the
    transpose sums the ranks' cotangent shares the same way."""
    M, mesh = ctx.model_axis, ctx.mesh

    def psum(a: torch.Tensor, b: torch.Tensor):
        flat = copy_d(reduce_sum(torch.cat([a.reshape(-1), b.reshape(-1)]), M, mesh), M, mesh)
        return flat[:a.numel()].view_as(a), flat[a.numel():].view_as(b)
    return psum


def split_dim(leaf: Optional[torch.Tensor], n: int, dim: int) -> Optional[int]:
    """``dim`` when the cache block ``leaf`` holds fewer than the ``n``
    heads or channels of its global leaf there (``launch/specs.py`` split
    it over ``model``), else None (whole, or no cache)."""
    return dim if leaf is not None and leaf.shape[dim] < n else None


def replicated_block(block, group: str, p: Params, x: torch.Tensor, cfg: ModelConfig,
                     cache: Optional[dict], ctx, shapes: dict, cache_dims: dict):
    """A recurrent block whose weights ``model`` does not split
    (``engine_replicate``, or pure data parallelism): the one-process
    ``block`` on the rank's rows, the weights gathered over the fsdp axes;
    a cache leaf split over ``model`` (``cache_dims``: leaf -> dim) is
    gathered before and sliced after."""
    full = {n: L._weight(w, (group, n), shapes[n], cfg, ctx) if n in shapes else w
            for n, w in p.items()}
    dims = {} if ctx.dp_over_model else cache_dims
    if cache is not None:
        cache = {n: relayout(t, dims.get(n), None, ctx) for n, t in cache.items()}
    out, new = block(full, x, cfg, cache=cache)
    if new is not None:
        new = {n: relayout(t, None, dims.get(n), ctx) for n, t in new.items()}
    return out, new


def _mm(spec: str, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``einsum`` of operands rounded to ``dtype``, accumulated and returned
    in f32 (JAX's ``preferred_element_type=f32``): the rounded operands are
    widened, which is exact."""
    return torch.einsum(spec, a.to(dtype).float(), b.to(dtype).float())


def chunked_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             log_a: torch.Tensor, gate: torch.Tensor, *, chunk: int,
                             state0: Optional[torch.Tensor] = None,
                             mm_bf16: bool = False, psum: Optional[Callable] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y[i] = sum_{j<=i} exp(cum_i - cum_j) gate_j (q_i . k_j) v_j (+ carry).

    q, k (B, S, H, dk); v (B, S, H, dv); log_a, gate (B, S, H).  Returns
    (y (B, S, H, dv) in v's dtype, final state (B, H, dk, dv) f32).  With
    ``psum`` (the dk-split engine: q, k and the state hold the rank's slice
    of dk) each chunk's q.k scores and q.S terms are partial and
    ``psum(scores, qS)`` sums them over ``model``."""
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
        q_state = torch.einsum("bihd,bhdv->bihv", qq.float(), state)
        if psum is not None:
            scores, q_state = psum(scores, q_state)
        decay = cum[:, :, None, :] - cum[:, None, :, :]          # (b, i, j, h)
        decay = decay.masked_fill(~below[None, :, :, None], float("-inf"))
        m = scores * torch.exp(decay).permute(0, 3, 1, 2) * g.permute(0, 2, 1)[:, :, None, :]
        y_intra = _mm("bhij,bjhv->bihv", m, vv, mm)
        # inter-chunk: exp(cum_i) q_i . S_prev
        y_inter = q_state * torch.exp(cum)[..., None]
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
    prefill (the chunk scan seeded from the cached state).  ``ctx``: the
    module docstring (the rank's rows and cache blocks)."""
    s, d_in, nh = _dims(cfg)
    if ctx is not None:
        conv_ch = d_in + 2 * s.d_state
        if tensor_parallel(ctx):
            return _mamba2_tp(p, x, cfg, cache, ctx)
        dims = {} if cache is None else {"conv": split_dim(cache["conv"], conv_ch, 2),
                                         "ssm": split_dim(cache["ssm"], nh, 1)}
        shapes = {"in_proj": (cfg.d_model, 2 * d_in + 2 * s.d_state + nh),
                  "conv_w": (s.conv_width, conv_ch), "out_proj": (d_in, cfg.d_model)}
        return replicated_block(mamba2_block, "mamba", p, x, cfg, cache, ctx, shapes, dims)
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


def _mamba2_tp(p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Optional[dict], ctx
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """``mamba2_block`` tensor-parallel over ``model``: the projection
    gathered, the conv on the rank's channels (where ``model`` splits
    them, as it splits the conv weights and the conv cache), the engine on
    the rank's heads (or dk slice), the norm on the gathered output and the
    row-parallel ``out_proj``."""
    s, d_in, nh = _dims(cfg)
    d = cfg.d_model
    b, seq, _ = x.shape
    M, mesh = ctx.model_axis, ctx.mesh
    conv_ch = d_in + 2 * s.d_state
    xm = copy_d(x, M, mesh)
    zxbcdt = L.col_product(xm, p["in_proj"], ("mamba", "in_proj"),
                           (d, 2 * d_in + 2 * s.d_state + nh), cfg, ctx)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_in, conv_ch, nh], dim=-1)
    rp = L.replicated_params({n: p[n] for n in ("A_log", "D", "dt_bias", "norm")}, ctx)

    new_cache = {}
    conv_cache = cache["conv"] if cache is not None else None
    conv_w = L._weight(p["conv_w"], ("mamba", "conv_w"), (s.conv_width, conv_ch), cfg, ctx)
    if conv_w.shape[1] != conv_ch:            # the rank's channels
        y, conv_new = _causal_conv(model_slice(xbc, 2, ctx), conv_w, conv_cache)
        xbc = all_gather_dim(F.silu(y.float()).to(y.dtype), M, -1, mesh)
    else:
        y, conv_new = _causal_conv(xbc, copy_d(conv_w, M, mesh), conv_cache)
        xbc = F.silu(y.float()).to(y.dtype)
    if cache is not None:
        new_cache["conv"] = conv_new

    xh = xbc[..., :d_in].reshape(b, seq, nh, s.head_dim)
    bmat = xbc[..., d_in:d_in + s.d_state]
    cmat = xbc[..., d_in + s.d_state:]
    dt = F.softplus(dt_raw.float() + rp["dt_bias"])
    log_a = -torch.exp(rp["A_log"]) * dt
    q = cmat[:, :, None, :].expand(b, seq, nh, s.d_state)
    k = bmat[:, :, None, :].expand(b, seq, nh, s.d_state)
    cache_dim = split_dim(cache["ssm"] if cache is not None else None, nh, 1)

    if cache is not None and seq == 1:
        # the decode step in the cache's layout
        hs = (lambda t: model_slice(t, 1, ctx)) if cache_dim else (lambda t: t)
        y, new_cache["ssm"] = linear_attention_step(cache["ssm"], hs(q[:, 0]), hs(k[:, 0]),
                                                    hs(xh[:, 0]), hs(log_a[:, 0]),
                                                    hs(dt[:, 0]))
        y = relayout(y, cache_dim, None, ctx)[:, None]
    else:
        y, state = sharded_engine(q, k, xh, log_a, dt, s.d_state, ctx, chunk=s.chunk,
                           state0=cache["ssm"] if cache is not None else None,
                           state_dim=cache_dim, mm_bf16=s.mm_bf16)
        if cache is not None:
            new_cache["ssm"] = state

    y = y + rp["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, seq, d_in).to(L._dtype(cfg))
    y = y * F.silu(z.float()).to(y.dtype)
    y = L.apply_norm(rp["norm"], y, cfg)
    out = L.row_product(y, p["out_proj"], ("mamba", "out_proj"), (d_in, d), cfg, ctx)
    return out, (new_cache if cache is not None else None)


def sharded_engine(q, k, v, log_a, gate, dk: int, ctx, *, chunk: int, state0, state_dim,
            mm_bf16: bool):
    """The chunk scan of whole (replicated) q, k (B, S, H, dk), v, log_a
    and gate, in ``engine_specs``'s layout: the rank's heads, or its dk
    slice of q and k with the partial terms summed over ``model``.
    ``state0`` and the returned state are split over ``model`` on
    ``state_dim`` (the cache's layout; None: whole); y is whole.  Without
    ``state0`` (no cache) no state is returned."""
    keep = state0 is not None
    h_ax, dk_ax = engine_specs(q.shape[2], dk, ctx)
    dim = 1 if h_ax else (2 if dk_ax else None)        # the state's split in the engine
    state0 = relayout(state0, state_dim, dim, ctx)
    if h_ax:
        q, k, v, log_a, gate = (model_slice(t, 2, ctx) for t in (q, k, v, log_a, gate))
    elif dk_ax:
        q, k = model_slice(q, 3, ctx), model_slice(k, 3, ctx)
    y, state = chunked_linear_attention(q, k, v, log_a, gate, chunk=chunk, state0=state0,
                                        mm_bf16=mm_bf16,
                                        psum=partial_sum(ctx) if dk_ax else None)
    if h_ax:
        y = all_gather_dim(y, ctx.model_axis, 2, ctx.mesh)
    return y, relayout(state, dim, state_dim, ctx) if keep else None


def mamba2_init_cache(batch: int, cfg: ModelConfig, device, dtype: torch.dtype) -> dict:
    """The block's decode state: the conv's last W-1 inputs in ``dtype``
    and the SSM state in f32, zeros."""
    s, d_in, nh = _dims(cfg)
    return {"conv": torch.zeros((batch, s.conv_width - 1, d_in + 2 * s.d_state), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, nh, s.d_state, s.head_dim), dtype=torch.float32,
                               device=device)}
