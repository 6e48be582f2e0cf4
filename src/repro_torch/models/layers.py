"""Shared transformer layers: norms, RoPE, GQA attention, MLPs, embedding.

Pure functions over dict params, mirroring the JAX package's
``models/layers.py`` function by function:

  * weight matrices keep the JAX layout ``(d_in, d_out)`` (``x @ w``);
  * parameters are stored in ``cfg.param_dtype`` (f32 master weights, as in
    JAX) and cast to ``cfg.dtype`` inside every ``dense``; activations run
    in ``cfg.dtype``, norm statistics, softmax and logits in f32.  An init
    may ask for its matrices in another dtype (the serving entry points ask
    for bf16): matrices are drawn in f32 and rounded once, so a bf16 matrix
    holds exactly what ``dense`` would cast the f32 one to.
  * caches are written in place, where JAX donates and rewrites them: the
    paged cache is a (K, V) pair of page arenas ``(n_blocks, block, Hkv,
    hd)``; the end-aligned cache a (K, V) pair of per-slot rows ``(B, L, Hkv,
    hd)`` (an SWA ring when L is the window).
  * full-sequence attention with Lq == Lk at offset 0 -- the no-cache
    ``forward``, a fused prefill from position 0, an SWA prefill longer than
    the ring -- runs through the flash-attention kernel
    (``kernels/flash_attention.py``); decode, per-row offsets and the paged
    chunked prefill stay on ``_sdpa``, as in JAX.  The kernel has no
    backward pass, so attention that autograd records (a train step) runs
    ``_sdpa``, as JAX's train step does.

Under a mesh ctx (``models.moe.MeshCtx``) every function runs inside one
rank on its local blocks (``parallel/sharding.py`` gives each weight's
spec), and where JAX's GSPMD inserts a collective to meet a
``with_sharding_constraint`` (``_cstr``), the port issues the
redistribution between the two placements itself, from the Table-1
collectives of ``core/dseq.py`` (differentiable; the source layout is known
by construction):

  * a weight sharded over the fsdp axes is all-gathered before its product
    (its gradient is reduce-scattered), as GSPMD does for ``P(fsdp, 'model')``;
  * attention (Ulysses, heads never sharded): the column-parallel q goes to
    sequence-sharded full heads by ``allToAllD``, k and v to replicated by
    ``allGatherD``, each rank attends with its S/p query rows
    (``_sdpa_manual``: the causal offset is the shard's row base), the
    output goes back to feature-sharded by ``allToAllD`` for the
    row-parallel ``wo``, whose partial products ``reduceD("sum")``;
  * the MLP is the FooPar chain of ``core/tensor_ops.py`` (``_mlp_foopar``):
    GSPMD's partition of this layout is that same column/row pattern;
  * ``embed`` looks up its vocabulary shard, masks the rows outside it and
    ``reduceD("sum")``s; tied ``logits`` stay vocabulary-sharded for the
    vocab-parallel cross-entropy (``parallel/steps.py``).

A replicated activation entering a column-parallel product passes through
``copy_d`` (its gradient is summed over ``model``), so every
model-replicated tensor's gradient is the same on each rank of the group.
Under ``dp_over_model`` nothing is model-sharded and attention is local.

With a sequence-sharded residual (``seq_sharded``: JAX's ``seq_parallel``,
the residual ``P(batch, 'model', None)`` between the layers) each rank
holds its S/p rows, and the Megatron sequence-parallel redistributions
take the place of ``copy_d`` and ``reduceD``: attention and the MLP
all-gather S before their column-parallel products (``allGatherD``, whose
transpose reduce-scatters the gradient) and reduce-scatter the
row-parallel partial products onto the rows (``reduceScatterD``, whose
transpose all-gathers); ``embed`` reduce-scatters its vocabulary-shard sum
onto the rows, ``logits`` gathers the rows of the final norm so that the
logits keep every position, and a norm's scale enters through ``copy_d``
(``residual_norm``).  The numbers are those of the replicated residual.

With a cache under a ctx (the serve engine on a mesh), the layout of
``launch/specs.py::cache_specs``: an end-aligned cache ``(B, L, Hkv, hd)``
is split over ``model`` on its length, rank r holding the slots
``[r L/p, (r+1) L/p)``, or, where ``model`` does not divide L, held whole
on every rank (each rank writes every token and scores every slot with no
combine, as one process does; ``launch.specs.kv_slots``):

  * a fused prefill from position 0 runs the sequence-sharded region; the
    prompt's K/V (all S tokens, gathered) go into the rank's slots (an SWA
    prompt longer than the ring keeps its last L tokens at their ring
    slots), and outside autograd the rank's S/p query rows go through the
    flash kernel against the keys ``[0, (r+1) S/p)`` (causal: the rows are
    end-aligned to them);
  * a decode step (and any other call) runs with q replicated through
    the one-process code (``_rows_attention``): the q, k and v columns are
    gathered in one ``allGatherD``, a row's token is written only on the
    rank that owns its slot, each rank scores its slots, and the softmax
    combines over ``model`` (``_sdpa_split``: an all-reduce of the row
    max, the rescale, an all-reduce of the sum and the unnormalised
    output, in f32); a shard with no valid slot weighs 0.  A fused prefill
    from 0 whose S does not split over ``model`` (or that is longer than
    the ring) goes through the flash kernel on every rank, as one process
    does, over the whole gathered k/v where the cache is split;
  * the paged arenas and block tables are replicated over ``model``: each
    rank writes and reads its batch rows, through the paged-attention
    kernel in decode;
  * cross-attention (enc-dec) runs the sequence-sharded region when S
    splits; the decoder's one-token step keeps q replicated against the
    encoder K/V, gathered in full (they are recomputed from the replicated
    encoder output at each call, as in the reference, and one query row
    against 1500 keys is too small a product to split).
The output leaves through the row-parallel ``wo``, whose partial products
``reduceD("sum")``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, torch_dtype
from repro_torch.core.dseq import (all_gather_dim, all_gather_whole, all_to_all_dim, copy_d,
                                   reduce_scatter_dim, reduce_sum, split_dim)
from repro_torch.core.tensor_ops import foopar_matmul_col, foopar_matmul_row
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import kernel_takes, paged_attention
from repro_torch.parallel.sharding import leaf_spec
from repro_torch.runtime import trace
from repro_torch.tree import tree_map

Params = dict
NEG_INF = -1e30


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def _device(gen: Optional[torch.Generator]) -> torch.device:
    """The generator's device; no generator is a shape-only (``meta``) init."""
    return gen.device if gen is not None else torch.device("meta")


def _normal(gen: Optional[torch.Generator], shape, std: float,
            dtype: torch.dtype) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
            * std).to(dtype)


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int, cfg: ModelConfig,
               scale: float | None = None, dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    """A ``(d_in, d_out)`` matrix, normal with std ``scale`` (1/sqrt(d_in)),
    in ``dtype`` (default ``cfg.param_dtype``, as in JAX)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _normal(gen, (d_in, d_out), scale, dtype or _pdtype(cfg))


def dense(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = _dtype(cfg)
    return torch.matmul(x.to(dt), w.to(dt))


class _MatmulF32(torch.autograd.Function):
    """bf16 x bf16 -> f32 on the card (``torch.mm(out_dtype=)``), with a
    backward in the same form: the f32 cotangent is rounded to the
    operands' dtype and each gradient accumulates in f32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (torch.mm(g, b.t(), out_dtype=torch.float32).to(a.dtype),
                torch.mm(a.t(), g, out_dtype=torch.float32).to(b.dtype))


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of two same-dtype operands with f32 accumulation (JAX's
    ``preferred_element_type=f32``).  bf16 on the card goes through
    ``torch.mm(out_dtype=)`` so the large operand is never widened; on the
    CPU the operands are widened, which is exact."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type == "cuda":
        return _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b).reshape(
            *a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_init(d: int, cfg: ModelConfig, device) -> Params:
    p = {"scale": torch.ones((d,), dtype=_pdtype(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=_pdtype(cfg), device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + cfg.norm_eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    out = xf * p["scale"].float()
    if "bias" in p:
        out = out + p["bias"].float()
    return out.to(_dtype(cfg))


# ---------------------------------------------------------------------------
# RoPE (standard + fractional "2d" chatglm variant)
# ---------------------------------------------------------------------------
def yarn_inv_freq(theta: float, rot: int, yarn) -> list:
    """YaRN's frequencies of a rotary part of ``rot`` dims at base
    ``theta`` (HF's ``_compute_yarn_parameters``), in float64: dim pair i
    keeps ``theta^(-2i/rot)`` below the ramp, takes it over ``factor``
    above it, and blends the two linearly over [lo, hi], where lo and hi
    are the pairs that turn ``beta_fast`` and ``beta_slow`` times over the
    original context (floored and ceiled, clipped to the dims)."""
    def turns(n):
        return rot * math.log(yarn.original_max_position_embeddings / (n * 2 * math.pi)) / (
            2 * math.log(theta))
    lo = max(math.floor(turns(yarn.beta_fast)), 0)
    hi = min(math.ceil(turns(yarn.beta_slow)), rot - 1)
    out = []
    for i in range(rot // 2):
        base = theta ** (-2 * i / rot)
        keep = 1.0 - min(max((i - lo) / (hi - lo), 0.0), 1.0)
        out.append(base / yarn.factor * (1.0 - keep) + base * keep)
    return out


@functools.lru_cache(maxsize=16)
def _yarn_table(theta: float, rot: int, yarn, device: torch.device) -> torch.Tensor:
    """``yarn_inv_freq`` as an f32 tensor on ``device``, made once."""
    return torch.tensor(yarn_inv_freq(theta, rot, yarn), dtype=torch.float32, device=device)


def rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) or (B, S) absolute positions.
    With ``cfg.yarn`` the frequencies are YaRN's and cos and sin are scaled
    by its attention factor (so q.k by its square)."""
    hd = x.shape[-1]
    rot = int(hd * cfg.rope_fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    if cfg.yarn is None:
        exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
        freqs = cfg.rope_theta ** exps                          # f32, as in JAX
    else:
        freqs = _yarn_table(cfg.rope_theta, rot, cfg.yarn, x.device)
    ang = positions.float()[..., None] * freqs                  # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    if cfg.yarn is not None:
        cos, sin = cos * cfg.yarn.attention_factor, sin * cfg.yarn.attention_factor
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    x_rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([x_rot.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def attention_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                   dtype: Optional[torch.dtype] = None) -> Params:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, d, hq * hd, cfg, dtype=dtype),
        "wk": dense_init(gen, d, hkv * hd, cfg, dtype=dtype),
        "wv": dense_init(gen, d, hkv * hd, cfg, dtype=dtype),
        "wo": dense_init(gen, hq * hd, d, cfg, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((hd,), dtype=_pdtype(cfg), device=_device(gen))}
        p["k_norm"] = {"scale": torch.ones((hd,), dtype=_pdtype(cfg), device=_device(gen))}
    return p


def _qk_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def _scores(q, k, *, causal: bool, window: Optional[int], q_offset, k_offset: int = 0,
            kv_len_valid=None):
    """The f32 scores (B, Hkv, rep, Lq, Lk) of q (B, Lq, Hkv, rep, hd) against
    k (B, Lk, Hkv, hd), and the (B or 1, Lq, Lk) mask of the keys each query
    reads: causal and window by position, q[0] at ``q_offset`` (an int, a
    0-d tensor, or (B,) for per-row positions) and k[0] at ``k_offset``,
    and the first ``kv_len_valid`` key positions (scalar or (B,))."""
    lq, hd = q.shape[1], q.shape[-1]
    lk = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", (q * scale).float(), k.float())
    per_row = torch.is_tensor(q_offset) and q_offset.dim() == 1
    # (Lq,) for a scalar offset, (B, Lq) for per-row offsets; a Python int
    # stays on the host (no copy, no sync)
    qpos = torch.arange(lq, device=dev) + (q_offset[:, None] if per_row else q_offset)
    kpos = torch.arange(k_offset, k_offset + lk, device=dev)
    mask = torch.ones(qpos.shape + (lk,), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos[..., None]
    if window is not None:
        mask &= qpos[..., None] - kpos < window
    if kv_len_valid is not None:
        if torch.is_tensor(kv_len_valid) and kv_len_valid.dim() == 1:
            kv_len_valid = kv_len_valid[:, None, None]
        mask = mask & (kpos < kv_len_valid)
    return s, (mask[None] if mask.dim() == 2 else mask)


def _sdpa(q, k, v, *, causal: bool, window: Optional[int], q_offset,
          kv_len_valid=None) -> torch.Tensor:
    """Grouped SDPA.  q: (B, Lq, Hkv, rep, hd); k, v: (B, Lk, Hkv, hd).
    ``q_offset``: absolute position of q[0] minus the first key position --
    an int, a 0-d tensor, or (B,) for per-row positions.  ``kv_len_valid``:
    number of valid key slots, scalar or (B,).  Scores and softmax in f32;
    the probabilities are cast to q's dtype for P.V (the JAX discipline,
    which ``scaled_dot_product_attention`` does not share)."""
    s, mask = _scores(q, k, causal=causal, window=window, q_offset=q_offset,
                      kv_len_valid=kv_len_valid)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(q.dtype))


def _write_pages(arena: torch.Tensor, entry: torch.Tensor, off: torch.Tensor,
                 rows: torch.Tensor) -> None:
    """``arena[entry[i], off[i]] = rows[i]`` for every i with ``entry[i] >= 0``;
    the rest are dropped (JAX's ``mode="drop"`` scatter through the
    out-of-range block).  PyTorch raises or faults on an out-of-range index,
    so dead rows are removed first, never clamped: a clamped write would
    land on a live page."""
    with trace.span("sync", site="paged_write"):     # nonzero reads the count back
        live = torch.nonzero(entry >= 0).squeeze(1)
    arena[entry[live].long(), off[live].long()] = rows[live].to(arena.dtype)


def _write_rows(rows: torch.Tensor, pos: torch.Tensor, new: torch.Tensor) -> None:
    """``rows[i, pos[i]] = new[i]`` for every i with ``0 <= pos[i] < L``; the
    rest are dropped (JAX's ``mode="drop"`` scatter).  PyTorch faults on an
    out-of-range index, and a clamped one would overwrite a live slot, so a
    dead row is sent to its own slot 0 and writes back the value it read
    there (no host sync, unlike removing the dead rows first)."""
    live = (pos >= 0) & (pos < rows.shape[1])
    idx = torch.where(live, pos, 0).long()
    bidx = torch.arange(pos.shape[0], device=pos.device)
    rows[bidx, idx] = torch.where(live[:, None, None], new.to(rows.dtype), rows[bidx, idx])


def _flash(q, k, v, *, causal: bool, window: Optional[int]) -> torch.Tensor:
    """Attention through the flash-attention kernel, queries end-aligned to
    the keys (Lq <= Lk), in the model's layout: q (B, Lq, Hkv, rep, hd) and
    k, v (B, Lk, Hkv, hd) go in as strided (B, H, L, hd) views, no copies;
    returns (B, Lq, Hkv, rep, hd)."""
    b, lq, hkv, rep, hd = q.shape
    out = flash_attention(q.reshape(b, lq, hkv * rep, hd).transpose(1, 2),
                          k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                          window=window)
    return out.transpose(1, 2).reshape(b, lq, hkv, rep, hd)


def rows_block(lk: int) -> Optional[int]:
    """The page size under which end-aligned rows of ``lk`` slots are read
    as a page arena: the largest power of two in 16..256 dividing ``lk``;
    None when none does."""
    return next((blk for blk in (256, 128, 64, 32, 16) if lk % blk == 0), None)


def rows_decode_takes(q_dtype: torch.dtype, kv_dtype: torch.dtype, rep: int, hd: int,
                      lk: int) -> bool:
    """Whether the decode over end-aligned rows of ``lk`` slots goes through
    the paged-attention kernel (``_rows_decode``): the kernel's dtypes,
    group and head size, and rows that split into pages."""
    return kernel_takes(q_dtype, kv_dtype, rep, hd) and rows_block(lk) is not None


@functools.lru_cache(maxsize=64)
def _rows_table(b: int, pages: int, device: torch.device) -> torch.Tensor:
    """The fixed block table of ``b`` rows viewed as an arena of ``b *
    pages`` pages: row i owns pages ``i * pages + arange(pages)``.  Made
    once a shape and device, never inside a step."""
    return torch.arange(b * pages, dtype=torch.int32, device=device).view(b, pages)


def _rows_decode(q, ck, cv, lengths) -> torch.Tensor:
    """One query token a row over the end-aligned rows, through the
    paged-attention kernel: the rows (B, L, Hkv, hd) are read as an arena of
    B * L / blk pages (a view, no copy) under the fixed table, each row's
    slots [0, ``lengths``) once, in the cache's dtype.  q (B, 1, Hkv, rep,
    hd), lengths (B,) int32; returns (B, 1, Hkv, rep, hd)."""
    b, lk, hkv, hd = ck.shape
    blk = rows_block(lk)
    arena = (b * lk // blk, blk, hkv, hd)
    return paged_attention(q[:, 0].contiguous(), ck.view(arena), cv.view(arena),
                           _rows_table(b, lk // blk, ck.device), lengths)[:, None]


def _rows_attention(q, k, v, cache, cache_pos, positions, length, lo: int, lk: int,
                    cfg: ModelConfig, ctx) -> torch.Tensor:
    """``attention`` over end-aligned rows: ``cache`` is the (K, V) block
    ``(B, L, Hkv, hd)`` holding the slots ``[lo, lo + L)`` of rows of ``lk``
    slots (one process: all of them; a rank: ``launch.specs.kv_slots``).
    Writes first, in place: a token a row at its (B,) ``cache_pos`` (a
    scalar position is JAX's ``dynamic_update_slice`` clamp, then per row),
    only into the block that holds its slot (a position past the row
    drops); a prompt at scalar ``cache_pos`` through ``_write_prefill``
    (``length``: its true (B,) lengths).  Then q attends end-aligned to the
    rows; a block of part of the rows (``lk > L``) combines its share over
    ``model`` (``_sdpa_split``)."""
    ck, cv = cache
    b, s, _, rep, hd = q.shape
    split = lk > ck.shape[1]
    per_row = torch.is_tensor(cache_pos) and cache_pos.dim() == 1
    # a decode of one token a row reads slots [0, cache_pos + 1) (the
    # causal mask; a parked row all of them), or on a ring its first
    # pos + 1 slots until the first wrap: on one process, at (B,)
    # positions, through the kernel where it takes the shapes (each row's
    # K/V read once, up to its length), else ``_sdpa`` (every whole row,
    # widened to f32)
    rows = (per_row and s == 1 and ctx is None and not q.requires_grad and ck.is_contiguous()
            and cv.is_contiguous() and rows_decode_takes(q.dtype, ck.dtype, rep, hd, lk))
    if s == 1 and not per_row:
        # read on the host, but a ``meta`` position (the dry run's) has no
        # value and is clamped as a tensor
        if torch.is_tensor(cache_pos) and cache_pos.device.type == "meta":
            cache_pos = torch.clamp(cache_pos, 0, lk - 1).expand(b)
        else:
            cache_pos = torch.as_tensor(min(max(int(cache_pos), 0), lk - 1),
                                        device=k.device).expand(b)
        per_row = True
    if per_row:
        at = cache_pos - lo if lo else cache_pos
        _write_rows(ck, at, k[:, 0])
        _write_rows(cv, at, v[:, 0])
    else:
        _write_prefill(ck, cv, k, v, cache_pos, lo, lk, n_real=length)
    if s > lk:
        # prefill longer than the ring: attend the full in-flight k/v (the
        # cache holds only the trailing window)
        return _flash(q, k, v, causal=True, window=cfg.window)
    if cfg.window is not None and lk == cfg.window and s == 1:
        # ring decode: before the first wrap only pos+1 slots hold real
        # tokens (the untouched slots would soak up softmax mass)
        valid = torch.clamp(positions[..., -1] + 1, max=lk)
        if rows:
            return _rows_decode(q, ck, cv, valid.to(torch.int32))
        mask = dict(causal=False, window=None, q_offset=0, kv_len_valid=valid)
    elif isinstance(cache_pos, int) and cache_pos == 0:
        # fused prefill from position 0: Lq == Lk == s, in the cache's dtype
        # as JAX reads them (keys past s are causally invisible): the rows
        # just written, or on a block of part of them the whole gathered k/v
        if split:
            return _flash(q, k.to(ck.dtype), v.to(cv.dtype), causal=True, window=cfg.window)
        return _flash(q, ck[:, :s], cv[:, :s], causal=True, window=cfg.window)
    elif rows:
        # rows shorter than a window (``init_cache`` caps a ring at it):
        # the window masks nothing
        return _rows_decode(q, ck, cv, torch.clamp(cache_pos + 1, max=lk).to(torch.int32))
    else:
        # end-aligned: query position == cache_pos
        mask = dict(causal=True, window=cfg.window, q_offset=cache_pos)
    if split:
        return _sdpa_split(q, ck, cv, ctx, k_offset=lo, **mask)
    return _sdpa(q, ck, cv, **mask)


def attention(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos=None,
              block_tables: Optional[torch.Tensor] = None,
              ctx=None,
              xattn_kv: Optional[torch.Tensor] = None,
              length=None,
              ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Self- (or cross-) attention.

    No cache: full (causal) attention over x, through the flash kernel, or
    through ``_sdpa`` when autograd records it.
    End-aligned cache (``cache`` without ``block_tables``): per-slot rows
    ``(B, L, Hkv, hd)``, on one process and on a rank alike
    (``_rows_attention``).  Decode writes each row's token at its own (B,)
    ``cache_pos``, or at one scalar position for every row (a position
    past the row drops); a fused prefill writes at scalar ``cache_pos`` (an
    SWA prompt longer than the ring keeps its last L tokens at their ring
    slots: the last L of its true ``length``, (B,), where one is given);
    then q attends end-aligned to the cache.
    Paged decode/prefill (``cache`` and ``block_tables`` given): ``cache`` is
    the (K, V) pair of page arenas ``(n_blocks, block, Hkv, hd)``; each
    request writes and reads through its block-table row.  Decode is a (B,)
    tensor ``cache_pos`` (one token per row, read by the paged-attention
    kernel); chunked prefill is a scalar ``cache_pos`` (one request, B=1,
    attending causally over the gathered page view).
    Cross-attention (the enc-dec decoder): ``xattn_kv`` (B, T, d) is the
    encoder output; keys and values come from it, without RoPE, cache or
    mask, through ``_sdpa`` (the reference's arithmetic).
    With ``ctx``: the rank's batch rows and cache blocks (the module
    docstring; ``_attention_ctx``).
    """
    if ctx is not None:
        if _tp_axis(ctx) is not None:
            return _attention_ctx(p, x, positions, cfg, causal=causal, ctx=ctx, cache=cache,
                                  cache_pos=cache_pos, block_tables=block_tables,
                                  xattn_kv=xattn_kv, length=length)
        # pure DP: the attention of one device on the gathered weights
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
                  "wo": (hq * hd, d)}
        p = dict(p, **{n: _weight(p[n], ("attn", n), shape, cfg, ctx, dtype=_dtype(cfg))
                       for n, shape in shapes.items()})
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rep = hq // hkv

    kv_src = xattn_kv if xattn_kv is not None else x
    q = dense(x, p["wq"], cfg).reshape(b, s, hkv, rep, hd)
    k = dense(kv_src, p["wk"], cfg).reshape(b, -1, hkv, hd)
    v = dense(kv_src, p["wv"], cfg).reshape(b, -1, hkv, hd)
    q, k = _qk_rope(p, q, k, positions, cfg, rope_on=xattn_kv is None)

    new_cache = None
    if xattn_kv is not None:
        out = _sdpa(q, k, v, causal=False, window=cfg.window, q_offset=0)
    elif cache is not None and block_tables is None:
        out = _rows_attention(q, k, v, cache, cache_pos, positions, length, 0,
                              cache[0].shape[1], cfg, ctx)
        new_cache = cache
    elif cache is not None:
        out, new_cache = _paged(q, k, v, cache, cache_pos, block_tables, cfg)
    elif q.requires_grad:
        # a train step: the flash kernel has no backward pass
        out = _sdpa(q, k, v, causal=causal, window=cfg.window, q_offset=0)
    else:
        out = _flash(q, k, v, causal=causal, window=cfg.window)

    out = out.reshape(b, s, hq * hd)
    return dense(out, p["wo"], cfg), new_cache


def _qk_rope(p: Params, q, k, positions, cfg: ModelConfig, *, rope_on: bool,
             k_positions=None):
    """qk-norm, then RoPE at ``positions`` (q) and ``k_positions`` (k,
    default ``positions``) unless ``rope_on`` is False (cross-attention)."""
    b, s, hkv, rep, hd = q.shape
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = _qk_norm(k, p["k_norm"]["scale"], cfg.norm_eps)
    if rope_on:
        q = rope(q.reshape(b, s, hkv * rep, hd), positions, cfg).reshape(b, s, hkv, rep, hd)
        k = rope(k, positions if k_positions is None else k_positions, cfg)
    return q, k


def _write_prefill(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cache_pos, lo: int, lk: int, n_real=None) -> None:
    """A fused prefill's K/V (B, S, ..) into the cache slots ``[lo, lo +
    ck.shape[1])`` of a row of ``lk`` slots: at ``cache_pos`` on, with
    JAX's ``dynamic_update_slice`` clamp of the start so the update fits
    the row; a prompt longer than the row (an SWA ring) keeps its last
    ``lk`` tokens at their ring slots (token j -> slot j % lk), of each
    row's first ``n_real`` (B,) tokens (default: all S; a right-padded
    bucket passes its true lengths, and slots past a shorter prompt get its
    token 0, behind the decode's length).  Slots outside the block are
    another rank's."""
    s, nl = k.shape[1], ck.shape[1]
    if s > lk:
        g = torch.arange(lo, lo + nl, device=k.device)
        n = s if n_real is None else n_real
        first = torch.as_tensor(n, device=k.device).long().expand(k.shape[0])[:, None] - lk
        tok = (first + (g - first) % lk).clamp(min=0)   # (B, nl): the token at ring slot g
        rows = torch.arange(k.shape[0], device=k.device)[:, None]
        ck[:] = k[rows, tok].to(ck.dtype)
        cv[:] = v[rows, tok].to(cv.dtype)
        return
    start = min(max(int(cache_pos), 0), lk - s)
    a, e = max(lo, start), min(lo + nl, start + s)
    if a < e:
        ck[:, a - lo:e - lo] = k[:, a - start:e - start].to(ck.dtype)
        cv[:, a - lo:e - lo] = v[:, a - start:e - start].to(cv.dtype)


def _paged(q, k, v, cache, cache_pos, block_tables, cfg: ModelConfig):
    """Paged decode (per-row ``cache_pos``: the paged-attention kernel) or
    chunked prefill (scalar ``cache_pos``, B=1: ``_sdpa`` over the page
    view) of ``attention``; writes the arenas in place."""
    if cfg.window is not None:
        raise NotImplementedError("paged attention needs full (no-SWA) attention")
    b, s, hkv, rep, hd = q.shape
    ck, cv = cache
    n_pages = block_tables.shape[1]
    blk = ck.shape[1]
    if torch.is_tensor(cache_pos) and cache_pos.dim() == 1:
        # decode: row i writes its token at page pos//block, offset
        # pos%block of its own chain; a position past the table width or
        # a -1 entry (parked / prefilling slot) drops the write
        pg, off = cache_pos // blk, cache_pos % blk
        inside = pg < n_pages
        entry = torch.gather(block_tables, 1,
                             pg.clamp(max=n_pages - 1)[:, None].long())[:, 0]
        entry = torch.where(inside, entry, -1)
        _write_pages(ck, entry, off, k[:, 0])
        _write_pages(cv, entry, off, v[:, 0])
        out = paged_attention(q[:, 0].contiguous(), ck, cv,
                              block_tables.to(torch.int32).contiguous(),
                              (cache_pos + 1).to(torch.int32))[:, None]
        return out, (ck, cv)
    # chunked prefill (B=1): the chunk's tokens land at positions
    # cache_pos..cache_pos+s-1 through the table, then attend causally
    # over the gathered page view.  Right-pad tokens whose page lies past
    # the table width must drop (a clamped index would scatter pad K/V over
    # the last live page); pad writes inside the table are re-written by
    # real tokens before any query reads them, and pad queries' outputs are
    # never used.
    if b != 1:
        raise ValueError(f"chunked prefill runs one request per call, got B={b}")
    tpos = cache_pos + torch.arange(s, device=q.device)
    pg, off = tpos // blk, tpos % blk
    entry = torch.where(pg < n_pages, block_tables[0, pg.clamp(max=n_pages - 1)], -1)
    _write_pages(ck, entry, off, k[0])
    _write_pages(cv, entry, off, v[0])
    idx = block_tables.long().clamp(min=0)
    out = _sdpa(q, ck[idx].reshape(b, -1, hkv, hd), cv[idx].reshape(b, -1, hkv, hd),
                causal=True, window=None, q_offset=cache_pos)
    return out, (ck, cv)


# ---------------------------------------------------------------------------
# Under a mesh ctx
# ---------------------------------------------------------------------------
def _tp_axis(ctx) -> Optional[str]:
    """The model axis the layers shard over, or None (pure DP)."""
    return None if ctx.dp_over_model else ctx.model_axis


def seq_sharded(ctx) -> bool:
    """True when the residual between the layers is this rank's sequence
    rows (B/dp, S/tp, d): ``ctx.seq_parallel`` under tensor parallelism
    (``transformer.forward`` sets it only where S splits)."""
    return ctx is not None and ctx.seq_parallel and _tp_axis(ctx) is not None


def replicated_seq(ctx):
    """``ctx`` for a call whose activations hold the whole sequence (a
    serving call, the enc-dec model, a block kind with no sequence-sharded
    form): ``seq_parallel`` off."""
    if ctx is None or not ctx.seq_parallel:
        return ctx
    return dataclasses.replace(ctx, seq_parallel=False)


def residual_norm(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx=None) -> torch.Tensor:
    """``apply_norm`` on the residual.  Sequence-sharded, each rank
    normalises its own rows, so the scale (and bias) enter through
    ``copy_d``: their gradient is summed over ``model``."""
    if seq_sharded(ctx):
        p = replicated_params(p, ctx)
    return apply_norm(p, x, cfg)


def gather_seq(x: torch.Tensor, ctx) -> torch.Tensor:
    """The rank's sequence rows -> the whole sequence, for a block kind
    with no sequence-sharded form (run replicated, as without
    ``seq_parallel``); the identity when the residual is not sharded."""
    return all_gather_whole(x, ctx.model_axis, 1, ctx.mesh) if seq_sharded(ctx) else x


def scatter_seq(x: torch.Tensor, ctx) -> torch.Tensor:
    """The whole sequence (replicated) -> this rank's rows, a slice whose
    transpose gathers the cotangent; the identity when the residual is not
    sharded."""
    return split_dim(x, ctx.model_axis, 1, ctx.mesh) if seq_sharded(ctx) else x


def _weight(w: torch.Tensor, names: Tuple[str, ...], shape: Tuple[int, ...], cfg: ModelConfig,
            ctx, *, model_dim: Optional[int] = None, dtype: Optional[torch.dtype] = None
            ) -> torch.Tensor:
    """The block of weight ``w`` (global ``shape``, path ``names``) this rank
    multiplies with: cast to ``dtype`` (so a bf16 compute gathers bf16), then
    all-gathered over the fsdp axes on every dim its spec shards over them.
    ``model_dim``: the dim the TP layer needs split over ``model``; a rule
    partition that ``sanitize_spec`` dropped there raises."""
    spec = leaf_spec(names, shape, cfg, ctx)
    tp = _tp_axis(ctx)
    if model_dim is not None and tp is not None and spec[model_dim] != tp:
        raise NotImplementedError(
            f"{'/'.join(names)} {shape}: the rule table's {tp!r} partition of dim "
            f"{model_dim} was dropped ({shape[model_dim]} % {ctx.model_size} != 0); the "
            f"tensor-parallel layers need it")
    if dtype is not None:
        w = w.to(dtype)
    for d, part in enumerate(spec):
        axes = () if part is None else (part if isinstance(part, tuple) else (part,))
        fsdp = tuple(a for a in axes if a in ctx.fsdp_axes)
        if fsdp:
            w = all_gather_dim(w, fsdp, d, ctx.mesh)
    return w


def col_product(x: torch.Tensor, w: torch.Tensor, names: Tuple[str, ...],
                shape: Tuple[int, ...], cfg: ModelConfig, ctx) -> torch.Tensor:
    """Inside a tensor-parallel block (its input passed through ``copy_d``):
    ``x`` (replicated over ``model``) times the column-parallel ``w`` ->
    the whole ``(.., d_out)`` product, replicated: the rank's columns are
    gathered (``allGatherD``, whose transpose sums the ranks' shares of the
    cotangent).  A weight the rules leave whole is multiplied whole, its
    gradient summed over ``model`` (``copy_d``)."""
    spec = leaf_spec(names, shape, cfg, ctx)
    wt = _weight(w, names, shape, cfg, ctx, dtype=_dtype(cfg))
    if spec[1] == ctx.model_axis:
        return all_gather_dim(dense(x, wt, cfg), ctx.model_axis, -1, ctx.mesh)
    return dense(x, copy_d(wt, ctx.model_axis, ctx.mesh), cfg)


def row_product(h: torch.Tensor, w: torch.Tensor, names: Tuple[str, ...],
                shape: Tuple[int, ...], cfg: ModelConfig, ctx) -> torch.Tensor:
    """The way out of a tensor-parallel block: the rank's features of ``h``
    (replicated, ``(.., d_in)``) times its rows of the row-parallel ``w``,
    the partial products ``reduceD("sum")``'d into the replicated output."""
    wt = _weight(w, names, shape, cfg, ctx, model_dim=0, dtype=_dtype(cfg))
    n = wt.shape[0]
    h = h.narrow(-1, ctx.mesh.index(ctx.model_axis) * n, n)
    return reduce_sum(dense(h, wt, cfg), ctx.model_axis, ctx.mesh)


def replicated_params(p: Params, ctx) -> Params:
    """Model-replicated parameters (norm scales, biases, the SSM's vectors)
    used inside a tensor-parallel block: ``copy_d``, so each rank's share of
    their gradient is summed over ``model``."""
    return tree_map(lambda t: copy_d(t, ctx.model_axis, ctx.mesh), p)


def _sdpa_manual(q, k, v, ctx, *, causal: bool, window: Optional[int]) -> torch.Tensor:
    """Sequence-sharded attention inside one rank: ``q`` holds this shard's
    S/p query rows (full heads), ``k``/``v`` the full (GQA-small) keys; the
    causal mask offsets by the shard's global row base."""
    off = ctx.mesh.index(ctx.model_axis) * q.shape[1]
    return _sdpa(q, k, v, causal=causal, window=window, q_offset=off)


def _sdpa_split(q, k, v, ctx, *, causal: bool, window: Optional[int], q_offset,
                k_offset: int, kv_len_valid=None) -> torch.Tensor:
    """``_sdpa`` of replicated queries against keys split over ``model``:
    this rank's ``k``/``v`` are the key slots ``[k_offset, k_offset +
    Lk)`` (masks by the global key position).  The rank scores its slots;
    the row max is all-reduced (max), each rank rescales its exponentials
    to it and keeps their sum and its unnormalised output in f32, and those
    are all-reduced (sum); the output is their quotient in q's dtype.  A
    shard (or a row of one) with no valid slot has max -inf, weight 0 and
    output 0, and its V is never read (masked slots are zeroed first, so
    no 0 x NaN)."""
    b, lk, hd = q.shape[0], k.shape[1], q.shape[-1]
    dev, mesh, M = q.device, ctx.mesh, ctx.model_axis
    s, mask = _scores(q, k, causal=causal, window=window, q_offset=q_offset,
                      k_offset=k_offset, kv_len_valid=kv_len_valid)
    live = mask.any(dim=1).expand(b, lk)                    # (B, Lk): slots some query reads
    v = torch.where(live[:, :, None, None], v, torch.zeros((), dtype=v.dtype, device=dev))
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    m = mesh.all_reduce(torch.amax(s, dim=-1, keepdim=True), "max", M)
    e = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    o = torch.einsum("bgrqk,bkgd->bqgrd", e, v.float())
    lsum = torch.sum(e, dim=-1).permute(0, 3, 1, 2)[..., None]     # (b, q, g, r, 1)
    tot = mesh.all_reduce(torch.cat([o, lsum], dim=-1), "sum", M)
    o, lsum = tot[..., :hd], tot[..., hd:]
    return torch.where(lsum > 0, o / torch.where(lsum > 0, lsum, 1.0), 0.0).to(q.dtype)


def _attention_ctx(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, *,
                   causal: bool, ctx, cache=None, cache_pos=None, block_tables=None,
                   xattn_kv: Optional[torch.Tensor] = None, length=None):
    """Attention on this rank's batch rows ``x`` (b, S, d), replicated over
    ``model``; returns the rank's (b, S, d) output, also replicated, and
    the cache.  Under a sequence-sharded residual (``seq_sharded``) ``x``
    holds the rank's S/p rows, which are all-gathered before the
    column-parallel q, k, v, and the output is the rank's rows, the
    row-parallel ``wo``'s partial products reduce-scattered onto them.
    Heads are never sharded (GQA head counts rarely divide TP): with S > 1
    from position 0 the einsum region is sequence-sharded over ``model``;
    otherwise q is replicated and, with an end-aligned cache, so are the
    keys of a cache held whole on every rank, and a split cache's are
    split over ``model`` on its length (``launch.specs.kv_slots``)."""
    from repro_torch.launch.specs import kv_slots
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rep = hq // hkv
    dt, mesh, M = _dtype(cfg), ctx.mesh, ctx.model_axis
    p_ = ctx.model_size
    sp = seq_sharded(ctx)
    # column-parallel input: the gathered rows, or the replicated x
    xm = all_gather_dim(x, M, 1, mesh) if sp else copy_d(x, M, mesh)
    b, s, d = xm.shape

    def out_rows(y):
        """The row-parallel ``wo``'s partial products summed: onto the
        rank's rows, or replicated."""
        return reduce_scatter_dim(y, M, 1, mesh) if sp else reduce_sum(y, M, mesh)

    wq = _weight(p["wq"], ("attn", "wq"), (d, hq * hd), cfg, ctx, model_dim=1, dtype=dt)
    wk = _weight(p["wk"], ("attn", "wk"), (d, hkv * hd), cfg, ctx, model_dim=1, dtype=dt)
    wv = _weight(p["wv"], ("attn", "wv"), (d, hkv * hd), cfg, ctx, model_dim=1, dtype=dt)
    wo = _weight(p["wo"], ("attn", "wo"), (hq * hd, d), cfg, ctx, model_dim=0, dtype=dt)
    if cache is not None and block_tables is None:
        for t in cache:
            if t.shape[0] != b:
                raise ValueError(f"cache block {tuple(t.shape)} for {b} rows")
    src = xm if xattn_kv is None else copy_d(xattn_kv, M, mesh)
    cross = xattn_kv is not None
    r = mesh.index(M)
    seq_region = s > 1 and s % p_ == 0 and block_tables is None and (
        cache is None or (isinstance(cache_pos, int) and cache_pos == 0))
    if seq_region:
        s_loc = s // p_
        row0 = r * s_loc
        # q: feature-sharded -> sequence-sharded full heads; k, v: replicated
        q = all_to_all_dim(dense(xm, wq, cfg), M, 1, 2, mesh).reshape(b, s_loc, hkv, rep, hd)
        k = all_gather_dim(dense(src, wk, cfg), M, 2, mesh).reshape(b, -1, hkv, hd)
        v = all_gather_dim(dense(src, wv, cfg), M, 2, mesh).reshape(b, -1, hkv, hd)
        q, k = _qk_rope(p, q, k, positions[row0:row0 + s_loc], cfg, rope_on=not cross,
                        k_positions=positions)
        new_cache = None
        keys, vals = k, v
        if cache is not None:
            ck, cv = cache
            lo, lk = kv_slots(ck, ctx)
            _write_prefill(ck, cv, k, v, 0, lo, lk)
            new_cache = (ck, cv)
            if s <= lk:                       # the attention reads the cache's dtype
                keys, vals = k.to(ck.dtype), v.to(cv.dtype)
        if cross:
            out = _sdpa(q, keys, vals, causal=False, window=cfg.window, q_offset=row0)
        elif q.requires_grad:
            out = _sdpa_manual(q, keys, vals, ctx, causal=causal, window=cfg.window)
        else:
            # the rank's rows through the flash kernel; causal: against the
            # keys up to its last row, to which the rows are end-aligned
            end = row0 + s_loc if causal else keys.shape[1]
            out = _flash(q, keys[:, :end], vals[:, :end], causal=causal, window=cfg.window)
        # sequence-sharded -> feature-sharded for the row-parallel wo
        out = all_to_all_dim(out.reshape(b, s_loc, hq * hd), M, 2, 1, mesh)
        return out_rows(dense(out, wo, cfg)), new_cache

    # q replicated: the rank's q, k, v columns gathered in one allGatherD
    nq, nk = wq.shape[1], wk.shape[1]
    if cross:
        q = all_gather_dim(dense(xm, wq, cfg), M, 2, mesh)
        k, v = all_gather_dim(torch.cat([dense(src, wk, cfg), dense(src, wv, cfg)], 2), M, 2,
                              mesh).unflatten(2, (p_, 2 * nk)).split(nk, 3)
    else:
        g = all_gather_dim(torch.cat([dense(xm, wq, cfg), dense(xm, wk, cfg),
                                      dense(xm, wv, cfg)], 2), M, 2, mesh)
        q, k, v = g.unflatten(2, (p_, nq + 2 * nk)).split([nq, nk, nk], 3)
    q = q.flatten(2).reshape(b, s, hkv, rep, hd)
    k = k.flatten(2).reshape(b, -1, hkv, hd)
    v = v.flatten(2).reshape(b, -1, hkv, hd)
    q, k = _qk_rope(p, q, k, positions, cfg, rope_on=not cross)
    new_cache = None
    if cross:
        out = _sdpa(q, k, v, causal=False, window=cfg.window, q_offset=0)
    elif block_tables is not None:
        out, new_cache = _paged(q, k, v, cache, cache_pos, block_tables, cfg)
    elif cache is not None:
        out = _rows_attention(q, k, v, cache, cache_pos, positions, length,
                              *kv_slots(cache[0], ctx), cfg, ctx)
        new_cache = cache
    elif q.requires_grad:
        out = _sdpa(q, k, v, causal=causal, window=cfg.window, q_offset=0)
    else:
        out = _flash(q, k, v, causal=causal, window=cfg.window)
    # replicated -> the rank's feature columns for the row-parallel wo
    out = out.reshape(b, s, hq * hd).narrow(2, r * (hq * hd // p_), hq * hd // p_)
    return out_rows(dense(out, wo, cfg)), new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_init(gen: Optional[torch.Generator], cfg: ModelConfig, d_ff: Optional[int] = None,
             dtype: Optional[torch.dtype] = None) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"w_gate": dense_init(gen, d, ff, cfg, dtype=dtype),
                "w_up": dense_init(gen, d, ff, cfg, dtype=dtype),
                "w_down": dense_init(gen, ff, d, cfg, dtype=dtype)}
    return {"w_up": dense_init(gen, d, ff, cfg, dtype=dtype),
            "w_down": dense_init(gen, ff, d, cfg, dtype=dtype)}


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx=None) -> torch.Tensor:
    """The block's MLP; under a ctx with a model axis, the FooPar chain
    (``_mlp_foopar``) whatever ``ctx.foopar_tp`` says: it is GSPMD's
    partition of this layout too."""
    if ctx is not None:
        if _tp_axis(ctx) is not None:
            return _mlp_foopar(p, x, cfg, ctx)
        d, ff = cfg.d_model, p["w_down"].shape[0]
        p = {n: _weight(w, ("mlp", n), (ff, d) if n == "w_down" else (d, ff), cfg, ctx,
                        dtype=_dtype(cfg)) for n, w in p.items()}
    if "w_gate" in p:
        g = dense(x, p["w_gate"], cfg)
        u = dense(x, p["w_up"], cfg)
        h = F.silu(g.float()).to(u.dtype) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(x, p["w_up"], cfg).float(), approximate="tanh").to(_dtype(cfg))
    return dense(h, p["w_down"], cfg)


def _mlp_foopar(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx) -> torch.Tensor:
    """Paper-faithful TP MLP: the FooPar algebra's column-parallel mapD for
    the up/gate projections (one mapD over both weights, so the input's
    gradient is summed over ``model`` once) and zipWithD . reduceD("sum")
    for the down projection (``core/tensor_ops.py``) -- the same math as
    the single-device ``mlp``.  Under a sequence-sharded residual the input
    is the rank's rows, all-gathered into the column product, and the down
    projection's sum is reduce-scattered back onto them."""
    dt, ax = _dtype(cfg), ctx.model_axis
    seq = 1 if seq_sharded(ctx) else None
    d = cfg.d_model
    ff = p["w_down"].shape[0] * ctx.model_size
    w = {n: _weight(t, ("mlp", n), (ff, d) if n == "w_down" else (d, ff), cfg, ctx,
                    model_dim=0 if n == "w_down" else 1, dtype=dt) for n, t in p.items()}
    xx = x.to(dt)
    if "w_gate" in w:
        gu = foopar_matmul_col(xx, torch.cat([w["w_gate"], w["w_up"]], dim=1), axis=ax,
                               preferred_element_type=dt, seq_dim=seq)
        g, u = gu.split(w["w_up"].shape[1], dim=-1)
        h = F.silu(g.float()).to(dt) * u
    else:
        h = F.gelu(foopar_matmul_col(xx, w["w_up"], axis=ax, preferred_element_type=dt,
                                     seq_dim=seq).float(), approximate="tanh").to(dt)
    return foopar_matmul_row(h, w["w_down"], axis=ax, preferred_element_type=dt, seq_dim=seq)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------
def embed_init(gen: Optional[torch.Generator], cfg: ModelConfig,
               dtype: Optional[torch.dtype] = None) -> Params:
    p = {"embedding": _normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype or _pdtype(cfg))}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab, cfg, dtype=dtype)
    return p


def _vocab_part(names, shape, dim: int, cfg: ModelConfig, ctx) -> Optional[str]:
    part = leaf_spec(names, shape, cfg, ctx)[dim]
    return part if part == _tp_axis(ctx) else None


def vocab_axis(cfg: ModelConfig, ctx) -> Optional[str]:
    """The axis the logits' vocabulary is split over under ``ctx`` (the
    embedding's, or the unembedding's, ``model`` partition), or None."""
    if ctx is None:
        return None
    if cfg.tie_embeddings:
        return _vocab_part(("embed", "embedding"), (cfg.vocab, cfg.d_model), 0, cfg, ctx)
    return _vocab_part(("embed", "unembed"), (cfg.d_model, cfg.vocab), 1, cfg, ctx)


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig, ctx=None) -> torch.Tensor:
    """Token lookup.  Under a ctx the embedding is split ``[model, fsdp]``:
    the fsdp columns are gathered (in the parameters' dtype, so the
    gradient accumulates as on one device), each rank looks up the tokens
    inside its vocabulary rows (the rest masked to 0) and the rows are
    summed over ``model`` -- one nonzero a row, so the sum is exact.  Under
    a sequence-sharded residual the sum is reduce-scattered onto the rank's
    sequence rows (a whole-vocabulary lookup keeps them)."""
    w = p["embedding"]
    vpart = None
    if ctx is not None:
        shape = (cfg.vocab, cfg.d_model)
        w = _weight(w, ("embed", "embedding"), shape, cfg, ctx)
        vpart = _vocab_part(("embed", "embedding"), shape, 0, cfg, ctx)
    if vpart is None:
        flat = w.index_select(0, tokens.reshape(-1))
        return scatter_seq(flat.reshape(*tokens.shape, -1).to(_dtype(cfg)), ctx)
    t = tokens.reshape(-1).long() - ctx.mesh.index(vpart) * w.shape[0]
    inside = (t >= 0) & (t < w.shape[0])
    rows = w.index_select(0, torch.where(inside, t, 0))
    rows = torch.where(inside[:, None], rows, 0.0).to(_dtype(cfg)).reshape(*tokens.shape, -1)
    if seq_sharded(ctx):
        return reduce_scatter_dim(rows, vpart, 1, ctx.mesh)
    return reduce_sum(rows, vpart, ctx.mesh)


def logits(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx=None) -> torch.Tensor:
    """f32 logits.  Under a ctx with the vocabulary split over ``model``
    they stay split: the rank's (.., V / model) columns.  A sequence-sharded
    ``x`` (the rank's rows of the final norm's output) is all-gathered
    first, so the logits hold every position, (B/dp, S, V/tp)."""
    dt = _dtype(cfg)
    if ctx is not None:
        vpart = vocab_axis(cfg, ctx)
        if cfg.tie_embeddings:
            w = _weight(p["embedding"], ("embed", "embedding"), (cfg.vocab, cfg.d_model),
                        cfg, ctx, dtype=dt).t()
        else:
            w = _weight(p["unembed"], ("embed", "unembed"), (cfg.d_model, cfg.vocab),
                        cfg, ctx, dtype=dt)
        if vpart is not None:
            x = all_gather_dim(x, vpart, 1, ctx.mesh) if seq_sharded(ctx) else \
                copy_d(x, vpart, ctx.mesh)
        else:
            x = gather_seq(x, ctx)
    else:
        w = p["embedding"].t() if cfg.tie_embeddings else p["unembed"]
    out = _matmul_f32(x.to(dt), w.to(dt))
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = c * torch.tanh(out / c)
    return out  # f32
