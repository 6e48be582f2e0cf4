"""Decoder-only LM assembly for the ``"attn"`` block kind (dense models).

Mirrors the JAX package's ``models/transformer.py``.  JAX stacks the layer
parameters over periods and scans them; here ``params["layers"]`` is a
plain list with one dict per layer and the scan is a Python loop.  A cache
is a list with one (K, V) pair per layer, updated in place: per-slot rows
``(B, L, Hkv, hd)`` (end-aligned) or page arenas (paged).

  * ``forward``: full-sequence logits, no cache (the tests' and
    ``chip_smoke.py``'s oracle for the decode paths, and the train step's
    model, differentiable, with JAX's ``remat`` modes);
  * ``init_cache`` / ``prefill`` / ``decode_step``: the end-aligned serving
    engine's model calls (one fused cache-writing prefill per prompt, a
    batched decode over per-row positions);
  * ``init_paged_cache`` / ``prefill_paged`` / ``decode_step(block_tables=)``:
    the paged serving engine's model calls.

Under a mesh ctx (``models.moe.MeshCtx``) ``forward`` runs inside one rank
on its local parameter blocks and batch rows and returns its logits block
(vocabulary-split over ``model`` under tensor parallelism); the layers
issue the collectives (``models/layers.py``).  ``init(shard=)`` keeps each
leaf's block as soon as its group is drawn, so a rank never holds the whole
tree.  MoE, SSM and xLSTM blocks are not ported yet (ROADMAP, port queue).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.tree import leaves_with_path, tree_map, tree_unflatten

Params = dict
Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def _check_kinds(cfg: ModelConfig) -> None:
    if any(k != "attn" for k in cfg.block_pattern) or cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: only the dense 'attn' block kind is ported; pattern "
            f"{cfg.block_pattern} (ROADMAP, port queue: other model families)")


def _block_apply(p: Params, h: torch.Tensor, positions, cfg: ModelConfig,
                 cache, cache_pos, block_tables, ctx=None):
    x1 = L.apply_norm(p["ln1"], h, cfg)
    attn_out, new_cache = L.attention(p["attn"], x1, positions, cfg, cache=cache,
                                      cache_pos=cache_pos, block_tables=block_tables,
                                      ctx=ctx)
    if cfg.parallel_block:                 # command-r style: attn ∥ mlp
        return h + attn_out + L.mlp(p["mlp"], x1, cfg, ctx), new_cache
    h = h + attn_out
    return h + L.mlp(p["mlp"], L.apply_norm(p["ln2"], h, cfg), cfg, ctx), new_cache


def init(cfg: ModelConfig, generator: Optional[torch.Generator],
         dtype: Optional[torch.dtype] = None,
         shard: Optional[Callable[[tuple, torch.Tensor], torch.Tensor]] = None) -> Params:
    """Random parameters on ``generator``'s device, drawn as the JAX init
    draws them (normal, std 1/sqrt(d_in); embedding std 0.02; norm scales
    ones): every leaf in ``cfg.param_dtype`` (f32 master weights), as in
    JAX, unless ``dtype`` asks for the matrices in another dtype.  The
    numbers differ from the JAX init's; tests carry JAX parameters over
    with ``convert``.  ``generator=None`` builds the tree on the ``meta``
    device (shapes and dtypes, no memory: JAX's ``eval_shape``).
    ``shard(path, leaf)`` replaces each leaf right after its group (the
    embedding, one layer, the final norm) is drawn -- with a rank's block,
    so the whole tree never exists at once; the draws are the same."""
    _check_kinds(cfg)
    dev = L._device(generator)

    def keep(prefix, tree):
        if shard is None:
            return tree
        return tree_unflatten(tree, [shard(prefix + path, leaf)
                                     for path, leaf in leaves_with_path(tree)])

    return {
        "embed": keep(("embed",), L.embed_init(generator, cfg, dtype)),
        "layers": [keep(("layers", i), {"ln1": L.norm_init(cfg.d_model, cfg, dev),
                                        "attn": L.attention_init(generator, cfg, dtype),
                                        "ln2": L.norm_init(cfg.d_model, cfg, dev),
                                        "mlp": L.mlp_init(generator, cfg, dtype=dtype)})
                   for i in range(cfg.n_layers)],
        "final_norm": keep(("final_norm",), L.norm_init(cfg.d_model, cfg, dev)),
    }


def decay_mask(params: Params) -> dict:
    """The leaves AdamW decays, as the JAX package's train step decays them:
    those of more than one dimension in JAX's layout, where every per-layer
    leaf is stacked over the periods.  So each layer's norm scales (and
    biases) take weight decay there and here; the final norm's do not."""
    return {k: tree_map(lambda t, stacked=(k == "layers"): stacked or t.dim() > 1, v)
            for k, v in params.items()}


def _save_matmuls(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the 2-D products (the
    projections; JAX's ``checkpoint_dots_with_no_batch_dims``) and recompute
    everything else, attention's batched products included."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            ctx=None, remat: str = "none") -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) f32, causal, no cache.

    ``remat`` says what the backward pass recomputes, as JAX's ``forward``
    does with ``jax.checkpoint`` per layer: ``"none"`` keeps every
    activation, ``"full"`` only each layer's input (``torch.utils.
    checkpoint``), ``"dots"`` each layer's input and its 2-D matmul outputs
    (selective checkpointing).  The numbers are the same in every mode.

    ``ctx``: this rank's batch rows and parameter blocks in, its logits
    block out (B/dp, S, V/tp); a recompute issues its layer's collectives
    again, in the same order on every rank."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {remat!r}")
    if ctx is not None and ctx.seq_parallel:
        raise NotImplementedError("a sequence-parallel residual (ctx.seq_parallel) is not "
                                  "ported (ROADMAP queue 1, item 8)")
    h = L.embed(params["embed"], tokens, cfg, ctx)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def layer(h, p):
        h = _block_apply(p, h, positions, cfg, None, None, None, ctx)[0]
        return h if ctx is None else _constrain(h, ctx)

    for p in params["layers"]:
        if remat == "none":
            h = layer(h, p)
        elif remat == "full":
            h = checkpoint(layer, h, p, use_reentrant=False)
        else:
            h = checkpoint(layer, h, p, use_reentrant=False,
                           context_fn=lambda: create_selective_checkpoint_contexts(
                               _save_matmuls))
    h = L.apply_norm(params["final_norm"], h, cfg)
    return L.logits(params["embed"], h, cfg, ctx)


def _constrain(h: torch.Tensor, ctx) -> torch.Tensor:
    """The residual's layout between layers: batch over the batch axes,
    replicated over ``model`` -- what the layers give by construction, so
    nothing moves.  The sequence-parallel residual (JAX's
    ``seq_parallel``, which only the dry run's hill-climb sets) is not
    ported: ``forward`` refuses it before any collective."""
    return h


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda",
               dtype: torch.dtype = torch.bfloat16) -> Cache:
    """One (K, V) pair of ``(batch, kv_len, kv_heads, hd)`` zero rows per
    layer, ``kv_len = min(max_len, window)`` for SWA (a ring).  K/V are
    stored in bf16 whatever the model dtype, as in the JAX package."""
    _check_kinds(cfg)
    kv_len = min(max_len, cfg.window) if cfg.window else max_len
    shp = (batch, kv_len, cfg.n_kv_heads, cfg.hd)
    return [(torch.zeros(shp, dtype=dtype, device=device),
             torch.zeros(shp, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def supports_fused_prefill(cfg: ModelConfig) -> bool:
    """True when ``prefill`` handles arbitrary (right-padded, any-length)
    prompts: pure-attention patterns, where causal masking makes end-padding
    invisible."""
    return all(k == "attn" for k in cfg.block_pattern)


def prefill(params: Params, tokens: torch.Tensor, cache: Cache, cfg: ModelConfig, *,
            length: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
    """Cache-writing full-sequence forward: one fused call replaces a
    prompt-length loop of decode steps.  tokens (B, S) start at position 0;
    every layer writes the K/V of all S tokens into ``cache`` and attends
    through the flash kernel.  ``length``: optional (B,) true prompt
    lengths of a right-padded batch (pad entries are causally invisible).
    Returns (last-position logits (B, V) f32, cache)."""
    b, s = tokens.shape
    if length is not None:
        if not supports_fused_prefill(cfg):
            raise NotImplementedError(
                "padded fused prefill needs a causally-maskable pattern; "
                f"{cfg.block_pattern} carries recurrent state")
        ring = cache[0][0].shape[1]
        if s > ring:
            # the trailing-window ring write would keep pad K/V and drop
            # real tokens; unpadded (length=None) overflow is fine
            raise NotImplementedError(
                f"right-padded prefill bucket {s} exceeds the cache ring "
                f"{ring}; cap the pad bucket at the attention window")
    h = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(s, device=tokens.device)
    for i, p in enumerate(params["layers"]):
        h, cache[i] = _block_apply(p, h, positions, cfg, cache[i], 0, None)
    h = L.apply_norm(params["final_norm"], h, cfg)
    if length is None:
        h_last = h[:, -1]
    else:
        idx = torch.as_tensor(length, device=h.device).long().expand(b) - 1
        h_last = h[torch.arange(b, device=h.device), idx]
    return L.logits(params["embed"], h_last[:, None], cfg)[:, 0], cache


def supports_paged(cfg: ModelConfig) -> bool:
    """True when the paged KV-cache engine can serve this config: pure
    dense attention blocks with full (no sliding-window) attention."""
    return (not cfg.enc_dec and cfg.window is None
            and all(k == "attn" for k in cfg.block_pattern))


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block: int, *,
                     device="cuda", dtype: torch.dtype = torch.bfloat16) -> Cache:
    """One (K, V) pair of ``(n_blocks, block, kv_heads, hd)`` page arenas per
    layer, zero-filled.  K/V are stored in bf16 whatever the model dtype, as
    in the JAX package."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged KV cache needs a pure-attention, no-SWA pattern; got "
            f"{cfg.block_pattern} (window={cfg.window})")
    shp = (n_blocks, block, cfg.n_kv_heads, cfg.hd)
    return [(torch.zeros(shp, dtype=dtype, device=device),
             torch.zeros(shp, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def prefill_paged(params: Params, tokens: torch.Tensor, cache: Cache,
                  cfg: ModelConfig, *, pos0: int, block_tables: torch.Tensor,
                  length: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """One chunked-prefill slice: tokens (1, C) land at absolute positions
    ``pos0..pos0+C-1`` of one request's paged sequence (pages named by
    ``block_tables`` (1, P)), writing K/V into the arenas and attending
    causally over everything written so far.  ``length``: true token count
    of a right-padded final chunk.  Returns (logits at the chunk's last real
    token (1, V) f32, cache)."""
    b, s = tokens.shape
    h = L.embed(params["embed"], tokens, cfg)
    positions = pos0 + torch.arange(s, device=tokens.device)
    for i, p in enumerate(params["layers"]):
        h, cache[i] = _block_apply(p, h, positions, cfg, cache[i], pos0, block_tables)
    h = L.apply_norm(params["final_norm"], h, cfg)
    last = (length if length is not None else s) - 1
    return L.logits(params["embed"], h[:, last:last + 1], cfg)[:, 0], cache


def decode_step(params: Params, token: torch.Tensor, cache: Cache, pos: torch.Tensor,
                cfg: ModelConfig, *, block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  token (B,) int; pos: a scalar absolute position,
    or a (B,) tensor of per-row positions (continuous-batching slots advance
    independently).  Without ``block_tables`` the cache is the end-aligned
    rows (SWA: a ring, written at ``pos % window``); ``block_tables`` (B, P):
    the paged cache, each row addressing its own page chain.  Returns
    (logits (B, V) f32, cache)."""
    _check_kinds(cfg)
    pos = torch.as_tensor(pos, device=token.device)
    h = L.embed(params["embed"], token[:, None], cfg)          # (B, 1, d)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    cache_pos = pos if cfg.window is None else pos % cfg.window
    for i, p in enumerate(params["layers"]):
        h, cache[i] = _block_apply(p, h, positions, cfg, cache[i], cache_pos, block_tables)
    h = L.apply_norm(params["final_norm"], h, cfg)
    return L.logits(params["embed"], h, cfg)[:, 0], cache
