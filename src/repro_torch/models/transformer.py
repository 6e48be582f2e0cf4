"""Decoder-only LM assembly: the dense, MoE, hybrid (Mamba2) and xLSTM
families.

Mirrors the JAX package's ``models/transformer.py``.  JAX stacks the layer
parameters over periods of ``cfg.block_pattern`` and scans them; here
``params["layers"]`` is a plain list with one dict per layer (layer j *
len(pattern) + i has kind ``pattern[i]``) and the scan is a Python loop.
Zamba2's one ``shared_attn`` weight set sits beside the layers and is
applied at every ``mamba2_attn`` layer, each with its own KV cache.

A cache is a list with one entry per layer: a (K, V) pair for the
attention kinds (``attn``, ``attn_moe``), updated in place -- per-slot rows
``(B, L, Hkv, hd)`` (end-aligned) or page arenas (paged) -- and a dict of
state for the recurrent kinds, replaced at each call: ``{"mamba": {"conv",
"ssm"}}`` (with ``"shared_attn": (K, V)`` at a ``mamba2_attn`` layer),
``{"mlstm": {"ssm"}}``, ``{"slstm": {"c", "n", "m"}}``.

  * ``forward``: full-sequence logits, no cache (the oracle of the decode
    paths, and the train step's model, differentiable, with JAX's
    ``remat`` modes); ``return_aux`` adds the MoE load-balance loss;
  * ``init_cache`` / ``prefill`` / ``decode_step``: the end-aligned serving
    engine's model calls (a fused cache-writing prefill, right-padded for
    the attention kinds, unpadded for the recurrent ones; a batched decode
    over per-row positions);
  * ``init_paged_cache`` / ``prefill_paged`` / ``decode_step(block_tables=)``:
    the paged serving engine's model calls (pure attention patterns).

Under a mesh ctx (``models.moe.MeshCtx``) ``forward`` runs inside one rank
on its local parameter blocks and batch rows and returns its logits block
(vocabulary-split over ``model`` under tensor parallelism); the layers
issue the collectives (``models/layers.py``, ``models/moe.py``).
``init(shard=)`` keeps each leaf's block as soon as its group is drawn, so
a rank never holds the whole tree.  The serving calls take a ctx too:
``init_cache(ctx=)`` builds this rank's block of every cache leaf
(``launch/specs.py::cache_specs``), and ``prefill``, ``prefill_paged`` and
``decode_step`` run on the rank's batch rows and cache blocks and return
its logits block; the paged arenas are whole on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.tree import leaves_with_path, tree_map, tree_unflatten

Params = dict
Cache = List[Any]            # per layer: (K, V) for attention kinds, a dict of state else
ATTN_KINDS = ("attn", "attn_moe")
# the parameter groups JAX stacks (over periods, or over layers for enc-dec)
STACKED = ("layers", "enc_layers", "dec_layers")


def kind_of(cfg: ModelConfig, i: int) -> str:
    """The block kind of layer ``i``."""
    return cfg.block_pattern[i % len(cfg.block_pattern)]


# ---------------------------------------------------------------------------
# Per-kind init / apply
# ---------------------------------------------------------------------------
def _block_init(kind: str, gen, cfg: ModelConfig, dtype) -> Params:
    dev = L._device(gen)
    ln1 = L.norm_init(cfg.d_model, cfg, dev)
    if kind in ATTN_KINDS:
        p = {"ln1": ln1, "attn": L.attention_init(gen, cfg, dtype),
             "ln2": L.norm_init(cfg.d_model, cfg, dev)}
        if kind == "attn":
            p["mlp"] = L.mlp_init(gen, cfg, dtype=dtype)
        else:
            p["moe"] = M.moe_init(gen, cfg, dtype)
        return p
    if kind in ("mamba2", "mamba2_attn"):
        return {"ln1": ln1, "mamba": S.mamba2_init(gen, cfg, dtype)}
    if kind == "mlstm":
        return {"ln1": ln1, "mlstm": X.mlstm_init(gen, cfg, dtype)}
    if kind == "slstm":
        return {"ln1": ln1, "slstm": X.slstm_init(gen, cfg, dtype)}
    raise ValueError(f"unknown block kind {kind!r}")


def _block_apply(kind: str, p: Params, h: torch.Tensor, positions, cfg: ModelConfig,
                 cache, cache_pos, block_tables, shared_attn: Optional[Params], ctx=None,
                 length=None):
    """Returns (h, new cache entry, aux loss contribution).  ``cfg`` is the
    layer's (``ModelConfig.layer_config``); ``length``: a fused prefill's
    true prompt lengths (``prefill``).  Under a sequence-sharded residual
    (``layers.seq_sharded``) ``h`` is the rank's sequence rows: the norms
    run on them, attention and the dense MLP take them; a block kind with
    no sequence-sharded form (MoE, Mamba2, mLSTM, sLSTM) gathers the whole
    sequence on entry, runs as without ``seq_parallel`` (``whole``) and
    keeps the rank's rows on exit."""
    aux = None
    whole = L.replicated_seq(ctx)

    def norm(q, x):
        return L.residual_norm(q, x, cfg, ctx)

    def replicated(fn, x):
        """``fn`` (returning a pair) of the whole sequence, its first output
        back to the rank's rows."""
        out, rest = fn(L.gather_seq(x, ctx))
        return L.scatter_seq(out, ctx), rest

    if kind in ATTN_KINDS:
        x1 = norm(p["ln1"], h)
        attn_out, new = L.attention(p["attn"], x1, positions, cfg, cache=cache,
                                    cache_pos=cache_pos, block_tables=block_tables, ctx=ctx,
                                    length=length)
        if cfg.parallel_block:             # command-r style: attn || ffn on one input
            x2 = x1
        else:
            h = h + attn_out
            x2 = norm(p["ln2"], h)
        if kind == "attn":
            ffn_out = L.mlp(p["mlp"], x2, cfg, ctx)
        else:
            ffn_out, probs = replicated(lambda x: M.moe_ffn(p["moe"], x, cfg, whole), x2)
            aux = M.load_balance_loss(probs, whole)
        if cfg.parallel_block:
            return h + attn_out + ffn_out, new, aux
        return h + ffn_out, new, aux

    if kind in ("mamba2", "mamba2_attn"):
        out, m_new = replicated(lambda x: S.mamba2_block(
            p["mamba"], x, cfg, cache=cache["mamba"] if cache is not None else None, ctx=whole),
            norm(p["ln1"], h))
        h = h + out
        new = {"mamba": m_new} if cache is not None else None
        if kind == "mamba2_attn":
            a_out, sa_new = L.attention(shared_attn["attn"], norm(shared_attn["ln1"], h),
                                        positions, cfg, cache=cache["shared_attn"]
                                        if cache is not None else None, cache_pos=cache_pos,
                                        ctx=ctx)
            h = h + a_out
            h = h + L.mlp(shared_attn["mlp"], norm(shared_attn["ln2"], h), cfg, ctx)
            if cache is not None:
                new["shared_attn"] = sa_new
        return h, new, aux

    if kind in ("mlstm", "slstm"):
        block = X.mlstm_block if kind == "mlstm" else X.slstm_block
        out, s_new = replicated(lambda x: block(
            p[kind], x, cfg, cache=cache[kind] if cache is not None else None, ctx=whole),
            norm(p["ln1"], h))
        return h + out, ({kind: s_new} if cache is not None else None), aux
    raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------
def init(cfg: ModelConfig, generator: Optional[torch.Generator],
         dtype: Optional[torch.dtype] = None,
         shard: Optional[Callable[[tuple, torch.Tensor], torch.Tensor]] = None) -> Params:
    """Random parameters on ``generator``'s device, drawn as the JAX init
    draws them (normal, std 1/sqrt(d_in); embedding std 0.02; norm scales
    ones; the router, the conv weights and the SSM's A_log / D / dt_bias in
    f32): every leaf in ``cfg.param_dtype`` (f32 master weights), as in
    JAX, unless ``dtype`` asks for the matrices in another dtype.  The
    numbers differ from the JAX init's; tests carry JAX parameters over
    with ``convert``.  ``generator=None`` builds the tree on the ``meta``
    device (shapes and dtypes, no memory: JAX's ``eval_shape``).
    ``shard(path, leaf)`` replaces each leaf right after its group (the
    embedding, one layer, the shared attention, the final norm) is drawn --
    with a rank's block, so the whole tree never exists at once; the draws
    are the same."""
    dev = L._device(generator)

    def keep(prefix, tree):
        if shard is None:
            return tree
        return tree_unflatten(tree, [shard(prefix + path, leaf)
                                     for path, leaf in leaves_with_path(tree)])

    params = {
        "embed": keep(("embed",), L.embed_init(generator, cfg, dtype)),
        "layers": [keep(("layers", i), _block_init(kind_of(cfg, i), generator, cfg, dtype))
                   for i in range(cfg.n_layers)],
        "final_norm": keep(("final_norm",), L.norm_init(cfg.d_model, cfg, dev)),
    }
    if "mamba2_attn" in cfg.block_pattern:
        params["shared_attn"] = keep(("shared_attn",), {
            "ln1": L.norm_init(cfg.d_model, cfg, dev),
            "attn": L.attention_init(generator, cfg, dtype),
            "ln2": L.norm_init(cfg.d_model, cfg, dev),
            "mlp": L.mlp_init(generator, cfg, dtype=dtype)})
    return params


def init_abstract(cfg: ModelConfig) -> Params:
    """Shape-only init for the dry run: every leaf on ``meta``, nothing
    drawn or allocated (JAX's ``eval_shape`` of its init)."""
    return init(cfg, None)


def decay_mask(params: Params) -> dict:
    """The leaves AdamW decays, as the JAX package's train step decays them:
    those of more than one dimension in JAX's layout, where every leaf of a
    stacked group (``STACKED``: the layers, or the enc-dec's encoder and
    decoder layers) has the stacking dim.  So each layer's norm scales (and
    biases, and the SSM's A_log / D / dt_bias) take weight decay there and
    here; the final norm's, and the unstacked shared attention's, do not."""
    return {k: tree_map(lambda t, stacked=(k in STACKED): stacked or t.dim() > 1, v)
            for k, v in params.items()}


def _save_matmuls(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the 2-D products (the
    projections; JAX's ``checkpoint_dots_with_no_batch_dims``) and recompute
    everything else, attention's batched products included."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, remat: str, *args):
    """``fn(*args)`` with the backward recomputing what ``remat`` says, as
    JAX's ``jax.checkpoint`` per layer: ``"none"`` keeps every activation,
    ``"full"`` only the inputs (``torch.utils.checkpoint``), ``"dots"`` the
    inputs and the 2-D matmul outputs (selective checkpointing)."""
    if remat == "none":
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: create_selective_checkpoint_contexts(
                              _save_matmuls))
    raise ValueError(f"remat must be 'none', 'full' or 'dots', got {remat!r}")


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            ctx=None, remat: str = "none", return_aux: bool = False):
    """tokens (B, S) -> logits (B, S, V) f32, causal, no cache; with
    ``return_aux``, (logits, aux): the sum over MoE layers of the
    load-balance loss (an f32 0 without MoE layers), as JAX's ``forward``
    returns them.

    ``remat`` says what the backward pass recomputes (``remat_call``); the
    numbers are the same in every mode.

    ``ctx``: this rank's batch rows and parameter blocks in, its logits
    block out (B/dp, S, V/tp); a recompute issues its layer's collectives
    again, in the same order on every rank.  With ``ctx.seq_parallel`` the
    residual between the layers is the rank's sequence rows (B/dp, S/tp, d)
    (``_constrain``); where ``model`` does not split S it stays replicated,
    the same numbers either way."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {remat!r}")
    if ctx is not None and ctx.seq_parallel:
        if ctx.dp_over_model:
            # the residual's spec would name 'model' twice, P(('data', 'model'),
            # 'model', None), which JAX refuses (DuplicateSpecError)
            raise ValueError("sequence_parallel with dp_over_model: the residual's spec would "
                             "name 'model' for both the batch and the sequence")
        if tokens.shape[1] % ctx.model_size:
            ctx = L.replicated_seq(ctx)
    h = L.embed(params["embed"], tokens, cfg, ctx)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    shared_attn = params.get("shared_attn")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    for i, p in enumerate(params["layers"]):
        kind = kind_of(cfg, i)

        def layer(h, p, kind=kind, lcfg=cfg.layer_config(i)):
            h, _, a = _block_apply(kind, p, h, positions, lcfg, None, None, None, shared_attn,
                                   ctx)
            h = h if ctx is None else _constrain(h, ctx)
            return h, (a if a is not None else torch.zeros((), device=h.device))

        h, a = remat_call(layer, remat, h, p)
        aux = aux + a
    h = L.residual_norm(params["final_norm"], h, cfg, ctx)
    logits = L.logits(params["embed"], h, cfg, ctx)
    return (logits, aux) if return_aux else logits


def _constrain(h: torch.Tensor, ctx) -> torch.Tensor:
    """The residual's layout between layers, JAX's ``P(batch, s_part,
    None)``: batch over the batch axes, and the sequence over ``model``
    with ``seq_parallel`` (the rank's rows) or replicated over it without.
    The layers give it by construction (``layers.seq_sharded``: the
    Megatron sequence-parallel gathers and reduce-scatters), so nothing
    moves here."""
    return h


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda",
               dtype: torch.dtype = torch.bfloat16, ctx=None) -> Cache:
    """One entry per layer: a (K, V) pair of ``(batch, kv_len, kv_heads,
    hd)`` zero rows for an attention kind (``kv_len = min(max_len,
    window)`` for SWA, with the layer's own window where they are per
    layer: a ring), in ``dtype`` (bf16 whatever the model dtype,
    as in the JAX package); the recurrent kinds' state: the Mamba2 conv
    window in ``dtype`` and its SSM state in f32 (plus the shared
    attention's K/V at ``mamba2_attn``), the mLSTM state and the sLSTM's c,
    n (0) and m (-1e30) in f32.  Under ``ctx``: this rank's block of each
    leaf, by ``cache_specs``."""
    if ctx is not None:
        return local_cache(cfg, init_cache(cfg, batch, max_len, device="meta", dtype=dtype),
                           ctx, device)
    def kv(window=cfg.window):
        shp = (batch, min(max_len, window) if window else max_len, cfg.n_kv_heads, cfg.hd)
        return (torch.zeros(shp, dtype=dtype, device=device),
                torch.zeros(shp, dtype=dtype, device=device))

    def one(kind, i):
        if kind in ATTN_KINDS:
            return kv(cfg.layer_config(i).window)
        if kind in ("mamba2", "mamba2_attn"):
            c = {"mamba": S.mamba2_init_cache(batch, cfg, device, dtype)}
            if kind == "mamba2_attn":
                c["shared_attn"] = kv()
            return c
        if kind == "mlstm":
            return {"mlstm": X.mlstm_init_cache(batch, cfg, device)}
        if kind == "slstm":
            return {"slstm": X.slstm_init_cache(batch, cfg, device)}
        raise ValueError(f"unknown block kind {kind!r}")

    return [one(kind_of(cfg, i), i) for i in range(cfg.n_layers)]


def local_cache(cfg: ModelConfig, like: Cache, ctx, device) -> Cache:
    """Zeros (the sLSTM stabiliser's ``m`` at -1e30) in this rank's block
    shapes (``launch.specs.block_layouts``) of the global cache ``like``
    (``meta`` tensors will do), each tagged with its spec."""
    from repro_torch.launch.specs import block_layouts, keep_spec
    out = [keep_spec(torch.full(shape, X.M_INIT if path[-1] == "m" else 0.0, dtype=leaf.dtype,
                                device=device), spec)
           for (path, leaf), (spec, shape) in zip(leaves_with_path(like),
                                                  block_layouts(cfg, ctx, like))]
    return tree_unflatten(like, out)


def supports_fused_prefill(cfg: ModelConfig) -> bool:
    """True when ``prefill`` handles arbitrary (right-padded, any-length)
    prompts: pure-attention patterns, where causal masking makes end-padding
    invisible.  The recurrent kinds do support ``prefill``, but only
    unpadded, with a length the chunk scan divides: the scheduler falls
    back to the per-token loop for them."""
    return all(k in ATTN_KINDS for k in cfg.block_pattern)


def _layers(params: Params, h: torch.Tensor, positions, cfg: ModelConfig, cache: Cache,
            cache_pos, block_tables, ctx=None, length=None) -> torch.Tensor:
    """Every layer over ``h`` with its cache entry, replaced in ``cache``,
    under its own config (``ModelConfig.layer_config``); ``cache_pos`` is
    one for every layer, or a list of one a layer."""
    shared_attn = params.get("shared_attn")
    per_layer = isinstance(cache_pos, list)
    for i, p in enumerate(params["layers"]):
        h, cache[i], _ = _block_apply(kind_of(cfg, i), p, h, positions, cfg.layer_config(i),
                                      cache[i], cache_pos[i] if per_layer else cache_pos,
                                      block_tables, shared_attn, ctx, length)
    return h


def prefill(params: Params, tokens: torch.Tensor, cache: Cache, cfg: ModelConfig, *,
            length: Optional[torch.Tensor] = None, ctx=None) -> Tuple[torch.Tensor, Cache]:
    """Cache-writing full-sequence forward: one fused call replaces a
    prompt-length loop of decode steps.  tokens (B, S) start at position 0;
    every attention layer writes the K/V of all S tokens into ``cache`` and
    attends through the flash kernel; a recurrent layer's state is the
    chunk scan's (the whole S must be real tokens).  ``length``: optional
    (B,) true prompt lengths of a right-padded batch (pad entries are
    causally invisible; attention patterns only).  Per-layer windows
    (``cfg.layer_windows``): a ring shorter than the bucket keeps the last
    ``window`` real tokens of each row (``layers._write_prefill``); a
    model-wide window refuses such a bucket.  Returns (last-position
    logits (B, V) f32, cache).  ``ctx``: the rank's rows and cache blocks
    in, its logits block (B/dp, V/tp) out."""
    b, s = tokens.shape
    ctx = L.replicated_seq(ctx)
    if length is not None:
        if not supports_fused_prefill(cfg):
            raise NotImplementedError(
                "padded fused prefill needs a causally-maskable pattern; "
                f"{cfg.block_pattern} carries recurrent state")
        from repro_torch.launch.specs import kv_slots
        ring = cache[0][0].shape[1] if ctx is None else kv_slots(cache[0][0], ctx)[1]
        if cfg.layer_windows is None and s > ring:
            # the trailing-window ring write would keep pad K/V and drop
            # real tokens; unpadded (length=None) overflow is fine.  Per-layer
            # rings write from the true lengths instead
            raise NotImplementedError(
                f"right-padded prefill bucket {s} exceeds the cache ring "
                f"{ring}; cap the pad bucket at the attention window")
    h = L.embed(params["embed"], tokens, cfg, ctx)
    h = _layers(params, h, torch.arange(s, device=tokens.device), cfg, cache, 0, None, ctx,
                length)
    h = L.apply_norm(params["final_norm"], h, cfg)
    if length is None:
        h_last = h[:, -1]
    else:
        idx = torch.as_tensor(length, device=h.device).long().expand(b) - 1
        h_last = h[torch.arange(b, device=h.device), idx]
    return L.logits(params["embed"], h_last[:, None], cfg, ctx)[:, 0], cache


def supports_paged(cfg: ModelConfig) -> bool:
    """True when the paged KV-cache engine can serve this config: pure
    attention patterns (pages hold K/V lines; recurrent state has no
    per-position layout to page) with full (no sliding-window) attention in
    every layer (no ``layer_windows``)."""
    return (not cfg.enc_dec and cfg.window is None and cfg.layer_windows is None
            and all(k in ATTN_KINDS for k in cfg.block_pattern))


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block: int, *,
                     device="cuda", dtype: torch.dtype = torch.bfloat16) -> Cache:
    """One (K, V) pair of ``(n_blocks, block, kv_heads, hd)`` page arenas per
    layer, zero-filled.  K/V are stored in bf16 whatever the model dtype, as
    in the JAX package.  Under a mesh ctx every rank holds the whole arenas
    (the reference sets no constraint on them)."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged KV cache needs a pure-attention, no-SWA pattern; got "
            f"{cfg.block_pattern} (window={cfg.window}, layer_windows={cfg.layer_windows})")
    shp = (n_blocks, block, cfg.n_kv_heads, cfg.hd)
    return [(torch.zeros(shp, dtype=dtype, device=device),
             torch.zeros(shp, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def prefill_paged(params: Params, tokens: torch.Tensor, cache: Cache,
                  cfg: ModelConfig, *, pos0: int, block_tables: torch.Tensor,
                  length: Optional[int] = None, ctx=None) -> Tuple[torch.Tensor, Cache]:
    """One chunked-prefill slice: tokens (1, C) land at absolute positions
    ``pos0..pos0+C-1`` of one request's paged sequence (pages named by
    ``block_tables`` (1, P)), writing K/V into the arenas and attending
    causally over everything written so far.  ``length``: true token count
    of a right-padded final chunk.  Returns (logits at the chunk's last real
    token (1, V) f32, cache).  ``ctx``: as ``prefill``'s."""
    b, s = tokens.shape
    ctx = L.replicated_seq(ctx)
    h = L.embed(params["embed"], tokens, cfg, ctx)
    h = _layers(params, h, pos0 + torch.arange(s, device=tokens.device), cfg, cache, pos0,
                block_tables, ctx)
    h = L.apply_norm(params["final_norm"], h, cfg)
    last = (length if length is not None else s) - 1
    return L.logits(params["embed"], h[:, last:last + 1], cfg, ctx)[:, 0], cache


def decode_step(params: Params, token: torch.Tensor, cache: Cache, pos: torch.Tensor,
                cfg: ModelConfig, *, block_tables: Optional[torch.Tensor] = None,
                ctx=None) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  token (B,) int; pos: a scalar absolute position,
    or a (B,) tensor of per-row positions (continuous-batching slots advance
    independently).  Without ``block_tables`` the cache is the end-aligned
    rows (SWA: a ring, written at ``pos % window``, each layer at its own
    window, ``ModelConfig.layer_config``) and the recurrent
    state; ``block_tables`` (B, P): the paged cache, each row addressing
    its own page chain.  Returns (logits (B, V) f32, cache).  ``ctx``: as
    ``prefill``'s (the rank's rows of ``token``, ``pos`` and
    ``block_tables``)."""
    pos = torch.as_tensor(pos, device=token.device)
    ctx = L.replicated_seq(ctx)
    h = L.embed(params["embed"], token[:, None], cfg, ctx)     # (B, 1, d)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    windows = [cfg.layer_config(i).window for i in range(cfg.n_layers)]
    ring = {w: pos % w for w in set(windows) if w is not None}
    cache_pos = [pos if w is None else ring[w] for w in windows]
    h = _layers(params, h, positions, cfg, cache, cache_pos, block_tables, ctx)
    h = L.apply_norm(params["final_norm"], h, cfg)
    return L.logits(params["embed"], h, cfg, ctx)[:, 0], cache
