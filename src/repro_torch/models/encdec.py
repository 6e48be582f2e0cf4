"""Whisper-style encoder-decoder backbone: the port of the JAX package's
``models/encdec.py``.  The conv / audio frontend is a stub: the caller
supplies frame embeddings (B, T_enc, d).

Encoder: non-causal self-attention (through the flash kernel outside
autograd, as every Lq == Lk attention of the port) and a GELU MLP over the
frames.  Decoder: causal self-attention (KV-cached for decode),
cross-attention to the encoder output (``_sdpa``, recomputing its K/V from
the encoder output at each call, as the reference does) and a GELU MLP.
LayerNorm, learned positional tables ``enc_pos`` (1500, d) and ``dec_pos``
(32768, d) kept in f32.  JAX stacks ``enc_layers`` / ``dec_layers`` over
the layers; here each is a list of per-layer dicts.  A cache is a list of
one (K, V) pair per decoder layer.

Under a mesh ctx every call runs inside one rank on its batch rows and
parameter blocks (``models/layers.py``): the encoder's and the decoder's
attention in the sequence-sharded region (Whisper's 1500 frames split
over ``model``), the cache's length split over ``model`` for decoding, the
decoder's one-token cross-attention against the whole encoder K/V, the
MLPs tensor-parallel, the logits split over the vocabulary.  The residual
is never sequence-sharded: JAX's enc-dec constraint ignores
``seq_parallel``, and so does every entry point here.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import local_cache, remat_call
from repro_torch.tree import leaves_with_path, tree_unflatten

Params = dict
ENC_LEN = 1500       # whisper: 30 s at 50 Hz after the (stubbed) conv frontend
DEC_LEN = 32768


def init(cfg: ModelConfig, generator: Optional[torch.Generator],
         dtype: Optional[torch.dtype] = None,
         shard: Optional[Callable[[tuple, torch.Tensor], torch.Tensor]] = None) -> Params:
    """Random parameters, drawn as ``transformer.init`` draws them (the
    positional tables normal with std 0.01, in f32 whatever ``dtype``).
    ``generator=None``: shapes only, on the ``meta`` device; ``shard`` as
    in ``transformer.init``."""
    dev = L._device(generator)
    d = cfg.d_model

    def keep(prefix, tree):
        if shard is None:
            return tree
        return tree_unflatten(tree, [shard(prefix + path, leaf)
                                     for path, leaf in leaves_with_path(tree)])

    def enc_layer():
        return {"ln1": L.norm_init(d, cfg, dev), "attn": L.attention_init(generator, cfg, dtype),
                "ln2": L.norm_init(d, cfg, dev), "mlp": L.mlp_init(generator, cfg, dtype=dtype)}

    def dec_layer():
        return {"ln1": L.norm_init(d, cfg, dev), "attn": L.attention_init(generator, cfg, dtype),
                "lnx": L.norm_init(d, cfg, dev), "xattn": L.attention_init(generator, cfg, dtype),
                "ln2": L.norm_init(d, cfg, dev), "mlp": L.mlp_init(generator, cfg, dtype=dtype)}

    f32 = torch.float32
    return {
        "embed": keep(("embed",), L.embed_init(generator, cfg, dtype)),
        "enc_pos": keep(("enc_pos",), L._normal(generator, (ENC_LEN, d), 0.01, f32)),
        "dec_pos": keep(("dec_pos",), L._normal(generator, (DEC_LEN, d), 0.01, f32)),
        "enc_layers": [keep(("enc_layers", i), enc_layer()) for i in range(cfg.n_layers)],
        "dec_layers": [keep(("dec_layers", i), dec_layer()) for i in range(cfg.n_layers)],
        "enc_norm": keep(("enc_norm",), L.norm_init(d, cfg, dev)),
        "final_norm": keep(("final_norm",), L.norm_init(d, cfg, dev)),
    }


def init_abstract(cfg: ModelConfig) -> Params:
    """Shape-only init for the dry run: every leaf on ``meta``."""
    return init(cfg, None)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig, *, remat: str = "none",
           ctx=None) -> torch.Tensor:
    """frames (B, T_enc, d) stub frame embeddings -> encoder output (B, T_enc, d)."""
    ctx = L.replicated_seq(ctx)
    dt = L._dtype(cfg)
    t = frames.shape[1]
    h = frames.to(dt) + params["enc_pos"][:t].to(dt)
    positions = torch.arange(t, device=frames.device)

    def layer(h, p):
        a, _ = L.attention(p["attn"], L.apply_norm(p["ln1"], h, cfg), positions, cfg,
                           causal=False, ctx=ctx)
        h = h + a
        return h + L.mlp(p["mlp"], L.apply_norm(p["ln2"], h, cfg), cfg, ctx)

    for p in params["enc_layers"]:
        h = remat_call(layer, remat, h, p)
    return L.apply_norm(params["enc_norm"], h, cfg)


def _dec_layer(p: Params, h, positions, enc_out, cfg, cache=None, cache_pos=None, ctx=None):
    a, new = L.attention(p["attn"], L.apply_norm(p["ln1"], h, cfg), positions, cfg,
                         cache=cache, cache_pos=cache_pos, ctx=ctx)
    h = h + a
    xa, _ = L.attention(p["xattn"], L.apply_norm(p["lnx"], h, cfg), positions, cfg,
                        xattn_kv=enc_out, ctx=ctx)
    h = h + xa
    return h + L.mlp(p["mlp"], L.apply_norm(p["ln2"], h, cfg), cfg, ctx), new


def decode_train(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig, *, remat: str = "none", ctx=None) -> torch.Tensor:
    """Teacher-forced decoder pass.  Returns logits (B, S, V) f32."""
    ctx = L.replicated_seq(ctx)
    s = tokens.shape[1]
    h = L.embed(params["embed"], tokens, cfg, ctx) + params["dec_pos"][:s].to(L._dtype(cfg))
    positions = torch.arange(s, device=tokens.device)

    def layer(h, p):
        return _dec_layer(p, h, positions, enc_out, cfg, ctx=ctx)[0]

    for p in params["dec_layers"]:
        h = remat_call(layer, remat, h, p)
    h = L.apply_norm(params["final_norm"], h, cfg)
    return L.logits(params["embed"], h, cfg, ctx)


def forward(params: Params, frames: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig, *,
            remat: str = "none", ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, S, V) f32, aux = an f32 0), as JAX's ``forward``."""
    enc = encode(params, frames, cfg, remat=remat, ctx=ctx)
    logits = decode_train(params, tokens, enc, cfg, remat=remat, ctx=ctx)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda",
               dtype: torch.dtype = torch.bfloat16,
               ctx=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One (K, V) pair of ``(batch, max_len, kv_heads, hd)`` zeros per
    decoder layer; under ``ctx`` this rank's blocks (``cache_specs``)."""
    if ctx is not None:
        return local_cache(cfg, init_cache(cfg, batch, max_len, device="meta", dtype=dtype),
                           ctx, device)
    shp = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return [(torch.zeros(shp, dtype=dtype, device=device),
             torch.zeros(shp, dtype=dtype, device=device)) for _ in range(cfg.n_layers)]


def decode_prefill(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor, cache,
                   cfg: ModelConfig, *, length: Optional[torch.Tensor] = None, ctx=None):
    """Cache-writing full-sequence decoder pass from position 0 (one fused
    call for a prompt-length loop of decode steps).  ``length``: optional
    (B,) true prompt lengths of right-padded prompts.  Returns
    (last-position logits (B, V) f32, cache)."""
    ctx = L.replicated_seq(ctx)
    b, s = tokens.shape
    h = L.embed(params["embed"], tokens, cfg, ctx) + params["dec_pos"][:s].to(L._dtype(cfg))
    positions = torch.arange(s, device=tokens.device)
    for i, p in enumerate(params["dec_layers"]):
        h, cache[i] = _dec_layer(p, h, positions, enc_out, cfg, cache[i], 0, ctx)
    h = L.apply_norm(params["final_norm"], h, cfg)
    if length is None:
        h_last = h[:, -1]
    else:
        idx = torch.as_tensor(length, device=h.device).long().expand(b) - 1
        h_last = h[torch.arange(b, device=h.device), idx]
    return L.logits(params["embed"], h_last[:, None], cfg, ctx)[:, 0], cache


def decode_step(params: Params, token: torch.Tensor, cache, pos, enc_out: torch.Tensor,
                cfg: ModelConfig, *, ctx=None):
    """One decoder step with cached self-attention; cross-attention recomputes
    K/V from ``enc_out`` (B, T_enc, d).  pos: a scalar, or (B,) per-row
    positions.  Returns (logits (B, V) f32, cache)."""
    ctx = L.replicated_seq(ctx)
    pos = torch.as_tensor(pos, device=token.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    h = L.embed(params["embed"], token[:, None], cfg, ctx) + \
        params["dec_pos"][positions].to(L._dtype(cfg))
    for i, p in enumerate(params["dec_layers"]):
        h, cache[i] = _dec_layer(p, h, positions, enc_out, cfg, cache[i], pos, ctx)
    h = L.apply_norm(params["final_norm"], h, cfg)
    return L.logits(params["embed"], h, cfg, ctx)[:, 0], cache
