"""Step functions of the paged serving engine, as plain closures.

The JAX package jits these and donates the cache; here they run eagerly and
write the page arenas in place (the returned cache is the same list).
Only the paged decode step and the chunked-prefill step are ported; the
train steps, the fused prefill and the end-aligned decode step are later
slices (ROADMAP, port queue).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T


def make_decode_step(cfg: ModelConfig, *, return_logits: bool = False) -> Callable:
    """Paged decode step ``(params, tok, cache, pos, block_tables) -> (next,
    cache)``: greedy int32 tokens by default, or the f32 logits with
    ``return_logits`` so the scheduler can sample.  (The JAX package's
    ``paged=True`` step; its end-aligned step is not ported yet.)"""
    if cfg.enc_dec:
        raise NotImplementedError("paged decode is decoder-only")

    @torch.no_grad()
    def decode_paged(params, token, cache, pos, block_tables):
        logit, cache = T.decode_step(params, token, cache, pos, cfg,
                                     block_tables=block_tables)
        if return_logits:
            return logit.float(), cache
        return torch.argmax(logit, dim=-1).to(torch.int32), cache

    return decode_paged


def make_chunk_prefill_step(cfg: ModelConfig) -> Callable:
    """Chunked-prefill step ``(params, tokens (1, chunk), cache, pos0,
    block_tables (1, P), length) -> (last_logits (1, V), cache)``: one
    fixed-shape slice of one request's prompt per call
    (``models.transformer.prefill_paged``)."""
    if cfg.enc_dec:
        raise NotImplementedError("chunked prefill is decoder-only")

    @torch.no_grad()
    def chunk_prefill(params, tokens, cache, pos0, block_tables, length):
        return T.prefill_paged(params, tokens, cache, cfg, pos0=pos0,
                               block_tables=block_tables, length=length)

    return chunk_prefill
