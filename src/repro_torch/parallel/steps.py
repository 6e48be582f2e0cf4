"""Step functions of the serving engines, as plain closures.

The JAX package jits these and donates the cache; here they run eagerly and
write the cache in place (the returned cache is the same list).  Ported:
the fused prefill and the end-aligned decode step, the paged decode step and
the chunked-prefill step.  The train steps are a later slice (ROADMAP, port
queue).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Fused prefill ``(params, batch, cache) -> (last_logits (B, V),
    cache)``: one cache-writing full-sequence forward per prompt.  ``batch``
    holds ``tokens`` (B, S) and may hold ``length``, the per-row true prompt
    lengths of right-padded prompts (pad entries are causally invisible)."""
    if cfg.enc_dec:
        raise NotImplementedError("enc-dec prefill is not ported (ROADMAP, port queue)")

    @torch.no_grad()
    def prefill(params, batch, cache):
        return T.prefill(params, batch["tokens"], cache, cfg, length=batch.get("length"))

    return prefill


def make_decode_step(cfg: ModelConfig, *, return_logits: bool = False,
                     paged: bool = False) -> Callable:
    """Decode step: greedy int32 tokens by default, or the f32 logits with
    ``return_logits`` so the scheduler can sample.  ``paged`` selects the
    step's form: ``(params, tok, cache, pos, block_tables)`` over the shared
    page arena, or, with ``paged=False``, the end-aligned ``(params, tok,
    cache, pos)`` over per-slot cache rows."""
    if cfg.enc_dec:
        raise NotImplementedError("enc-dec decode is not ported (ROADMAP, port queue)")

    def _out(logit):
        if return_logits:
            return logit.float()
        return torch.argmax(logit, dim=-1).to(torch.int32)

    @torch.no_grad()
    def decode(params, token, cache, pos):
        logit, cache = T.decode_step(params, token, cache, pos, cfg)
        return _out(logit), cache

    @torch.no_grad()
    def decode_paged(params, token, cache, pos, block_tables):
        logit, cache = T.decode_step(params, token, cache, pos, cfg,
                                     block_tables=block_tables)
        return _out(logit), cache

    return decode_paged if paged else decode


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
