"""Train and serve step builders, as plain closures.

The JAX package jits these (the train step donating its state, the serve
steps their cache); here they run eagerly.  Training: ``cross_entropy``,
``make_loss_fn``, ``make_train_step`` (the single-device all-reduce step,
which writes the new state into the old state's tensors, as JAX's donated
buffers are reused), ``init_train_state`` and
``abstract_train_state`` (on the ``meta`` device).  The ZeRO step
(``make_train_step_zero``) waits for the port's sharding layer (ROADMAP
queue 1, item 7).  Serving: the fused prefill and end-aligned decode step,
the paged decode step and the chunked-prefill step, which write the cache
in place (the returned cache is the same list).
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch.config import ModelConfig, ParallelConfig, TrainConfig, torch_dtype
from repro_torch.models import transformer as T
from repro_torch.tree import leaves, tree_map, tree_unflatten

Tree = Any


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def _lse_and_picked(lg: torch.Tensor, lb: torch.Tensor):
    """Per-token log-sum-exp and the label's logit (0 for a label outside
    the vocabulary, as JAX's iota-mask pick gives)."""
    lg = lg.float()
    m = torch.amax(lg, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(lg - m), dim=-1)) + m[..., 0]
    inside = (lb >= 0) & (lb < lg.shape[-1])
    picked = torch.gather(lg, -1, torch.where(inside, lb, 0).long()[..., None])[..., 0]
    return lse, torch.where(inside, picked, 0.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  z_loss: float = 0.0, chunk: Optional[int] = None) -> torch.Tensor:
    """Token-mean CE over (B, S, V) logits, in f32.  ``z_loss`` adds
    ``z_loss * lse**2`` a token (unchunked form only, as in JAX).  ``chunk``
    sums the loss over sequence chunks of that length, the last padded with
    ignored labels."""
    if chunk is None:
        lse, picked = _lse_and_picked(logits, labels)
        loss = lse - picked
        if z_loss:
            loss = loss + z_loss * lse ** 2
        return torch.sum(loss) / loss.numel()
    b, s = labels.shape
    pad = (-s) % chunk
    if pad:
        logits = torch.nn.functional.pad(logits, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for lo in range(0, s + pad, chunk):
        lbc = labels[:, lo:lo + chunk]
        lse, picked = _lse_and_picked(logits[:, lo:lo + chunk], lbc)
        total = total + torch.sum((lse - picked) * (lbc >= 0).float())
    return total / (b * s)


def make_loss_fn(cfg: ModelConfig, pcfg: ParallelConfig, tcfg: TrainConfig,
                 ctx=None) -> Callable:
    """``loss_fn(params, batch) -> (loss, {"loss", "aux"})``: next-token CE
    over ``batch["tokens"]`` plus ``1e-2 * aux``.  The dense families have
    no auxiliary loss: ``aux`` is an f32 0, reported as JAX reports it."""
    if ctx is not None:
        raise NotImplementedError("a mesh ctx needs the port's sharding layer "
                                  "(ROADMAP queue 1, item 7)")
    if cfg.enc_dec:
        raise NotImplementedError("enc-dec training is not ported (ROADMAP queue 1, item 6)")

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        logits = T.forward(params, tokens, cfg, remat=pcfg.remat)
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        loss = cross_entropy(logits[:, :-1], tokens[:, 1:], z_loss=tcfg.z_loss,
                             chunk=pcfg.logit_chunk)
        loss = loss + 1e-2 * aux
        return loss, {"loss": loss, "aux": aux}
    return loss_fn


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig, tcfg: TrainConfig,
                    ctx=None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, JAX's all-reduce
    step on one device: loss and grads (f32 for f32 parameters), grads cast
    to ``pcfg.grad_dtype``, clipped by global norm, then the warmup-cosine
    rate and AdamW (weight decay on the leaves JAX decays,
    ``transformer.decay_mask``).  ``grad_reduce="reduce_scatter_zero"`` without a ctx
    warns and takes this step, as JAX's does."""
    if pcfg.grad_reduce == "reduce_scatter_zero":
        if ctx is not None:
            raise NotImplementedError("make_train_step_zero waits for the port's "
                                      "sharding layer (ROADMAP queue 1, item 7)")
        warnings.warn("grad_reduce='reduce_scatter_zero' needs a mesh ctx; "
                      "falling back to the single-device all-reduce step",
                      stacklevel=2)
    loss_fn = make_loss_fn(cfg, pcfg, tcfg, ctx)
    grad_dt = torch_dtype(pcfg.grad_dtype)

    def train_step(state: Tree, batch: Tree) -> Tuple[Tree, dict]:
        live = [p.detach().requires_grad_(True) for p in leaves(state["params"])]
        with torch.enable_grad():
            (loss, metrics) = loss_fn(tree_unflatten(state["params"], live), batch)
            # a leaf the arch never reads (command-r's ln2) gets a zero
            # gradient, as JAX gives it
            grads = list(torch.autograd.grad(loss, live, allow_unused=True,
                                             materialize_grads=True))
        del live
        if pcfg.grad_dtype != "float32":
            for i, g in enumerate(grads):     # one f32 grad freed at a time
                grads[i] = g.to(grad_dt)
        grads, gnorm = optim.clip_by_global_norm(
            tree_unflatten(state["params"], grads), tcfg.grad_clip)
        lr = optim.warmup_cosine(state["opt"]["step"], lr=tcfg.lr,
                                 warmup_steps=tcfg.warmup_steps,
                                 total_steps=tcfg.total_steps)
        params, opt_state = optim.adamw_update(
            grads, state["opt"], state["params"], lr=lr, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay, decay=T.decay_mask(state["params"]))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_norm=gnorm, lr=lr)
        return {"params": params, "opt": opt_state}, metrics

    return train_step


def init_train_state(generator: Optional[torch.Generator], cfg: ModelConfig,
                     pcfg: ParallelConfig) -> Tree:
    """``{"params", "opt"}`` on ``generator``'s device (``None``: the
    ``meta`` device).  With ``pcfg.master_weights`` the parameters are
    stored in bf16 and the optimizer keeps their f32 master copy."""
    if cfg.enc_dec:
        raise NotImplementedError("enc-dec training is not ported (ROADMAP queue 1, item 6)")
    params = T.init(cfg, generator)
    opt = optim.adamw_init(params, pcfg.opt_state_dtype, master=pcfg.master_weights)
    if pcfg.master_weights:
        params = tree_map(lambda p: p.to(torch.bfloat16), params)
    return {"params": params, "opt": opt}


def abstract_train_state(cfg: ModelConfig, pcfg: ParallelConfig) -> Tree:
    """The train state's structure, shapes and dtypes on the ``meta``
    device (no memory): the ``like`` tree of ``restore_checkpoint``."""
    return init_train_state(None, cfg, pcfg)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------
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
