"""Train and serve step builders, as plain closures.

The JAX package jits these (the train step donating its state, the serve
steps their cache); here they run eagerly.  Training: ``cross_entropy``,
``make_loss_fn``, ``make_train_step`` (the all-reduce step, which writes
the new state into the old state's tensors, as JAX's donated buffers are
reused), ``make_train_step_zero`` (the ZeRO step), ``init_train_state``,
``abstract_train_state`` (on the ``meta`` device) and
``train_state_shardings``.  Serving: the fused prefill and end-aligned
decode step, the paged decode step and the chunked-prefill step, which
write the cache in place (the returned cache is the same list).

Under a mesh ctx a step runs inside one rank (``core.mesh.launch``) on its
blocks of the state (``train_state_shardings``) and its batch rows.  Where
GSPMD reduces the gradients of the reference's step, the port does: each
leaf's gradient is summed over the batch axes its spec does not already
split (an FSDP leaf's was reduce-scattered by its gather's transpose), by
an all-reduce, or, in the ZeRO step, by a reduce-scatter onto the leaf's
``scatter_specs`` layout.  The loss is a vocab-parallel cross-entropy when
the logits are split over ``model``.

A serve step built with a ctx runs inside one rank too: it takes the
global token, position and block-table rows (every rank the same), cuts
them to the rank's batch rows, runs the model on its cache blocks
(``models/transformer.py``) and gathers the logits over the vocabulary and
the batch axes, so every rank returns the same global logits (or greedy
tokens).  An enc-dec prefill returns the encoder output gathered likewise.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch.config import ModelConfig, ParallelConfig, TrainConfig, torch_dtype
from repro_torch.core.dseq import all_gather_dim, reduce_sum
from repro_torch.core.mesh import local_block
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe import MeshCtx
from repro_torch.optim.adamw import scatter_part
from repro_torch.parallel.sharding import opt_specs, param_specs, scatter_specs
from repro_torch.tree import leaves, leaves_with_path, tree_map, tree_unflatten

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
    return _cross_entropy_sum(logits, labels, z_loss=z_loss, chunk=chunk, axis=None,
                              mesh=None) / labels.numel()


def _lse_and_picked_split(lg: torch.Tensor, lb: torch.Tensor, axis, mesh):
    """``_lse_and_picked`` over logits whose vocabulary is split over
    ``axis`` (this rank holds the columns ``[i * V_loc, (i + 1) * V_loc)``):
    the row max, the sum of exponentials and the picked logit are each
    ``reduceD``'d over the axis.  The max is a constant shift (its gradient
    terms cancel exactly), so it carries none."""
    lg = lg.float()
    m = mesh.all_reduce(torch.amax(lg, dim=-1, keepdim=True).detach(), "max", axis)
    lse = torch.log(reduce_sum(torch.sum(torch.exp(lg - m), dim=-1), axis, mesh)) + m[..., 0]
    n = lg.shape[-1]
    t = lb.long() - mesh.index(axis) * n
    inside = (t >= 0) & (t < n)
    picked = torch.gather(lg, -1, torch.where(inside, t, 0)[..., None])[..., 0]
    return lse, reduce_sum(torch.where(inside, picked, 0.0), axis, mesh)


def _cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor, *, z_loss: float,
                       chunk: Optional[int], axis, mesh) -> torch.Tensor:
    """``cross_entropy``'s token sum (not the mean) over this rank's rows,
    the vocabulary split over ``axis`` (or whole, with ``axis`` None)."""
    def lse_picked(lg, lb):
        if axis is None:
            return _lse_and_picked(lg, lb)
        return _lse_and_picked_split(lg, lb, axis, mesh)

    if chunk is None:
        lse, picked = lse_picked(logits, labels)
        loss = lse - picked
        if z_loss:
            loss = loss + z_loss * lse ** 2
        return torch.sum(loss)
    s = labels.shape[1]
    pad = (-s) % chunk
    if pad:
        logits = torch.nn.functional.pad(logits, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for lo in range(0, s + pad, chunk):
        lbc = labels[:, lo:lo + chunk]
        lse, picked = lse_picked(logits[:, lo:lo + chunk], lbc)
        total = total + torch.sum((lse - picked) * (lbc >= 0).float())
    return total


def make_loss_fn(cfg: ModelConfig, pcfg: ParallelConfig, tcfg: TrainConfig,
                 ctx: Optional[MeshCtx] = None) -> Callable:
    """``loss_fn(params, batch) -> (loss, {"loss", "aux"})``: next-token CE
    over ``batch["tokens"]`` plus ``1e-2 * aux``, the MoE layers'
    load-balance loss (an f32 0 for the other families, reported as JAX
    reports it).  An enc-dec model reads ``batch["frames"]`` (B, T, d) too.

    Under a ctx: this rank's rows and blocks; the CE is vocab-parallel
    when the logits are split over ``model`` (the reference constrains them
    to ``P(batch, None, 'model')``), each rank's token sum is divided by the
    global token count and ``reduceD("sum")``'d over the batch axes, so
    every rank holds the global token mean, as in JAX."""
    vaxis = L.vocab_axis(cfg, ctx)

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        if cfg.enc_dec:
            logits, aux = E.forward(params, batch["frames"], tokens, cfg, remat=pcfg.remat,
                                    ctx=ctx)
        else:
            logits, aux = T.forward(params, tokens, cfg, ctx=ctx, remat=pcfg.remat,
                                    return_aux=True)
        if ctx is None:
            loss = cross_entropy(logits[:, :-1], tokens[:, 1:], z_loss=tcfg.z_loss,
                                 chunk=pcfg.logit_chunk)
        else:
            mesh = ctx.mesh
            b, s = tokens.shape
            total = _cross_entropy_sum(logits[:, :-1], tokens[:, 1:], z_loss=tcfg.z_loss,
                                       chunk=pcfg.logit_chunk, axis=vaxis, mesh=mesh)
            n = b * mesh.size(ctx.batch_axes) * (s - 1)
            loss = reduce_sum(total / n, ctx.batch_axes, mesh)
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
    ``transformer.decay_mask``).  ``grad_reduce="reduce_scatter_zero"``
    dispatches to ``make_train_step_zero`` under a ctx; without one it warns
    and takes this step, as JAX's does.  Under a ctx: ``_make_mesh_step``."""
    if pcfg.grad_reduce == "reduce_scatter_zero":
        if ctx is not None:
            return make_train_step_zero(cfg, pcfg, tcfg, ctx)
        warnings.warn("grad_reduce='reduce_scatter_zero' needs a mesh ctx; "
                      "falling back to the single-device all-reduce step",
                      stacklevel=2)
    if ctx is not None:
        return _make_mesh_step(cfg, pcfg, tcfg, ctx, zero=False)
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


def make_train_step_zero(cfg: ModelConfig, pcfg: ParallelConfig, tcfg: TrainConfig,
                         ctx: MeshCtx) -> Callable:
    """ZeRO train step: grads reduce-scattered over the fsdp (else the
    batch) axes onto ``scatter_specs``, AdamW updating only the rank's
    shard (moments and master copy stored so), params all-gathered for the
    next forward (``optim.adamw_update_zero``).  Loss, grads and clip are
    the all-reduce step's, so the trajectories coincide; only the
    optimizer segment's layout, and its communication, differ."""
    if ctx is None:
        raise ValueError("make_train_step_zero needs a mesh ctx to scatter "
                         "over; use make_train_step on a single device")
    return _make_mesh_step(cfg, pcfg, tcfg, ctx, zero=True)


def _axes_of(spec) -> tuple:
    """The mesh axes a spec names, in its order."""
    out = []
    for part in spec:
        out += [] if part is None else list(part if isinstance(part, tuple) else (part,))
    return tuple(out)


def _reduce_grad(g: torch.Tensor, pspec, sspec, ctx: MeshCtx) -> torch.Tensor:
    """Sum one leaf's gradient block over the batch axes its parameter spec
    does not split: a reduce-scatter onto ``sspec`` along the dim the
    scatter layout adds, an all-reduce over the rest."""
    mesh = ctx.mesh
    done = set(_axes_of(pspec))
    for d, part in enumerate(scatter_part(sspec, pspec)):
        if part is not None:
            g = mesh.reduce_scatter_sum(g.movedim(d, 0), part).movedim(0, d)
            done.update(_axes_of((part,)))
    rest = tuple(a for a in mesh.axis_names if a in ctx.batch_axes and a not in done)
    return mesh.all_reduce(g, "sum", rest) if rest else g


def _sharded_norm(grads: list, specs: list, mesh) -> torch.Tensor:
    """The global norm of a tree whose leaves are this rank's blocks under
    ``specs``: each leaf's squared sum is summed over the axes that split
    it (one all-reduce per distinct set of axes), then added up in leaf
    order, as ``optim.global_norm`` does."""
    sq = [torch.sum(g.float() ** 2) for g in grads]
    groups = {}
    for i, spec in enumerate(specs):
        axes = tuple(a for a in mesh.axis_names if a in _axes_of(spec))
        groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        if axes:
            summed = mesh.all_reduce(torch.stack([sq[i] for i in idx]), "sum", axes)
            for j, i in enumerate(idx):
                sq[i] = summed[j]
    total = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    for v in sq:
        total = total + v
    return torch.sqrt(total)


def _make_mesh_step(cfg: ModelConfig, pcfg: ParallelConfig, tcfg: TrainConfig,
                    ctx: MeshCtx, *, zero: bool) -> Callable:
    """The train step inside one rank of ``ctx.mesh``: loss and grads on the
    rank's blocks, each gradient summed over the batch axes
    (``_reduce_grad``) and cast to ``pcfg.grad_dtype``, clipped by the
    global norm, then
    AdamW on the parameters' layout, or, with ``zero``, on the scatter
    layout (``adamw_update_zero``).  Every rank issues the same collectives
    in the same order: the forward's, the backward's (a leaf with no use
    gets a zero gradient and is reduced like the others), the reduction's
    and the update's."""
    mesh = ctx.mesh
    meta = (E.init if cfg.enc_dec else T.init)(cfg, None)
    pspec_tree = param_specs(meta, cfg, ctx)
    sspec_tree = scatter_specs(meta, cfg, ctx) if zero else pspec_tree
    pspecs, sspecs = leaves(pspec_tree), leaves(sspec_tree)
    loss_fn = make_loss_fn(cfg, pcfg, tcfg, ctx)
    grad_dt = torch_dtype(pcfg.grad_dtype)

    def train_step(state: Tree, batch: Tree) -> Tuple[Tree, dict]:
        params = state["params"]
        with mesh:
            live = [p.detach().requires_grad_(True) for p in leaves(params)]
            with torch.enable_grad():
                loss, metrics = loss_fn(tree_unflatten(params, live), batch)
                grads = list(torch.autograd.grad(loss, live, allow_unused=True,
                                                 materialize_grads=True))
            del live
            for i, (ps, ss) in enumerate(zip(pspecs, sspecs)):
                # summed in autograd's dtype, then cast, as the reference's
                # gradients are reduced inside its backward pass
                grads[i] = _reduce_grad(grads[i], ps, ss, ctx).to(grad_dt)
            norm = _sharded_norm(grads, sspecs, mesh)
            grads, gnorm = optim.clip_by_global_norm(tree_unflatten(params, grads),
                                                     tcfg.grad_clip, norm=norm)
            lr = optim.warmup_cosine(state["opt"]["step"], lr=tcfg.lr,
                                     warmup_steps=tcfg.warmup_steps,
                                     total_steps=tcfg.total_steps)
            kw = dict(lr=lr, b1=tcfg.b1, b2=tcfg.b2, weight_decay=tcfg.weight_decay,
                      decay=T.decay_mask(params))
            if zero:
                params, opt_state = optim.adamw_update_zero(
                    grads, state["opt"], params, scatter=sspec_tree, gather=pspec_tree,
                    mesh=mesh, **kw)
            else:
                params, opt_state = optim.adamw_update(grads, state["opt"], params, **kw)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_norm=gnorm, lr=lr)
        return {"params": params, "opt": opt_state}, metrics

    return train_step


def init_train_state(generator: Optional[torch.Generator], cfg: ModelConfig,
                     pcfg: ParallelConfig, ctx: Optional[MeshCtx] = None) -> Tree:
    """``{"params", "opt"}`` on ``generator``'s device (``None``: the
    ``meta`` device).  With ``pcfg.master_weights`` the parameters are
    stored in bf16 and the optimizer keeps their f32 master copy.

    Under a ctx: this rank's blocks of the same state, laid out by
    ``train_state_shardings``.  The parameters are drawn group by group in
    the single-rank order, and each leaf is cut to its block as soon as it
    is drawn, so a rank never holds the whole tree; assembled, the blocks
    are the single-rank state, leaf for leaf."""
    if ctx is None:
        params = (E.init if cfg.enc_dec else T.init)(cfg, generator)
        opt_params = params
    else:
        specs = train_state_shardings(cfg, pcfg, ctx, abstract_train_state(cfg, pcfg))
        by_path = dict(leaves_with_path(specs["params"]))
        params = (E.init if cfg.enc_dec else T.init)(cfg, generator, shard=lambda path, leaf:
                                                     local_block(leaf, by_path[path],
                                                                 ctx.mesh).clone())
        # the moments (and master copy) live in their own layout: the rank's
        # part of its parameter block (all of it but under ZeRO)
        opt_params = tree_map(lambda p, ps, ms: local_block(p, scatter_part(ms, ps), ctx.mesh),
                              params, specs["params"], specs["opt"]["m"])
    opt = optim.adamw_init(opt_params, pcfg.opt_state_dtype, master=pcfg.master_weights)
    if pcfg.master_weights:
        params = tree_map(lambda p: p.to(torch.bfloat16), params)
    return {"params": params, "opt": opt}


def abstract_train_state(cfg: ModelConfig, pcfg: ParallelConfig) -> Tree:
    """The train state's structure, shapes and dtypes on the ``meta``
    device (no memory): the ``like`` tree of ``restore_checkpoint``."""
    return init_train_state(None, cfg, pcfg)


def train_state_shardings(cfg: ModelConfig, pcfg: ParallelConfig, ctx: MeshCtx,
                          state: Tree) -> Tree:
    """The spec tree of a train state (global ``state``, e.g.
    ``abstract_train_state``): the parameters' ``param_specs``; m, v and
    the master copy in ``scatter_specs`` under ZeRO, else the parameters';
    the step replicated.  A spec is the placement (JAX returns
    ``NamedSharding``s)."""
    pspec = param_specs(state["params"], cfg, ctx)
    sspec = scatter_specs(state["params"], cfg, ctx) \
        if pcfg.grad_reduce == "reduce_scatter_zero" else None
    ospec = opt_specs(pspec, sspec)
    if "master" in state["opt"]:
        ospec["master"] = sspec if sspec is not None else pspec
    return {"params": pspec, "opt": ospec}



# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------
def local_rows(t, ctx: Optional[MeshCtx]):
    """The rank's block of the leading (batch) dim of a global ``t`` (a
    tensor; anything else passes), split over the ctx's batch axes."""
    if ctx is None or not torch.is_tensor(t) or t.dim() == 0 or not ctx.batch_axes:
        return t
    n = ctx.mesh.size(ctx.batch_axes)
    if t.shape[0] % n:
        raise ValueError(f"batch {t.shape[0]} does not split {n} ways over "
                         f"{ctx.batch_axes}")
    rows = t.shape[0] // n
    return t.narrow(0, ctx.mesh.index(ctx.batch_axes) * rows, rows)


def global_rows(t: torch.Tensor, ctx: MeshCtx, cfg: Optional[ModelConfig] = None
                ) -> torch.Tensor:
    """The inverse of ``local_rows`` (every rank gets the global value);
    with ``cfg``, ``t`` is a logits block whose vocabulary may be split
    over ``model`` too, and is gathered there first."""
    mesh = ctx.mesh
    vaxis = L.vocab_axis(cfg, ctx) if cfg is not None else None
    if vaxis is not None:
        t = all_gather_dim(t, vaxis, -1, mesh)
    if ctx.batch_axes:
        t = all_gather_dim(t, ctx.batch_axes, 0, mesh)
    return t


def _in_ctx(ctx: Optional[MeshCtx]):
    return ctx.mesh if ctx is not None else contextlib.nullcontext()


def make_prefill_step(cfg: ModelConfig, ctx: Optional[MeshCtx] = None) -> Callable:
    """Fused prefill ``(params, batch, cache) -> (last_logits (B, V),
    cache)``: one cache-writing full-sequence forward per prompt.  ``batch``
    holds ``tokens`` (B, S) and may hold ``length``, the per-row true prompt
    lengths of right-padded prompts (pad entries are causally invisible).
    An enc-dec model encodes ``batch["frames"]`` first and returns
    ``(last_logits, cache, encoder output)``: the decode steps need it.
    ``ctx``: the module docstring (``cache`` is the rank's blocks)."""

    @torch.no_grad()
    def prefill(params, batch, cache):
        b = {k: local_rows(v, ctx) for k, v in batch.items()}
        with _in_ctx(ctx):
            length = b.get("length")
            if cfg.enc_dec:
                enc = E.encode(params, b["frames"], cfg, ctx=ctx)
                logits, cache = E.decode_prefill(params, b["tokens"], enc, cache, cfg,
                                                 length=length, ctx=ctx)
                if ctx is None:
                    return logits, cache, enc
                return global_rows(logits, ctx, cfg), cache, global_rows(enc, ctx)
            logits, cache = T.prefill(params, b["tokens"], cache, cfg, length=length, ctx=ctx)
            return (logits if ctx is None else global_rows(logits, ctx, cfg)), cache

    return prefill


def make_decode_step(cfg: ModelConfig, *, return_logits: bool = False,
                     paged: bool = False, ctx: Optional[MeshCtx] = None) -> Callable:
    """Decode step: greedy int32 tokens by default, or the f32 logits with
    ``return_logits`` so the scheduler can sample.  ``paged`` selects the
    step's form: ``(params, tok, cache, pos, block_tables)`` over the shared
    page arena, or, with ``paged=False``, the end-aligned ``(params, tok,
    cache, pos)`` over per-slot cache rows; an enc-dec model's step takes
    the encoder output after ``pos``.  ``ctx``: the module docstring."""
    if paged and cfg.enc_dec:
        raise NotImplementedError("paged decode is decoder-only")

    def _out(logit):
        if ctx is not None:
            logit = global_rows(logit, ctx, cfg)
        if return_logits:
            return logit.float()
        return torch.argmax(logit, dim=-1).to(torch.int32)

    @torch.no_grad()
    def decode(params, token, cache, pos, enc_out=None):
        token, pos, enc_out = (local_rows(t, ctx) for t in (token, pos, enc_out))
        with _in_ctx(ctx):
            if cfg.enc_dec:
                logit, cache = E.decode_step(params, token, cache, pos, enc_out, cfg, ctx=ctx)
            else:
                logit, cache = T.decode_step(params, token, cache, pos, cfg, ctx=ctx)
            return _out(logit), cache

    @torch.no_grad()
    def decode_paged(params, token, cache, pos, block_tables):
        token, pos, block_tables = (local_rows(t, ctx) for t in (token, pos, block_tables))
        with _in_ctx(ctx):
            logit, cache = T.decode_step(params, token, cache, pos, cfg,
                                         block_tables=block_tables, ctx=ctx)
            return _out(logit), cache

    return decode_paged if paged else decode


def make_chunk_prefill_step(cfg: ModelConfig, ctx: Optional[MeshCtx] = None) -> Callable:
    """Chunked-prefill step ``(params, tokens (1, chunk), cache, pos0,
    block_tables (1, P), length) -> (last_logits (1, V), cache)``: one
    fixed-shape slice of one request's prompt per call
    (``models.transformer.prefill_paged``).  ``ctx``: the module docstring
    (its batch axes must divide 1: ``launch.specs.restrict_batch``)."""
    if cfg.enc_dec:
        raise NotImplementedError("chunked prefill is decoder-only")

    @torch.no_grad()
    def chunk_prefill(params, tokens, cache, pos0, block_tables, length):
        tokens, block_tables = local_rows(tokens, ctx), local_rows(block_tables, ctx)
        with _in_ctx(ctx):
            logits, cache = T.prefill_paged(params, tokens, cache, cfg, pos0=pos0,
                                            block_tables=block_tables, length=length,
                                            ctx=ctx)
            return (logits if ctx is None else global_rows(logits, ctx, cfg)), cache

    return chunk_prefill
