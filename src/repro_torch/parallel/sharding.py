"""Sharding rules: parameter name -> partition spec, driven by the Table-1
cost model's layout conventions (DP/FSDP over 'data' (+'pod'), TP/EP over
'model'); the port of the JAX package's ``parallel/sharding.py``.

Rules are path-based: the last path components of each leaf select a template.
Templates use the symbols:
  IN   (d_in, d_out) weight:  P(fsdp, 'model')   -- column-parallel
  OUT  (d_out, d_in) weight:  P('model', fsdp)   -- row-parallel
  EP_IN/EP_OUT             : expert tensors (layout depends on n_experts vs ep)
  REP                      : replicated
A stacked leaf gets leading ``None``s by rank.  The port's layers are
unstacked, so a layer leaf's spec is the JAX spec without its leading None.

Specs are ``core.mesh.P``.  A spec *is* the placement: ``shard_params``
keeps each rank's ``core.mesh.local_block`` of every leaf under its spec,
so there is no ``to_shardings``.
"""
from __future__ import annotations

import warnings
from typing import Any, Optional, Tuple

from repro_torch.config import ModelConfig
from repro_torch.core.mesh import AbstractMesh, P, ProcessMesh, assemble, local_block
from repro_torch.models.moe import MeshCtx
from repro_torch.tree import leaves_with_path, tree_map, tree_unflatten

Tree = Any


def make_ctx(mesh: AbstractMesh, parallel) -> MeshCtx:
    """MeshCtx from a layout -- a ``ParallelConfig`` or a first-class
    ``planner.ParallelPlan`` (bridged via ``to_pcfg``).  On a
    ``ProcessMesh`` the groups of the batch and FSDP axes are created here,
    on every rank at the same point."""
    if hasattr(parallel, "to_pcfg"):
        parallel = parallel.to_pcfg()
    axes = mesh.axis_names
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    if parallel.dp_over_model:
        batch_axes += ("model",)
    fsdp: Tuple[str, ...] = ()
    if parallel.fsdp_params:
        fsdp = ("data",)
        if parallel.fsdp_pod and "pod" in axes:
            fsdp = ("pod", "data")
    if isinstance(mesh, ProcessMesh):
        mesh.make_groups(batch_axes, fsdp)
    return MeshCtx(mesh=mesh, batch_axes=batch_axes, model_axis="model",
                   fsdp_axes=fsdp, moe_a2a_ep=parallel.moe_a2a_ep,
                   engine_replicate=parallel.engine_replicate,
                   seq_parallel=parallel.sequence_parallel,
                   foopar_tp=parallel.use_foopar_tp,
                   manual_attention=parallel.manual_attention,
                   dp_over_model=parallel.dp_over_model)


def batch_spec(ctx: MeshCtx, ndim: int, batch_dim: int = 0) -> P:
    parts = [None] * ndim
    parts[batch_dim] = ctx.batch_axes
    return P(*parts)


# ---------------------------------------------------------------------------
# rule table
# ---------------------------------------------------------------------------
_IN_NAMES = {"wq", "wk", "wv", "w_gate", "w_up", "up_proj", "w_in", "in_proj",
             "w_gates", "unembed"}
_OUT_NAMES = {"wo", "w_down", "down_proj", "out_proj", "proj"}
_REP_NAMES = {"scale", "bias", "router", "A_log", "D", "dt_bias",
              "enc_pos", "dec_pos"}


def _leaf_spec(path: Tuple[str, ...], ndim: int, cfg: ModelConfig, ctx: MeshCtx,
               use_ep: bool) -> P:
    name = path[-1]
    parents = set(path[:-1])
    fsdp = ctx.fsdp_axes if ctx.fsdp_axes else None
    model = ctx.model_axis

    def with_stack(spec_dims):
        pad = ndim - len(spec_dims)
        return P(*([None] * pad + spec_dims))

    if "shared" in parents:  # MoE shared expert: must match moe_ffn in_specs
        if name in ("w_gate", "w_up"):
            return with_stack([None, model])
        if name == "w_down":
            return with_stack([model, None])

    if "moe" in parents and name in ("w_gate", "w_up", "w_down"):
        if ctx.moe_a2a_ep:
            if name == "w_down":                    # (E, ff, d)
                return with_stack(["data", model, None])
            return with_stack(["data", None, model])  # (E, d, ff)
        if use_ep:
            if name == "w_down":                    # (E, ff, d)
                return with_stack([model, None, fsdp])
            return with_stack([model, fsdp, None])  # (E, d, ff)
        else:
            if name == "w_down":
                return with_stack([None, model, fsdp])
            return with_stack([None, fsdp, model])

    if ctx.engine_replicate and parents & {"mlstm", "slstm", "mamba"}:
        # recurrent blocks run batch-parallel only: weights keep FSDP
        # storage sharding but no TP (local matmuls, zero act collectives)
        if name in _IN_NAMES | {"conv_w"}:
            return with_stack([fsdp, None] if name != "conv_w" else [None, None])
        if name in _OUT_NAMES:
            return with_stack([None, fsdp])
        return P(*([None] * ndim))

    if name == "embedding":                          # (V, d)
        return with_stack([model, fsdp])
    if name == "conv_w":                             # (W, C)
        return with_stack([None, model])
    if name in _REP_NAMES:
        return P(*([None] * ndim))
    if name == "wq" and "mlstm" in parents:
        return with_stack([fsdp, model])
    if name in _IN_NAMES:
        return with_stack([fsdp, model])
    if name in _OUT_NAMES:
        return with_stack([model, fsdp])
    # default: replicate (and surface it for review)
    return P(*([None] * ndim))


# Partitions silently dropped by ``sanitize_spec`` make the realized layout
# diverge from what the rule table (and the planner's cost predictions)
# assumed -- so every drop is counted here and surfaced: once as a warning,
# and in full in ``dropped_partition_report``.
_DROPPED: dict = {}
_WARNED = [False]


def reset_dropped_partitions() -> None:
    _DROPPED.clear()


def dropped_partition_report() -> list:
    """Partitions dropped since the last reset: one record per (leaf, dim)
    whose rule-table axes didn't divide the dim."""
    return [dict(leaf=k[0], dim=k[1], **v) for k, v in sorted(_DROPPED.items())]


def sanitize_spec(spec: P, shape: Tuple[int, ...], mesh: AbstractMesh,
                  path: Optional[str] = None, *, record: bool = True) -> P:
    """Drop partitions on dims the mesh axes don't divide evenly (a block
    must be a whole slice).  Each drop is recorded (warn once + the report)
    so planner predictions can't silently diverge from the realized layout;
    ``record=False`` computes the spec without recording."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for i, (dim, part) in enumerate(zip(shape, parts)):
        if part is None:
            out.append(None)
            continue
        axes = part if isinstance(part, tuple) else (part,)
        size = 1
        for a in axes:
            size *= mesh.size(a)
        if dim % size == 0:
            out.append(part)
            continue
        out.append(None)
        if not record:
            continue
        _DROPPED[(path or "<anon>", i)] = {
            "shape": tuple(shape), "axes": tuple(axes), "shard": size}
        if not _WARNED[0]:
            _WARNED[0] = True
            warnings.warn(
                f"sharding: dropped partition {axes} on dim {i} of "
                f"{path or shape} ({dim} % {size} != 0) -- the leaf stays "
                "replicated on that dim; see dropped_partition_report() "
                "for the full list", stacklevel=2)
    return P(*out)


def _use_ep(cfg: ModelConfig, ctx: MeshCtx) -> bool:
    return bool(cfg.moe) and cfg.moe.n_experts % ctx.model_size == 0 \
        and cfg.moe.n_experts >= ctx.model_size


def _strip_model(spec: P, ctx: MeshCtx) -> P:
    if not ctx.dp_over_model:
        return spec
    parts = []
    for part in spec:
        if part == ctx.model_axis:
            parts.append(None)
        elif isinstance(part, tuple):
            parts.append(tuple(a for a in part if a != ctx.model_axis) or None)
        else:
            parts.append(part)
    return P(*parts)


def leaf_spec(names: Tuple[str, ...], shape: Tuple[int, ...], cfg: ModelConfig,
              ctx: MeshCtx, *, record: bool = False) -> P:
    """One leaf's spec, as ``param_specs`` gives it, from its path names
    and global shape (the model layers ask this of their weights)."""
    spec = _strip_model(_leaf_spec(names, len(shape), cfg, ctx, _use_ep(cfg, ctx)), ctx)
    return sanitize_spec(spec, tuple(shape), ctx.mesh, path="/".join(names), record=record)


def param_specs(params: Tree, cfg: ModelConfig, ctx: MeshCtx) -> Tree:
    """Spec tree mirroring ``params`` (global leaves: real or ``meta``
    tensors, or anything with a ``shape``)."""
    pairs = leaves_with_path(params)
    return tree_unflatten(params, [leaf_spec(tuple(map(str, path)), tuple(leaf.shape), cfg,
                                             ctx, record=True) for path, leaf in pairs])


def scatter_specs(params: Tree, cfg: ModelConfig, ctx: MeshCtx) -> Tree:
    """ZeRO grad/optimizer layout: each leaf's param spec with the scatter
    axes (the fsdp axes, else the batch axes -- the grad-reduction group,
    which includes 'model' under dp_over_model) added on the first free dim
    they divide.  Leaves already sharded over a scatter axis (FSDP param
    storage) and leaves with no divisible free dim keep their param spec --
    those gradients stay all-reduced."""
    axes = ctx.fsdp_axes or ctx.batch_axes
    base = param_specs(params, cfg, ctx)
    if not axes:
        return base
    size = 1
    for a in axes:
        size *= ctx.mesh.size(a)
    part = axes if len(axes) > 1 else axes[0]

    def scatter(spec, leaf):
        shape = tuple(leaf.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        used = set()
        for p_ in parts:
            used.update(p_ if isinstance(p_, tuple) else (p_,))
        if used & set(axes):
            return spec                      # FSDP already scatters this leaf
        for i, (dim, p_) in enumerate(zip(shape, parts)):
            if p_ is None and dim % size == 0 and dim >= size:
                parts[i] = part
                return P(*parts)
        return spec

    return tree_map(scatter, base, params)


def shard_params(params: Tree, cfg: ModelConfig, ctx: MeshCtx) -> Tree:
    """This rank's block of every leaf under the rules (views of the global
    leaves: ``core.mesh.local_block``)."""
    return tree_map(lambda x, s: local_block(x, s, ctx.mesh), params,
                    param_specs(params, cfg, ctx))


def shard_cache(cache: Tree, cfg: ModelConfig, ctx: MeshCtx) -> Tree:
    """This rank's block of every leaf of a whole end-aligned decode cache
    under ``launch.specs.cache_specs`` (copies: the layers write caches in
    place), each tagged with its spec (``launch.specs.keep_spec``)."""
    from repro_torch.launch.specs import cache_specs, keep_spec
    return tree_map(lambda x, s: keep_spec(local_block(x, s, ctx.mesh).clone(), s), cache,
                    cache_specs(cfg, ctx, cache))


def gather_cache(cache: Tree, cfg: ModelConfig, ctx: MeshCtx, like: Tree) -> Tree:
    """The inverse of ``shard_cache``: every rank gets the whole cache of
    the rank blocks ``cache`` (``like``: the whole cache's shapes, ``meta``
    tensors will do).  Collective over the mesh."""
    from repro_torch.launch.specs import cache_specs
    return tree_map(lambda x, s: assemble(x, s, ctx.mesh), cache, cache_specs(cfg, ctx, like))


def opt_specs(param_spec_tree: Tree, scatter_spec_tree: Optional[Tree] = None) -> Tree:
    """Optimizer state specs: m/v mirror params -- or, under the ZeRO
    reduce-scatter strategy, the ``scatter_specs`` layout (each rank keeps
    only the moment shard it updates); step replicated."""
    sp = scatter_spec_tree if scatter_spec_tree is not None else param_spec_tree
    return {"m": sp, "v": sp, "step": P()}
