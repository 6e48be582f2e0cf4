"""The layout of a serving cell: the port of two functions of the JAX
package's ``launch/specs.py``.

  * ``make_cell_ctx``: the ``MeshCtx`` of a cell, its batch axes cut to
    those that divide the cell's global batch (a B=1 prefill runs
    batch-replicated, the model axis carrying all the parallelism);
  * ``cache_specs``: the placement of every leaf of a decode cache --
    batch over the batch axes, and over ``model``, where it divides: an
    attention cache's length, the Mamba2 conv window's channels and SSM
    state's heads, the mLSTM state's heads and the sLSTM state's channels.

The port's caches are unstacked (``models/transformer.py``: one entry per
layer), so a leaf's spec is JAX's without the leading None of the stacked
periods dim.  A paged cache has no spec here: its page arenas are
replicated on every rank (the reference sets no constraint on them).

Which leaf splits on which dim is decided here only: ``block_shapes``
gives the rank's block of every leaf (``models/transformer.py`` builds its
caches from it), and the recurrent blocks read a state's split from the
block they are given.  ``build_cell`` and the abstract inputs of the dry
run are not ported (ROADMAP queue 1, the XLA tooling).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.config import ModelConfig
from repro_torch.core.mesh import AbstractMesh, P
from repro_torch.models.moe import MeshCtx
from repro_torch.parallel.sharding import make_ctx
from repro_torch.tree import leaves_with_path, tree_unflatten

Tree = Any


def restrict_batch(ctx: MeshCtx, global_batch: int) -> MeshCtx:
    """``ctx`` with its batch axes cut to those, in order, whose running
    product divides ``global_batch``."""
    axes: Tuple[str, ...] = ()
    prod = 1
    for a in ctx.batch_axes:
        if global_batch % (prod * ctx.mesh.size(a)) == 0:
            axes += (a,)
            prod *= ctx.mesh.size(a)
    return dataclasses.replace(ctx, batch_axes=axes)


def make_cell_ctx(mesh: AbstractMesh, pcfg, global_batch: int) -> MeshCtx:
    """MeshCtx whose batch axes are restricted to those that divide the
    global batch (B=1 long-decode: batch replicated, the model axis carries
    all the parallelism)."""
    return restrict_batch(make_ctx(mesh, pcfg), global_batch)


def _div(n: int, size: int, axis: str) -> Optional[str]:
    return axis if n % size == 0 else None


def _model_dim(names) -> int:
    """The dim of a cache leaf (path ``names``) that ``model`` splits where
    it divides: the Mamba2 conv window's channels (B, W-1, C); else dim 1,
    the heads of a recurrent state (Mamba2, mLSTM), the sLSTM's channels and
    an attention cache's length (B, L, Hkv, hd)."""
    return 2 if "mamba" in names and "conv" in names else 1


def _attends(names) -> bool:
    """True for an attention cache's K or V (of an attention layer, of
    Zamba2's ``shared_attn`` or of an enc-dec decoder layer)."""
    return not names & {"mamba", "mlstm", "slstm"}


def _leaf_spec(names, shape, ctx: MeshCtx) -> P:
    parts: list = [None] * len(shape)
    if parts:
        parts[0] = ctx.batch_axes if ctx.batch_axes else None
    dim = _model_dim(names)
    parts[dim] = _div(shape[dim], ctx.model_size, ctx.model_axis)
    return P(*parts)


def cache_specs(cfg: ModelConfig, ctx: MeshCtx, cache: Tree) -> Tree:
    """Spec tree of an end-aligned decode cache (global shapes: real or
    ``meta`` tensors, or anything with a ``shape``), mirroring ``cache``:
    a (K, V) pair of an attention layer (or of Zamba2's ``shared_attn``,
    or of an enc-dec decoder layer) splits its length over ``model``."""
    pairs = leaves_with_path(cache)
    return tree_unflatten(cache, [_leaf_spec({str(k) for k in path}, tuple(leaf.shape), ctx)
                                  for path, leaf in pairs])


def block_shapes(cfg: ModelConfig, ctx: MeshCtx, cache: Tree) -> list:
    """This rank's block shape of every leaf of ``cache`` (global shapes),
    in ``leaves_with_path`` order, under ``cache_specs``.  An attention
    cache's length must split over ``model`` (the layers read their slots'
    offset from the split); a recurrent leaf whose heads or channels do not
    split stays whole."""
    out = []
    for path, leaf in leaves_with_path(cache):
        names = {str(k) for k in path}
        spec = _leaf_spec(names, tuple(leaf.shape), ctx)
        if _attends(names) and spec[1] is None and ctx.model_size > 1:
            raise ValueError(f"cache leaf {path} {tuple(leaf.shape)}: its length does not "
                             f"split {ctx.model_size} ways over {ctx.model_axis!r}")
        out.append(block_shape(leaf.shape, spec, ctx.mesh))
    return out


def block_shape(shape, spec, mesh: AbstractMesh) -> Tuple[int, ...]:
    """The local block's shape of a leaf of global ``shape`` under ``spec``."""
    out = list(shape)
    for d, part in enumerate(spec):
        if part is not None:
            n = mesh.size(part)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split {n} ways over "
                                 f"{part!r}")
            out[d] //= n
    return tuple(out)
