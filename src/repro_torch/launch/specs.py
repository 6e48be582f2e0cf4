"""The layout of every (architecture x input shape) cell: the port of the
JAX package's ``launch/specs.py``.

  * ``make_cell_ctx``: the ``MeshCtx`` of a cell, its batch axes cut to
    those that divide the cell's global batch (a B=1 prefill runs
    batch-replicated, the model axis carrying all the parallelism);
  * ``cache_specs``: the placement of every leaf of a decode cache --
    batch over the batch axes, and over ``model``, where it divides: an
    attention cache's length, the Mamba2 conv window's channels and SSM
    state's heads, the mLSTM state's heads and the sLSTM state's channels.
    A leaf whose dim ``model`` does not divide is held whole on every rank,
    as GSPMD holds JAX's;
  * ``Cell`` / ``abstract_cache`` / ``build_cell``: the dry run's data
    layer -- a cell's inputs as ``meta`` tensors (shapes and dtypes, no
    storage: JAX's ``ShapeDtypeStruct``) and their specs.  Nothing here
    allocates.  Modality frontends are stubs: Whisper gets (B, 1500,
    d_model) frame embeddings, Chameleon VQ token ids (they live in the
    text vocabulary).

The port's caches are unstacked (``models/transformer.py``: one entry per
layer), so a leaf's spec is JAX's without the leading None of the stacked
periods dim.  A paged cache has no spec here: its page arenas are
replicated on every rank (the reference sets no constraint on them).  A
spec *is* the placement (``parallel/sharding.py``), so a cell's shardings
are spec trees on the mesh -- an ``AbstractMesh`` needs no process.

Which leaf splits on which dim is decided here only: ``block_layouts``
gives the rank's block of every leaf (``models/transformer.py`` builds its
caches from it) and ``keep_spec`` tags each block with its spec, as a JAX
array carries its sharding; the attention layers read an attention
cache's slots from the tag (``kv_slots``: split over ``model``, or whole on
every rank), and the recurrent blocks read a state's split from the block
they are given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core.mesh import AbstractMesh, P
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.encdec import ENC_LEN
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
    or of an enc-dec decoder layer) splits its length over ``model`` where
    ``model`` divides it, else stays whole (JAX's ``_div``).  A config with
    per-layer windows (``layer_windows``) has no layout on a mesh."""
    if cfg.layer_windows is not None:
        raise NotImplementedError(f"{cfg.name}: per-layer attention windows (layer_windows) "
                                  f"have no cache layout on a mesh")
    pairs = leaves_with_path(cache)
    return tree_unflatten(cache, [_leaf_spec({str(k) for k in path}, tuple(leaf.shape), ctx)
                                  for path, leaf in pairs])


def block_layouts(cfg: ModelConfig, ctx: MeshCtx, cache: Tree) -> List[Tuple[P, tuple]]:
    """(spec, this rank's block shape) of every leaf of ``cache`` (global
    shapes), in ``leaves_with_path`` order, under ``cache_specs``: a leaf
    whose dim ``model`` does not divide (an attention cache's length, a
    recurrent state's heads or channels) is whole on every rank."""
    return [(spec, block_shape(leaf.shape, spec, ctx.mesh))
            for (_, leaf), (_, spec) in zip(leaves_with_path(cache),
                                            leaves_with_path(cache_specs(cfg, ctx, cache)))]


def keep_spec(block: torch.Tensor, spec: P) -> torch.Tensor:
    """``block`` tagged with its spec (``block.cache_spec``), as a JAX array
    carries its sharding; the tag lives as long as the tensor, which the
    layers write in place."""
    block.cache_spec = spec
    return block


def kv_slots(block: torch.Tensor, ctx: MeshCtx) -> Tuple[int, int]:
    """(first slot, global length) of this rank's block ``(B, nl, Hkv, hd)``
    of an end-aligned attention cache under ``ctx``: split over ``model``,
    rank r holds the slots ``[r nl, (r + 1) nl)`` of ``p nl``; whole (a
    length ``model`` does not divide), every rank holds all ``nl``.  Read
    from the block's spec tag (``keep_spec``), so the block must come from
    ``init_cache(ctx=)`` or ``shard_cache``."""
    spec = getattr(block, "cache_spec", None)
    if spec is None:
        raise ValueError(f"cache block {tuple(block.shape)} carries no spec: under a ctx a "
                         f"cache comes from init_cache(ctx=) or shard_cache")
    nl = block.shape[1]
    if spec[1] is None:
        return 0, nl
    return ctx.mesh.index(spec[1]) * nl, nl * ctx.mesh.size(spec[1])


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


# ---------------------------------------------------------------------------
# the dry run's cells
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    """Everything the dry run needs for one (arch x shape x mesh) cell."""
    cfg: ModelConfig
    shape: ShapeConfig
    ctx: MeshCtx
    abstract_args: tuple          # ``meta`` tensors for the step function
    in_shardings: tuple           # their specs
    kind: str                     # train | prefill | decode


def _bspec(ctx: MeshCtx, ndim: int, batch_dim: int = 0) -> P:
    parts: list = [None] * ndim
    parts[batch_dim] = ctx.batch_axes if ctx.batch_axes else None
    return P(*parts)


def _abs(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> Tree:
    """The whole decode cache of ``batch`` rows of ``max_len`` positions,
    on ``meta`` (bf16 K/V and conv windows, f32 recurrent states)."""
    init = E.init_cache if cfg.enc_dec else T.init_cache
    return init(cfg, batch, max_len, device="meta")


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: AbstractMesh,
               pcfg: ParallelConfig) -> Cell:
    """Abstract inputs and their specs for one cell (the state excluded: the
    caller pairs these with ``steps.abstract_train_state`` or
    ``transformer.init_abstract``)."""
    ctx = make_cell_ctx(mesh, pcfg, shape.global_batch)
    b, s = shape.global_batch, shape.seq_len

    def tokens_and_frames():
        batch = {"tokens": _abs((b, s), torch.int32)}
        bsh = {"tokens": _bspec(ctx, 2)}
        if cfg.enc_dec:
            batch["frames"] = _abs((b, ENC_LEN, cfg.d_model), torch.float32)
            bsh["frames"] = _bspec(ctx, 3)
        return batch, bsh

    if shape.kind == "train":
        batch, bsh = tokens_and_frames()
        return Cell(cfg, shape, ctx, (batch,), (bsh,), "train")
    # prefill (the fused prefill writes the prompt's cache in-pass) and
    # decode (one new token against a seq_len cache) take the cache
    cache = abstract_cache(cfg, b, s)
    csh = cache_specs(cfg, ctx, cache)
    if shape.kind == "prefill":
        batch, bsh = tokens_and_frames()
        return Cell(cfg, shape, ctx, (batch, cache), (bsh, csh), "prefill")
    args = [_abs((b,), torch.int32), cache, _abs((), torch.int32)]
    shs = [_bspec(ctx, 1), csh, P()]
    if cfg.enc_dec:
        args.append(_abs((b, ENC_LEN, cfg.d_model), torch.float32))
        shs.append(_bspec(ctx, 3))
    return Cell(cfg, shape, ctx, tuple(args), tuple(shs), "decode")
