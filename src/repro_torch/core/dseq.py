"""Distributed sequences: the FooPar Table-1 operation algebra on gloo ranks.

The port of ``repro/core/dseq.py``.  A ``DSeq`` is a sequence whose i-th
element lives on rank i of a communication group; the group is an axis (or
a tuple of axes) of the ``ProcessMesh`` whose ``spmd`` body is running.
Each function keeps the reference's name, arguments and semantics:

  mapD / zipWithD   local compute (no communication)
  reduceD           all_reduce fast path ('sum' | 'min' | 'max'), or the
                    generic binary tree built from ``permute`` (log p rounds)
  shiftD            cyclic shift (``permute``)
  allGatherD        all-gather
  allToAllD         all-to-all over the leading dim
  applyD(i)         one-to-all broadcast from element i
  scanD             Hillis-Steele recursive doubling over ``permute``
  reduceScatterD    reduce_scatter ('sum') or the ring over ``permute``
  ringShiftD        +-1 nearest-neighbour shift
  allGatherRingD    p-1 ring shifts, assembled in arrival order

Where the reference selects with a traced predicate (``jnp.where`` on the
axis index), the port branches on the rank's index, a Python int.  Elements
are tensors or tuples / lists / dicts of tensors.

Seven of the operations are differentiable, each a ``torch.autograd.Function``
whose backward is its transpose -- what ``shard_map``'s transpose and GSPMD's
partitioner give the reference:

  forward                          backward
  reduceD("sum")                   identity
  copy_d (identity, replicated x)  reduceD("sum")   (a column-parallel input)
  allGatherD (tiled, any dim)      reduceScatterD("sum") on that dim
  reduceScatterD("sum") on a dim   allGatherD on that dim
  allToAllD                        the inverse allToAllD
  split_dim (this element's chunk) allGatherD on that dim
  all_gather_whole (allGatherD)    this element's chunk

The last two carry a sequence-sharded activation into and out of a block
that runs on the whole, replicated sequence (every rank holding the whole
cotangent, as after ``reduceD("sum")``); the gather / reduce-scatter pair
carries it into a column-parallel and out of a row-parallel product, whose
ranks each hold a share of the cotangent (the Megatron sequence-parallel
pattern).

Each holds its mesh, so a backward pass (and the recompute of a
checkpointed region) issues its collectives outside any ``with mesh:``
block, in the same order on every rank of the group.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from .mesh import P, ProcessMesh, current, spmd  # noqa: F401  (spmd, P re-exported)

Pytree = Any


def _tmap(f: Callable, *trees):
    t = trees[0]
    if isinstance(t, (tuple, list)):
        return type(t)(_tmap(f, *parts) for parts in zip(*trees))
    if isinstance(t, dict):
        return {k: _tmap(f, *(tr[k] for tr in trees)) for k in t}
    return f(*trees)


# ---------------------------------------------------------------------------
# the differentiable collectives: forward and transpose
# ---------------------------------------------------------------------------
def _all_gather_dim(mesh: ProcessMesh, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    g = mesh.all_gather(x, axes)                          # (p, *x.shape)
    return g.movedim(0, dim).flatten(dim, dim + 1)


def _reduce_scatter_dim(mesh: ProcessMesh, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    return mesh.reduce_scatter_sum(x.movedim(dim, 0), axes).movedim(0, dim)


def _all_to_all_dims(mesh: ProcessMesh, x: torch.Tensor, axes, split: int,
                     concat: int) -> torch.Tensor:
    p, n = mesh.size(axes), x.shape[split]
    if n % p:
        raise ValueError(f"all_to_all: dim {split} of {tuple(x.shape)} does not split {p} ways")
    # (p, ..., n / p, ...): chunk i of dim ``split`` leads, bound for element i
    chunks = x.unflatten(split, (p, n // p)).movedim(split, 0)
    got = mesh.all_to_all(chunks, axes)                   # leading dim: the source
    return got.movedim(0, concat).flatten(concat, concat + 1)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, "sum", axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, "sum", ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather_dim(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(ctx.mesh, g, ctx.axes, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _reduce_scatter_dim(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim(ctx.mesh, g, ctx.axes, ctx.dim), None, None, None


def _chunk(mesh: ProcessMesh, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    p, n = mesh.size(axes), x.shape[dim]
    if n % p:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {p} ways")
    return x.narrow(dim, mesh.index(axes) * (n // p), n // p)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _chunk(mesh, x, axes, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim(ctx.mesh, g, ctx.axes, ctx.dim), None, None, None


class _AllGatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather_dim(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(ctx.mesh, g, ctx.axes, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split, concat):
        ctx.mesh, ctx.axes, ctx.split, ctx.concat = mesh, axes, split, concat
        return _all_to_all_dims(mesh, x, axes, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all_dims(ctx.mesh, g, ctx.axes, ctx.concat, ctx.split),
                None, None, None, None)


def _grouped(mesh: ProcessMesh, axis) -> bool:
    """Whether ``axis`` names a group of more than one rank."""
    return mesh.size(axis) > 1


def reduce_sum(x: torch.Tensor, axis, mesh: ProcessMesh | None = None) -> torch.Tensor:
    """``reduceD("sum")`` of one tensor; its transpose is the identity."""
    mesh = mesh or current()
    return _ReduceSum.apply(x, mesh, axis) if _grouped(mesh, axis) else x


def copy_d(x: torch.Tensor, axis, mesh: ProcessMesh | None = None) -> torch.Tensor:
    """The identity on a tensor replicated over the group, whose transpose
    sums the cotangent over the group (``reduceD("sum")``): the input of a
    column-parallel product, which each element multiplies by its own slice
    of the weight, so each holds part of the input's gradient."""
    mesh = mesh or current()
    return _Copy.apply(x, mesh, axis) if _grouped(mesh, axis) else x


def all_gather_dim(x: torch.Tensor, axis, dim: int = 0,
                   mesh: ProcessMesh | None = None) -> torch.Tensor:
    """``allGatherD`` tiled along ``dim`` (the group's blocks concatenated
    in element order); its transpose reduce-scatters the cotangent (sum)
    along ``dim``."""
    mesh = mesh or current()
    return _AllGather.apply(x, mesh, axis, dim % x.dim()) if _grouped(mesh, axis) else x


def reduce_scatter_dim(x: torch.Tensor, axis, dim: int = 0,
                       mesh: ProcessMesh | None = None) -> torch.Tensor:
    """``reduceScatterD("sum")`` along ``dim``: the group's sum, element i
    keeping chunk i of ``dim``; its transpose all-gathers the cotangent
    along ``dim`` (the way out of a row-parallel product into a
    sequence-sharded activation)."""
    mesh = mesh or current()
    return _ReduceScatter.apply(x, mesh, axis, dim % x.dim()) if _grouped(mesh, axis) else x


def split_dim(x: torch.Tensor, axis, dim: int = 0,
              mesh: ProcessMesh | None = None) -> torch.Tensor:
    """This element's chunk of ``dim`` of a tensor replicated over the group
    (no communication); its transpose all-gathers the cotangent along
    ``dim``, so the replicated producer gets its whole cotangent on every
    element."""
    mesh = mesh or current()
    return _Split.apply(x, mesh, axis, dim % x.dim()) if _grouped(mesh, axis) else x


def all_gather_whole(x: torch.Tensor, axis, dim: int = 0,
                     mesh: ProcessMesh | None = None) -> torch.Tensor:
    """``allGatherD`` along ``dim`` into a tensor that every element then
    uses whole (a block run replicated, each element computing the whole
    cotangent): its transpose keeps this element's chunk of the cotangent."""
    mesh = mesh or current()
    return _AllGatherWhole.apply(x, mesh, axis, dim % x.dim()) if _grouped(mesh, axis) else x


def all_to_all_dim(x: torch.Tensor, axis, split: int, concat: int,
                   mesh: ProcessMesh | None = None) -> torch.Tensor:
    """``allToAllD`` over dims: chunk i of ``split`` goes to element i, the
    chunks received are concatenated along ``concat`` in source order.  Its
    transpose is the inverse, ``all_to_all_dim(g, axis, concat, split)``."""
    mesh = mesh or current()
    if not _grouped(mesh, axis):
        return x
    return _AllToAll.apply(x, mesh, axis, split % x.dim(), concat % x.dim())


# ---------------------------------------------------------------------------
def axis_index(axis) -> int:
    return current().index(axis)


def axis_size(axis) -> int:
    return current().size(axis)


def reduce_d(x: Pytree, op: Callable | str, axis, *, root: int | None = None) -> Pytree:
    """FooPar ``reduceD`` with associative ``op``.  A string op is one
    all_reduce; a callable builds the binary tree of the reference from
    ``permute`` (ceil(log2 p) rounds), then broadcasts from element 0, or,
    with ``root``, moves the result to ``root`` and leaves zeros elsewhere."""
    mesh = current()
    idx = mesh.index(axis)
    if op == "sum" and root is None:
        return _tmap(lambda l: reduce_sum(l, axis, mesh), x)
    if isinstance(op, str):
        out = _tmap(lambda l: mesh.all_reduce(l, op, axis), x)
        if root is None or idx == root:
            return out
        return _tmap(torch.zeros_like, out)

    p = mesh.size(axis)
    rounds = max(1, math.ceil(math.log2(p))) if p > 1 else 0
    for r in range(rounds):
        stride = 1 << r
        block = stride << 1
        perm = [(i + stride, i) for i in range(0, p, block) if i + stride < p]
        recv = _tmap(lambda l: mesh.permute(l, perm, axis), x)
        if idx % block == 0 and idx + stride < p:
            x = op(x, recv)
    if root is None:
        return apply_d(x, 0, axis)
    if root != 0:
        x = shift_d(x, root, axis)
    return x if idx == root else _tmap(torch.zeros_like, x)


def shift_d(x: Pytree, delta: int, axis) -> Pytree:
    """FooPar ``shiftD``: element i goes to i + delta (cyclic)."""
    mesh = current()
    p = mesh.size(axis)
    d = delta % p
    if d == 0:
        return x
    perm = [(i, (i + d) % p) for i in range(p)]
    return _tmap(lambda l: mesh.permute(l, perm, axis), x)


def all_gather_d(x: Pytree, axis, *, tiled: bool = False) -> Pytree:
    """FooPar ``allGatherD``: (p, ...) stacked, or concatenated with ``tiled``
    (differentiable: the transpose reduce-scatters)."""
    mesh = current()

    def gather(l):
        if tiled:
            return all_gather_dim(l, axis, 0, mesh)
        return all_gather_dim(l[None], axis, 0, mesh) if _grouped(mesh, axis) else l[None]

    return _tmap(gather, x)


def all_to_all_d(x: Pytree, axis) -> Pytree:
    """FooPar ``allToAllD``: the local leading dim indexes the destination
    (differentiable: the transpose is the same exchange)."""
    mesh = current()
    return _tmap(lambda l: all_to_all_dim(l, axis, 0, 0, mesh), x)


def apply_d(x: Pytree, i: int, axis) -> Pytree:
    """FooPar ``apply(i)``: every element obtains element i (a broadcast)."""
    mesh = current()
    return _tmap(lambda l: mesh.broadcast(l, int(i), axis), x)


def scan_d(x: Pytree, axis, op: Callable | None = None, *,
           inclusive: bool = False) -> Pytree:
    """Parallel prefix (``scanD``), Hillis-Steele: ceil(log2 p) rounds, each
    combining with the element ``stride`` below.  The exclusive form gives
    element 0 zeros (the identity of ``+``-like ops)."""
    op = op or (lambda a, b: a + b)
    mesh = current()
    idx, p = mesh.index(axis), mesh.size(axis)
    acc = x
    for r in range(max(0, math.ceil(math.log2(p)))):
        stride = 1 << r
        perm = [(i, i + stride) for i in range(p - stride)]
        recv = _tmap(lambda l: mesh.permute(l, perm, axis), acc)
        if idx >= stride:
            acc = _tmap(lambda a, rv: op(rv, a), acc, recv)
    if inclusive:
        return acc
    shifted = _tmap(lambda l: mesh.permute(l, [(i, i + 1) for i in range(p - 1)], axis),
                    acc)
    return _tmap(torch.zeros_like, shifted) if idx == 0 else shifted


def reduce_scatter_d(x: Pytree, op: Callable | str, axis) -> Pytree:
    """``reduceScatterD``: reduce with ``op`` and leave element i holding the
    i-th chunk of the leading dim.  'sum' is one reduce_scatter; a callable
    runs the ring of p-1 nearest-neighbour steps."""
    mesh = current()
    if isinstance(op, str):
        if op != "sum":
            raise ValueError(f"reduce_scatter_d: string op must be 'sum', got {op!r}")
        return _tmap(lambda l: mesh.reduce_scatter_sum(l, axis), x)

    p, idx = mesh.size(axis), mesh.index(axis)

    def check(l):
        if l.shape[0] % p:
            raise ValueError(f"reduce_scatter_d: leading dim {l.shape[0]} must be "
                             f"divisible by group size {p}")
    _tmap(check, x)
    if p == 1:
        return x

    def chunk(l, c):
        blk = l.shape[0] // p
        return l[c * blk:(c + 1) * blk]

    # chunk c travels the ring from element c+1 to element c, gathering each
    # element's part: at step s element r sends the partial of chunk r-s-1
    ring = [(i, (i + 1) % p) for i in range(p)]
    buf = _tmap(lambda l: chunk(l, (idx - 1) % p), x)
    for s in range(p - 1):
        sent = _tmap(lambda l: mesh.permute(l, ring, axis), buf)
        c_recv = (idx - s - 2) % p
        buf = _tmap(lambda rv, l: op(rv, chunk(l, c_recv)), sent, x)
    return buf


def ring_shift_d(x: Pytree, axis, *, reverse: bool = False) -> Pytree:
    """Nearest-neighbour ring step: element i goes to i + 1 (i - 1 reversed)."""
    return shift_d(x, -1 if reverse else 1, axis)


def all_gather_ring_d(x: Pytree, axis) -> Pytree:
    """All-gather as p-1 ``ring_shift_d`` steps; the block that arrives at
    step s is element (idx - s) mod p, and the result is in element order,
    as ``all_gather_d``'s."""
    mesh = current()
    p, idx = mesh.size(axis), mesh.index(axis)
    parts = [x]
    buf = x
    for _ in range(p - 1):
        buf = ring_shift_d(buf, axis)
        parts.append(buf)

    def assemble(*ls):
        out = torch.empty((p,) + tuple(ls[0].shape), dtype=ls[0].dtype,
                          device=ls[0].device)
        for s, l in enumerate(ls):
            out[(idx - s) % p] = l
        return out

    return _tmap(assemble, *parts)


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DSeq:
    """A distributed sequence bound to communication group ``axis``:
    ``local`` is this rank's element, element i lives on rank i of the axis."""

    local: Pytree
    axis: Any

    def mapD(self, f: Callable) -> "DSeq":
        return DSeq(f(self.local), self.axis)

    def mapIdxD(self, f: Callable) -> "DSeq":
        """map with the element index (= rank in the group) as first argument."""
        return DSeq(f(axis_index(self.axis), self.local), self.axis)

    def zipWithD(self, other: "DSeq", f: Callable) -> "DSeq":
        if other.axis != self.axis:
            raise ValueError("zipWithD requires the same group")
        return DSeq(f(self.local, other.local), self.axis)

    def reduceD(self, op: Callable | str, root: int | None = None) -> Pytree:
        return reduce_d(self.local, op, self.axis, root=root)

    def shiftD(self, delta: int) -> "DSeq":
        return DSeq(shift_d(self.local, delta, self.axis), self.axis)

    def allGatherD(self, tiled: bool = False) -> Pytree:
        return all_gather_d(self.local, self.axis, tiled=tiled)

    def allToAllD(self) -> "DSeq":
        return DSeq(all_to_all_d(self.local, self.axis), self.axis)

    def apply(self, i: int) -> Pytree:
        return apply_d(self.local, i, self.axis)

    def scanD(self, op: Callable | None = None, *, inclusive: bool = False) -> "DSeq":
        return DSeq(scan_d(self.local, self.axis, op, inclusive=inclusive), self.axis)

    def reduceScatterD(self, op: Callable | str = "sum") -> "DSeq":
        return DSeq(reduce_scatter_d(self.local, op, self.axis), self.axis)

    def ringShiftD(self, *, reverse: bool = False) -> "DSeq":
        return DSeq(ring_shift_d(self.local, self.axis, reverse=reverse), self.axis)

    def allGatherRingD(self) -> Pytree:
        return all_gather_ring_d(self.local, self.axis)

    @property
    def size(self) -> int:
        return axis_size(self.axis)

    @property
    def rank(self) -> int:
        return axis_index(self.axis)
