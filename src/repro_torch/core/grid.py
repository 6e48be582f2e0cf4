"""Cartesian grid abstractions (paper §4.3): GridN / Grid2D / Grid3D.

The port of ``repro/core/grid.py``.  A grid binds N axes of the active
``ProcessMesh``; ``seq(axis)`` is the DSeq variable in that axis and
constant in the others (the paper's xSeq / ySeq / zSeq), so the Table-1 costs
apply per axis.  Coordinates are the rank's own, plain ints.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Tuple

from .dseq import DSeq, apply_d, reduce_d, shift_d
from .mesh import Pending, current

Pytree = Any


@dataclass(frozen=True)
class RingBcast:
    """An in-flight pipelined ring broadcast along one mesh axis.

    Each ``step()`` forwards the value one nearest-neighbour hop (a
    ``ring_shift_d``), so a caller can interleave the hops of panel k+1's
    broadcast with the local multiply of panel k.  ``buf`` holds the value on
    every rank whose forward ring distance from ``src`` is at most ``hops``;
    the others still hold their own element, which each rank replaces by its
    predecessor's exactly when the value arrives.  A step issues its hop
    asynchronously; the next step, or ``value``, completes it."""

    buf: Pytree
    src: int
    hops: int
    axis: str
    pending: Optional[Pending] = None

    @classmethod
    def start(cls, local: Pytree, src: int, axis: str) -> "RingBcast":
        return cls(buf=local, src=int(src), hops=0, axis=axis)

    def _settled(self) -> "RingBcast":
        if self.pending is None:
            return self
        recv = self.pending.wait()
        mesh = current()
        p = mesh.size(self.axis)
        arriving = (mesh.index(self.axis) - self.src + p) % p == self.hops
        return replace(self, buf=recv if arriving else self.buf, pending=None)

    def step(self) -> "RingBcast":
        """Issue one more hop (after completing the one in flight)."""
        st = self._settled()
        mesh = current()
        p = mesh.size(st.axis)
        if st.hops >= p - 1:
            return st
        perm = [(i, (i + 1) % p) for i in range(p)]
        pend = mesh.permute(st.buf, perm, st.axis, async_op=True)
        return replace(st, hops=st.hops + 1, pending=pend)

    @property
    def done(self) -> bool:
        return self.hops >= current().size(self.axis) - 1

    @property
    def value(self) -> Pytree:
        if not self.done:
            raise RuntimeError(f"ring broadcast over {self.axis!r} read after "
                               f"{self.hops} hops")
        return self._settled().buf


@dataclass(frozen=True)
class GridN:
    """An N-dimensional Cartesian process grid over mesh axes ``axes``."""

    axes: Tuple[str, ...]

    @property
    def ndim(self) -> int:
        return len(self.axes)

    @property
    def coords(self) -> Tuple[int, ...]:
        mesh = current()
        return tuple(mesh.index(a) for a in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        mesh = current()
        return tuple(mesh.size(a) for a in self.axes)

    def mapD(self, f: Callable[..., Pytree]) -> Pytree:
        """Each process computes ``f(*coords)`` (``G mapD {case (i, j, k) => ...}``)."""
        return f(*self.coords)

    def seq(self, axis: str, local: Pytree) -> DSeq:
        """The distributed sequence variable in ``axis``."""
        if axis not in self.axes:
            raise ValueError(f"{axis!r} is not an axis of the grid {self.axes}")
        return DSeq(local, axis)


class Grid2D(GridN):
    """A q_x x q_y process grid: ``x`` indexes the process row i, ``y`` the
    column j, so a row-wise collective runs over the y axis."""

    def __init__(self, x_axis: str = "x", y_axis: str = "y"):
        super().__init__(axes=(x_axis, y_axis))

    @property
    def row_axis(self) -> str:
        return self.axes[1]

    @property
    def col_axis(self) -> str:
        return self.axes[0]

    def xSeq(self, local: Pytree) -> DSeq:
        return self.seq(self.axes[0], local)

    def ySeq(self, local: Pytree) -> DSeq:
        return self.seq(self.axes[1], local)

    def bcast_row(self, local: Pytree, src_col: int) -> Pytree:
        """Every process of row i receives the element held at (i, src_col)."""
        return apply_d(local, src_col, self.row_axis)

    def bcast_col(self, local: Pytree, src_row: int) -> Pytree:
        return apply_d(local, src_row, self.col_axis)

    def reduce_row(self, local: Pytree, op: Callable | str = "sum",
                   root: int | None = None) -> Pytree:
        return reduce_d(local, op, self.row_axis, root=root)

    def reduce_col(self, local: Pytree, op: Callable | str = "sum",
                   root: int | None = None) -> Pytree:
        return reduce_d(local, op, self.col_axis, root=root)

    def shift_row(self, local: Pytree, delta: int) -> Pytree:
        """Cyclic shift within each process row (Cannon's A movement)."""
        return shift_d(local, delta, self.row_axis)

    def shift_col(self, local: Pytree, delta: int) -> Pytree:
        return shift_d(local, delta, self.col_axis)

    def shift_row_async(self, local, delta: int) -> Pending:
        """``shift_row`` of one tensor, issued now and completed by ``wait()``."""
        return _shift_async(local, delta, self.row_axis)

    def bcast_row_ring_start(self, local: Pytree, src_col: int) -> RingBcast:
        """Begin a pipelined ring broadcast within each row from ``src_col``."""
        return RingBcast.start(local, src_col, self.row_axis)

    def bcast_row_ring_next(self, st: RingBcast) -> RingBcast:
        if st.axis != self.row_axis:
            raise ValueError(f"ring broadcast over {st.axis!r}, not the row axis")
        return st.step()

    def bcast_col_ring_start(self, local: Pytree, src_row: int) -> RingBcast:
        return RingBcast.start(local, src_row, self.col_axis)

    def bcast_col_ring_next(self, st: RingBcast) -> RingBcast:
        if st.axis != self.col_axis:
            raise ValueError(f"ring broadcast over {st.axis!r}, not the column axis")
        return st.step()

    def skew(self, local, *, by_row: bool, scale: int = 1):
        """Cannon's alignment as one grid-wide permute: ``by_row`` sends
        (i, j) to (i, j - i*scale mod q_y) (A's skew), else (i, j) to
        (i - j*scale mod q_x, j) (B's skew)."""
        qx, qy = self.shape
        perm = []
        for i in range(qx):
            for j in range(qy):
                dst = (i, (j - i * scale) % qy) if by_row else ((i - j * scale) % qx, j)
                perm.append((i * qy + j, dst[0] * qy + dst[1]))
        return current().permute(local, perm, self.axes)


class Grid3D(GridN):
    def __init__(self, x_axis: str = "x", y_axis: str = "y", z_axis: str = "z"):
        super().__init__(axes=(x_axis, y_axis, z_axis))

    def xSeq(self, local: Pytree) -> DSeq:
        return self.seq(self.axes[0], local)

    def ySeq(self, local: Pytree) -> DSeq:
        return self.seq(self.axes[1], local)

    def zSeq(self, local: Pytree) -> DSeq:
        return self.seq(self.axes[2], local)


def _shift_async(x, delta: int, axis: str) -> Pending:
    mesh = current()
    p = mesh.size(axis)
    perm = [(i, (i + delta) % p) for i in range(p)]
    return mesh.permute(x, perm, axis, async_op=True)
