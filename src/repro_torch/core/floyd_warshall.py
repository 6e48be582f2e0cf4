"""Parallel Floyd-Warshall all-pairs shortest paths (paper §5) and the
blocked variant.

The port of ``repro/core/floyd_warshall.py``:

* ``floyd_warshall``         -- paper Algorithm 3: n pivots, each one pivot-row
  and one pivot-column broadcast (size B = n/sqrt(p)) over the grid axes and
  a rank-1 (min, +) update of the local block;
* ``blocked_floyd_warshall`` -- the 3-phase blocked algorithm on the same
  grid: q rounds of three block broadcasts and (min, +) matrix products as
  local work (``minplus=ops.minplus`` runs the CUDA kernel);
* ``floyd_warshall_reference`` -- the single-device oracle.

Both parallel variants use only Table-1 ``apply`` and local updates.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels.minplus import minplus_ref
from .dseq import apply_d
from .mesh import P, ProcessMesh, current, spmd


def _local_fw(block: torch.Tensor) -> torch.Tensor:
    """Sequential FW closure of one (B, B) block: B in-place rank-1
    ``torch.minimum`` updates of a copy of ``block``."""
    d = block.clone()
    for k in range(d.shape[0]):
        torch.minimum(d, d[:, k:k + 1] + d[k:k + 1, :], out=d)
    return d


def fw_body(block: torch.Tensor, n: int, x_axis: str = "x",
            y_axis: str = "y") -> torch.Tensor:
    """One rank's Algorithm 3.  Per pivot k::

        ik = grid.xSeq.mapD(_(k % B)).apply(k / B)   # pivot-row segment
        kj = grid.ySeq.mapD(col k % B).apply(k / B)  # pivot-col segment
        block = min(block, kj (+) ik)                # rank-1 (min, +) update
    """
    blk = block.clone()
    b = blk.shape[0]
    for k in range(n):
        kb, kq = k % b, k // b
        ik = apply_d(blk[kb], kq, x_axis)          # lives at grid row kq
        kj = apply_d(blk[:, kb], kq, y_axis)       # lives at grid column kq
        torch.minimum(blk, kj[:, None] + ik[None, :], out=blk)
    return blk


def floyd_warshall(D: torch.Tensor, mesh: ProcessMesh,
                   x_axis: str = "x", y_axis: str = "y") -> torch.Tensor:
    """Paper Algorithm 3.  ``D`` is the (n, n) weight matrix (+inf for
    absent edges, 0 diagonal), block-distributed over a (sqrt p, sqrt p) grid."""
    n = D.shape[0]
    if D.shape != (n, n) or n % mesh.size(x_axis):
        raise ValueError(f"need a square D that splits over the grid; got {tuple(D.shape)}")
    spec = P(x_axis, y_axis)
    return spmd(lambda blk: fw_body(blk, n, x_axis, y_axis), mesh, spec, spec)(D)


def blocked_fw_body(block: torch.Tensor, *, minplus: Callable | None = None,
                    x_axis: str = "x", y_axis: str = "y") -> torch.Tensor:
    """One rank's blocked FW.  Round kb (one per block column):
      phase 1: the diagonal block (kb, kb) is FW-closed (on every rank);
      phase 2: the pivot row panel D[kb, j] and column panel D[i, kb] are
               updated with it;
      phase 3: every block D[i, j] <- min(D[i, j], D[i, kb] (x) D[kb, j]).
    Broadcasts: row panel down the columns, then the diagonal along the rows,
    and the column panel along the rows."""
    mp = minplus or minplus_ref
    mesh = current()
    q = mesh.size(x_axis)
    xi, yj = mesh.index(x_axis), mesh.index(y_axis)
    blk = block
    for kb in range(q):
        row_panel = apply_d(blk, kb, x_axis)           # D[kb, j] at all (i, j)
        diag = apply_d(row_panel, kb, y_axis)          # D[kb, kb] everywhere
        col_panel = apply_d(blk, kb, y_axis)           # D[i, kb]
        diag = _local_fw(diag)
        row_panel = torch.minimum(row_panel, mp(diag, row_panel))
        col_panel = torch.minimum(col_panel, mp(col_panel, diag))
        new_blk = torch.minimum(blk, mp(col_panel, row_panel))
        if xi == kb and yj == kb:
            new_blk = diag
        elif xi == kb:
            new_blk = row_panel
        elif yj == kb:
            new_blk = col_panel
        blk = new_blk
    return blk


def blocked_floyd_warshall(D: torch.Tensor, mesh: ProcessMesh,
                           x_axis: str = "x", y_axis: str = "y",
                           minplus: Callable | None = None) -> torch.Tensor:
    """3-phase blocked FW on the 2D grid algebra; ``minplus`` is the local
    (min, +) product (default: the plain ``minplus_ref``)."""
    n = D.shape[0]
    if D.shape != (n, n) or n % mesh.size(x_axis):
        raise ValueError(f"need a square D that splits over the grid; got {tuple(D.shape)}")
    spec = P(x_axis, y_axis)

    def body(blk):
        return blocked_fw_body(blk, minplus=minplus, x_axis=x_axis, y_axis=y_axis)

    return spmd(body, mesh, spec, spec)(D)


def floyd_warshall_reference(D: torch.Tensor) -> torch.Tensor:
    """Single-device oracle (same math, no distribution)."""
    return _local_fw(D)
