"""2D parallel matrix multiplication on the FooPar algebra: SUMMA + Cannon.

The port of ``repro/core/summa.py``:

* ``summa_matmul``  -- outer-product SUMMA on a q_x x q_y grid: L = lcm(q_x,
  q_y) panel steps, each a row broadcast of an A panel and a column
  broadcast of a B panel, accumulated locally;
* ``cannon_matmul`` -- Cannon's algorithm: one skew permute per operand
  slot, then L multiply-and-ring-shift steps, generalized to rectangular
  grids by panel windows of L/q_y (A) and L/q_x (B) slots;
* ``summa_matmul_kernel`` / ``cannon_matmul_kernel`` -- both with the CUDA
  ``matmul_acc`` kernel, which updates the rank's C block in place (the
  reference's ``*_pallas`` wrappers).

Each ``*_body`` is one rank's block-level program and can be called on its
own inside ``with mesh:``; the public functions wrap it in ``spmd``.
"""
from __future__ import annotations

import math
from typing import Callable, List

import torch

from .grid import Grid2D
from .mesh import P, ProcessMesh, current, spmd


def _skew_panels(g: Grid2D, panels: List[torch.Tensor], *, qx: int, qy: int,
                 L: int, operand: str) -> List[torch.Tensor]:
    """Cannon's alignment at panel granularity on a (possibly rectangular)
    grid: afterwards process (i, j) holds the panels base(i, j) + s (mod L),
    base = i*L/q_x + j*L/q_y, which its first steps consume.  One panel per
    process moves as one ``Grid2D.skew``; with several, each destination slot
    is one merged grid-wide permute in which every source rank sends the one
    local slot it owes (a local choice, no communication)."""
    n_slots = len(panels)
    if n_slots == 1:
        return [g.skew(panels[0], by_row=operand == "A",
                       scale=(L // qx) if operand == "A" else (L // qy))]
    me = g.coords[0] * qy + g.coords[1]
    out = []
    for ds in range(n_slots):
        perm = []
        send_slot = [-1] * (qx * qy)
        for i in range(qx):
            for j in range(qy):
                k = (i * (L // qx) + j * (L // qy) + ds) % L
                owner = k // n_slots
                src = (i, owner) if operand == "A" else (owner, j)
                src_lin = src[0] * qy + src[1]
                if send_slot[src_lin] != -1:
                    raise AssertionError(f"rank {src} would send twice in the merged "
                                         f"skew (operand {operand}, slot {ds})")
                send_slot[src_lin] = k % n_slots
                perm.append((src_lin, i * qy + j))
        out.append(current().permute(panels[send_slot[me]], perm, g.axes))
    return out


def _make_mm_acc(local_matmul: Callable | None,
                 local_matmul_acc: Callable | None) -> Callable:
    """``(a, b, c) -> c + a @ b`` from whichever product the caller gave."""
    if local_matmul_acc is not None:
        return local_matmul_acc
    mm = local_matmul or torch.matmul
    return lambda a, b, c: c + mm(a, b)


def _grid(row_axis: str, col_axis: str):
    mesh = current()
    qx, qy = mesh.size(row_axis), mesh.size(col_axis)
    return Grid2D(row_axis, col_axis), qx, qy, math.lcm(qx, qy)


def _check_k(A, B, L: int) -> None:
    if A.shape[1] % L or A.shape[1] != B.shape[0]:
        raise ValueError(f"A {tuple(A.shape)} and B {tuple(B.shape)}: the contraction "
                         f"dim must match and split into L = {L} panels")


def summa_body(a_blk: torch.Tensor, b_blk: torch.Tensor, *, mm_acc: Callable,
               row_axis: str = "x", col_axis: str = "y") -> torch.Tensor:
    """One rank's SUMMA: for k = 0..L-1, C += bcast_row(A panel k) @
    bcast_col(B panel k)."""
    g, qx, qy, L = _grid(row_axis, col_axis)
    w = a_blk.shape[1] // (L // qy)          # panel width n/L
    c = torch.zeros((a_blk.shape[0], b_blk.shape[1]), dtype=torch.float32,
                    device=a_blk.device)
    for k in range(L):
        a_off = (k % (L // qy)) * w
        b_off = (k % (L // qx)) * w
        a_k = g.bcast_row(a_blk[:, a_off:a_off + w], k // (L // qy))
        b_k = g.bcast_col(b_blk[b_off:b_off + w, :], k // (L // qx))
        c = mm_acc(a_k, b_k, c)
    return c


def summa_matmul(A: torch.Tensor, B: torch.Tensor, mesh: ProcessMesh, *,
                 local_matmul: Callable | None = None,
                 local_matmul_acc: Callable | None = None,
                 row_axis: str = "x", col_axis: str = "y") -> torch.Tensor:
    """SUMMA on a q_x x q_y grid.  A and B arrive block-partitioned P(x, y);
    the contraction dim is cut into L = lcm(q_x, q_y) panels of width n/L:
    panel k of A lives in block column k*q_y/L, of B in block row k*q_x/L."""
    mm_acc = _make_mm_acc(local_matmul, local_matmul_acc)
    _check_k(A, B, math.lcm(mesh.size(row_axis), mesh.size(col_axis)))
    spec = P(row_axis, col_axis)

    def body(a, b):
        return summa_body(a, b, mm_acc=mm_acc, row_axis=row_axis, col_axis=col_axis)

    return spmd(body, mesh, (spec, spec), spec)(A, B)


def cannon_body(a_blk: torch.Tensor, b_blk: torch.Tensor, *, mm_acc: Callable,
                row_axis: str = "x", col_axis: str = "y") -> torch.Tensor:
    """One rank's Cannon: skew the A and B slots, then L steps of C += a @ b,
    pulling the next window from the right (A) / below (B) as one is used up."""
    g, qx, qy, L = _grid(row_axis, col_axis)
    w = a_blk.shape[1] // (L // qy)
    a_slots = [a_blk[:, s * w:(s + 1) * w] for s in range(L // qy)]
    b_slots = [b_blk[s * w:(s + 1) * w, :] for s in range(L // qx)]
    a_slots = _skew_panels(g, a_slots, qx=qx, qy=qy, L=L, operand="A")
    b_slots = _skew_panels(g, b_slots, qx=qx, qy=qy, L=L, operand="B")
    c = torch.zeros((a_blk.shape[0], b_blk.shape[1]), dtype=torch.float32,
                    device=a_blk.device)
    for t in range(L):
        c = mm_acc(a_slots[t % len(a_slots)], b_slots[t % len(b_slots)], c)
        if t == L - 1:
            break
        if (t + 1) % len(a_slots) == 0:
            a_slots = [g.shift_row(s, -1) for s in a_slots]
        if (t + 1) % len(b_slots) == 0:
            b_slots = [g.shift_col(s, -1) for s in b_slots]
    return c


def cannon_matmul(A: torch.Tensor, B: torch.Tensor, mesh: ProcessMesh, *,
                  local_matmul: Callable | None = None,
                  local_matmul_acc: Callable | None = None,
                  row_axis: str = "x", col_axis: str = "y") -> torch.Tensor:
    """Cannon's algorithm on a q_x x q_y grid (square or rectangular); after
    the skew all traffic is nearest-neighbour ring shifts."""
    mm_acc = _make_mm_acc(local_matmul, local_matmul_acc)
    _check_k(A, B, math.lcm(mesh.size(row_axis), mesh.size(col_axis)))
    spec = P(row_axis, col_axis)

    def body(a, b):
        return cannon_body(a, b, mm_acc=mm_acc, row_axis=row_axis, col_axis=col_axis)

    return spmd(body, mesh, (spec, spec), spec)(A, B)


def summa_matmul_kernel(A: torch.Tensor, B: torch.Tensor,
                        mesh: ProcessMesh) -> torch.Tensor:
    """SUMMA with the in-place CUDA ``matmul_acc`` kernel (the reference's
    ``summa_matmul_pallas``): no per-panel product temporary."""
    from ..kernels.ops import matmul_acc

    return summa_matmul(A, B, mesh, local_matmul_acc=matmul_acc)


def cannon_matmul_kernel(A: torch.Tensor, B: torch.Tensor,
                         mesh: ProcessMesh) -> torch.Tensor:
    """Cannon with the in-place CUDA ``matmul_acc`` kernel (the reference's
    ``cannon_matmul_pallas``)."""
    from ..kernels.ops import matmul_acc

    return cannon_matmul(A, B, mesh, local_matmul_acc=matmul_acc)
