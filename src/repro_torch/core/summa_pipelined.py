"""Overlap-pipelined SUMMA and 2.5D (replicated) Cannon.

The port of ``repro/core/summa_pipelined.py``:

* ``summa_matmul_pipelined`` -- SUMMA with the panel broadcasts replaced by
  ring transfers.  Process column j consumes the panels in the rotated order
  k(t) = (j*L/q_y + t) mod L, so A needs no broadcast: each rank starts on
  its own A window and pulls the next with one nearest-neighbour shift; the
  B panel of each step travels as a ring broadcast.  Both transfers of step
  t+1 are *issued* (asynchronous gloo work) before step t's multiply and
  waited on before step t+1 uses them;
* ``cannon_matmul_25d`` -- Cannon with c-fold replication on a q x q x c
  mesh: layer l skews for step l*q/c, runs q/c steps, and the partial C's
  are summed over the replica axis (an all_reduce on the z groups);
* ``summa_matmul_pipelined_kernel`` / ``cannon_matmul_25d_kernel`` -- both
  with the in-place CUDA ``matmul_acc`` kernel.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .grid import Grid2D, Grid3D
from .mesh import P, ProcessMesh, current, spmd
from .summa import _check_k, _make_mm_acc


def summa_pipelined_body(a_blk: torch.Tensor, b_blk: torch.Tensor, *,
                         mm_acc: Callable, row_axis: str = "x",
                         col_axis: str = "y") -> torch.Tensor:
    """One rank's pipelined SUMMA (see the module docstring)."""
    mesh = current()
    qx, qy = mesh.size(row_axis), mesh.size(col_axis)
    L = math.lcm(qx, qy)
    g = Grid2D(row_axis, col_axis)
    wa, wb = L // qy, L // qx
    j = mesh.index(g.row_axis)                       # own process column
    ks = (j * wa + np.arange(L)) % L                 # panel of each step
    w = a_blk.shape[1] // wa                         # panel width n_k / L
    a_slots = [a_blk[:, s * w:(s + 1) * w] for s in range(wa)]
    b_win = [b_blk[s * w:(s + 1) * w, :] for s in range(wb)]

    def start_b(t):
        """Issue the ring broadcast of step t's B panel from its owner row."""
        st = g.bcast_col_ring_start(b_win[int(ks[t] % wb)], int(ks[t] // wb))
        for _ in range(qx - 1):
            st = g.bcast_col_ring_next(st)
        return st

    c = torch.zeros((a_blk.shape[0], b_blk.shape[1]), dtype=torch.float32,
                    device=a_blk.device)
    b_next = start_b(0)
    a_next = None
    for t in range(L):
        if a_next is not None:
            a_slots = [pend.wait() for pend in a_next]
            a_next = None
        a_t, b_t = a_slots[t % wa], b_next.value
        if t + 1 < L:                 # double buffer: step t+1's transfers
            b_next = start_b(t + 1)   # are issued before this multiply
            if (t + 1) % wa == 0:     # A window used up: pull from j+1
                a_next = [g.shift_row_async(s, -1) for s in a_slots]
        c = mm_acc(a_t, b_t, c)
    return c


def summa_matmul_pipelined(A: torch.Tensor, B: torch.Tensor, mesh: ProcessMesh, *,
                           local_matmul: Callable | None = None,
                           local_matmul_acc: Callable | None = None,
                           row_axis: str = "x", col_axis: str = "y") -> torch.Tensor:
    """SUMMA with ring transfers overlapped with the local multiply; same
    layout and result as ``summa_matmul``."""
    mm_acc = _make_mm_acc(local_matmul, local_matmul_acc)
    _check_k(A, B, math.lcm(mesh.size(row_axis), mesh.size(col_axis)))
    spec = P(row_axis, col_axis)

    def body(a, b):
        return summa_pipelined_body(a, b, mm_acc=mm_acc, row_axis=row_axis,
                                    col_axis=col_axis)

    return spmd(body, mesh, (spec, spec), spec)(A, B)


def _skew_25d(g: Grid3D, local: torch.Tensor, *, q: int, c: int, steps: int,
              operand: str) -> torch.Tensor:
    """2.5D Cannon alignment: (i, j, l) receives the block its layer's first
    step consumes, A[i, (i+j+l*steps) mod q] or B[(i+j+l*steps) mod q, j], as
    one permute over the whole mesh."""
    perm = []
    for i in range(q):
        for j in range(q):
            for l in range(c):
                k0 = (i + j + l * steps) % q
                src = (i, k0, l) if operand == "A" else (k0, j, l)
                perm.append((src[0] * q * c + src[1] * c + src[2], i * q * c + j * c + l))
    return current().permute(local, perm, g.axes)


def cannon_25d_body(a_blk: torch.Tensor, b_blk: torch.Tensor, *, mm_acc: Callable,
                    row_axis: str = "x", col_axis: str = "y",
                    rep_axis: str = "z") -> torch.Tensor:
    """One rank's 2.5D Cannon: layer skew, q/c multiply-and-shift steps, and
    the sum over the replica axis."""
    mesh = current()
    q, c = mesh.size(row_axis), mesh.size(rep_axis)
    steps = q // c
    g = Grid3D(row_axis, col_axis, rep_axis)
    g2 = Grid2D(row_axis, col_axis)
    a = _skew_25d(g, a_blk, q=q, c=c, steps=steps, operand="A")
    b = _skew_25d(g, b_blk, q=q, c=c, steps=steps, operand="B")
    c_part = torch.zeros((a_blk.shape[0], b_blk.shape[1]), dtype=torch.float32,
                         device=a_blk.device)
    for t in range(steps):
        c_part = mm_acc(a, b, c_part)
        if t < steps - 1:
            a = g2.shift_row(a, -1)
            b = g2.shift_col(b, -1)
    return mesh.all_reduce(c_part, "sum", rep_axis)


def cannon_matmul_25d(A: torch.Tensor, B: torch.Tensor, mesh: ProcessMesh, *,
                      local_matmul: Callable | None = None,
                      local_matmul_acc: Callable | None = None,
                      row_axis: str = "x", col_axis: str = "y",
                      rep_axis: str = "z") -> torch.Tensor:
    """2.5D Cannon on a q x q x c mesh (c = extent of ``rep_axis``); both
    operands arrive P(x, y), replicated over the c layers."""
    mm_acc = _make_mm_acc(local_matmul, local_matmul_acc)
    q, qy, c = mesh.size(row_axis), mesh.size(col_axis), mesh.size(rep_axis)
    if q != qy or q % c:
        raise ValueError(f"2.5D Cannon needs a square x, y grid whose side the "
                         f"replication factor divides; got {q} x {qy} x {c}")
    _check_k(A, B, q)
    spec = P(row_axis, col_axis)

    def body(a, b):
        return cannon_25d_body(a, b, mm_acc=mm_acc, row_axis=row_axis,
                               col_axis=col_axis, rep_axis=rep_axis)

    return spmd(body, mesh, (spec, spec), spec)(A, B)


def summa_matmul_pipelined_kernel(A: torch.Tensor, B: torch.Tensor,
                                  mesh: ProcessMesh) -> torch.Tensor:
    """Pipelined SUMMA with the in-place CUDA ``matmul_acc`` kernel (the
    reference's ``summa_matmul_pipelined_pallas``)."""
    from ..kernels.ops import matmul_acc

    return summa_matmul_pipelined(A, B, mesh, local_matmul_acc=matmul_acc)


def cannon_matmul_25d_kernel(A: torch.Tensor, B: torch.Tensor,
                             mesh: ProcessMesh) -> torch.Tensor:
    """2.5D Cannon with the in-place CUDA ``matmul_acc`` kernel (the
    reference's ``cannon_matmul_25d_pallas``)."""
    from ..kernels.ops import matmul_acc

    return cannon_matmul_25d(A, B, mesh, local_matmul_acc=matmul_acc)
