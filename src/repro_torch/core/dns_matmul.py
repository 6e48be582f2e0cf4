"""Parallel matrix-matrix multiplication (paper §4) on the FooPar algebra.

The port of ``repro/core/dns_matmul.py``:

* ``generic_matmul``    -- paper Algorithm 1: q^2 reductions, emulated by a
  sequential Python loop over (i, j) blocks;
* ``dns_matmul``        -- paper Algorithm 2 on ``Grid3D``;
* ``dns_matmul_kernel`` -- Algorithm 2 with the CUDA ``matmul`` kernel as the
  local product (the reference's ``dns_matmul_pallas``).

All operate on logically (n, n) matrices decomposed into q x q blocks.  The
default local product is ``torch.matmul`` (f32, TF32 off by PyTorch's
default).
"""
from __future__ import annotations

from typing import Callable

import torch

from .dseq import DSeq
from .grid import Grid3D
from .mesh import P, ProcessMesh, spmd


def dns_body(a_blk: torch.Tensor, b_blk: torch.Tensor, *,
             local_matmul: Callable | None = None,
             reduce_op: str | Callable = "sum") -> torch.Tensor:
    """One rank's part of Algorithm 2: C(i, j) = sum_k A(i, k) B(k, j), the
    partial products zipped along z and reduced over z (replicated there)."""
    mm = local_matmul or torch.matmul
    g = Grid3D("x", "y", "z")
    c_partial = g.seq("z", a_blk).zipWithD(g.seq("z", b_blk), mm)
    return c_partial.reduceD(reduce_op)


DNS_SPECS = ((P("x", "z"), P("z", "y")), P("x", "y"))


def dns_matmul(A: torch.Tensor, B: torch.Tensor, mesh: ProcessMesh, *,
               local_matmul: Callable | None = None,
               reduce_op: str | Callable = "sum") -> torch.Tensor:
    """Paper Algorithm 2::

        val GA = G mapD { case (i, j, k) => A(i)(k) }
        val GB = G mapD { case (i, j, k) => B(k)(j) }
        val C  = ((GA zipWithD GB)(_ * _) zSeq) reduceD (_ + _)

    ``mesh`` has axes ('x', 'y', 'z') of equal size q.  The mapD lines are
    the in specs: rank (i, j, k) holds block A[i, k] (replicated over y) and
    B[k, j] (replicated over x), sliced in place from the global inputs."""
    def body(a, b):
        return dns_body(a, b, local_matmul=local_matmul, reduce_op=reduce_op)

    return spmd(body, mesh, *DNS_SPECS)(A, B)


def generic_matmul(A: torch.Tensor, B: torch.Tensor, mesh: ProcessMesh,
                   axis: str = "z") -> torch.Tensor:
    """Paper Algorithm 1 (generic, for-loop): for every (i, j) block::

        A(i) zip Bt(j) mapD { case (a, b) => a * b } reduceD (_ + _)

    The group is mesh axis ``axis`` with q processes; process k holds
    A[i, k] and B[k, j] for the current (i, j).  The loop is the sequential
    emulation whose q^2 rounds drive the Θ(p^{5/3}) isoefficiency of §4.2.1;
    each reduction takes the generic binary tree (a user ``+``)."""
    q = mesh.size(axis)
    n = A.shape[0]
    if n % q:
        raise ValueError(f"n = {n} does not split {q} ways")
    blk = n // q

    def body(a, b):
        prod = DSeq(a, axis).zipWithD(DSeq(b, axis), torch.matmul)
        return prod.reduceD(lambda u, v: u + v, root=None)

    one_reduction = spmd(body, mesh, (P(None, axis), P(axis, None)), P(None, None))
    rows = []
    for i in range(q):
        rows.append(torch.cat([one_reduction(A[i * blk:(i + 1) * blk],
                                             B[:, j * blk:(j + 1) * blk])
                               for j in range(q)], dim=1))
    return torch.cat(rows, dim=0)


def dns_matmul_kernel(A: torch.Tensor, B: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """Algorithm 2 with the CUDA ``matmul`` kernel as the local product (the
    reference's ``dns_matmul_pallas``)."""
    from ..kernels.ops import matmul

    return dns_matmul(A, B, mesh, local_matmul=matmul)
