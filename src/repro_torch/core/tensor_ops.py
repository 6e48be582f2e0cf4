"""Tensor-parallel matmuls expressed in the FooPar algebra (the paper's
technique inside the LM), the port of the JAX package's
``core/tensor_ops.py``.

A Megatron-style TP layer is a FooPar chain over the ``model`` axis:

  column-parallel  y_shard = x @ W_shard            -- mapD (no communication)
  row-parallel     y = sum_k x_shard @ W_shard      -- zipWithD (.) then reduceD (+)

the same ``mapD/zipWithD -> reduceD`` pattern as the paper's matrix
multiplication (section 4.2).  With a sequence-sharded activation
(``seq_dim``, the Megatron sequence-parallel layout) the column-parallel
input is an ``allGatherD`` of that dim instead of a replicated copy, and
the row-parallel sum a ``reduceScatterD`` onto it instead of ``reduceD``.  Each function takes the rank's local blocks
inside an active ``ProcessMesh`` (how the model calls them); given
``mesh=``, it takes global operands instead and runs as an ``spmd``
program over the mesh with the reference's ``shard_map`` in/out specs.
The operations are differentiable: ``reduceD("sum")``'s transpose is the
identity, and a replicated input enters through ``copy_d``, whose
transpose sums the cotangent over the group (``core/dseq.py``).  Local
products are ``torch.matmul``, as the reference's are ``jnp.matmul``.

``choose_tp_strategy`` ranks the two layouts with the Table-1 cost model --
the paper's "analyzability" claim used as a runtime decision procedure.
"""
from __future__ import annotations

from typing import Literal

import torch

from . import costmodel
from .costmodel import LinkClass, NVLINK
from .dseq import DSeq, all_gather_dim, copy_d, reduce_scatter_dim, reduce_sum
from .mesh import P, ProcessMesh, spmd


def _matmul(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``jnp.matmul(a, b, preferred_element_type=out_dtype)``: narrower
    operands are widened, which is exact for the products."""
    if a.dtype == out_dtype and b.dtype == out_dtype:
        return torch.matmul(a, b)
    return torch.matmul(a.to(out_dtype), b.to(out_dtype))


def _on_mesh(body, mesh: ProcessMesh | None, in_specs, out_specs, x, w, seq_dim=None):
    if seq_dim is not None and mesh is not None:
        raise ValueError("seq_dim takes the rank's blocks: call it inside the mesh, without mesh=")
    if mesh is None:
        return body(x, w)
    return spmd(body, mesh, in_specs, out_specs)(x, w)


def foopar_matmul_row(x: torch.Tensor, w: torch.Tensor, *, mesh: ProcessMesh | None = None,
                      axis: str = "model",
                      preferred_element_type: torch.dtype = torch.float32,
                      seq_dim: int | None = None) -> torch.Tensor:
    """Row-parallel: x (..., k) with k sharded over ``axis``; w (k, n)
    sharded on k.  FooPar: zipWithD (.) then reduceD (+) -- one all-reduce of
    the (..., n) output, replicated over ``axis``; with ``seq_dim`` (local
    blocks only) a reduceScatterD (+) that leaves element i the i-th chunk
    of that dim."""

    def body(xl, wl):
        partial_ = DSeq(xl, axis).zipWithD(
            DSeq(wl, axis), lambda a, b: _matmul(a, b, preferred_element_type))
        if seq_dim is not None:
            return reduce_scatter_dim(partial_.local, axis, seq_dim)
        return partial_.reduceD("sum")

    nx = x.dim()
    return _on_mesh(body, mesh, (P(*([None] * (nx - 1) + [axis])), P(axis, None)),
                    P(*([None] * nx)), x, w, seq_dim)


def foopar_matmul_col(x: torch.Tensor, w: torch.Tensor, *, mesh: ProcessMesh | None = None,
                      axis: str = "model",
                      preferred_element_type: torch.dtype = torch.float32,
                      seq_dim: int | None = None) -> torch.Tensor:
    """Column-parallel: x replicated, w (k, n) sharded on n; the output
    (..., n) sharded on n.  FooPar: a pure mapD -- no communication forward;
    the replicated x's gradient is summed over the group backward.  With
    ``seq_dim`` (local blocks only) x is sharded on that dim and enters by
    allGatherD, whose transpose reduce-scatters its gradient."""

    def body(xl, wl):
        xl = copy_d(xl, axis) if seq_dim is None else all_gather_dim(xl, axis, seq_dim)
        return DSeq((xl, wl), axis).mapD(
            lambda t: _matmul(t[0], t[1], preferred_element_type)).local

    nx = x.dim()
    return _on_mesh(body, mesh, (P(*([None] * nx)), P(None, axis)),
                    P(*([None] * (nx - 1) + [axis])), x, w, seq_dim)


def choose_tp_strategy(m_tokens: int, k: int, n: int, p: int, bytes_per_elt: int = 2,
                       link: LinkClass = NVLINK) -> Literal["row", "col"]:
    """Rank row- vs column-parallel with the Table-1 cost model.

    row: all-reduce of the (m_tokens, n) output; col: none now, but the
    activation stays sharded (cost deferred to the consumer -- modeled as an
    eventual all-gather of the same size).  The decision reduces to whether
    the *consumer* contracts over n (then 'col' is free) -- callers pass the
    effective sizes; ties break to 'col' (lazier)."""
    m_bytes = m_tokens * n * bytes_per_elt
    row_cost = costmodel.t_all_reduce(m_bytes, p, link)
    col_cost = costmodel.t_all_gather(m_bytes / p, p, link)
    return "row" if row_cost < col_cost else "col"


def dns_matmul_2d(x: torch.Tensor, w: torch.Tensor, *, mesh: ProcessMesh | None = None,
                  contract_axis: str = "data", out_axis: str = "model",
                  preferred_element_type: torch.dtype = torch.float32) -> torch.Tensor:
    """2.5D/DNS-flavoured matmul: the contraction dim sharded over
    ``contract_axis`` *and* the output sharded over ``out_axis`` -- the
    LM-mesh projection of the paper's 3D decomposition.  x is replicated
    over ``out_axis``; the partial products are summed over
    ``contract_axis``, an all-reduce p_out times smaller than plain
    row-parallel's."""

    def body(xl, wl):
        part = _matmul(copy_d(xl, out_axis), wl, preferred_element_type)
        return reduce_sum(part, contract_axis)

    nx = x.dim()
    return _on_mesh(body, mesh,
                    (P(*([None] * (nx - 1) + [contract_axis])), P(contract_axis, out_axis)),
                    P(*([None] * (nx - 1) + [out_axis])), x, w)
