"""AdamW from scratch, with state-dtype compression.

The JAX package's optimizer, function for function, on the port's trees
(``repro_torch.tree``): all math in f32, m and v stored in their configured
dtype, decoupled weight decay on matrices only (``ndim > 1``), the step
counter an int32 0-d tensor.  ``decay`` names the leaves that decay where
the port's layout differs from JAX's (``models.transformer.decay_mask``).  ``state_dtype='bfloat16'`` halves the
optimizer's memory; ``master=True`` keeps an f32 copy of the parameters in
the state (the parameters themselves are then stored in bf16).

JAX's step donates its state buffers; here ``adamw_update`` writes its
results into the state's own tensors, leaf by leaf, so a step holds one
leaf's temporaries at a time and never a second copy of the parameters.

``adamw_update_zero`` is the ZeRO update on a rank of a mesh: the same
per-element arithmetic on the rank's scatter shard of each leaf, then an
all-gather back to the parameters' layout.
"""
from __future__ import annotations

from functools import reduce
from typing import Any, Tuple

import torch

from repro_torch.config import torch_dtype
from repro_torch.core.dseq import all_gather_dim
from repro_torch.core.mesh import P, ProcessMesh, local_block
from repro_torch.tree import leaves, tree_map

Tree = Any


def adamw_init(params: Tree, state_dtype: str = "float32", master: bool = False) -> Tree:
    dt = torch_dtype(state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    st = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
          "step": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)}
    if master:
        # f32 master copy, never aliasing a parameter (updates are in place)
        st["master"] = tree_map(lambda p: p.to(torch.float32, copy=True), params)
    return st


def global_norm(tree: Tree) -> torch.Tensor:
    sq = [torch.sum(g.float() ** 2) for g in leaves(tree)]
    return torch.sqrt(reduce(torch.add, sq, torch.zeros((), dtype=torch.float32,
                                                         device=sq[0].device)))


def clip_by_global_norm(grads: Tree, max_norm: float,
                        norm: torch.Tensor = None) -> Tuple[Tree, torch.Tensor]:
    """``norm``: the global norm when ``grads`` are a rank's blocks of a
    sharded tree (``global_norm`` of the blocks is not it)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw_update(grads: Tree, opt_state: Tree, params: Tree, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 decay: Tree = None) -> Tuple[Tree, Tree]:
    """Writes the new parameters, moments, master copy and step into the
    tensors of ``params`` and ``opt_state`` and returns those two trees.
    ``decay``: a tree of bools in ``params``' structure, the leaves that
    take weight decay (default: those with ``ndim > 1``)."""
    step = opt_state["step"] + 1
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    g_l, m_l, v_l, p_l = (leaves(t) for t in (grads, opt_state["m"], opt_state["v"], params))
    w_l = leaves(opt_state["master"]) if "master" in opt_state else [None] * len(p_l)
    d_l = leaves(decay) if decay is not None else [p.dim() > 1 for p in p_l]
    if not len(g_l) == len(m_l) == len(v_l) == len(p_l) == len(w_l) == len(d_l):
        raise ValueError("adamw_update: grads, moments and params differ in structure")
    for g, m, v, p, mast, dec in zip(g_l, m_l, v_l, p_l, w_l, d_l):
        g32 = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
        del g32
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
        base = mast.to(torch.float32) if mast is not None else p.to(torch.float32)
        if dec:
            delta = delta + weight_decay * base
        p_new = base - lr * delta
        del delta, base
        p.copy_(p_new)              # copy_ rounds to the leaf's dtype
        m.copy_(m32)
        v.copy_(v32)
        if mast is not None:
            mast.copy_(p_new)
    opt_state["step"].copy_(step)
    return params, opt_state


def scatter_part(scatter_spec: P, param_spec: P) -> P:
    """What the scatter layout splits beyond the parameters' layout: the
    entries of ``scatter_spec`` that differ from ``param_spec``, None
    elsewhere (a spec relative to the parameters' local block)."""
    n = max(len(scatter_spec), len(param_spec))
    s = tuple(scatter_spec) + (None,) * (n - len(scatter_spec))
    g = tuple(param_spec) + (None,) * (n - len(param_spec))
    return P(*[a if a != b else None for a, b in zip(s, g)])


def adamw_update_zero(grads: Tree, opt_state: Tree, params: Tree, *, scatter: Tree,
                      gather: Tree, mesh: ProcessMesh, lr, b1: float = 0.9,
                      b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                      decay: Tree = None) -> Tuple[Tree, Tree]:
    """ZeRO sharded-update path (Rajbhandari et al. section 5), inside one
    rank of ``mesh``.

    ``scatter`` is the spec tree of the grad reduce-scatter layout
    (``sharding.scatter_specs``), ``gather`` the parameters' (``param_specs``).
    ``grads`` and the moments (and master copy) are this rank's blocks in
    the scatter layout, ``params`` its blocks in the parameters' layout.
    ``adamw_update`` runs verbatim on the rank's scatter shard of each
    parameter block (a view, written in place), so the per-element
    arithmetic, and the trajectory, are the all-reduce step's; then each
    leaf's shards are all-gathered over the scatter axes into the whole
    block for the next forward.  Every rank gathers every leaf in one
    order."""
    rel = tree_map(scatter_part, scatter, gather)
    views = tree_map(lambda p, r: local_block(p, r, mesh), params, rel)
    adamw_update(grads, opt_state, views, lr=lr, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay, decay=decay)
    for p, v, r in zip(leaves(params), leaves(views), leaves(rel)):
        for d, part in enumerate(r):
            if part is not None:
                p.copy_(all_gather_dim(v, part, d, mesh))
    return params, opt_state
