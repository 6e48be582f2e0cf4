"""Mixture-of-Experts layer, and ``MeshCtx``: the port of the JAX package's
``models/moe.py``.

One process (``ctx=None``): top-k routing on f32 logits (a stable
descending sort, so ties go to the lower expert id as ``lax.top_k`` gives
them), softmax over the k picked logits, the assignments sorted by expert
(stable), and each expert's rows multiplied as one group (JAX's
``lax.ragged_dot``: rows past the groups' sum give 0).  The groups' bounds
stay on the device (``_offsets``) and two launches of
``kernels/grouped_matmul.py`` take them, gate and up in one and down in the
other (the kernels on the card, their plain versions on the CPU); on
``meta``, while autograd records, and on the card in f32 arithmetic, a loop
of one product per expert runs instead, bounded by group sizes read back to
the host (``_on_loop``).
The outputs are combined without a scatter-add: each expert row is put back
at its (token, slot) place and the k slots of a token are summed in slot
order, so the sum is the same on every run (no atomics).

Under a mesh ctx (inside one rank of ``core.mesh``; the activations are
replicated over ``model``), the three layouts of the reference:

  * ``ep`` (experts over ``model``, ``n_experts % model == 0``): each rank
    takes its tokens' assignments to its experts, first come first served
    up to the capacity ``ceil(T k / ep * capacity_factor)``, and the
    partial outputs (the shared expert's ff-slice partial added first) are
    ``reduceD("sum")``'d over ``model``;
  * ``tp`` (fewer experts than ranks): every rank computes every
    assignment on its ``d_ff / model`` slice (dropless), the same sum;
  * ``a2a`` (``moe_a2a_ep``): experts resident, ``E / data`` over
    ``data`` and ``d_ff / model`` over ``model``; tokens travel to their
    expert's data shard by ``allToAllD``, the products' partials are summed
    over ``model``, and the outputs travel back.

Expert weights sharded over the fsdp axes are all-gathered first (their
gradients reduce-scattered).  Gradients: the replicated input and routing
weights enter each rank's partial product through ``copy_d`` (their
cotangents summed over ``model``), while the logits' own path (the aux
loss) is the same on every rank; so every model-replicated gradient is the
same on each rank, as ``parallel/steps.py`` expects.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.dseq import all_to_all_dim, copy_d, reduce_sum
from repro_torch.core.mesh import AbstractMesh
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.runtime import trace

Params = dict
_DRAW_ELEMS = 2 ** 28       # an expert leaf is drawn in f32 slices of at most 1 GiB

# when a list, ``_route`` appends each call's picked experts (T, k) to it, on
# the host: a probe for comparing the routing of two paths
routes: Optional[list] = None


@dataclass(frozen=True)
class MeshCtx:
    """Where a model call runs: the rank's mesh (a ``core.mesh.ProcessMesh``,
    or an ``AbstractMesh`` where only the layout is computed) and the role
    of each axis."""
    mesh: AbstractMesh
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp_axes: Tuple[str, ...] = ("data",)   # axes params are sharded over
    moe_a2a_ep: bool = False                 # token-routing EP (§Perf H6)
    engine_replicate: bool = False           # SSM/mLSTM engine batch-shard only
    seq_parallel: bool = False               # S-sharded residual (§Perf H5)
    foopar_tp: bool = False                  # algebra (DSeq) TP matmuls in MLP
    manual_attention: bool = False           # manual SDPA region (§Perf A8)
    dp_over_model: bool = False              # pure DP over both axes (§Perf C7)

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(self.mesh.axis_names)

    @property
    def model_size(self) -> int:
        return self.mesh.size(self.model_axis)


def _experts(gen: Optional[torch.Generator], shape, std: float, dtype: torch.dtype):
    """An (E, ., .) expert leaf, normal with std ``std``, drawn in f32 and
    rounded to ``dtype`` a slice of experts at a time, so a large leaf
    never exists whole in f32 beside its rounded copy."""
    from repro_torch.models.layers import _normal
    if gen is None or dtype == torch.float32:
        return _normal(gen, shape, std, dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    step = max(1, _DRAW_ELEMS // (shape[1] * shape[2]))
    for lo in range(0, shape[0], step):
        hi = min(shape[0], lo + step)
        out[lo:hi] = _normal(gen, (hi - lo,) + tuple(shape[1:]), std, dtype)
    return out


def moe_init(gen: Optional[torch.Generator], cfg: ModelConfig,
             dtype: Optional[torch.dtype] = None) -> Params:
    """Router (d, E) in f32 whatever the dtype (JAX draws it so); experts
    (E, d, ff) and (E, ff, d) and the shared expert's matrices in the
    parameter dtype, or ``dtype``."""
    from repro_torch.models.layers import _normal, _pdtype, dense_init
    e = cfg.moe
    d, ff = cfg.d_model, e.d_ff_expert
    dt = dtype or _pdtype(cfg)
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": _normal(gen, (d, e.n_experts), scale, torch.float32),
        "w_gate": _experts(gen, (e.n_experts, d, ff), scale, dt),
        "w_up": _experts(gen, (e.n_experts, d, ff), scale, dt),
        "w_down": _experts(gen, (e.n_experts, ff, d), 1.0 / math.sqrt(ff), dt),
    }
    if e.n_shared_experts:
        sff = ff * e.n_shared_experts
        p["shared"] = {"w_gate": dense_init(gen, d, sff, cfg, dtype=dtype),
                       "w_up": dense_init(gen, d, sff, cfg, dtype=dtype),
                       "w_down": dense_init(gen, sff, d, cfg, dtype=dtype)}
    return p


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last dim, in descending order,
    ties to the lower index (``torch.topk`` breaks ties otherwise)."""
    v, i = torch.sort(logits, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, k: int):
    """Top-k routing with softmax-renormalised weights, all f32.  Returns
    (picked experts (T, k), their weights (T, k), the router's
    probabilities (T, E) for the aux loss)."""
    logits = torch.matmul(x_flat.float(), router_w.float())
    top_v, top_i = top_k(logits, k)
    if routes is not None:
        with trace.span("sync", site="moe_routes"):
            routes.append(top_i.detach().cpu())
    return top_i, torch.softmax(top_v, dim=-1), torch.softmax(logits, dim=-1)


def _on_loop(xs: torch.Tensor, ws) -> bool:
    """Whether the experts' products take the per-expert loop
    (``grouped_matmul.ragged_swiglu``): on ``meta`` (the dry run counts the
    balanced split's products), while autograd records (the kernels have no
    backward), and on the card in f32 arithmetic (the kernels are bf16's;
    the card's f32 oracles run so).  What decides is the call's device,
    dtype and autograd state, never its layout: every other call takes the
    offsets on the device, and on the card a layout the kernels do not take
    raises there."""
    if xs.device.type == "meta":
        return True
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xs, *ws)):
        return True
    return xs.is_cuda and xs.dtype == torch.float32


def _expert_ffn(xs, eid, w_gate, w_up, w_down, dtype, slots=None, scale=None) -> torch.Tensor:
    """Grouped SwiGLU over rows sorted by expert id ``eid`` (ids at or past
    E last; their rows give 0), in a ``moe.experts`` span (``experts``:
    those given a row; ``rows``: the assignments).  With ``slots`` and
    ``scale`` the rows come back put in place and weighted
    (``grouped_matmul.scatter``; the down kernel's epilogue does it).  Off
    the loop (``_on_loop``) the groups' offsets stay on the device and the
    host reads nothing back, except while a profile records: then it reads
    the sizes for the span (sync site ``moe_sizes``, as the loop reads them)
    and waits for the products before the span ends (site ``moe_experts``),
    so the device operations that start in the span are all of the
    products."""
    n = w_gate.shape[0]
    xs = xs.to(dtype)
    loop = _on_loop(xs, (w_gate, w_up, w_down))
    if loop:
        sizes = _sizes(eid, n)
    else:
        offsets = _offsets(eid, n)
        with trace.span("sync", site="moe_sizes") as sp:
            sizes = None if sp is trace._OFF else torch.diff(offsets).tolist()
    with trace.span("moe.experts") as sp:
        if sp is not trace._OFF:            # counted only while a profile records
            sp.set(experts=sum(k > 0 for k in sizes), rows=sum(sizes))
        if loop:
            ys = gm.ragged_swiglu(xs, w_gate, w_up, w_down, sizes)
            return ys if slots is None else gm.scatter(ys, slots, scale)
        ys = gm.grouped_down(gm.grouped_gate_up(xs, w_gate, w_up, offsets), w_down, offsets,
                             slots, scale)
        if sp is not trace._OFF:
            with trace.span("sync", site="moe_experts"):
                if ys.is_cuda:
                    torch.cuda.current_stream(ys.device).synchronize()
        return ys


def _offsets(eid: torch.Tensor, n: int) -> torch.Tensor:
    """The groups' bounds of ids sorted ascending, on their device: (n + 1,)
    int32, ``offsets[e]`` the ids below e (ids at or past n count in
    none).  A binary search, so nothing is read back to the host (CUDA's
    ``bincount`` reads the ids' range back)."""
    return torch.searchsorted(eid, torch.arange(n + 1, dtype=eid.dtype, device=eid.device),
                              out_int32=True)


def _sizes(eid: torch.Tensor, n: int) -> List[int]:
    """Rows per expert id in ``[0, n)`` (ids outside are not counted), on
    the host: the grouped product's loop bounds.  On ``meta`` (the dry run,
    where routing has no values) the balanced split: every row counted,
    spread evenly over the n experts, so the grouped products' FLOPs are
    exact whatever the routing."""
    if eid.device.type == "meta":
        q, r = divmod(eid.numel(), n)
        return [q + (i < r) for i in range(n)]
    with trace.span("sync", site="moe_sizes"):
        eid = eid[(eid >= 0) & (eid < n)]
        return torch.bincount(eid, minlength=n).tolist()


def _kept(mask: torch.Tensor, full: int) -> torch.Tensor:
    """The indices where ``mask`` holds, in order; on ``meta`` the balanced
    routing's: ``full`` of them, the body's static capacity filled."""
    if mask.device.type == "meta":
        return torch.empty((full,), dtype=torch.int64, device="meta")
    with trace.span("sync", site="moe_kept"):
        return torch.nonzero(mask).squeeze(1)


def _combine(ys: torch.Tensor, slots: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_j w[t, j] y[t, j] in f32, from expert rows ``ys[i]`` of the
    assignments ``slots[i]`` (flat index t * k + j; each at most once,
    unlisted ones give 0).  A weighted put and a sum over the k slots in
    order: no scatter-add, so the result does not depend on the order of
    the rows."""
    return _slot_sum(gm.scatter(ys, slots, weights.reshape(-1)), weights.shape[1])


def _slot_sum(full: torch.Tensor, k: int) -> torch.Tensor:
    """The weighted rows of the (t * k) assignments summed over each token's
    k slots, in slot order."""
    return full.reshape(-1, k, full.shape[-1]).sum(dim=1)


def _shared_ffn(x_flat: torch.Tensor, shared: Params, cfg: ModelConfig) -> torch.Tensor:
    """The shared expert: dense SwiGLU with f32 products; under a ctx its
    ff is sharded over ``model`` and this is the rank's partial."""
    from repro_torch.models.layers import _dtype, _matmul_f32
    dt = _dtype(cfg)
    x = x_flat.to(dt)
    g = _matmul_f32(x, shared["w_gate"].to(dt))
    u = _matmul_f32(x, shared["w_up"].to(dt))
    h = (F.silu(g) * u).to(dt)
    return _matmul_f32(h, shared["w_down"].to(dt))


def _body_all(x_e, route, w_gate, w_up, w_down, dtype) -> torch.Tensor:
    """Every assignment of every token, dropless (the ``tp`` layout; with one
    rank, the whole layer): ``x_e`` and the routing weights feed the
    experts, the partial (T, d) f32 comes back."""
    top_i, weights = route
    k = weights.shape[1]
    eid, g_order = torch.sort(top_i.reshape(-1), stable=True)
    xs = x_e.index_select(0, g_order // k)
    full = _expert_ffn(xs, eid, w_gate, w_up, w_down, dtype, g_order, weights.reshape(-1))
    return _slot_sum(full, k)


def _body_ep(x_e, route, w_gate, w_up, w_down, cfg, dtype, *, ep: int, shard: int):
    """This rank's experts (``E / ep`` of them, from ``shard * E / ep``):
    its assignments in token order up to the capacity, the rest dropped."""
    e = cfg.moe
    top_i, weights = route
    t, k = weights.shape
    e_local = e.n_experts // ep
    cap = max(8, min(int(math.ceil(t * k / ep * e.capacity_factor)), t * k))
    flat_e = top_i.reshape(-1)
    mine = _kept(flat_e // e_local == shard, cap)[:cap]   # first come
    eid, g_order = torch.sort(flat_e[mine] - shard * e_local, stable=True)
    slots = mine[g_order]
    xs = x_e.index_select(0, slots // k)
    full = _expert_ffn(xs, eid, w_gate, w_up, w_down, dtype, slots, weights.reshape(-1))
    return _slot_sum(full, k)


def _body_a2a(x_flat, x_sh, route, w_gate, w_up, w_down, shared, cfg, dtype, ctx):
    """Token routing: this rank's assignments go to the data shard that
    holds their expert (``E / dp`` experts a shard), at most ``cap`` to
    each (first come), by ``allToAllD`` over ``data``; the received rows
    run through the resident experts' ff slices, summed over ``model``, and
    go back the same way."""
    e = cfg.moe
    mesh, M = ctx.mesh, ctx.model_axis
    top_i, weights = route
    t, k = weights.shape
    d = x_flat.shape[1]
    dp = mesh.size("data")
    e_local = e.n_experts // dp
    cap = max(8, int(math.ceil(t * k / dp * e.capacity_factor)))
    flat_e = top_i.reshape(-1)
    dest = flat_e // e_local
    slot = torch.cumsum(F.one_hot(dest, dp), dim=0).gather(1, dest[:, None])[:, 0] - 1
    sel = _kept(slot < cap, min(t * k, dp * cap))
    place = dest[sel] * cap + slot[sel]                      # (dest, slot) flat
    send = x_flat.new_zeros((dp * cap, d), dtype=dtype).index_put(
        (place,), x_flat.index_select(0, sel // k).to(dtype))
    meta = torch.full((dp * cap,), -1, dtype=torch.int64, device=x_flat.device)
    meta = meta.index_put((place,), flat_e[sel] % e_local)
    rx = all_to_all_dim(send.reshape(dp, cap, d), "data", 0, 0, mesh).reshape(dp * cap, d)
    reid = mesh.all_to_all(meta, "data")
    reid, g_order = torch.sort(torch.where(reid >= 0, reid, e_local), stable=True)
    # the received rows are the same on every rank of a model group, each
    # multiplies its ff slice: the input's cotangent sums over model
    xs = copy_d(rx, M, mesh).index_select(0, g_order)
    ys = _expert_ffn(xs, reid, w_gate, w_up, w_down, dtype)
    ys = reduce_sum(ys.float(), M, mesh)
    back = ys.new_zeros(ys.shape).index_put((g_order,), ys)      # unsorted
    back = all_to_all_dim(back.reshape(dp, cap, d), "data", 0, 0, mesh).reshape(dp * cap, d)
    out = _combine(back.index_select(0, place), sel, weights)
    if shared is not None:
        out = out + reduce_sum(_shared_ffn(x_sh, shared, cfg), M, mesh)
    return out


def _gathered(p: Params, cfg: ModelConfig, ctx, model_dims: Optional[dict]) -> Params:
    """The expert leaves (with ``model_dims``, a dict naming the dim each
    must have split over ``model``; None skips them) and the shared expert's
    this rank multiplies with: its blocks, all-gathered over the fsdp axes
    (``layers._weight``) in their stored dtype, as JAX gathers them; the
    products cast them (an expert at a time)."""
    from repro_torch.models.layers import _weight
    e = cfg.moe
    d, ff = cfg.d_model, e.d_ff_expert
    out = {}
    if model_dims is not None:
        shapes = {"w_gate": (e.n_experts, d, ff), "w_up": (e.n_experts, d, ff),
                  "w_down": (e.n_experts, ff, d)}
        out = {n: _weight(p[n], ("moe", n), s, cfg, ctx, model_dim=model_dims.get(n))
               for n, s in shapes.items()}
    if "shared" in p:
        sff = ff * e.n_shared_experts
        out["shared"] = {
            n: _weight(w, ("moe", "shared", n), (sff, d) if n == "w_down" else (d, sff), cfg,
                       ctx, model_dim=None if ctx.dp_over_model else (0 if n == "w_down" else 1))
            for n, w in p["shared"].items()}
    return out


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: Optional[MeshCtx] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of x (B, S, d).  Returns (output (B, S, d) in the compute
    dtype, the router's probabilities (T, E) for the aux loss; under a ctx,
    this rank's rows).  The layout follows the ctx: a2a with
    ``ctx.moe_a2a_ep`` (and a ``data`` batch axis), else EP when ``model``
    divides the experts, else TP.  The layer is a ``moe.ffn`` span
    (``rows``: the B * S tokens)."""
    with trace.span("moe.ffn", rows=x.shape[0] * x.shape[1]):
        return _moe_ffn(p, x, cfg, ctx)


def _moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: Optional[MeshCtx]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.models.layers import _dtype
    e = cfg.moe
    dt = _dtype(cfg)
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    top_i, weights, probs = _route(x_flat, p["router"], e.top_k)

    if ctx is None or ctx.dp_over_model:
        # one process, or pure data parallelism (every weight whole on each
        # rank once the fsdp blocks are gathered)
        w = p if ctx is None else _gathered(p, cfg, ctx, {})
        out = _body_all(x_flat, (top_i, weights), w["w_gate"], w["w_up"], w["w_down"], dt)
        if "shared" in w:
            out = out + _shared_ffn(x_flat, w["shared"], cfg)
        return out.reshape(b, s, d).to(dt), probs

    mesh, M = ctx.mesh, ctx.model_axis
    x_e = copy_d(x_flat, M, mesh)
    if ctx.moe_a2a_ep and "data" in ctx.batch_axes:
        dp = mesh.size("data")
        if e.n_experts % dp:
            raise ValueError(f"a2a expert parallelism: {e.n_experts} experts do not split "
                             f"over {dp} data shards")
        shared = _gathered(p, cfg, ctx, None).get("shared")
        # the experts are resident: (E/dp, d, ff/tp) blocks, no gathers
        out = _body_a2a(x_flat, x_e, (top_i, weights), p["w_gate"], p["w_up"], p["w_down"],
                        shared, cfg, dt, ctx)
        return out.reshape(b, s, d).to(dt), probs

    ep = ctx.model_size
    route = (top_i, copy_d(weights, M, mesh))
    if e.n_experts % ep == 0 and e.n_experts >= ep:
        w = _gathered(p, cfg, ctx, {"w_gate": 0, "w_up": 0, "w_down": 0})
        out = _body_ep(x_e, route, w["w_gate"], w["w_up"], w["w_down"], cfg, dt,
                       ep=ep, shard=mesh.index(M))
    else:
        w = _gathered(p, cfg, ctx, {"w_gate": 2, "w_up": 2, "w_down": 1})
        out = _body_all(x_e, route, w["w_gate"], w["w_up"], w["w_down"], dt)
    if "shared" in w:
        out = out + _shared_ffn(x_e, w["shared"], cfg)      # its partial, before the sum
    out = reduce_sum(out, M, mesh)                           # reduceD("sum")
    return out.reshape(b, s, d).to(dt), probs


def load_balance_loss(probs: torch.Tensor, ctx: Optional[MeshCtx] = None) -> torch.Tensor:
    """Switch-style aux loss surrogate: E * sum_e mean_t(p_te)^2.  Under a
    ctx the mean is over every rank's rows (``reduceD("sum")`` over the
    batch axes of this rank's share), so each rank holds the global loss."""
    n_exp = probs.shape[-1]
    rows = probs.reshape(-1, n_exp)
    if ctx is None:
        me = rows.mean(dim=0)
    else:
        mesh = ctx.mesh
        n = rows.shape[0] * mesh.size(ctx.batch_axes)
        me = reduce_sum(rows.sum(dim=0) / n, ctx.batch_axes, mesh)
    return n_exp * torch.sum(me * me)
