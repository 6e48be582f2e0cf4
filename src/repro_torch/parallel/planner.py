"""Cost-driven auto-parallel planner: enumerate the layout lattice, reject
memory-infeasible points, rank the rest by predicted step time.  The port
of the JAX package's ``parallel/planner.py``; its defaults are the port's
H100 constants (``core/costmodel.py``: 80 GB a card, the ``NVLINK`` link
class, the tensor cores' bf16 peak and HBM3's rate), uncalibrated, so every
time it gives is a prediction on a data sheet.

The paper's core claim is that the Table-1 cost model lets you *pick* the
parallel layout analytically instead of guessing a config.  ``ParallelPlan``
is the first-class layout object (what ``ParallelConfig`` fields used to
encode ad hoc); ``plan_search`` scores every valid point of the lattice with
``costmodel.train_memory_bytes`` / ``train_step_cost`` and returns them
ranked; ``default_plan`` is the drop-in replacement for the old hand-written
``launch/dryrun.default_pcfg`` rule table.

Every cost term maps to a Table-1 collective of the paper:

  | term      | collective (Table 1)           | cost shape                     |
  |-----------|--------------------------------|--------------------------------|
  | tp_comm_s | reduceD pair per layer (XLA    | 4L · 2(t_s log p + t_w m (p-1)/p) |
  |           | all-reduce = RS+AG)            |                                |
  | gather_s  | allGatherD of the FSDP param   | 2 · (p-1)(t_s + t_w m)         |
  |           | shard, fwd + bwd               |                                |
  | grad_s    | all_reduce: reduceD pair;      | 2(t_s log p + t_w m (p-1)/p)   |
  |           | zero: ring reduceScatterD      | (p-1)(t_s + t_w m/p)           |
  |           |   + allGatherD of the updated  | + (p-1)(t_s + t_w m/p)         |
  |           |   param shard                  |                                |
  | ep_s      | allToAllD token dispatch+      | 2(t_s log p + t_w m (p-1))     |
  |           | return (a2a expert layout)     |                                |
  | update_s  | mapD (no comm): optimizer HBM  | bytes / (shard · HBM_BW)       |
  |           | traffic on the local shard     |                                |

The layout the search mostly picks for training is the ZeRO one
(Rajbhandari et al.): grads reduce-scattered, optimizer updating only the
local shard, params all-gathered — Θ(2m (p-1)/p) wire and 1/p of the
optimizer memory/traffic vs the all-reduce step's Θ(4m (p-1)/p) wire plus p
redundant full updates.  ``parallel/steps.make_train_step_zero`` implements
it; the CPU tests pin its trajectory to the all-reduce step's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.core import costmodel
from repro_torch.core.costmodel import HBM_PER_CHIP, NVLINK, LinkClass


@dataclass(frozen=True)
class ParallelPlan:
    """One point of the layout lattice — the first-class parallel layout.

    ``to_pcfg()`` bridges to the ``ParallelConfig`` the model/step code
    consumes; the plan itself carries the mesh geometry the config never
    knew, which is what makes it scoreable."""
    mesh_shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")
    fsdp_axes: Tuple[str, ...] = ("data",)   # () = params replicated
    tp: int = 16                             # model-axis degree (1 = TP off)
    ep_mode: str = "none"                    # none | shard | a2a  (MoE)
    dp_over_model: bool = False              # TP off: batch over both axes
    grad: str = "all_reduce"                 # all_reduce | reduce_scatter_zero
    remat: str = "full"                      # none | dots | full
    grad_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    master_weights: bool = False

    @property
    def chips(self) -> int:
        return math.prod(self.mesh_shape)

    @property
    def model_size(self) -> int:
        return self.mesh_shape[self.axis_names.index("model")]

    @property
    def dp(self) -> int:
        """Grad-reduction group: every chip not used for TP."""
        return self.chips // self.tp

    @property
    def fsdp_shard(self) -> int:
        s = 1
        for a in self.fsdp_axes:
            s *= self.mesh_shape[self.axis_names.index(a)]
        return s

    def to_pcfg(self) -> ParallelConfig:
        return ParallelConfig(
            fsdp_params=bool(self.fsdp_axes),
            fsdp_pod="pod" in self.fsdp_axes,
            grad_reduce=self.grad if self.grad != "none" else "all_reduce",
            opt_state_dtype=self.opt_state_dtype,
            grad_dtype=self.grad_dtype,
            remat=self.remat,
            moe_a2a_ep=self.ep_mode == "a2a",
            master_weights=self.master_weights,
            dp_over_model=self.dp_over_model,
        )

    def label(self) -> str:
        fsdp = "+".join(self.fsdp_axes) if self.fsdp_axes else "off"
        grad = {"all_reduce": "allreduce", "reduce_scatter_zero": "zero",
                "none": "-"}[self.grad]
        bits = [f"fsdp={fsdp}", f"tp={self.tp}", f"grad={grad}",
                f"remat={self.remat}",
                f"opt={'bf16' if self.opt_state_dtype == 'bfloat16' else 'f32'}"]
        if self.ep_mode != "none":
            bits.insert(3, f"ep={self.ep_mode}")
        return " ".join(bits)


@dataclass(frozen=True)
class RankedPlan:
    plan: ParallelPlan
    cost: dict                    # costmodel.train_step_cost terms (+ ep_s)
    memory: dict                  # costmodel.train_memory_bytes breakdown
    feasible: bool

    @property
    def total_s(self) -> float:
        return self.cost["total_s"]


def _dtype_bytes(name: str) -> int:
    return 2 if name in ("bfloat16", "float16") else 4


def _ep_cost(cfg: ModelConfig, plan: ParallelPlan, batch_local: int,
             seq: int, link: LinkClass) -> float:
    """a2a expert layout: token dispatch + return — two allToAllD of the
    per-destination token slab (Table-1 Θ(t_s log p + t_w m (p-1)))."""
    if plan.ep_mode != "a2a" or cfg.moe is None:
        return 0.0
    ep = plan.model_size
    n_moe = cfg.block_pattern.count("attn_moe") * (
        cfg.n_layers // len(cfg.block_pattern))
    m = batch_local * seq * cfg.d_model * 2 * cfg.moe.top_k / max(ep, 1)
    return 2.0 * n_moe * costmodel.t_all_to_all(m, ep, link) * 3  # fwd+bwd

def plan_search(cfg: ModelConfig, mesh_shape: Tuple[int, ...] = (16, 16),
                batch: int = 256, seq: int = 4096, kind: str = "train", *,
                axis_names: Optional[Tuple[str, ...]] = None,
                hbm: float = HBM_PER_CHIP, budget: float = 0.9,
                link: LinkClass = NVLINK,
                peak_flops: float = costmodel.PEAK_FLOPS_BF16,
                hbm_bw: float = costmodel.HBM_BW) -> List[RankedPlan]:
    """Enumerate the valid plan lattice for ``cfg`` on a mesh, reject points
    whose training state doesn't fit ``budget · hbm`` per device, and return
    every point ranked: feasible plans by predicted step time (deterministic
    tie-break on the label), then infeasible ones by how far over memory
    they are — so the head of the list is always the best *runnable* plan
    and the list is never empty."""
    if axis_names is None:
        axis_names = ("pod", "data", "model") if len(mesh_shape) == 3 \
            else ("data", "model")
    assert len(axis_names) == len(mesh_shape), (axis_names, mesh_shape)
    if kind != "train":
        return _plan_search_serve(cfg, mesh_shape, batch, seq,
                                  axis_names=axis_names, hbm=hbm,
                                  budget=budget, link=link,
                                  peak_flops=peak_flops, hbm_bw=hbm_bw)

    model_size = mesh_shape[axis_names.index("model")]
    has_pod = "pod" in axis_names
    pc = cfg.param_counts()
    param_bytes = _dtype_bytes(cfg.param_dtype)
    fsdp_options: List[Tuple[str, ...]] = [(), ("data",)]
    if has_pod:
        fsdp_options.append(("pod", "data"))
    tp_options = [(model_size, False)] if model_size > 1 else [(1, False)]
    if model_size > 1:
        tp_options.append((1, True))          # dp_over_model: pure DP
    if cfg.moe is not None:
        ep_modes = ["shard", "a2a"] if cfg.moe.n_experts % model_size == 0 \
            and cfg.moe.n_experts >= model_size else ["shard"]
    else:
        ep_modes = ["none"]

    ranked: List[RankedPlan] = []
    for fsdp_axes in fsdp_options:
        for tp, dpom in tp_options:
            for ep_mode in ep_modes:
                if dpom and ep_mode == "a2a":
                    continue                  # a2a routes over the model axis
                # with FSDP storage the reduction IS a reduce-scatter (the
                # scatter specs are the param specs) — only the replicated
                # layout has a genuine all-reduce vs zero choice
                grads = ["reduce_scatter_zero"] if fsdp_axes \
                    else ["all_reduce", "reduce_scatter_zero"]
                for grad in grads:
                    for remat in ("none", "full"):
                        for opt_dtype in ("float32", "bfloat16"):
                            p = ParallelPlan(
                                mesh_shape=mesh_shape, axis_names=axis_names,
                                fsdp_axes=fsdp_axes, tp=tp, ep_mode=ep_mode,
                                dp_over_model=dpom, grad=grad, remat=remat,
                                opt_state_dtype=opt_dtype)
                            if p.dp < 2 and grad == "reduce_scatter_zero":
                                continue      # nothing to scatter over
                            ranked.append(_score_train(
                                cfg, p, pc, batch, seq, param_bytes,
                                hbm * budget, link, peak_flops, hbm_bw))
    feas = sorted((r for r in ranked if r.feasible),
                  key=lambda r: (r.total_s, r.plan.label()))
    infeas = sorted((r for r in ranked if not r.feasible),
                    key=lambda r: (r.memory["total"], r.plan.label()))
    return feas + infeas


def _score_train(cfg: ModelConfig, plan: ParallelPlan, pc: dict, batch: int,
                 seq: int, param_bytes: int, hbm_budget: float,
                 link: LinkClass, peak_flops: float,
                 hbm_bw: float) -> RankedPlan:
    # ceil-div: a batch the dp group doesn't divide leaves some chips with a
    # padded row (mirrors make_cell_ctx dropping non-dividing axes) — scored
    # approximately rather than filtered, so the list is never empty
    batch_local = max(1, math.ceil(batch / plan.dp))
    act = costmodel.train_activation_bytes(
        batch_local, seq, cfg.d_model, max(cfg.d_ff // plan.tp, 1),
        cfg.n_layers, max(cfg.vocab // plan.tp, 1), remat=plan.remat)
    mem = costmodel.train_memory_bytes(
        pc["total"], tp=plan.tp, fsdp_shard=plan.fsdp_shard, dp=plan.dp,
        grad=plan.grad, param_bytes=param_bytes,
        grad_bytes=_dtype_bytes(plan.grad_dtype),
        opt_state_bytes=_dtype_bytes(plan.opt_state_dtype),
        master=plan.master_weights, activation_bytes=act)
    cost = costmodel.train_step_cost(
        pc["active"], pc["total"], tokens=float(batch) * seq,
        chips=plan.chips, tp=plan.tp, dp=plan.dp,
        fsdp_shard=plan.fsdp_shard, grad=plan.grad, batch_local=batch_local,
        seq=seq, d_model=cfg.d_model, n_layers=cfg.n_layers,
        param_bytes=2,                        # gathers/streams run in bf16
        grad_bytes=_dtype_bytes(plan.grad_dtype),
        opt_state_bytes=_dtype_bytes(plan.opt_state_dtype),
        master=plan.master_weights, remat=plan.remat, link=link,
        peak_flops=peak_flops, hbm_bw=hbm_bw)
    ep_s = _ep_cost(cfg, plan, batch_local, seq, link)
    cost = dict(cost, ep_s=ep_s, total_s=cost["total_s"] + ep_s)
    return RankedPlan(plan=plan, cost=cost, memory=mem,
                      feasible=mem["total"] <= hbm_budget)


def _plan_search_serve(cfg: ModelConfig, mesh_shape, batch, seq, *,
                       axis_names, hbm, budget, link, peak_flops,
                       hbm_bw) -> List[RankedPlan]:
    """Serving lattice (much smaller: no grads/optimizer): params bf16,
    TP-resident when the shard fits (no per-token FSDP gathers), FSDP
    storage otherwise; scored with ``costmodel.decode_step_cost``."""
    chips = math.prod(mesh_shape)
    model_size = mesh_shape[axis_names.index("model")]
    total = cfg.param_counts()["total"]
    has_pod = "pod" in axis_names
    ranked: List[RankedPlan] = []
    for fsdp_axes in ([(), ("data",)] + ([("pod", "data")] if has_pod else [])):
        plan = ParallelPlan(mesh_shape=mesh_shape, axis_names=axis_names,
                            fsdp_axes=fsdp_axes, tp=model_size,
                            ep_mode="none", grad="none", remat="none",
                            opt_state_dtype="float32")
        shard = plan.tp * plan.fsdp_shard
        p_dev = total * 2.0 / shard
        mem = {"params": p_dev, "grads": 0.0, "opt": 0.0,
               "activations": 0.0, "total": p_dev}
        cost = costmodel.decode_step_cost(
            cfg.param_counts()["active"], batch, chips=chips,
            peak_flops=peak_flops, hbm_bw=hbm_bw)
        if fsdp_axes:
            # per-token param regather over the fsdp axes — the reason
            # TP-resident wins whenever the shard fits
            gather = costmodel.t_all_gather(total * 2.0 / shard,
                                            plan.fsdp_shard, link)
            cost = dict(cost, gather_s=gather, comm_s=gather,
                        total_s=cost["total_s"] + gather)
        else:
            cost = dict(cost, gather_s=0.0, comm_s=0.0)
        # TP-resident needs comfortable headroom for the KV cache: the old
        # rule table's 12 GiB line, kept as ¾ of the budgeted HBM
        limit = hbm * budget * (5.0 / 6.0 if not fsdp_axes else 1.0)
        ranked.append(RankedPlan(plan=plan, cost=cost, memory=mem,
                                 feasible=p_dev < limit))
    feas = sorted((r for r in ranked if r.feasible),
                  key=lambda r: (r.total_s, r.plan.label()))
    infeas = sorted((r for r in ranked if not r.feasible),
                    key=lambda r: (r.memory["total"], r.plan.label()))
    return feas + infeas


def default_plan(arch: str, kind: str, *, multi_pod: bool = False,
                 **search) -> ParallelPlan:
    """The plan the cost model picks for an (arch × shape-kind) cell on the
    production mesh — the replacement for the old hand-written
    ``dryrun.default_pcfg`` rule table.  ``search``: ``plan_search``'s
    machine constants (``hbm``, ``budget``, ``link``, ``peak_flops``,
    ``hbm_bw``)."""
    from repro_torch import configs
    from repro_torch.config import SHAPES
    from repro_torch.launch.mesh import production_mesh_shape
    cfg = configs.get(arch)
    mesh_shape, _ = production_mesh_shape(multi_pod=multi_pod)
    shape = SHAPES["train_4k" if kind == "train" else
                   ("prefill_32k" if kind == "prefill" else "decode_32k")]
    ranked = plan_search(cfg, mesh_shape, shape.global_batch, shape.seq_len,
                         kind, **search)
    return best_plan(ranked)


def best_plan(ranked: List[RankedPlan]) -> ParallelPlan:
    """Head of a ranked lattice with the numerics guard the time model
    can't see: bf16 moments only buy HBM bytes, so keep f32 optimizer
    states unless no f32 point fits."""
    for r in ranked:
        if r.feasible and r.plan.opt_state_dtype == "float32":
            return r.plan
    return ranked[0].plan


def format_plan_table(ranked: List[RankedPlan], top: int = 12) -> str:
    """Markdown table of the ranked lattice (``roofline --plan``)."""
    rows = ["| # | plan | mem/dev GiB | fits | compute_s | comm_s | "
            "update_s | total_s |",
            "|---|---|---|---|---|---|---|---|"]
    for i, r in enumerate(ranked[:top]):
        c = r.cost
        rows.append(
            f"| {i + 1} | {r.plan.label()} | "
            f"{r.memory['total'] / 2**30:.2f} | "
            f"{'y' if r.feasible else 'OOM'} | {c['compute_s']:.4f} | "
            f"{c.get('comm_s', 0) + c.get('ep_s', 0):.4f} | "
            f"{c.get('update_s', 0):.4f} | {c['total_s']:.4f} |")
    return "\n".join(rows)
