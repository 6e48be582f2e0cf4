"""FooPar Table-1 cost model + isoefficiency analysis, with H100 constants.

The paper's message-passing cost is t_c = t_s + t_w * m (start-up + per-word).
The symbolic model is the JAX package's, formula for formula; only the
constants describe another machine, one NVIDIA H100 SXM (80 GB HBM3):

  NVLINK  (GPU to GPU, NVLink 4)   450 GB/s per direction, t_s assumed 2 us
  IB      (node to node)           50 GB/s (NDR 400 Gb/s), t_s assumed 5 us
  HBM     (roofline memory term)   3.35 TB/s
  tensor cores                     989 TFLOP/s dense bf16

The rates are NVIDIA's data-sheet figures at the 700 W power limit; the
start-up latencies are assumed orders of magnitude.  None is calibrated
against a measurement: they are a description, and a prediction made with
them is a spec-sheet prediction.  ``fit_link`` turns measured walls into a
calibrated link (``chip_smoke.py`` fits the host staging of
``core/mesh.py``'s gloo ranks with it).

All Table-1 costs are expressed in seconds for a message of m *bytes* over a
group of p processes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

# ---------------------------------------------------------------------------
# Hardware constants: one H100 SXM, NVIDIA data sheet (uncalibrated).
# ---------------------------------------------------------------------------
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12          # bytes/s per card (HBM3)
NVLINK_BW = 450e9         # bytes/s per direction (NVLink 4, 18 links)
IB_BW = 50e9              # bytes/s per card, one NDR 400 Gb/s port
NVLINK_LATENCY = 2e-6     # t_s, seconds: assumed, not a data-sheet figure
IB_LATENCY = 5e-6         # assumed, not a data-sheet figure
HBM_PER_CHIP = 80e9       # 80 GB HBM3


@dataclass(frozen=True)
class LinkClass:
    t_s: float  # start-up (latency) seconds
    t_w: float  # seconds per byte

    @classmethod
    def nvlink(cls) -> "LinkClass":
        return cls(t_s=NVLINK_LATENCY, t_w=1.0 / NVLINK_BW)

    @classmethod
    def ib(cls) -> "LinkClass":
        return cls(t_s=IB_LATENCY, t_w=1.0 / IB_BW)

    @classmethod
    def fit(cls, terms: Sequence[Tuple[float, float]],
            seconds: Sequence[float]) -> "LinkClass":
        """Least-squares (t_s, t_w) from measured communication times.

        ``terms[i]`` is ``(starts, bytes)`` of run i, the coefficients of t_s
        and t_w in its predicted communication time (``link_terms``), and
        ``seconds[i]`` the time it measured.  Solves the 2x2 normal
        equations; needs two runs whose terms are not proportional."""
        saa = sum(a * a for a, _ in terms)
        sab = sum(a * b for a, b in terms)
        sbb = sum(b * b for _, b in terms)
        say = sum(a * y for (a, _), y in zip(terms, seconds))
        sby = sum(b * y for (_, b), y in zip(terms, seconds))
        det = saa * sbb - sab * sab
        if not det > 0:
            raise ValueError("LinkClass.fit needs two runs with independent terms")
        return cls(t_s=(say * sbb - sby * sab) / det, t_w=(sby * saa - say * sab) / det)


NVLINK = LinkClass.nvlink()
IB = LinkClass.ib()


def link_terms(comm: Callable[[LinkClass], float]) -> Tuple[float, float]:
    """(starts, bytes): the coefficients of t_s and t_w in ``comm(link)``,
    a cost in seconds that is linear in the link and 0 on a free one (a
    ``*_cost(..., link=link, peak_flops=math.inf)["total_s"]``: an infinite
    peak zeroes the compute terms, which leaves the communication)."""
    if comm(LinkClass(0.0, 0.0)) != 0.0:
        raise ValueError("comm(link) must vanish on a free link (pass peak_flops=inf)")
    return comm(LinkClass(1.0, 0.0)), comm(LinkClass(0.0, 1.0))


def fit_link(totals: Sequence[Callable[[LinkClass], float]],
             comms: Sequence[Callable[[LinkClass], float]],
             seconds: Sequence[float], iters: int = 20) -> LinkClass:
    """The link under which the predicted times ``totals[i](link)`` best
    match the measured ``seconds[i]`` (least squares).  ``comms[i]`` is run
    i's communication alone (its cost at ``peak_flops=inf``), linear in the
    link; a total may overlap compute with it (``summa_pipelined_cost``'s
    max), so the link-independent remainder of each total is taken at the
    current estimate and the linear fit repeated to a fixed point."""
    terms = [link_terms(c) for c in comms]
    link = LinkClass(0.0, 0.0)
    for _ in range(iters):
        rest = [f(link) - a * link.t_s - b * link.t_w for f, (a, b) in zip(totals, terms)]
        new = LinkClass.fit(terms, [y - r for y, r in zip(seconds, rest)])
        if new == link:
            break
        link = new
    return link


# ---------------------------------------------------------------------------
# Table-1 cost formulas (paper §2 and Table 1).  m in bytes, p = group size.
# ---------------------------------------------------------------------------
def t_map(t_lambda: float) -> float:
    """mapD / zipWithD: non-communicating."""
    return t_lambda


def t_reduce(m: float, p: int, link: LinkClass = NVLINK, t_lambda: float = 0.0) -> float:
    """reduceD: Θ(log p (t_s + t_w m + T_λ(m))) — recursive doubling."""
    if p <= 1:
        return 0.0
    return math.log2(p) * (link.t_s + link.t_w * m + t_lambda)


def t_shift(m: float, p: int, link: LinkClass = NVLINK) -> float:
    """shiftD: Θ(t_s + t_w m) (needs cross-section bandwidth O(p) — true on a torus)."""
    return link.t_s + link.t_w * m if p > 1 else 0.0


def t_broadcast(m: float, p: int, link: LinkClass = NVLINK) -> float:
    """apply(i) / one-to-all broadcast: Θ(log p (t_s + t_w m))."""
    if p <= 1:
        return 0.0
    return math.log2(p) * (link.t_s + link.t_w * m)


def t_all_gather(m: float, p: int, link: LinkClass = NVLINK) -> float:
    """allGatherD: Θ((t_s + t_w m)(p-1)) — ring; m is the per-process element."""
    return (link.t_s + link.t_w * m) * (p - 1) if p > 1 else 0.0


def t_all_to_all(m: float, p: int, link: LinkClass = NVLINK) -> float:
    """allToAllD: Θ(t_s log p + t_w m (p-1)); m is the per-destination element."""
    if p <= 1:
        return 0.0
    return link.t_s * math.log2(p) + link.t_w * m * (p - 1)


def t_all_reduce(m: float, p: int, link: LinkClass = NVLINK) -> float:
    """All-reduce as reduce-scatter + all-gather: 2 m (p-1)/p bandwidth term."""
    if p <= 1:
        return 0.0
    return 2.0 * (link.t_s * math.log2(p) + link.t_w * m * (p - 1) / p)


def t_reduce_scatter(m: float, p: int, link: LinkClass = NVLINK) -> float:
    if p <= 1:
        return 0.0
    return link.t_s * math.log2(p) + link.t_w * m * (p - 1) / p


def t_reduce_scatter_ring(m: float, p: int, link: LinkClass = NVLINK,
                          t_lambda: float = 0.0) -> float:
    """Generic-op ring reduce-scatter (``reduce_scatter_d`` with a callable):
    p-1 nearest-neighbour steps of an m/p chunk —
    Θ((p-1)(t_s + t_w m/p + T_λ(m/p)))."""
    if p <= 1:
        return 0.0
    return (p - 1) * (link.t_s + link.t_w * m / p + t_lambda)


def t_scan(m: float, p: int, link: LinkClass = NVLINK, t_lambda: float = 0.0) -> float:
    """scanD (parallel prefix, Hillis-Steele recursive doubling):
    Θ(log p (t_s + t_w m + T_λ(m))) — same shape as reduceD; the prefix
    combine runs in every round."""
    if p <= 1:
        return 0.0
    return math.ceil(math.log2(p)) * (link.t_s + link.t_w * m + t_lambda)


def t_ring_shift(m: float, p: int, link: LinkClass = NVLINK) -> float:
    """ringShiftD: one nearest-neighbour hop — Θ(t_s + t_w m)."""
    return link.t_s + link.t_w * m if p > 1 else 0.0


# ---------------------------------------------------------------------------
# Roofline terms (per §Roofline of the experiment plan).
# ---------------------------------------------------------------------------
def roofline_terms(
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    chips: int,
    *,
    peak_flops: float = PEAK_FLOPS_BF16,
    hbm_bw: float = HBM_BW,
    link_bw: float = NVLINK_BW,
) -> dict:
    """The three roofline terms, in seconds.

    ``hlo_flops``/``hlo_bytes`` are totals from ``compiled.cost_analysis()``
    (already per-program = per-device in SPMD); ``collective_bytes`` is the
    summed operand bytes of collective ops parsed from the HLO.
    """
    compute = hlo_flops / (chips * peak_flops)
    memory = hlo_bytes / (chips * hbm_bw)
    collective = collective_bytes / (chips * link_bw)
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms


def model_flops_train(n_params_active: float, tokens: float) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for one train step."""
    return 6.0 * n_params_active * tokens


def model_flops_decode(n_params_active: float, tokens: float) -> float:
    """Decode: 2 N per token per forward."""
    return 2.0 * n_params_active * tokens


# ---------------------------------------------------------------------------
# Serving-path costs (scheduler + roofline --serve).
# ---------------------------------------------------------------------------
def decode_step_cost(n_params_active: float, batch: int, kv_bytes: float = 0.0,
                     *, chips: int = 1, bytes_per_param: int = 2,
                     overhead_s: float = 0.0,
                     peak_flops: float = PEAK_FLOPS_BF16,
                     hbm_bw: float = HBM_BW) -> dict:
    """One batched decode step: every chip streams its parameter shard once
    (plus each sequence's KV/state cache, ``kv_bytes`` per sequence) while
    doing 2·N·B flops — the classic batch-amortized memory-bound regime.
    ``overhead_s`` is a fixed per-step dispatch floor (host-driven engines).
    Returns the roofline terms plus the predicted aggregate tok/s."""
    compute = 2.0 * n_params_active * batch / (chips * peak_flops)
    memory = (n_params_active * bytes_per_param + batch * kv_bytes) / (chips * hbm_bw)
    total = max(compute, memory) + overhead_s
    return {
        "compute_s": compute,
        "memory_s": memory,
        "dominant": "compute_s" if compute >= memory else "memory_s",
        "total_s": total,
        "tok_s": batch / total if total > 0 else float("inf"),
    }


def prefill_cost(n_params_active: float, prompt_tokens: float, *,
                 chips: int = 1, bytes_per_param: int = 2,
                 peak_flops: float = PEAK_FLOPS_BF16,
                 hbm_bw: float = HBM_BW) -> dict:
    """Fused prefill of ``prompt_tokens`` (batch × prompt length) in one
    full-sequence forward: 2·N flops per token against one parameter stream —
    compute-bound for any real prompt, which is exactly why the scheduler
    prefers one fused call over a prompt-length loop of decode steps (the
    loop pays the decode memory bound ``prompt_len`` times)."""
    compute = 2.0 * n_params_active * prompt_tokens / (chips * peak_flops)
    memory = n_params_active * bytes_per_param / (chips * hbm_bw)
    total = max(compute, memory)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "dominant": "compute_s" if compute >= memory else "memory_s",
        "total_s": total,
        "tok_s": prompt_tokens / total if total > 0 else float("inf"),
    }


def paged_decode_step_cost(n_params_active: float, batch: int,
                           kv_bytes: float, *, block: int,
                           kv_token_bytes: float, chips: int = 1,
                           bytes_per_param: int = 2, overhead_s: float = 0.0,
                           table_entry_bytes: int = 4,
                           t_page_issue: float = 5e-8,
                           peak_flops: float = PEAK_FLOPS_BF16,
                           hbm_bw: float = HBM_BW) -> dict:
    """``decode_step_cost`` plus the page-table-gather term: the KV stream
    is no longer one contiguous row per sequence but ``pages`` block reads
    *through* the table, so each page costs its table entry
    (``table_entry_bytes``) on the wire plus an amortized non-contiguous
    start latency ``t_page_issue`` (descriptor setup; pages overlap, so the
    per-page constant is small).  The term vanishes as ``block`` grows —
    ``block → seq`` recovers the dense cost, which is exactly the layout
    tradeoff: big pages gather cheap but waste pool capacity to internal
    fragmentation (``BlockPool.report``), small pages pack tight but pay
    the gather."""
    pages = max(1, -(-int(kv_bytes / kv_token_bytes) // block)) \
        if kv_token_bytes > 0 else 1
    compute = 2.0 * n_params_active * batch / (chips * peak_flops)
    gather_bytes = batch * pages * table_entry_bytes
    memory = (n_params_active * bytes_per_param + batch * kv_bytes
              + gather_bytes) / (chips * hbm_bw)
    gather = batch * pages * t_page_issue / chips
    total = max(compute, memory + gather) + overhead_s
    return {
        "compute_s": compute,
        "memory_s": memory,
        "gather_s": gather,
        "pages_per_seq": pages,
        "dominant": "compute_s" if compute >= memory + gather else "memory_s",
        "total_s": total,
        "tok_s": batch / total if total > 0 else float("inf"),
    }


def chunked_prefill_cost(n_params_active: float, prompt_tokens: float,
                         chunk: int, *, chips: int = 1,
                         bytes_per_param: int = 2,
                         kv_token_bytes: float = 0.0,
                         peak_flops: float = PEAK_FLOPS_BF16,
                         hbm_bw: float = HBM_BW) -> dict:
    """Prefill consumed in ``chunk``-token slices interleaved with decode
    ticks.  Chunking re-streams the parameters once per chunk (the fused
    call streams them once total) and re-reads the growing KV prefix each
    chunk (Θ(prompt²/2·chunk) extra KV traffic), so ``total_s`` rises as
    ``chunk`` shrinks — but ``stall_s``, the single-chunk cost and hence
    the longest any in-flight decode tick can be delayed by one admission,
    falls with it.  That stall bound is what chunked admission buys; the
    fused prefill is the ``chunk >= prompt`` corner (one "chunk", maximal
    stall)."""
    chunk = max(1, min(int(chunk), int(prompt_tokens)))
    n_chunks = -(-int(prompt_tokens) // chunk)
    compute = 2.0 * n_params_active * prompt_tokens / (chips * peak_flops)
    param_stream = n_chunks * n_params_active * bytes_per_param / (chips * hbm_bw)
    kv_restream = (prompt_tokens ** 2 / (2.0 * chunk)) * kv_token_bytes \
        / (chips * hbm_bw)
    memory = param_stream + kv_restream
    total = max(compute, memory)
    stall = max(2.0 * n_params_active * chunk / (chips * peak_flops),
                n_params_active * bytes_per_param / (chips * hbm_bw))
    return {
        "compute_s": compute,
        "memory_s": memory,
        "n_chunks": n_chunks,
        "stall_s": stall,
        "dominant": "compute_s" if compute >= memory else "memory_s",
        "total_s": total,
        "tok_s": prompt_tokens / total if total > 0 else float("inf"),
    }


# ---------------------------------------------------------------------------
# Train-step memory + time model (what the layout planner scores; the
# single-card trainer prints it beside its measured step).
# Each comm term is a Table-1 collective: the TP activation combines are
# reduceD-pairs (t_all_reduce), the ZeRO gradient scatter is the ring
# reduceScatterD (t_reduce_scatter_ring), and the FSDP/ZeRO parameter
# regather is allGatherD (t_all_gather).
# ---------------------------------------------------------------------------
def train_activation_bytes(batch_local: int, seq: int, d_model: int,
                           d_ff: int, n_layers: int, vocab: int, *,
                           remat: str = "full", act_bytes: int = 2,
                           logit_chunk: int | None = None) -> float:
    """Per-device live activation bytes of one train step.

    ``remat='full'`` keeps only the layer-boundary residual per layer (the
    layer body is recomputed in the backward); ``'dots'`` additionally keeps
    the matmul outputs; ``'none'`` keeps every intermediate (the rough
    per-token transformer constant 10·d_model + 3·d_ff).  The f32 logits
    transient rides on top (bounded by ``logit_chunk`` when set)."""
    toks = batch_local * seq
    per_tok = {"full": d_model,
               "dots": 5 * d_model + d_ff,
               "none": 10 * d_model + 3 * d_ff}[remat] * act_bytes
    logits = batch_local * (min(logit_chunk, seq) if logit_chunk else seq) * vocab * 4
    return float(toks * per_tok * n_layers + logits)


def train_memory_bytes(n_params_total: float, *, tp: int = 1,
                       fsdp_shard: int = 1, dp: int = 1,
                       grad: str = "all_reduce",
                       param_bytes: int = 4, grad_bytes: int = 2,
                       opt_state_bytes: int = 4, master: bool = False,
                       activation_bytes: float = 0.0) -> dict:
    """Per-device HBM bytes of the training state under a layout.

    Params are sharded over tp × fsdp_shard; gradients and optimizer moments
    follow the params (``all_reduce``: every device holds the full grad and
    updates its whole param residency) or the ZeRO scatter layout
    (``reduce_scatter_zero``: grads/m/v/master live on 1/dp of the non-TP
    shard — Θ(2m/p) vs the all-reduce layout's Θ(2m), ZeRO §5)."""
    shard = tp * fsdp_shard
    zero = grad == "reduce_scatter_zero"
    # the ZeRO scatter only adds sharding where FSDP storage hasn't already
    # (scatter_specs leaves FSDP-sharded leaves alone)
    gshard = tp * (fsdp_shard if fsdp_shard > 1 else (dp if zero else 1))
    params = n_params_total * param_bytes / shard
    grads = n_params_total * grad_bytes / gshard
    opt = n_params_total * (2 * opt_state_bytes + (4 if master else 0)) / gshard
    total = params + grads + opt + activation_bytes
    return {"params": params, "grads": grads, "opt": opt,
            "activations": activation_bytes, "total": total}


def train_step_cost(n_params_active: float, n_params_total: float,
                    tokens: float, *, chips: int, tp: int = 1, dp: int = 1,
                    fsdp_shard: int = 1, grad: str = "all_reduce",
                    batch_local: int = 1, seq: int = 1, d_model: int = 1,
                    n_layers: int = 1, param_bytes: int = 2,
                    grad_bytes: int = 2, opt_state_bytes: int = 4,
                    master: bool = False, remat: str = "full",
                    link: LinkClass = NVLINK,
                    peak_flops: float = PEAK_FLOPS_BF16,
                    hbm_bw: float = HBM_BW) -> dict:
    """Predicted wall time of one train step under a ``ParallelPlan`` layout.

    Terms (each mapped to its Table-1 collective):
      compute_s   6·N·D/(chips·peak) roofline (×4/3 under full remat — the
                  recompute is one extra forward)
      tp_comm_s   4·L per-layer activation combines over the TP group:
                  reduceD-pairs costed as ``t_all_reduce`` (the RS+AG form)
      gather_s    FSDP parameter regather, fwd+bwd: ``t_all_gather`` over the
                  fsdp axes of the per-device param shard
      grad_s      the gradient reduction over the dp group —
                  all_reduce: ``t_all_reduce`` of the full (non-TP) grad;
                  reduce_scatter_zero: ring ``t_reduce_scatter_ring`` of the
                  grads + ``t_all_gather`` of the updated param shard
      update_s    optimizer HBM traffic (grad read + m/v read/write + param
                  read/write): over 1/dp of the params under ZeRO, the whole
                  residency under all_reduce
    """
    compute = 6.0 * n_params_active * tokens / (chips * peak_flops)
    if remat == "full":
        compute *= 4.0 / 3.0
    n_tp = n_params_total / tp                       # per-TP-shard params
    m_act = batch_local * seq * d_model * 2          # bf16 activations
    tp_comm = 4.0 * n_layers * t_all_reduce(m_act, tp, link)
    gather = 2.0 * t_all_gather(n_tp * param_bytes / fsdp_shard, fsdp_shard,
                                link) if fsdp_shard > 1 else 0.0
    zero = grad == "reduce_scatter_zero"
    g_bytes = n_tp * grad_bytes
    if fsdp_shard > 1:
        # FSDP storage already scatters the reduction (the partitioner folds the
        # all-reduce + slice into a reduce-scatter); the param regather is
        # gather_s above, for either grad strategy
        grad_s = t_reduce_scatter_ring(g_bytes, dp, link)
        opt_shard = fsdp_shard
    elif zero:
        grad_s = (t_reduce_scatter_ring(g_bytes, dp, link)
                  + t_all_gather(n_tp * param_bytes / max(dp, 1), dp, link))
        opt_shard = dp
    else:
        grad_s = t_all_reduce(g_bytes, dp, link)
        opt_shard = 1
    opt_traffic = n_tp * (grad_bytes + 2 * param_bytes + 4 * opt_state_bytes
                          + (8 if master else 0))
    update = opt_traffic / opt_shard / hbm_bw
    # fwd/bwd parameter streaming (3 passes over the resident shard)
    memory = 3.0 * n_tp / fsdp_shard * param_bytes / hbm_bw
    total = max(compute, memory) + tp_comm + gather + grad_s + update
    terms = {"compute_s": compute, "memory_s": memory, "tp_comm_s": tp_comm,
             "gather_s": gather, "grad_s": grad_s, "update_s": update,
             "comm_s": tp_comm + gather + grad_s, "total_s": total}
    terms["dominant"] = max(
        ("compute_s", "memory_s", "tp_comm_s", "gather_s", "grad_s",
         "update_s"), key=lambda k: terms[k])
    return terms


# ---------------------------------------------------------------------------
# Isoefficiency (paper §2, §4.2.1, §4.3): W = K * T_o(W, p).
# ---------------------------------------------------------------------------
def efficiency(t_serial: float, t_parallel: float, p: int) -> float:
    return t_serial / (p * t_parallel) if p * t_parallel > 0 else 0.0


def overhead(t_serial: float, t_parallel: float, p: int) -> float:
    """T_o(W, p) = p T_p - T_s."""
    return p * t_parallel - t_serial


def isoefficiency_matmul_generic(p: int) -> float:
    """Paper §4.2.1: W ∈ Θ(p^{5/3}) for Algorithm 1 (for-loop emulation)."""
    return p ** (5.0 / 3.0)


def isoefficiency_matmul_grid(p: int) -> float:
    """Paper §4.3 / DNS: W ∈ Θ(p log p)  (stated as Θ(n^3 + p log p))."""
    return p * math.log2(max(p, 2))


def isoefficiency_matmul_summa(p: int) -> float:
    """SUMMA on a √p×√p grid: per step, two Θ(log √p) panel broadcasts; the
    bandwidth term t_w n²/√p · log √p dominates the overhead, giving
    W ∈ Θ(p^{3/2} log p) — between DNS's Θ(p log p) (which pays p^{1/3}
    memory replication for it) and generic's Θ(p^{5/3})."""
    return p ** 1.5 * math.log2(max(p, 2))


def isoefficiency_matmul_cannon(p: int) -> float:
    """Cannon: same Θ(n²/√p) bandwidth per process but nearest-neighbour
    only (no log-factor broadcast trees): W ∈ Θ(p^{3/2})."""
    return p ** 1.5


def isoefficiency_matmul_25d(p: int, c: int = 1) -> float:
    """2.5D Cannon with c-fold replication: per-process bandwidth drops to
    Θ(n²/√(c·p)), so W ∈ Θ((p/c)^{3/2}) — c = 1 recovers Cannon's Θ(p^{3/2})
    and c = p^{1/3} reaches Θ(p), the replication-bought end of the curve
    next to DNS's Θ(p log p)."""
    return (p / c) ** 1.5


def isoefficiency_floyd_warshall(p: int) -> float:
    """Paper §5: W ∈ Θ((√p log p)^3)."""
    return (math.sqrt(p) * math.log2(max(p, 2))) ** 3


def solve_isoefficiency(t_overhead_fn, p: int, k: float = 1.0, w0: float = 1.0, iters: int = 100) -> float:
    """Numerically solve W = k * T_o(W, p) by fixed-point iteration.

    ``t_overhead_fn(W, p)`` returns the overhead for problem size W on p
    processes.  Returns the smallest W achieving the target efficiency
    implied by k (E = 1 / (1 + 1/k) in the standard formulation).
    """
    w = w0
    for _ in range(iters):
        w_new = k * t_overhead_fn(w, p)
        if w_new <= 0:
            return w
        if abs(w_new - w) / max(w, 1e-12) < 1e-9:
            return w_new
        w = 0.5 * w + 0.5 * w_new  # damped for stability
    return w


# ---------------------------------------------------------------------------
# Whole-algorithm cost predictions (used by benchmarks + sharding chooser).
# ---------------------------------------------------------------------------
def dns_matmul_cost(n: int, q: int, bytes_per_elt: int = 4, link: LinkClass = NVLINK,
                    peak_flops: float = PEAK_FLOPS_BF16) -> dict:
    """Predicted parallel runtime of Grid3D DNS matmul on a q^3 grid.

    T_p = 2 broadcasts (A, B along grid axes) + local multiply + reduceD over z.
    Block size (n/q)^2 elements.
    """
    blk = (n // q) ** 2
    m = blk * bytes_per_elt
    t_bcast = 2 * t_broadcast(m, q, link)
    t_mult = 2.0 * (n / q) ** 3 / peak_flops
    t_red = t_reduce(m, q, link, t_lambda=blk / peak_flops)
    return {
        "broadcast_s": t_bcast,
        "compute_s": t_mult,
        "reduce_s": t_red,
        "total_s": t_bcast + t_mult + t_red,
        "serial_s": 2.0 * n**3 / peak_flops,
        "p": q**3,
    }


def summa_matmul_cost(n: int, qx: int, qy: int | None = None,
                      bytes_per_elt: int = 4, link: LinkClass = NVLINK,
                      peak_flops: float = PEAK_FLOPS_BF16) -> dict:
    """Predicted runtime of SUMMA on a q_x × q_y grid (square by default).

    L = lcm(q_x, q_y) panel steps; each step row-broadcasts an
    (n/q_x × n/L) A panel over the q_y-group and column-broadcasts an
    (n/L × n/q_y) B panel over the q_x-group; local flops total 2n³/p.
    """
    qy = qy or qx
    L = math.lcm(qx, qy)
    m_a = (n // qx) * (n // L) * bytes_per_elt
    m_b = (n // L) * (n // qy) * bytes_per_elt
    t_comm = L * (t_broadcast(m_a, qy, link) + t_broadcast(m_b, qx, link))
    t_mult = 2.0 * n**3 / (qx * qy) / peak_flops
    return {
        "broadcast_s": t_comm,
        "compute_s": t_mult,
        "total_s": t_comm + t_mult,
        "serial_s": 2.0 * n**3 / peak_flops,
        "p": qx * qy,
        "mem_elts_per_proc": 3 * (n // qx) * (n // qy),
    }


def cannon_matmul_cost(n: int, qx: int, qy: int | None = None,
                       bytes_per_elt: int = 4, link: LinkClass = NVLINK,
                       peak_flops: float = PEAK_FLOPS_BF16) -> dict:
    """Predicted runtime of Cannon on a q_x × q_y grid: one skew ppermute
    per operand + (q_y-1) ring shifts of the A block and (q_x-1) of the B
    block — nearest-neighbour only, no broadcast trees, so the communication
    term drops the log factor of SUMMA."""
    qy = qy or qx
    m_a = (n // qx) * (n // qy) * bytes_per_elt
    m_b = m_a
    t_comm = (t_shift(m_a, qy, link) + t_shift(m_b, qx, link)
              + (qy - 1) * t_ring_shift(m_a, qy, link)
              + (qx - 1) * t_ring_shift(m_b, qx, link))
    t_mult = 2.0 * n**3 / (qx * qy) / peak_flops
    return {
        "shift_s": t_comm,
        "compute_s": t_mult,
        "total_s": t_comm + t_mult,
        "serial_s": 2.0 * n**3 / peak_flops,
        "p": qx * qy,
        "mem_elts_per_proc": 3 * (n // qx) * (n // qy),
    }


def summa_pipelined_cost(n: int, qx: int, qy: int | None = None,
                         bytes_per_elt: int = 4, link: LinkClass = NVLINK,
                         peak_flops: float = PEAK_FLOPS_BF16) -> dict:
    """Predicted runtime of overlap-pipelined SUMMA.

    A rotates (each rank starts on its own window — a filled ring pipeline):
    q_y - 1 block-sized nearest-neighbour hops total.  B runs one
    double-buffered ring broadcast per panel: (q_x - 1) panel-sized hops per
    step, the first of which is the pipeline-fill latency.  Every transfer
    for step t+1 is in flight during step t's multiply, so the total is
    max(t_comm, t_comp) — not their sum — plus the fill."""
    qy = qy or qx
    L = math.lcm(qx, qy)
    blk = (n // qx) * (n // qy)
    m_blk = blk * bytes_per_elt
    m_b = (n // L) * (n // qy) * bytes_per_elt
    t_comm = ((qy - 1) * t_ring_shift(m_blk, qy, link)
              + L * (qx - 1) * t_ring_shift(m_b, qx, link))
    t_comp = 2.0 * n**3 / (qx * qy) / peak_flops
    t_fill = (qx - 1) * t_ring_shift(m_b, qx, link)
    total = t_fill + max(t_comm, t_comp)
    return {
        "fill_s": t_fill,
        "comm_s": t_comm,
        "compute_s": t_comp,
        "overlap_s": t_comm + t_comp - max(t_comm, t_comp),
        "total_s": total,
        "serial_s": 2.0 * n**3 / peak_flops,
        "p": qx * qy,
        # 3 blocks + the incoming A window + 2 double-buffered B panels
        "mem_elts_per_proc": 4 * blk + 2 * (n // L) * (n // qy),
    }


def cannon_25d_cost(n: int, q: int, c: int = 1, bytes_per_elt: int = 4,
                    link: LinkClass = NVLINK,
                    peak_flops: float = PEAK_FLOPS_BF16) -> dict:
    """Predicted runtime of 2.5D Cannon on a q × q × c mesh (p = q²c).

    c-fold operand replication (one log-tree broadcast over the replication
    axis at load time), a skew ppermute per operand, q/c - 1 ring-shift
    steps per operand, and a final tree sum of the (n/q)² partial C over the
    c layers.  Per-process traffic interpolates Cannon (c = 1, Θ(n²/√p))
    down to the DNS-like corner (c = q, Θ(n²·c/p) plus the reduction)."""
    assert q % c == 0, (q, c)
    p = q * q * c
    blk = (n // q) ** 2
    m = blk * bytes_per_elt
    steps = q // c
    t_rep = 2 * t_broadcast(m, c, link)           # c-fold operand replication
    t_skew = 2 * t_shift(m, q, link)
    t_ring = 2 * (steps - 1) * t_ring_shift(m, q, link)
    t_red = t_reduce(m, c, link, t_lambda=blk / peak_flops)
    t_comp = 2.0 * n**3 / p / peak_flops
    comm = t_rep + t_skew + t_ring + t_red
    return {
        "replicate_s": t_rep,
        "shift_s": t_skew + t_ring,
        "reduce_s": t_red,
        "comm_s": comm,
        "compute_s": t_comp,
        "total_s": comm + t_comp,
        "serial_s": 2.0 * n**3 / peak_flops,
        "p": p,
        "c": c,
        "mem_elts_per_proc": 3 * blk,  # = 3·c·n²/p — the replication premium
    }


def floyd_warshall_cost(n: int, q: int, bytes_per_elt: int = 4, link: LinkClass = NVLINK,
                        peak_flops: float = PEAK_FLOPS_BF16) -> dict:
    """Predicted runtime of the 2D-grid FW (paper §5): n iterations of
    (row+col broadcast of B elements over √p) + Θ(B^2) local update."""
    b = n // q
    m = b * bytes_per_elt
    per_iter = 2 * t_broadcast(m, q, link) + (b * b) / peak_flops
    return {"total_s": n * per_iter, "per_iter_s": per_iter, "p": q * q}
