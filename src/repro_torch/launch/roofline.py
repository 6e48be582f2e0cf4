"""Roofline and cost-model tables: the port of the JAX package's
``launch/roofline.py``, on the port's cost model (``core/costmodel.py``:
H100 data-sheet constants, not calibrated against the card).

The dry-run record table -- per cell the three roofline terms, the
dominant one, the useful-FLOPs ratio, the fraction of the roofline and a
one-line recommendation -- over a JSON list of records with the keys of
JAX's dry run:

  PYTHONPATH=src python -m repro_torch.launch.roofline records.json

the parallel-matmul scenario table (paper section 4 and the 2D family):

  PYTHONPATH=src python -m repro_torch.launch.roofline --matmul n=8192,p=64

the serving-path table (the continuous-batching scheduler against one
slot, from ``costmodel.decode_step_cost`` / ``prefill_cost``):

  PYTHONPATH=src python -m repro_torch.launch.roofline --serve arch=llama3.2-3b,prompt=2048,gen=256,chips=16

and the auto-parallel plan lattice (``parallel/planner.py`` ranked by the
Table-1 train-step model):

  PYTHONPATH=src python -m repro_torch.launch.roofline --plan arch=llama3.2-3b,batch=256,seq=4096,mesh=16x16

Every constant is read from ``costmodel`` when a table is made, the
planner's too, so a table made with another module's constants is the
reference's table.
"""
from __future__ import annotations

import json
import math
import sys

from repro_torch.core import costmodel


def recommend(rec: dict) -> str:
    """One sentence: what moves the dominant term down."""
    dom = rec["roofline"]["dominant"]
    kind = rec["kind"]
    per_op = rec.get("collectives_corrected", {}).get("per_op", {})
    if dom == "collective_s":
        big = max(per_op, key=lambda k: per_op[k]["wire_bytes"]) if per_op else "?"
        return (f"dominant collective is {big}: cast the f32 backward "
                "segments to bf16 and replace grad all-reduce with "
                "reduce-scatter (ZeRO), then overlap with compute")
    if dom == "memory_s":
        if kind == "decode":
            return ("decode is KV-cache-bandwidth bound (expected): raise "
                    "batch or quantize the cache to int8")
        return ("bytes/FLOP too high: fuse attention (the Hopper flash kernel "
                "keeps scores in shared memory) and drop the remat policy to 'dots'")
    return ("compute-bound — at the roofline; remaining headroom is only "
            "remat overhead (useful-FLOPs ratio "
            f"{rec.get('useful_flops_ratio', 0):.2f})")


def fraction_of_roofline(rec: dict) -> float:
    """Useful-compute time / bound time: MODEL_FLOPS / (chips · peak) against
    the dominant term."""
    t_useful = rec["model_flops"] / (rec["chips"] * costmodel.PEAK_FLOPS_BF16)
    return t_useful / max(rec["roofline"]["bound_s"], 1e-12)


def table(path: str) -> str:
    with open(path) as f:
        rows = json.load(f)
    out = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
           "| useful/HLO | roofline-frac | fix |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | skipped "
                       f"(full attention @500k) | — | — | — |")
            continue
        if r.get("error"):
            out.append(f"| {r['arch']} | {r['shape']} | ERROR: {r['error'][:60]} |")
            continue
        t = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3f} | "
            f"{t['memory_s']:.3f} | {t['collective_s']:.3f} | "
            f"{t['dominant'].replace('_s', '')} | "
            f"{r['useful_flops_ratio']:.2f} | {fraction_of_roofline(r):.3f} | "
            f"{recommend(r)[:80]} |")
    return "\n".join(out)


def matmul_scenarios_table(n: int, p: int, bytes_per_elt: int = 2) -> str:
    """Predicted time / efficiency / memory of every parallel-matmul variant
    in the repo on p chips, from the Table-1 cost model.  DNS needs a cube
    grid, SUMMA/Cannon a square one; rows are skipped when p doesn't fit."""
    cm = costmodel
    hw = dict(link=cm.NVLINK, peak_flops=cm.PEAK_FLOPS_BF16)
    rows = ["| algorithm | grid | total_s | efficiency | per-proc elts | "
            "isoefficiency W(p) |", "|---|---|---|---|---|---|"]

    def eff(c):
        return c["serial_s"] / (c["p"] * c["total_s"])

    q3 = round(p ** (1 / 3))
    if q3**3 == p and n % q3 == 0:
        c = cm.dns_matmul_cost(n, q3, bytes_per_elt, **hw)
        rows.append(f"| DNS (3D) | {q3}³ | {c['total_s']:.4g} | {eff(c):.3f} | "
                    f"{3 * (n // q3) ** 2} (×{q3} replicated) | "
                    f"{cm.isoefficiency_matmul_grid(p):.3g} |")
    q2 = round(math.isqrt(p))
    if q2 * q2 == p and n % q2 == 0:
        c = cm.summa_matmul_cost(n, q2, bytes_per_elt=bytes_per_elt, **hw)
        rows.append(f"| SUMMA (2D) | {q2}² | {c['total_s']:.4g} | {eff(c):.3f} | "
                    f"{c['mem_elts_per_proc']} | "
                    f"{cm.isoefficiency_matmul_summa(p):.3g} |")
        c = cm.summa_pipelined_cost(n, q2, bytes_per_elt=bytes_per_elt, **hw)
        rows.append(f"| SUMMA-pipelined (2D, overlap) | {q2}² | "
                    f"{c['total_s']:.4g} | {eff(c):.3f} | "
                    f"{c['mem_elts_per_proc']} | "
                    f"{cm.isoefficiency_matmul_cannon(p):.3g} |")
        c = cm.cannon_matmul_cost(n, q2, bytes_per_elt=bytes_per_elt, **hw)
        rows.append(f"| Cannon (2D) | {q2}² | {c['total_s']:.4g} | {eff(c):.3f} | "
                    f"{c['mem_elts_per_proc']} | "
                    f"{cm.isoefficiency_matmul_cannon(p):.3g} |")
    # 2.5D: the largest replication factor c with p = q²c, c | q fixes (q, c)
    for c25 in sorted({d for d in range(2, p + 1) if p % d == 0}, reverse=True):
        q25 = round(math.isqrt(p // c25))
        if q25 * q25 * c25 == p and c25 <= q25 and q25 % c25 == 0 \
                and n % q25 == 0:
            c = cm.cannon_25d_cost(n, q25, c25, bytes_per_elt=bytes_per_elt, **hw)
            rows.append(f"| Cannon-2.5D (×{c25} replicated) | {q25}²×{c25} | "
                        f"{c['total_s']:.4g} | {eff(c):.3f} | "
                        f"{c['mem_elts_per_proc']} | "
                        f"{cm.isoefficiency_matmul_25d(p, c25):.3g} |")
            break
    rows.append(f"| generic (1D, Alg. 1) | {p} | — | — | — | "
                f"{cm.isoefficiency_matmul_generic(p):.3g} |")
    return "\n".join(rows)


def kv_bytes_per_seq(cfg, seq: int) -> float:
    """Per-sequence decode-cache traffic: attention KV (bf16, window-capped)
    plus the recurrent-state leaves (conv window + f32 SSM/mLSTM state)."""
    kv_len = min(seq, cfg.window) if cfg.window else seq
    kv_line = 2 * kv_len * cfg.n_kv_heads * cfg.hd * 2          # k+v, bf16
    if cfg.enc_dec:
        return cfg.n_layers * kv_line
    total = 0.0
    for kind in cfg.block_pattern:
        if kind in ("attn", "attn_moe"):
            total += kv_line
        elif kind in ("mamba2", "mamba2_attn"):
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            total += (s.conv_width - 1) * (d_in + 2 * s.d_state) * 2
            total += (d_in // s.head_dim) * s.d_state * s.head_dim * 4
            if kind == "mamba2_attn":
                total += kv_line
        elif kind == "mlstm":
            d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
            hd = d_in // cfg.n_heads
            total += cfg.n_heads * hd * (hd + 1) * 4
        elif kind == "slstm":
            total += 3 * cfg.d_model * 4
    return total * cfg.n_periods


def serve_table(arch: str, prompt: int, gen: int, chips: int = 1) -> str:
    """Predicted serving throughput/latency of the continuous-batching
    scheduler at growing slot counts against the one-slot server: decode is
    batch-amortized memory-bound (parameters stream once a step whatever
    the batch), so tok/s climbs near-linearly until KV traffic or the
    tensor cores take over."""
    from repro_torch import configs
    cm = costmodel
    hw = dict(peak_flops=cm.PEAK_FLOPS_BF16, hbm_bw=cm.HBM_BW)
    cfg = configs.get(arch)
    n_active = cfg.param_counts()["active"]
    kv = kv_bytes_per_seq(cfg, prompt + gen)
    pre = cm.prefill_cost(n_active, prompt, chips=chips, **hw)
    naive = cm.decode_step_cost(n_active, 1, kv, chips=chips, **hw)
    rows = ["| slots | step_compute_s | step_memory_s | dominant | tok/s | "
            "request latency_s | speedup vs 1 |", "|---|---|---|---|---|---|---|"]
    for b in (1, 8, 32, 128, 512):
        c = cm.decode_step_cost(n_active, b, kv, chips=chips, **hw)
        lat = pre["total_s"] + gen * c["total_s"]
        rows.append(
            f"| {b} | {c['compute_s']:.3e} | {c['memory_s']:.3e} | "
            f"{c['dominant'].replace('_s', '')} | {c['tok_s']:.1f} | "
            f"{lat:.3f} | {c['tok_s'] / naive['tok_s']:.1f}× |")
    rows.append(f"(prefill {prompt} toks: {pre['total_s'] * 1e3:.2f} ms fused "
                f"vs {prompt * naive['total_s'] * 1e3:.2f} ms as a decode "
                f"loop — {cfg.name}, {chips} chip(s))")
    # paged engine: page-table-gather tax vs block size, and the chunked-
    # prefill stall bound vs the fused call's whole-prompt stall
    kv_tok = kv_bytes_per_seq(cfg, 1)
    rows.append("")
    rows.append("| paged (32 slots) | block | pages/seq | tok/s | vs dense | "
                "chunk | admission stall_s |")
    rows.append("|---|---|---|---|---|---|---|")
    dense = cm.decode_step_cost(n_active, 32, kv, chips=chips, **hw)
    for blk, chunk in ((16, 256), (64, 1024), (256, 4096)):
        pc = cm.paged_decode_step_cost(n_active, 32, kv, block=blk, kv_token_bytes=kv_tok,
                                       chips=chips, **hw)
        cp = cm.chunked_prefill_cost(n_active, prompt, chunk, chips=chips,
                                     kv_token_bytes=kv_tok, **hw)
        rows.append(f"| paged | {blk} | {pc['pages_per_seq']} | "
                    f"{pc['tok_s']:.1f} | {pc['tok_s'] / dense['tok_s']:.3f}× "
                    f"| {chunk} | {cp['stall_s']:.3e} |")
    rows.append(f"(fused prefill stalls every in-flight decode for "
                f"{pre['total_s']:.3e} s; a chunk stalls it for one slice — "
                f"the paged/chunked engine caps it at the chunk column)")
    return "\n".join(rows)


def plan_table(arch: str, batch: int, seq: int, mesh: tuple,
               kind: str = "train") -> str:
    """The ranked plan lattice of one (arch x shape) cell.  The reference
    prints its CPU-simulator A/B (``BENCH_train.json``) beside it; that
    file holds JAX CPU numbers, no baseline for the port, so it is not
    read here."""
    from repro_torch import configs
    from repro_torch.parallel import planner
    cm = costmodel
    cfg = configs.get(arch)
    ranked = planner.plan_search(cfg, mesh, batch, seq, kind, hbm=cm.HBM_PER_CHIP,
                                 link=cm.NVLINK, peak_flops=cm.PEAK_FLOPS_BF16,
                                 hbm_bw=cm.HBM_BW)
    return "\n".join([f"### plan lattice — {arch} × {kind} b={batch} s={seq} "
                      f"mesh={'x'.join(map(str, mesh))}", "",
                      planner.format_plan_table(ranked)])


def _kv(args, usage: str) -> dict:
    try:
        return dict(s.split("=") for s in args[1].split(",")) if len(args) > 1 else {}
    except ValueError:
        raise SystemExit(usage)


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else list(argv)
    if args and args[0] == "--plan":
        usage = ("usage: roofline --plan arch=<name>,batch=<n>,seq=<n>,"
                 "mesh=<d>x<d>[,kind=train|decode]")
        kv = _kv(args, usage)
        try:
            batch, seq = int(kv.get("batch", 256)), int(kv.get("seq", 4096))
            mesh = tuple(int(d) for d in kv.get("mesh", "16x16").split("x"))
        except ValueError:
            raise SystemExit(usage)
        print(plan_table(kv.get("arch", "llama3.2-3b"), batch, seq, mesh,
                         kv.get("kind", "train")))
        return
    if args and args[0] == "--serve":
        usage = "usage: roofline --serve arch=<name>,prompt=<len>,gen=<len>,chips=<n>"
        kv = _kv(args, usage)
        try:
            prompt, gen = int(kv.get("prompt", 2048)), int(kv.get("gen", 256))
            chips = int(kv.get("chips", 1))
        except ValueError:
            raise SystemExit(usage)
        print(serve_table(kv.get("arch", "llama3.2-3b"), prompt, gen, chips))
        return
    if args and args[0] == "--matmul":
        usage = "usage: roofline --matmul n=<size>,p=<chips>"
        kv = _kv(args, usage)
        try:
            n, p = int(kv.get("n", 8192)), int(kv.get("p", 64))
        except ValueError:
            raise SystemExit(usage)
        print(matmul_scenarios_table(n, p))
        return
    for path in args:
        print(f"\n### {path}\n")
        print(table(path))


if __name__ == "__main__":
    main()
