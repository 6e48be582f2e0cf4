#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py

Phases, each printing one line and each failing the run on error:

  1. device   -- the card's name and power limit, torch and CUDA versions;
                 stops when there is no CUDA device;
  2. build    -- builds every kernel from ``src/repro_torch/kernels/csrc``;
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 at the serving path's shapes (paged attention: B=4 slots,
                 Hkv=8, rep=3, hd=128, block 16), in bf16 and f32, with a
                 dead row, -1 entries and partial pages; times the kernel,
                 the plain version and one library call, beside the bound;
  4. serve    -- full-width Llama-3.2-3B in bf16, random weights from a
                 seeded generator, through ``Scheduler(paged=True)``: 8
                 requests of 512 prompt and 64 generated tokens, 4 slots,
                 block 16, chunk 256, stagger 2.  The kernel's launch count
                 must equal decode steps x 28 layers;
  5. oracle   -- one served request re-run through chunked prefill and
                 decode steps; its logits must agree with ``forward`` over
                 the same tokens;
  6. trace    -- a shorter serve run (4 requests, 16 generated tokens)
                 under ``torch.profiler``: device busy time against wall
                 time, split into the paged-attention kernel, matrix
                 products and everything else.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  TF32 is off for every f32 product.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12                       # H100 SXM HBM3
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_FLUSH_BYTES = 100 * 2**20                 # twice the H100's 50 MB L2
# kernel vs plain: f32 differs only in summation order; bf16 adds one bf16
# rounding of the probabilities and of q * scale in the plain version
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# decode path vs forward in bf16: the two paths round at different places
# (kernel f32 probabilities vs bf16 ones, other GEMM shapes) in each of 28
# layers; the per-row relative RMS error of the f32 logits stays within
# ~13 bf16 epsilons (2**-8)
ORACLE_REL_RMS = 5e-2

ARCH = "llama3.2-3b"
SLOTS, BLOCK, CHUNK, PROMPT, GEN, N_REQ, STAGGER = 4, 16, 256, 512, 64, 8, 2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def device_ms(calls, replays: int = 10) -> float:
    """Mean device time of one call.  ``calls`` holds one zero-argument
    call per copy of the inputs; together the copies exceed the 50 MB L2,
    so each call finds its inputs cold, as each layer of a decode step
    does.  The calls are captured once into a CUDA graph and replayed, so
    the host's launch cost stays out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                       # warmup, as capture asks
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(calls))


# ---------------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name} x{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build()
    wall = time.perf_counter() - t0
    for name, rep in report.items():
        usage = [ln.strip() for ln in rep["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {rep['seconds']:.1f}s; " + " | ".join(usage[:4]),
              flush=True)
    print(f"[build] {len(report)} kernel(s) in {wall:.1f}s", flush=True)


# ---------------------------------------------------------------------------
def _paged_case(dtype, seed=0):
    """The serving path's decode shapes: 4 slots, Hkv=8, rep=3, hd=128,
    block 16, a 36-page table (576 tokens) over a 144-block pool.  Row 0 is
    full, row 1 ends mid-page and has a dead entry below its length, row 2
    is dead (a parked slot), row 3 holds 33 tokens."""
    b, hkv, rep, hd, blk = SLOTS, 8, 3, 128, BLOCK
    pages = -(-(PROMPT + GEN) // blk)
    n_blocks = b * pages
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, hkv, rep, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((n_blocks, blk, hkv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((n_blocks, blk, hkv, hd), generator=g, device="cuda").to(dtype)
    lengths = [pages * blk, pages * blk // 2 + 12, 100, 2 * blk + 1]
    perm = np.random.RandomState(seed).permutation(n_blocks)
    tables = np.full((b, pages), -1, np.int32)
    used = 0
    for row, ln in enumerate(lengths):
        if row == 2:
            continue                                   # dead row: all -1
        chain = -(-ln // blk)
        tables[row, :chain] = perm[used:used + chain]
        used += chain
    tables[1, 5] = -1                                  # dead entry below the length
    return (q, k, v, torch.from_numpy(tables).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def _live_positions(tables, lengths, blk) -> int:
    t = tables.cpu().numpy()
    n = 0
    for row, ln in enumerate(lengths.tolist()):
        for pg, e in enumerate(t[row]):
            if e >= 0:
                n += max(0, min(blk, ln - pg * blk))
    return n


def _library_paged(q, k_pages, v_pages, tables, lengths):
    """Gather + scaled_dot_product_attention: the yardstick, never used by
    the port."""
    b, hkv, rep, hd = q.shape
    blk, pages = k_pages.shape[1], tables.shape[1]
    idx = tables.long().clamp(min=0)
    k = k_pages[idx].reshape(b, pages * blk, hkv, hd).transpose(1, 2)
    v = v_pages[idx].reshape(b, pages * blk, hkv, hd).transpose(1, 2)
    kpos = torch.arange(pages * blk, device=q.device)
    mask = (kpos[None] < lengths[:, None]) & (tables >= 0).repeat_interleave(blk, 1)
    return torch.nn.functional.scaled_dot_product_attention(
        q.reshape(b, hkv * rep, 1, hd), k, v, attn_mask=mask[:, None, None],
        enable_gqa=True)


def phase_kernels() -> dict:
    from repro_torch.kernels import paged_attention as pa
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, tables, lengths = case = _paged_case(dtype)
        got = pa.paged_attention(*case)
        want = pa.paged_attention_ref(*case)
        torch.cuda.synchronize()
        tol = KERNEL_TOL[dtype]
        err = (got.float() - want.float()).abs().max().item()
        if not torch.isfinite(got).all():
            fail(f"paged_attention {dtype}: non-finite output")
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            fail(f"paged_attention {dtype}: max |kernel - plain| = {err:.3e} "
                 f"beyond atol=rtol={tol:g}")
        if got[2].abs().max().item() != 0.0:
            fail(f"paged_attention {dtype}: the dead row is not 0")
        live = _live_positions(tables, lengths, k.shape[1])
        live_bytes = 2 * live * q.shape[1] * q.shape[3] * k.element_size()
        copies = [(q, k.clone(), v.clone(), tables, lengths)
                  for _ in range(-(-L2_FLUSH_BYTES // live_bytes))]
        ms = device_ms([lambda c=c: pa.paged_attention(*c) for c in copies])
        plain_ms = device_ms([lambda c=c: pa.paged_attention_ref(*c) for c in copies])
        library_ms = device_ms([lambda c=c: _library_paged(*c) for c in copies])
        del copies
        hkv, rep, hd = q.shape[1], q.shape[2], q.shape[3]
        esz = k.element_size()
        nbytes = (2 * live * hkv * hd * esz + 2 * q.numel() * q.element_size()
                  + tables.numel() * 4 + lengths.numel() * 4)
        ops = 4 * live * hkv * rep * hd
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S[dtype] * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rec[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms,
                          bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        print(f"[kernels] paged_attention {str(dtype)[6:]}: max|kernel-plain| {err:.3e} "
              f"(bound atol=rtol={tol:g}); kernel {ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us, gather+sdpa {library_ms * 1e3:.2f} us, bound "
              f"{bound_ms * 1e3:.3f} us ({nbytes} B over {PEAK_BYTES_S:.3g} B/s, "
              f"{live} live positions); device times from CUDA-graph replays over "
              f"{-(-L2_FLUSH_BYTES // live_bytes)} input copies (cold L2)", flush=True)
    return rec


# ---------------------------------------------------------------------------
def phase_serve(cfg, params):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.scheduler import Scheduler, make_requests
    sched = Scheduler(cfg, params, slots=SLOTS, max_len=PROMPT + GEN, paged=True,
                      block=BLOCK, chunk=CHUNK)
    sched.run(make_requests(2, PROMPT, 2, cfg.vocab))          # warmup
    sched.reset()
    torch.cuda.reset_peak_memory_stats()
    reqs = make_requests(N_REQ, PROMPT, GEN, cfg.vocab, stagger=STAGGER)
    pa.launches = 0
    out = sched.run(reqs)
    launches = pa.launches
    comps = out["completions"]
    if sorted(comps) != list(range(N_REQ)):
        fail(f"served {sorted(comps)} of {N_REQ} requests")
    for c in comps.values():
        if len(c.tokens) != GEN or not all(0 <= t < cfg.vocab for t in c.tokens):
            fail(f"request {c.rid}: {len(c.tokens)} tokens, or one out of the vocab")
    want = out["decode_steps"] * cfg.n_layers
    if launches != want:
        fail(f"paged_attention launches {launches} != decode steps "
             f"{out['decode_steps']} x {cfg.n_layers} layers = {want}")
    ttft = sorted(c.ttft_s for c in comps.values())
    print(f"[serve] {cfg.name} bf16, {N_REQ} req x ({PROMPT} prompt + {GEN} gen), "
          f"{SLOTS} slots, block {BLOCK}, chunk {CHUNK}: {out['generated']} tokens in "
          f"{out['wall_s']:.3f} s = {out['tok_s']:.1f} tok/s; TTFT p50 "
          f"{ttft[len(ttft) // 2] * 1e3:.1f} ms; {out['ticks']} ticks, "
          f"{out['decode_steps']} decode steps, {launches} kernel launches; peak pool "
          f"occupancy {out['pool']['peak_occupancy']:.3f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return comps[0], launches


def phase_oracle(cfg, params, comp) -> None:
    """Re-run one served request through chunked prefill + decode steps
    (teacher-forced on its own tokens) and hold every step's logits against
    ``forward`` over the same sequence."""
    from repro_torch.launch.scheduler import make_requests
    from repro_torch.models import transformer as T
    from repro_torch.parallel import steps as S
    from repro_torch.serving import BlockPool
    prompt = np.asarray(make_requests(N_REQ, PROMPT, GEN, cfg.vocab,
                                      stagger=STAGGER)[comp.rid].prompt)
    toks = np.concatenate([prompt, np.asarray(comp.tokens[:-1], np.int32)])
    seq = torch.from_numpy(toks.astype(np.int64)).cuda()[None]
    with torch.no_grad():
        ref = T.forward(params, seq, cfg)[0, PROMPT - 1:]            # (GEN, V)
    n_pages = -(-(PROMPT + GEN) // BLOCK)
    pool = BlockPool(n_pages, BLOCK)
    pool.admit(0, PROMPT + GEN)
    cache = T.init_paged_cache(cfg, n_pages, BLOCK, device="cuda")
    prefill = S.make_chunk_prefill_step(cfg)
    decode = S.make_decode_step(cfg, return_logits=True)
    got = []
    for lo in range(0, PROMPT, CHUNK):
        ln = min(CHUNK, PROMPT - lo)
        pool.ensure(0, lo + ln)
        chunk = torch.zeros((1, CHUNK), dtype=torch.int32, device="cuda")
        chunk[0, :ln] = seq[0, lo:lo + ln]
        table = torch.from_numpy(pool.table(0, n_pages)[None]).cuda()
        logits, cache = prefill(params, chunk, cache, lo, table, ln)
    got.append(logits[0])
    for i in range(GEN - 1):
        pos = PROMPT + i
        pool.ensure(0, pos + 1)
        table = torch.from_numpy(pool.table(0, n_pages)[None]).cuda()
        logits, cache = decode(params, seq[0, pos:pos + 1].to(torch.int32), cache,
                               torch.tensor([pos], dtype=torch.int32, device="cuda"), table)
        got.append(logits[0])
    got = torch.stack(got)
    if not torch.isfinite(got).all():
        fail("decode-path logits are not finite")
    diff = got - ref
    rel = (diff.norm(dim=-1) / ref.norm(dim=-1)).max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"[oracle] request {comp.rid}: decode-path logits vs forward over {len(toks)} "
          f"tokens: max per-row relative RMS {rel:.3e} (bound {ORACLE_REL_RMS:g}), max "
          f"|diff| {diff.abs().max().item():.3e} of max |logit| "
          f"{ref.abs().max().item():.3e}, argmax agreement {agree:.3f}", flush=True)
    if rel > ORACLE_REL_RMS:
        fail(f"decode-path logits differ from forward: relative RMS {rel:.3e}")


def phase_trace(cfg, params) -> None:
    """Where the serve time goes: kernel time on the device, by kind,
    against the host's wall clock, over a profiled serve run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.scheduler import Scheduler, make_requests
    sched = Scheduler(cfg, params, slots=SLOTS, max_len=PROMPT + GEN, paged=True,
                      block=BLOCK, chunk=CHUNK)
    sched.run(make_requests(2, PROMPT, 2, cfg.vocab))          # warmup
    sched.reset()
    reqs = make_requests(4, PROMPT, 16, cfg.vocab, stagger=STAGGER)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = sched.run(reqs)
    kinds = {"paged_attention": 0.0, "matmul": 0.0, "other": 0.0}
    n = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        us = e.time_range.elapsed_us()
        name = e.name.lower()
        if "paged_attention" in name:
            kinds["paged_attention"] += us
        elif any(k in name for k in ("nvjet", "gemm", "xmma", "cutlass")):
            kinds["matmul"] += us
        else:
            kinds["other"] += us
    wall_ms = out["wall_s"] * 1e3
    busy_ms = sum(kinds.values()) / 1e3
    if n == 0:
        print(f"[trace] the profiler recorded no device events: device busy time not "
              f"measured (wall {wall_ms:.1f} ms)", flush=True)
        return
    print(f"[trace] 4 req x ({PROMPT} prompt + 16 gen), {out['decode_steps']} decode steps: "
          f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}) in {n} device events; paged_attention "
          f"{kinds['paged_attention'] / 1e3:.1f} ms, matmul {kinds['matmul'] / 1e3:.1f} ms, "
          f"other {kinds['other'] / 1e3:.1f} ms (wall time is under the profiler)",
          flush=True)


# ---------------------------------------------------------------------------
def main() -> None:
    name = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.models import transformer as T
    phase_build()
    rec = phase_kernels()
    cfg = configs.get(ARCH)
    t0 = time.perf_counter()
    params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"]["embedding"]] +
                   [w for lp in params["layers"] for d in lp.values() for w in d.values()])
    print(f"[init] {cfg.name}: {n_params / 1e9:.3f} B parameters (bf16 matrices) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    comp, launches = phase_serve(cfg, params)
    phase_oracle(cfg, params, comp)
    phase_trace(cfg, params)
    bf = rec[torch.bfloat16]
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:90",
        "launches": launches, "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
        "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
        "bound_by": bf["bound_by"], "library_ms": bf["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
