#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py

Phases, each printing its lines and seconds and each failing the run on
error:

  1. device   -- the card's name and power limit, torch and CUDA versions;
                 stops when there is no CUDA device;
  2. build    -- builds every kernel from ``src/repro_torch/kernels/csrc``
                 and prints each kernel function's registers, spills and
                 static shared memory (``ptxas``);
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 timed beside the plain version, one library call and its
                 bound:
                 paged attention (split-KV) in bf16 and f32 at the serving
                 path's shape (B=4 slots, Hkv=8, rep=3, hd=128, block 16,
                 36-page tables), at B=1 with an 8192-token context and at
                 B=64 rows of up to 576 tokens (one split), with dead rows,
                 -1 entries and partial pages; per shape the split count,
                 and the split and combine kernels' device times from a
                 profiler trace; then the serve shape with scale=0.05;
                 then the end-aligned decode's rows read through the
                 kernel at the benchmark cells' shapes (ChatGLM3-6B: B 128
                 x L 5120 and B 64 x L 7168, Hkv 2, rep 16, hd 128, bf16,
                 about 27% of each row live; Mellum2-12B-A2.5B's group-8
                 build, Hkv 4, rep 8: B 64 x a ring of 1024 read up to
                 min(position + 1, 1024) and B 64 x L 7168), timed beside
                 the bytes bound, the plain route (``_sdpa`` over the
                 whole rows) and ``scaled_dot_product_attention``;
                 matmul at 4096^3 in f32 (the TMA-fed FFMA tile) and f16
                 (the wgmma tile), both also ragged (1000 x 1032 x 520: TMA
                 zero fill, bounded stores) and with f16 output, and the
                 host cost of one launch (its TMA maps); matmul_acc in
                 place, ragged with f32 and with f16 inputs, on a column
                 panel (lda > k), with an f16 C from either input dtype;
                 one view of each op and input dtype that TMA cannot read
                 (f16 (64x12)x(12x64), x[:, 1:] panels, f32 at 250^3),
                 which must go to the SIMT tile and nothing else; f32
                 matmul_acc at the SUMMA 2x4, pipelined 1x8 and 2.5D 2x2x2
                 block shapes of n = 8192 and f16-input matmul_acc (the
                 wgmma tile) at the SUMMA shape and at 4096^3 (in place, no
                 (m, n) temporary, timed against c.addmm_ / torch.addmm
                 with out_dtype=f32); minplus at 4096^3 with integer
                 weights and +inf entries (exactly equal);
                 flash attention at the fused prefill's shape (q (1, 24,
                 512, 128), k/v (1, 8, 512, 128), causal), a ragged causal
                 575, L = 8192 causal, Mixtral's window 4096 with 48/8
                 heads, Mellum2's 7104-token prefill with 32/4 heads with
                 its window 1024 and without, and a head size of 64 at batch 2 (32/8 heads, 937
                 queries on 1000 keys, window 256), in bf16 (the wgmma
                 kernel) and f32 (the CUDA-core one), and query rows with
                 no key (exactly 0);
                 the grouped expert kernels (gate+up, down, and down's
                 weighted scatter) at Mellum2-12B-A2.5B's decode (64 rows,
                 top-8 of 64) and 1500-token prefill, Mixtral-8x22B's
                 prefill (1500, top-2 of 8) and Kimi-K2's decode (64, top-8
                 of 384), then with padding rows past the groups at
                 Mellum2's and Mixtral's decode (every row tile taken),
                 against their plain versions (max error over max |plain|
                 within 2e-2, rows past the groups exactly 0), timed beside
                 their bound, the plain version and the per-expert
                 torch.matmul loop, which they must not trail at Mixtral's
                 prefill and Kimi-K2's decode; then one Mellum2 MoE layer
                 call at the decode and prefill shapes under
                 torch.cuda.set_sync_debug_mode("error"): no sync, 2
                 launches, within 2e-2 of the same call on the loop route;
                 and a bf16 call with a transposed expert weight raises;
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
                 products and everything else;
  7. matmul ranks -- the paper's distributed matmuls at n = 8192 in f32 on 8
                 gloo rank processes sharing ``cuda:0``: DNS on 2x2x2, SUMMA
                 and Cannon on 2x4, pipelined SUMMA on 1x8 and 2.5D Cannon on
                 2x2x2 through their ``*_kernel`` entry points, DNS on 2x2x2
                 and SUMMA on 2x4 again with f16 inputs and f32 output (the
                 tensor-core tile: exactly 8 matmul and 32 matmul_acc
                 launches), and ``generic_matmul`` on 8; each against
                 ``torch.matmul`` of the whole matrices (of the f16 values
                 widened, for the f16 runs), the kernels' launch counts
                 against the algorithm's, and per algorithm its wall time,
                 the device time of its kernel launches and the bytes it
                 staged through the host;
  8. fw ranks -- blocked Floyd-Warshall at n = 8192 on 2x2 ranks with the
                 minplus kernel (24 launches), equal to the plain-version run
                 and to the single-device oracle; the faithful Algorithm 3
                 at n = 2048 (2n staged broadcasts).

Between 6 and 7, on the same model and request mix as 4:

  serve aligned  -- ``Scheduler(paged=False)``, the end-aligned engine: one
                 fused prefill per admission (bucket 16, max_len 576),
                 through the wgmma flash kernel in every layer, so its launch
                 count must equal non-empty admissions x 28 (and the CUDA-core
                 flash kernel's 0), and every decode step reads the rows
                 through the paged-attention kernel (launches = the decode
                 steps whose Python ran x 28: the eager warm-up and the
                 capture of the engine's CUDA graph, every other step a
                 replay); its tokens must equal those of an eager engine
                 (the decode graph refused) on the same requests, every
                 one; prints the share of greedy tokens equal to the
                 paged engine's (not gated);
  oracle aligned -- one served request re-run teacher-forced through a fused
                 prefill and end-aligned decode steps, against ``forward``.

After those and before 7, on the same model (trained, not served):

  train      -- 8 steps of ``make_train_step`` on full-width, full-depth
                 Llama-3.2-3B (batch 8 x seq 256, f32 master parameters,
                 bf16 compute and grads, f32 AdamW moments, full remat),
                 each loss finite; the step time (the walls of steps 2-8
                 summed over 7; their median beside it) and the peak memory
                 beside the cost model's predictions on H100 constants
                 (``train_step_cost``, ``train_memory_bytes +
                 train_activation_bytes``); the forward/backward and the
                 AdamW update timed alone; one step under the profiler
                 (device busy against wall);
  train reduced -- the reduced config's loss and grads on the card against
                 the CPU from the same state, every remat mode, f32 and
                 bf16 compute, and one train step's parameters;
  train launcher -- ``launch/train.py``'s main path at reduced width with an
                 injected fault, in a fresh process under
                 ``torch.use_deterministic_algorithms(True)`` (with
                 ``CUBLAS_WORKSPACE_CONFIG``, which must be set before cuBLAS
                 first initialises -- hence the process), on one process and
                 on 4 gloo ranks (``--ranks 4 --model-parallel 2 --plan
                 auto``); every run prints OK and each recovered final state
                 equals the uninterrupted run's, bit for bit, on every rank.

Phase 7 also fits a host-staging ``LinkClass`` (t_s, t_w) by least squares
to the f32 bodies' walls and prints every ``*_cost`` prediction with it
beside the body wall it measured.

After 8, the trainer on a mesh of gloo ranks sharing ``cuda:0``:

  train tp   -- full-width, full-depth Llama-3.2-3B on 2 ranks, mesh (1, 2),
                 tensor parallelism 2, through the launcher's per-rank body
                 (``launch.train.train_rank``) with the train phase's state,
                 data and TrainConfig, 3 steps: losses finite and within
                 2e-2 of the train phase's first three;
  train tp sp -- on "train tp"'s launch, its job with ``sequence_parallel``:
                 the residual between the layers is each rank's S/2 rows
                 (all-gathers before the column-parallel products,
                 reduce-scatters after the row-parallel ones), 3 steps,
                 losses within 2e-2 of the train phase's; bytes staged a
                 step, the share of the wall inside the collectives and the
                 peak memory a rank beside "train tp"'s; then one no-grad
                 forward of a batch on the same ranks: each rank's S/2
                 query rows through the tensor-core flash kernel (launches
                 a rank = 28, nothing else), each rank's kernel against its
                 plain version on its own inputs (bf16 2e-2), rank 0's
                 logits against the one-process bf16 ``forward`` (5e-2);
  dry run    -- CPU work in this process (``launch/dryrun.py``, the
                 program on ``meta`` tensors over a recording mesh): "train
                 tp" and "train tp sp" recorded for each of the 2 ranks
                 (their model, batch, layout and TrainConfig), each rank's
                 recorded ``staged_bytes`` equal to the bytes its step
                 staged on the card, to the byte; the record's FLOPs beside
                 ``costmodel.model_flops_train``, its argument bytes and
                 peak estimate beside the ranks' measured peak; then
                 Llama-3.2-3B x {train_4k, prefill_32k, decode_32k} on the
                 (16, 16) mesh, each prefill counting 28 abstract flash
                 launches and the card's flash counters not moving; the
                 records' roofline table filled into a template under
                 ``build/`` through ``launch/report.py``;
  train layouts -- full width, depth cut to 2 layers, f32 compute and
                 gradients, on 4 ranks (mesh 2 x 2), in a fresh process under
                 deterministic algorithms: TP with all-reduce, TP + FSDP with
                 ZeRO, dp_over_model with ZeRO, dp_over_model + FSDP with
                 all-reduce and the layout ``plan_search`` picks (its ranking
                 printed), 2 steps each from the same state, held against one
                 process's steps on the card (losses, grad norms, AdamW's
                 first moments after step 1 over the whole tree, 1e-4; each
                 leaf's error, and the moments and parameters after step 2,
                 printed).
Each prints its step walls and tokens/s, every rank's peak memory and the
bytes each rank staged a step, and the planner's predicted step time on
the H100 constants' NVLink and on the staging link fitted in phase 7.

Then the other model families, each model's memory freed before the next
(bf16 matrices from a seeded generator on the card; each serve phase zeroes
the kernels' launch counts just before its run and reads them just after;
an end-aligned phase first serves the same requests through an eager
engine, the decode graph refused, and its graphed engine's tokens must
equal those, every one):

  serve moe aligned -- Mixtral-8x22B at its published width (d 6144, 48/8
                 heads, hd 128, 8 experts top-2, d_ff 16384, window 4096),
                 depth cut from 56 to 4 layers (20.8 GB; the whole model is
                 282 GB), through ``Scheduler(paged=False)`` on the llama
                 phases' mix: tensor-core flash launches = non-empty
                 admissions x 4, paged launches = decode calls x 4 (the
                 decode over the rows; a replay of the decode graph calls
                 no wrapper), grouped expert launches = 2 x 4 x model
                 calls; then one served request teacher-forced
                 through a fused prefill and end-aligned decode steps
                 against ``forward``, both in f32 arithmetic on the served
                 bf16 weights (f32 cache), with the (token, layer) top-2
                 sets that differ between the two counted;
  serve mellum2 aligned -- Mellum2-12B-A2.5B whole (28 layers, 24.3 GB;
                 the benchmark's configuration file) through the end-aligned
                 engine at the code cell's max_len 7168: 4 prompts of 1500
                 tokens (past the 1024 window) and 4 of 600, 4 slots, bucket
                 16: tensor-core flash launches = admissions x 28 (window
                 1024 on 21 layers, none on 7), none of the CUDA-core kernel,
                 paged launches = decode calls x 28 (the group-8 build over
                 21 rings and 7 rows), grouped expert launches = 2 x 28 x
                 model calls (the per-expert loop never runs);
  serve moe paged -- Kimi-K2 at its published width (d 7168, 64/8 heads,
                 384 experts top-8 and a shared expert, expert d_ff 2048),
                 depth cut from 61 to 1 (39 GB), the paged-attention kernel
                 checked at its decode shape (rep 8), then 4 requests of 256
                 + 32 tokens through ``Scheduler(paged=True)`` (4 slots,
                 block 16, chunk 256): paged launches = decode steps,
                 grouped expert launches = 2 x model calls; the f32 oracle
                 through chunked prefill and paged decode (its f32
                 arithmetic takes the per-expert loop);
  serve hybrid, serve xlstm -- Zamba2-1.2B and xLSTM-1.3B at full width,
                 depth cut to 19 of 38 and 24 of 48 layers (whole periods of
                 their block patterns), 4 requests of 128 + 32 tokens on 2 slots through
                 the per-token recurrent prefill (paged launches: decode
                 calls x Zamba2's shared-attention layers, none in xLSTM);
                 the f32 oracle through B=1 decode steps;
  serve encdec -- Whisper-base at full size: the flash kernel checked at
                 the encoder's shape (non-causal, L 1500, hd 64), then stub
                 frames (1, 1500, 512) through ``make_prefill_step`` and 32
                 greedy ``make_decode_step``s: flash launches = the
                 encoder's 6 + the decoder prefill's 6; logits against
                 ``encdec.forward`` (bf16, the served arithmetic);
  train families -- each family's reduced config in f32: loss and every
                 gradient leaf on the card against the CPU, then one train
                 step and the parameters after it (1e-5 / 1e-4);
  moe ranks  -- Mixtral-8x22B's MoE FFN at full width (one layer, bf16,
                 4 x 256 tokens) on 8 gloo ranks sharing the card, mesh (2,
                 4): the EP and a2a layouts, and the TP layout at 3
                 experts, each against the one-process layer (rtol 2e-2,
                 atol 2e-3), with each rank's wall, bytes staged and peak
                 memory.

Then serving under a mesh ctx, on gloo ranks sharing ``cuda:0`` (every rank
with its parameter and cache blocks; counts set to 0 just before each
served run and read just after, in the rank):

  serve ranks -- full-width, full-depth Llama-3.2-3B in bf16 on 2 ranks,
                 mesh (1, 2), through ``Scheduler(ctx=)``: 4 requests of
                 512 + 64 tokens, 4 slots, stagger 2, end-aligned (the
                 fused prefill's S/2 rows a rank through the tensor-core
                 flash kernel: launches a rank = non-empty admissions x 28)
                 and paged (block 16, chunk 256: paged launches a rank =
                 decode steps x 28); tok/s, TTFT p50, each rank's peak
                 memory, bytes staged and seconds inside collectives; the
                 ranks' tokens equal and beside the one-process engine's
                 (first position that differs, not gated); each rank's
                 flash kernel against its plain version on the inputs its
                 served prefills gave it (bf16 2e-2); request 0
                 teacher-forced through the ranks' fused prefill and
                 end-aligned decode (and chunked prefill and paged decode)
                 in f32 arithmetic on the bf16 weights against the
                 one-process ``forward`` (relative RMS 1e-3), and in bf16
                 as served against the one-process bf16 path (5e-2);
  serve ranks whole cache -- on "serve ranks"' launch and weights,
                 Llama-3.2-3B served end-aligned with max_len 575 and bucket
                 15, which 2 does not divide (4 requests of 512 + 63
                 tokens): every rank holds, writes and scores every slot
                 with no combine; flash launches a rank = admissions x 28,
                 each rank's flash kernel against its plain version on its
                 served inputs, request 0's bf16 logits teacher-forced
                 against the one-process bf16 path (5e-2); tok/s, TTFT,
                 staged bytes and peak memory a rank;
  serve ranks families -- Zamba2-1.2B (depth 7, 64 heads split over mesh
                 (1, 2)), Mixtral-8x22B (depth 2, EP over (1, 2), a
                 capacity no assignment overflows) and Whisper-base (mesh
                 (1, 2), 16 greedy tokens, flash launches a rank 12) on
                 the same launch, then xLSTM-1.3B (depth 8) on 8 ranks,
                 mesh (1, 8), its mLSTM engine split on dk with the partial
                 sums over ``model`` every chunk; each served through the
                 scheduler, and a teacher-forced path in f32 arithmetic
                 against one process's same path (relative RMS 1e-3,
                 Mixtral's routing flips printed); Whisper's bf16 logits
                 against the one-process ``encdec.forward`` (5e-2); the
                 flash kernel of Mixtral's and Whisper's ranks against its
                 plain version on their served inputs;
  train families ranks -- the reduced Zamba2, xLSTM and Whisper configs in
                 f32 on 4 ranks, mesh (2, 2): the loss and every gradient
                 leaf at the initial state, then 2 steps, against one
                 process on the card (loss 1e-5, leaves and step losses
                 1e-4, the first step's grad norm 1e-5).

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  TF32 is off for every f32 product.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12                       # H100 SXM HBM3
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
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
BUCKET = 16                                  # the end-aligned engine's prompt pad


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


def _ptxas_rows(log: str):
    """(kernel function, registers, spill bytes, static shared memory bytes)
    for each entry function in an ``nvcc -Xptxas -v`` log."""
    rows, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            rows.append((name, int(m.group(1)), spill, int(smem.group(1)) if smem else 0))
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt", "-p"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(rows):
            rows = [(n,) + r[1:] for n, r in zip(names, rows)]
    return rows


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build()
    wall = time.perf_counter() - t0
    for name, rep in report.items():
        rows = _ptxas_rows(rep["ptxas"])
        print(f"[build] {name}: {rep['seconds']:.1f}s; {len(rows)} kernel function(s)",
              flush=True)
        for fn, regs, spill, smem in rows:
            print(f"[build]   {fn}: {regs} registers, {spill} B spilled, {smem} B static "
                  f"shared memory", flush=True)
    print(f"[build] {len(report)} kernel(s) in {wall:.1f}s", flush=True)


# ---------------------------------------------------------------------------
# (label, B, table pages P, lengths, dead rows, dead entries (row, page)
# below the length): the serving path's decode shape (4 slots, a 36-page
# table of 576 tokens over a 144-block pool: row 0 full, row 1 ending
# mid-page with a dead entry, row 2 dead (a parked slot), row 3 of 33
# tokens); one request of an 8192-token context, where the splits carry
# the work (partial last page, a dead entry); and 64 rows of up to 576
# tokens, where B * Hkv fills the card with one split
_SERVE_PAGES = -(-(PROMPT + GEN) // BLOCK)
PAGED_CASES = [
    ("serve", SLOTS, _SERVE_PAGES,
     [_SERVE_PAGES * BLOCK, _SERVE_PAGES * BLOCK // 2 + 12, 100, 2 * BLOCK + 1],
     (2,), ((1, 5),)),
    ("long context", 1, 8192 // BLOCK, [8192 - 5], (), ((0, 100),)),
    ("batch 64", 64, _SERVE_PAGES,
     [_SERVE_PAGES * BLOCK, 300] + list(np.random.RandomState(7).randint(
         1, _SERVE_PAGES * BLOCK + 1, size=62)), (2, 40), ((1, 5), (9, 0))),
]


def _paged_case(dtype, b, pages, lengths, dead_rows, holes, seed=0):
    """Random q and arenas (Hkv=8, rep=3, hd=128, block 16) over a pool of
    B * P blocks; each live row's chain takes fresh blocks, the rest of its
    table is -1."""
    hkv, rep, hd, blk = 8, 3, 128, BLOCK
    n_blocks = b * pages
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, hkv, rep, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((n_blocks, blk, hkv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((n_blocks, blk, hkv, hd), generator=g, device="cuda").to(dtype)
    perm = np.random.RandomState(seed).permutation(n_blocks)
    tables = np.full((b, pages), -1, np.int32)
    used = 0
    for row, ln in enumerate(lengths):
        if row in dead_rows:
            continue
        chain = -(-ln // blk)
        tables[row, :chain] = perm[used:used + chain]
        used += chain
    for row, page in holes:
        tables[row, page] = -1
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


def _paged_kernel_ms(copies):
    """Mean device time a call of the split kernel and of the combine
    kernel, from a profiler trace of one call per copy; (None, None) when
    the profiler records no device event."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import paged_attention as pa
    for c in copies:
        pa.paged_attention(*c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in copies:
            pa.paged_attention(*c)
        torch.cuda.synchronize()
    us = {"paged_attention_split": 0.0, "paged_attention_combine": 0.0}
    seen = False
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in us:
            if name in e.name:
                us[name] += e.time_range.elapsed_us()
                seen = True
    if not seen:
        return None, None
    return tuple(us[n] / 1e3 / len(copies) for n in us)


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
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for label, b, pages, lengths, dead_rows, holes in PAGED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, tables, lengths_t = case = _paged_case(dtype, b, pages, lengths,
                                                            dead_rows, holes)
            n_splits, pps = pa.split_plan(b, q.shape[1], pages, n_sm)
            before = pa.launches
            got = pa.paged_attention(*case)
            want = pa.paged_attention_ref(*case)
            torch.cuda.synchronize()
            if pa.launches != before + 1:
                fail(f"paged_attention {label} {dtype}: the wrapper counted "
                     f"{pa.launches - before} launches for one call")
            tol = KERNEL_TOL[dtype]
            err = (got.float() - want.float()).abs().max().item()
            if not torch.isfinite(got).all():
                fail(f"paged_attention {label} {dtype}: non-finite output")
            if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
                fail(f"paged_attention {label} {dtype}: max |kernel - plain| = {err:.3e} "
                     f"beyond atol=rtol={tol:g}")
            for row in dead_rows:
                if got[row].abs().max().item() != 0.0:
                    fail(f"paged_attention {label} {dtype}: dead row {row} is not 0")
            del got, want
            live = _live_positions(tables, lengths_t, k.shape[1])
            hkv, rep, hd = q.shape[1], q.shape[2], q.shape[3]
            esz = k.element_size()
            live_bytes = 2 * live * hkv * hd * esz
            n_copies = -(-L2_FLUSH_BYTES // live_bytes)
            copies = [(q, k.clone(), v.clone(), tables, lengths_t) for _ in range(n_copies)]
            ms = device_ms([lambda c=c: pa.paged_attention(*c) for c in copies])
            split_ms, combine_ms = _paged_kernel_ms(copies)
            plain_ms = device_ms([lambda c=c: pa.paged_attention_ref(*c) for c in copies])
            library_ms = device_ms([lambda c=c: _library_paged(*c) for c in copies])
            del copies
            nbytes = (live_bytes + 2 * q.numel() * q.element_size()
                      + tables.numel() * 4 + lengths_t.numel() * 4)
            # the kernel's arithmetic is f32 on the CUDA cores, whatever the dtype
            bound_ms, by, bytes_ms, _ = _bound(nbytes, 4 * live * hkv * rep * hd,
                                               PEAK_OPS_S[torch.float32])
            rec[(label, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                       library_ms=library_ms, bound_ms=bound_ms, bound_by=by)
            kern = ("split and combine kernels not seen by the profiler" if split_ms is None
                    else f"split kernel {split_ms * 1e3:.2f} us + combine kernel "
                         f"{combine_ms * 1e3:.2f} us (profiler)")
            print(f"[kernels] paged_attention {label} {str(dtype)[6:]} (B {b}, Hkv {hkv}, "
                  f"rep {rep}, hd {hd}, block {k.shape[1]}, P {pages}; S {n_splits} of "
                  f"{pps} pages): max|kernel-plain| {err:.3e} (atol=rtol={tol:g}); kernel "
                  f"{ms * 1e3:.2f} us ({kern}), plain {plain_ms * 1e3:.2f} us, "
                  f"gather+sdpa {library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
                  f"({nbytes} B over {PEAK_BYTES_S:.3g} B/s = {bytes_ms * 1e3:.3f} us, by "
                  f"{by}; {live} live positions); graph replays over {n_copies} input "
                  f"copies (cold L2)", flush=True)
            del case, q, k, v
            torch.cuda.empty_cache()
    # a scale other than 1/sqrt(hd) (paged_attention_pallas's scale=) at the
    # serve shape
    _, b, pages, lengths, dead_rows, holes = PAGED_CASES[0]
    for dtype in (torch.float32, torch.bfloat16):
        case = _paged_case(dtype, b, pages, lengths, dead_rows, holes, seed=1)
        before = pa.launches
        got = pa.paged_attention(*case, scale=0.05)
        want = pa.paged_attention_ref(*case, scale=0.05)
        default = pa.paged_attention_ref(*case)
        torch.cuda.synchronize()
        tol = KERNEL_TOL[dtype]
        err = (got.float() - want.float()).abs().max().item()
        moved = (default.float() - want.float()).abs().max().item()
        print(f"[kernels] paged_attention serve {str(dtype)[6:]} scale=0.05: max|kernel-plain| "
              f"{err:.3e} (atol=rtol={tol:g}); the default scale's result is {moved:.3e} away",
              flush=True)
        if pa.launches != before + 1 or not torch.isfinite(got).all() or \
                not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol) or \
                not moved > tol:
            fail(f"paged_attention scale=0.05 {dtype}: max |kernel - plain| = {err:.3e}, "
                 f"{pa.launches - before} launches, or the scale changed nothing")
        del case, got, want, default
    return rec


# the end-aligned decode's rows at the benchmark cells' decode shapes:
# (label, slots B, slots a row L, Hkv, rep, max_len).  ChatGLM3-6B: 2 kv
# heads of 16 query heads; Mellum2-12B-A2.5B: 4 of 32 (group 8), a ring of
# its 1024 window on the window layers and rows of max_len on the full
# ones.  Each row's position drawn exponential with a mean of 28% of
# max_len, clipped to [1, max_len], as the cells' rows are 25-29% live; a
# ring reads min(position + 1, L) slots (``layers.attention``'s ring decode)
ROWS_CASES = [("glm6b.conv", 128, 5120, 2, 16, 5120), ("glm6b.code", 64, 7168, 2, 16, 7168),
              ("mellum2 ring", 64, 1024, 4, 8, 7168), ("mellum2 full", 64, 7168, 4, 8, 7168)]
ROWS_HD, ROWS_LIVE = 128, 0.28


def phase_rows_kernel() -> None:
    """The end-aligned decode's route at the cells' shapes: the rows (B, L,
    Hkv, hd) read as an arena of B * L / 256 pages through the kernel
    (``layers._rows_decode``), held against ``paged_attention_ref`` on the
    same view and timed beside its bytes bound, the plain route the decode
    takes without the kernel (``_sdpa`` over every whole row: causal at
    each row's position, or on a ring over its valid slots) and
    ``scaled_dot_product_attention`` over the rows with a length mask."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import layers as L
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for label, b, lk, hkv, rep, max_len in ROWS_CASES:
        g = torch.Generator(device="cuda").manual_seed(5)
        q = torch.randn((b, 1, hkv, rep, ROWS_HD), generator=g,
                        device="cuda").to(torch.bfloat16)
        ck, cv = (torch.randn((b, lk, hkv, ROWS_HD), generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        drawn = np.random.RandomState(5).exponential(ROWS_LIVE * max_len, size=b)
        ring = lk < max_len
        lengths = torch.from_numpy(np.minimum(np.clip(drawn, 1, max_len), lk)
                                   .astype(np.int32)).cuda()
        pos = (lengths - 1).long()
        blk = L.rows_block(lk)
        arena = (b * lk // blk, blk, hkv, ROWS_HD)
        table = L._rows_table(b, lk // blk, ck.device)
        before = pa.launches
        got = L._rows_decode(q, ck, cv, lengths)
        want = pa.paged_attention_ref(q[:, 0], ck.view(arena), cv.view(arena), table,
                                      lengths)[:, None]

        def plain_route():
            if ring:
                return L._sdpa(q, ck, cv, causal=False, window=None, q_offset=0,
                               kv_len_valid=lengths)
            return L._sdpa(q, ck, cv, causal=True, window=None, q_offset=pos)
        plain = plain_route()
        torch.cuda.synchronize()
        tol = KERNEL_TOL[torch.bfloat16]
        err = (got.float() - want.float()).abs().max().item()
        err_plain = (got.float() - plain.float()).abs().max().item()
        if pa.launches != before + 1 or not torch.isfinite(got).all() or \
                not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol) or \
                not torch.allclose(got.float(), plain.float(), atol=tol, rtol=tol):
            fail(f"rows decode {label}: max |kernel - plain| {err:.3e}, against _sdpa "
                 f"{err_plain:.3e} (atol=rtol={tol:g}), {pa.launches - before} launches")
        del want, plain
        mask = torch.arange(lk, device="cuda")[None] < lengths[:, None]

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q.reshape(b, hkv * rep, 1, ROWS_HD), ck.transpose(1, 2),
                cv.transpose(1, 2), attn_mask=mask[:, None, None], enable_gqa=True)
        ms = device_ms([lambda: L._rows_decode(q, ck, cv, lengths)])
        split_ms, combine_ms = _paged_kernel_ms(
            [(q[:, 0].contiguous(), ck.view(arena), cv.view(arena), table, lengths)])
        plain_ms = device_ms([plain_route])
        library_ms = device_ms([library])
        live = int(lengths.sum())
        nbytes = 2 * live * hkv * ROWS_HD * 2 + 2 * q.numel() * 2 + b * 4
        bound_ms, by, _, _ = _bound(nbytes, 4 * live * hkv * rep * ROWS_HD,
                                    PEAK_OPS_S[torch.float32])
        n_splits, pps = pa.split_plan(b, hkv, lk // blk, n_sm)
        kern = ("split and combine kernels not seen by the profiler" if split_ms is None
                else f"split kernel {split_ms * 1e3:.1f} us + combine kernel "
                     f"{combine_ms * 1e3:.1f} us (profiler)")
        print(f"[kernels] rows decode {label} bf16 (B {b} x L {lk}{' ring' if ring else ''}, "
              f"Hkv {hkv}, rep {rep}, hd {ROWS_HD}, block {blk}; S {n_splits} of {pps} pages; "
              f"{live} live positions, {live / (b * lk):.3f} of the rows): max|kernel-plain| "
              f"{err:.3e}, against _sdpa {err_plain:.3e} (atol=rtol={tol:g}); kernel "
              f"{ms * 1e3:.1f} us ({kern}), plain route (_sdpa over the whole rows) "
              f"{plain_ms * 1e3:.1f} us, sdpa {library_ms * 1e3:.1f} us, bound "
              f"{bound_ms * 1e3:.1f} us ({nbytes} B over {PEAK_BYTES_S:.3g} B/s, by {by}); "
              f"kernel share of the bound {100 * bound_ms / ms:.1f}%", flush=True)
        del q, ck, cv, got
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# flash attention: the end-aligned engine's fused prefill and ``forward``
FLASH_CASES = [  # (label, B, Hq, Hkv, Lq, Lk, hd, causal, window)
    ("serve prefill", 1, 24, 8, PROMPT, PROMPT, 128, True, None),
    ("ragged causal", 1, 24, 8, PROMPT + GEN - 1, PROMPT + GEN - 1, 128, True, None),
    ("long causal", 1, 24, 8, 8192, 8192, 128, True, None),
    ("Mixtral window", 1, 48, 8, 8192, 8192, 128, True, 4096),
    # Mellum2-12B-A2.5B's prefill (32/4 heads, group 8) of the code mix's
    # longest prompt: its 1024 window on the window layers, none on the full
    ("Mellum2 window", 1, 32, 4, 7104, 7104, 128, True, 1024),
    ("Mellum2 full", 1, 32, 4, 7104, 7104, 128, True, None),
    # the D = 64 instantiation (Zamba2-1.2B's head size) with a batch of 2
    # (the 4-D TMA maps' batch dim), grouped heads, queries end-aligned to
    # longer keys, ragged lengths and a window
    ("hd 64 batch 2", 2, 32, 8, 937, 1000, 64, True, 256),
]


def _library_flash(q, k, v, causal, window):
    """scaled_dot_product_attention: the yardstick, never used by the port."""
    if window is None:
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    lq, lk = q.shape[2], k.shape[2]
    qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    kpos = torch.arange(lk, device=q.device)[None, :]
    mask = (qpos - kpos < window) & ((kpos <= qpos) if causal else True)
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                            enable_gqa=True)


# max |kernel - plain| of the CUDA-core kernel over the same cases on the
# card (PERF.md, PR 8), printed beside this run's
PR8_FLASH_ERR = {torch.bfloat16: "PR 8's CUDA-core kernel <= 3.9e-3",
                 torch.float32: "PR 8 <= 2.3e-6"}


def phase_flash_kernels() -> dict:
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(2)
    rec = {}
    for label, b, hq, hkv, lq, lk, hd, causal, window in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            def make():
                return (torch.randn((b, hq, lq, hd), generator=g, device="cuda").to(dtype),
                        torch.randn((b, hkv, lk, hd), generator=g, device="cuda").to(dtype),
                        torch.randn((b, hkv, lk, hd), generator=g, device="cuda").to(dtype))
            q, k, v = make()
            route = fa._route(dtype, dtype, hd)
            before = (fa.launches, fa.launches_wgmma)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            ran = (fa.launches - before[0], fa.launches_wgmma - before[1])
            want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            if ran != ((0, 1) if route == "wgmma" else (1, 0)):
                fail(f"flash_attention {label} {dtype}: route {route} but launches "
                     f"(simt, wgmma) +{ran}")
            tol = KERNEL_TOL[dtype]
            err = (got.float() - want.float()).abs().max().item()
            if not torch.isfinite(got).all():
                fail(f"flash_attention {label} {dtype}: non-finite output")
            if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
                fail(f"flash_attention {label} {dtype}: max |kernel - plain| = {err:.3e} "
                     f"beyond atol=rtol={tol:g}")
            del got, want
            esz = q.element_size()
            nbytes = 2 * q.numel() * esz + 2 * k.numel() * esz      # q, out; k, v
            cases = _copies(make, nbytes)
            slow = lq > 2048
            ms = device_ms([lambda c=c: fa.flash_attention(*c, causal=causal, window=window)
                            for c in cases], replays=3 if slow else 10)
            plain_ms = device_ms([lambda c=c: fa.flash_attention_ref(*c, causal=causal,
                                                                     window=window)
                                  for c in cases], replays=2 if slow else 10)
            library_ms = device_ms([lambda c=c: _library_flash(*c, causal, window)
                                    for c in cases], replays=2 if slow else 10)
            del cases
            pairs = fa.visible_pairs(lq, lk, causal, window) * b * hq
            bound_ms, by, bytes_ms, ops_ms = _bound(nbytes, 4 * hd * pairs, PEAK_OPS_S[dtype])
            rec[(label, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                       library_ms=library_ms, bound_ms=bound_ms, bound_by=by)
            print(f"[kernels] flash_attention {label} {str(dtype)[6:]} ({route} kernel) q "
                  f"({b}, {hq}, {lq}, {hd}) k/v ({b}, {hkv}, {lk}, {hd}) causal={causal} "
                  f"window={window}: max|kernel-plain| {err:.3e} (atol=rtol={tol:g}; "
                  f"{PR8_FLASH_ERR[dtype]}); kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
                  f"= max({pairs / 1e6:.2f} M live pairs x 4 x {hd} = "
                  f"{4 * hd * pairs / 1e9:.2f} GFLOP / {PEAK_OPS_S[dtype] / 1e12:g} TFLOP/s = "
                  f"{ops_ms:.4f} ms, {nbytes / 1e6:.1f} MB / 3.35 TB/s = {bytes_ms:.4f} ms), "
                  f"by {by}", flush=True)
        torch.cuda.empty_cache()
    # query rows that see no key (Lq > Lk, causal): exactly 0, row by row --
    # row 63 of the first 64-row tile sees a key, rows 0-62 do not
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, 24, 100, 128), generator=g, device="cuda").to(dtype)
        k = torch.randn((1, 8, 37, 128), generator=g, device="cuda").to(dtype)
        v = torch.randn((1, 8, 37, 128), generator=g, device="cuda").to(dtype)
        got = fa.flash_attention(q, k, v)
        want = fa.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        dead = int((got[:, :, :63] != 0).sum())
        err = (got[:, :, 63:].float() - want[:, :, 63:].float()).abs().max().item()
        print(f"[kernels] flash_attention no-key rows {str(dtype)[6:]} q (1, 24, 100, 128) "
              f"k/v (1, 8, 37, 128) causal: rows 0-62 see no key, {dead} nonzero entries "
              f"there; rows 63-99 max|kernel-plain| {err:.3e}", flush=True)
        if dead or not err <= KERNEL_TOL[dtype]:
            fail(f"flash_attention {dtype}: rows with no key are not all 0, or the rest "
                 f"differ from the plain version ({err:.3e})")
    return rec


# ---------------------------------------------------------------------------
# the grouped expert products at the serving path's shapes: (label, tokens
# T, experts E, top-k, d, ff, rows past offsets[E]).  Mellum2-12B-A2.5B's
# decode (64 slots: 512 rows, row tile 16, as the cell decodes) and a
# 1500-token prefill, Mixtral-8x22B's 1500-token prefill, Kimi-K2's decode;
# then padding past the groups (the token-routing layout's), which must come
# out exactly 0, on Mellum2's and Mixtral-8x22B's decode.  Between them the
# cases take every row tile the kernels are built for
GROUPED_CASES = [
    ("mellum2 decode", 64, 64, 8, 2304, 896, 0),
    ("mellum2 prefill", 1500, 64, 8, 2304, 896, 0),
    ("mixtral prefill", 1500, 8, 2, 6144, 16384, 0),
    ("kimi decode", 64, 384, 8, 7168, 2048, 3),
    ("mellum2 decode padded", 64, 64, 8, 2304, 896, 5),
    ("mixtral decode padded", 64, 8, 2, 6144, 16384, 3),
]
GROUPED_REL_TOL = 2e-2      # max |kernel - plain| over max |plain|, bf16 outputs
# where the kernels must not trail the per-expert torch.matmul loop: the
# shapes with many rows an expert, bound by operations or by scattered bytes
GROUPED_NOT_SLOWER = ("mixtral prefill", "kimi decode")


def _grouped_case(t, e, k, d, ff, pad, seed):
    """Rows sorted by their top-k experts of random logits (``pad`` rows
    past the groups), their offsets, bf16 expert matrices N(0, 1/fan-in)."""
    from repro_torch.models import moe as M
    g = torch.Generator(device="cuda").manual_seed(seed)
    eid = torch.sort(M.top_k(torch.randn((t, e), generator=g, device="cuda"), k)[1]
                     .reshape(-1), stable=True)[0]
    eid = torch.cat([eid, torch.full((pad,), e, dtype=eid.dtype, device="cuda")])
    xs = torch.randn((t * k + pad, d), generator=g, device="cuda", dtype=torch.bfloat16)
    ws = [torch.randn((e, a, b), generator=g, device="cuda", dtype=torch.bfloat16)
          .mul_(a ** -0.5) for a, b in ((d, ff), (d, ff), (ff, d))]
    return xs, M._offsets(eid, e), ws


def _errs(got: torch.Tensor, want: torch.Tensor):
    """max |got - want| and that over max |want|."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / want.float().abs().max().item()


def phase_grouped_kernels() -> dict:
    """Each grouped kernel against its plain version at GROUPED_CASES, then
    timed from CUDA-graph replays beside its bound, the plain version and
    the per-expert loop; then one Mellum2 MoE layer call at the decode and
    prefill shapes under ``torch.cuda.set_sync_debug_mode("error")``: the
    untraced layer never waits for the device, and launches the two
    kernels."""
    from repro_torch.kernels import grouped_matmul as gm
    rec, slower, tiles = {}, [], set()
    for i, (label, t, e, k, d, ff, pad) in enumerate(GROUPED_CASES):
        xs, off, ws = _grouped_case(t, e, k, d, ff, pad, seed=10 + i)
        off_host = off.cpu()
        sizes = torch.diff(off_host).tolist()
        rows, hit = xs.shape[0], sum(n > 0 for n in sizes)
        before = gm.launches
        h = gm.grouped_gate_up(xs, ws[0], ws[1], off)
        y = gm.grouped_down(h, ws[2], off)
        torch.cuda.synchronize()
        if gm.launches - before != 2:
            fail(f"grouped {label}: {gm.launches - before} launches for gate+up and down")
        abs_h, err_h = _errs(h, gm.grouped_gate_up_ref(xs, ws[0], ws[1], off_host))
        abs_y, err_y = _errs(y, gm.grouped_down_ref(h, ws[2], off_host))
        # the scatter epilogue (the combine's weighted put): exactly the put
        # of the bf16 rows, three slots no row lists left 0
        slots = torch.randperm(rows + 3, device="cuda")[:rows]
        scale = torch.rand(rows + 3, device="cuda")
        scattered = torch.equal(gm.grouped_down(h, ws[2], off, slots, scale),
                                gm.scatter(y, slots, scale))
        loop = gm.ragged_swiglu(xs, *ws, sizes)
        err_loop = _errs(y, loop)[1]
        tiles.add(gm.row_tile(rows, e))
        past = int((h[t * k:] != 0).sum() + (y[t * k:] != 0).sum())
        print(f"[kernels] grouped {label}: rows {rows} ({pad} past the groups), {hit} of {e} "
              f"experts given a row, d {d}, ff {ff}, row tile {gm.row_tile(rows, e)}; "
              f"max|kernel - plain| / max|plain|: gate+up {err_h:.3e}, down {err_y:.3e} "
              f"(bound {GROUPED_REL_TOL:g}); against the loop {err_loop:.3e}; nonzero past "
              f"the groups {past}; scatter equal to the put {scattered}", flush=True)
        if not (err_h <= GROUPED_REL_TOL and err_y <= GROUPED_REL_TOL) or past or \
                not torch.isfinite(y).all() or not scattered:
            fail(f"grouped {label}: the kernels differ from their plain versions "
                 f"({err_h:.3e}, {err_y:.3e}), rows past the groups are not 0 ({past}) or "
                 f"the scatter differs from the put")
        del h, y, loop
        slow = label.startswith("mixtral")
        ms = device_ms([lambda: gm.grouped_down(gm.grouped_gate_up(xs, ws[0], ws[1], off),
                                                ws[2], off)])
        gate_up_ms = device_ms([lambda: gm.grouped_gate_up(xs, ws[0], ws[1], off)])
        plain_ms = device_ms([lambda: gm.grouped_down_ref(
            gm.grouped_gate_up_ref(xs, ws[0], ws[1], off_host), ws[2], off_host)],
            replays=2 if slow else 10)
        loop_ms = device_ms([lambda: gm.ragged_swiglu(xs, *ws, sizes)])
        nbytes = (hit * 3 * d * ff + 2 * rows * d) * 2          # moe_experts_roofline's count
        bound_ms, by, bytes_ms, ops_ms = _bound(nbytes, 6 * t * k * d * ff,
                                                PEAK_OPS_S[torch.bfloat16])
        rec[label] = dict(max_abs_err=max(abs_h, abs_y), max_rel_err=max(err_h, err_y), ms=ms,
                          plain_ms=plain_ms, library_ms=loop_ms, bound_ms=bound_ms, bound_by=by)
        print(f"[kernels] grouped {label}: kernels {ms:.4f} ms (gate+up {gate_up_ms:.4f}, "
              f"down {ms - gate_up_ms:.4f}), {100 * bound_ms / ms:.1f}% of the bound "
              f"{bound_ms:.4f} ms = max({nbytes / 1e9:.3f} GB / 3.35 TB/s = {bytes_ms:.4f} ms, "
              f"{6 * t * k * d * ff / 1e9:.1f} GFLOP / 989 TFLOP/s = {ops_ms:.4f} ms), by {by}; "
              f"plain {plain_ms:.4f} ms; per-expert torch.matmul loop {loop_ms:.4f} ms "
              f"({loop_ms / ms:.2f}x the kernels)", flush=True)
        if label in GROUPED_NOT_SLOWER and ms > loop_ms:
            slower.append(f"{label}: the kernels {ms:.4f} ms, the loop {loop_ms:.4f} ms")
        del xs, off, ws
        torch.cuda.empty_cache()
    if tiles != set(gm._ROW_TILES):
        fail(f"grouped: the cases took row tiles {sorted(tiles)}, not all of {gm._ROW_TILES}")
    _mellum2_layer_never_syncs()
    if slower:
        fail(f"grouped: slower than the per-expert loop at {slower}")
    return rec


def _mellum2_layer_never_syncs() -> None:
    """One Mellum2 MoE layer call at the decode and prefill shapes under
    ``set_sync_debug_mode("error")``: two launches, and the output within
    GROUPED_REL_TOL of the same call on the per-expert loop (one weight
    requiring grad, so autograd records); then a bf16 call with a weight the
    kernels do not take (a transposed copy) raises, as no layout falls back
    to the loop on the card."""
    import bench.harness
    import bench.spec
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models import moe as M
    model = bench.spec.config(bench.spec.benchmark(ROOT), MELLUM2_CONFIG, ROOT)["model"]
    cfg = bench.harness.port_config(model)
    g = torch.Generator(device="cuda").manual_seed(3)
    p = M.moe_init(g, cfg, dtype=torch.bfloat16)
    for b, s in ((64, 1), (1, 1500)):
        x = torch.randn((b, s, cfg.d_model), generator=g, device="cuda", dtype=torch.bfloat16)
        with torch.no_grad():
            M.moe_ffn(p, x, cfg)                            # warm: builds, allocates
            torch.cuda.synchronize()
            before = gm.launches
            torch.cuda.set_sync_debug_mode("error")
            try:
                y, _ = M.moe_ffn(p, x, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launched = gm.launches - before
        live = {**p, "w_up": p["w_up"].detach().requires_grad_(True)}
        want, _ = M.moe_ffn(live, x, cfg)                  # autograd records: the loop
        looped = gm.launches - before - launched
        _, err = _errs(y, want.detach())
        print(f"[kernels] grouped: one Mellum2 MoE layer call at x ({b}, {s}, {cfg.d_model}) "
              f"under set_sync_debug_mode('error'): no sync, {launched} launches; "
              f"max|layer - loop route| / max|loop route| {err:.3e} (bound "
              f"{GROUPED_REL_TOL:g}), kernel launches on the loop route {looped}", flush=True)
        if launched != 2 or looped or not err <= GROUPED_REL_TOL:
            fail(f"grouped: a Mellum2 layer call launched {launched} kernels (want 2), the "
                 f"loop route {looped} (want 0), or differs from the loop route by {err:.3e}")
        del live, want
    bad = {**p, "w_up": p["w_up"].transpose(1, 2).contiguous().transpose(1, 2)}
    try:
        with torch.no_grad():
            M.moe_ffn(bad, x, cfg)
    except ValueError as exc:
        print(f"[kernels] grouped: a bf16 layer call with a transposed w_up raises: "
              f"{str(exc)[:80]}...", flush=True)
    else:
        fail("grouped: a bf16 layer call with a weight the kernels do not take ran")
    del p, bad
    torch.cuda.empty_cache()


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
    if launches != want or out["decode_replays"]:
        fail(f"paged_attention launches {launches} ({out['decode_replays']} decode replays, "
             f"want none) != decode steps "
             f"{out['decode_steps']} x {cfg.n_layers} layers = {want}")
    ttft = sorted(c.ttft_s for c in comps.values())
    print(f"[serve] {cfg.name} bf16, {N_REQ} req x ({PROMPT} prompt + {GEN} gen), "
          f"{SLOTS} slots, block {BLOCK}, chunk {CHUNK}: {out['generated']} tokens in "
          f"{out['wall_s']:.3f} s = {out['tok_s']:.1f} tok/s; TTFT p50 "
          f"{ttft[len(ttft) // 2] * 1e3:.1f} ms; {out['ticks']} ticks, "
          f"{out['decode_steps']} decode steps, {launches} kernel launches; peak pool "
          f"occupancy {out['pool']['peak_occupancy']:.3f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return comps, launches


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
    decode = S.make_decode_step(cfg, return_logits=True, paged=True)
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


def _decode_calls(tag: str, out: dict) -> int:
    """The decode steps of an end-aligned run on the card whose Python ran,
    and so the decode's kernel wrapper calls; every step after the first
    must be a replay, which calls none."""
    steps, replays = out["decode_steps"], out["decode_replays"]
    if replays != steps - 1:
        fail(f"{tag}: {replays} of {steps} decode steps replayed from the graph; want all but "
             f"the first")
    return min(steps, 2)   # the eager warm-up and the capture


def _eager_tokens(cfg, params, reqs, **kw) -> dict:
    """The tokens of ``reqs`` served by an engine built as ``Scheduler(cfg,
    params, **kw)`` but with the rule refusing the decode graph, so every
    decode step runs eagerly: {rid: tokens}."""
    from unittest import mock

    from repro_torch.launch import scheduler
    with mock.patch.object(scheduler, "decode_graphed", lambda *a: False):
        sched = scheduler.Scheduler(cfg, params, **kw)
    out = sched.run(reqs)
    if out["decode_replays"]:
        fail(f"the eager engine replayed {out['decode_replays']} decode steps")
    return {r: c.tokens for r, c in out["completions"].items()}


def _same_as_eager(tag: str, comps: dict, eager: dict) -> None:
    """The graphed engine's tokens must be the eager engine's, every one."""
    got = {r: c.tokens for r, c in comps.items()}
    if got != eager:
        bad = [r for r in eager if got.get(r) != eager[r]]
        fail(f"{tag}: the graphed engine's tokens differ from the eager engine's in requests "
             f"{bad}")
    print(f"[{tag}] the graphed engine's tokens equal the eager engine's: "
          f"{sum(map(len, got.values()))} tokens of {len(got)} requests", flush=True)


# ---------------------------------------------------------------------------
def phase_serve_aligned(cfg, params, paged_comps):
    """The end-aligned engine on the paged phase's request mix: one fused
    prefill per admission, through the flash kernel in each of the layers."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.scheduler import Scheduler, make_requests
    sched = Scheduler(cfg, params, slots=SLOTS, max_len=PROMPT + GEN, bucket=BUCKET)
    sched.run(make_requests(2, PROMPT, 2, cfg.vocab))          # warmup
    sched.reset()
    reqs = make_requests(N_REQ, PROMPT, GEN, cfg.vocab, stagger=STAGGER)
    eager = _eager_tokens(cfg, params, reqs, slots=SLOTS, max_len=PROMPT + GEN, bucket=BUCKET)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_wgmma = pa.launches = 0
    out = sched.run(reqs)
    launches, simt, paged = fa.launches_wgmma, fa.launches, pa.launches
    comps = out["completions"]
    if sorted(comps) != list(range(N_REQ)):
        fail(f"served {sorted(comps)} of {N_REQ} requests")
    for c in comps.values():
        if len(c.tokens) != GEN or not all(0 <= t < cfg.vocab for t in c.tokens):
            fail(f"request {c.rid}: {len(c.tokens)} tokens, or one out of the vocab")
    admissions = sum(1 for r in reqs if len(r.prompt) > 0)
    want = admissions * cfg.n_layers
    if out["prefills"] != admissions or launches != want or simt != 0:
        fail(f"flash_attention wgmma launches {launches} (CUDA-core kernel {simt}), fused "
             f"prefills {out['prefills']}; want {admissions} non-empty admissions x "
             f"{cfg.n_layers} layers = {want} wgmma launches and none of the other kernel")
    calls = _decode_calls("serve aligned", out)
    want_paged = calls * cfg.n_layers
    if paged != want_paged or not want_paged:
        fail(f"paged_attention launches {paged}; want decode calls {calls} x "
             f"{cfg.n_layers} layers = {want_paged}: the decode reads the rows through it")
    ttft = sorted(c.ttft_s for c in comps.values())
    same = sum(a == b for i in comps for a, b in zip(comps[i].tokens, paged_comps[i].tokens))
    print(f"[serve aligned] {cfg.name} bf16, {N_REQ} req x ({PROMPT} prompt + {GEN} gen), "
          f"{SLOTS} slots, max_len {PROMPT + GEN}, bucket {BUCKET}: {out['generated']} tokens "
          f"in {out['wall_s']:.3f} s = {out['tok_s']:.1f} tok/s; TTFT p50 "
          f"{ttft[len(ttft) // 2] * 1e3:.1f} ms; {out['ticks']} ticks, {out['decode_steps']} "
          f"decode steps ({out['decode_replays']} replays), {out['prefills']} fused "
          f"prefills, {launches} flash_attention "
          f"(wgmma) launches, {paged} paged_attention launches; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"greedy tokens equal to the paged engine's at {same} of {N_REQ * GEN} positions "
          f"({same / (N_REQ * GEN):.3f}, not gated)", flush=True)
    _same_as_eager("serve aligned", comps, eager)
    return comps, launches


def phase_oracle_aligned(cfg, params, comp) -> None:
    """Re-run one served request teacher-forced through a fused prefill and
    end-aligned decode steps; hold every step's logits against ``forward``
    over the same sequence."""
    from repro_torch.launch.scheduler import make_requests
    from repro_torch.models import transformer as T
    from repro_torch.parallel import steps as S
    prompt = np.asarray(make_requests(N_REQ, PROMPT, GEN, cfg.vocab,
                                      stagger=STAGGER)[comp.rid].prompt)
    toks = np.concatenate([prompt, np.asarray(comp.tokens[:-1], np.int32)])
    seq = torch.from_numpy(toks.astype(np.int64)).cuda()[None]
    with torch.no_grad():
        ref = T.forward(params, seq, cfg)[0, PROMPT - 1:]            # (GEN, V)
    cache = T.init_cache(cfg, 1, PROMPT + GEN, device="cuda")
    prefill = S.make_prefill_step(cfg)
    decode = S.make_decode_step(cfg, return_logits=True)
    logits, cache = prefill(params, {"tokens": seq[:, :PROMPT].to(torch.int32),
                                     "length": torch.tensor([PROMPT], device="cuda")}, cache)
    got = [logits[0]]
    for i in range(GEN - 1):
        pos = PROMPT + i
        logits, cache = decode(params, seq[0, pos:pos + 1].to(torch.int32), cache,
                               torch.tensor([pos], dtype=torch.int32, device="cuda"))
        got.append(logits[0])
    got = torch.stack(got)
    if not torch.isfinite(got).all():
        fail("end-aligned logits are not finite")
    diff = got - ref
    rel = (diff.norm(dim=-1) / ref.norm(dim=-1)).max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"[oracle aligned] request {comp.rid}: fused prefill + end-aligned decode logits vs "
          f"forward over {len(toks)} tokens: max per-row relative RMS {rel:.3e} (bound "
          f"{ORACLE_REL_RMS:g}), max |diff| {diff.abs().max().item():.3e} of max |logit| "
          f"{ref.abs().max().item():.3e}, argmax agreement {agree:.3f}", flush=True)
    if rel > ORACLE_REL_RMS:
        fail(f"end-aligned logits differ from forward: relative RMS {rel:.3e}")


# ---------------------------------------------------------------------------
# training: full-width steps, the reduced step against the CPU, the launcher
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 8     # the launcher's batch and sequence
# the reduced step, card against CPU: f32 (loss relative, grads normwise a
# leaf; the two differ in summation order only), bf16 compute (one bf16
# rounding, 2**-8, at different places in a few ops)
TRAIN_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
LAUNCH_ARGS = ["--steps", "8", "--ckpt-every", "3"]
# the same on 4 gloo ranks (mesh 2 x 2), the layout the planner picks
LAUNCH_RANKS_ARGS = LAUNCH_ARGS + ["--ranks", "4", "--model-parallel", "2", "--plan", "auto"]
# runs the launcher twice, with an injected fault and without, in one fresh
# process: deterministic algorithms need CUBLAS_WORKSPACE_CONFIG before cuBLAS
# first initialises, which this process did long ago (the launcher's ranks
# take the setting from the process that launches them).  With --ranks the
# states are the ranks' blocks, as numpy
LAUNCH_CHILD = r"""
import json, sys, numpy as np, torch
torch.use_deterministic_algorithms(True)
from repro_torch.launch import train
from repro_torch.tree import leaves
args, d_fault, d_clean = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
s1, h1 = train.main(args + ["--ckpt-dir", d_fault, "--inject-fault-at", "5"])
s2, h2 = train.main(args + ["--ckpt-dir", d_clean])
s1, s2 = (s1, s2) if isinstance(s1, list) else ([s1], [s2])
eq = lambda a, b: torch.equal(a, b) if torch.is_tensor(a) else bool(np.array_equal(a, b))
print(json.dumps({"equal": all(eq(a, b) for x, y in zip(s1, s2)
                               for a, b in zip(leaves(x), leaves(y))),
                  "ranks": len(s1), "steps": [h["step"] for h in h1]}))
"""


def _train_setup(cfg):
    from repro_torch.config import ParallelConfig, ShapeConfig, TrainConfig
    # the launcher's settings at its batch and sequence, with JAX's default
    # layout: f32 master parameters, bf16 compute and grads, f32 moments,
    # full remat
    pcfg = ParallelConfig(remat="full", fsdp_params=False)
    tcfg = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=TRAIN_STEPS, z_loss=0.0)
    return pcfg, tcfg, ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_BATCH)


def phase_train(cfg) -> list:
    """Full-width, full-depth steps of ``make_train_step`` on the card, each
    loss finite; step time and peak memory beside the cost model's
    predictions on H100 constants; then the forward/backward and the
    optimizer alone, and one profiled step.  Returns the losses."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import optim
    from repro_torch.core import costmodel as cm
    from repro_torch.data import make_batch_iterator
    from repro_torch.parallel import steps as S
    from repro_torch.tree import leaves, tree_map, tree_unflatten
    pcfg, tcfg, shape = _train_setup(cfg)
    counts = cfg.param_counts()
    print(f"[train] {cfg.name}: {counts['total'] / 1e9:.3f} B parameters, {cfg.n_layers} "
          f"layers, d {cfg.d_model}, vocab {cfg.vocab}; batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}; f32 master parameters, bf16 compute, {pcfg.grad_dtype} grads, "
          f"{pcfg.opt_state_dtype} AdamW moments, remat={pcfg.remat}; allocated before "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = S.init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg, pcfg)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    print(f"[train] init {time.perf_counter() - t0:.1f} s; state {state_bytes / 1e9:.2f} GB "
          f"(parameters and both moments)", flush=True)
    step = S.make_train_step(cfg, pcfg, tcfg)
    batches = make_batch_iterator(cfg, shape, seed=tcfg.seed, device="cuda")
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        print(f"[train] step {i}: loss {losses[-1]:.4f}, grad norm {float(m['grad_norm']):.3f}, "
              f"lr {float(m['lr']):.2e}, {times[-1] * 1e3:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        fail(f"train: a non-finite loss in {losses}")
    # the window's rate: every wall of steps 2..N summed, so a stalled step
    # counts; the median beside it is a per-step statistic
    window = times[1:]
    mean = float(np.sum(window)) / len(window)
    med = float(np.median(window))
    toks = TRAIN_BATCH * TRAIN_SEQ
    act = cm.train_activation_bytes(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, cfg.d_ff,
                                    cfg.n_layers, cfg.vocab, remat=pcfg.remat)
    mem = cm.train_memory_bytes(counts["total"], param_bytes=4, grad_bytes=2,
                                opt_state_bytes=4, activation_bytes=act)
    pred = cm.train_step_cost(counts["active"], counts["total"], toks, chips=1,
                              batch_local=TRAIN_BATCH, seq=TRAIN_SEQ, d_model=cfg.d_model,
                              n_layers=cfg.n_layers, param_bytes=4, grad_bytes=2,
                              opt_state_bytes=4, remat=pcfg.remat)
    print(f"[train] step time over steps 2-{TRAIN_STEPS} (sum of their walls / "
          f"{len(window)}): {mean * 1e3:.1f} ms, {toks * len(window) / float(np.sum(window)):.0f} "
          f"tokens/s over the window (per-step median {med * 1e3:.1f} ms, min "
          f"{min(window) * 1e3:.1f}, max {max(window) * 1e3:.1f}); cost model on H100 constants "
          f"(spec sheet, uncalibrated): {pred['total_s'] * 1e3:.1f} ms = max(compute "
          f"{pred['compute_s'] * 1e3:.1f}, parameter streaming {pred['memory_s'] * 1e3:.1f}) "
          f"+ optimizer traffic {pred['update_s'] * 1e3:.1f}; measured / predicted "
          f"{mean / pred['total_s']:.2f}; achieved {6 * counts['active'] * toks * 4 / 3 / mean / 1e12:.1f} "
          f"TFLOP/s of model FLOPs with the recompute", flush=True)
    print(f"[train] peak memory (max_memory_allocated, init included): {peak / 1e9:.2f} GB; "
          f"cost model train_memory_bytes + train_activation_bytes: {mem['total'] / 1e9:.2f} GB "
          f"(parameters {mem['params'] / 1e9:.2f} + grads {mem['grads'] / 1e9:.2f} + moments "
          f"{mem['opt'] / 1e9:.2f} + activations {act / 1e9:.2f}); gap {(peak - mem['total']) / 1e9:.2f} "
          f"GB (the model does not count autograd's f32 gradients, "
          f"{4 * counts['total'] / 1e9:.2f} GB, nor the transients of the loss and the update)",
          flush=True)

    # the layers alone: forward/backward, then the optimizer
    loss_fn = S.make_loss_fn(cfg, pcfg, tcfg)
    batch = next(batches)
    batches.close()
    fb, upd = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live = [p.detach().requires_grad_(True) for p in leaves(state["params"])]
        loss, _ = loss_fn(tree_unflatten(state["params"], live), batch)
        grads = torch.autograd.grad(loss, live)
        torch.cuda.synchronize()
        fb.append(time.perf_counter() - t0)
        grads = tree_unflatten(state["params"], [g.to(torch.bfloat16) for g in grads])
        del live, loss
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optim.adamw_update(grads, state["opt"], state["params"], lr=1e-6)
        torch.cuda.synchronize()
        upd.append(time.perf_counter() - t0)
        del grads
    print(f"[train] layers alone (median of 3): forward+backward {np.median(fb) * 1e3:.1f} ms "
          f"(cost model compute {pred['compute_s'] * 1e3:.1f} ms); AdamW update "
          f"{np.median(upd) * 1e3:.1f} ms (cost model optimizer traffic "
          f"{pred['update_s'] * 1e3:.1f} ms)", flush=True)

    # one profiled step: device busy against wall, by kind
    batches = make_batch_iterator(cfg, shape, seed=tcfg.seed, start_step=TRAIN_STEPS,
                                  device="cuda")
    batch = next(batches)
    batches.close()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds = {"matmul": 0.0, "other": 0.0}
    n = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        name = e.name.lower()
        key = "matmul" if any(k in name for k in ("nvjet", "gemm", "xmma", "cutlass")) \
            else "other"
        kinds[key] += e.time_range.elapsed_us() / 1e3
    busy = sum(kinds.values())
    if n == 0:
        print(f"[train] the profiler recorded no device events: device busy time not "
              f"measured (wall {wall * 1e3:.1f} ms)", flush=True)
    else:
        print(f"[train] one profiled step: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy:.1f} ms (idle share {1 - busy / (wall * 1e3):.3f}) in {n} device events; "
              f"matrix products {kinds['matmul']:.1f} ms, everything else "
              f"{kinds['other']:.1f} ms (wall time is under the profiler)", flush=True)
    del state, m, prof
    torch.cuda.empty_cache()
    return losses


def _loss_and_grads(cfg, pcfg, tcfg, params, tokens):
    from repro_torch.parallel import steps as S
    from repro_torch.tree import leaves, tree_unflatten
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, _ = S.make_loss_fn(cfg, pcfg, tcfg)(tree_unflatten(params, live), {"tokens": tokens})
    return float(loss.detach()), [g.cpu() for g in torch.autograd.grad(loss, live)]


def _logits_cotangent_rounding(rcfg, params, tokens) -> tuple:
    """The card's bf16 logits product (``layers._MatmulF32``) rounds its f32
    cotangent to bf16 before both gradient products; the CPU route (and
    JAX's transpose) keeps it f32.  Both routes on the card, on unit-normal
    hidden states and the reduced model's embedding under the next-token
    CE: the normwise gap of the hidden-state and embedding gradients."""
    from repro_torch.models import layers as L
    from repro_torch.parallel import steps as S
    b, s = tokens.shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    x0 = torch.randn(b * s, rcfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    w0 = params["embed"]["embedding"].to(torch.bfloat16).t()
    grads = []
    for route in (L._MatmulF32.apply, lambda x, w: torch.matmul(x.float(), w.float())):
        x, w = x0.detach().requires_grad_(True), w0.detach().requires_grad_(True)
        logits = route(x, w).reshape(b, s, -1)
        loss = S.cross_entropy(logits[:, :-1], tokens[:, 1:])
        grads.append(torch.autograd.grad(loss, (x, w)))
    (gx, gw), (fx, fw) = grads
    return (float((gx.float() - fx.float()).norm() / fx.float().norm()),
            float((gw.float() - fw.float()).norm() / fw.float().norm()))


def phase_train_reduced(cfg) -> None:
    """The reduced config on the card and on the CPU from the same state:
    loss and grads in every remat mode and both compute dtypes, then one
    train step and the parameters after it."""
    from repro_torch import configs
    from repro_torch.parallel import steps as S
    from repro_torch.tree import leaves, tree_map
    pcfg, tcfg, _ = _train_setup(cfg)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, (TRAIN_BATCH, 64)).astype(np.int32))
    worst = {}
    for dtype in ("float32", "bfloat16"):
        rcfg = configs.reduced(cfg).replace(dtype=dtype)
        cpu = S.init_train_state(torch.Generator().manual_seed(0), rcfg, pcfg)
        gpu = tree_map(lambda t: t.to("cuda"), cpu)
        loss_tol, grad_tol = TRAIN_TOL[dtype]
        for remat in ("none", "full", "dots"):
            p = dataclasses.replace(pcfg, remat=remat)
            lc, gc = _loss_and_grads(rcfg, p, tcfg, cpu["params"], toks)
            lg, gg = _loss_and_grads(rcfg, p, tcfg, gpu["params"], toks.cuda())
            rel = abs(lg - lc) / abs(lc)
            gerr = max(float((a - b).norm() / b.norm()) for a, b in zip(gg, gc))
            worst[(dtype, remat)] = (rel, gerr)
            if not (rel <= loss_tol and gerr <= grad_tol):
                fail(f"train reduced {dtype} remat={remat}: card loss {lg} vs CPU {lc} "
                     f"(relative {rel:.2e}, bound {loss_tol}), worst grad leaf normwise "
                     f"{gerr:.2e} (bound {grad_tol})")
        if dtype == "bfloat16":
            rounding = _logits_cotangent_rounding(rcfg, gpu["params"], toks.cuda().long())
            if not max(rounding) <= grad_tol:
                fail(f"train reduced: the bf16 logits backward's rounded cotangent moves its "
                     f"gradients by {rounding} normwise (bound {grad_tol})")
        sc, mc = S.make_train_step(rcfg, pcfg, tcfg)(cpu, {"tokens": toks})
        sg, mg = S.make_train_step(rcfg, pcfg, tcfg)(gpu, {"tokens": toks.cuda()})
        perr = max(float((a.cpu() - b).norm() / b.norm())
                   for a, b in zip(leaves(sg["params"]), leaves(sc["params"])))
        rel = abs(float(mg["loss"]) - float(mc["loss"])) / float(mc["loss"])
        worst[(dtype, "step")] = (rel, perr)
        if not (rel <= loss_tol and perr <= grad_tol):
            fail(f"train reduced {dtype}: one step on the card vs the CPU: loss relative "
                 f"{rel:.2e}, parameters normwise {perr:.2e} (bounds {loss_tol}, {grad_tol})")
    print("[train reduced] card vs CPU from the same state, reduced "
          f"{cfg.name} at batch {TRAIN_BATCH} x 64: loss relative / worst grad leaf normwise: "
          + "; ".join(f"{d} {r}: {a:.1e} / {b:.1e}" for (d, r), (a, b) in worst.items())
          + f" (bounds f32 {TRAIN_TOL['float32']}, bf16 {TRAIN_TOL['bfloat16']}; 'step': "
          "one train step, parameters after it)", flush=True)
    print("[train reduced] bf16 logits backward on the card, cotangent rounded to bf16 "
          "(the card's route) against kept in f32 (the CPU's and JAX's): hidden-state "
          f"gradient {rounding[0]:.2e}, embedding gradient {rounding[1]:.2e} normwise",
          flush=True)


def phase_train_launcher() -> None:
    """``launch/train.py``'s main path at reduced width on the card, with
    an injected fault, in a fresh process under deterministic algorithms,
    on one process and then on 4 gloo ranks (``--ranks 4 --model-parallel 2
    --plan auto``); each recovered final state must equal an uninterrupted
    run's, bit for bit (on every rank)."""
    for args in (LAUNCH_ARGS, LAUNCH_RANKS_ARGS):
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                       CUBLAS_WORKSPACE_CONFIG=":4096:8")
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-c", LAUNCH_CHILD, json.dumps(args),
                                os.path.join(tmp, "fault"), os.path.join(tmp, "clean")],
                               capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
            wall = time.perf_counter() - t0
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or not lines:
            fail(f"train launcher: exit {r.returncode}\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        res = json.loads(lines[-1])
        for ln in lines[:-1]:
            if ln.strip():
                print(f"[train launcher] {ln}", flush=True)
        n_ok = sum(ln.strip() == "OK" for ln in lines)
        print(f"[train launcher] {' '.join(args)}, fault at step 5, deterministic "
              f"algorithms: steps run {res['steps']}; final state ({res['ranks']} rank(s)) "
              f"bitwise equal to the uninterrupted run: {res['equal']}; {n_ok} x OK; "
              f"{wall:.1f} s for both runs (process start included)", flush=True)
        if n_ok != 2 or not res["equal"]:
            fail(f"train launcher {' '.join(args)}: the recovered run did not reach OK or "
                 f"differs from the uninterrupted one")


# ---------------------------------------------------------------------------
# the tile kernels of the distributed path (matmul, matmul_acc, minplus)
TILE_TOL = {torch.float32: (1e-4, 1e-3), torch.float16: (2e-2, 2e-1)}   # rtol, atol
MINPLUS_OPS_S = PEAK_OPS_S[torch.float32] / 2   # an add or a min is one op, an FMA two
HOST_LAUNCHES = 500                          # fewer than the launch queue holds


def _copies(make, nbytes: int) -> list:
    """Enough copies of a case (at least one) that together they exceed the
    L2 flush size, so each timed call finds its inputs cold."""
    return [make() for _ in range(max(1, -(-L2_FLUSH_BYTES // nbytes)))]


def _bound(nbytes: float, ops: float, ops_s: float):
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, ops / ops_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), \
        bytes_ms, ops_ms


def _counted(km, fn):
    """Run ``fn``; return its result and the launch counters that moved."""
    before = dict(km.launches)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in km.launches.items() if v != before[k]}


def _tc_rel_bound(k: int) -> float:
    """Normwise bound between a tensor-core sum of k products of f16 values
    and the plain f32 one: sqrt(k) * (2^-23 + 2^-24), the tensor cores' f32
    adds truncating (a unit roundoff of 2^-23) and the plain version's
    rounding (2^-24)."""
    return k ** 0.5 * (2.0 ** -23 + 2.0 ** -24)


def phase_tile_kernels() -> dict:
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import minplus as kmp
    g = torch.Generator(device="cuda").manual_seed(1)
    rec = {}
    t0 = time.perf_counter()

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def check(label, got, want, tol_dtype, counted, key, rel_bound=None) -> float:
        """Kernel against plain within the reference's tolerance for
        ``tol_dtype`` (and, for tensor-core sums, a normwise bound), after one
        launch of ``key`` and of no other kernel."""
        rtol, atol = TILE_TOL[tol_dtype]
        diff = got.float() - want.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / want.float().norm()).item()
        print(f"[kernels] {label} ({key}): max|kernel-plain| {err:.3e} (rtol {rtol:g}, atol "
              f"{atol:g}); normwise {rel:.3e}"
              f"{f' (bound {rel_bound:.3e})' if rel_bound else ''}; launches {counted}",
              flush=True)
        if counted != {key: 1}:
            fail(f"{label}: launches {counted}, want one {key} launch and no other")
        if got.dtype != want.dtype or not torch.isfinite(got).all() or \
                not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol) or \
                (rel_bound is not None and not rel <= rel_bound):
            fail(f"{label}: max |kernel - plain| = {err:.3e} beyond rtol {rtol:g}, atol "
                 f"{atol:g}, or normwise {rel:.3e} beyond its bound (or a wrong dtype or "
                 f"a non-finite entry)")
        return err

    # matmul at 4096^3, f32 in (the TMA-fed FFMA tile) and f16 in (the wgmma
    # tile), f32 out, timed
    n = 4096
    for dtype in (torch.float32, torch.float16):
        a, b = rnd(n, n, dtype=dtype), rnd(n, n, dtype=dtype)
        key = km._route("matmul", dtype, torch.float32, True)
        got, counted = _counted(km, lambda: km.matmul(a, b))
        err = check(f"matmul {str(dtype)[6:]} {n}^3", got, km.matmul_ref(a, b), dtype,
                    counted, key)
        del got
        esz = a.element_size()
        nbytes = 2 * n * n * esz + n * n * 4
        cases = _copies(lambda: (a.clone(), b.clone()), 2 * n * n * esz)
        ms = device_ms([lambda c=c: km.matmul(*c) for c in cases])
        plain_ms = device_ms([lambda c=c: km.matmul_ref(*c) for c in cases])
        library_ms = device_ms([lambda c=c: torch.matmul(*c) for c in cases])
        del cases
        bound_ms, by, bytes_ms, ops_ms = _bound(nbytes, 2 * n ** 3, PEAK_OPS_S[dtype])
        rec[("matmul", dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      library_ms=library_ms, bound_ms=bound_ms, bound_by=by)
        print(f"[kernels] matmul {str(dtype)[6:]} {n}^3 ({key} kernel): kernel {ms:.3f} ms "
              f"({2 * n ** 3 / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
              f"torch.matmul {library_ms:.3f} ms{' (f16 out, tensor cores)' if esz == 2 else ''}"
              f" (kernel / torch.matmul {ms / library_ms:.2f}); bound {bound_ms:.3f} ms = "
              f"max(2*{n}^3 = {2 * n ** 3 / 1e9:.1f} GFLOP / {PEAK_OPS_S[dtype] / 1e12:g} "
              f"TFLOP/s = {ops_ms:.3f} ms, {nbytes / 1e6:.0f} MB / {PEAK_BYTES_S / 1e12:g} TB/s "
              f"= {bytes_ms:.3f} ms), by {by}", flush=True)

    # both input dtypes: a ragged shape (TMA zero fill past M, N and K;
    # bounded stores) and f16 out, against the plain version
    for dtype in (torch.float32, torch.float16):
        key = km._route("matmul", dtype, torch.float32, True)
        for (m, k, nn), out_dtype in (((1000, 1032, 520), torch.float32),
                                      ((1000, 1032, 520), torch.float16),
                                      ((n, n, n), torch.float16)):
            a, b = rnd(m, k, dtype=dtype), rnd(k, nn, dtype=dtype)
            got, counted = _counted(km, lambda: km.matmul(a, b, out_dtype=out_dtype))
            check(f"matmul {str(dtype)[6:]} ({m}x{k})x({k}x{nn}) -> {str(out_dtype)[6:]}", got,
                  km.matmul_ref(a, b, out_dtype=out_dtype),
                  torch.float16 if torch.float16 in (dtype, out_dtype) else torch.float32,
                  counted, key)

    # host cost of one launch through the wrapper; both TMA routes encode two
    # TMA maps in their C entry on every launch
    host_us = {}
    for dtype in (torch.float16, torch.float32):
        a, b = rnd(256, 256, dtype=dtype), rnd(256, 256, dtype=dtype)
        for _ in range(20):
            km.matmul(a, b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(HOST_LAUNCHES):
            km.matmul(a, b)
        host_us[dtype] = (time.perf_counter() - t1) / HOST_LAUNCHES * 1e6
        torch.cuda.synchronize()
    print(f"[kernels] matmul host time a launch (256^3, {HOST_LAUNCHES} launches, wrapper "
          f"checks and two TMA maps encoded in the C entry included): f16 "
          f"{host_us[torch.float16]:.1f} us, f32 {host_us[torch.float32]:.1f} us", flush=True)

    # matmul_acc in place against the plain version: a ragged shape (partial
    # tiles in M, N and K: TMA zero fill, bounded C traffic) with f32 and with
    # f16 inputs, a column panel of a wider block (lda > k, as summa_body
    # passes), and an f16 C from either input dtype
    blk = rnd(2048, 4096)
    r16 = {"dtype": torch.float16}
    for label, a, b, c in (
            ("f32 in ragged (1000x1032)x(1032x520)", rnd(1000, 1032), rnd(1032, 520),
             rnd(1000, 520)),
            ("f32 in column panel A[:, 2048:3072] of a (2048, 4096) block", blk[:, 2048:3072],
             rnd(1024, 2048), rnd(2048, 2048)),
            ("f16 in ragged (1000x1032)x(1032x520)", rnd(1000, 1032, **r16),
             rnd(1032, 520, **r16), rnd(1000, 520)),
            ("f16 in, f16 C (1000x1032)x(1032x520)", rnd(1000, 1032, **r16),
             rnd(1032, 520, **r16), rnd(1000, 520, **r16)),
            ("f32 in, f16 C (1000x1032)x(1032x520)", rnd(1000, 1032), rnd(1032, 520),
             rnd(1000, 520, **r16))):
        key = km._route("matmul_acc", a.dtype, c.dtype, True)
        want = km.matmul_acc_ref(a, b, c.clone())
        got, counted = _counted(km, lambda: km.matmul_acc(a, b, c))
        if got.data_ptr() != c.data_ptr():
            fail(f"matmul_acc {label}: the result is not c's storage")
        f16 = torch.float16 in (a.dtype, c.dtype)
        check(f"matmul_acc {label} (lda {a.stride(0)}), in place", got, want,
              torch.float16 if f16 else torch.float32, counted, key,
              _tc_rel_bound(a.shape[1]) if a.dtype == torch.float16 and
              c.dtype == torch.float32 else None)
    del blk

    # one view of each op and input dtype that TMA cannot read: the SIMT
    # tile's route, chosen from the view before the launch (never a
    # fallback), against the plain version
    wide16, wide32 = rnd(2048, 1025, **r16), rnd(1000, 1033)
    for label, op, args in (
            ("matmul f16 (64x12)x(12x64), 24-byte rows", "matmul",
             (rnd(64, 12, **r16), rnd(12, 64, **r16))),
            ("matmul f32 x[:, 1:] of (1000, 1033) times (1032x520), base 4 B off", "matmul",
             (wide32[:, 1:], rnd(1032, 520))),
            ("matmul_acc f16 in x[:, 1:] of (2048, 1025) times (1024x2048), base 2 B off",
             "matmul_acc", (wide16[:, 1:], rnd(1024, 2048, **r16), rnd(2048, 2048))),
            ("matmul_acc f32 250^3, 1000-byte rows", "matmul_acc",
             (rnd(250, 250), rnd(250, 250), rnd(250, 250)))):
        a = args[0]
        key = km._route(op, a.dtype, torch.float32, False)
        tma = km._route(op, a.dtype, torch.float32, True)
        if km.tma_aligned(a.shape, a.stride(), a.data_ptr(), a.element_size()):
            fail(f"{label}: TMA reads this view; the case is meant to be one it cannot")
        if op == "matmul":
            want = km.matmul_ref(*args)
            got, counted = _counted(km, lambda: km.matmul(*args))
        else:
            want = km.matmul_acc_ref(args[0], args[1], args[2].clone())
            got, counted = _counted(km, lambda: km.matmul_acc(*args))
        check(f"{label}: misaligned, so not {tma}", got, want, a.dtype, counted, key)
    del wide16, wide32

    # matmul_acc at the SUMMA 2x4 and pipelined 1x8 block shapes of n = 8192
    # and the 2.5D Cannon 2x2x2 block shape with f32 inputs (the FFMA tile);
    # with f16 inputs (the wgmma tile) at the SUMMA shape (the f16 SUMMA
    # run's panel step) and at 4096^3; in place, timed
    for m, k, nn, dtype in ((4096, 2048, 2048, torch.float32), (8192, 1024, 1024, torch.float32),
                            (4096, 4096, 4096, torch.float32),
                            (4096, 2048, 2048, torch.float16),
                            (4096, 4096, 4096, torch.float16)):
        a, b, c = rnd(m, k, dtype=dtype), rnd(k, nn, dtype=dtype), rnd(m, nn)
        want = km.matmul_acc_ref(a, b, c.clone())
        key = km._route("matmul_acc", dtype, torch.float32, True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got, counted = _counted(km, lambda: km.matmul_acc(a, b, c))
        grew = torch.cuda.max_memory_allocated() - base
        if got.data_ptr() != c.data_ptr():
            fail(f"matmul_acc ({m}, {k}, {nn}): the result is not c's storage")
        if grew >= m * nn * 4:
            fail(f"matmul_acc ({m}, {k}, {nn}): device memory grew {grew} B during the "
                 f"call, an (m, n) temporary is {m * nn * 4} B")
        tensor_cores = dtype == torch.float16
        err = check(f"matmul_acc {str(dtype)[6:]} in ({m}x{k})x({k}x{nn}), in place "
                    f"(memory grew {grew} B < {m * nn * 4} B)", got, want, dtype, counted, key,
                    _tc_rel_bound(k) if tensor_cores else None)
        esz = a.element_size()
        nbytes = (m * k + k * nn) * esz + 2 * m * nn * 4
        cases = _copies(lambda: (a.clone(), b.clone(), c.clone()), nbytes)
        ms = device_ms([lambda c=c: km.matmul_acc(*c) for c in cases])
        plain_ms = device_ms([lambda c=c: km.matmul_acc_ref(*c) for c in cases])
        library = "c.addmm_"
        if tensor_cores:
            # cuBLAS's addmm with out_dtype (aten::addmm.dtype); the yardstick
            # only, the port never calls it
            library = "torch.addmm(c, a, b, out_dtype=f32)"
            try:
                library_ms = device_ms([lambda c=c: torch.addmm(c[2], c[0], c[1],
                                                                out_dtype=torch.float32)
                                        for c in cases])
            except RuntimeError as e:
                library = (f"c.addmm_ of the widened inputs (addmm with out_dtype refused: "
                           f"{str(e).splitlines()[0]})")
                wide = [(x.float(), y.float(), z) for x, y, z in cases]
                library_ms = device_ms([lambda c=c: c[2].addmm_(c[0], c[1]) for c in wide])
                del wide
        else:
            library_ms = device_ms([lambda c=c: c[2].addmm_(c[0], c[1]) for c in cases])
        del cases
        bound_ms, by, bytes_ms, ops_ms = _bound(nbytes, 2 * m * k * nn, PEAK_OPS_S[dtype])
        rec[(f"matmul_acc_{str(dtype)[6:]}", (m, k, nn))] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=by)
        print(f"[kernels] matmul_acc {str(dtype)[6:]} in ({m}x{k})x({k}x{nn}) ({key} kernel): "
              f"kernel {ms:.4f} ms ({2 * m * k * nn / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, {library} {library_ms:.4f} ms (kernel / library "
              f"{ms / library_ms:.2f}); bound {bound_ms:.4f} ms = max(2*{m}*{k}*{nn} = "
              f"{2 * m * k * nn / 1e9:.2f} GFLOP / {PEAK_OPS_S[dtype] / 1e12:g} TFLOP/s = "
              f"{ops_ms:.4f} ms, {nbytes / 1e6:.1f} MB / 3.35 TB/s = {bytes_ms:.4f} ms), "
              f"by {by}", flush=True)

    # minplus at 4096^3: integer weights, some +inf; exact
    a = torch.randint(0, 100, (n, n), generator=g, device="cuda").float()
    b = torch.randint(0, 100, (n, n), generator=g, device="cuda").float()
    a[torch.rand((n, n), generator=g, device="cuda") < 0.1] = float("inf")
    b[torch.rand((n, n), generator=g, device="cuda") < 0.1] = float("inf")
    got, want = kmp.minplus(a, b), kmp.minplus_ref(a, b)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"minplus: kernel and plain version differ at "
             f"{int((got != want).sum())} of {got.numel()} entries")
    n_inf = int(torch.isinf(got).sum())
    nbytes = 3 * n * n * 4
    cases = _copies(lambda: (a.clone(), b.clone()), 2 * n * n * 4)
    ms = device_ms([lambda c=c: kmp.minplus(*c) for c in cases])
    plain_ms = device_ms([lambda c=c: kmp.minplus_ref(*c) for c in cases], replays=2)
    del cases
    bound_ms, by, bytes_ms, ops_ms = _bound(nbytes, 2 * n ** 3, MINPLUS_OPS_S)
    rec[("minplus", torch.float32)] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                           library_ms=None, bound_ms=bound_ms, bound_by=by)
    print(f"[kernels] minplus f32 {n}^3: kernel == plain exactly ({n_inf} +inf outputs); "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library none (no single PyTorch "
          f"call computes (min, +)); bound {bound_ms:.3f} ms = max({n}^3 = "
          f"{n ** 3 / 1e9:.1f} G triples x 2 instructions (add, min) / 33.5 T/s "
          f"(67 TFLOP/s counts an FMA as 2) = {ops_ms:.3f} ms, {nbytes / 1e6:.0f} MB / "
          f"3.35 TB/s = {bytes_ms:.3f} ms), by {by}", flush=True)
    print(f"[kernels] tile kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    return rec


# ---------------------------------------------------------------------------
# the distributed path: rank processes on cuda:0
N_RANKS_MM, N_MM, N_FW, N_FW_FAITHFUL = 8, 8192, 8192, 2048
# normwise relative bound between two f32 products of n-term dot products:
# each is within about sqrt(n) * 2^-24 of the exact product, so they are
# within twice that of each other: 2 * sqrt(8192) * 2^-24 = 1.08e-5
MM_REL_BOUND = 2 * N_MM ** 0.5 * 2.0 ** -24
# the same for f16 inputs (products exact in f32) summed by the tensor cores,
# whose f32 adds truncate (a unit roundoff of 2^-23, twice round-to-nearest's),
# against torch.matmul of the widened values: sqrt(n) * (2^-23 + 2^-24)
MM_F16_REL_BOUND = _tc_rel_bound(N_MM)


def _mm_runs(C):
    """(name, entry point, mesh shape, axes, body, specs, kernel, launches,
    input dtype)."""
    from repro_torch.core import summa as S, summa_pipelined as SP
    D = importlib.import_module("repro_torch.core.dns_matmul")   # the name is also a function
    from repro_torch.core.mesh import P
    from repro_torch.kernels import ops
    xy, xyz = P("x", "y"), ("x", "y", "z")
    return [
        ("dns_matmul_kernel", C.dns_matmul_kernel, (2, 2, 2), xyz,
         lambda a, b: D.dns_body(a, b, local_matmul=ops.matmul), D.DNS_SPECS[0],
         "matmul_f32_ffma", 8, torch.float32),
        ("dns_matmul_kernel f16", C.dns_matmul_kernel, (2, 2, 2), xyz,
         lambda a, b: D.dns_body(a, b, local_matmul=ops.matmul), D.DNS_SPECS[0],
         "matmul_f16_wgmma", 8, torch.float16),
        ("summa_matmul_kernel", C.summa_matmul_kernel, (2, 4), ("x", "y"),
         lambda a, b: S.summa_body(a, b, mm_acc=ops.matmul_acc), (xy, xy),
         "matmul_acc_f32_ffma", 32, torch.float32),
        ("summa_matmul_kernel f16", C.summa_matmul_kernel, (2, 4), ("x", "y"),
         lambda a, b: S.summa_body(a, b, mm_acc=ops.matmul_acc), (xy, xy),
         "matmul_acc_f16_wgmma", 32, torch.float16),
        ("cannon_matmul_kernel", C.cannon_matmul_kernel, (2, 4), ("x", "y"),
         lambda a, b: S.cannon_body(a, b, mm_acc=ops.matmul_acc), (xy, xy),
         "matmul_acc_f32_ffma", 32, torch.float32),
        ("summa_matmul_pipelined_kernel", C.summa_matmul_pipelined_kernel, (1, 8), ("x", "y"),
         lambda a, b: SP.summa_pipelined_body(a, b, mm_acc=ops.matmul_acc), (xy, xy),
         "matmul_acc_f32_ffma", 64, torch.float32),
        ("cannon_matmul_25d_kernel", C.cannon_matmul_25d_kernel, (2, 2, 2), xyz,
         lambda a, b: SP.cannon_25d_body(a, b, mm_acc=ops.matmul_acc), (xy, xy),
         "matmul_acc_f32_ffma", 8, torch.float32),
    ]


def _cost_fns(n: int) -> dict:
    """Each rank run's ``*_cost`` as a function of (link, peak FLOP/s,
    bytes an element), at its mesh."""
    from repro_torch.core import costmodel as cm
    return {
        "dns_matmul_kernel": lambda lk, pk, b: cm.dns_matmul_cost(
            n, 2, bytes_per_elt=b, link=lk, peak_flops=pk),
        "summa_matmul_kernel": lambda lk, pk, b: cm.summa_matmul_cost(
            n, 2, 4, bytes_per_elt=b, link=lk, peak_flops=pk),
        "cannon_matmul_kernel": lambda lk, pk, b: cm.cannon_matmul_cost(
            n, 2, 4, bytes_per_elt=b, link=lk, peak_flops=pk),
        "summa_matmul_pipelined_kernel": lambda lk, pk, b: cm.summa_pipelined_cost(
            n, 1, 8, bytes_per_elt=b, link=lk, peak_flops=pk),
        "cannon_matmul_25d_kernel": lambda lk, pk, b: cm.cannon_25d_cost(
            n, 2, 2, bytes_per_elt=b, link=lk, peak_flops=pk),
    }


def _staging_fit(res, runs) -> None:
    """Fit the host staging of ``core/mesh.py`` as one ``LinkClass``: the
    (t_s, t_w) under which the f32 runs' ``*_cost`` predictions best match
    their body walls in least squares (``costmodel.fit_link``), each with
    its compute term at 1/p of the card's peak (p ranks time-slice one
    card); and, for comparison, the same walls against the bytes each rank
    staged.  Then every run's prediction with the fitted link beside its
    measured body wall."""
    from repro_torch.core import costmodel as cm
    fns = _cost_fns(N_MM)
    rows = []
    for name, _, shape, _, _, _, _, _, dtype in runs:
        fn = fns[name.split()[0]]
        bpe = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_OPS_S[dtype] / N_RANKS_MM
        per_rank = [r[name] for r in res]
        rows.append(dict(name=name, shape=shape, dtype=dtype,
                         total=lambda lk, fn=fn, pk=peak, b=bpe: fn(lk, pk, b)["total_s"],
                         comm=lambda lk, fn=fn, b=bpe: fn(lk, math.inf, b)["total_s"],
                         wall=max(r["body_s"] for r in per_rank),
                         staged=sum(r["staged"] for r in per_rank) / len(per_rank)))
    f32 = [r for r in rows if r["dtype"] == torch.float32]
    link = cm.fit_link([r["total"] for r in f32], [r["comm"] for r in f32],
                       [r["wall"] for r in f32])
    print(f"[fit] host staging fitted to the {len(f32)} f32 bodies: t_s = {link.t_s * 1e6:.1f} "
          f"us, t_w = {link.t_w * 1e9:.4f} ns/B ({1 / link.t_w / 1e9:.2f} GB/s) (the H100 "
          f"constants' NVLink: {cm.NVLINK.t_s * 1e6:.1f} us, {1 / cm.NVLINK.t_w / 1e9:.0f} GB/s)",
          flush=True)
    # the transport alone: each body's wall against the bytes it staged a
    # rank (as measured, not as the model counts them), one intercept a body
    free = cm.LinkClass(0.0, 0.0)
    direct = cm.LinkClass.fit([(1.0, r["staged"]) for r in f32],
                              [r["wall"] - r["total"](free) for r in f32])
    resid = [direct.t_s + direct.t_w * r["staged"] + r["total"](free) - r["wall"] for r in f32]
    print(f"[fit] the f32 bodies' walls less compute against the bytes each rank staged: "
          f"{direct.t_s * 1e3:.1f} ms a body + {1 / direct.t_w / 1e9:.2f} GB/s; residuals "
          + ", ".join(f"{r['name'].split()[0]} {e:+.3f} s" for r, e in zip(f32, resid)),
          flush=True)
    for r in rows:
        starts, nbytes = cm.link_terms(r["comm"])
        pred = r["total"](link)
        print(f"[fit] {r['name']} {'x'.join(map(str, r['shape']))}: predicted {pred:.3f} s "
              f"(compute {r['total'](cm.LinkClass(0.0, 0.0)) * 1e3:.1f} ms at 1/{N_RANKS_MM} "
              f"of the card's peak; {starts:.0f} start-ups and {nbytes / 2**20:.0f} MiB on "
              f"the critical path) vs body wall {r['wall']:.3f} s ({pred / r['wall']:.2f}x); "
              f"staged {r['staged'] / 2**20:.0f} MiB a rank", flush=True)
    return link


def _kernel_ms(km) -> float:
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for _, s, e in km.events)


def rank_matmul(device, n: int, seed: int) -> dict:
    """One rank of the matmul phase: every algorithm through its entry point
    (counted, checked), then its block-level body alone (timed)."""
    import torch.distributed as dist
    from repro_torch import core as C
    from repro_torch.core.mesh import local_block
    from repro_torch.kernels import matmul as km
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(seed)
    inputs = {torch.float32: (torch.randn((n, n), generator=g, device=device),
                              torch.randn((n, n), generator=g, device=device))}
    inputs[torch.float16] = tuple(x.half() for x in inputs[torch.float32])
    rank = dist.get_rank()
    wants = {dt: torch.matmul(A.float(), B.float()) if rank == 0 else None
             for dt, (A, B) in inputs.items()}
    A, B = inputs[torch.float32]
    want = wants[torch.float32]
    out = {}
    meshes = {}
    for name, entry, shape, axes, body, specs, kernel, _, dtype in _mm_runs(C):
        mesh = meshes.get(shape) or meshes.setdefault(shape, C.ProcessMesh(shape, axes))
        A, B = inputs[dtype]
        want = wants[dtype]
        # the main path, counted
        torch.cuda.synchronize()
        dist.barrier()
        km.launches = dict.fromkeys(km.launches, 0)
        t0 = time.perf_counter()
        got = entry(A, B, mesh)
        torch.cuda.synchronize()
        entry_s = time.perf_counter() - t0
        launches = dict(km.launches)
        rel = ((got - want).norm() / want.norm()).item() if rank == 0 else None
        finite = bool(torch.isfinite(got).all())
        del got
        # the block-level body alone, timed
        with mesh:
            a, b = local_block(A, specs[0], mesh), local_block(B, specs[1], mesh)
            torch.cuda.synchronize()
            dist.barrier()
            mesh.staged_bytes = 0
            km.events = []
            t0 = time.perf_counter()
            body(a, b)
            torch.cuda.synchronize()
            body_s = time.perf_counter() - t0
            kernel_ms = _kernel_ms(km)
            km.events = None
        out[name] = dict(entry_s=entry_s, body_s=body_s, kernel_ms=kernel_ms,
                         staged=mesh.staged_bytes, launches=launches, rel=rel,
                         finite=finite)
    A, B = inputs[torch.float32]
    want = wants[torch.float32]
    mesh8 = C.ProcessMesh((8,), ("z",))
    dist.barrier()
    mesh8.staged_bytes = 0
    t0 = time.perf_counter()
    got = C.generic_matmul(A, B, mesh8, axis="z")
    torch.cuda.synchronize()
    out["generic_matmul"] = dict(
        entry_s=time.perf_counter() - t0, body_s=None, kernel_ms=None,
        staged=mesh8.staged_bytes, launches={},
        rel=((got - want).norm() / want.norm()).item() if rank == 0 else None,
        finite=bool(torch.isfinite(got).all()))
    return out


def _fw_weights(n: int, seed: int, device):
    """Integer edge weights 1..99, an edge with probability 0.05 (+inf
    otherwise), zero diagonal: every path sum is an integer below 2^24, so
    any evaluation order gives the same f32 result."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randint(1, 100, (n, n), generator=g, device=device).float()
    w[torch.rand((n, n), generator=g, device=device) >= 0.05] = float("inf")
    w.fill_diagonal_(0.0)
    return w


def rank_fw(device, n: int, n_faithful: int, seed: int) -> dict:
    """One rank of the Floyd-Warshall phase on a 2x2 grid."""
    import torch.distributed as dist
    from repro_torch import core as C
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import minplus as kmp
    from repro_torch.kernels import ops
    mesh = C.ProcessMesh((2, 2), ("x", "y"))
    rank = dist.get_rank()
    D = _fw_weights(n, seed, device)
    out = {}
    torch.cuda.synchronize()
    dist.barrier()
    mesh.staged_bytes = 0
    kmp.launches = 0
    km.events = []
    t0 = time.perf_counter()
    got = C.blocked_floyd_warshall(D, mesh, minplus=ops.minplus)
    torch.cuda.synchronize()
    out["blocked_floyd_warshall"] = dict(entry_s=time.perf_counter() - t0,
                                         kernel_ms=_kernel_ms(km), staged=mesh.staged_bytes,
                                         launches={"minplus": kmp.launches})
    km.events = None
    t0 = time.perf_counter()
    plain = C.blocked_floyd_warshall(D, mesh)
    torch.cuda.synchronize()
    out["blocked_plain_s"] = time.perf_counter() - t0
    if rank == 0:
        ref = C.floyd_warshall_reference(D)
        out["blocked_equal_plain"] = bool(torch.equal(got, plain))
        out["blocked_equal_ref"] = bool(torch.equal(got, ref))
        out["n_inf"] = int(torch.isinf(ref).sum())
    del got, plain
    Df = _fw_weights(n_faithful, seed + 1, device)
    dist.barrier()
    mesh.staged_bytes = 0
    t0 = time.perf_counter()
    got = C.floyd_warshall(Df, mesh)
    torch.cuda.synchronize()
    out["floyd_warshall"] = dict(entry_s=time.perf_counter() - t0, kernel_ms=None,
                                 staged=mesh.staged_bytes, launches={})
    if rank == 0:
        out["faithful_equal_ref"] = bool(torch.equal(got, C.floyd_warshall_reference(Df)))
    return out


def _check_compute_mode() -> None:
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.split("\n")[0]
    if "exclusive" in mode.lower():
        fail(f"the card is in compute mode {mode.strip()}: the rank phases put several "
             f"processes on cuda:0, which that mode forbids")


def _print_algo(name, per_rank, extra=""):
    walls = [r["entry_s"] for r in per_rank]
    bodies = [r.get("body_s") for r in per_rank]
    kms = [r.get("kernel_ms") for r in per_rank]
    staged = sum(r["staged"] for r in per_rank)
    body = (f"; body alone {max(bodies):.3f} s" if bodies[0] is not None else "")
    kern = (f"; kernel device time {sum(kms):.1f} ms summed over ranks" if kms[0] is not None
            else "")
    print(f"[ranks] {name}: wall {max(walls):.3f} s (entry point, slicing and assembly "
          f"included){body}{kern}; staged through the host {staged / 2**20:.1f} MiB over "
          f"{len(per_rank)} ranks ({staged / len(per_rank) / 2**20:.1f} MiB a rank){extra}",
          flush=True)


def phase_distributed() -> tuple:
    """Returns the launch counts of the main-path runs, summed over ranks,
    and the host-staging link fitted to the f32 bodies."""
    from repro_torch import core as C
    from repro_torch.core.mesh import launch
    from repro_torch.kernels import matmul as km
    _check_compute_mode()
    counts = dict.fromkeys(list(km.launches) + ["minplus"], 0)
    t0 = time.perf_counter()
    res = launch(N_RANKS_MM, rank_matmul, N_MM, 3, device="cuda", timeout=900)
    for name, _, shape, _, _, _, kernel, want_launches, dtype in _mm_runs(C) + \
            [("generic_matmul", None, (8,), None, None, None, None, 0, torch.float32)]:
        per_rank = [r[name] for r in res]
        rel = per_rank[0]["rel"]
        bound = MM_F16_REL_BOUND if dtype == torch.float16 else MM_REL_BOUND
        got = {k: sum(r["launches"].get(k, 0) for r in per_rank) for k in km.launches}
        _print_algo(f"{name} {'x'.join(map(str, shape))}", per_rank,
                    f"; |C - torch.matmul| / |torch.matmul| = {rel:.3e} (bound "
                    f"{bound:.3e}); launches {got}")
        if not all(r["finite"] for r in per_rank) or not rel <= bound:
            fail(f"{name}: normwise relative error {rel:.3e} beyond {bound:.3e} "
                 f"(or a non-finite entry)")
        if kernel is not None:
            if got != {k: (want_launches if k == kernel else 0) for k in km.launches}:
                fail(f"{name}: launches {got}, want {kernel} x {want_launches} and no other")
            counts[kernel] += got[kernel]
    print(f"[ranks] matmul phase: {N_RANKS_MM} ranks, n = {N_MM}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    link = _staging_fit(res, _mm_runs(C))

    t0 = time.perf_counter()
    res = launch(4, rank_fw, N_FW, N_FW_FAITHFUL, 5, device="cuda", timeout=900)
    r0 = res[0]
    blocked = [r["blocked_floyd_warshall"] for r in res]
    n_mp = sum(r["launches"]["minplus"] for r in blocked)
    _print_algo(f"blocked_floyd_warshall(minplus=ops.minplus) 2x2, n = {N_FW}", blocked,
                f"; minplus launches {n_mp}; plain-version run {r0['blocked_plain_s']:.3f} s; "
                f"equal to the plain run: {r0['blocked_equal_plain']}, to the single-device "
                f"oracle: {r0['blocked_equal_ref']} ({r0['n_inf']} +inf)")
    if n_mp != 24:
        fail(f"blocked_floyd_warshall: minplus launches {n_mp}, want 4 ranks x 2 rounds x 3")
    if not (r0["blocked_equal_plain"] and r0["blocked_equal_ref"]):
        fail("blocked_floyd_warshall with the kernel differs from the plain-version run "
             "or from the single-device oracle")
    counts["minplus"] = n_mp
    _print_algo(f"floyd_warshall 2x2, n = {N_FW_FAITHFUL} ({2 * N_FW_FAITHFUL} staged "
                f"broadcasts)", [r["floyd_warshall"] for r in res],
                f"; equal to the single-device oracle: {r0['faithful_equal_ref']}")
    if not r0["faithful_equal_ref"]:
        fail("floyd_warshall differs from the single-device oracle")
    print(f"[ranks] Floyd-Warshall phase: 4 ranks: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return counts, link



# ---------------------------------------------------------------------------
# the trainer on a mesh: gloo rank processes sharing cuda:0
TP_STEPS = 3                 # phase_train's state, data and TrainConfig, stopped after 3
LAYOUT_DEPTH, LAYOUT_STEPS = 2, 2
# bf16 compute: the ranks round their partial products and sums in bf16 at
# other places than one process does (the tests' bf16 tolerance)
MESH_TOL = 2e-2
# the layouts run f32 compute and f32 gradients under deterministic
# algorithms, where the ranks and one process differ in summation order
# only.  Held to the tests' f32 tolerance: every step's loss and grad norm,
# and AdamW's first moment after the first step (0.1 x that step's
# gradient, from the same parameters) normwise over the whole tree, which
# bounds every leaf's error by 1e-4 of the whole.  Printed, not held: each
# leaf's own error, and the moments and parameters after the last step --
# AdamW's first step is nearly sign(g), so an entry whose gradient lies at
# the rounding noise moves by the rate either way, and the next gradients
# see it
LAYOUT_TOL = 1e-4
# the layouts phase in a fresh process: deterministic algorithms need
# CUBLAS_WORKSPACE_CONFIG before cuBLAS first initialises
LAYOUTS_CHILD = r"""
import json, sys, torch
torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from repro_torch.core.costmodel import LinkClass
chip_smoke.layouts_body(LinkClass(*json.loads(sys.argv[1])))
"""
MESH_LAYOUTS = {
    "tp all-reduce": dict(fsdp_params=False),
    "tp+fsdp zero": dict(fsdp_params=True, grad_reduce="reduce_scatter_zero"),
    "dp_over_model zero": dict(fsdp_params=False, dp_over_model=True,
                               grad_reduce="reduce_scatter_zero"),
    "dp_over_model+fsdp all-reduce": dict(fsdp_params=True, dp_over_model=True),
}


def _plan_label(pcfg, mesh_shape) -> str:
    from repro_torch.parallel.planner import ParallelPlan
    return ParallelPlan(mesh_shape=mesh_shape, fsdp_axes=("data",) if pcfg.fsdp_params else (),
                        tp=1 if pcfg.dp_over_model else mesh_shape[1],
                        dp_over_model=pcfg.dp_over_model, grad=pcfg.grad_reduce,
                        remat=pcfg.remat, opt_state_dtype=pcfg.opt_state_dtype).label()


def _planner_times(cfg, mesh_shape, link) -> dict:
    """label -> (predicted step s on H100 constants with NVLink between the
    cards, the same on the fitted host-staging link with the card's peak
    shared by the ranks)."""
    from repro_torch.core import costmodel as cm
    from repro_torch.parallel import planner
    n = math.prod(mesh_shape)
    nv = planner.plan_search(cfg, mesh_shape, TRAIN_BATCH, TRAIN_SEQ, "train")
    st = planner.plan_search(cfg, mesh_shape, TRAIN_BATCH, TRAIN_SEQ, "train", link=link,
                             peak_flops=cm.PEAK_FLOPS_BF16 / n, hbm_bw=cm.HBM_BW / n)
    st = {r.plan.label(): r for r in st}
    return {r.plan.label(): (r, st[r.plan.label()]) for r in nv}


def _print_prediction(tag, times, label) -> None:
    if label not in times:
        print(f"[{tag}] planner: {label} is not in the lattice (with FSDP storage it scores "
              f"the reduction as a reduce-scatter only)", flush=True)
        return
    nv, st = times[label]
    print(f"[{tag}] planner ({label}), predictions on H100 constants: "
          f"{nv.total_s * 1e3:.1f} ms a step with NVLink between cards (compute "
          f"{nv.cost['compute_s'] * 1e3:.1f}, TP combines {nv.cost['tp_comm_s'] * 1e3:.1f}, "
          f"gathers {nv.cost['gather_s'] * 1e3:.1f}, grads {nv.cost['grad_s'] * 1e3:.1f}, "
          f"update {nv.cost['update_s'] * 1e3:.1f}); on the host-staging link fitted in the "
          f"ranks phase, the ranks sharing one card's peak and HBM: {st.total_s * 1e3:.1f} ms "
          f"(TP combines {st.cost['tp_comm_s'] * 1e3:.1f}, gathers "
          f"{st.cost['gather_s'] * 1e3:.1f}, grads {st.cost['grad_s'] * 1e3:.1f})", flush=True)


def _print_ranks(tag, walls, peaks, staged, comm) -> None:
    """Step walls (the slowest rank's), tokens/s over steps 2.., every
    rank's peak memory, and by rank and step the bytes staged through the
    host and the host seconds inside the collectives (``comm_seconds``)."""
    window = walls[1:]
    toks = TRAIN_BATCH * TRAIN_SEQ
    by_rank = lambda rows, f: "; ".join(f"rank {r}: " + ", ".join(f(v) for v in row)
                                        for r, row in enumerate(rows))
    print(f"[{tag}] step walls {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; over steps "
          f"2-{len(walls)} (sum of walls / {len(window)}): {np.sum(window) / len(window) * 1e3:.1f} "
          f"ms, {toks * len(window) / float(np.sum(window)):.0f} tokens/s; peak memory "
          f"(max_memory_allocated) by rank: {', '.join(f'{p / 1e9:.2f}' for p in peaks)} GB; "
          f"staged through the host a step: {by_rank(staged, lambda b: f'{b / 1e9:.3f}')} GB; "
          f"inside the collectives a step: {by_rank(comm, lambda c: f'{c * 1e3:.0f}')} ms",
          flush=True)


def rank_train_tp(device, job, sp_job, tokens: np.ndarray) -> dict:
    """One of the 2 ranks of "train tp" and "train tp sp", on one launch:
    ``job``'s steps, then ``rank_train_sp``'s."""
    from repro_torch.launch import train
    return {"tp": train.train_rank(device, job), "sp": rank_train_sp(device, sp_job, tokens)}


def phase_train_tp(cfg, ref_losses, link, dev: str = "cuda"):
    """Full-width, full-depth Llama-3.2-3B on 2 ranks sharing the card,
    mesh (1, 2), tensor parallelism 2, through the launcher's per-rank body
    (``launch.train.train_rank``) with ``phase_train``'s state, data and
    TrainConfig, stopped after 3 steps: losses finite and within MESH_TOL
    of ``phase_train``'s first three.  The same launch then runs "train tp
    sp" (``rank_train_sp``; ``phase_train_tp_sp`` checks it).  Returns
    (this phase's figures, the ranks' "train tp sp" results, its tokens)."""
    from repro_torch.core.mesh import launch
    from repro_torch.launch import train
    pcfg, tcfg, shape = _train_setup(cfg)
    tokens = np.random.RandomState(11).randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ))
    _sync(dev)
    if torch.device(dev).type == "cuda":
        print(f"[train tp] this process before the launch: "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
              f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved", flush=True)
    with tempfile.TemporaryDirectory() as tmp, tempfile.TemporaryDirectory() as tmp_sp:
        job = train.RankJob(cfg, pcfg, dataclasses.replace(tcfg, checkpoint_dir=tmp), shape,
                            TP_STEPS, model_parallel=2, return_state=False)
        sp_job = dataclasses.replace(job, pcfg=dataclasses.replace(pcfg, sequence_parallel=True),
                                     tcfg=dataclasses.replace(tcfg, checkpoint_dir=tmp_sp))
        t0 = time.perf_counter()
        both = launch(2, rank_train_tp, job, sp_job, tokens, device=dev, timeout=1500)
        wall = time.perf_counter() - t0
    res = [r["tp"] for r in both]
    hist = res[0]["history"]
    losses = [h["loss"] for h in hist]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"[train tp] {cfg.name}, {cfg.n_layers} layers, mesh (1, 2), TP 2, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, remat={pcfg.remat}: losses "
          + ", ".join(f"{a:.4f} (one process {b:.4f}, relative {e:.1e})"
                      for a, b, e in zip(losses, ref_losses, rel))
          + f", bound {MESH_TOL}; launch {wall:.1f} s (process start, init and \"train tp sp\" "
          f"included)", flush=True)
    _print_ranks("train tp", [max(r["history"][i]["time_s"] for r in res)
                              for i in range(len(hist))], [r["peak_bytes"] for r in res],
                 [[h["staged_bytes"] for h in r["history"]] for r in res],
                 [[h["comm_s"] for h in r["history"]] for r in res])
    _print_prediction("train tp", _planner_times(cfg, (1, 2), link), _plan_label(pcfg, (1, 2)))
    if len(losses) != TP_STEPS or not all(np.isfinite(losses)) or not max(rel) <= MESH_TOL:
        fail(f"train tp: losses {losses} against one process's {ref_losses[:TP_STEPS]}")
    return _rank_figures(res), [r["sp"] for r in both], tokens


def _rank_figures(res: list) -> dict:
    """Per rank, over the steps after the first: bytes staged a step, the
    share of the step wall inside the collectives; and the peak memory."""
    out = {}
    for key, f in (("staged", lambda h: h["staged_bytes"]),
                   ("comm_share", lambda h: h["comm_s"] / h["time_s"])):
        out[key] = [float(np.mean([f(h) for h in r["history"][1:]])) for r in res]
    out["peak"] = [r["peak_bytes"] or 0 for r in res]
    out["staged_steps"] = [[h["staged_bytes"] for h in r["history"]] for r in res]
    return out


def rank_train_layouts(device, cfg, layouts, tcfg, shape, ref_path) -> dict:
    """One rank of the layouts phase: each layout's steps from the seed-0
    state on the mesh (2, 2); per step the loss, grad norm, wall and bytes
    staged, then each parameter and first-moment block's squared distance
    to the one-process run's (and the squared norm of that), divided by the
    number of ranks that hold the same block, so the ranks' sums are the
    leaves' global values."""
    import torch.distributed as dist
    from repro_torch.core.mesh import local_block
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import steps as S
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.tree import leaves
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_local_mesh(2)
    ref = torch.load(ref_path, mmap=True)
    out = {}
    for name, pcfg in layouts.items():
        ctx = make_ctx(mesh, pcfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = S.init_train_state(torch.Generator(device=device).manual_seed(tcfg.seed), cfg,
                                   pcfg, ctx)
        step = S.make_train_step(cfg, pcfg, tcfg, ctx)
        batches = make_batch_iterator(cfg, shape, seed=tcfg.seed, device=device,
                                      shard=(mesh.index(ctx.batch_axes),
                                             mesh.size(ctx.batch_axes)))
        hist, m1 = [], None
        for _ in range(LAYOUT_STEPS):
            batch = next(batches)
            torch.cuda.synchronize()
            dist.barrier()
            staged, comm, t0 = mesh.staged_bytes, mesh.comm_seconds, time.perf_counter()
            state, m = step(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            hist.append(dict(loss=loss, grad_norm=float(m["grad_norm"]),
                             wall=time.perf_counter() - t0, staged=mesh.staged_bytes - staged,
                             comm=mesh.comm_seconds - comm))
            if m1 is None:
                m1 = [t.clone() for t in leaves(state["opt"]["m"])]
        batches.close()
        specs = S.train_state_shardings(cfg, pcfg, ctx, S.abstract_train_state(cfg, pcfg))
        errs = {}
        for key, got, spec in (("params", leaves(state["params"]), specs["params"]),
                               ("m", leaves(state["opt"]["m"]), specs["opt"]["m"]),
                               ("m1", m1, specs["opt"]["m"])):
            errs[key] = []
            for p, sp, r in zip(got, leaves(spec), ref[key]):
                want = local_block(r, sp, mesh).to(device)
                named = [a for part in sp if part is not None
                         for a in (part if isinstance(part, tuple) else (part,))]
                copies = mesh.size(mesh.axis_names) // mesh.size(
                    tuple(a for a in mesh.axis_names if a in named))
                errs[key].append((float(((p.float() - want) ** 2).sum()) / copies,
                                  float((want ** 2).sum()) / copies))
        out[name] = dict(hist=hist, errs=errs, peak=torch.cuda.max_memory_allocated())
        del state, step, batch, m
    return out


def phase_train_layouts(link) -> None:
    """``layouts_body`` in a fresh process under deterministic algorithms
    (its lines relayed; it fails the run by its exit code)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUBLAS_WORKSPACE_CONFIG=":4096:8")
    r = subprocess.run([sys.executable, "-c", LAYOUTS_CHILD, json.dumps([link.t_s, link.t_w])],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=1500)
    for ln in r.stdout.splitlines():
        print(ln, flush=True)
    if r.returncode != 0:
        fail(f"train layouts: exit {r.returncode}\n{r.stderr[-3000:]}")


def layouts_body(link) -> None:
    """Full width, depth cut to LAYOUT_DEPTH layers, on 4 ranks (mesh 2 x 2):
    TP with all-reduce, TP + FSDP with ZeRO, dp_over_model with ZeRO,
    dp_over_model + FSDP with all-reduce, and the layout ``plan_search``
    picks for the mesh, LAYOUT_STEPS steps each from the seed-0 state in
    f32 compute and gradients, each held against one process's steps on
    the card (losses, grad norms, the first moments after the first step
    over the whole tree, LAYOUT_TOL).  Runs in a process, and ranks, under
    deterministic algorithms."""
    from repro_torch import configs
    from repro_torch.core.mesh import launch
    from repro_torch.data import make_batch_iterator
    from repro_torch.parallel import planner
    from repro_torch.parallel import steps as S
    from repro_torch.tree import leaves, leaves_with_path
    cfg = configs.get(ARCH).replace(n_layers=LAYOUT_DEPTH, dtype="float32")
    pcfg, tcfg, shape = _train_setup(cfg)
    pcfg = dataclasses.replace(pcfg, grad_dtype="float32")
    ranked = planner.plan_search(cfg, (2, 2), TRAIN_BATCH, TRAIN_SEQ, "train")
    pick = planner.best_plan(ranked)
    print(f"[train layouts] {cfg.name} at full width, {LAYOUT_DEPTH} of 28 layers, f32 compute, "
          f"deterministic algorithms, mesh (2, 2); "
          f"plan_search on H100 constants (predictions) picks {pick.label()}; the head of its "
          f"ranking:", flush=True)
    for ln in planner.format_plan_table(ranked, top=6).splitlines():
        print(f"[train layouts]   {ln}", flush=True)
    layouts = {k: dataclasses.replace(pcfg, **kw) for k, kw in MESH_LAYOUTS.items()}
    layouts["plan_search pick"] = dataclasses.replace(pick.to_pcfg(), grad_dtype="float32")
    # the one-process reference on the card
    state = S.init_train_state(torch.Generator(device="cuda").manual_seed(tcfg.seed), cfg, pcfg)
    step = S.make_train_step(cfg, pcfg, tcfg)
    batches = make_batch_iterator(cfg, shape, seed=tcfg.seed, device="cuda")
    ref, m1 = [], None
    for _ in range(LAYOUT_STEPS):
        state, m = step(state, next(batches))
        ref.append((float(m["loss"]), float(m["grad_norm"])))
        if m1 is None:
            m1 = [t.detach().to("cpu", copy=True) for t in leaves(state["opt"]["m"])]
    batches.close()
    times = _planner_times(cfg, (2, 2), link)
    paths = ["/".join(map(str, p)) for p, _ in leaves_with_path(state["params"])]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.pt")
        torch.save({"m1": m1, **{k: [t.detach().cpu() for t in leaves(tree)] for k, tree in
                                 (("params", state["params"]), ("m", state["opt"]["m"]))}},
                   path)
        del state, step, m
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = launch(4, rank_train_layouts, cfg, layouts, tcfg, shape, path, device="cuda",
                     timeout=1500)
        wall = time.perf_counter() - t0
    print(f"[train layouts] one process: losses {', '.join(f'{a:.4f}' for a, _ in ref)}, grad "
          f"norms {', '.join(f'{b:.3f}' for _, b in ref)}; launch of the 4 ranks for all "
          f"{len(layouts)} layouts {wall:.1f} s", flush=True)
    bad = []
    for name, pc in layouts.items():
        per = [r[name] for r in res]
        hist = per[0]["hist"]
        lrel = max(abs(h["loss"] - a) / abs(a) for h, (a, _) in zip(hist, ref))
        grel = max(abs(h["grad_norm"] - b) / abs(b) for h, (_, b) in zip(hist, ref))
        def errors(key):
            """(whole tree normwise, worst leaf's own normwise, its path)."""
            d = [sum(r["errs"][key][i][0] for r in per) for i in range(len(paths))]
            n = [sum(r["errs"][key][i][1] for r in per) for i in range(len(paths))]
            e = [(a / b) ** 0.5 for a, b in zip(d, n)]
            return (sum(d) / sum(n)) ** 0.5, max(e), paths[int(np.argmax(e))]

        (m1tree, m1leaf_err, m1leaf), (mtree, mleaf_err, mleaf), (_, perr, pleaf) = (
            errors("m1"), errors("m"), errors("params"))
        got = ", ".join(f"{h['loss']:.4f}" for h in hist)
        print(f"[train layouts] {name} ({_plan_label(pc, (2, 2))}): losses {got}, worst "
              f"relative to one process: "
              f"loss {lrel:.1e}, grad norm {grel:.1e}, first moments after step 1 normwise "
              f"over the tree {m1tree:.1e} (bound {LAYOUT_TOL}); not held: the worst leaf "
              f"there {m1leaf_err:.1e} ({m1leaf}); after step {LAYOUT_STEPS} the moments "
              f"{mtree:.1e} over the tree, {mleaf_err:.1e} the worst leaf ({mleaf}), the "
              f"parameters {perr:.1e} the worst leaf ({pleaf})", flush=True)
        _print_ranks(f"train layouts] [{name}", [max(r["hist"][i]["wall"] for r in per)
                                                 for i in range(LAYOUT_STEPS)],
                     [r["peak"] for r in per], [[h["staged"] for h in r["hist"]] for r in per],
                     [[h["comm"] for h in r["hist"]] for r in per])
        _print_prediction(f"train layouts] [{name}", times, _plan_label(pc, (2, 2)))
        if not (max(lrel, grel, m1tree) <= LAYOUT_TOL and
                all(np.isfinite(h["loss"]) for h in hist)):
            bad.append(name)
    if bad:
        fail(f"train layouts: {bad} differ from one process's steps beyond {LAYOUT_TOL}")


# ---------------------------------------------------------------------------
# the other model families: served at their published widths, trained at
# reduced size, and the MoE layer's mesh layouts on gloo ranks
MOE_ALIGNED_ARCH, MOE_ALIGNED_DEPTH = "mixtral-8x22b", 4    # 56 layers would be 282 GB
MOE_PAGED_ARCH, MOE_PAGED_DEPTH = "kimi-k2-1t-a32b", 1      # 61 layers would be 2.1 TB
KIMI_REQ, KIMI_PROMPT, KIMI_GEN = 4, 256, 32
# arch -> (tag, depth, attention layers): one of Zamba2's two 19-layer
# periods (both ``mamba2_attn`` layers, whose decode reads the rows through
# the paged-attention kernel), three of xLSTM's six 8-layer periods (sLSTM
# included; no attention); the full depths took 97-133 s of the script's 1200
RECURRENT_ARCHS = {"zamba2-1.2b": ("hybrid", 19, 2), "xlstm-1.3b": ("xlstm", 24, 0)}
REC_REQ, REC_PROMPT, REC_GEN, REC_SLOTS = 4, 128, 32, 2
WHISPER_PROMPT, WHISPER_GEN, WHISPER_FRAMES = 4, 32, 1500
FAMILY_ARCHS = ("mixtral-8x22b", "kimi-k2-1t-a32b", "zamba2-1.2b", "xlstm-1.3b",
                "whisper-base")
# the families' decode paths against ``forward`` in f32 arithmetic on the
# served bf16 weights (every product widened): the router then decides on
# f32 logits in both paths, as arithmetic should decide it; the paths differ
# in summation order only
ORACLE_F32_REL_RMS = 1e-3
MOE_RANKS, MOE_MESH_MODEL, MOE_TOKENS = 8, 4, (4, 256)        # mesh (2, 4), B x S
MOE_RANK_TOL = dict(rtol=2e-2, atol=2e-3)                    # tests/progs/moe_ep_prog.py


def _family_init(cfg, full_layers: int):
    """bf16 matrices from a seeded generator on the card, as the serve CLI
    draws them (f32 draws rounded once; the f32 leaves stay f32)."""
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = (E.init if cfg.enc_dec else T.init)(cfg, gen, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    ls = leaves(params)
    print(f"[init] {cfg.name}: {cfg.n_layers} of {full_layers} layers, "
          f"{sum(t.numel() for t in ls) / 1e9:.3f} B parameters, "
          f"{sum(t.numel() * t.element_size() for t in ls) / 1e9:.2f} GB, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return params


def _family_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    return {"flash_wgmma": fa.launches_wgmma, "flash_simt": fa.launches,
            "paged": pa.launches}


def _zero_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import paged_attention as pa
    fa.launches = fa.launches_wgmma = pa.launches = gm.launches = 0


def _check_grouped(tag: str, cfg, calls: int) -> int:
    """The grouped expert kernels' launches since ``_zero_counts``: 2 a MoE
    layer (gate+up, down) and a model call, the loop never on the card."""
    from repro_torch.kernels import grouped_matmul as gm
    pattern = cfg.block_pattern
    moe_layers = sum(pattern[i % len(pattern)].endswith("moe") for i in range(cfg.n_layers))
    want = 2 * moe_layers * calls
    print(f"[{tag}] grouped expert kernel launches {gm.launches} (want {want}: 2 a MoE layer "
          f"and a model call, {calls} calls)", flush=True)
    if gm.launches != want:
        fail(f"{tag}: {gm.launches} grouped expert kernel launches, want {want}")
    return gm.launches


def _serve_family(tag: str, cfg, params, reqs, warm_prompt: int, **kw):
    """A warmup run, then ``reqs`` through the scheduler with the kernels'
    counts set to 0 just before and read just after; an engine that
    replays its decode from a graph must serve the tokens that an eager
    engine, run before the counts are set to 0, serves.  Returns (the run's
    output, the launch counts)."""
    from repro_torch.launch.scheduler import Scheduler, decode_graphed, make_requests
    sched = Scheduler(cfg, params, **kw)
    sched.run(make_requests(2, warm_prompt, 2, cfg.vocab))
    sched.reset()
    graphed = decode_graphed(torch.device("cuda"), kw.get("paged", False), None)
    eager = _eager_tokens(cfg, params, reqs, **kw) if graphed else None
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    out = sched.run(reqs)
    counts = _family_counts()
    comps = out["completions"]
    gen = reqs[0].gen
    if sorted(comps) != [r.rid for r in reqs] or any(
            len(c.tokens) != gen or not all(0 <= t < cfg.vocab for t in c.tokens)
            for c in comps.values()):
        fail(f"{tag}: served {sorted(comps)}; every request needs {gen} tokens in the vocab")
    ttft = sorted(c.ttft_s for c in comps.values())
    print(f"[{tag}] {cfg.name} bf16, {cfg.n_layers} layers, {len(reqs)} req x "
          f"({len(reqs[0].prompt)} prompt + {gen} gen), {kw}: {out['generated']} tokens in "
          f"{out['wall_s']:.3f} s = {out['tok_s']:.1f} tok/s; TTFT p50 "
          f"{ttft[len(ttft) // 2] * 1e3:.1f} ms; {out['ticks']} ticks, {out['decode_steps']} "
          f"decode steps ({out['decode_replays']} replays), {out['prefills']} prefills; "
          f"launches {counts}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    if graphed:
        _same_as_eager(tag, comps, eager)
    return out, counts


def _route_flips(fwd: list, path: list, n_layers: int) -> int:
    """(token, layer) pairs whose top-k sets differ between ``forward``'s
    routing and the decode path's (``moe.routes`` of each: one (T, k) entry
    a layer and a call, layer-major within a call)."""
    flips = 0
    for layer in range(n_layers):
        a = torch.sort(fwd[layer], dim=-1).values
        b = torch.sort(torch.cat(path[layer::n_layers]), dim=-1).values
        if a.shape != b.shape:
            fail(f"routing probe: forward routed {tuple(a.shape)}, the decode path "
                 f"{tuple(b.shape)} in layer {layer}")
        flips += int((a != b).any(dim=-1).sum())
    return flips


def _oracle_f32(tag: str, cfg, params, prompt, comp, run_path) -> None:
    """One served request teacher-forced through the served path
    (``run_path(cfg32, seq)`` -> logits (GEN, V) from the last prompt
    token on) and through ``forward``, both in f32 arithmetic on the served
    bf16 weights; every step's logits held to ORACLE_F32_REL_RMS, and the
    routing flips between the two counted (MoE)."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    cfg32 = cfg.replace(dtype="float32")
    lp = len(prompt)
    toks = np.concatenate([np.asarray(prompt), np.asarray(comp.tokens[:-1], np.int32)])
    seq = torch.from_numpy(toks.astype(np.int64)).cuda()[None]
    M.routes = [] if cfg.moe else None
    try:
        with torch.no_grad():
            ref = T.forward(params, seq, cfg32)[0, lp - 1:]
        fwd_routes, M.routes = M.routes, ([] if cfg.moe else None)
        got = run_path(cfg32, seq)
        path_routes = M.routes
    finally:
        M.routes = None
    if not torch.isfinite(got).all():
        fail(f"{tag}: decode-path logits are not finite")
    diff = got - ref
    rel = (diff.norm(dim=-1) / ref.norm(dim=-1)).max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    flips = _route_flips(fwd_routes, path_routes, cfg.n_layers) if cfg.moe else 0
    print(f"[{tag}] request {comp.rid}: the served path vs forward over {len(toks)} tokens "
          f"in f32 arithmetic on the bf16 weights: max per-row relative RMS {rel:.3e} (bound "
          f"{ORACLE_F32_REL_RMS:g}), max |diff| {diff.abs().max().item():.3e} of max |logit| "
          f"{ref.abs().max().item():.3e}, argmax agreement {agree:.3f}"
          + (f"; (token, layer) top-{cfg.moe.top_k} sets that differ: {flips} of "
             f"{len(toks) * cfg.n_layers}" if cfg.moe else ""), flush=True)
    if rel > ORACLE_F32_REL_RMS:
        fail(f"{tag}: decode-path logits differ from forward: relative RMS {rel:.3e}")


def _aligned_path(params, prompt_len: int, gen: int):
    """Fused prefill of the prompt and end-aligned decode steps, f32 cache."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import steps as S

    def run(cfg32, seq):
        cache = T.init_cache(cfg32, 1, prompt_len + gen, device="cuda", dtype=torch.float32)
        prefill, decode = S.make_prefill_step(cfg32), S.make_decode_step(cfg32,
                                                                          return_logits=True)
        logits, cache = prefill(params, {"tokens": seq[:, :prompt_len].to(torch.int32),
                                         "length": torch.tensor([prompt_len], device="cuda")},
                                cache)
        got = [logits[0]]
        for i in range(gen - 1):
            pos = prompt_len + i
            logits, cache = decode(params, seq[0, pos:pos + 1].to(torch.int32), cache,
                                   torch.tensor([pos], dtype=torch.int32, device="cuda"))
            got.append(logits[0])
        return torch.stack(got)
    return run


def _paged_path(params, prompt_len: int, gen: int):
    """Chunked prefill and paged decode steps over f32 arenas."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import steps as S
    from repro_torch.serving import BlockPool

    def run(cfg32, seq):
        n_pages = -(-(prompt_len + gen) // BLOCK)
        pool = BlockPool(n_pages, BLOCK)
        pool.admit(0, prompt_len + gen)
        cache = T.init_paged_cache(cfg32, n_pages, BLOCK, device="cuda", dtype=torch.float32)
        prefill = S.make_chunk_prefill_step(cfg32)
        decode = S.make_decode_step(cfg32, return_logits=True, paged=True)
        for lo in range(0, prompt_len, CHUNK):
            ln = min(CHUNK, prompt_len - lo)
            pool.ensure(0, lo + ln)
            chunk = torch.zeros((1, CHUNK), dtype=torch.int32, device="cuda")
            chunk[0, :ln] = seq[0, lo:lo + ln]
            table = torch.from_numpy(pool.table(0, n_pages)[None]).cuda()
            logits, cache = prefill(params, chunk, cache, lo, table, ln)
        got = [logits[0]]
        for i in range(gen - 1):
            pos = prompt_len + i
            pool.ensure(0, pos + 1)
            table = torch.from_numpy(pool.table(0, n_pages)[None]).cuda()
            logits, cache = decode(params, seq[0, pos:pos + 1].to(torch.int32), cache,
                                   torch.tensor([pos], dtype=torch.int32, device="cuda"), table)
            got.append(logits[0])
        return torch.stack(got)
    return run


def _recurrent_path(params, prompt_len: int, gen: int):
    """The scheduler's fallback: every token through a B=1 decode step, f32
    state and cache."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import steps as S

    def run(cfg32, seq):
        cache = T.init_cache(cfg32, 1, prompt_len + gen, device="cuda", dtype=torch.float32)
        decode = S.make_decode_step(cfg32, return_logits=True)
        got = []
        for pos in range(prompt_len + gen - 1):
            logits, cache = decode(params, seq[0, pos:pos + 1].to(torch.int32), cache, pos)
            if pos >= prompt_len - 1:
                got.append(logits[0])
        return torch.stack(got)
    return run


def _check_kernel(tag: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> None:
    err = (got.float() - want.float()).abs().max().item()
    print(f"[{tag}] max |kernel - plain| {err:.3e} (bound {tol:g})", flush=True)
    if not err <= tol:
        fail(f"{tag}: the kernel differs from its plain version by {err:.3e}")


def phase_serve_moe_aligned() -> int:
    """Mixtral-8x22B (depth 4) end-aligned: every non-empty admission one
    fused prefill through the tensor-core flash kernel in each layer (48/8
    heads, hd 128, window 4096), the llama phases' request mix."""
    from repro_torch import configs
    from repro_torch.launch.scheduler import make_requests
    full = configs.get(MOE_ALIGNED_ARCH)
    cfg = full.replace(n_layers=MOE_ALIGNED_DEPTH)
    params = _family_init(cfg, full.n_layers)
    reqs = make_requests(N_REQ, PROMPT, GEN, cfg.vocab, stagger=STAGGER)
    out, counts = _serve_family("serve moe aligned", cfg, params, reqs, 16, slots=SLOTS,
                                max_len=PROMPT + GEN, bucket=BUCKET)
    admissions = sum(1 for r in reqs if len(r.prompt) > 0)
    calls = _decode_calls("serve moe aligned", out)
    want = {"flash_wgmma": admissions * cfg.n_layers, "flash_simt": 0,
            "paged": calls * cfg.n_layers}
    if counts != want or out["prefills"] != admissions or not want["paged"]:
        fail(f"serve moe aligned: launches {counts}, prefills {out['prefills']}; want {want} "
             f"({admissions} non-empty admissions x {cfg.n_layers} layers, decode calls x "
             f"{cfg.n_layers} layers)")
    _check_grouped("serve moe aligned", cfg, calls + out["prefills"])
    comp = out["completions"][0]
    _oracle_f32("oracle moe aligned", cfg, params, reqs[0].prompt, comp,
                _aligned_path(params, PROMPT, GEN))
    del params
    return counts["flash_wgmma"]


MELLUM2_CONFIG, MELLUM2_MAX_LEN = "mellum2-12b-a2.5b", 7168   # the code cell's max_len
MELLUM2_PROMPTS, MELLUM2_REQ = (1500, 600), 4                  # requests of each length


def phase_serve_mellum2_aligned() -> int:
    """Mellum2-12B-A2.5B whole through the end-aligned engine: window rings
    of 1024 beside rows of ``max_len``, prompts past the window and inside
    it; every admission one tensor-core flash launch a layer, every decode
    step one split-KV launch a layer."""
    import bench.harness
    import bench.spec
    from repro_torch.launch.scheduler import make_requests
    model = bench.spec.config(bench.spec.benchmark(ROOT), MELLUM2_CONFIG, ROOT)["model"]
    cfg = bench.harness.port_config(model)
    params = _family_init(cfg, cfg.n_layers)
    reqs = [dataclasses.replace(r, rid=r.rid + i * MELLUM2_REQ, arrival=r.arrival + i)
            for i, n in enumerate(MELLUM2_PROMPTS)
            for r in make_requests(MELLUM2_REQ, n, GEN, cfg.vocab, stagger=STAGGER, seed=7 + i)]
    out, counts = _serve_family("serve mellum2 aligned", cfg, params, reqs, 16, slots=SLOTS,
                                max_len=MELLUM2_MAX_LEN, bucket=BUCKET)
    calls = _decode_calls("serve mellum2 aligned", out)
    want = {"flash_wgmma": len(reqs) * cfg.n_layers, "flash_simt": 0,
            "paged": calls * cfg.n_layers}
    if counts != want or out["prefills"] != len(reqs) or not want["paged"]:
        fail(f"serve mellum2 aligned: launches {counts}, prefills {out['prefills']}; want "
             f"{want} ({len(reqs)} admissions x {cfg.n_layers} layers, decode calls x "
             f"{cfg.n_layers} layers)")
    grouped = _check_grouped("serve mellum2 aligned", cfg, calls + out["prefills"])
    del params
    return grouped


def phase_serve_moe_paged() -> int:
    """Kimi-K2 (depth 1: 384 experts top-8 and a shared expert, 64/8 heads)
    through the paged engine: the paged-attention kernel at rep 8, once a
    layer and a decode step."""
    from repro_torch import configs
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.scheduler import make_requests
    full = configs.get(MOE_PAGED_ARCH)
    cfg = full.replace(n_layers=MOE_PAGED_DEPTH)
    params = _family_init(cfg, full.n_layers)
    # the kernel at the served decode shape (rep 8) against its plain version
    hkv, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    pages = -(-(KIMI_PROMPT + KIMI_GEN) // BLOCK)
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn((KIMI_REQ, hkv, rep, cfg.hd), generator=g, device="cuda").to(torch.bfloat16)
    kv = [torch.randn((KIMI_REQ * pages, BLOCK, hkv, cfg.hd), generator=g, device="cuda")
          .to(torch.bfloat16) for _ in range(2)]
    tables = torch.from_numpy(np.random.RandomState(4).permutation(KIMI_REQ * pages)
                              .reshape(KIMI_REQ, pages).astype(np.int32)).cuda()
    lengths = torch.tensor([KIMI_PROMPT + 7 * i + 1 for i in range(KIMI_REQ)],
                           dtype=torch.int32, device="cuda")
    _check_kernel(f"serve moe paged: paged_attention bf16 at B {KIMI_REQ}, Hkv {hkv}, rep {rep}, "
                  f"hd {cfg.hd}, {pages} pages", pa.paged_attention(q, *kv, tables, lengths),
                  pa.paged_attention_ref(q, *kv, tables, lengths), KERNEL_TOL[torch.bfloat16])
    reqs = make_requests(KIMI_REQ, KIMI_PROMPT, KIMI_GEN, cfg.vocab, stagger=STAGGER)
    out, counts = _serve_family("serve moe paged", cfg, params, reqs, 16, slots=KIMI_REQ,
                                max_len=KIMI_PROMPT + KIMI_GEN, paged=True, block=BLOCK,
                                chunk=CHUNK)
    want = {"flash_wgmma": 0, "flash_simt": 0, "paged": out["decode_steps"] * cfg.n_layers}
    if counts != want:
        fail(f"serve moe paged: launches {counts}; want {want} (decode steps x layers)")
    _check_grouped("serve moe paged", cfg,
                   out["decode_steps"] + sum(-(-len(r.prompt) // CHUNK) for r in reqs))
    _oracle_f32("oracle moe paged", cfg, params, reqs[0].prompt, out["completions"][0],
                _paged_path(params, KIMI_PROMPT, KIMI_GEN))
    del params
    return counts["paged"]


def phase_serve_recurrent(arch: str) -> None:
    """Zamba2 / xLSTM at full width, depth ``RECURRENT_ARCHS``, through the
    end-aligned engine's per-token recurrent prefill (no kernel on this
    path: its B=1 steps' attention is ``_sdpa``, the engines are products
    and elementwise ops); the decode steps read Zamba2's shared-attention
    rows through the paged-attention kernel."""
    from repro_torch import configs
    from repro_torch.launch.scheduler import make_requests
    tag, depth, attn = RECURRENT_ARCHS[arch]
    full = configs.get(arch)
    cfg = full.replace(n_layers=depth)
    params = _family_init(cfg, full.n_layers)
    reqs = make_requests(REC_REQ, REC_PROMPT, REC_GEN, cfg.vocab, stagger=STAGGER)
    out, counts = _serve_family(f"serve {tag}", cfg, params, reqs, 8, slots=REC_SLOTS,
                                max_len=REC_PROMPT + REC_GEN)
    want = {"flash_wgmma": 0, "flash_simt": 0,
            "paged": _decode_calls(f"serve {tag}", out) * attn}
    if out["prefills"] != REC_REQ or counts != want or (attn and not want["paged"]):
        fail(f"serve {arch}: {out['prefills']} per-token prefills, launches {counts}; want "
             f"{REC_REQ} and {want}")
    _oracle_f32(f"oracle {tag}", cfg, params, reqs[0].prompt, out["completions"][0],
                _recurrent_path(params, REC_PROMPT, REC_GEN))
    del params


def phase_serve_encdec() -> int:
    """Whisper-base at full size: stub frames (1, 1500, 512) from the seed,
    ``make_prefill_step`` (the encoder and the decoder's fused prefill, each
    layer's self-attention through the tensor-core flash kernel at hd 64)
    and greedy ``make_decode_step``s; the logits against ``encdec.forward``
    over the same tokens.  No scheduler, as in JAX."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.scheduler import make_requests
    from repro_torch.models import encdec as E
    from repro_torch.parallel import steps as S
    cfg = configs.get("whisper-base")
    params = _family_init(cfg, cfg.n_layers)
    g = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn((1, WHISPER_FRAMES, cfg.d_model), generator=g, device="cuda")
    # the encoder's attention shape, kernel against plain
    q, k, v = (torch.randn((1, cfg.n_heads, WHISPER_FRAMES, cfg.hd), generator=g,
                           device="cuda").to(torch.bfloat16) for _ in range(3))
    _check_kernel(f"serve encdec: flash_attention bf16 non-causal, {cfg.n_heads} heads, "
                  f"L {WHISPER_FRAMES}, hd {cfg.hd}", fa.flash_attention(q, k, v, causal=False),
                  fa.flash_attention_ref(q, k, v, causal=False), KERNEL_TOL[torch.bfloat16])
    prompt = torch.from_numpy(np.asarray(make_requests(1, WHISPER_PROMPT, 1, cfg.vocab)[0]
                                         .prompt)).cuda()[None]
    prefill, decode = S.make_prefill_step(cfg), S.make_decode_step(cfg, return_logits=True)
    total = WHISPER_PROMPT + WHISPER_GEN

    def serve():
        cache = E.init_cache(cfg, 1, total, device="cuda")
        logits, cache, enc = prefill(params, {"tokens": prompt, "frames": frames}, cache)
        got, toks = [logits[0]], [int(torch.argmax(logits[0]))]
        ttft = time.perf_counter() - t0
        for i in range(WHISPER_GEN - 1):
            tok = torch.tensor(toks[-1:], dtype=torch.int32, device="cuda")
            logits, cache = decode(params, tok, cache,
                                   torch.tensor(WHISPER_PROMPT + i, device="cuda"), enc)
            got.append(logits[0])
            toks.append(int(torch.argmax(logits[0])))
        return torch.stack(got), toks, ttft

    t0 = time.perf_counter()
    serve()                                                  # warmup
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    got, toks, ttft = serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _family_counts()
    want = {"flash_wgmma": 2 * cfg.n_layers, "flash_simt": 0, "paged": 0}
    print(f"[serve encdec] {cfg.name} bf16, {cfg.n_layers} + {cfg.n_layers} layers, frames "
          f"{tuple(frames.shape)}, {WHISPER_PROMPT} prompt + {WHISPER_GEN} generated tokens: "
          f"TTFT {ttft * 1e3:.1f} ms (encoder and prefill), {WHISPER_GEN / wall:.1f} tok/s over "
          f"{wall:.3f} s; launches {counts} (want {want}: the encoder's and the decoder "
          f"prefill's layers); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    if counts != want:
        fail(f"serve encdec: launches {counts}, want {want}")
    seq = torch.cat([prompt[0], torch.tensor(toks[:-1], device="cuda")])[None]
    with torch.no_grad():
        ref = E.forward(params, frames, seq, cfg)[0][0, WHISPER_PROMPT - 1:]
    rel = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"[oracle encdec] prefill + decode logits vs encdec.forward over {seq.shape[1]} "
          f"tokens (bf16, the served arithmetic): max per-row relative RMS {rel:.3e} (bound "
          f"{ORACLE_REL_RMS:g}), argmax agreement {agree:.3f}", flush=True)
    if not torch.isfinite(got).all() or rel > ORACLE_REL_RMS:
        fail(f"serve encdec: logits differ from encdec.forward: relative RMS {rel:.3e}")
    del params
    return counts["flash_wgmma"]


def phase_train_families() -> None:
    """Each family's reduced config (``configs.reduced``), f32: the loss and
    every gradient leaf on the card against the CPU from the same state
    (PERF.md section 2 gates: loss 1e-5 relative, each leaf 1e-4 normwise),
    then one train step each, its loss and grad norm held to the same
    bounds.  The parameters after the step are printed, not held: AdamW's
    first step is nearly sign(g), so an entry whose gradient lies at the
    rounding noise moves by the rate either way."""
    from repro_torch import configs
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.parallel import steps as S
    from repro_torch.tree import leaves, tree_map, tree_unflatten
    loss_tol, grad_tol = TRAIN_TOL["float32"]
    pcfg = ParallelConfig(remat="none", fsdp_params=False, grad_dtype="float32")
    tcfg = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=8, z_loss=0.0)
    rows = []
    for arch in FAMILY_ARCHS:
        cfg = configs.reduced(configs.get(arch)).replace(dtype="float32")
        r = np.random.RandomState(0)
        batch = {"tokens": torch.from_numpy(r.randint(0, cfg.vocab, (2, 64)).astype(np.int32))}
        if cfg.enc_dec:
            batch["frames"] = torch.from_numpy(r.randn(2, 256, cfg.d_model).astype(np.float32))
        cpu = S.init_train_state(torch.Generator().manual_seed(0), cfg, pcfg)
        gpu = tree_map(lambda t: t.to("cuda"), cpu)
        gbatch = {k: v.cuda() for k, v in batch.items()}
        res = {}
        for name, state, b in (("cpu", cpu, batch), ("card", gpu, gbatch)):
            live = [p.detach().requires_grad_(True) for p in leaves(state["params"])]
            loss, m = S.make_loss_fn(cfg, pcfg, tcfg)(tree_unflatten(state["params"], live), b)
            grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
            new, met = S.make_train_step(cfg, pcfg, tcfg)(state, b)
            res[name] = (float(loss.detach()), float(m["aux"].detach()), [g.cpu() for g in grads],
                         [t.cpu() for t in leaves(new["params"])], float(met["loss"]),
                         float(met["grad_norm"]))
        (lc, ac, gc, pc, sc, nc), (lg, ag, gg, pg, sg, ng) = res["cpu"], res["card"]
        rel = abs(lg - lc) / abs(lc)
        gerr = max(float((a - b).norm() / max(float(b.norm()), 1e-30)) for a, b in zip(gg, gc))
        step_rel = max(abs(sg - sc) / abs(sc), abs(ng - nc) / abs(nc))
        perr = max(float((a - b).norm() / max(float(b.norm()), 1e-30)) for a, b in zip(pg, pc))
        rows.append(f"{arch} loss {lc:.4f} (aux {ac:.4f}) relative {rel:.1e}, worst grad leaf "
                    f"{gerr:.1e}, the step's loss and grad norm {step_rel:.1e}, parameters "
                    f"after it {perr:.1e} (not held)")
        if not (rel <= loss_tol and gerr <= grad_tol and step_rel <= loss_tol):
            fail(f"train families {arch}: card vs CPU loss relative {rel:.2e}, the step's loss "
                 f"and grad norm {step_rel:.2e} (bound {loss_tol}), worst grad leaf {gerr:.2e} "
                 f"(bound {grad_tol})")
    print("[train families] reduced configs, f32, batch 2 x 64 (whisper: 256 frames), card "
          "vs CPU from the same state: " + "; ".join(rows), flush=True)


def rank_moe(device, seed: int) -> dict:
    """One rank of the MoE layouts phase: Mixtral-8x22B's MoE FFN at full
    width (bf16 weights, f32 arithmetic) on the mesh (2, 4) in the EP layout (2 experts a rank, FSDP over
    data), the a2a layout (4 experts a data shard, d_ff / 4 a rank) and,
    with 3 experts, the TP layout (d_ff / 4 a rank); the outputs assembled,
    the walls and the bytes this rank staged."""
    import torch.distributed as dist
    from repro_torch.core.mesh import P, assemble
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe as M
    from repro_torch.parallel.sharding import shard_params
    mesh = make_local_mesh(MOE_MESH_MODEL)
    cfgs = _moe_rank_cfgs()
    b, s = MOE_TOKENS
    rows = b // mesh.size("data")
    i = mesh.index("data")
    out = {}
    for name, (key, kw) in _moe_rank_layouts().items():
        cfg = cfgs[key]
        ctx = M.MeshCtx(mesh=mesh, **kw)
        mesh.make_groups(ctx.batch_axes, ctx.fsdp_axes)
        x, p = _moe_rank_inputs(cfg, seed)
        local = {k: (v.clone() if torch.is_tensor(v) else {n: w.clone() for n, w in v.items()})
                 for k, v in shard_params({"moe": p}, cfg, ctx)["moe"].items()}
        del p
        torch.cuda.empty_cache()
        x = x[i * rows:(i + 1) * rows]
        walls = []
        for _ in range(2):                                 # the first builds nothing: warm
            torch.cuda.synchronize()
            dist.barrier()
            staged, t0 = mesh.staged_bytes, time.perf_counter()
            with mesh, torch.no_grad():
                y, _ = M.moe_ffn(local, x, cfg, ctx)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            staged = mesh.staged_bytes - staged
        with mesh:
            y = assemble(y, P("data"), mesh)
        out[name] = {"y": y.float().cpu() if mesh.rank == 0 else None, "wall": walls[-1],
                     "staged": staged, "peak": torch.cuda.max_memory_allocated()}
        del local, y
        torch.cuda.empty_cache()
    return out


def _moe_rank_cfgs() -> dict:
    from repro_torch import configs
    # f32 arithmetic on bf16 weights, as the reference's program runs in
    # f32: the ff-split layouts sum bf16-rounded partials otherwise, which
    # the elementwise bound does not allow where partials cancel
    cfg = configs.get(MOE_ALIGNED_ARCH).replace(n_layers=1, dtype="float32")
    # a capacity no assignment overflows, so EP and a2a drop nothing and
    # compute what the dropless one-process layer computes
    moe = dataclasses.replace(cfg.moe, capacity_factor=float(MOE_MESH_MODEL * 2))
    return {"eight": cfg.replace(moe=moe),
            "three": cfg.replace(moe=dataclasses.replace(moe, n_experts=3))}


def _moe_rank_layouts() -> dict:
    return {"ep": ("eight", dict(fsdp_axes=("data",))),
            "a2a": ("eight", dict(fsdp_axes=(), moe_a2a_ep=True)),
            "tp": ("three", dict(fsdp_axes=("data",)))}


def _moe_rank_inputs(cfg, seed: int):
    """The layer (bf16 matrices, f32 router) and the input (B, S, d) bf16,
    from the seed on the card: the same numbers in every process."""
    from repro_torch.models import moe as M
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(MOE_TOKENS + (cfg.d_model,), generator=g, device="cuda").to(torch.bfloat16)
    return x, M.moe_init(g, cfg, dtype=torch.bfloat16)


def phase_moe_ranks() -> None:
    """The MoE layouts on 8 gloo ranks sharing the card, each against the
    one-process ``moe_ffn`` on the same input and layer."""
    from repro_torch.core.mesh import launch
    from repro_torch.models import moe as M
    torch.cuda.empty_cache()
    refs = {}
    for key, cfg in _moe_rank_cfgs().items():
        x, p = _moe_rank_inputs(cfg, 11)
        with torch.no_grad():
            refs[key] = M.moe_ffn(p, x, cfg)[0].float().cpu()
        del x, p
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = launch(MOE_RANKS, rank_moe, 11, device="cuda", timeout=900)
    for name, (key, kw) in _moe_rank_layouts().items():
        y, ref = torch.from_numpy(res[0][name]["y"]), refs[key]   # results come back as numpy
        err = (y - ref).abs()
        ok = bool((err <= MOE_RANK_TOL["atol"] + MOE_RANK_TOL["rtol"] * ref.abs()).all())
        cfg = _moe_rank_cfgs()[key]
        staged = ", ".join(f"{r[name]['staged'] / 1e6:.1f}" for r in res)
        peaks = ", ".join(f"{r[name]['peak'] / 1e9:.2f}" for r in res)
        print(f"[moe ranks] {name}: {cfg.name} MoE FFN, {cfg.moe.n_experts} experts top-"
              f"{cfg.moe.top_k}, d {cfg.d_model}, d_ff {cfg.moe.d_ff_expert}, bf16 weights, "
              f"f32 arithmetic, "
              f"{MOE_TOKENS[0]} x {MOE_TOKENS[1]} tokens on mesh (2, {MOE_MESH_MODEL}) {kw}: "
              f"max |ranks - one process| {err.max().item():.3e} of max |y| "
              f"{ref.abs().max().item():.3e} (rtol {MOE_RANK_TOL['rtol']}, atol "
              f"{MOE_RANK_TOL['atol']}); wall (slowest rank) "
              f"{max(r[name]['wall'] for r in res) * 1e3:.1f} ms; staged by rank {staged} MB; "
              f"peak memory by rank {peaks} GB", flush=True)
        if not ok:
            fail(f"moe ranks {name}: the layout differs from the one-process layer")
    print(f"[moe ranks] {MOE_RANKS} ranks: {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# serving under a mesh ctx: the gloo ranks of ``core.mesh.launch`` sharing
# ``cuda:0``, each with its parameter blocks and its cache blocks
RANK_REQ, RANK_SLOTS = 4, 4                     # 4 requests of PROMPT + GEN, stagger 2
RANK_ORACLE_GEN = 16                            # decode steps teacher-forced in the oracle
# family -> (depth, model ranks, requests, prompt, gen, oracle prompt, oracle gen)
RANK_FAMILIES = {"zamba2-1.2b": (7, 2, 2, 64, 16, 64, 16),
                 "xlstm-1.3b": (8, 8, 2, 16, 8, 512, 16),
                 "mixtral-8x22b": (2, 2, 2, PROMPT, 16, PROMPT, 16)}
WHISPER_RANK_GEN = 16
TRAIN_RANK_ARCHS = ("zamba2-1.2b", "xlstm-1.3b", "whisper-base")


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _rank_setup(cfg, model: int, dev, seed: int = 0, pcfg=None):
    """This rank's mesh (world / model, model), ctx (``pcfg``, by default
    tensor parallelism without FSDP) and parameter blocks: the bf16 matrices
    of ``_family_init``'s seeded draw, each leaf cut to its block as soon as
    its group is drawn."""
    from repro_torch.config import ParallelConfig
    from repro_torch.core.mesh import local_block
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import make_ctx, param_specs
    from repro_torch.tree import leaves_with_path
    mesh = make_local_mesh(model)
    ctx = make_ctx(mesh, pcfg if pcfg is not None else ParallelConfig(fsdp_params=False))
    init = E.init if cfg.enc_dec else T.init
    specs = dict(leaves_with_path(param_specs(init(cfg, None), cfg, ctx)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init(cfg, gen, dtype=torch.bfloat16,
                  shard=lambda path, leaf: local_block(leaf, specs[path], mesh).clone())
    _sync(dev)
    return mesh, ctx, params


@contextlib.contextmanager
def _served_flash_inputs():
    """Inside a rank: ``models.layers._flash`` wrapped so that a copy of the
    first inputs of each shape the served path gives the flash kernel is
    kept (the kernel still runs on the originals); yields the dict of
    copies, keyed by (q shape, k shape, causal, window)."""
    from repro_torch.models import layers as L
    seen, plain = {}, L._flash

    def keep(q, k, v, *, causal, window):
        key = (tuple(q.shape), tuple(k.shape), causal, window)
        if key not in seen:
            seen[key] = (q.clone(), k.clone(), v.clone())
        return plain(q, k, v, causal=causal, window=window)

    L._flash = keep
    try:
        yield seen
    finally:
        L._flash = plain


def _flash_checks(seen: dict) -> list:
    """The flash kernel against its plain version on each kept input, in
    the (B, H, L, hd) views ``layers._flash`` passes: (label, max |kernel -
    plain|).  Run after the served run's counts were read."""
    from repro_torch.kernels import flash_attention as fa
    out = []
    for (_, _, causal, window), (q, k, v) in seen.items():
        b, lq, hkv, rep, hd = q.shape
        args = (q.reshape(b, lq, hkv * rep, hd).transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2))
        got = fa.flash_attention(*args, causal=causal, window=window).float()
        want = fa.flash_attention_ref(*args, causal=causal, window=window).float()
        out.append((f"{str(q.dtype).split('.')[-1]} q {tuple(args[0].shape)} against k "
                    f"{tuple(args[1].shape)}, {'causal' if causal else 'non-causal'}"
                    + (f", window {window}" if window else ""),
                    (got - want).abs().max().item()))
    return out


def _rank_serve(tag, cfg, params, ctx, reqs, **kw) -> dict:
    """A warmup run, then ``reqs`` through ``Scheduler(ctx=)``, the kernels'
    counts set to 0 just before and read just after; this rank's stats, and
    the flash kernel held against its plain version on the inputs the
    served run gave it."""
    from repro_torch.launch.scheduler import Scheduler, make_requests
    mesh = ctx.mesh
    sched = Scheduler(cfg, params, ctx=ctx, **kw)
    sched.run(make_requests(2, 16, 2, cfg.vocab))
    sched.reset()
    _sync(sched.device)
    if sched.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    staged, comm = mesh.staged_bytes, mesh.comm_seconds
    _zero_counts()
    with _served_flash_inputs() as seen:
        out = sched.run(reqs)
    counts = _family_counts()
    ttft = sorted(c.ttft_s for c in out["completions"].values())
    return {"tokens": {r: c.tokens for r, c in out["completions"].items()},
            "counts": counts, "tok_s": out["tok_s"], "wall_s": out["wall_s"],
            "ttft_p50": ttft[len(ttft) // 2], "decode_steps": out["decode_steps"],
            "prefills": out["prefills"], "generated": out["generated"],
            "peak": _peak(sched.device), "staged": mesh.staged_bytes - staged,
            "comm_s": mesh.comm_seconds - comm, "flash_checks": _flash_checks(seen)}


def _rank_path(cfg, params, ctx, seq: np.ndarray, prompt: int, gen: int, dev, paged=False,
               f32=True, max_len=None):
    """The teacher-forced serve path under ``ctx`` in f32 arithmetic on the
    served bf16 weights (f32 cache), or (``f32=False``) as served, in bf16:
    a fused (or chunked) prefill of the first ``prompt`` tokens of ``seq``
    and ``gen`` - 1 decode steps into a cache ``max_len`` long (default
    ``prompt + gen``); the logits (gen, V), global on every rank."""
    from repro_torch.launch.specs import restrict_batch
    from repro_torch.models import transformer as T
    from repro_torch.parallel import steps as S
    from repro_torch.serving import BlockPool
    cfg32 = cfg.replace(dtype="float32") if f32 else cfg
    cdt = torch.float32 if f32 else torch.bfloat16
    one = restrict_batch(ctx, 1)
    toks = torch.from_numpy(seq.astype(np.int32)).to(dev)[None]
    with torch.no_grad():
        if paged:
            n_pages = -(-(prompt + gen) // BLOCK)
            pool = BlockPool(n_pages, BLOCK)
            pool.admit(0, prompt + gen)
            cache = T.init_paged_cache(cfg32, n_pages, BLOCK, device=dev, dtype=cdt)
            step = S.make_chunk_prefill_step(cfg32, one)
            for lo in range(0, prompt, CHUNK):
                ln = min(CHUNK, prompt - lo)
                pool.ensure(0, lo + ln)
                chunk = torch.zeros((1, CHUNK), dtype=torch.int32, device=dev)
                chunk[0, :ln] = toks[0, lo:lo + ln]
                table = torch.from_numpy(pool.table(0, n_pages)[None]).to(dev)
                logits, cache = step(params, chunk, cache, lo, table, ln)
            decode = S.make_decode_step(cfg32, return_logits=True, paged=True, ctx=one)
        else:
            cache = T.init_cache(cfg32, 1, max_len or prompt + gen, device=dev, dtype=cdt,
                                 ctx=one)
            logits, cache = S.make_prefill_step(cfg32, one)(params, {"tokens": toks[:, :prompt]},
                                                           cache)
            decode = S.make_decode_step(cfg32, return_logits=True, ctx=one)
        got = [logits[0]]
        for i in range(gen - 1):
            pos = prompt + i
            args = (params, toks[0, pos:pos + 1], cache,
                    torch.tensor([pos], dtype=torch.int32, device=dev))
            if paged:
                pool.ensure(0, pos + 1)
                args += (torch.from_numpy(pool.table(0, n_pages)[None]).to(dev),)
            logits, cache = decode(*args)
            got.append(logits[0])
    return torch.stack(got).float().cpu()


def _one_process_path(cfg, params, seq: np.ndarray, prompt: int, gen: int,
                      dev="cuda", f32=True) -> torch.Tensor:
    """``_rank_path`` on one process (no ctx): the families' reference, and
    the reference of the ranks' bf16 path."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import steps as S
    cfg32 = cfg.replace(dtype="float32") if f32 else cfg
    toks = torch.from_numpy(seq.astype(np.int32)).to(dev)[None]
    with torch.no_grad():
        cache = T.init_cache(cfg32, 1, prompt + gen, device=dev,
                             dtype=torch.float32 if f32 else torch.bfloat16)
        logits, cache = S.make_prefill_step(cfg32)(params, {"tokens": toks[:, :prompt]}, cache)
        decode = S.make_decode_step(cfg32, return_logits=True)
        got = [logits[0]]
        for i in range(gen - 1):
            pos = prompt + i
            logits, cache = decode(params, toks[0, pos:pos + 1], cache,
                                   torch.tensor([pos], dtype=torch.int32, device=dev))
            got.append(logits[0])
    return torch.stack(got).float().cpu()


def _oracle_seq(cfg, n: int, seed: int) -> np.ndarray:
    from repro_torch.launch.scheduler import make_requests
    return np.asarray(make_requests(1, n, 1, cfg.vocab, seed=seed)[0].prompt)


def rank_serve(device, cfgs: dict) -> dict:
    """One of the 2 ranks (mesh (1, 2)) of the "serve ranks" phases:
    full-width, full-depth Llama-3.2-3B through ``Scheduler(ctx=)``,
    end-aligned and paged, then its f32 oracle path; then Zamba2-1.2B (depth
    7), Mixtral-8x22B (depth 2, EP) and Whisper-base, each model's memory
    freed before the next.  ``cfgs``: arch -> the config served."""
    from repro_torch.launch.scheduler import make_requests
    from repro_torch.models import moe as M
    out = {}
    dev = str(device)
    cfg = cfgs[ARCH]
    mesh, ctx, params = _rank_setup(cfg, 2, dev)
    reqs = make_requests(RANK_REQ, PROMPT, GEN, cfg.vocab, stagger=STAGGER)
    out["aligned"] = _rank_serve("aligned", cfg, params, ctx, reqs, slots=RANK_SLOTS,
                                 max_len=PROMPT + GEN, bucket=BUCKET)
    out["paged"] = _rank_serve("paged", cfg, params, ctx, reqs, slots=RANK_SLOTS,
                               max_len=PROMPT + GEN, paged=True, block=BLOCK, chunk=CHUNK)
    comp = out["aligned"]["tokens"][0]
    seq = np.concatenate([np.asarray(reqs[0].prompt),
                          np.asarray(comp[:RANK_ORACLE_GEN - 1], np.int32)])
    out["oracle_seq"] = seq
    out["oracle"] = _rank_path(cfg, params, ctx, seq, PROMPT, RANK_ORACLE_GEN, dev)
    out["oracle_paged"] = _rank_path(cfg, params, ctx, seq, PROMPT, RANK_ORACLE_GEN, dev,
                                     paged=True)
    out["served_bf16"] = _rank_path(cfg, params, ctx, seq, PROMPT, RANK_ORACLE_GEN, dev,
                                    f32=False)
    out["whole"] = rank_serve_whole(cfg, params, ctx, dev)
    del params
    _sync(dev)
    for arch in ("zamba2-1.2b", "mixtral-8x22b"):
        depth, model, n_req, prompt, gen, oprompt, ogen = RANK_FAMILIES[arch]
        cfg = cfgs[arch]
        _, fctx, params = _rank_setup(cfg, model, dev)
        reqs = make_requests(n_req, prompt, gen, cfg.vocab, stagger=STAGGER)
        out[arch] = _rank_serve(arch, cfg, params, fctx, reqs, slots=n_req,
                                max_len=prompt + gen, bucket=BUCKET)
        seq = _oracle_seq(cfg, oprompt + ogen - 1, 5)
        M.routes = [] if cfg.moe else None
        try:
            out[arch]["oracle"] = _rank_path(cfg, params, fctx, seq, oprompt, ogen, dev)
            out[arch]["routes"] = [r.cpu() for r in M.routes] if cfg.moe else None
        finally:
            M.routes = None
        del params
        _sync(dev)
    out["whisper-base"] = _rank_whisper(cfgs["whisper-base"], dev)
    return out


def _whisper_inputs(cfg, dev="cuda"):
    from repro_torch.launch.scheduler import make_requests
    g = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn((1, WHISPER_FRAMES, cfg.d_model), generator=g, device=dev)
    prompt = torch.from_numpy(np.asarray(make_requests(1, WHISPER_PROMPT, 1, cfg.vocab)[0]
                                         .prompt)).to(dev)[None]
    return frames, prompt


def _whisper_serve(cfg, params, ctx, frames, prompt, dev="cuda"):
    """``make_prefill_step`` and greedy ``make_decode_step``s under ``ctx``
    (None: one process): the logits (WHISPER_RANK_GEN, V) and tokens."""
    from repro_torch.launch.specs import restrict_batch
    from repro_torch.models import encdec as E
    from repro_torch.parallel import steps as S
    one = restrict_batch(ctx, 1) if ctx is not None else None
    prefill = S.make_prefill_step(cfg, one)
    decode = S.make_decode_step(cfg, return_logits=True, ctx=one)
    cache = E.init_cache(cfg, 1, WHISPER_PROMPT + WHISPER_RANK_GEN, device=dev, ctx=one)
    logits, cache, enc = prefill(params, {"tokens": prompt, "frames": frames}, cache)
    got, toks = [logits[0]], [int(torch.argmax(logits[0]))]
    for i in range(WHISPER_RANK_GEN - 1):
        tok = torch.tensor(toks[-1:], dtype=torch.int32, device=dev)
        logits, cache = decode(params, tok, cache,
                               torch.tensor(WHISPER_PROMPT + i, device=dev), enc)
        got.append(logits[0])
        toks.append(int(torch.argmax(logits[0])))
    return torch.stack(got), toks


def _rank_whisper(cfg, dev) -> dict:
    _, wctx, params = _rank_setup(cfg, 2, dev)
    frames, prompt = _whisper_inputs(cfg, dev)
    mesh = wctx.mesh
    _whisper_serve(cfg, params, wctx, frames, prompt, dev)         # warmup
    _sync(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    staged, comm = mesh.staged_bytes, mesh.comm_seconds
    _zero_counts()
    t0 = time.perf_counter()
    with _served_flash_inputs() as seen:
        got, toks = _whisper_serve(cfg, params, wctx, frames, prompt, dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = _family_counts()
    return {"logits": got.float().cpu(), "tokens": toks, "counts": counts,
            "wall_s": wall, "peak": _peak(dev),
            "staged": mesh.staged_bytes - staged, "comm_s": mesh.comm_seconds - comm,
            "flash_checks": _flash_checks(seen)}


def rank_xlstm(device, cfg) -> dict:
    """One of the 8 ranks (mesh (1, 8)) of xLSTM-1.3B (depth 8): 4 heads do
    not split 8 ways, so the mLSTM engine splits dk (1024 / 8) and sums its
    partial scores over ``model`` every chunk."""
    from repro_torch.launch.scheduler import make_requests
    arch = "xlstm-1.3b"
    depth, model, n_req, prompt, gen, oprompt, ogen = RANK_FAMILIES[arch]
    dev = str(device)
    _, ctx, params = _rank_setup(cfg, model, dev)
    reqs = make_requests(n_req, prompt, gen, cfg.vocab, stagger=STAGGER)
    out = _rank_serve(arch, cfg, params, ctx, reqs, slots=n_req, max_len=prompt + gen,
                      bucket=BUCKET)
    out["oracle"] = _rank_path(cfg, params, ctx, _oracle_seq(cfg, oprompt + ogen - 1, 5), oprompt,
                               ogen, dev)
    return out


def rank_cfgs() -> dict:
    """The configs the rank phases serve: Llama-3.2-3B whole, the families
    at the depth of ``RANK_FAMILIES``, Whisper-base whole."""
    from repro_torch import configs
    out = {a: configs.get(a) for a in (ARCH, "whisper-base")}
    out.update({a: configs.get(a).replace(n_layers=v[0]) for a, v in RANK_FAMILIES.items()})
    return dict(out, **{"mixtral-8x22b": _dropless(out["mixtral-8x22b"], 2)})


def _dropless(cfg, ep: int):
    """``cfg`` with a capacity factor of ``ep``: the EP layout's capacity
    ``min(ceil(T k / ep * cf), T k)`` is then T k, so no assignment drops and
    the layer computes what the dropless one-process layer computes (as
    ``phase_moe_ranks`` has it)."""
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=float(ep)))


def _init_on(cfg, dev):
    """The one-process model: the same seeded bf16 draw as ``_rank_setup``."""
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T
    return (E.init if cfg.enc_dec else T.init)(cfg, torch.Generator(device=dev).manual_seed(0),
                                               dtype=torch.bfloat16)


def _rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()


def _by_rank(runs: list, key: str, scale: float = 1.0, digits: int = 3) -> str:
    return ", ".join(f"{r[key] / scale:.{digits}f}" for r in runs)


def _print_rank_serve(tag: str, cfg, runs: list, extra: str = "") -> None:
    r0 = runs[0]
    print(f"[{tag}] {cfg.name} bf16, {cfg.n_layers} layers, {len(runs)} ranks: "
          f"{r0['generated']} tokens in {r0['wall_s']:.3f} s = {r0['tok_s']:.1f} tok/s; TTFT p50 "
          f"{r0['ttft_p50'] * 1e3:.1f} ms; {r0['decode_steps']} decode steps, {r0['prefills']} "
          f"prefills; launches by rank {[r['counts'] for r in runs]}; peak memory by rank "
          f"{_by_rank(runs, 'peak', 1e9, 2)} GB; staged through the host by rank "
          f"{_by_rank(runs, 'staged', 1e9)} GB; inside the collectives by rank "
          f"{_by_rank(runs, 'comm_s', 1.0, 2)} s" + extra, flush=True)


def _check_same_tokens(tag: str, runs: list, key: str = "tokens") -> None:
    if any(r[key] != runs[0][key] for r in runs[1:]):
        fail(f"{tag}: the ranks' tokens differ")


def _gate_flash_checks(tag: str, runs: list) -> None:
    """Each rank's flash kernel against its plain version on the inputs its
    served run gave the kernel (every shape it met); fails on a rank that
    kept none or differs by more than the bf16 bound."""
    tol = KERNEL_TOL[torch.bfloat16]
    for rank, r in enumerate(runs):
        if not r["flash_checks"]:
            fail(f"{tag}: rank {rank} kept no flash input")
        for label, err in r["flash_checks"]:
            print(f"[{tag}] rank {rank}: flash_attention {label}, on the served inputs: max "
                  f"|kernel - plain| {err:.3e} (bound {tol:g})", flush=True)
            if not err <= tol:
                fail(f"{tag}: rank {rank}'s flash kernel differs from its plain version by "
                     f"{err:.3e} at {label}")


def phase_serve_ranks(aligned_comps, cfgs: dict, dev: str = "cuda") -> dict:
    """Full-width Llama-3.2-3B on 2 gloo ranks sharing the card (mesh (1,
    2)): ``Scheduler(ctx=)`` end-aligned (flash launches a rank = non-empty
    admissions x 28) and paged (paged launches a rank = decode steps x 28);
    each rank's flash kernel against its plain version on the inputs of its
    served prefills; request 0 teacher-forced through the ranks' fused
    prefill and decode steps (and chunked prefill and paged decode) in f32
    arithmetic on the bf16 weights, against the one-process ``forward``,
    and in bf16 as served against the one-process bf16 path; then the
    families on the same launch (``phase_serve_ranks_families`` checks
    them)."""
    from repro_torch.core.mesh import launch
    from repro_torch.launch.scheduler import make_requests
    from repro_torch.models import transformer as T
    _sync(dev)
    t0 = time.perf_counter()
    res = launch(2, rank_serve, cfgs, device=dev, timeout=1100)
    print(f"[serve ranks] 2 ranks, launch {time.perf_counter() - t0:.1f} s (process start, "
          f"init and every model of the phase included)", flush=True)
    cfg = cfgs[ARCH]
    reqs = make_requests(RANK_REQ, PROMPT, GEN, cfg.vocab, stagger=STAGGER)
    admissions = sum(1 for r in reqs if len(r.prompt) > 0)
    for engine, key, want_of in (("aligned", "flash_wgmma", lambda r: admissions * cfg.n_layers),
                                 ("paged", "paged", lambda r: r["decode_steps"] * cfg.n_layers)):
        runs = [r[engine] for r in res]
        _check_same_tokens(f"serve ranks {engine}", runs)
        for rank, r in enumerate(runs):
            if sorted(r["tokens"]) != list(range(RANK_REQ)) or any(
                    len(t) != GEN for t in r["tokens"].values()):
                fail(f"serve ranks {engine}: rank {rank} served {sorted(r['tokens'])}")
            others = {k: v for k, v in r["counts"].items() if k != key}
            if r["counts"][key] != want_of(r) or any(others.values()):
                fail(f"serve ranks {engine}: rank {rank} launches {r['counts']}; want {key} = "
                     f"{want_of(r)} and no other kernel")
        diff = []
        for rid in range(RANK_REQ):
            a, b = runs[0]["tokens"][rid], aligned_comps[rid].tokens
            first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
            diff.append(f"{rid}: {'equal' if first is None else f'first differs at {first}'}")
        _print_rank_serve(f"serve ranks {engine}", cfg, runs,
                          f"; against the one-process end-aligned engine's completions "
                          f"(not gated): {'; '.join(diff)}")
        if engine == "aligned":
            _gate_flash_checks(f"serve ranks {engine}", runs)
    seq = res[0]["oracle_seq"]
    params = _init_on(cfg, dev)
    with torch.no_grad():
        ref = T.forward(params, torch.from_numpy(seq.astype(np.int64)).to(dev)[None],
                        cfg.replace(dtype="float32"))[0, PROMPT - 1:].float().cpu()
    one_bf16 = _one_process_path(cfg, params, seq, PROMPT, RANK_ORACLE_GEN, dev, f32=False)
    del params
    _sync(dev)
    rels = [_rel_rms(torch.from_numpy(r["served_bf16"]), one_bf16) for r in res]
    print(f"[serve ranks] served_bf16: request 0 over {len(seq)} tokens, the ranks' fused "
          f"prefill and end-aligned decode in bf16 as served vs the one-process bf16 path: max "
          f"per-row relative RMS by rank {', '.join(f'{x:.3e}' for x in rels)} (bound "
          f"{ORACLE_REL_RMS:g})", flush=True)
    if max(rels) > ORACLE_REL_RMS or not all(np.isfinite(r["served_bf16"]).all() for r in res):
        fail(f"serve ranks served_bf16: the ranks' bf16 logits differ from one process's: "
             f"{max(rels):.3e}")
    for key in ("oracle", "oracle_paged"):
        for rank, r in enumerate(res):
            got = torch.from_numpy(r[key])
            rel = _rel_rms(got, ref)
            if rank == 0:
                print(f"[serve ranks] {key}: request 0 over {len(seq)} tokens, the ranks' "
                      f"{'chunked prefill and paged' if key == 'oracle_paged' else 'fused prefill and end-aligned'}"
                      f" decode in f32 arithmetic on the bf16 weights vs the one-process forward: "
                      f"max per-row relative RMS {rel:.3e} (bound {ORACLE_F32_REL_RMS:g}), argmax "
                      f"agreement {(got.argmax(-1) == ref.argmax(-1)).float().mean().item():.3f}",
                      flush=True)
            if not torch.isfinite(got).all() or rel > ORACLE_F32_REL_RMS:
                fail(f"serve ranks {key}: rank {rank} logits differ from forward: {rel:.3e}")
    return {"res": res, "flash": res[0]["aligned"]["counts"]["flash_wgmma"],
            "paged": res[0]["paged"]["counts"]["paged"]}


def phase_serve_ranks_families(served, cfgs: dict, dev: str = "cuda") -> None:
    """The families on gloo ranks: Zamba2-1.2B (depth 7, its ``mamba2_attn``
    at index 5; 64 heads split over mesh (1, 2)), Mixtral-8x22B (depth 2,
    EP over (1, 2)) and Whisper-base (mesh (1, 2)) from ``rank_serve``'s
    launch, then xLSTM-1.3B (depth 8) on 8 ranks, mesh (1, 8), its mLSTM
    engine split on dk.  Each: the ranks serve the same tokens, their
    teacher-forced path in f32 arithmetic equals the one-process path
    (relative RMS 1e-3; Mixtral's routing flips printed); Whisper's bf16
    logits against the one-process ``encdec.forward`` (5e-2) with flash
    launches a rank = the encoder's 6 + the decoder prefill's 6."""
    from repro_torch.core.mesh import launch
    from repro_torch.models import encdec as E
    from repro_torch.models import moe as M
    res = served["res"]
    t0 = time.perf_counter()
    xres = launch(8, rank_xlstm, cfgs["xlstm-1.3b"], device=dev, timeout=900)
    print(f"[serve ranks families] xlstm 8 ranks, launch {time.perf_counter() - t0:.1f} s",
          flush=True)
    for arch, runs in (("zamba2-1.2b", [r["zamba2-1.2b"] for r in res]),
                       ("mixtral-8x22b", [r["mixtral-8x22b"] for r in res]),
                       ("xlstm-1.3b", xres)):
        depth, model, n_req, prompt, gen, oprompt, ogen = RANK_FAMILIES[arch]
        cfg = cfgs[arch]
        _check_same_tokens(f"serve ranks {arch}", runs)
        if cfg.moe:
            _gate_flash_checks(f"serve ranks {arch}", runs)
        want_flash = n_req * cfg.n_layers if cfg.moe else 0
        for rank, r in enumerate(runs):
            if r["counts"] != {"flash_wgmma": want_flash, "flash_simt": 0, "paged": 0} or any(
                    len(t) != gen for t in r["tokens"].values()):
                fail(f"serve ranks {arch}: rank {rank} launches {r['counts']} (want flash "
                     f"{want_flash}), tokens {r['tokens']}")
        seq = _oracle_seq(cfg, oprompt + ogen - 1, 5)
        params = _init_on(cfg, dev)
        M.routes = [] if cfg.moe else None
        try:
            ref = _one_process_path(cfg, params, seq, oprompt, ogen, dev)
            ref_routes = M.routes
        finally:
            M.routes = None
        del params
        _sync(dev)
        flips = ""
        if cfg.moe:
            got_routes = [torch.from_numpy(t) for t in runs[0]["routes"]]
            n = sum(int((torch.sort(a, -1).values != torch.sort(b.cpu(), -1).values).any(-1)
                        .sum()) for a, b in zip(got_routes, ref_routes))
            flips = (f"; (token, layer) top-{cfg.moe.top_k} sets that differ from one "
                     f"process's: {n} of {sum(a.shape[0] for a in ref_routes)}")
        rels = [_rel_rms(torch.from_numpy(r["oracle"]), ref) for r in runs]
        _print_rank_serve(f"serve ranks {arch}", cfg, runs,
                          f"; oracle over {len(seq)} tokens (prefill {oprompt}, {ogen} steps), "
                          f"f32 arithmetic, the ranks' path vs one process's: max per-row "
                          f"relative RMS by rank {', '.join(f'{x:.3e}' for x in rels)} (bound "
                          f"{ORACLE_F32_REL_RMS:g})" + flips)
        if max(rels) > ORACLE_F32_REL_RMS or not all(
                np.isfinite(r["oracle"]).all() for r in runs):
            fail(f"serve ranks {arch}: the ranks' logits differ from one process's")
    runs = [r["whisper-base"] for r in res]
    _check_same_tokens("serve ranks whisper", runs)
    cfg = cfgs["whisper-base"]
    params = _init_on(cfg, dev)
    frames, prompt = _whisper_inputs(cfg, dev)
    seq = torch.cat([prompt[0], torch.tensor(runs[0]["tokens"][:-1], device=dev)])[None]
    with torch.no_grad():
        ref = E.forward(params, frames, seq, cfg)[0][0, WHISPER_PROMPT - 1:].float().cpu()
        one, one_toks = _whisper_serve(cfg, params, None, frames, prompt, dev)
    del params
    _sync(dev)
    want = {"flash_wgmma": 2 * cfg.n_layers, "flash_simt": 0, "paged": 0}
    rels = [_rel_rms(torch.from_numpy(r["logits"]), ref) for r in runs]
    first = next((i for i, (a, b) in enumerate(zip(runs[0]["tokens"], one_toks)) if a != b), None)
    print(f"[serve ranks whisper] {cfg.name} bf16, frames {tuple(frames.shape)}, "
          f"{WHISPER_PROMPT} prompt + {WHISPER_RANK_GEN} greedy tokens on 2 ranks: "
          f"{WHISPER_RANK_GEN / runs[0]['wall_s']:.1f} tok/s over {runs[0]['wall_s']:.3f} s; "
          f"launches by rank {[r['counts'] for r in runs]} (want {want}); peak memory by rank "
          f"{_by_rank(runs, 'peak', 1e9, 2)} GB; staged by rank "
          f"{_by_rank(runs, 'staged', 1e6, 1)} MB; logits vs encdec.forward "
          f"(bf16): max per-row relative RMS by rank {', '.join(f'{x:.3e}' for x in rels)} "
          f"(bound {ORACLE_REL_RMS:g}); greedy tokens against one process's: "
          f"{'equal' if first is None else f'first differ at {first}'} (not gated)", flush=True)
    if any(r["counts"] != want for r in runs) or max(rels) > ORACLE_REL_RMS:
        fail("serve ranks whisper: launches or logits off")
    _gate_flash_checks("serve ranks whisper", runs)


def rank_train_families(device, cfgs: dict, states: dict, batches: dict) -> dict:
    """One of 4 ranks (mesh (2, 2)): for each reduced family, from
    ``states`` (the one-process initial states) and the rank's rows of each
    batch, the loss and every gradient leaf at the initial state (summed
    over the batch axes and assembled), then 2 f32 train steps; the metrics
    and the parameters after them assembled."""
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.core.mesh import assemble, local_block
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import steps as S
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.tree import leaves, tree_map, tree_unflatten
    mesh = make_local_mesh(2)
    pcfg = ParallelConfig(remat="none", fsdp_params=False, grad_dtype="float32")
    tcfg = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=8, z_loss=0.0)
    ctx = make_ctx(mesh, pcfg)
    out = {}
    for arch, cfg in cfgs.items():
        full = tree_map(lambda a: torch.from_numpy(a).to(device), states[arch])
        specs = S.train_state_shardings(cfg, pcfg, ctx, full)
        state = tree_map(lambda x, s: local_block(x, s, mesh).clone(), full, specs)
        del full
        pspecs = leaves(specs["params"])
        rows = [{k: S.local_rows(torch.from_numpy(v).to(device), ctx) for k, v in b.items()}
                for b in batches[arch]]
        with mesh:
            live = [p.detach().clone().requires_grad_(True) for p in leaves(state["params"])]
            loss, _ = S.make_loss_fn(cfg, pcfg, tcfg, ctx)(tree_unflatten(state["params"], live),
                                                           rows[0])
            grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
            grads = [assemble(S._reduce_grad(g, s, s, ctx), s, mesh).cpu()
                     for g, s in zip(grads, pspecs)]
        del live
        step = S.make_train_step(cfg, pcfg, tcfg, ctx)
        metrics = []
        for b in rows:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        with mesh:
            ps = [assemble(x, s, mesh).cpu() for x, s in zip(leaves(state["params"]), pspecs)]
        out[arch] = {"loss0": float(loss.detach()), "metrics": metrics,
                     "grads": grads if mesh.rank == 0 else None,
                     "params": ps if mesh.rank == 0 else None}
    return out


def phase_train_families_ranks(dev: str = "cuda") -> None:
    """The reduced Zamba2, xLSTM and Whisper configs (f32) on 4 gloo ranks
    (mesh (2, 2), tensor parallelism 2, batch over data) against one
    process on the card from the same state, with PERF.md section 2's train
    gates: the loss (1e-5 relative) and every gradient leaf (1e-4 normwise)
    at the initial state, then 2 train steps: each step's loss 1e-4 and the
    first step's grad norm 1e-5 relative.  The second step's grad norm and
    the parameters after the steps are printed, not held: AdamW's first
    update is nearly sign(g), so an entry whose gradient lies at the
    rounding noise of the two summation orders moves by the rate either way."""
    from repro_torch import configs
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.core.mesh import launch
    from repro_torch.parallel import steps as S
    from repro_torch.tree import leaves, tree_map, tree_unflatten
    loss_tol, grad_tol = TRAIN_TOL["float32"]
    pcfg = ParallelConfig(remat="none", fsdp_params=False, grad_dtype="float32")
    tcfg = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=8, z_loss=0.0)
    states, batches, single = {}, {}, {}
    cfgs = {a: configs.reduced(configs.get(a)).replace(dtype="float32") for a in TRAIN_RANK_ARCHS}
    for arch, cfg in cfgs.items():
        r = np.random.RandomState(1)
        bs = []
        for _ in range(2):
            b = {"tokens": r.randint(0, cfg.vocab, (4, 64)).astype(np.int32)}
            if cfg.enc_dec:
                b["frames"] = r.randn(4, 256, cfg.d_model).astype(np.float32)
            bs.append(b)
        state = S.init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, pcfg)
        states[arch] = tree_map(lambda t: t.cpu().numpy().copy(), state)   # steps write in place
        batches[arch] = bs
        tb = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in bs]
        live = [p.detach().clone().requires_grad_(True) for p in leaves(state["params"])]
        loss, _ = S.make_loss_fn(cfg, pcfg, tcfg)(tree_unflatten(state["params"], live), tb[0])
        grads = [g.cpu() for g in torch.autograd.grad(loss, live, allow_unused=True,
                                                      materialize_grads=True)]
        del live
        step = S.make_train_step(cfg, pcfg, tcfg)
        metrics = []
        for b in tb:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        single[arch] = (float(loss.detach()), grads, metrics,
                        [t.cpu() for t in leaves(state["params"])])
    t0 = time.perf_counter()
    res = launch(4, rank_train_families, cfgs, states, batches, device=dev, timeout=900)
    rows, bad = [], []
    for arch in TRAIN_RANK_ARCHS:
        loss0, grads, metrics, params = single[arch]
        got = res[0][arch]
        rel0 = abs(got["loss0"] - loss0) / abs(loss0)
        gerr = max(float(np.linalg.norm(a - b.numpy()) / max(float(b.norm()), 1e-30))
                   for a, b in zip(got["grads"], grads))
        lrel = [abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(got["metrics"], metrics)]
        nrel = [abs(g["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
                for g, w in zip(got["metrics"], metrics)]
        perr = max(float(np.linalg.norm(a - b.numpy()) / max(float(b.norm()), 1e-30))
                   for a, b in zip(got["params"], params))
        rows.append(f"{arch} loss {loss0:.4f} relative {rel0:.1e}, worst grad leaf {gerr:.1e}, "
                    f"step losses relative {', '.join(f'{x:.1e}' for x in lrel)}, grad norms "
                    f"{', '.join(f'{x:.1e}' for x in nrel)}, parameters after 2 steps "
                    f"{perr:.1e} (not held)")
        if not (rel0 <= loss_tol and gerr <= grad_tol and max(lrel) <= grad_tol
                and nrel[0] <= loss_tol):
            bad.append(arch)
    print(f"[train families ranks] reduced configs, f32, batch 4 x 64 (whisper: 256 frames), "
          f"4 ranks, mesh (2, 2), TP 2, vs one process on the card: " + "; ".join(rows)
          + f"; launch {time.perf_counter() - t0:.1f} s", flush=True)
    if bad:
        fail(f"train families ranks {bad}: the ranks differ from one process (loss and first "
             f"grad norm {loss_tol}, gradient leaves and step losses {grad_tol})")


# ---------------------------------------------------------------------------
# the sequence-parallel residual and the whole-cache serve layout, on gloo
# ranks sharing ``cuda:0``
SP_ROWS = 32                  # positions of rank 0's no-grad logits held against one process
WHOLE_GEN, WHOLE_BUCKET = 63, 15   # max_len 512 + 63 = 575 and bucket 15: 2 divides neither


def rank_train_sp(device, job, tokens: np.ndarray) -> dict:
    """One of the 2 ranks of "train tp sp": ``job``'s steps through
    ``launch.train.train_rank`` (``sequence_parallel``), then one no-grad
    forward of ``tokens`` (the global batch: this rank's rows are all of
    it, mesh (1, 2)) under the same layout on the seeded bf16 weights, the
    kernels' counts set to 0 just before and read just after, the first
    flash input of each shape kept; rank 0's logits of batch row 0 at
    ``SP_ROWS`` positions over both ranks' halves, gathered over the
    vocabulary."""
    from repro_torch.core.mesh import P, assemble
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    out = train.train_rank(device, job)
    dev = str(device)
    _sync(dev)
    mesh, ctx, params = _rank_setup(job.cfg, 2, dev, pcfg=job.pcfg)
    toks = torch.from_numpy(tokens).to(dev)
    pos = torch.linspace(0, tokens.shape[1] - 1, SP_ROWS, device=dev).long()
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    staged, comm = mesh.staged_bytes, mesh.comm_seconds
    _zero_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), mesh, _served_flash_inputs() as seen:
        lg = T.forward(params, toks, job.cfg, ctx=ctx)
        _sync(dev)
    out.update(fwd_wall=time.perf_counter() - t0, fwd_counts=_family_counts(),
               fwd_staged=mesh.staged_bytes - staged, fwd_comm=mesh.comm_seconds - comm,
               fwd_peak=_peak(dev))
    with mesh:
        rows = assemble(lg[0, pos].float().contiguous(), P(None, "model"), mesh)
    out["fwd_logits"] = rows.cpu() if mesh.rank == 0 else None
    out["fwd_pos"] = pos.cpu()
    out["flash_checks"] = _flash_checks(seen)
    return out


def phase_train_tp_sp(cfg, ref_losses, tp: dict, res: list, tokens: np.ndarray,
                      dev: str = "cuda") -> None:
    """Full-width, full-depth Llama-3.2-3B on 2 ranks sharing the card, mesh
    (1, 2), TP 2 with the sequence-parallel residual (each rank's S/2 rows
    between the layers: all-gathers before the column-parallel products,
    reduce-scatters after the row-parallel ones), ``phase_train``'s state,
    data and TrainConfig, 3 steps: losses within MESH_TOL of
    ``phase_train``'s; staged bytes, the share of the wall inside the
    collectives and the peak memory a rank beside "train tp"'s.  Then one
    no-grad forward of a batch on the same ranks: each rank's S/2 query
    rows through the tensor-core flash kernel (launches a rank = layers),
    each rank's kernel against its plain version on its own inputs
    (KERNEL_TOL[bf16]), rank 0's logits against the one-process bf16
    ``forward`` (ORACLE_REL_RMS).  ``res``: the ranks' ``rank_train_sp``
    results from "train tp"'s launch."""
    from repro_torch.models import transformer as T
    pcfg = _train_setup(cfg)[0]
    hist = res[0]["history"]
    losses = [h["loss"] for h in hist]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"[train tp sp] {cfg.name}, {cfg.n_layers} layers, mesh (1, 2), TP 2, "
          f"sequence_parallel, batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat={pcfg.remat}: losses "
          + ", ".join(f"{a:.4f} (one process {b:.4f}, relative {e:.1e})"
                      for a, b, e in zip(losses, ref_losses, rel))
          + f", bound {MESH_TOL}", flush=True)
    _print_ranks("train tp sp", [max(r["history"][i]["time_s"] for r in res)
                                 for i in range(len(hist))], [r["peak_bytes"] for r in res],
                 [[h["staged_bytes"] for h in r["history"]] for r in res],
                 [[h["comm_s"] for h in r["history"]] for r in res])
    sp = _rank_figures(res)
    for key, label, scale, unit in (
            ("staged", f"staged a step (steps 2-{len(hist)})", 1e9, " GB"),
            ("comm_share", f"share of the step wall inside the collectives (steps "
                           f"2-{len(hist)})", 1.0, ""),
            ("peak", "peak memory (max_memory_allocated, the steps)", 1e9, " GB")):
        print(f"[train tp sp] {label} by rank: "
              f"{', '.join(f'{v / scale:.3f}' for v in sp[key])}{unit}; train tp (no sequence "
              f"parallelism), this run: {', '.join(f'{v / scale:.3f}' for v in tp[key])}{unit}; "
              f"ratio {np.mean(sp[key]) / np.mean(tp[key]):.3f}", flush=True)
    if len(losses) != TP_STEPS or not all(np.isfinite(losses)) or not max(rel) <= MESH_TOL:
        fail(f"train tp sp: losses {losses} against one process's {ref_losses[:TP_STEPS]}")
    for rank, r in enumerate(res):
        c = r["fwd_counts"]
        print(f"[train tp sp] rank {rank}: no-grad forward of {TRAIN_BATCH} x {TRAIN_SEQ} "
              f"tokens in {r['fwd_wall'] * 1e3:.1f} ms, launches {c}, staged "
              f"{r['fwd_staged'] / 1e9:.3f} GB, {r['fwd_comm'] * 1e3:.0f} ms inside the "
              f"collectives, peak {r['fwd_peak'] / 1e9:.2f} GB", flush=True)
        if c["flash_wgmma"] != cfg.n_layers or c["flash_simt"] or c["paged"]:
            fail(f"train tp sp: rank {rank}'s forward launched {c}; want flash_wgmma = "
                 f"{cfg.n_layers} and no other kernel")
    _gate_flash_checks("train tp sp", res)
    params = _init_on(cfg, dev)
    pos = torch.from_numpy(res[0]["fwd_pos"])
    with torch.no_grad():
        ref = T.forward(params, torch.from_numpy(tokens[:1]).to(dev), cfg)[0, pos.to(dev)]
    del params
    _sync(dev)
    got = torch.from_numpy(res[0]["fwd_logits"])
    err = _rel_rms(got, ref.float().cpu())
    print(f"[train tp sp] rank 0's no-grad logits (batch row 0, {len(pos)} positions over "
          f"both ranks' rows) vs the one-process bf16 forward: max per-row relative RMS "
          f"{err:.3e} (bound {ORACLE_REL_RMS:g})", flush=True)
    if not torch.isfinite(got).all() or not err <= ORACLE_REL_RMS:
        fail(f"train tp sp: rank 0's logits differ from one process's forward: {err:.3e}")


def rank_serve_whole(cfg, params, ctx, dev) -> dict:
    """"serve ranks whole cache" on one of ``rank_serve``'s 2 ranks, its
    Llama-3.2-3B blocks: ``Scheduler(ctx=)`` end-aligned with max_len 575
    and bucket 15 (2 divides neither: the cache rows are whole on every
    rank, and a 512-token prompt's 525-token bucket attends the whole
    gathered K/V), then request 0 teacher-forced in bf16 as served into a
    575-slot cache."""
    from repro_torch.launch.scheduler import make_requests
    reqs = make_requests(RANK_REQ, PROMPT, WHOLE_GEN, cfg.vocab, stagger=STAGGER)
    out = _rank_serve("whole", cfg, params, ctx, reqs, slots=RANK_SLOTS,
                      max_len=PROMPT + WHOLE_GEN, bucket=WHOLE_BUCKET)
    seq = np.concatenate([np.asarray(reqs[0].prompt),
                          np.asarray(out["tokens"][0][:RANK_ORACLE_GEN - 1], np.int32)])
    out["oracle_seq"] = seq
    out["served_bf16"] = _rank_path(cfg, params, ctx, seq, PROMPT, RANK_ORACLE_GEN, dev,
                                    f32=False, max_len=PROMPT + WHOLE_GEN)
    return out


def phase_serve_ranks_whole(served, cfg, dev: str = "cuda") -> None:
    """Full-width Llama-3.2-3B on 2 ranks sharing the card (mesh (1, 2)),
    served end-aligned with a cache length and a bucket that 2 does not
    divide (4 requests of 512 + 63 tokens): each rank holds every slot,
    writes every token and scores every slot with no combine over
    ``model``.  Flash launches a rank = admissions x 28 (nothing else);
    each rank's flash kernel against its plain version on its served
    inputs; request 0's bf16 logits, teacher-forced, against the
    one-process bf16 path (ORACLE_REL_RMS).  The ranks served it in
    ``rank_serve``'s launch (``served``), on the weights already there."""
    from repro_torch.launch.scheduler import make_requests
    runs = [r["whole"] for r in served["res"]]
    reqs = make_requests(RANK_REQ, PROMPT, WHOLE_GEN, cfg.vocab, stagger=STAGGER)
    want = sum(1 for r in reqs if len(r.prompt) > 0) * cfg.n_layers
    _check_same_tokens("serve ranks whole cache", runs)
    for rank, r in enumerate(runs):
        if sorted(r["tokens"]) != list(range(RANK_REQ)) or any(
                len(t) != WHOLE_GEN for t in r["tokens"].values()):
            fail(f"serve ranks whole cache: rank {rank} served {sorted(r['tokens'])}")
        others = {k: v for k, v in r["counts"].items() if k != "flash_wgmma"}
        if r["counts"]["flash_wgmma"] != want or any(others.values()):
            fail(f"serve ranks whole cache: rank {rank} launches {r['counts']}; want "
                 f"flash_wgmma = {want} and no other kernel")
    _print_rank_serve("serve ranks whole cache", cfg, runs,
                      f"; max_len {PROMPT + WHOLE_GEN}, bucket {WHOLE_BUCKET}")
    _gate_flash_checks("serve ranks whole cache", runs)
    seq = runs[0]["oracle_seq"]
    params = _init_on(cfg, dev)
    one = _one_process_path(cfg, params, seq, PROMPT, RANK_ORACLE_GEN, dev, f32=False)
    del params
    _sync(dev)
    rels = [_rel_rms(torch.from_numpy(r["served_bf16"]), one) for r in runs]
    print(f"[serve ranks whole cache] served_bf16: request 0 over {len(seq)} tokens, the "
          f"ranks' fused prefill and end-aligned decode into the whole 575-slot cache in bf16 "
          f"vs the one-process bf16 path: max per-row relative RMS by rank "
          f"{', '.join(f'{x:.3e}' for x in rels)} (bound {ORACLE_REL_RMS:g})", flush=True)
    if max(rels) > ORACLE_REL_RMS or not all(np.isfinite(r["served_bf16"]).all() for r in runs):
        fail(f"serve ranks whole cache: the ranks' bf16 logits differ from one process's: "
             f"{max(rels):.3e}")


DRY_TEMPLATE = """# Dry run of the port, Llama-3.2-3B on the (16, 16) mesh

Roofline terms: the cost model's predictions on H100 data-sheet constants
from the dry run's counts (``launch/dryrun.py``), not measurements.

<!-- ROOFLINE_16x16 -->
<!-- /ROOFLINE_16x16 -->
"""


def phase_dry_run(cfg, tp: dict, sp_runs: list) -> None:
    """The dry run (``launch/dryrun.py``), CPU work in this process: one
    rank's program on ``meta`` over a ``RecordingMesh``.  "train tp" and
    "train tp sp" (``tp``: "train tp"'s figures; ``sp_runs``: the ranks'
    "train tp sp" results) recorded for each rank at its coordinates: the
    recorded staged bytes of a step must equal every step's bytes the rank
    staged on the card.  Then Llama-3.2-3B x {train_4k, prefill_32k,
    decode_32k} on (16, 16): JAX's one-line summary each; a prefill counts
    28 abstract flash launches and no card counter moves.  The records fill
    a template under ``build/`` through ``launch/report.py``."""
    from repro_torch import configs
    from repro_torch.config import ShapeConfig
    from repro_torch.core import costmodel
    from repro_torch.core.mesh import RecordingMesh
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun, report
    pcfg, tcfg, shape = _train_setup(cfg)
    sp = _rank_figures(sp_runs)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model = costmodel.model_flops_train(cfg.param_counts()["active"], tokens)
    for tag, layout, got in (("train tp", pcfg, tp),
                             ("train tp sp", dataclasses.replace(pcfg, sequence_parallel=True),
                              sp)):
        flops = 0.0
        for rank in range(2):
            mesh = RecordingMesh((1, 2), ("data", "model"), (0, rank))
            raw = dryrun.trace_cell(ARCH, ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_BATCH),
                                    mesh, pcfg=layout, cfg_override=cfg, tcfg=tcfg)
            flops += raw["flops"]
            mem, card = raw["memory"], got["staged_steps"][rank]
            print(f"[dry run] {tag}, rank {rank}: traced in {raw['seconds']:.1f} s; staged a "
                  f"step recorded {raw['staged_bytes']} B, on the card "
                  f"{', '.join(str(int(b)) for b in card)} B; FLOPs "
                  f"{raw['flops']:.4e}; arguments {mem['argument_bytes'] / 1e9:.3f} GB, peak "
                  f"estimate {mem['peak_estimate_bytes'] / 1e9:.3f} GB against the measured "
                  f"peak {got['peak'][rank] / 1e9:.3f} GB (ratio "
                  f"{mem['peak_estimate_bytes'] / max(got['peak'][rank], 1):.3f}); wire "
                  f"{raw['collectives']['wire_bytes'] / 1e9:.3f} GB", flush=True)
            if any(raw["staged_bytes"] != b for b in card):
                fail(f"dry run: {tag} rank {rank} recorded {raw['staged_bytes']} B staged a "
                     f"step; the card staged {card}")
        print(f"[dry run] {tag}: FLOPs over both ranks {flops:.4e}; "
              f"costmodel.model_flops_train {model:.4e}, x 4/3 (full remat) "
              f"{model * 4 / 3:.4e}: ratio {flops / (model * 4 / 3):.4f}", flush=True)
    counts = (fa.launches, fa.launches_wgmma)
    records = []
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(ARCH, shape_name, multi_pod=False)
        print(f"[dry run] {ARCH} x {shape_name} x 16x16: {time.perf_counter() - t0:.1f} s "
              f"wall", flush=True)
        layers = configs.get(ARCH).n_layers
        want = {"flash_attention_wgmma": layers} if rec["kind"] == "prefill" else {}
        if rec["kernel_launches"] != want:
            fail(f"dry run: {shape_name} counted abstract launches {rec['kernel_launches']}; "
                 f"want {want}")
        records.append(rec)
    if (fa.launches, fa.launches_wgmma) != counts:
        fail(f"dry run: the card's flash counters moved from {counts} to "
             f"{(fa.launches, fa.launches_wgmma)}")
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "dryrun_16x16.json").write_text(json.dumps(records, indent=1))
    (out / "dryrun_report.md").write_text(
        report.fill(DRY_TEMPLATE, str(out / "dryrun_16x16.json")))
    print((out / "dryrun_report.md").read_text(), flush=True)


# ---------------------------------------------------------------------------
def _timed(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _record(name: str, source: str, replaces: str, launches: int, r: dict) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}


def main() -> None:
    name = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.models import transformer as T
    _timed("build", phase_build)
    rec = _timed("kernels: paged attention", phase_kernels)
    _timed("kernels: rows decode", phase_rows_kernel)
    flash = _timed("kernels: flash attention", phase_flash_kernels)
    grouped = _timed("kernels: grouped experts", phase_grouped_kernels)
    tile = _timed("kernels: matmul, matmul_acc, minplus", phase_tile_kernels)
    cfg = configs.get(ARCH)
    t0 = time.perf_counter()
    # bf16 matrices, as the serve CLI asks: ``dense`` casts every matrix to
    # cfg.dtype (bf16) before its product, and a bf16 init rounds the same
    # f32 draws once, so the numbers equal those of the f32 master init
    params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"]["embedding"]] +
                   [w for lp in params["layers"] for d in lp.values() for w in d.values()])
    print(f"[init] {cfg.name}: {n_params / 1e9:.3f} B parameters (bf16 matrices) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    comps, launches = _timed("serve", phase_serve, cfg, params)
    _timed("oracle", phase_oracle, cfg, params, comps[0])
    _timed("trace", phase_trace, cfg, params)
    aligned_comps, flash_launches = _timed("serve aligned", phase_serve_aligned, cfg, params,
                                           comps)
    _timed("oracle aligned", phase_oracle_aligned, cfg, params, aligned_comps[0])
    del params
    torch.cuda.empty_cache()
    train_losses = _timed("train", phase_train, cfg)
    _timed("train reduced", phase_train_reduced, cfg)
    _timed("train launcher", phase_train_launcher)
    counts, link = _timed("ranks", phase_distributed)
    tp_figures, sp_runs, sp_tokens = _timed("train tp", phase_train_tp, cfg, train_losses, link)
    _timed("train tp sp", phase_train_tp_sp, cfg, train_losses, tp_figures, sp_runs, sp_tokens)
    _timed("dry run", phase_dry_run, cfg, tp_figures, sp_runs)
    _timed("train layouts", phase_train_layouts, link)
    _timed("serve moe aligned", phase_serve_moe_aligned)
    grouped_launches = _timed("serve mellum2 aligned", phase_serve_mellum2_aligned)
    _timed("serve moe paged", phase_serve_moe_paged)
    for arch, (tag, _, _) in RECURRENT_ARCHS.items():
        _timed(f"serve {tag}", phase_serve_recurrent, arch)
    _timed("serve encdec", phase_serve_encdec)
    _timed("train families", phase_train_families)
    _timed("moe ranks", phase_moe_ranks)
    cfgs = rank_cfgs()
    served = _timed("serve ranks", phase_serve_ranks, aligned_comps, cfgs)
    _timed("serve ranks whole cache", phase_serve_ranks_whole, served, cfg)
    _timed("serve ranks families", phase_serve_ranks_families, served, cfgs)
    _timed("train families ranks", phase_train_families_ranks)
    csrc, ref = "src/repro_torch/kernels/csrc/", "src/repro/kernels/"
    kernels = [
        _record("paged_attention", csrc + "paged_attention.cu", ref + "paged_attention.py:90",
                launches, rec[("serve", torch.bfloat16)]),
        _record("matmul", csrc + "matmul.cu", ref + "matmul.py:82", counts["matmul_f32_ffma"],
                tile[("matmul", torch.float32)]),
        _record("matmul_f16", csrc + "matmul.cu", ref + "matmul.py:82",
                counts["matmul_f16_wgmma"], tile[("matmul", torch.float16)]),
        _record("matmul_acc", csrc + "matmul.cu", ref + "matmul.py:48",
                counts["matmul_acc_f32_ffma"], tile[("matmul_acc_float32", (4096, 2048, 2048))]),
        _record("matmul_acc_f16", csrc + "matmul.cu", ref + "matmul.py:48",
                counts["matmul_acc_f16_wgmma"],
                tile[("matmul_acc_float16", (4096, 2048, 2048))]),
        _record("minplus", csrc + "minplus.cu", ref + "minplus.py:44", counts["minplus"],
                tile[("minplus", torch.float32)]),
        _record("flash_attention", csrc + "flash_attention.cu", ref + "flash_attention.py:84",
                flash_launches, flash[("serve prefill", torch.bfloat16)]),
        # replaces no Pallas kernel: stands in for lax.ragged_dot
        _record("grouped_matmul", csrc + "grouped_matmul.cu", "src/repro/models/moe.py:100",
                grouped_launches, grouped["mellum2 decode"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
