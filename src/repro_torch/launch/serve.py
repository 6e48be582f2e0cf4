"""Serving launcher: thin CLI over the continuous-batching scheduler.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 8 --prompt-len 512 --gen 64 --slots 4

Serves any registered decoder arch (dense, MoE, Mamba2 hybrid, xLSTM) at
its published width on the card (``--device``, default ``cuda``), with
random weights from a seeded generator; ``--reduced`` shrinks it to the JAX
CLI's CPU size.  An enc-dec arch exits, as the JAX CLI does (drive
``models.encdec`` through ``parallel.steps``).  Each prompt is prefilled in
ONE fused cache-writing forward (through the flash-attention kernel),
right-padded to a ``--bucket`` multiple (a pattern with recurrent kinds
feeds it token by token through the decode step instead, unpadded);
requests share a fixed slot pool: staggered
arrivals are admitted into free slots mid-flight, finished requests
evicted, greedy (or sampled) tokens streamed per request
(``launch/scheduler.py``).  ``--naive`` serves one request at a time
(slots=1).  ``--paged`` switches to the paged engine: prompts prefilled in
``--chunk``-token slices written into ``--block``-token pages of a shared
arena.  A warmup pass runs first, so the kernel build and the library's
first-call set-up never land in the reported tok/s; every timing reads
after ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.launch.scheduler import Scheduler, make_requests
from repro_torch.models import transformer as T


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch shrunk to CPU size (configs.reduced)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--stagger", type=int, default=2,
                    help="ticks (decode steps) between request arrivals")
    ap.add_argument("--naive", action="store_true",
                    help="one-request-at-a-time baseline (slots=1)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV-cache engine: block-pool arena + chunked "
                         "prefill admission (pure-attention no-SWA archs)")
    ap.add_argument("--bucket", type=int, default=16,
                    help="prompt pad bucket of the fused prefill (end-aligned "
                         "engine)")
    ap.add_argument("--block", type=int, default=16,
                    help="page size in tokens (only with --paged)")
    ap.add_argument("--chunk", type=int, default=32,
                    help="prefill tokens consumed per tick (only with --paged)")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="total pages in the pool (default: slots x "
                         "ceil(max_len/block))")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (only with --temperature > 0)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the sampling stream")
    args = ap.parse_args(argv)
    if args.requests < 1 or args.gen < 1:
        ap.error(f"--requests and --gen must be >= 1 "
                 f"(got {args.requests}/{args.gen})")
    if args.prompt_len < 0 or args.slots < 1 or args.stagger < 0:
        ap.error("--prompt-len/--stagger must be >= 0 and --slots >= 1")
    if args.block < 1 or args.chunk < 1 or args.bucket < 1 or \
            (args.pool_blocks is not None and args.pool_blocks < 1):
        ap.error("--block/--chunk/--bucket/--pool-blocks must be >= 1")
    if args.temperature < 0 or not 0 < args.top_p <= 1:
        ap.error("--temperature must be >= 0 and --top-p in (0, 1]")
    if args.prompt_len + args.gen < 2:
        ap.error("--prompt-len + --gen must be >= 2")

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    if cfg.enc_dec:
        raise SystemExit(f"{cfg.name} is an enc-dec model, which the scheduler does not "
                         f"serve; drive models.encdec through parallel.steps' "
                         f"make_prefill_step / make_decode_step")
    if args.paged and not T.supports_paged(cfg):
        raise SystemExit(f"--paged needs a pure-attention no-SWA arch; "
                         f"{cfg.name} has pattern {cfg.block_pattern} "
                         f"(window={cfg.window})")
    device = torch.device(args.device)
    # serving keeps bf16 matrices: ``dense`` casts every matrix to
    # cfg.dtype (bf16) before its product, and a bf16 init rounds the same
    # f32 draws once, so the logits equal those of the f32 master init
    params = T.init(cfg, torch.Generator(device=device).manual_seed(args.seed),
                    dtype=torch.bfloat16)

    slots = 1 if args.naive else args.slots
    max_len = args.prompt_len + args.gen
    if not args.paged and cfg.window is not None and max_len > cfg.window:
        raise SystemExit(f"prompt+gen {max_len} exceeds the attention window "
                         f"{cfg.window} (end-aligned slots; --paged lifts the "
                         f"limit for no-SWA archs)")
    sched = Scheduler(cfg, params, slots=slots, max_len=max_len, bucket=args.bucket,
                      temperature=args.temperature, top_p=args.top_p,
                      seed=args.seed, paged=args.paged, block=args.block,
                      chunk=args.chunk, pool_blocks=args.pool_blocks)

    # warmup: kernel build and first-call set-up outside the timed run
    sched.run(make_requests(min(2, args.requests), args.prompt_len,
                            min(2, args.gen), cfg.vocab))
    sched.reset()

    reqs = make_requests(args.requests, args.prompt_len, args.gen, cfg.vocab,
                         stagger=args.stagger)
    out = sched.run(reqs)
    comps = out["completions"]
    if len(comps) != args.requests:
        raise RuntimeError(f"served {len(comps)} of {args.requests} requests")
    mode = "naive (1 slot)" if args.naive else f"batched ({slots} slots)"
    if args.paged:
        mode += f", paged (block={args.block} chunk={args.chunk} pool={sched.pool.n_blocks})"
    else:
        mode += f", end-aligned (fused prefill, bucket={args.bucket})"
    if args.temperature > 0:
        mode += f", T={args.temperature} top_p={args.top_p}"
    ttft = sorted(c.ttft_s for c in comps.values())
    print(f"served {args.requests} requests of {cfg.name} on {device} [{mode}]: "
          f"{out['generated']} toks in {out['wall_s']:.2f}s "
          f"({out['tok_s']:.1f} tok/s, {out['ticks']} ticks)")
    print(f"ttft (admission->first token) p50/p99: "
          f"{ttft[len(ttft) // 2] * 1e3:.1f}/"
          f"{ttft[int(len(ttft) * 0.99)] * 1e3:.1f} ms")
    if args.paged:
        rep = out["pool"]
        print(f"pool: {rep['n_blocks']} blocks x {rep['block']} toks, peak "
              f"occupancy {rep['peak_occupancy']:.2f}, end occupancy "
              f"{rep['occupancy']:.2f}, internal fragmentation at peak "
              f"{rep['frag_at_peak']:.2f}")
    print("sample:", comps[0].tokens[:12])
    return out


if __name__ == "__main__":
    main()
