"""Training launcher: the end-to-end entry point (the paper's example application (b)).

Trains an arch on one device -- ``cuda`` unless ``--device cpu`` -- with
the JAX launcher's flags, defaults and loss check:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch chatglm3-6b --steps 8 --batch 2 --seq 64 --ckpt-every 3 \
      --ckpt-dir "$TMPDIR/ck" --inject-fault-at 5

``--reduce`` (on by default) shrinks the arch to its CPU-sized form
(``configs.reduced``).  Fault tolerance is on by default: step-fenced
checkpoints + a crash-only restart loop (runtime/recovery.py);
``--inject-fault-at N`` proves recovery.  A ``--ckpt-dir`` that already
holds checkpoints is resumed from, so start a fresh run in an empty one.
The layouts that need the port's sharding layer (``--plan auto``,
``--model-parallel`` above 1) raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.config import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.data import make_batch_iterator
from repro_torch.parallel import steps as S
from repro_torch.runtime import TrainingRunner


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduce", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--plan", default="default",
                    choices=["default", "auto", "zero", "allreduce"],
                    help="parallel layout: zero/allreduce pin the gradient "
                         "strategy ('zero' takes the single-device step on one "
                         "device, as the JAX launcher does); 'auto' needs the "
                         "port's planner (not ported yet)")
    # 3e-3 (with the seeded init/data below) descends within even 8-step
    # smoke runs; 1e-3 needs tens of steps to clear the warmup ramp
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'; there is no fallback")
    return ap.parse_args(argv)


def main(argv=None):
    """Runs the launcher; returns (final state, metrics history)."""
    args = parse_args(argv)
    if args.plan == "auto":
        raise NotImplementedError("--plan auto needs the port's planner "
                                  "(parallel/planner.py; ROADMAP queue 1, item 7)")
    if args.model_parallel > 1:
        raise NotImplementedError("--model-parallel > 1 needs the port's tensor-parallel "
                                  "ops and sharding layer (ROADMAP queue 1, items 2 and 7)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is visible; "
                           "pass --device cpu to train on the CPU")

    cfg = configs.get(args.arch)
    if args.reduce:
        cfg = configs.reduced(cfg)
    shape = ShapeConfig("train_cli", "train", args.seq, args.batch)
    grad = {"zero": "reduce_scatter_zero"}.get(args.plan, "all_reduce")
    pcfg = ParallelConfig(remat="none", fsdp_params=False, grad_reduce=grad)
    # warmup must fit inside short smoke runs (the fault-injection run does
    # 8 steps) or the effective lr never leaves the ramp and the loss plateaus
    warmup = max(1, min(10, args.steps // 4))
    tcfg = TrainConfig(lr=args.lr, warmup_steps=warmup, total_steps=args.steps,
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir, z_loss=0.0)
    train_step = S.make_train_step(cfg, pcfg, tcfg, None)

    def build(start_step: int):
        if ckpt.latest_step(args.ckpt_dir):
            like = S.abstract_train_state(cfg, pcfg)
            state = ckpt.restore_checkpoint(args.ckpt_dir, start_step, like, device=device)
        else:
            gen = torch.Generator(device=device).manual_seed(tcfg.seed)
            state = S.init_train_state(gen, cfg, pcfg)
        batches = make_batch_iterator(cfg, shape, seed=tcfg.seed, start_step=start_step,
                                      device=device)
        return state, train_step, batches

    runner = TrainingRunner(directory=args.ckpt_dir, build=build,
                            checkpoint_every=args.ckpt_every)
    t0 = time.time()
    state, history = runner.run(args.steps, inject_fault_at=args.inject_fault_at)
    dt = time.time() - t0
    losses = [h["loss"] for h in history]
    print(f"\ntrained {len(history)} steps on {device} in {dt:.1f}s "
          f"({dt / max(len(history), 1):.3f}s/step)")
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("loss did not decrease")
    print("OK", flush=True)
    return state, history


if __name__ == "__main__":
    main()
