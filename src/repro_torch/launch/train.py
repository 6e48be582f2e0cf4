"""Training launcher: the end-to-end entry point (the paper's example application (b)).

Trains an arch of any family -- on the card unless ``--device cpu`` --
with the JAX launcher's flags, defaults and loss check (an enc-dec arch
reads the pipeline's stub ``frames``):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch chatglm3-6b --steps 8 --batch 2 --seq 64 --ckpt-every 3 \
      --ckpt-dir "$TMPDIR/ck" --inject-fault-at 5

``--ranks p`` is the port's counterpart of the reference's device count:
p gloo rank processes (``core.mesh.launch``; all on ``cuda:0``, or on the
CPU) over the mesh ``(p / model, model)`` of ``launch.mesh.make_local_mesh``
with ``--model-parallel model``, each running ``train_rank``, the per-rank
body, under a mesh ctx:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --ranks 4 \
      --model-parallel 2 --plan auto --steps 8 --ckpt-every 3 \
      --ckpt-dir "$TMPDIR/ck" --inject-fault-at 5

``--plan auto`` runs the cost model's ``plan_search`` on that mesh (H100
constants) and prints the plan it picks and its predicted step time;
``zero`` / ``allreduce`` pin the gradient strategy of the default layout.
``--reduce`` (on by default) shrinks the arch to its CPU-sized form
(``configs.reduced``).  Fault tolerance is on by default: step-fenced
checkpoints of full leaves (one writer) and a crash-only restart loop on
every rank (runtime/recovery.py); ``--inject-fault-at N`` fires on every
rank at step N.  A ``--ckpt-dir`` that already holds checkpoints is resumed
from, whatever the number of ranks that wrote it, so start a fresh run in
an empty one.  Each rank runs under the launching process's
deterministic-algorithms setting.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.config import ModelConfig, ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.core.mesh import launch, local_block
from repro_torch.data import make_batch_iterator
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.parallel import planner
from repro_torch.parallel import steps as S
from repro_torch.parallel.sharding import make_ctx
from repro_torch.runtime import TrainingRunner
from repro_torch.tree import leaves_with_path, tree_map


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduce", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--plan", default="default",
                    choices=["default", "auto", "zero", "allreduce"],
                    help="parallel layout: 'auto' runs the cost-model plan_search on "
                         "the rank mesh; zero/allreduce pin the gradient strategy "
                         "('zero' takes the single-device step on one rank, as the "
                         "JAX launcher does on one device)")
    # 3e-3 (with the seeded init/data below) descends within even 8-step
    # smoke runs; 1e-3 needs tens of steps to clear the warmup ramp
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ranks", type=int, default=1,
                    help="gloo rank processes (the reference's device count)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'; there is no fallback")
    return ap.parse_args(argv)


@dataclasses.dataclass(frozen=True)
class RankJob:
    """What every rank trains: sent to each rank process (so it pickles)."""
    cfg: ModelConfig
    pcfg: ParallelConfig
    tcfg: TrainConfig
    shape: ShapeConfig
    steps: int
    model_parallel: int = 1
    inject_fault_at: Optional[int] = None
    deterministic: bool = False
    return_state: bool = True      # the rank's final blocks, in its result


def _host(t: torch.Tensor) -> torch.Tensor:
    # a result crosses to the launching process as numpy, which has no bf16
    return t.detach().float() if t.dtype == torch.bfloat16 else t.detach()


def train_rank(device, job: RankJob) -> dict:
    """The per-rank body: trains ``job`` with the crash-only runner, under a
    mesh ctx when the rank is one of a launched group (else on one device,
    with no ctx, as the reference does on one device).  Returns the metrics
    history (with each step's bytes staged through the host, under a
    mesh, and the host seconds spent inside its collectives), the peak
    device memory (CUDA) and, with ``job.return_state``,
    the rank's final state blocks."""
    if job.deterministic:
        torch.use_deterministic_algorithms(True)
    device = torch.device(device)
    cfg, pcfg, tcfg = job.cfg, job.pcfg, job.tcfg
    directory = tcfg.checkpoint_dir
    ctx = mesh = specs = None
    if dist.is_initialized():
        mesh = make_local_mesh(job.model_parallel)
        ctx = make_ctx(mesh, pcfg)
    train_step = S.make_train_step(cfg, pcfg, tcfg, ctx)
    like = S.abstract_train_state(cfg, pcfg)
    transform = rows = None
    if ctx is not None:
        specs = S.train_state_shardings(cfg, pcfg, ctx, like)
        by_path = dict(leaves_with_path(specs))
        transform = lambda path, t: local_block(t, by_path[path], mesh).clone()
        rows = (mesh.index(ctx.batch_axes), mesh.size(ctx.batch_axes))

    def step_fn(state, batch):
        if mesh is None:
            return train_step(state, batch)
        staged, comm = mesh.staged_bytes, mesh.comm_seconds
        state, metrics = train_step(state, batch)
        metrics["staged_bytes"] = mesh.staged_bytes - staged
        metrics["comm_s"] = mesh.comm_seconds - comm
        return state, metrics

    def build(start_step: int):
        if ckpt.latest_step(directory):
            state = ckpt.restore_checkpoint(directory, start_step, like, device=device,
                                            transform=transform)
        else:
            gen = torch.Generator(device=device).manual_seed(tcfg.seed)
            state = S.init_train_state(gen, cfg, pcfg, ctx)
        batches = make_batch_iterator(cfg, job.shape, seed=tcfg.seed, start_step=start_step,
                                      device=device, shard=rows)
        return state, step_fn, batches

    runner = TrainingRunner(directory=directory, build=build,
                            checkpoint_every=tcfg.checkpoint_every)
    if ctx is not None:
        runner.checkpointer = lambda: ckpt.ShardedCheckpointer(directory, mesh, specs)
        axes = mesh.axis_names
        runner.agree = lambda flag: bool(mesh.all_reduce(torch.tensor([float(flag)]),
                                                         "max", axes)[0])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state, history = runner.run(job.steps, inject_fault_at=job.inject_fault_at)
    out = {"history": history,
           "peak_bytes": torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else None}
    if job.return_state:
        out["state"] = tree_map(_host, state)
    return out


def make_job(args: argparse.Namespace) -> RankJob:
    """The job the flags describe; with ``--plan auto`` prints the plan the
    cost model picks on the rank mesh and its predicted step time."""
    if args.ranks < 1 or args.model_parallel < 1 or args.ranks % args.model_parallel:
        raise ValueError(f"--model-parallel {args.model_parallel} must divide --ranks "
                         f"{args.ranks}")
    cfg = configs.get(args.arch)
    if args.reduce:
        cfg = configs.reduced(cfg)
    shape = ShapeConfig("train_cli", "train", args.seq, args.batch)
    if args.plan == "auto":
        # cost-driven layout on the rank mesh (a ParallelPlan ranked by the
        # Table-1 step model on H100 constants); the top feasible point wins
        mesh_shape = (args.ranks // args.model_parallel, args.model_parallel)
        ranked = planner.plan_search(cfg, mesh_shape, args.batch, args.seq, "train",
                                     axis_names=("data", "model"))
        plan = planner.best_plan(ranked)   # the f32-moments numerics guard
        top = next(r for r in ranked if r.plan is plan)
        print(f"plan_search picked: {plan.label()} (predicted {top.total_s * 1e3:.4g} "
              f"ms/step on H100 constants)", flush=True)
        pcfg = plan.to_pcfg()
    else:
        grad = {"zero": "reduce_scatter_zero"}.get(args.plan, "all_reduce")
        pcfg = ParallelConfig(remat="none", fsdp_params=False, grad_reduce=grad)
    # warmup must fit inside short smoke runs (the fault-injection run does
    # 8 steps) or the effective lr never leaves the ramp and the loss plateaus
    warmup = max(1, min(10, args.steps // 4))
    tcfg = TrainConfig(lr=args.lr, warmup_steps=warmup, total_steps=args.steps,
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir, z_loss=0.0)
    return RankJob(cfg, pcfg, tcfg, shape, args.steps, model_parallel=args.model_parallel,
                   inject_fault_at=args.inject_fault_at,
                   deterministic=torch.are_deterministic_algorithms_enabled())


def main(argv=None):
    """Runs the launcher.  Returns (final state, metrics history); with
    ``--ranks p`` > 1 the state is the list of the p ranks' final blocks
    (numpy), and the history rank 0's."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is visible; "
                           "pass --device cpu to train on the CPU")
    job = make_job(args)
    t0 = time.time()
    if args.ranks == 1:
        out = train_rank(device, job)
        state = out["state"]
    else:
        outs = launch(args.ranks, train_rank, job, device=args.device, timeout=1800)
        out, state = outs[0], [o["state"] for o in outs]
    dt = time.time() - t0
    history = out["history"]
    losses = [h["loss"] for h in history]
    print(f"\ntrained {len(history)} steps on {args.ranks} x {device} in {dt:.1f}s "
          f"({dt / max(len(history), 1):.3f}s/step)")
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("loss did not decrease")
    print("OK", flush=True)
    return state, history


if __name__ == "__main__":
    main()
