"""Fault tolerance & elasticity: the JAX package's crash-only runner.

* **Checkpoint/restart** is the recovery primitive.  Steps are fenced by
  atomic checkpoint commits (checkpoint/store.py); the data pipeline is a
  pure function of (seed, step) (data/pipeline.py) -- so a restart resumes
  from the last commit on the same batches.  ``TrainingRunner.run`` is a
  crash-only loop: a ``RuntimeError`` (a CUDA error is one) falls back to
  restore-latest-and-continue, bounded by ``max_restarts``.  On the CPU the
  resumed run is bitwise the uninterrupted one; on the card too under
  ``torch.use_deterministic_algorithms(True)`` (the embedding's backward
  otherwise accumulates with atomics).

* **Straggler mitigation**: a straggling device stalls the whole
  synchronous step, so mitigation is detect-and-evict.  ``StepWatchdog``
  tracks a robust step-time estimate (median + MAD); a step exceeding ``k``
  MADs raises a straggler event, and the runner responds by restarting
  from the last commit.

* **Elastic scaling**: ``ElasticPlan`` recomputes the (data, model) shape
  for a new device count.  Checkpoints hold whole logical arrays, so a
  resize needs no format change.  The plan is a plain description
  (``MeshPlan``); ``launch.mesh.make_local_mesh`` builds the mesh.

* **On the ranks of a mesh** every rank runs the same loop: the
  checkpointer is a ``ShardedCheckpointer`` (one writer; its ``wait`` is a
  fence, so every rank restores the same step), a straggler verdict is
  agreed across the ranks (``agree``) before anyone acts on it, and an
  error of the process group itself (a collective's timeout, a lost rank)
  is never recovered from: it ends the run, and the launch fails.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch import checkpoint as ckpt


class StepWatchdog:
    """Robust step-time anomaly detector (median + k·MAD)."""

    def __init__(self, k: float = 6.0, window: int = 50, min_steps: int = 10):
        self.k, self.window, self.min_steps = k, window, min_steps
        self.times: List[float] = []

    def observe(self, dt: float) -> bool:
        """Record a step time; returns True if it's a straggler event."""
        self.times.append(dt)
        self.times = self.times[-self.window:]
        if len(self.times) < self.min_steps:
            return False
        med = float(np.median(self.times))
        mad = float(np.median(np.abs(np.array(self.times) - med))) + 1e-9
        return dt > med + self.k * mad


@dataclass(frozen=True)
class MeshPlan:
    """A (data, model) device layout: ``shape`` maps axis name to extent,
    ``devices`` the devices it uses (None: unspecified)."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    devices: Optional[tuple] = None


@dataclass
class ElasticPlan:
    """Mesh plan for a given healthy-device count."""
    model: int = 16
    min_data: int = 1

    def mesh_for(self, n_chips: int, devices: Optional[Sequence] = None) -> MeshPlan:
        data = max(self.min_data, n_chips // self.model)
        if devices is not None:
            devices = tuple(devices[: data * self.model])
        return MeshPlan(shape={"data": data, "model": self.model},
                        axis_names=("data", "model"), devices=devices)


@dataclass
class TrainingRunner:
    """Crash-only training loop: restore -> run -> (fault) -> restore -> ...

    ``build`` re-creates (state, step_fn, batch_iter) from a step index --
    called at start and after every recovery, so the state and the data
    stream are always reconstructed from durable state only.
    """
    directory: str
    build: Callable[[int], tuple]           # step -> (state, step_fn, batches)
    checkpoint_every: int = 100
    max_restarts: int = 3
    watchdog: StepWatchdog = field(default_factory=StepWatchdog)
    # ranks of a mesh: the checkpointer (default: AsyncCheckpointer of
    # ``directory``) and the ranks' common verdict on a local flag
    checkpointer: Optional[Callable[[], object]] = None
    agree: Callable[[bool], bool] = bool

    def run(self, total_steps: int, *, inject_fault_at: Optional[int] = None):
        """Returns (final_state, metrics_history).  ``inject_fault_at`` is the
        test hook proving recovery."""
        restarts = 0
        history = []
        saver = self.checkpointer() if self.checkpointer else \
            ckpt.AsyncCheckpointer(self.directory)
        while True:
            start = ckpt.latest_step(self.directory) or 0
            state, step_fn, batches = self.build(start)
            step = start
            try:
                for batch in batches:
                    if step >= total_steps:
                        saver.wait()
                        return state, history
                    t0 = time.perf_counter()
                    if inject_fault_at is not None and step == inject_fault_at:
                        inject_fault_at = None  # fire once
                        raise RuntimeError("injected node failure")
                    state, metrics = step_fn(state, batch)
                    # float() waits for the device (JAX: block_until_ready)
                    row = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    straggler = self.agree(self.watchdog.observe(dt))
                    history.append({"step": step, "time_s": dt, **row})
                    step += 1
                    if step % self.checkpoint_every == 0:
                        saver.save(step, state)
                    if straggler:
                        raise RuntimeError(f"straggler step {step - 1}: {dt:.3f}s")
            except RuntimeError as e:   # torch.cuda.CudaError and OutOfMemoryError are ones
                if isinstance(e, dist.DistError):
                    raise                # the group is broken: no rank goes on
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                saver.wait()
                # recovery: loop re-enters, restores latest commit, rebuilds
                continue
