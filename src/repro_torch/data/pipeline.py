"""Deterministic synthetic token pipeline.

Every batch is a pure function of (seed, step) -- this is what makes
checkpoint/restart bitwise reproducible (runtime/recovery.py): after a
restart at step k the stream continues exactly where it left off.  The
batches are the JAX package's, bit for bit: ``SyntheticTokens`` is its
numpy generator, copied.

Per-process slicing: with ``torch.distributed`` initialised, each process
takes its slice of the global batch by rank (global row indices, so an
elastic resize keeps the global batch's content); otherwise the slice is
the whole batch.  ``shard=(index, count)`` names the slice instead: a rank
of a mesh takes its index over the batch axes, so the ranks of one
``model`` group read the same rows.  Tokens land on the caller's device as int32.

A background thread prefetches ``prefetch`` batches ahead; an error it\nmeets is raised in the consumer.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeConfig


@dataclass
class SyntheticTokens:
    """Markov-ish synthetic LM data: deterministic, seeded, non-trivial
    (next-token structure exists, so loss decreases measurably)."""
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int, lo: int | None = None, hi: int | None = None) -> np.ndarray:
        lo = 0 if lo is None else lo
        hi = self.global_batch if hi is None else hi
        # per-row generators keyed by global row index => elastic-safe
        rows = []
        for r in range(lo, hi):
            rr = np.random.Generator(np.random.Philox(key=(self.seed << 1) ^ (step << 20) ^ r))
            base = rr.integers(0, self.vocab, size=self.seq_len // 2, dtype=np.int32)
            # structure: every token repeated twice (learnable bigram rule)
            row = np.repeat(base, 2)[: self.seq_len]
            noise = rr.random(self.seq_len) < 0.1
            row = np.where(noise, rr.integers(0, self.vocab, self.seq_len), row)
            rows.append(row.astype(np.int32))
        return np.stack(rows)


def _process_slice(global_batch: int, shard: Optional[Tuple[int, int]] = None):
    dist = torch.distributed
    if shard is not None:
        pidx, n_proc = shard
    else:
        n_proc, pidx = ((dist.get_world_size(), dist.get_rank())
                        if dist.is_available() and dist.is_initialized() else (1, 0))
    if global_batch % n_proc:
        raise ValueError(f"global batch {global_batch} does not split {n_proc} ways")
    per = global_batch // n_proc
    return pidx * per, (pidx + 1) * per


def make_batch_iterator(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                        start_step: int = 0, prefetch: int = 2,
                        frames_dim: Optional[int] = None,
                        device="cuda",
                        shard: Optional[Tuple[int, int]] = None) -> Iterator[dict]:
    """Yields {'tokens': (B, S) int32} (+ 'frames' (B, F, d) f32 for enc-dec)
    on ``device``: this process's rows, or slice ``shard = (index, count)``."""
    ds = SyntheticTokens(cfg.vocab, shape.seq_len, shape.global_batch, seed)
    lo, hi = _process_slice(shape.global_batch, shard)

    def produce(step: int) -> dict:
        out = {"tokens": torch.from_numpy(ds.batch_at(step, lo, hi)).to(device)}
        if cfg.enc_dec:
            rng = np.random.Generator(np.random.Philox(key=seed ^ (step << 21)))
            fr = rng.standard_normal((hi - lo, frames_dim or 1500, cfg.d_model),
                                     dtype=np.float32)
            out["frames"] = torch.from_numpy(fr).to(device)
        return out

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def worker():
        step = start_step
        try:
            while not stop.is_set():
                put(produce(step))
                step += 1
        except Exception as e:   # handed to the consumer, which raises it
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
