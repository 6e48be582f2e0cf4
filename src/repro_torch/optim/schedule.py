"""LR schedules (pure functions of the step)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine decay to
    ``min_ratio * lr`` at ``total_steps``.  ``step`` is an int or an int
    tensor; the result is a 0-d f32 tensor on the step's device, computed in
    f32 as the JAX package computes it."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = lr * (s + 1.0) / max(warmup_steps, 1)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup_steps, warm, cos)
