"""Learning-rate schedules: the port of the JAX package's
``train/schedule.py``."""
from __future__ import annotations

import math

import torch


def lr_schedule(
    step,
    *,
    peak: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    min_ratio: float = 0.1,
) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_ratio*peak, in float32.
    ``step`` is a number or a 0-d tensor; the result is a 0-d float32
    tensor on the step's device (the CPU for a number)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak * s / max(warmup_steps, 1)
    prog = torch.clamp(
        (s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak * (min_ratio + (1 - min_ratio) * 0.5
                  * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)


__all__ = ["lr_schedule"]
