"""Learning-rate schedules (pure functions of the step): the port of
``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to `base_lr` over `warmup_steps`, then a cosine decay
    to ``final_frac * base_lr`` at `total_steps`; a 0-d float32 tensor on
    the step's device."""
    step = torch.as_tensor(step).float()
    warm = base_lr * step / max(warmup_steps, 1)
    t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = base_lr * (final_frac
                     + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)
