"""Learning-rate schedules (``repro.optim.schedules``): step in, f32
scalar tensor out."""
from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def linear_warmup(step, warmup_steps: int):
    return torch.clamp((_f32(step) + 1) / max(1, warmup_steps), max=1.0)


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0,
                    floor: float = 0.1):
    warm = linear_warmup(step, warmup_steps)
    t = torch.clamp((_f32(step) - warmup_steps)
                    / max(1, total_steps - warmup_steps), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos
