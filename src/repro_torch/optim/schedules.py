"""Learning-rate schedules as step -> lr callables (counterpart of
`repro/optim/schedules.py`); `step` is a number or a tensor, the result
an f32 tensor."""
from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine_decay(lr: float, steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)

    return f


def warmup_cosine(lr: float, warmup: int, steps: int,
                  final_frac: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(steps - warmup, 1), 0.0, 1.0)
        cos = lr * (final_frac + (1 - final_frac) * 0.5
                    * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return f
