"""Learning-rate schedules (port of ``repro.optim.schedule``): functions of
a step tensor returning an fp32 tensor on its device, so the train step
never reads the step on the host."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        s = step.to(torch.float32)
        warm = peak * s / max(warmup, 1)
        prog = ((s - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return f


def warmup_linear_decay(peak: float, warmup: int, total: int):
    def f(step):
        s = step.to(torch.float32)
        warm = peak * s / max(warmup, 1)
        dec = peak * ((total - s) / max(total - warmup, 1)).clamp(0.0, 1.0)
        return torch.where(s < warmup, warm, dec)
    return f
