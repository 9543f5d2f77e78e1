"""Learning-rate schedules: functions of an int32 step-count tensor.

Counterpart of ``repro.optim.schedules``; each returns an f32 tensor of the
count's shape (a scalar, or ``[K]`` for a stacked federation's counters).
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def constant(value: float):
    def sched(count: Tensor) -> Tensor:
        return torch.full(count.shape, value, dtype=torch.float32, device=count.device)
    return sched


def cosine(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    def sched(count: Tensor) -> Tensor:
        c = count.to(torch.float32)
        warm = peak * c / max(warmup_steps, 1)
        frac = torch.clamp((c - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(c < warmup_steps, warm, cos)
    return sched


def inverse_sqrt(peak: float, warmup_steps: int):
    def sched(count: Tensor) -> Tensor:
        c = torch.clamp(count.to(torch.float32), min=1.0)
        w = torch.tensor(float(max(warmup_steps, 1)), dtype=torch.float32, device=c.device)
        return peak * torch.minimum(c / w, torch.sqrt(w / c))
    return sched


def step_decay(base: float, decay: float, every: int):
    def sched(count: Tensor) -> Tensor:
        k = torch.div(count, every, rounding_mode="floor").to(torch.float32)
        return base * torch.pow(torch.tensor(decay, dtype=torch.float32, device=k.device), k)
    return sched
