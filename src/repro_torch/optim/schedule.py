"""Learning-rate schedules as plain ``step -> lr`` functions (port of
``repro.optim.schedule``); the value is a Python float."""

from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def linear_warmup(peak_lr: float, warmup_steps: int):
    def fn(step):
        return peak_lr * min(1.0, (step + 1.0) / max(warmup_steps, 1))
    return fn


def cosine_decay(peak_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return peak_lr * (final_frac + (1.0 - final_frac) * cos)
    return fn


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup into cosine decay."""
    def fn(step):
        if step < warmup_steps:
            return peak_lr * (step + 1.0) / max(warmup_steps, 1)
        frac = min(max((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return peak_lr * (final_frac + (1.0 - final_frac)
                          * 0.5 * (1.0 + math.cos(math.pi * frac)))
    return fn
