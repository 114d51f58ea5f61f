"""Learning-rate schedules (pure functions of the step).

The port of the reference's ``optim/schedule.py``, in Python floats: the
step is a host integer here (the reference traces it as an int32 array).
"""
from __future__ import annotations

import math

__all__ = ["linear_warmup", "cosine_schedule"]


def linear_warmup(step: int, warmup_steps: int, peak: float) -> float:
    return peak * min(1.0, (step + 1) / max(warmup_steps, 1))


def cosine_schedule(step: int, *, peak: float, warmup_steps: int,
                    total_steps: int, floor: float = 0.1) -> float:
    """Linear warmup then cosine decay to ``floor * peak``."""
    if step < warmup_steps:
        return linear_warmup(step, warmup_steps, peak)
    t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))
