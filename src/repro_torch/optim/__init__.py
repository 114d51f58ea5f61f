"""Optimizer substrate (no external deps): AdamW + schedules + clipping.

The port of the reference's ``optim/``.
"""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "linear_warmup"]
