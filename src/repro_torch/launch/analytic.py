"""MODEL_FLOPS of a training step, and the trainer's model-flops utilisation.

The port's copy of the train branch of the reference's ``launch/analytic.py``
``cell_cost`` (numpy only): 6 * N_active * tokens plus the attention term
12 * L * n_heads * hd * tokens * S, halved for causal, with each windowed
layer's S bounded by its window (remat's forward repeat is not counted).
:func:`train_mfu` reads it against the H100's dense bf16 tensor-core peak.
The reference's prefill and decode branches and its HBM floors feed its dry
run and roofline, which are XLA-only and not ported.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ArchConfig

__all__ = ["H100_BF16_PEAK", "train_model_flops", "train_mfu"]

# H100 SXM data sheet: dense bf16 on the tensor cores (the peak K13's bound
# reads against in chip_smoke.py)
H100_BF16_PEAK = 989e12


def train_model_flops(cfg: ArchConfig, *, batch: int, seq: int) -> float:
    """MODEL_FLOPS of one training step of ``batch`` x ``seq`` tokens."""
    tokens = batch * seq
    # average effective context over the layers
    attn_ctx = float(np.minimum(cfg.layer_windows(), seq).sum()) \
        / max(cfg.n_layers, 1)
    attn = 12.0 * cfg.n_layers * cfg.n_heads * cfg.hd * tokens * attn_ctx \
        * 0.5
    return 6.0 * cfg.active_param_count() * tokens + attn


def train_mfu(cfg: ArchConfig, *, batch: int, seq: int, step_s: float,
              peak: float = H100_BF16_PEAK) -> float:
    """MODEL_FLOPS of one training step of ``batch`` x ``seq`` tokens over
    ``step_s`` seconds, as a share of ``peak``, on one device."""
    return train_model_flops(cfg, batch=batch, seq=seq) / step_s / peak
