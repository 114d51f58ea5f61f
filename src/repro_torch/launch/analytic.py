"""Analytic per-cell cost model: MODEL_FLOPS and minimal HBM traffic.

The port of the reference's ``launch/analytic.py`` (numpy only): the
roofline's "useful work" reference (MODEL_FLOPS = 6·N·D dense,
6·N_active·D MoE) and its memory-term floor, which ``launch/dryrun.py``
records beside the FLOPs it counts and ``launch/roofline.py`` reads.

Conventions (the reference's):
  * train  : 6 * N_active * tokens  + attention term 12 * L * S^2 * d_attn
             (causal halves the S^2 term; remat's forward repeat is not
             counted)
  * prefill: 2 * N_active * tokens  + 2 * L * S^2 * d_attn (causal halved)
  * decode : 2 * N_active * B       + 4 * B * L * S_cache * kv_width
Memory floor:
  * train  : params read (fwd+bwd) + grads + moments r/w + activation stream
  * prefill: params once + KV cache write + activation stream
  * decode : params once + KV cache read (the long-context wall); rwkv's
             recurrent state instead of a KV cache
Everything is *per device* given the mesh size.  :func:`train_model_flops`
and :func:`train_mfu` read :func:`cell_cost`, the trainer's MFU against the
H100's dense bf16 tensor-core peak.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeCell

__all__ = ["CellCost", "cell_cost", "H100_BF16_PEAK", "train_model_flops",
           "train_mfu"]

# H100 SXM data sheet: dense bf16 on the tensor cores (the peak K13's bound
# reads against in chip_smoke.py)
H100_BF16_PEAK = 989e12


@dataclasses.dataclass(frozen=True)
class CellCost:
    model_flops_total: float      # whole step, all devices
    model_flops_per_dev: float
    hbm_bytes_per_dev: float      # analytic floor
    attn_flops_total: float
    notes: str = ""


def _dtype_bytes(name: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[name]


def cell_cost(cfg: ArchConfig, cell: ShapeCell, n_devices: int,
              param_shards: int | None = None) -> CellCost:
    """``param_shards``: how many ways the params are sharded (serve mode
    replicates over the batch axes -> 16, not n_devices)."""
    N_act = cfg.active_param_count()
    N_tot = cfg.param_count()
    pshards = param_shards or n_devices
    L = cfg.n_layers
    pb = _dtype_bytes(cfg.param_dtype)
    cb = _dtype_bytes(cfg.compute_dtype)
    mb = _dtype_bytes(cfg.opt_moment_dtype)
    d = cfg.d_model
    B, S = cell.global_batch, cell.seq_len
    kv_width = 2 * cfg.n_kv_heads * cfg.hd          # K and V per token

    # attention flops: qk^T and pv, causal => x1/2; windowed layers bound S
    windows = np.minimum(cfg.layer_windows(), S)
    attn_ctx = float(windows.sum()) / max(L, 1)     # avg effective context

    if cell.kind == "train":
        tokens = B * S
        flops = 6.0 * N_act * tokens
        attn = 12.0 * L * cfg.n_heads * cfg.hd * tokens * attn_ctx * 0.5
        flops_total = flops + attn
        # params: read fwd + read bwd (+ remat fwd) ~ 3x; grads write +
        # read; moments read+write; master params read+write
        param_traffic = N_tot * (3 * pb + 2 * 4 + 4 * mb + 2 * pb)
        act_traffic = tokens * d * L * 12 * cb      # residual stream passes
        hbm = (param_traffic + act_traffic) / n_devices
        return CellCost(flops_total, flops_total / n_devices, hbm, attn)

    if cell.kind == "prefill":
        tokens = B * S
        flops = 2.0 * N_act * tokens
        attn = 4.0 * L * cfg.n_heads * cfg.hd * tokens * attn_ctx * 0.5
        flops_total = flops + attn
        cache_write = B * S * L * kv_width * cb
        hbm = (N_tot * pb / pshards
               + (cache_write + tokens * d * L * 6 * cb) / n_devices)
        return CellCost(flops_total, flops_total / n_devices, hbm, attn)

    # decode: one token per sequence against an S-long cache
    tokens = B
    flops = 2.0 * N_act * tokens
    if cfg.block == "rwkv":
        attn = 4.0 * B * L * cfg.n_heads * cfg.hd * cfg.hd  # state update
        cache_read = B * L * cfg.n_heads * cfg.hd * cfg.hd * 4
    else:
        attn = 4.0 * B * L * cfg.n_heads * cfg.hd * attn_ctx
        # sum over layers of min(window, S) cache entries, K+V each
        cache_read = B * float(windows.sum()) * kv_width * cb
    flops_total = flops + attn
    hbm = N_tot * pb / pshards + cache_read / n_devices
    return CellCost(flops_total, flops_total / n_devices, hbm, attn,
                    notes="cache-read dominated"
                    if cache_read / n_devices > N_tot * pb / pshards
                    else "param-read dominated")


def train_model_flops(cfg: ArchConfig, *, batch: int, seq: int) -> float:
    """MODEL_FLOPS of one training step of ``batch`` x ``seq`` tokens."""
    cell = ShapeCell("train", seq, batch, "train")
    return cell_cost(cfg, cell, 1).model_flops_total


def train_mfu(cfg: ArchConfig, *, batch: int, seq: int, step_s: float,
              peak: float = H100_BF16_PEAK) -> float:
    """MODEL_FLOPS of one training step of ``batch`` x ``seq`` tokens over
    ``step_s`` seconds, as a share of ``peak``, on one device."""
    return train_model_flops(cfg, batch=batch, seq=seq) / step_s / peak
