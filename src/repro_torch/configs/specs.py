"""Input stand-ins per (arch x shape) cell, on the ``meta`` device.

The port of the reference's ``configs/specs.py``, for what has a meaning
without a mesh: the modality stubs' shapes and dtype (:func:`extra_specs`)
and each cell's step inputs (:func:`input_specs`) as
``torch.empty(..., device="meta")`` tensors, which hold a shape and a dtype
and allocate nothing.  ``kind``:
  * train   — the loss's inputs: a token batch (+ modality stubs)
  * prefill — ``serve_prefill``'s inputs: the full prompt (+ modality stubs)
  * decode  — ``serve_step``'s inputs: one token, a cache of ``seq_len``
              slots and the position index
Token ids are int64, as the port's entry points take them (the reference's
are int32).  The reference's PartitionSpecs (``_extra_pspecs``, the second
half of ``input_specs``' result) and ``cache_specs`` place arrays on a mesh;
they wait for ROADMAP.md queue 1 item 14 (distributed).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models.layers import dtype_of

__all__ = ["input_specs", "extra_specs"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def extra_specs(cfg: ArchConfig, batch: int):
    """Modality-stub inputs (precomputed embeddings) in the compute dtype,
    or None: ``img_embeds`` (batch, img_tokens, d) for llava,
    ``audio_embeds`` (batch, audio_ctx, d) for whisper."""
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.img_tokens:
        return {"img_embeds": _meta((batch, cfg.img_tokens, cfg.d_model),
                                    cdt)}
    if cfg.enc_layers:
        return {"audio_embeds": _meta((batch, cfg.audio_ctx, cfg.d_model),
                                      cdt)}
    return None


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """The cell's step-function inputs as meta tensors, keyed like the
    step functions' arguments (``launch/steps.py``).  A decode cell's cache
    is the port's: one dict a layer (``models.model.init_cache``)."""
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        text = S - (cfg.img_tokens or 0)
        return {"batch": {"tokens": _meta((B, text + 1), torch.long)},
                "extra": extra_specs(cfg, B)}
    if cell.kind == "prefill":
        text = S - (cfg.img_tokens or 0)
        return {"tokens": _meta((B, text), torch.long),
                "extra": extra_specs(cfg, B)}
    if cell.kind == "decode":
        from repro_torch.models import model as M

        return {"tokens": _meta((B, 1), torch.long),
                "cache": M.init_cache(cfg, B, S, device="meta"),
                "index": _meta((), torch.long)}
    raise ValueError(cell.kind)
