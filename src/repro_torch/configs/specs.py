"""Input stand-ins and their partition specs per (arch x shape) cell.

The port of the reference's ``configs/specs.py``.  The modality stubs'
shapes and dtype (:func:`extra_specs`) and each cell's step inputs
(:func:`input_specs`) are ``torch.empty(..., device="meta")`` tensors,
which hold a shape and a dtype and allocate nothing.  ``kind``:
  * train   — the loss's inputs: a token batch (+ modality stubs)
  * prefill — ``serve_prefill``'s inputs: the full prompt (+ modality stubs)
  * decode  — ``serve_step``'s inputs: one token, a cache of ``seq_len``
              slots and the position index
Token ids are int64, as the port's entry points take them (the reference's
are int32).  The reference's ``input_specs`` returns the inputs and their
PartitionSpecs together; here :func:`input_pspecs` returns the specs
(``distributed/sharding.P``) keyed as :func:`input_specs` keys the inputs,
and :func:`cache_specs` specs a decode cache, one dict a layer (the port's
cache layout), each spec the reference's less its leading layer axis.
``long_500k`` (batch 1) marks the cache context-parallel: its sequence axis
is sharded over ``data``.  ``mesh`` is a ``DeviceMesh`` or an
``AbstractMesh``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed.sharding import RULES, P, mesh_axes
from repro_torch.models.layers import dtype_of

__all__ = ["input_specs", "input_pspecs", "cache_specs", "extra_specs"]


def _div(mesh, dim, axes):
    if axes is None or mesh is None:
        return None
    sizes = mesh_axes(mesh)
    ax = (axes,) if isinstance(axes, str) else tuple(axes)
    sz = 1
    for a in ax:
        sz *= sizes.get(a, 1)
    return axes if (sz > 1 and dim % sz == 0) else None


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


def _extra_pspecs(extra, mesh):
    if extra is None:
        return None
    return {k: P(_div(mesh, v.shape[0], RULES.dp), None, None)
            for k, v in extra.items()}


def cache_specs(cfg: ArchConfig, cache, mesh, *,
                context_parallel: bool) -> list[dict]:
    """Specs of a decode cache (``models.model.init_cache``, built without
    a mesh: the global shapes), one ``{name: P}`` a layer."""

    def spec_for(name, shape):
        B = shape[0]
        dp = _div(mesh, B, RULES.dp)
        if name in ("k", "v"):
            Hkv, S = shape[1], shape[2]
            if context_parallel:
                return P(None, _div(mesh, Hkv, RULES.tp),
                         _div(mesh, S, RULES.seq), None)
            tp_h = _div(mesh, Hkv, RULES.tp)
            if tp_h is None:          # kv heads < TP degree: shard sequence
                return P(dp, None, _div(mesh, S, RULES.tp), None)
            return P(dp, tp_h, None, None)
        if name in ("xk", "xv"):
            return P(dp, _div(mesh, shape[1], RULES.tp), None, None)
        if name == "state":           # rwkv (B, H, hd, hd)
            return P(dp, _div(mesh, shape[1], RULES.tp), None, None)
        if name in ("tm_x", "cm_x"):
            return P(dp, None, None)
        if name == "conv":            # (B, K-1, di)
            return P(dp, None, _div(mesh, shape[2], RULES.tp))
        if name == "h":               # (B, di, n)
            return P(dp, _div(mesh, shape[1], RULES.tp), None)
        return P(*([None] * len(shape)))

    return [{name: spec_for(name, t.shape) for name, t in layer.items()}
            for layer in cache]


def input_pspecs(cfg: ArchConfig, cell: ShapeCell, mesh=None) -> dict:
    """The specs of :func:`input_specs`' inputs, keyed the same way (the
    second half of the reference's ``input_specs``)."""
    B, S = cell.global_batch, cell.seq_len
    dp = _div(mesh, B, RULES.dp)
    inputs = input_specs(cfg, cell)
    if cell.kind == "train":
        return {"batch": {"tokens": P(dp, None)},
                "extra": _extra_pspecs(inputs["extra"], mesh)}
    if cell.kind == "prefill":
        return {"tokens": P(dp, None),
                "extra": _extra_pspecs(inputs["extra"], mesh)}
    if cell.kind == "decode":
        cp = cell.name == "long_500k"
        return {"tokens": P(dp, None),
                "cache": cache_specs(cfg, inputs["cache"], mesh,
                                     context_parallel=cp),
                "index": P()}
    raise ValueError(cell.kind)
