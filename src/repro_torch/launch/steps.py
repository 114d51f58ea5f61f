"""The serving step functions: prefill and one-token decode.

The port of the reference's ``launch/steps.py`` serving half: closures of
``cfg`` around ``model.prefill`` and ``model.decode_step``, for every
registered architecture (the prefill takes llava's and whisper's modality
stubs as ``extra``).  ``TrainState`` and ``make_train_step`` come with the
training path (ROADMAP.md queue 1 item 3).  PyTorch runs eagerly, so
nothing here is compiled (the reference jits these closures).
"""
from __future__ import annotations

from repro_torch.models import model as M

__all__ = ["make_serve_prefill", "make_serve_step"]


def make_serve_prefill(cfg, *, max_len: int):
    def serve_prefill(params, tokens, extra=None):
        return M.prefill(params, cfg, tokens, extra, max_len=max_len)

    return serve_prefill


def make_serve_step(cfg):
    def serve_step(params, tokens, cache, index):
        return M.decode_step(params, cfg, tokens, cache, index)

    return serve_step
