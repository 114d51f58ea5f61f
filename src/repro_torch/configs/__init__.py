"""Configurations of the port: the Nekbone cases (``configs/nekbone.py``)
and the reference's ten LM architectures (``ARCHS`` / :func:`get`), in the
reference's order, each a verbatim copy of the reference's config.

The serving path (``launch/serve.py``) and the training path
(``launch/train.py``) run all ten; ``configs/specs.py`` gives each cell's
inputs and their partition specs on a mesh.
"""
from __future__ import annotations

from repro_torch.configs import (arctic_480b, codeqwen1_5_7b, gemma2_27b,
                                 hymba_1_5b, llava_next_mistral_7b,
                                 nemotron_4_340b, qwen2_5_14b,
                                 qwen3_moe_30b_a3b, rwkv6_1_6b,
                                 whisper_large_v3)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell

__all__ = ["ARCHS", "get", "SHAPES", "ArchConfig", "ShapeCell"]

ARCHS: dict[str, ArchConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (rwkv6_1_6b, gemma2_27b, codeqwen1_5_7b, nemotron_4_340b,
              qwen2_5_14b, llava_next_mistral_7b, whisper_large_v3,
              qwen3_moe_30b_a3b, arctic_480b, hymba_1_5b)}


def get(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}") from None
