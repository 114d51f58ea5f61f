"""Configurations of the port: the Nekbone cases (``configs/nekbone.py``)
and the LM architectures ported so far (``ARCHS`` / :func:`get`).

The reference registers ten LM architectures; the port holds the four whose
serving path it runs: rwkv6-1.6b, gemma2-27b, nemotron-4-340b and
hymba-1.5b.  The others (the moe models, whisper, llava and the remaining
dense models) come with the rest of the LM substrate, ROADMAP.md queue 1
item 3.
"""
from __future__ import annotations

from repro_torch.configs import (gemma2_27b, hymba_1_5b, nemotron_4_340b,
                                 rwkv6_1_6b)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell

__all__ = ["ARCHS", "get", "SHAPES", "ArchConfig", "ShapeCell"]

ARCHS: dict[str, ArchConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (rwkv6_1_6b, gemma2_27b, nemotron_4_340b, hymba_1_5b)}


def get(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise NotImplementedError(
            f"arch {name!r} is not ported; the port has {sorted(ARCHS)}. "
            "The other architectures come with the rest of the LM "
            "substrate (ROADMAP.md queue 1 item 3)") from None
