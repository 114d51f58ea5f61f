"""Configurations of the port: the Nekbone cases (``configs/nekbone.py``)
and the LM architectures ported so far (``ARCHS`` / :func:`get`).

The reference registers ten LM architectures; the port holds the two whose
serving path it runs, rwkv6-1.6b and gemma2-27b.  The others (moe, hymba,
whisper, llava and the remaining dense models) come with the rest of the LM
substrate, ROADMAP.md queue 1 item 3.
"""
from __future__ import annotations

from repro_torch.configs import gemma2_27b, rwkv6_1_6b
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell

__all__ = ["ARCHS", "get", "SHAPES", "ArchConfig", "ShapeCell"]

ARCHS: dict[str, ArchConfig] = {
    c.CONFIG.name: c.CONFIG for c in (rwkv6_1_6b, gemma2_27b)}


def get(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise NotImplementedError(
            f"arch {name!r} is not ported; the port has {sorted(ARCHS)}. "
            "The other architectures come with the rest of the LM "
            "substrate (ROADMAP.md queue 1 item 3)") from None
