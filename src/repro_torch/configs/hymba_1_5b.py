"""Hymba 1.5B — hybrid: attention heads and Mamba heads in parallel.

[arXiv:2411.13676; hf]  32L d_model=1600 25H (GQA kv=5, head_dim 64)
d_ff=5504 vocab=32001 ssm_state=16.  Most layers use sliding-window
attention (1024); layers {0, 16, 31} are global — pattern below.  The SSM
path runs in parallel with attention in every block, outputs mean-combined
after per-path normalization.
"""
from repro_torch.configs.base import ArchConfig

_WINDOWS = tuple(0 if i in (0, 16, 31) else 1024 for i in range(32))

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    block="hymba",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    windows=_WINDOWS,
    source="arXiv:2411.13676",
)
