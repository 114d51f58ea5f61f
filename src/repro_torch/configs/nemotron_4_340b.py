"""Nemotron-4 340B — GQA + squared-ReLU MLP, the largest assigned arch.

[arXiv:2402.16819; unverified]  96L d_model=18432 96H (GQA kv=8)
d_ff=73728 vocab=256000.  Non-gated squared-ReLU MLP, LayerNorm,
head_dim = 192.  FSDP spans pod+data for this arch (3.4e11 params).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    act="relu2",
    gated=False,
    norm="layernorm",
    # 3.4e11 params: bf16 storage + bf16 Adam moments + pod-spanning FSDP
    # keep the per-chip footprint inside 16 GB HBM (DESIGN.md §3).
    param_dtype="bfloat16",
    opt_moment_dtype="bfloat16",
    source="arXiv:2402.16819",
)
