"""Gemma 2 27B — local+global alternating attention, logit soft-capping.

[arXiv:2408.00118; hf]  46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000.  Sliding window 4096 on alternating layers, attention softcap
50, final-logit softcap 30, sandwich (pre+post) norms, tied embeddings,
sqrt(d) embedding scale, gelu-gated MLP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    act="gelu",
    gated=True,
    windows=(4096, 0),
    attn_softcap=50.0,
    logit_softcap=30.0,
    sandwich_norm=True,
    scale_embed=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
