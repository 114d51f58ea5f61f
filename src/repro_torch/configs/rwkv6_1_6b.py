"""RWKV6 "Finch" 1.6B — attention-free, data-dependent decay.

[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536.
Head size 64 (RWKV convention) -> 32 heads.  The WKV recurrence is the most
direct beneficiary of the paper's streaming optimization (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    block="rwkv",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    pos_emb="none",
    gated=False,
    tie_embeddings=False,
    source="arXiv:2404.05892",
)
