"""Qwen3-30B-A3B — 128-expert top-8 MoE with qk-norm.

[hf:Qwen/Qwen3-30B-A3B; hf]  48L d_model=2048 32H (GQA kv=4, head_dim 128)
expert d_ff=768, vocab=151936, 128 experts top-8, no shared expert.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    block="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    d_ff_expert=768,
    n_experts=128,
    top_k=8,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)
