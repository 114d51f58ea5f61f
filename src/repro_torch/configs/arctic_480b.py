"""Snowflake Arctic 480B — dense-MoE hybrid: 128-expert top-2 MoE with a
parallel dense residual MLP in every layer.

[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (GQA kv=8)
d_ff=4864 (both the dense residual and each expert), 128 experts top-2,
vocab=32000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    block="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    d_ff_expert=4864,
    n_experts=128,
    top_k=2,
    dense_residual=True,
    vocab=32000,
    # 4.7e11 params: bf16 storage + bf16 Adam moments (DESIGN.md §3).
    param_dtype="bfloat16",
    opt_moment_dtype="bfloat16",
    source="hf:Snowflake/snowflake-arctic-base",
)
