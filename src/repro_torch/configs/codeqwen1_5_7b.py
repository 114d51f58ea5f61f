"""CodeQwen1.5 7B — qwen1.5 architecture (MHA, QKV bias).

[hf:Qwen/CodeQwen1.5-7B; hf]  32L d_model=4096 32H (GQA kv=32 = MHA)
d_ff=13440 vocab=92416.  SiLU-gated MLP, RoPE theta 1e6 (64k context).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/CodeQwen1.5-7B",
)
