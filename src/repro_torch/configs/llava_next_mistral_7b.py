"""LLaVA-NeXT (Mistral-7B backbone) — VLM with anyres tiling stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  Backbone: 32L
d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.  Per the assignment the
vision frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings (anyres: base 576 + 4 tiles x 576 = 2880 tokens) prepended to the
text sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    rope_theta=1e6,
    img_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
