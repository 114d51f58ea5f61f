"""Whisper large-v3 — encoder-decoder with conv frontend (stub).

[arXiv:2212.04356; unverified]  32 encoder + 32 decoder layers,
d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866, learned positions,
LayerNorm, GELU.  The mel/conv frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings (B, 1500, d).
Decode cells exercise the decoder self-attention cache + cross-attention.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    act="gelu",
    gated=False,
    norm="layernorm",
    pos_emb="learned",
    audio_ctx=1500,
    source="arXiv:2212.04356",
)
