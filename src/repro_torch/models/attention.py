"""GQA attention: prefill through K13 and single-token decode.

The port of the reference's ``models/attention.py`` for one device.

Prefill (:func:`attention`).  The reference's implementation ladder is
``naive`` (the full score matrix), ``chunked`` (an XLA online softmax) and
``flash`` (the Pallas kernel, K13).  Here every impl runs K13
(``ops.flash_attention``) on a CUDA tensor, so a prefill on the card never
takes a plain version.  On a CPU tensor the impl picks the plain
formulation: ``naive`` the reference's oracle (``kernels/ref.attention_ref``),
``chunked`` and ``flash`` the kernel's own online-softmax function (K13's
plain version; ``chunked`` computes that same function in the reference).
``kv_override=(k, v)`` supplies the keys and values, (B, Hkv, Skv, hd),
in place of the layer's own projections (whisper's cross-attention, over
the encoder's output); with ``causal=False`` it and the encoder's
self-attention run K13 non-causal, with Sq != Skv for the former.  The
reference's sequence-sharded and context-parallel branches are not ported
(ROADMAP.md queue 1 item 14).  Where a gradient is wanted (training), K13
and its plain version run through ``kernels/autograd.FlashAttentionFn``,
whose backward is FlashAttention-2's in plain torch; serving calls the
wrapper itself.

Decode (:func:`decode_attention`) attends a (B, Hkv, max_len, hd) cache.
It is plain torch, as in the reference, where it is einsum code outside any
Pallas kernel.  The cache is updated in place (the reference returns a new
array): one slot per step, no copy of the cache.

Supports GQA grouping, sliding window, gemma2 logit softcap, QKV biases,
qk-norm and rotary positions.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import autograd as AG
from repro_torch.kernels.ref import NEG_INF, attention_ref
from repro_torch.models import layers as L

__all__ = ["IMPLS", "Attention", "init_attention", "attention",
           "decode_attention", "init_kv_cache"]

IMPLS = ("naive", "chunked", "flash")


class Attention(nn.Module):
    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = L.dtype_of(cfg.param_dtype)
        self.wq = L.Linear(gen, d, H * hd, bias=cfg.qkv_bias, dtype=dt)
        self.wk = L.Linear(gen, d, Hkv * hd, bias=cfg.qkv_bias, dtype=dt)
        self.wv = L.Linear(gen, d, Hkv * hd, bias=cfg.qkv_bias, dtype=dt)
        self.wo = L.Linear(gen, H * hd, d, dtype=dt)
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:
            self.q_norm = L.Norm(hd, dtype=dt, device=gen.device)
            self.k_norm = L.Norm(hd, dtype=dt, device=gen.device)


def init_attention(gen: torch.Generator, cfg) -> Attention:
    return Attention(gen, cfg)


def _heads(x, w: L.Linear, n: int, cfg, norm=None, positions=None):
    """(B, S, d) -> (B, S, n, hd) through ``w``; rms-normed by ``norm``
    (qk-norm) if given, and rotated where the config has RoPE and
    ``positions`` is given."""
    B, S, _ = x.shape
    t = L.linear(x, w, L.dtype_of(cfg.compute_dtype)).reshape(B, S, n, cfg.hd)
    if norm is not None:
        t = L.rms_norm(t, norm, eps=cfg.norm_eps)
    if cfg.pos_emb == "rope" and positions is not None:
        t = L.rope(t, positions, theta=cfg.rope_theta)
    return t


def _project_qkv(x, p: Attention, cfg, positions, *, kv: bool = True):
    """q, k, v in (B, S, heads, hd); k and v are None unless ``kv``."""
    q = _heads(x, p.wq, cfg.n_heads, cfg, p.q_norm, positions)
    if not kv:
        return q, None, None
    k = _heads(x, p.wk, cfg.n_kv_heads, cfg, p.k_norm, positions)
    v = _heads(x, p.wv, cfg.n_kv_heads, cfg)
    return q, k, v


def attention(x, p: Attention, cfg, *, positions, window=None, causal=True,
              impl: str = "chunked", kv_override=None):
    """Full-sequence (prefill) attention.

    Returns (out, (k, v)) — k/v in (B, Hkv, S, hd) for cache construction.
    ``kv_override`` supplies external K/V (cross-attention), already
    (B, Hkv, Skv, hd); the layer's own k and v are then not computed.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; have {IMPLS}")
    H, hd = cfg.n_heads, cfg.hd
    q, k, v = _project_qkv(x, p, cfg, positions, kv=kv_override is None)
    q = q.transpose(1, 2)
    if kv_override is not None:
        k, v = kv_override
    else:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    scale = hd ** -0.5
    if impl == "naive" and q.device.type == "cpu":
        out = attention_ref(q, k, v, causal=causal, scale=scale,
                            window=window, softcap=cfg.attn_softcap)
    else:
        out = AG.flash_attention(q, k, v, causal=causal, scale=scale,
                                 window=window, softcap=cfg.attn_softcap)
    B, _, S, _ = out.shape
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return L.linear(out, p.wo, L.dtype_of(cfg.compute_dtype)), (k, v)


def init_kv_cache(cfg, batch: int, max_len: int, *, device) -> dict:
    """One layer's zero KV cache, (batch, Hkv, max_len, hd) in the compute
    dtype."""
    shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)
    dt = L.dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention(x, p: Attention, cfg, cache: dict, cache_index: int, *,
                     window=None):
    """Single-token decode: write the cache at ``cache_index`` (in place)
    and attend.  x: (B, 1, d); cache k/v: (B, Hkv, S, hd).  Returns
    (out, cache)."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // Hkv
    positions = torch.full((B, 1), cache_index, dtype=torch.long,
                           device=x.device)
    q, k_new, v_new = _project_qkv(x, p, cfg, positions)
    k, v = cache["k"], cache["v"]
    k[:, :, cache_index:cache_index + 1] = k_new.transpose(1, 2).to(k.dtype)
    v[:, :, cache_index:cache_index + 1] = v_new.transpose(1, 2).to(v.dtype)

    qg = q.reshape(B, 1, Hkv, G, hd).float()
    s = torch.einsum("bqhgd,bhkd->bhgqk", qg, k.float()) * (hd ** -0.5)
    s = L.softcap(s, cfg.attn_softcap)
    kpos = torch.arange(k.shape[2], device=x.device)
    mask = kpos <= cache_index
    if window is not None:
        mask &= cache_index - kpos < window
    s = torch.where(mask, s, NEG_INF)
    pe = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhgqk,bhkd->bhgqd", pe, v.float())
    out = out / pe.sum(-1, keepdim=True)
    out = out.reshape(B, H, 1, hd).transpose(1, 2).reshape(B, 1, H * hd)
    out = L.linear(out.to(x.dtype), p.wo, L.dtype_of(cfg.compute_dtype))
    return out, cache
