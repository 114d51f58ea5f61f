"""The LM of the port: every block kind of the reference, for serving.

Block kinds (static per arch): ``dense`` (attention + MLP), ``moe``
(attention + MoE, plus a parallel dense MLP for arctic), ``rwkv`` (RWKV6
time/channel mix) and ``hymba`` (attention and a Mamba path in parallel,
then the MLP).  Whisper wraps a non-causal encoder stack, over stub frame
embeddings, plus a decoder stack with cross-attention to it; LLaVA prepends
stub patch embeddings to the token embeddings.  Learned positions
(whisper) are added after the embedding.

The port of the reference's ``models/model.py``.  The reference stacks
per-layer params on a leading L axis and scans over window-pattern groups;
here the model is an ``nn.Module`` with a ``ModuleList`` of layers (and of
encoder layers), and layer i takes window ``pattern[i % p]`` of
``cfg.window_pattern()`` (which still requires the period p to divide
``n_layers``).  Attribute names follow the reference's pytree keys.

Entry points (the reference's signatures, with ``params`` the module):
  * ``init_params(gen, cfg)``                 — weights from a
    ``torch.Generator``, on its device
  * ``forward(params, cfg, tokens, extra)``   — full-sequence logits
  * ``init_cache(cfg, batch, max_len, device=...)`` — per-layer caches
  * ``prefill(params, cfg, tokens, extra, max_len=...)`` — fill the cache,
    last-position logits
  * ``decode_step(params, cfg, tok, cache, index)`` — one-token decode

``extra`` holds the modality stubs: ``img_embeds`` (B, img_tokens, d) for
llava, ``audio_embeds`` (B, audio_ctx, d) for whisper
(``configs/specs.extra_specs``).  There is no backward and no remat:
training (``loss_fn``, ``param_specs``) waits for ROADMAP.md queue 1
item 3.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MO
from repro_torch.models import rwkv6 as R
from repro_torch.models import ssm as SM

__all__ = ["Layer", "LM", "init_params", "forward", "init_cache", "prefill",
           "decode_step"]


def _norm(x, p, cfg):
    if cfg.norm == "layernorm":
        return L.layer_norm(x, p, eps=cfg.norm_eps)
    return L.rms_norm(x, p, eps=cfg.norm_eps, plus_one=cfg.scale_embed)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
class Layer(nn.Module):
    """One layer; ``cross`` adds whisper's decoder cross-attention
    (``norm_x``, ``xattn``)."""

    def __init__(self, gen: torch.Generator, cfg, *, cross: bool = False):
        super().__init__()
        dt = L.dtype_of(cfg.param_dtype)
        bias = cfg.norm == "layernorm"

        def norm():
            return L.Norm(cfg.d_model, bias=bias, dtype=dt, device=gen.device)

        self.norm1 = norm()
        self.norm2 = norm()
        if cfg.block == "rwkv":
            self.rwkv = R.init_rwkv6(gen, cfg)
            return
        self.attn = A.init_attention(gen, cfg)
        if cfg.sandwich_norm:
            self.norm1b = norm()
            self.norm2b = norm()
        if cross:
            self.norm_x = norm()
            self.xattn = A.init_attention(gen, cfg)
        self.moe = MO.init_moe(gen, cfg) if cfg.block == "moe" else None
        self.mlp = (L.MLP(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated,
                          dtype=dt)
                    if cfg.block != "moe" or cfg.dense_residual else None)
        if cfg.block == "hymba":
            self.mamba = SM.init_mamba(gen, cfg)
            self.norm_attn_out = L.Norm(cfg.d_model, dtype=dt,
                                        device=gen.device)
            self.norm_ssm_out = L.Norm(cfg.d_model, dtype=dt,
                                       device=gen.device)


class LM(nn.Module):
    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        dt = L.dtype_of(cfg.param_dtype)
        d, V = cfg.d_model, cfg.vocab
        bias = cfg.norm == "layernorm"
        self.embed = L.normal(gen, (V, d), 0.02, dt)
        self.final_norm = L.Norm(d, bias=bias, dtype=dt, device=gen.device)
        cross = cfg.enc_layers > 0
        self.layers = nn.ModuleList(Layer(gen, cfg, cross=cross)
                                    for _ in range(cfg.n_layers))
        self.lm_head = (None if cfg.tie_embeddings
                        else L.normal(gen, (V, d), 0.02, dt))
        self.pos_embed = (L.normal(gen, (32768, d), 0.02, dt)
                          if cfg.pos_emb == "learned" else None)
        if cfg.enc_layers:
            self.enc_layers = nn.ModuleList(Layer(gen, cfg)
                                            for _ in range(cfg.enc_layers))
            self.enc_pos = L.normal(gen, (max(cfg.audio_ctx, 1), d), 0.02, dt)
            self.enc_final_norm = L.Norm(d, bias=bias, dtype=dt,
                                         device=gen.device)


def init_params(gen: torch.Generator, cfg) -> LM:
    """The model with weights drawn from ``gen``, on ``gen``'s device, in
    ``cfg.param_dtype`` (the reference's distributions, not its values)."""
    return LM(gen, cfg)


def _windows(cfg, n: int) -> list:
    pattern = cfg.window_pattern()
    return [pattern[i % len(pattern)] for i in range(n)]


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------
def _mix_paths(ao, so, lp: Layer, cfg):
    """hymba: the mean of the rms-normed attention and SSM outputs."""
    return 0.5 * (L.rms_norm(ao, lp.norm_attn_out, eps=cfg.norm_eps)
                  + L.rms_norm(so, lp.norm_ssm_out, eps=cfg.norm_eps))


def _ffn(h, lp: Layer, cfg):
    """The layer's feed-forward part on the normed stream h: the MLP, or
    the MoE (plus the MLP where the config has a dense residual)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    ff = None if lp.moe is None else MO.moe_ffn(h, lp.moe, cfg)
    if lp.mlp is not None:
        y = L.mlp(h, lp.mlp, act=cfg.act, compute_dtype=cdt)
        ff = y if ff is None else ff + y
    if cfg.sandwich_norm:
        ff = _norm(ff, lp.norm2b, cfg)
    return ff


def _attn_layer(x, lp: Layer, cfg, *, positions, window, causal=True,
                cross=None):
    """One full-sequence dense, moe or hymba layer, with cross-attention to
    ``cross`` = (k, v), each (B, Hkv, Skv, hd), where given.  Returns the
    new residual stream, the layer's (k, v) and, for hymba, its SSM cache
    (the conv tail and the scan's last state; else None)."""
    h = _norm(x, lp.norm1, cfg)
    ao, kv = A.attention(h, lp.attn, cfg, positions=positions, window=window,
                         causal=causal, impl=cfg.attn_impl)
    ssm = None
    if cfg.block == "hymba":
        so, tail, hT = SM._mamba_core(h, lp.mamba, cfg)
        ao = _mix_paths(ao, so.to(h.dtype), lp, cfg)
        ssm = {"conv": tail, "h": hT}
    if cfg.sandwich_norm:
        ao = _norm(ao, lp.norm1b, cfg)
    x = x + ao
    if cross is not None:
        h = _norm(x, lp.norm_x, cfg)
        xo, _ = A.attention(h, lp.xattn, cfg, positions=positions,
                            causal=False, impl=cfg.attn_impl,
                            kv_override=cross)
        x = x + xo
    h = _norm(x, lp.norm2, cfg)
    return x + _ffn(h, lp, cfg), kv, ssm


def _embed(params: LM, cfg, tokens, extra=None, pos0: int = 0):
    """Token embeddings, with llava's image embeddings prepended and
    learned positions from ``pos0`` on added.  Returns (B, img_tokens + S,
    d)."""
    x = params.embed[tokens].to(L.dtype_of(cfg.compute_dtype))
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if cfg.img_tokens and extra is not None and "img_embeds" in extra:
        x = torch.cat([extra["img_embeds"].to(x.dtype), x], dim=1)
    if cfg.pos_emb == "learned":
        x = x + params.pos_embed[pos0:pos0 + x.shape[1]].to(x.dtype)
    return x


def _logits(params: LM, cfg, x):
    head = params.embed if cfg.tie_embeddings else params.lm_head
    logits = x @ head.to(x.dtype).T
    return L.softcap(logits.float(), cfg.logit_softcap)


def _positions(x):
    B, S, _ = x.shape
    return torch.arange(S, device=x.device).expand(B, S)


def _encode(params: LM, cfg, extra):
    """Whisper's encoder on stub frame embeddings (B, audio_ctx, d): learned
    positions, the non-causal stack, the final norm."""
    if extra is None or "audio_embeds" not in extra:
        raise ValueError(f"{cfg.name} needs extra['audio_embeds'] of shape "
                         f"(batch, {cfg.audio_ctx}, {cfg.d_model})")
    x = extra["audio_embeds"].to(L.dtype_of(cfg.compute_dtype))
    x = x + params.enc_pos[:x.shape[1]].to(x.dtype)
    positions = _positions(x)
    for lp, window in zip(params.enc_layers,
                          _windows(cfg, cfg.enc_layers)):
        x, _, _ = _attn_layer(x, lp, cfg, positions=positions, window=window,
                              causal=False)
    return _norm(x, params.enc_final_norm, cfg)


def _cross_kv_all_layers(params: LM, cfg, enc_out) -> list:
    """Each decoder layer's cross-attention (k, v) of the encoder's output,
    (B, Hkv, Se, hd) each, contiguous."""
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    B, Se, _ = enc_out.shape
    cdt = L.dtype_of(cfg.compute_dtype)

    def heads(w):
        return (L.linear(enc_out, w, cdt).reshape(B, Se, Hkv, hd)
                .transpose(1, 2).contiguous())

    return [(heads(lp.xattn.wk), heads(lp.xattn.wv)) for lp in params.layers]


def _cross(params: LM, cfg, extra) -> list:
    """Per decoder layer: its cross-attention (k, v), or None."""
    if not cfg.enc_layers:
        return [None] * cfg.n_layers
    return _cross_kv_all_layers(params, cfg, _encode(params, cfg, extra))


# ---------------------------------------------------------------------------
# Public: full-sequence forward
# ---------------------------------------------------------------------------
def forward(params: LM, cfg, tokens, extra=None):
    """Full-sequence logits.  tokens: (B, S_text); returns (B, S_total, V)
    float32, S_total counting llava's image tokens."""
    x = _embed(params, cfg, tokens, extra)
    positions = _positions(x)
    cross = _cross(params, cfg, extra)
    for lp, window, ckv in zip(params.layers, _windows(cfg, cfg.n_layers),
                               cross):
        if cfg.block == "rwkv":
            x = R.rwkv6_block(x, lp.rwkv, cfg, lp.norm1, lp.norm2)
        else:
            x, _, _ = _attn_layer(x, lp, cfg, positions=positions,
                                  window=window, cross=ckv)
    x = _norm(x, params.final_norm, cfg)
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# Public: serving (prefill + decode)
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, *, device) -> list[dict]:
    """Per-layer caches (zeros): KV caches of ``max_len`` slots for
    attention layers (with whisper's cross-attention ``xk`` and ``xv`` of
    ``audio_ctx`` slots), recurrent caches for rwkv layers, both for hymba
    layers."""
    if cfg.block == "rwkv":
        return [R.init_rwkv6_cache(cfg, batch, device=device)
                for _ in range(cfg.n_layers)]
    cdt = L.dtype_of(cfg.compute_dtype)
    caches = [A.init_kv_cache(cfg, batch, max_len, device=device)
              for _ in range(cfg.n_layers)]
    for c in caches:
        if cfg.block == "hymba":
            c.update(SM.init_mamba_cache(cfg, batch, device=device))
        if cfg.enc_layers:
            shape = (batch, cfg.n_kv_heads, max(cfg.audio_ctx, 1), cfg.hd)
            c["xk"] = torch.zeros(shape, dtype=cdt, device=device)
            c["xv"] = torch.zeros(shape, dtype=cdt, device=device)
    return caches


def _cross_decode(x, lp: Layer, cfg, cache_l):
    """One token's cross-attention to the cached encoder keys and values:
    plain f32 einsums, as in the reference."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cdt = L.dtype_of(cfg.compute_dtype)
    h = _norm(x, lp.norm_x, cfg)
    q = L.linear(h, lp.xattn.wq, cdt)
    qg = q.reshape(B, 1, Hkv, H // Hkv, hd).float()
    s = torch.einsum("bqhgd,bhkd->bhgqk", qg,
                     cache_l["xk"].float()) * (hd ** -0.5)
    pe = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", pe, cache_l["xv"].float())
    o = o.reshape(B, H, 1, hd).transpose(1, 2).reshape(B, 1, H * hd)
    return x + L.linear(o.to(x.dtype), lp.xattn.wo, cdt)


def _decode_layer(x, lp: Layer, cfg, cache_l, index, window):
    if cfg.block == "rwkv":
        return R.rwkv6_decode(x, lp.rwkv, cfg, cache_l, lp.norm1, lp.norm2)
    h = _norm(x, lp.norm1, cfg)
    ao, cache_l = A.decode_attention(h, lp.attn, cfg, cache_l, index,
                                     window=window)
    if cfg.block == "hymba":
        so, sc = SM.mamba_decode(h, lp.mamba, cfg, cache_l)
        ao = _mix_paths(ao, so, lp, cfg)
        cache_l["conv"], cache_l["h"] = sc["conv"], sc["h"]
    if cfg.sandwich_norm:
        ao = _norm(ao, lp.norm1b, cfg)
    x = x + ao
    if cfg.enc_layers:
        x = _cross_decode(x, lp, cfg, cache_l)
    h = _norm(x, lp.norm2, cfg)
    return x + _ffn(h, lp, cfg), cache_l


def decode_step(params: LM, cfg, tokens, cache, index: int):
    """One decode step.  tokens: (B, 1); ``index``: the position of the new
    token (counting llava's image tokens).  Returns (logits (B, 1, V),
    cache); KV caches are updated in place."""
    x = _embed(params, cfg, tokens, pos0=index)
    new_cache = []
    for lp, cache_l, window in zip(params.layers, cache,
                                   _windows(cfg, cfg.n_layers)):
        x, nc = _decode_layer(x, lp, cfg, cache_l, index, window)
        new_cache.append(nc)
    x = _norm(x, params.final_norm, cfg)
    return _logits(params, cfg, x), new_cache


def prefill(params: LM, cfg, tokens, extra=None, *, max_len: int):
    """Run the full prompt (after llava's image tokens; whisper's encoder
    first), build the cache, return last-position logits (B, 1, V) and the
    cache."""
    B = tokens.shape[0]
    x = _embed(params, cfg, tokens, extra)
    S = x.shape[1]
    cache = []
    if cfg.block == "rwkv":
        for lp in params.layers:
            h = L.rms_norm(x, lp.norm1, eps=cfg.norm_eps)
            out, s_new = R._time_mix(h, R._shift(h), lp.rwkv, cfg,
                                     return_state=True)
            x = x + out
            h2 = L.rms_norm(x, lp.norm2, eps=cfg.norm_eps)
            x = x + R._channel_mix(h2, R._shift(h2), lp.rwkv)
            cache.append({"tm_x": h[:, -1:], "cm_x": h2[:, -1:],
                          "state": s_new})
    else:
        positions = _positions(x)
        cache = init_cache(cfg, B, max_len, device=tokens.device)
        cross = _cross(params, cfg, extra)
        for lp, cache_l, window, ckv in zip(
                params.layers, cache, _windows(cfg, cfg.n_layers), cross):
            x, (k, v), ssm = _attn_layer(x, lp, cfg, positions=positions,
                                         window=window, cross=ckv)
            cache_l["k"][:, :, :S] = k.to(cache_l["k"].dtype)
            cache_l["v"][:, :, :S] = v.to(cache_l["v"].dtype)
            if ssm is not None:
                cache_l["conv"] = ssm["conv"].to(cache_l["conv"].dtype)
                cache_l["h"] = ssm["h"]
            if ckv is not None:
                cache_l["xk"] = ckv[0].to(cache_l["xk"].dtype)
                cache_l["xv"] = ckv[1].to(cache_l["xv"].dtype)
    x = _norm(x, params.final_norm, cfg)
    return _logits(params, cfg, x[:, -1:]), cache
