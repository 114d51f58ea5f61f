"""The LM of the port: the ``dense`` (attention + MLP), ``rwkv`` (RWKV6
time/channel mix) and ``hymba`` (attention and a Mamba path in parallel,
then the MLP) blocks, for serving.

The port of the reference's ``models/model.py`` for those three blocks.  The
reference stacks per-layer params on a leading L axis and scans over
window-pattern groups; here the model is an ``nn.Module`` with a
``ModuleList`` of layers, and layer i takes window ``pattern[i % p]`` of
``cfg.window_pattern()`` (which still requires the period p to divide
``n_layers``).  Attribute names follow the reference's pytree keys.

Entry points (the reference's signatures, with ``params`` the module):
  * ``init_params(gen, cfg)``                 — weights from a
    ``torch.Generator``, on its device
  * ``forward(params, cfg, tokens)``          — full-sequence logits
  * ``init_cache(cfg, batch, max_len, device=...)`` — per-layer caches
  * ``prefill(params, cfg, tokens, max_len=...)`` — fill the cache,
    last-position logits
  * ``decode_step(params, cfg, tok, cache, index)`` — one-token decode

There is no backward and no remat: training is ROADMAP.md queue 1 item 3.
The ``moe`` block, encoder-decoder stacks, image tokens and learned
positions raise ``NotImplementedError`` (the same item).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R
from repro_torch.models import ssm as SM

__all__ = ["Layer", "LM", "init_params", "forward", "init_cache", "prefill",
           "decode_step"]

_UNPORTED = "the rest of the LM substrate, ROADMAP.md queue 1 item 3"


def _check_ported(cfg) -> None:
    if cfg.block not in ("dense", "rwkv", "hymba"):
        raise NotImplementedError(f"block {cfg.block!r} is not ported "
                                  f"({_UNPORTED})")
    for what, unported in (("encoder-decoder stacks", cfg.enc_layers),
                           ("image tokens", cfg.img_tokens),
                           ("learned positions", cfg.pos_emb == "learned")):
        if unported:
            raise NotImplementedError(f"{what} are not ported ({_UNPORTED})")


def _norm(x, p, cfg):
    if cfg.norm == "layernorm":
        return L.layer_norm(x, p, eps=cfg.norm_eps)
    return L.rms_norm(x, p, eps=cfg.norm_eps, plus_one=cfg.scale_embed)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
class Layer(nn.Module):
    def __init__(self, gen: torch.Generator, cfg):
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
        self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated,
                         dtype=dt)
        if cfg.block == "hymba":
            self.mamba = SM.init_mamba(gen, cfg)
            self.norm_attn_out = L.Norm(cfg.d_model, dtype=dt,
                                        device=gen.device)
            self.norm_ssm_out = L.Norm(cfg.d_model, dtype=dt,
                                       device=gen.device)


class LM(nn.Module):
    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        _check_ported(cfg)
        dt = L.dtype_of(cfg.param_dtype)
        d, V = cfg.d_model, cfg.vocab
        self.embed = L.normal(gen, (V, d), 0.02, dt)
        self.final_norm = L.Norm(d, bias=cfg.norm == "layernorm", dtype=dt,
                                 device=gen.device)
        self.layers = nn.ModuleList(_init_layer(gen, cfg)
                                    for _ in range(cfg.n_layers))
        self.lm_head = (None if cfg.tie_embeddings
                        else L.normal(gen, (V, d), 0.02, dt))


def _init_layer(gen: torch.Generator, cfg) -> Layer:
    return Layer(gen, cfg)


def init_params(gen: torch.Generator, cfg) -> LM:
    """The model with weights drawn from ``gen``, on ``gen``'s device, in
    ``cfg.param_dtype`` (the reference's distributions, not its values)."""
    return LM(gen, cfg)


def _windows(cfg) -> list:
    pattern = cfg.window_pattern()
    return [pattern[i % len(pattern)] for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------
def _mix_paths(ao, so, lp: Layer, cfg):
    """hymba: the mean of the rms-normed attention and SSM outputs."""
    return 0.5 * (L.rms_norm(ao, lp.norm_attn_out, eps=cfg.norm_eps)
                  + L.rms_norm(so, lp.norm_ssm_out, eps=cfg.norm_eps))


def _attn_layer(x, lp: Layer, cfg, *, positions, window):
    """One full-sequence dense or hymba layer.  Returns the new residual
    stream, the layer's (k, v) and, for hymba, its SSM cache (the conv tail
    and the scan's last state; else None)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    h = _norm(x, lp.norm1, cfg)
    ao, kv = A.attention(h, lp.attn, cfg, positions=positions, window=window,
                         causal=True, impl=cfg.attn_impl)
    ssm = None
    if cfg.block == "hymba":
        so, tail, hT = SM._mamba_core(h, lp.mamba, cfg)
        ao = _mix_paths(ao, so.to(h.dtype), lp, cfg)
        ssm = {"conv": tail, "h": hT}
    if cfg.sandwich_norm:
        ao = _norm(ao, lp.norm1b, cfg)
    x = x + ao
    h = _norm(x, lp.norm2, cfg)
    ff = L.mlp(h, lp.mlp, act=cfg.act, compute_dtype=cdt)
    if cfg.sandwich_norm:
        ff = _norm(ff, lp.norm2b, cfg)
    return x + ff, kv, ssm


def _embed(params: LM, cfg, tokens):
    x = params.embed[tokens].to(L.dtype_of(cfg.compute_dtype))
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _logits(params: LM, cfg, x):
    head = params.embed if cfg.tie_embeddings else params.lm_head
    logits = x @ head.to(x.dtype).T
    return L.softcap(logits.float(), cfg.logit_softcap)


def _positions(x):
    B, S, _ = x.shape
    return torch.arange(S, device=x.device).expand(B, S)


def _check_extra(extra) -> None:
    if extra is not None:
        raise NotImplementedError(f"image and audio inputs are not ported "
                                  f"({_UNPORTED})")


# ---------------------------------------------------------------------------
# Public: full-sequence forward
# ---------------------------------------------------------------------------
def forward(params: LM, cfg, tokens, extra=None):
    """Full-sequence logits.  tokens: (B, S); returns (B, S, V) float32."""
    _check_extra(extra)
    x = _embed(params, cfg, tokens)
    positions = _positions(x)
    for lp, window in zip(params.layers, _windows(cfg)):
        if cfg.block == "rwkv":
            x = R.rwkv6_block(x, lp.rwkv, cfg, lp.norm1, lp.norm2)
        else:
            x, _, _ = _attn_layer(x, lp, cfg, positions=positions,
                                  window=window)
    x = _norm(x, params.final_norm, cfg)
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# Public: serving (prefill + decode)
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, *, device) -> list[dict]:
    """Per-layer caches (zeros): KV caches of ``max_len`` slots for dense
    layers, recurrent caches for rwkv layers, both for hymba layers."""
    if cfg.block == "rwkv":
        return [R.init_rwkv6_cache(cfg, batch, device=device)
                for _ in range(cfg.n_layers)]
    caches = [A.init_kv_cache(cfg, batch, max_len, device=device)
              for _ in range(cfg.n_layers)]
    if cfg.block == "hymba":
        for c in caches:
            c.update(SM.init_mamba_cache(cfg, batch, device=device))
    return caches


def _decode_layer(x, lp: Layer, cfg, cache_l, index, window):
    if cfg.block == "rwkv":
        return R.rwkv6_decode(x, lp.rwkv, cfg, cache_l, lp.norm1, lp.norm2)
    cdt = L.dtype_of(cfg.compute_dtype)
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
    h = _norm(x, lp.norm2, cfg)
    ff = L.mlp(h, lp.mlp, act=cfg.act, compute_dtype=cdt)
    if cfg.sandwich_norm:
        ff = _norm(ff, lp.norm2b, cfg)
    return x + ff, cache_l


def decode_step(params: LM, cfg, tokens, cache, index: int):
    """One decode step.  tokens: (B, 1); ``index``: the position of the new
    token.  Returns (logits (B, 1, V), cache); KV caches are updated in
    place."""
    x = _embed(params, cfg, tokens)
    new_cache = []
    for lp, cache_l, window in zip(params.layers, cache, _windows(cfg)):
        x, nc = _decode_layer(x, lp, cfg, cache_l, index, window)
        new_cache.append(nc)
    x = _norm(x, params.final_norm, cfg)
    return _logits(params, cfg, x), new_cache


def prefill(params: LM, cfg, tokens, extra=None, *, max_len: int):
    """Run the full prompt, build the cache, return last-position logits
    (B, 1, V) and the cache."""
    _check_extra(extra)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
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
        for lp, cache_l, window in zip(params.layers, cache, _windows(cfg)):
            x, (k, v), ssm = _attn_layer(x, lp, cfg, positions=positions,
                                         window=window)
            cache_l["k"][:, :, :S] = k.to(cache_l["k"].dtype)
            cache_l["v"][:, :, :S] = v.to(cache_l["v"].dtype)
            if ssm is not None:
                cache_l["conv"] = ssm["conv"].to(cache_l["conv"].dtype)
                cache_l["h"] = ssm["h"]
    x = _norm(x, params.final_norm, cfg)
    return _logits(params, cfg, x[:, -1:]), cache
