"""RWKV6 "Finch" block: data-dependent-decay linear attention (attn-free).

The port of the reference's ``models/rwkv6.py`` (arXiv:2404.05892):
token-shift ddlerp with low-rank adapters, data-dependent per-channel decay
``w = exp(-exp(w~))`` (kept in f32, ``w~`` clamped to [_WMIN, _WMAX]),
bonus ``u``, per-head WKV state recurrence, grouped RMS norm, gated output,
and the squared-ReLU channel-mix.

The WKV recurrence (:func:`_wkv_apply`) runs K14 (``ops.wkv6``) on every
CUDA tensor — prefill (T = the prompt), every decode step (T = 1) and the
training forward — so the card never takes a plain version.  On a CPU
tensor ``cfg.use_kernels`` picks the plain formulation the reference picks:
the kernel's own function (``ops.wkv6``, the sequential recurrence) when
set, else the chunked form for T > 1 and the sequential scan for T = 1.
Where a gradient is wanted, the kernel's path runs through
``kernels/autograd.WKV6Fn``, whose backward differentiates the chunked
form (the reference's training gradient); the plain forms are
differentiated by autograd as they run.

Decode carries the reference's recurrent cache: the last normed hidden
state of each of the two token-shifts and the (B, H, hd, hd) f32 WKV state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import autograd as AG
from repro_torch.kernels.ref import wkv6_chunked, wkv6_ref
from repro_torch.models import layers as L

__all__ = ["RWKV6", "init_rwkv6", "rwkv6_block", "rwkv6_decode",
           "init_rwkv6_cache"]

_LORA_MIX = 32
_LORA_DECAY = 64
_WMIN, _WMAX = -8.0, 1.0   # clamp on w~ (kernel stability; exp(-exp(1))~0.066)


class RWKV6(nn.Module):
    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        d, H, hd, dff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        dt = L.dtype_of(cfg.param_dtype)
        dev = gen.device
        s = d ** -0.5

        def full(shape, value):
            return L.param(torch.full(shape, value, dtype=dt, device=dev))

        # time-mix
        self.mu_x = full((d,), 0.0)
        self.mu = full((5, d), 0.0)                       # r, k, v, w, g
        self.mix_A = L.normal(gen, (d, 5 * _LORA_MIX), s, dt)
        self.mix_B = L.normal(gen, (5, _LORA_MIX, d), 0.01, dt)
        self.w0 = full((d,), -2.0)
        self.w_A = L.normal(gen, (d, _LORA_DECAY), s, dt)
        self.w_B = L.normal(gen, (_LORA_DECAY, d), 0.01, dt)
        self.u = L.normal(gen, (H, hd), 0.1, dt)
        self.wr = L.Linear(gen, d, d, dtype=dt)
        self.wk = L.Linear(gen, d, d, dtype=dt)
        self.wv = L.Linear(gen, d, d, dtype=dt)
        self.wg = L.Linear(gen, d, d, dtype=dt)
        self.wo = L.Linear(gen, d, d, dtype=dt)
        self.ln_x = L.Norm(hd, dtype=dt, device=dev)    # per-head group norm
        # channel-mix
        self.cm_mu_k = full((d,), 0.0)
        self.cm_mu_r = full((d,), 0.0)
        self.cm_wk = L.Linear(gen, d, dff, dtype=dt)
        self.cm_wv = L.Linear(gen, dff, d, dtype=dt)
        self.cm_wr = L.Linear(gen, d, d, dtype=dt)


def init_rwkv6(gen: torch.Generator, cfg) -> RWKV6:
    return RWKV6(gen, cfg)


def _ddlerp(x, x_prev, p: RWKV6):
    """Data-dependent lerp producing the 5 mixed streams (r, k, v, w, g),
    all in the residual dtype."""
    dt = x.dtype
    diff = x_prev - x                                       # (B, T, d)
    xx = x + diff * p.mu_x.to(dt)
    mws = torch.tanh(xx @ p.mix_A.to(dt))                   # (B, T, 5*rank)
    out = []
    for i in range(5):                                      # r, k, v, w, g
        sel = mws[..., i * _LORA_MIX:(i + 1) * _LORA_MIX]
        adj = sel @ p.mix_B[i].to(dt)                       # (B, T, d)
        out.append(x + diff * (p.mu[i].to(dt) + adj))
    return tuple(out)


def _wkv_apply(r, k, v, w, u, s0, cfg, *, return_state):
    """(B, H, T, hd) WKV: K14 on the card; on the CPU the plain form the
    reference picks (module docstring)."""
    if r.device.type == "cpu" and not cfg.use_kernels:
        plain = wkv6_ref if r.shape[2] == 1 else wkv6_chunked
        return plain(r, k, v, w, u, initial_state=s0,
                     return_state=return_state)
    return AG.wkv6(r, k, v, w, u, initial_state=s0,
                   return_state=return_state)


def _time_mix(x, x_prev, p: RWKV6, cfg, s0=None, *, return_state=False):
    B, T, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    xr, xk, xv, xw, xg = _ddlerp(x, x_prev, p)
    cdt = x.dtype

    def heads(y):
        return y.reshape(B, T, H, hd).transpose(1, 2)

    r = heads(L.linear(xr, p.wr, cdt))
    k = heads(L.linear(xk, p.wk, cdt))
    v = heads(L.linear(xv, p.wv, cdt))
    g = F.silu(L.linear(xg, p.wg, cdt))
    # decay stays f32: log/exp chains need the mantissa
    wt = p.w0 + torch.tanh(xw.float() @ p.w_A) @ p.w_B
    wt = torch.clamp(wt, _WMIN, _WMAX)
    w = heads(torch.exp(-torch.exp(wt)))

    res = _wkv_apply(r, k, v, w, p.u, s0, cfg, return_state=return_state)
    o, s_new = res if return_state else (res, None)
    o = o.transpose(1, 2)                                   # (B, T, H, hd)
    o = L.rms_norm(o, p.ln_x, eps=cfg.norm_eps).reshape(B, T, d)
    out = L.linear((o * g).to(x.dtype), p.wo).to(x.dtype)
    return (out, s_new) if return_state else out


def _channel_mix(x, x_prev, p: RWKV6):
    diff = x_prev - x
    xk = (x + diff * p.cm_mu_k).to(x.dtype)
    xr = (x + diff * p.cm_mu_r).to(x.dtype)
    kk = F.relu(L.linear(xk, p.cm_wk, x.dtype))
    kk = kk * kk
    out = torch.sigmoid(L.linear(xr, p.cm_wr, x.dtype)) \
        * L.linear(kk, p.cm_wv, x.dtype)
    return out.to(x.dtype)


def _shift(x):
    """Previous-token stream: x_prev[t] = x[t-1], zeros at t=0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv6_block(x, p: RWKV6, cfg, norm1, norm2):
    """Full-sequence (prefill / forward) layer.  x: (B, T, d)."""
    h = L.rms_norm(x, norm1, eps=cfg.norm_eps)
    x = x + _time_mix(h, _shift(h), p, cfg)
    h = L.rms_norm(x, norm2, eps=cfg.norm_eps)
    return x + _channel_mix(h, _shift(h), p)


def init_rwkv6_cache(cfg, batch: int, *, device) -> dict:
    H, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    cdt = L.dtype_of(cfg.compute_dtype)
    return {
        "tm_x": torch.zeros((batch, 1, d), dtype=cdt, device=device),
        "cm_x": torch.zeros((batch, 1, d), dtype=cdt, device=device),
        "state": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
    }


def rwkv6_decode(x, p: RWKV6, cfg, cache, norm1, norm2):
    """Single-token step with recurrent cache.  x: (B, 1, d)."""
    h = L.rms_norm(x, norm1, eps=cfg.norm_eps)
    out, s_new = _time_mix(h, cache["tm_x"], p, cfg, s0=cache["state"],
                           return_state=True)
    x = x + out
    h2 = L.rms_norm(x, norm2, eps=cfg.norm_eps)
    x = x + _channel_mix(h2, cache["cm_x"], p)
    return x, {"tm_x": h, "cm_x": h2, "state": s_new}
