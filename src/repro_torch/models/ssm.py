"""Selective SSM (Mamba-style) path of the Hymba hybrid block.

The port of the reference's ``models/ssm.py``.  Hymba (arXiv:2411.13676)
runs attention heads and Mamba heads in parallel within each block on the
same input, then averages the two normalized paths (``models/model.py``).
This module is the Mamba path: input projection and gate, a short causal
depthwise conv, and the selective SSM with data-dependent (dt, B, C) and
``ssm_state`` channels per inner dim.  The full-sequence tensors stay in
the compute dtype and the scan state in f32, as in the reference.

The reference's scan is a sequential ``lax.scan`` outside any Pallas
kernel, so here it is plain PyTorch too: :func:`_ssm_scan` computes each
chunk's decays ``exp(dt A)`` and inputs ``dt x B`` at once, then walks the
chunk's steps one at a time (``h = decay * h + input``: two small device
operations a step, so a prefill on the card is host-bound, about T x
layers of them), and contracts the chunk's states with C in one einsum.
The per-step values are the reference step's: the same f32 products, in
the same order; the scan is differentiable end to end, as the reference's
``lax.scan``.

Decode carries (conv tail, SSM state): O(1) in sequence length.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L

__all__ = ["Mamba", "init_mamba", "mamba", "mamba_decode",
           "init_mamba_cache"]

_CONV_K = 4
# steps whose decays and inputs the scan materializes at once: (chunk, B,
# di, n) f32 each, 105 MB at hymba-1.5b's width and batch 4.  Two device
# operations a step in place of the reference step's eight: 4-5x faster
# than one step at a time on an H100, and bitwise the same values
# (scripts/ssm_scan_compare.py)
_SCAN_CHUNK = 128


class Mamba(nn.Module):
    """The reference's ``init_mamba`` tree as parameters (its key names)."""

    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        d = cfg.d_model
        di = 2 * d                              # inner dim
        n = cfg.ssm_state
        dt_rank = max(1, d // 16)
        dt = L.dtype_of(cfg.param_dtype)
        dev = gen.device
        s = d ** -0.5
        self.in_proj = L.normal(gen, (d, 2 * di), s, dt)
        self.conv_w = L.normal(gen, (_CONV_K, di), 0.2, dt)
        self.conv_b = L.param(torch.zeros(di, dtype=dt, device=dev))
        self.x_proj = L.normal(gen, (di, dt_rank + 2 * n), s, dt)
        self.dt_proj = L.normal(gen, (dt_rank, di), dt_rank ** -0.5, dt)
        self.dt_bias = L.param(torch.full((di,), math.log(math.expm1(0.01)),
                                          dtype=dt, device=dev))
        self.A_log = L.param(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=dev).expand(di, n)
            .to(dt)).contiguous())
        self.D = L.param(torch.ones(di, dtype=dt, device=dev))
        self.out_proj = L.normal(gen, (di, d), di ** -0.5, dt)


def init_mamba(gen: torch.Generator, cfg) -> Mamba:
    return Mamba(gen, cfg)


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv over time.  x: (B, T, di); w: (K, di).

    ``tail``: (B, K-1, di) previous samples for decode; zeros for prefill.
    Returns (y, new_tail).
    """
    B, T, di = x.shape
    K = w.shape[0]
    if tail is None:
        tail = torch.zeros((B, K - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)          # (B, T+K-1, di)
    y = sum(xp[:, i:i + T] * w[i] for i in range(K)) + b
    # the tail apart from xp, which a cache would otherwise keep whole
    return y, xp[:, -(K - 1):].clone()


def _ssm_scan(x, dt, Bc, Cc, A, D, h0):
    """Selective scan.  x, dt: (B, T, di); Bc, Cc: (B, T, n); A: (di, n).

    h_t = exp(dt_t A) * h_t-1 + dt_t * B_t * x_t;   y_t = h_t . C_t + D x_t
    Returns (y (B, T, di) f32, h_T (B, di, n) f32).
    """
    B, T, di = x.shape
    # autograd keeps every step's h, so a gradient's scan stacks new
    # tensors; without one, each step writes into its chunk's buffer
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, Bc, Cc, A, D, h0))
    xf, dtf, bf, cf = (t.float() for t in (x, dt, Bc, Cc))
    ys = torch.empty((B, T, di), dtype=torch.float32, device=x.device)
    h = h0
    for t0 in range(0, T, _SCAN_CHUNK):
        t1 = min(T, t0 + _SCAN_CHUNK)
        # (steps, B, di, n): step t's decay and input, contiguous per step
        dtc = dtf[:, t0:t1].transpose(0, 1)
        decay = torch.exp(dtc[..., None] * A)
        inp = (dtc * xf[:, t0:t1].transpose(0, 1))[..., None] \
            * bf[:, t0:t1, None, :].transpose(0, 1)
        if x.device.type == "meta":
            # the dry run: the steps' shapes without the per-step loop (no
            # dot product in it, so nothing the FLOP count reads)
            hs = decay * inp
            h = hs[-1]
        elif grad:
            hs = []
            for t in range(t1 - t0):
                h = decay[t] * h + inp[t]
                hs.append(h)
            hs = torch.stack(hs)
        else:
            hs = torch.empty_like(decay)
            for t in range(t1 - t0):
                h = torch.add(decay[t] * h, inp[t], out=hs[t])
        ys[:, t0:t1] = torch.einsum("tbdn,btn->btd", hs, cf[:, t0:t1])
    # without a gradient h is a step of the last chunk's buffer: keep the
    # state, not the chunk
    return ys + D * x, h.clone()


def _mamba_core(x, p: Mamba, cfg, conv_tail=None, h0=None):
    B, T, d = x.shape
    di = 2 * d
    n = cfg.ssm_state
    dt_rank = max(1, d // 16)
    cdt = x.dtype                     # keep full-seq tensors in compute dtype
    xz = x @ p.in_proj.to(cdt)
    xi, z = xz.chunk(2, dim=-1)                           # (B, T, di) each
    xi, new_tail = _causal_conv(xi, p.conv_w.to(cdt), p.conv_b.to(cdt),
                                conv_tail)
    xi = F.silu(xi)
    dbc = xi @ p.x_proj.to(cdt)
    dt = F.softplus(dbc[..., :dt_rank] @ p.dt_proj.to(cdt)
                    + p.dt_bias.to(cdt))
    Bc = dbc[..., dt_rank:dt_rank + n]
    Cc = dbc[..., dt_rank + n:]
    A = -torch.exp(p.A_log.float())
    if h0 is None:
        h0 = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
    # scan state stays f32 (decay-chain stability); the inputs stream in
    # the compute dtype and are upcast inside the scan
    y, hT = _ssm_scan(xi, dt, Bc, Cc, A, p.D.float(), h0)
    y = y.to(cdt) * F.silu(z)
    return y @ p.out_proj.to(cdt), new_tail, hT


def mamba(x, p: Mamba, cfg):
    """Prefill path.  x: (B, T, d) -> (B, T, d)."""
    out, _, _ = _mamba_core(x, p, cfg)
    return out.to(x.dtype)


def init_mamba_cache(cfg, batch: int, *, device) -> dict:
    di = 2 * cfg.d_model
    return {
        "conv": torch.zeros((batch, _CONV_K - 1, di),
                            dtype=L.dtype_of(cfg.compute_dtype),
                            device=device),
        "h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                         device=device),
    }


def mamba_decode(x, p: Mamba, cfg, cache: dict):
    """Single-token step.  x: (B, 1, d).  Returns (out, new cache)."""
    out, tail, hT = _mamba_core(x, p, cfg, conv_tail=cache["conv"],
                                h0=cache["h"])
    return out.to(x.dtype), {"conv": tail.to(cache["conv"].dtype), "h": hT}
