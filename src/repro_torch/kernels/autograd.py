"""Gradients through K13 and K14: ``torch.autograd.Function``s whose forward
is the kernel and whose backward is plain PyTorch.

K13 and K14 are launched through ctypes (``kernels/flash_attn.py``,
``kernels/wkv6.py``), so their outputs are fresh tensors with no
``grad_fn``; on a CPU tensor the same wrappers return the plain version,
which autograd differentiates.  Called directly in a training step, the
kernels would give q, k and v (r, k, v, w and u) no gradient on the card
while the CPU trained correctly.  These Functions carry the gradient on
both devices:

* :class:`FlashAttentionFn` — forward ``ops.flash_attention`` (K13 on the
  card, its plain version on the CPU), saving q, k, v and the output;
  backward FlashAttention-2's (:func:`flash_attention_bwd`), in plain torch
  over tiles of :data:`BLOCK_K` keys, so that its memory is one tile's and
  not Sq x Skv.  A first pass recomputes each row's log-sum-exp from q and
  k; then per tile ``P = exp(S - lse)``, ``dV = Pᵀ dO``, ``dP = dO Vᵀ``,
  ``dS = P ∘ (dP - rowsum(dO ∘ O))``, times the softcap's derivative
  ``1 - tanh²(s / cap)`` where there is one, ``dQ += dS K``,
  ``dK = dSᵀ Q``, with the forward's causal, window and ``q_offset`` masks
  and GQA (dK and dV summed over each group's query heads).  A row with no
  visible key gets a zero gradient, as its output is 0.
* :class:`WKV6Fn` — forward ``ops.wkv6`` (K14 on the card), saving its
  inputs; backward re-runs the differentiable ``ref.wkv6_chunked`` on
  detached copies under ``torch.enable_grad()`` and returns
  ``torch.autograd.grad`` of it for r, k, v, w, u and the initial state:
  the reference's own training gradient.

The reference has no backward kernel either: its training differentiates
the XLA chunked attention and ``wkv6_chunked`` by autodiff, outside any
Pallas kernel.  :func:`flash_attention` and :func:`wkv6` take the Functions
only when grad is enabled and an input requires it; otherwise (serving,
under ``torch.inference_mode()``) they call the wrappers themselves, so
serving's launch counts and outputs do not change.  Backward passes add
nothing to the launch counts: with remat (``cfg.remat``) the recomputed
forward launches each kernel once more.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import NEG_INF, accum_dtype

__all__ = ["BLOCK_K", "FlashAttentionFn", "WKV6Fn", "flash_attention",
           "flash_attention_bwd", "wkv6"]

# keys per tile of the attention backward: its buffers are (B, Hq, Sq,
# BLOCK_K) in the accumulation dtype, a few at a time
BLOCK_K = 128


def _key_range(Sq: int, Skv: int, causal: bool, window, q_offset: int):
    """[lo, hi): the keys some query row of q_offset .. q_offset + Sq - 1
    can see."""
    hi = min(Skv, max(0, q_offset + Sq)) if causal else Skv
    lo = 0 if window is None else min(hi, max(0, q_offset - window + 1))
    return lo, hi


def flash_attention_bwd(q, k, v, o, do, *, causal: bool, scale: float,
                        window, softcap, q_offset: int):
    """dq, dk, dv of K13's function (FlashAttention-2's backward, module
    docstring) in q's, k's and v's dtypes, computed in f32 (f64 for f64
    inputs), over tiles of :data:`BLOCK_K` keys.
    q, o, do: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d)."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    acc = accum_dtype(q.dtype)
    dev = q.device
    qg = q.to(acc).reshape(B, Hkv, G, Sq, d)
    dog = do.to(acc).reshape(B, Hkv, G, Sq, d)
    # rowsum(dO ∘ O): the softmax's term of dS
    dsum = (dog * o.to(acc).reshape(B, Hkv, G, Sq, d)).sum(-1, keepdim=True)
    qpos = torch.arange(Sq, device=dev)[:, None] + q_offset
    lo, hi = _key_range(Sq, Skv, causal, window, q_offset)
    tiles = [(j0, min(j0 + BLOCK_K, hi)) for j0 in range(lo, hi, BLOCK_K)]

    def scores(j0, j1):
        kt = k[:, :, j0:j1].to(acc)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kt) * scale
        th = None
        if softcap is not None:
            th = torch.tanh(s / softcap)
            s = softcap * th
        kpos = torch.arange(j0, j1, device=dev)[None, :]
        mask = torch.ones((Sq, j1 - j0), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= qpos - kpos < window
        return kt, s, th, mask

    # pass 1: each row's log-sum-exp over its visible keys, online
    m = torch.full((B, Hkv, G, Sq, 1), NEG_INF, dtype=acc, device=dev)
    l = torch.zeros((B, Hkv, G, Sq, 1), dtype=acc, device=dev)
    for j0, j1 in tiles:
        _, s, _, mask = scores(j0, j1)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.where(
            mask, torch.exp(s - m_new), 0.0).sum(-1, keepdim=True)
        m = m_new
    # a row with no visible key: P = 0 on every tile (its mask), so any
    # finite lse does
    lse = torch.where(l > 0, m + torch.log(l), 0.0)

    # pass 2: the gradients, tile by tile
    dq = torch.zeros_like(qg)
    dk = torch.zeros((B, Hkv, Skv, d), dtype=acc, device=dev)
    dv = torch.zeros((B, Hkv, Skv, d), dtype=acc, device=dev)
    for j0, j1 in tiles:
        kt, s, th, mask = scores(j0, j1)
        p = torch.where(mask, torch.exp(s - lse), 0.0)
        dv[:, :, j0:j1] = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v[:, :, j0:j1].to(acc))
        ds = p * (dp - dsum)
        if th is not None:
            ds = ds * (1.0 - th * th)
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, kt)
        dk[:, :, j0:j1] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    dq = (dq * scale).reshape(B, Hq, Sq, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """K13 forward, FlashAttention-2 backward in plain torch."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, softcap, q_offset):
        o = ops.flash_attention(q, k, v, causal=causal, scale=scale,
                                window=window, softcap=softcap,
                                q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o)
        ctx.kw = dict(causal=causal, scale=scale, window=window,
                      softcap=softcap, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


class WKV6Fn(torch.autograd.Function):
    """K14 forward; backward through the differentiable chunked form."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        o, state = ops.wkv6(r, k, v, w, u, initial_state=s0,
                            return_state=True)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return o, state

    @staticmethod
    def backward(ctx, do, dstate):
        saved = ctx.saved_tensors
        want = [i for i, t in enumerate(saved)
                if t is not None and ctx.needs_input_grad[i]]
        ins = [None if t is None else t.detach().requires_grad_(i in want)
               for i, t in enumerate(saved)]
        # on meta tensors (the dry run) the chunked form's products batched
        # over the chunks: the same FLOPs without a loop of T / 16 steps
        form = (ref.wkv6_chunked_batched if saved[0].device.type == "meta"
                else ref.wkv6_chunked)
        with torch.enable_grad():
            o, state = form(*ins[:5], initial_state=ins[5],
                            return_state=True)
            got = torch.autograd.grad((o, state), [ins[i] for i in want],
                                      (do, dstate), allow_unused=True)
        grads = [None] * len(saved)
        for i, g in zip(want, got):
            grads[i] = torch.zeros_like(saved[i]) if g is None else g
        return tuple(grads)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window: int | None = None,
                    softcap: float | None = None, q_offset: int = 0):
    """``ops.flash_attention`` (K13), through :class:`FlashAttentionFn`
    where a gradient is wanted."""
    if not _needs_grad(q, k, v):
        return ops.flash_attention(q, k, v, causal=causal, scale=scale,
                                   window=window, softcap=softcap,
                                   q_offset=q_offset)
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    return FlashAttentionFn.apply(q, k, v, causal, scale, window, softcap,
                                  q_offset)


def wkv6(r, k, v, w, u, *, initial_state=None, return_state: bool = False):
    """``ops.wkv6`` (K14), through :class:`WKV6Fn` where a gradient is
    wanted."""
    if not _needs_grad(r, k, v, w, u, initial_state):
        return ops.wkv6(r, k, v, w, u, initial_state=initial_state,
                        return_state=return_state)
    o, state = WKV6Fn.apply(r, k, v, w, u, initial_state)
    return (o, state) if return_state else o
