"""Mixture-of-Experts FFN: top-k routing with per-expert capacity.

The port of the reference's ``models/moe.py`` for one device.  Dispatch is
the reference's static-shape, capacity-based sort scheme:
  router logits and softmax in f32 -> top-k, gates renormalised -> stable
  sort of the (token, choice) assignments by expert id -> position within
  each expert's group -> scatter into an (E, C, d) buffer -> batched expert
  products -> gather back, weighted by the gates.
Assignments past an expert's capacity ``C`` (:func:`_capacity`) are
dropped, as in GShard/Switch and the reference.  The buffer has one row
more than E * C, a sentinel that every dropped assignment writes to and
reads 0 from: it stands in for JAX's ``mode="drop"`` scatter and
``fill_value=0`` gather.

Two things differ from the reference, for the card:
* the experts are counted with an integer ``scatter_add_`` (exact, so the
  same in any order) and not with ``bincount``, which reads its input's
  maximum back to the host;
* the combine gathers each token's k weighted rows into (T, k, d) and sums
  over k, where the reference adds them into the output with a scatter
  (``out.at[tok].add``).  On CUDA that scatter adds floats with atomics in
  an order that changes from run to run; the sum over k is the same in
  every run.

The expert products are batched matrix products (``torch.bmm``), as the
reference leaves them to XLA outside any Pallas kernel.  The reference's
expert-parallel branch (``shard_map`` over the TP axis, one ``psum``) is
not ported: it waits for ROADMAP.md queue 1 item 14, which brings the
mesh that the reference picks that branch from.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L

__all__ = ["MoE", "init_moe", "moe_ffn"]


def _capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    """Per-expert capacity.  The ``min(tokens, 16)`` floor makes tiny-token
    calls (single-token decode, smoke tests) drop-free — a token can occupy
    at most one slot per expert, so capacity >= tokens suffices there."""
    cap = max(1, -(-tokens * top_k // n_experts) if cf == 1.0
              else int(tokens * top_k / n_experts * cf) + 1)
    return max(cap, min(tokens, 16))


class MoE(nn.Module):
    """``router`` (d, E); ``w_in`` and ``w_gate`` (E, d, f); ``w_out``
    (E, f, d): the reference's keys and layouts."""

    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
        dt = L.dtype_of(cfg.param_dtype)
        s_in, s_out = d ** -0.5, f ** -0.5
        self.router = L.normal(gen, (d, E), s_in, dt)
        self.w_in = L.normal(gen, (E, d, f), s_in, dt)
        self.w_out = L.normal(gen, (E, f, d), s_out, dt)
        self.w_gate = L.normal(gen, (E, d, f), s_in, dt) if cfg.gated else None


def init_moe(gen: torch.Generator, cfg) -> MoE:
    return MoE(gen, cfg)


def _route(x: torch.Tensor, router_w: torch.Tensor, *, top_k: int,
           capacity: int):
    """Top-k routing of ``x (T, d)`` over E experts with ``capacity`` slots
    each.  Returns ``(eid, gate, slot)``, each (T * top_k,) in (token,
    choice) order: the expert, its renormalised gate, and the row of the
    (E * capacity + 1, d) buffer the assignment takes, ``E * capacity`` (the
    sentinel) where it is dropped.  Within an expert, earlier tokens take
    the earlier slots (the reference's stable sort)."""
    T = x.shape[0]
    E = router_w.shape[1]
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    gate, eid = torch.topk(probs, top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    eid, gate = eid.reshape(-1), gate.reshape(-1)
    order = torch.argsort(eid, stable=True)
    se = eid[order]
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, eid, torch.ones_like(eid))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * top_k, device=x.device) - starts[se]
    sslot = torch.where(pos < capacity, se * capacity + pos, E * capacity)
    slot = torch.empty_like(sslot)
    slot[order] = sslot
    return eid, gate, slot


def _dispatch_compute(x, router_w, w_in, w_gate, w_out, *, top_k: int,
                      capacity: int, act: str, compute_dtype) -> torch.Tensor:
    """Route ``x (T, d)`` through the experts; returns (T, d) in
    ``compute_dtype``."""
    T, d = x.shape
    E = w_in.shape[0]
    cdt = compute_dtype
    _, gate, slot = _route(x, router_w, top_k=top_k, capacity=capacity)
    kept = slot < E * capacity
    tok = torch.arange(T, device=x.device).repeat_interleave(top_k)
    buf = torch.zeros((E * capacity + 1, d), dtype=cdt, device=x.device)
    buf[slot] = x[tok].to(cdt)        # kept slots are distinct
    buf = buf[:-1].reshape(E, capacity, d)

    h = torch.bmm(buf, w_in.to(cdt))
    if w_gate is not None:
        h = h * L.activation(torch.bmm(buf, w_gate.to(cdt)), act)
    else:
        h = L.activation(h, act)
    y = torch.bmm(h, w_out.to(cdt)).reshape(E * capacity, d)
    y = torch.cat([y, y.new_zeros((1, d))])             # the sentinel's 0

    yt = y[slot] * (gate * kept).to(cdt)[:, None]       # (T * k, d)
    return yt.reshape(T, top_k, d).sum(1)


def moe_ffn(x: torch.Tensor, p: MoE, cfg) -> torch.Tensor:
    """MoE FFN on (B, S, d) activations, every expert on this device."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = _capacity(B * S, k, E, cfg.capacity_factor)
    out = _dispatch_compute(
        x.reshape(B * S, d), p.router, p.w_in, p.w_gate, p.w_out, top_k=k,
        capacity=cap, act=cfg.act, compute_dtype=L.dtype_of(cfg.compute_dtype))
    return out.reshape(B, S, d).to(x.dtype)
