"""Shared NN building blocks: norms, activations, MLPs, RoPE.

The port of the reference's ``models/layers.py``.  Parameters live in small
``nn.Module`` containers whose attribute names are the reference's pytree
keys (``Linear.w`` and ``.b``, ``Norm.scale`` and ``.bias``, ``MLP.w_in``
...), so a reference tree maps onto them key by key
(``convert.lm_params_from_reference``).  Weights keep the reference's
``(d_in, d_out)`` layout.  ``init_norm``, ``init_linear`` and ``init_mlp``
are the reference's initialisers; they return these modules.  Parameters
are made with ``requires_grad=False``, so serving builds no graph;
``launch/steps.make_train_state`` turns them on for training
(``model.requires_grad_(True)``).  The reference's sharding constraint on
the MLP's hidden activation stands where it stands there
(``distributed/sharding.constrain``: an identity on the port's plain
tensors).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import RULES, P, constrain

__all__ = ["dtype_of", "param", "MetaGen", "normal", "Norm", "Linear", "MLP",
           "init_norm", "init_linear", "init_mlp", "rms_norm", "layer_norm",
           "softcap", "activation", "linear", "mlp", "rope"]


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class MetaGen:
    """Stands in for a ``torch.Generator`` on ``torch.device("meta")``,
    which has none: the initialisers build their tensors' shapes and dtypes
    there and draw nothing (the dry run, ``launch/dryrun.py``)."""

    device = torch.device("meta")


def normal(gen: torch.Generator, shape, scale: float,
           dtype: torch.dtype) -> nn.Parameter:
    """``N(0, 1) * scale`` from ``gen``, on ``gen``'s device (an empty
    tensor where ``gen`` is a :class:`MetaGen`)."""
    if gen.device.type == "meta":
        return param(torch.empty(shape, dtype=dtype, device=gen.device))
    return param(torch.randn(shape, generator=gen, device=gen.device,
                             dtype=dtype) * scale)


class Norm(nn.Module):
    def __init__(self, d: int, *, bias: bool = False, dtype, device):
        super().__init__()
        self.scale = param(torch.ones(d, dtype=dtype, device=device))
        self.bias = (param(torch.zeros(d, dtype=dtype, device=device))
                     if bias else None)


class Linear(nn.Module):
    def __init__(self, gen: torch.Generator, d_in: int, d_out: int, *,
                 bias: bool = False, dtype, scale: float | None = None):
        super().__init__()
        scale = d_in ** -0.5 if scale is None else scale
        self.w = normal(gen, (d_in, d_out), scale, dtype)
        self.b = (param(torch.zeros(d_out, dtype=dtype, device=gen.device))
                  if bias else None)


class MLP(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, d_ff: int, *,
                 gated: bool, dtype):
        super().__init__()
        self.w_in = Linear(gen, d, d_ff, dtype=dtype)
        self.w_out = Linear(gen, d_ff, d, dtype=dtype)
        self.w_gate = Linear(gen, d, d_ff, dtype=dtype) if gated else None


def init_norm(d: int, *, bias: bool = False, dtype=torch.float32,
              device=None) -> Norm:
    """Scale ones (and bias zeros), on ``device`` (the CPU unless given)."""
    return Norm(d, bias=bias, dtype=dtype, device=device)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype=torch.float32,
                scale: float | None = None) -> Linear:
    """``w`` = N(0, 1) x scale (d_in ** -0.5 unless given) from ``gen``, on
    its device; ``b`` zeros where ``bias``."""
    return Linear(gen, d_in, d_out, bias=bias, dtype=dtype, scale=scale)


def init_mlp(gen: torch.Generator, d: int, d_ff: int, *, gated: bool,
             dtype=torch.float32) -> MLP:
    return MLP(gen, d, d_ff, gated=gated, dtype=dtype)


def rms_norm(x: torch.Tensor, p: Norm, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm; ``plus_one`` uses the gemma-style (1 + scale) param."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    scale = p.scale.float()
    scale = 1.0 + scale if plus_one else scale
    return (x * scale).to(dt)


def layer_norm(x: torch.Tensor, p: Norm, *, eps: float = 1e-5
               ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps) * p.scale.float()
    if p.bias is not None:
        out = out + p.bias.float()
    return out.to(dt)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":            # nemotron-4 squared ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


def linear(x: torch.Tensor, p: Linear, compute_dtype=None) -> torch.Tensor:
    """``x @ w (+ b)``: in ``compute_dtype`` if given, else in the promoted
    dtype of x and w (as JAX promotes a bf16 x against an f32 w)."""
    dt = (compute_dtype if compute_dtype is not None
          else torch.promote_types(x.dtype, p.w.dtype))
    y = x.to(dt) @ p.w.to(dt)
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y


def mlp(x: torch.Tensor, p: MLP, *, act: str,
        compute_dtype=None) -> torch.Tensor:
    """(Gated) MLP, with the reference's TP constraint on the hidden
    activation."""
    h = linear(x, p.w_in, compute_dtype)
    h_spec = P(RULES.dp, None, RULES.div(h.shape[-1], RULES.tp))
    if p.w_gate is not None:
        h = constrain(h * activation(linear(x, p.w_gate, compute_dtype), act),
                      h_spec)
    else:
        h = constrain(activation(h, act), h_spec)
    return linear(h, p.w_out, compute_dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float) -> torch.Tensor:
    """Apply RoPE.  x: (B, S, H, hd); positions: (B, S) integer."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs             # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
