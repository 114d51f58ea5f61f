"""AdamW with decoupled weight decay, global-norm clipping, and configurable
moment dtypes (bf16 moments for the largest archs, ``cfg.opt_moment_dtype``).

The port of the reference's ``optim/adamw.py``: the standard
Loshchilov-Hutter update with bias correction, in the reference's order of
operations.  ``torch.optim.AdamW`` is not used: it adds eps after dividing
by ``sqrt(b2c)``, applies the decay as a separate multiply (both round
differently), and has no global-norm clipping.

Parameters, gradients and moments are dicts keyed by parameter name (the
reference's pytrees).  :func:`adamw_update` writes the new parameters and
moments into the given tensors, in place under ``torch.no_grad()`` (the
counterpart of the reference's donated buffers), a slice of each leaf at a
time so that its float32 temporaries stay small beside the state.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm"]

# elements of a leaf updated at once: bounds the f32 temporaries of a leaf
# (the reference's are whole leaves, which XLA fuses away)
_SLICE = 1 << 25


@dataclasses.dataclass
class AdamWState:
    step: int                 # updates taken
    mu: dict                  # first moment, {name: tensor like the param}
    nu: dict                  # second moment


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d tensor on
    the leaves' device)."""
    total = None
    for g in tree.values():
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_init(params: dict, *, moment_dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    return AdamWState(step=0, mu={k: zeros(p) for k, p in params.items()},
                      nu={k: zeros(p) for k, p in params.items()})


def _flat(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError("adamw_update updates contiguous tensors in place")
    return t.view(-1)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float | None = 1.0,
                 grad_norm: torch.Tensor | None = None):
    """One AdamW step over every leaf of ``params`` (decay on every leaf, as
    in the reference).  Parameters and moments are updated in place; the
    math is float32, cast back to each parameter's and moment's dtype.
    ``grad_norm``: the global norm of the gradients, where the leaves are
    one rank's blocks of them (``launch/steps.py``); default
    :func:`global_norm` of ``grads``.

    Returns ``(params, new_state, metrics)`` with ``metrics["grad_norm"]``
    the pre-clip global norm (a 0-d float32 tensor).
    """
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = None
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    step = state.step + 1
    f32 = torch.float32
    dev = gnorm.device
    b1c = 1.0 - torch.tensor(b1, dtype=f32, device=dev) ** step
    b2c = 1.0 - torch.tensor(b2, dtype=f32, device=dev) ** step
    for name, p in params.items():
        g, m, v = grads[name], state.mu[name], state.nu[name]
        if scale is not None:
            g = g * scale.to(g.dtype)
        pf, gf, mf, vf = _flat(p), g.reshape(-1), _flat(m), _flat(v)
        for i in range(0, pf.numel(), _SLICE):
            sl = slice(i, i + _SLICE)
            g32 = gf[sl].to(f32)
            m32 = mf[sl].to(f32) * b1 + g32 * (1 - b1)
            v32 = vf[sl].to(f32) * b2 + g32 * g32 * (1 - b2)
            mh = m32 / b1c
            vh = v32 / b2c
            delta = mh / (torch.sqrt(vh) + eps) \
                + weight_decay * pf[sl].to(f32)
            pf[sl] = (pf[sl].to(f32) - lr * delta).to(p.dtype)
            mf[sl] = m32.to(m.dtype)
            vf[sl] = v32.to(v.dtype)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}
