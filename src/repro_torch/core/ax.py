"""Local spectral-element Poisson operator ``w = D^T (G (D u))`` per element.

Three implementations, mirroring the paper's version ladder:

* :func:`ax_local_listing1` — the paper's Listing 1: two passes with
  ``ur/us/ut`` materialized between them.
* :func:`ax_local_fused` — the same math as one expression.  Eager torch
  materializes the intermediates of both, so the two differ only in name
  here; both are plain ``torch.einsum`` code.
* ``kernels/csrc/nekbone_ax.cu`` (via :func:`ax_local`) — the paper's
  optimized 2-D-thread-structure CUDA kernel.

Layout: ``u[e, k, j, i]`` with ``i`` <-> x <-> the paper's ``r`` direction.
``D[a, b] = dl_b/dx(x_a)`` so an x-derivative contracts ``u``'s last axis with
``D``'s second axis.  ``g[e, m, k, j, i]`` with m in (rr, rs, rt, ss, st, tt).
"""
from __future__ import annotations

import torch

__all__ = ["ax_local_listing1", "ax_local_fused", "local_grad3", "local_grad3_t",
           "apply_metric", "ax_local"]


def local_grad3(u: torch.Tensor, D: torch.Tensor):
    """Reference-space gradient: returns (wr, ws, wt), each like ``u``.

    wr[e,k,j,i] = sum_l D[i,l] u[e,k,j,l]   (x / r direction)
    ws[e,k,j,i] = sum_l D[j,l] u[e,k,l,i]   (y / s direction)
    wt[e,k,j,i] = sum_l D[k,l] u[e,l,j,i]   (z / t direction)
    """
    wr = torch.einsum("il,ekjl->ekji", D, u)
    ws = torch.einsum("jl,ekli->ekji", D, u)
    wt = torch.einsum("kl,elji->ekji", D, u)
    return wr, ws, wt


def local_grad3_t(ur: torch.Tensor, us: torch.Tensor, ut: torch.Tensor,
                  D: torch.Tensor) -> torch.Tensor:
    """Transposed gradient (assembly of weak-form contributions).

    w[e,k,j,i] = sum_l D[l,i] ur[e,k,j,l] + D[l,j] us[e,k,l,i]
                 + D[l,k] ut[e,l,j,i]
    """
    w = torch.einsum("li,ekjl->ekji", D, ur)
    w = w + torch.einsum("lj,ekli->ekji", D, us)
    w = w + torch.einsum("lk,elji->ekji", D, ut)
    return w


def apply_metric(wr, ws, wt, g):
    """Apply the 6-entry symmetric metric: (ur, us, ut) = G @ (wr, ws, wt)."""
    grr, grs, grt, gss, gst, gtt = (g[:, m] for m in range(6))
    ur = grr * wr + grs * ws + grt * wt
    us = grs * wr + gss * ws + gst * wt
    ut = grt * wr + gst * ws + gtt * wt
    return ur, us, ut


def ax_local_listing1(u: torch.Tensor, D: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """Paper Listing 1: two explicit passes with materialized intermediates
    (``ur, us, ut`` are whole tensors between the passes)."""
    wr, ws, wt = local_grad3(u, D)
    ur, us, ut = apply_metric(wr, ws, wt, g)
    return local_grad3_t(ur, us, ut, D)


def ax_local_fused(u: torch.Tensor, D: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """The operator as one expression (the plain oracle of the kernels)."""
    return local_grad3_t(*apply_metric(*local_grad3(u, D), g), D)


def ax_local(u: torch.Tensor, D: torch.Tensor, g: torch.Tensor, *,
             impl: str = "fused") -> torch.Tensor:
    """Dispatch between implementations (``listing1`` | ``fused`` |
    ``pallas`` | ``pallas_fused_cg`` | ``pallas_fused_cg_v2`` |
    ``pallas_sstep_v3``).

    The ``pallas*`` names keep the reference package's spelling; all of
    them apply the local operator through the CUDA kernel
    (:func:`repro_torch.kernels.ops.nekbone_ax`), and only the solve loop
    they select differs.
    """
    if impl == "listing1":
        return ax_local_listing1(u, D, g)
    if impl == "fused":
        return ax_local_fused(u, D, g)
    if impl in ("pallas", "pallas_fused_cg", "pallas_fused_cg_v2",
                "pallas_sstep_v3"):
        from repro_torch.kernels import ops as kernel_ops

        return kernel_ops.nekbone_ax(u, D, g)
    raise ValueError(f"unknown ax impl: {impl!r}")
