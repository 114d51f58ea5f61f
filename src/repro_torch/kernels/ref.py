"""Plain PyTorch versions of every CUDA kernel in this package.

Each takes the kernel's own operands and returns its own outputs, so it is
both the CPU path of the kernel's wrapper (kernels/nekbone_ax.py) and the
oracle the kernel is held against on the card (``chip_smoke.py``).  They
are written for clarity, not speed.  Operands are upcast to the
accumulation dtype of the reference's ``_accum`` rule (f64 stays f64,
everything narrower accumulates in f32) and field outputs are rounded back
to the storage dtype.
"""
from __future__ import annotations

import torch

from repro_torch.core.ax import ax_local_fused, local_grad3, local_grad3_t
from repro_torch.core.geom import box_outer
from repro_torch.core.gs import ds_sum_local

__all__ = ["accum_dtype", "nekbone_ax_ref", "nekbone_ax_plain",
           "nekbone_ax_slab_plain", "nekbone_cg_update_plain"]


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """In-kernel accumulation dtype for a storage dtype."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def nekbone_ax_ref(u: torch.Tensor, D: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Oracle of the local operator on natural shapes.

    u: (E, n, n, n) [e, k, j, i];  D: (n, n);  g: (E, 6, n, n, n).
    """
    return ax_local_fused(u, D, g)


def nekbone_ax_plain(u2: torch.Tensor, D: torch.Tensor, g2: torch.Tensor, *,
                     n: int) -> torch.Tensor:
    """K1: ``w = D^T G D u``.  u2: (E, n^3); g2: (E, 6, n^3) -> (E, n^3)."""
    acc = accum_dtype(u2.dtype)
    E = u2.shape[0]
    w = ax_local_fused(u2.to(acc).reshape(E, n, n, n), D.to(acc),
                       g2.to(acc).reshape(E, 6, n, n, n))
    return w.reshape(E, n ** 3).to(u2.dtype)


def nekbone_ax_slab_plain(p2, r2, D, g3, mx, my, mz, beta, *, n: int):
    """K4: direction update, diagonal-metric masked Ax, pap partials.

    Args:
      p2, r2: (E, n^3) previous direction and residual; g3: (E, 3, n^3)
      metric diagonal (rr, ss, tt); mx, my, mz: (EX|EY|EZ, n) per-axis
      mask factors, whose lengths give the element grid (EX, EY, EZ),
      elements z-major; beta: one-element tensor.

    Returns ``(p, w, pap)``: the stored direction ``r + beta p2``, the masked
    *unassembled* operator output, and one ``sum(p * w)`` per element (E,).
    """
    acc = accum_dtype(p2.dtype)
    E = p2.shape[0]
    p = r2.to(acc) + beta.reshape(()).to(acc) * p2.to(acc)
    p = p.to(p2.dtype).to(acc)          # rounded through storage
    p4 = p.reshape(E, n, n, n)
    g = g3.to(acc).reshape(E, 3, n, n, n)
    wr, ws, wt = local_grad3(p4, D.to(acc))
    w = local_grad3_t(g[:, 0] * wr, g[:, 1] * ws, g[:, 2] * wt, D.to(acc))
    mask = box_outer(mz.to(acc), my.to(acc), mx.to(acc)).reshape(E, n, n, n)
    v = w * mask
    pap = (p4 * v).reshape(E, -1).sum(dim=1)
    return (p.to(p2.dtype).reshape(E, n ** 3),
            v.to(p2.dtype).reshape(E, n ** 3), pap)


def nekbone_cg_update_plain(x2, p2, r2, w2, alpha, cx, cy, cz, *, n: int):
    """K5: assemble w, both axpys, r·c·r partials over the stored r.

    Args:
      x2, p2, r2: (E, n^3); w2: (E, n^3) masked *unassembled* operator
      output (K4's); alpha: one-element tensor; cx, cy, cz: per-axis
      ``c = mask/mult`` factors, whose lengths give the element grid.

    Returns ``(x, r, rcr)`` with one ``sum(r * c * r)`` per element (E,).
    """
    acc = accum_dtype(x2.dtype)
    E = x2.shape[0]
    a = alpha.reshape(()).to(acc)
    grid = (cx.shape[0], cy.shape[0], cz.shape[0])
    w = ds_sum_local(w2.to(acc).reshape(E, n, n, n), grid).reshape(E, n ** 3)
    x = x2.to(acc) + a * p2.to(acc)
    r = (r2.to(acc) - a * w).to(r2.dtype)
    c = box_outer(cz.to(acc), cy.to(acc), cx.to(acc)).reshape(E, n ** 3)
    r6 = r.to(acc)
    rcr = (r6 * c * r6).sum(dim=1)
    return x.to(x2.dtype), r, rcr
