"""Public wrappers around the CUDA kernels, on natural shapes.

Each reshapes ``(E, n, n, n)`` fields to the kernels' flat ``(E, n^3)``
layout (free for contiguous tensors) and calls the kernel wrapper of
:mod:`repro_torch.kernels.nekbone_ax`, which runs the kernel on a CUDA
tensor and its plain version on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core.geom import (GEOM_RR, GEOM_RS, GEOM_RT, GEOM_SS,
                                   GEOM_ST, GEOM_TT, box_axis_factors)
from repro_torch.kernels import nekbone_ax as _ax

__all__ = ["nekbone_ax", "slab_axis_factors", "diag_metric"]


def nekbone_ax(u: torch.Tensor, D: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """Fused local Poisson operator  w = D^T (G (D u))  through K1.

    Args:
      u: (E, n, n, n) nodal values, layout [e, k, j, i].
      D: (n, n) derivative matrix (dxm1).
      g: (E, 6, n, n, n) metric fields (rr, rs, rt, ss, st, tt).
    """
    E = u.shape[0]
    n = u.shape[-1]
    w2 = _ax.nekbone_ax_cuda(u.reshape(E, n ** 3), D.contiguous(),
                             g.reshape(E, 6, n ** 3), n=n)
    return w2.reshape(u.shape)


def slab_axis_factors(grid: tuple[int, int, int], n: int, dtype: torch.dtype,
                      device):
    """Per-axis mask and c factors of the structured box, as tensors.

    Thin casting wrapper over :func:`repro_torch.core.geom.box_axis_factors`;
    the factor values (0, 1, 1/2) are exact in every supported dtype, so the
    in-kernel products reproduce the full fields bitwise.
    Returns ``((mx, my, mz), (cx, cy, cz))``.
    """
    masks, cs = box_axis_factors(grid, n)
    return (tuple(torch.as_tensor(m, dtype=dtype, device=device)
                  for m in masks),
            tuple(torch.as_tensor(c, dtype=dtype, device=device)
                  for c in cs))


def diag_metric(g: torch.Tensor, E: int, n: int) -> torch.Tensor:
    """Pack the metric to its (rr, ss, tt) diagonal, shape (E, 3, n^3).

    Accepts an already-packed (E, 3, ...) metric, or the general
    6-component one when its off-diagonal entries are zero — true for every
    axis-aligned ``BoxMesh``.  The check reads the card once, at set-up.
    """
    if g.shape[1] == 3:
        return g.reshape(E, 3, n ** 3).contiguous()
    if g.shape[1] != 6:
        raise ValueError(f"metric must have 3 or 6 components, got "
                         f"{tuple(g.shape)}")
    if bool(g[:, [GEOM_RS, GEOM_RT, GEOM_ST]].any()):
        raise ValueError(
            "the slab (v2) pipeline requires an axis-aligned (diagonal-"
            "metric) mesh; off-diagonal metric entries are non-zero")
    return g[:, [GEOM_RR, GEOM_SS, GEOM_TT]].reshape(E, 3, n ** 3).contiguous()
