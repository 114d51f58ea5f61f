"""Gather-scatter (direct stiffness summation) for the structured box mesh.

Nekbone's ``gs_op`` sums the values of coincident nodes on shared element
faces/edges/corners so every copy holds the assembled value.  On the
structured box this reduces to, per direction, summing the two coincident
node planes of neighbouring elements — x, then y, then z, so edge and
corner nodes sum in one fixed tree.  The CUDA update kernel
(``kernels/csrc/nekbone_cg_update.cu``) reproduces this tree node by node.

The sharded exchange (``ds_sum_sharded``, ``halo_exchange_z``) is not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch

__all__ = ["ds_sum_local"]


def ds_sum_local(u: torch.Tensor, grid: tuple[int, int, int]) -> torch.Tensor:
    """Direct-stiffness sum over a local (un-sharded) element grid.

    Args:
      u:    ``(E, n, n, n)`` with ``E = EX*EY*EZ`` and e z-major
            (``e = (ez*EY + ey)*EX + ex``), local layout ``(k, j, i)``.
      grid: ``(EX, EY, EZ)``.

    Returns the assembled field, same shape; coincident nodes carry the sum.
    The input is not modified.
    """
    ex, ey, ez = grid
    n = u.shape[-1]
    v = u.reshape(ez, ey, ex, n, n, n).clone()

    if ex > 1:  # x-direction: face i = n-1 of (.., ex) meets i = 0 of (.., ex+1)
        s = v[:, :, :-1, :, :, -1] + v[:, :, 1:, :, :, 0]
        v[:, :, :-1, :, :, -1] = s
        v[:, :, 1:, :, :, 0] = s
    if ey > 1:  # y-direction
        s = v[:, :-1, :, :, -1, :] + v[:, 1:, :, :, 0, :]
        v[:, :-1, :, :, -1, :] = s
        v[:, 1:, :, :, 0, :] = s
    if ez > 1:  # z-direction
        s = v[:-1, :, :, -1, :, :] + v[1:, :, :, 0, :, :]
        v[:-1, :, :, -1, :, :] = s
        v[1:, :, :, 0, :, :] = s
    return v.reshape(u.shape)
