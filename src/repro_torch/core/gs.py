"""Gather-scatter (direct stiffness summation) for the structured box mesh.

Nekbone's ``gs_op`` sums the values of coincident nodes on shared element
faces/edges/corners so every copy holds the assembled value.  On the
structured box this reduces to, per direction, summing the two coincident
node planes of neighbouring elements — x, then y, then z, so edge and
corner nodes sum in one fixed tree.  The CUDA update kernel
(``kernels/csrc/nekbone_cg_update.cu``) reproduces this tree node by node.

Distribution (the reference's ``ds_sum_sharded``): elements are split
along the outermost element-grid axis, z, into contiguous slabs, one per
shard of a :class:`repro_torch.distributed.sharding.SolverMesh`.  Each
shard runs the local pass, then exchanges its outer boundary planes with
its neighbours (the reference's ``halo_exchange_z``, here
``sharding.ppermute_pair``: one ``batch_isend_irecv`` of both directions) and adds what arrived: the torch analog of Nekbone's
nearest-neighbour MPI exchange.  The cross-shard interface is a z plane
and the x and y sums act within it on each side alone, so local-then-
exchange assembles every node, and each node's sum keeps the x, y, z tree.
A hierarchy of axes, such as the reference's ``('pod', 'data')`` mesh, is
one group whose ranks run in the flattened order (``solver_mesh(order=)``).
"""
from __future__ import annotations

import torch

__all__ = ["ds_sum_local", "ds_sum_sharded", "edge_planes"]


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


def ds_sum_sharded(u: torch.Tensor, grid_local: tuple[int, int, int],
                   mesh) -> torch.Tensor:
    """Direct-stiffness sum where the z element axis is sharded.

    ``u`` is this shard's block ``(E_local, n, n, n)`` of a z-major field
    and ``grid_local`` its element grid ``(EX, EY, EZ_local)``.  The local
    pass runs first; then the plane at local ``k = n-1`` of the top layer
    goes to the next shard and the plane at ``k = 0`` of the bottom layer
    to the previous one (``sharding.ppermute_pair``), and the planes that
    arrive are added where the single-shard sum adds its neighbour's
    value.  The input is not modified.
    """
    from repro_torch.distributed.sharding import ppermute_pair

    ex, ey, ez_l = grid_local
    n = u.shape[-1]
    v = ds_sum_local(u, grid_local).reshape(ez_l, ey, ex, n, n, n)
    top = v[-1, :, :, -1].contiguous()     # (ey, ex, n, n) at local k = n-1
    bottom = v[0, :, :, 0].contiguous()
    from_below, from_above = ppermute_pair(top, bottom, mesh)
    v[0, :, :, 0] += from_below
    v[-1, :, :, -1] += from_above
    return v.reshape(u.shape)


def edge_planes(w: torch.Tensor, grid_local: tuple[int, int, int],
                dtype: torch.dtype | None = None):
    """The x-then-y assembled bottom and top faces of a shard's block.

    ``w`` is ``(E_local, n^3)`` or ``(E_local, n, n, n)``, unassembled.
    Returns ``(bottom, top)``, each ``(EY*EX, n, n)`` in ``dtype`` (default
    ``w``'s; the face values are cast before they are summed): the
    ``k = 0`` face of the bottom element layer and the ``k = n-1`` face of
    the top one, summed over x, then y, in :func:`ds_sum_local`'s tree —
    the values a neighbour shard's z step adds (the plane operands of K5
    and K10).
    """
    ex, ey, ez_l = grid_local
    n = round(w[0].numel() ** (1.0 / 3.0))
    v = w.reshape(ez_l, ey, ex, n, n, n)
    faces = torch.stack([v[0, :, :, 0], v[-1, :, :, -1]]).to(
        dtype or w.dtype)                              # (2, ey, ex, n, n)
    if ex > 1:
        s = faces[:, :, :-1, :, -1] + faces[:, :, 1:, :, 0]
        faces[:, :, :-1, :, -1] = s
        faces[:, :, 1:, :, 0] = s
    if ey > 1:
        s = faces[:, :-1, :, -1, :] + faces[:, 1:, :, 0, :]
        faces[:, :-1, :, -1, :] = s
        faces[:, 1:, :, 0, :] = s
    faces = faces.reshape(2, ey * ex, n, n)
    return faces[0].contiguous(), faces[1].contiguous()
