"""A shard's ghost-extended grid: K8 and K11 on [ghosts | own | ghosts].

The reference's matrix-powers and Chebyshev kernels take per-block halo'd
windows (``sstep_extend_field``, ``sstep_extend_zfactor``,
``kernels/nekbone_ax.py:964-1025``): block ``i`` of ``sz`` layers with
``halo`` more on each side, zeros past the domain ends.  The port's K8 and
K11 are one launch over a whole grid, and they take per-layer factors
(``mz``, ``cz`` of shape ``(EZ, n)``) and return per-element outputs and
partials.  So a shard runs them unchanged on one extended grid,

    [depth ghost layers below | its own layers | depth ghost layers above],

with the ghost layers of the fields received from the neighbour shards and
the loop-invariant windows of ``g3``, ``mz`` and ``cz`` cut once per solve
from the global arrays; then it keeps its own layers' outputs.  A shard at
a global end gets no ghost layers on that side: the domain boundary is a
real boundary there, so no padding is added past a global end.

Why the owned layers come out exact: the kernels treat the extended grid's
outer faces as domain boundary faces, so the outermost ghost layer's outer
face misses its neighbour's sum.  Each operator application moves a wrong
value one element layer inward (the element-local operator spreads a wrong
face through its element, the assembly hands it to the next layer's face).
After ``depth`` applications it has reached only the ghost layer next to
the owned ones, and the face that layer shares with them is still exact.
K8 applies the operator s times (depth s), K11 k times (depth k).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["GhostWindow", "ghost_window"]


@dataclasses.dataclass(frozen=True)
class GhostWindow:
    """The extended z-window of one shard.

    ``z0`` is the global index of the shard's first own layer, ``ez_local``
    its own layer count, ``below``/``above`` the ghost layers it takes on
    each side (0 at a global end), ``eyex`` the elements of one layer.
    """

    z0: int
    ez_local: int
    below: int
    above: int
    eyex: int

    def extend(self, f: torch.Tensor, from_below: torch.Tensor,
               from_above: torch.Tensor) -> torch.Tensor:
        """The extended field: ``f`` (``(E_local, ...)``, z-major) between
        the received ghost slabs (each ``(depth, EY*EX, ...)``, the last
        ``below`` of ``from_below`` and the first ``above`` of
        ``from_above`` taken).  Returns ``(E_ext, ...)``, contiguous."""
        rest = f.shape[1:]
        parts = []
        if self.below:
            fb = from_below.reshape(-1, self.eyex, *rest)
            parts.append(fb[fb.shape[0] - self.below:]
                         .reshape(-1, *rest))
        parts.append(f)
        if self.above:
            fa = from_above.reshape(-1, self.eyex, *rest)
            parts.append(fa[:self.above].reshape(-1, *rest))
        return torch.cat(parts, dim=0).contiguous()

    def cut(self, f_global: torch.Tensor) -> torch.Tensor:
        """The window of a global per-element field (``(E, ...)``, z-major):
        the extended grid's elements, contiguous."""
        lo = (self.z0 - self.below) * self.eyex
        hi = (self.z0 + self.ez_local + self.above) * self.eyex
        return f_global[lo:hi].contiguous()

    def cut_z(self, fz_global: torch.Tensor) -> torch.Tensor:
        """The window of a global per-layer factor (``(EZ, n)``)."""
        lo = self.z0 - self.below
        return fz_global[lo:self.z0 + self.ez_local + self.above] \
            .contiguous()

    def own(self, f_ext: torch.Tensor) -> torch.Tensor:
        """The own layers of an extended per-element output (``(E_ext,
        ...)``): a contiguous view."""
        lo = self.below * self.eyex
        return f_ext[lo:lo + self.ez_local * self.eyex]


def ghost_window(mesh, grid: tuple[int, int, int],
                 depth: int) -> GhostWindow:
    """The ghost window of ``mesh``'s shard over the global ``grid`` with
    ``depth`` ghost layers a side (none past a global end).

    A ghost layer comes from the adjacent shard only, so ``depth`` must not
    exceed the local layer count (a deeper halo would need a multi-hop
    exchange, as in the reference).
    """
    ex, ey, ez = grid
    if ez % mesh.ndev:
        raise ValueError(f"EZ {ez} not divisible by {mesh.ndev} shards")
    ez_l = ez // mesh.ndev
    if not 0 < depth <= ez_l:
        raise ValueError(f"halo depth {depth} out of range for the local "
                         f"slab count {ez_l} (single-neighbour exchange)")
    return GhostWindow(z0=mesh.shard * ez_l, ez_local=ez_l,
                       below=0 if mesh.first else depth,
                       above=0 if mesh.last else depth, eyex=ex * ey)
