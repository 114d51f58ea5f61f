"""End-to-end Nekbone case: SEM Poisson on a box, solved with CG.

This is the composable entry point for the paper's system:

    case = NekboneCase(n=10, grid=(8, 8, 16), dtype=torch.float64)
    res, u_ex = case.solve_manufactured(niter=100)  # the paper's run
    err  = case.solution_error(res.x, u_ex)

The operator pipeline is exactly Nekbone's ``ax``:
    w = mask( gather_scatter( ax_local(u) ) )
with ``ax_local`` selectable between the paper-faithful Listing-1 version,
the fused expression (both plain torch), and the CUDA kernel.

Every field lives on ``device``.  ``device=None`` means the card
(``"cuda"``); without a CUDA device the case raises unless the caller asks
for ``device="cpu"``, as the tests do.  Sharding and preconditioning are
not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

import repro_torch.core.ax as ax_mod
import repro_torch.core.cg as cg_mod
import repro_torch.core.gs as gs_mod
from repro_torch.core.cost import CostModel
from repro_torch.core.geom import BoxMesh

__all__ = ["NekboneCase"]


def _resolve_device(device) -> torch.device:
    """``None`` -> the card; a CUDA device without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return device


@dataclasses.dataclass
class NekboneCase:
    """A runnable Nekbone problem instance.

    Args:
      n:       GLL points per direction (degree + 1). Paper uses 10.
      grid:    element grid (EX, EY, EZ).
      lengths: physical box size.
      dtype:   compute dtype (torch.float64 is the paper's precision).
      ax_impl: 'listing1' | 'fused' | 'pallas' | 'pallas_fused_cg' |
               'pallas_fused_cg_v2' | 'pallas_sstep_v3'.  'listing1' and
               'fused' are plain torch; 'pallas' applies the operator
               through the CUDA kernel K1 inside the reference CG loop;
               'pallas_fused_cg_v2' runs the whole iteration in the two
               CUDA kernels K4 and K5 (core/cg_fused.py).  The names keep
               the reference package's spelling.  'auto' (the autotuned
               pick) is not ported yet and raises.
      precision: 'f64' | 'f32' | 'bf16' | 'bf16_ir' | 'f32_ir' | None — the
               fused pipeline's precision policy.  Non-refined policies
               also set ``dtype`` to the storage dtype.
      device:  where the fields live; ``None`` is the card.
    """

    n: int = 10
    grid: tuple[int, int, int] = (4, 4, 4)
    lengths: tuple[float, float, float] = (1.0, 1.0, 1.0)
    dtype: torch.dtype = torch.float32
    ax_impl: str = "fused"
    precision: str | None = None
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.precision is not None:
            from repro_torch.core.precision import resolve_policy

            policy = resolve_policy(self.precision)
            if not policy.refine:
                self.dtype = policy.storage_dtype
        if self.ax_impl == "auto":
            raise NotImplementedError(
                "ax_impl='auto' needs the autotuned pipeline pick, not "
                "ported yet: ROADMAP.md queue 1 item 7")
        self.device = _resolve_device(self.device)
        self.mesh = BoxMesh(self.n, tuple(self.grid), tuple(self.lengths))
        ops = self.mesh.ops

        def field(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

        self.D = field(ops.D)
        self.g = field(self.mesh.geometric_factors())
        self.mask = field(self.mesh.dirichlet_mask())
        self.mult = field(self.mesh.multiplicity())
        self.c = self.mask / self.mult          # Nekbone's weight vector
        self.bmass = field(self.mesh.mass())

    # ------------------------------------------------------------------
    @property
    def cost(self) -> CostModel:
        from repro_torch.core.cost import precision_itemsize

        itemsize = (precision_itemsize(self.precision)
                    if self.precision is not None
                    else self.dtype.itemsize)
        return CostModel(self.mesh.nelt, self.n, itemsize)

    # ------------------------------------------------------------------
    def ax_local(self, u: torch.Tensor) -> torch.Tensor:
        return ax_mod.ax_local(u, self.D, self.g, impl=self.ax_impl)

    def ax_full(self, u: torch.Tensor) -> torch.Tensor:
        """Assembled, masked Poisson operator (single device)."""
        w = self.ax_local(u)
        w = gs_mod.ds_sum_local(w, self.grid)
        return w * self.mask

    # ------------------------------------------------------------------
    def manufactured(self):
        """Manufactured solution  u = prod sin(pi x_d / L_d)  and its rhs.

        Returns ``(u_exact, f)`` with f the *weak-form* right-hand side
        ``B f_strong`` assembled and masked, ready for CG.
        """
        xyz = self.mesh.coords()
        lx, ly, lz = self.lengths
        sx = np.sin(np.pi * xyz[..., 0] / lx)
        sy = np.sin(np.pi * xyz[..., 1] / ly)
        sz = np.sin(np.pi * xyz[..., 2] / lz)
        u_ex = sx * sy * sz
        lap = np.pi ** 2 * (1 / lx ** 2 + 1 / ly ** 2 + 1 / lz ** 2)
        f_strong = lap * u_ex
        f = torch.as_tensor(f_strong, dtype=self.dtype,
                            device=self.device) * self.bmass
        f = gs_mod.ds_sum_local(f, self.grid) * self.mask
        return torch.as_tensor(u_ex, dtype=self.dtype, device=self.device), f

    # ------------------------------------------------------------------
    def dot(self) -> Callable:
        return cg_mod.weighted_dot(self.c)

    def solve(self, f: torch.Tensor, *, b: int | None = None,
              niter: int | None = None, tol: float = 1e-8,
              max_iter: int = 1000,
              precond: str | None = None) -> cg_mod.SolveResult:
        """Solve ``A x = f`` through the routing table
        (:mod:`repro_torch.core.solvers`)."""
        from repro_torch.core import solvers as solvers_mod

        return solvers_mod.solve_case(self, f, b=b, niter=niter, tol=tol,
                                      max_iter=max_iter, precond=precond)

    def solve_manufactured(self, *, niter: int | None = None,
                           tol: float = 1e-8, max_iter: int = 1000,
                           precond: str | None = None):
        u_ex, f = self.manufactured()
        res = self.solve(f, niter=niter, tol=tol, max_iter=max_iter,
                         precond=precond)
        return res, u_ex

    def solution_error(self, x: torch.Tensor,
                       u_exact: torch.Tensor) -> torch.Tensor:
        """Weighted max-norm error against the exact solution."""
        return torch.max(torch.abs((x - u_exact) * self.mask))
