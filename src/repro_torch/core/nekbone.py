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
for ``device="cpu"``, as the tests do.  Jacobi, Chebyshev and p-multigrid
preconditioning (core/precond.py, core/pmg.py), multi-RHS block solves
(core/cg_block.py) and iterative refinement (``precision="f32_ir"`` or
``"bf16_ir"``, core/cg_fused.py) are ported, and so are the sharded solves
over ``torch.distributed`` (``distributed/``, :meth:`NekboneCase.shard_grid`
and :meth:`NekboneCase.sharded_ax_full`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

import repro_torch.core.ax as ax_mod
import repro_torch.core.cg as cg_mod
import repro_torch.core.gs as gs_mod
import repro_torch.core.precond as precond_mod
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
               'pallas_fused_cg' runs the v1 fused iteration over K3
               (core/cg_fused.py); 'pallas_fused_cg_v2' runs the whole
               iteration in the two CUDA kernels K4 and K5
               (core/cg_fused.py); 'pallas_sstep_v3' runs s iterations
               per cycle over K8 and K9 (core/cg_sstep.py).  The names
               keep the reference package's spelling.  'auto' resolves at
               construction to v1 or v2 through
               ``kernels/autotune.pick_pipeline``: on the card both are
               timed once per (device, case key, precision policy) and
               the faster is cached; on the CPU the pick is v2;
               preconditioned cases take v2.  The requested value is kept
               in ``ax_impl_requested``.
      precision: 'f64' | 'f32' | 'bf16' | 'bf16_ir' | 'f32_ir' | None — the
               fused pipeline's precision policy (core/precision.py).
               Non-refined policies also set ``dtype`` to the storage
               dtype; a refined one keeps ``dtype`` as the outer precision
               and sends fixed-iteration solves of the fused pipelines to
               the ``ir`` route.  On the card bf16 runs over every
               route: ``reference`` (K1), v2, v1, s-step, Jacobi-,
               Chebyshev- and pmg-PCG and block CG (K1 to K12 in
               bf16).
      s:       iterations per s-step cycle (the 'pallas_sstep_v3' knob;
               ignored by every other ax_impl).
      precond: None | 'jacobi' | 'cheb' (optionally 'cheb<k>') | 'pmg'
               (optionally 'pmg[cheb<k>]') — the case's default
               preconditioner (core/precond.py).  Solves through
               'pallas_fused_cg_v2' run the fused PCG drivers (Jacobi:
               K4 + K10 per iteration; Chebyshev: K11 + K4 + K5; pmg: a
               V-cycle over K11, K4, K5 and K12, then K4 + K5); every other
               ``ax_impl`` applies the plain preconditioner inside the
               reference CG loop.  ``solve(precond=...)`` overrides it per
               call with the same names; the booleans of the reference's
               old API raise ``TypeError``.
      cheb_k:  Chebyshev polynomial order for ``precond='cheb'``.
      device:  where the fields live; ``None`` is the card.
    """

    n: int = 10
    grid: tuple[int, int, int] = (4, 4, 4)
    lengths: tuple[float, float, float] = (1.0, 1.0, 1.0)
    dtype: torch.dtype = torch.float32
    ax_impl: str = "fused"
    precision: str | None = None
    s: int = 4
    precond: str | None = None
    cheb_k: int = 4
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.precision is not None:
            from repro_torch.core.precision import resolve_policy

            policy = resolve_policy(self.precision)
            if not policy.refine:
                self.dtype = policy.storage_dtype
        self.device = _resolve_device(self.device)
        self.ax_impl_requested = self.ax_impl
        if self.ax_impl == "auto":
            from repro_torch.kernels import autotune

            self.ax_impl = autotune.pick_pipeline(
                self.grid, self.n, self.dtype,
                precision=self.precision, device=self.device,
                precond=self.precond)
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

    def _precond_name(self, precond) -> str | None:
        """Resolve a ``solve(precond=...)`` argument against the case.

        ``None`` inherits the case's ``precond`` field; a string names a
        registry preconditioner.  Booleans raise ``TypeError``, as in the
        reference, whose boolean spelling completed its deprecation.
        """
        if precond is None:
            return self.precond
        if isinstance(precond, bool):
            raise TypeError(
                "solve(precond=True|False) was removed after its "
                "deprecation cycle; pass the registry name instead "
                "(precond='jacobi', 'cheb4', ...), or omit the argument / "
                "pass precond=None for unpreconditioned.")
        return str(precond)

    def precond_spec(self, name: str | None = None):
        """The case's preconditioner spec (core/precond.py), cached.

        The Jacobi diagonal, the Chebyshev Lanczos interval and the pmg
        per-level intervals depend only on the case's operator: one-time
        set-up costs per case, not per solve.
        """
        name = name or self.precond
        if name is None:
            return None
        if name in ("cheb", "chebyshev"):
            name = f"cheb{self.cheb_k}"
        cache = self.__dict__.setdefault("_precond_specs", {})
        spec = cache.get(name)
        if spec is None:
            spec = precond_mod.make_preconditioner(
                name, D=self.D, g=self.g, grid=self.grid, mask=self.mask,
                c=self.c, lengths=self.lengths)
            cache[name] = spec
        return spec

    def _reference_preconditioner(self, name: str | None):
        """The plain ``M(r)`` of the ``reference`` route."""
        if name is None:
            return None
        spec = self.precond_spec(name)
        if isinstance(spec, precond_mod.JacobiPrecond):
            return cg_mod.jacobi_preconditioner(self.operator_diagonal())
        if isinstance(spec, precond_mod.PMGPrecond):
            from repro_torch.core.pmg import pmg_vcycle_reference

            return pmg_vcycle_reference(spec, D=self.D, g=self.g,
                                        grid=self.grid, mask=self.mask,
                                        c=self.c)
        return precond_mod.chebyshev_preconditioner(
            self.ax_full, spec.k, spec.lmin, spec.lmax)

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

    # ------------------------------------------------------------------
    def operator_diagonal(self) -> torch.Tensor:
        """diag(A) for the Jacobi preconditioner, computed structurally
        (:func:`repro_torch.core.precond.operator_diagonal`); masked rows
        are 1 to keep the inverse finite."""
        return precond_mod.operator_diagonal(self.D, self.g, self.grid,
                                 self.mask).to(self.dtype)

    # ------------------------------------------------------------------
    # Distributed (z-slab) operator set
    # ------------------------------------------------------------------
    def shard_grid(self, n_shards: int) -> tuple[int, int, int]:
        """The element grid of one of ``n_shards`` z-slabs."""
        ex, ey, ez = self.grid
        if ez % n_shards:
            raise ValueError(f"EZ={ez} not divisible by {n_shards} shards")
        return ex, ey, ez // n_shards

    def sharded_ax_full(self, mesh=None) -> Callable:
        """Per-shard assembled operator over ``mesh`` (default
        :func:`repro_torch.distributed.sharding.solver_mesh`).

        Returns ``op(u_local, g_local, mask_local, grid_local)`` on a
        shard's blocks of the fields (z-major element order makes a
        leading-axis split a z-split): the local operator, the sharded
        gather-scatter (one plane exchange), the mask.
        """
        from repro_torch.distributed import sharding

        mesh = sharding.solver_mesh() if mesh is None else mesh

        def op(u_local, g_local, mask_local, grid_local):
            w = ax_mod.ax_local(u_local, self.D, g_local, impl=self.ax_impl)
            w = gs_mod.ds_sum_sharded(w, grid_local, mesh)
            return w * mask_local

        return op
