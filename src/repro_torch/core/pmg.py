"""p-multigrid V-cycle preconditioner (the reference's ``core/pmg.py``,
DESIGN.md §13).

Polynomial-degree coarsening of the box Poisson operator: the same element
grid rediscretized at the GLL orders ``n -> ceil(n/2) -> ... -> 2``
(:func:`repro_torch.core.cost.pmg_degrees`), each fine level smoothed by
Chebyshev(k) on a per-level Lanczos interval, levels coupled by
tensor-product GLL interpolation (:func:`gll_interp_matrix`), and the 2^3
base level solved by a few fixed CG iterations (:func:`coarse_solve_fixed`).

The cycle is symmetric (pre- and post-smoothing with the same polynomial,
which is self-adjoint in the c-weighted inner product), and positive
definite while ``lambda q_k(lambda)`` stays in (0, 2), which the smoothing
interval ``[lmax / ratio, lmax]`` guarantees.

Transfers: prolongation is the element-local ``e_f = (J x J x J) e_c`` with
``J[i, c] = l_c(x_f[i])``; both grids contain the endpoints, so the endpoint
rows of ``J`` are exact 0/1 and prolongation keeps element-face values, and
with them continuity and the Dirichlet mask, exactly.  Restriction is the
c-weighted adjoint ``r_c = mask_c * gs(J^T (c_f * r_f))``.

This module holds the spec, the set-up (per-level rediscretization and
intervals), the per-level operands of the fused driver
(:func:`level_operands`) and the plain cycle (:func:`pmg_vcycle_reference`,
the ``reference`` route's ``M(r)`` and the fused driver's oracle).  The
fused driver is ``core/precond._pcg_pmg``, over the CUDA interpolation
kernel K12 (``kernels/csrc/nekbone_interp.cu``), K11, K4 and K5.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.ax import ax_local_fused
from repro_torch.core.cost import (PMG_COARSE_ITERS, PMG_DEFAULT_K,
                                   PMG_SMOOTH_RATIO, pmg_degrees)
from repro_torch.core.geom import BoxMesh
from repro_torch.core.gs import ds_sum_local
from repro_torch.core.sem import gll_points_weights

__all__ = ["PMG_DEFAULT_K", "PMG_COARSE_ITERS", "PMG_SMOOTH_RATIO",
           "PMGPrecond", "pmg_degrees", "gll_interp_matrix", "interp3",
           "make_pmg_preconditioner", "level_operator", "level_operands",
           "coarse_solve_fixed", "pmg_vcycle_reference"]


# ---------------------------------------------------------------------------
# GLL-to-GLL transfer matrices
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def gll_interp_matrix(n_to: int, n_from: int) -> np.ndarray:
    """``(n_to, n_from)`` Lagrange interpolation between GLL grids, f64.

    ``J[i, c] = l_c(x_to[i])`` with ``l_c`` the cardinal functions of the
    ``n_from``-point GLL grid (barycentric form).  Rows at coinciding nodes
    (always the two endpoints) are exact 0/1.  ``gll_interp_matrix(nf, nc)``
    prolongs coarse -> fine; its transpose is the unweighted core of the
    restriction.
    """
    x_to = np.asarray(gll_points_weights(n_to)[0], np.float64)
    x_from = np.asarray(gll_points_weights(n_from)[0], np.float64)
    diff = x_from[:, None] - x_from[None, :]
    np.fill_diagonal(diff, 1.0)
    wbar = 1.0 / np.prod(diff, axis=1)
    J = np.zeros((n_to, n_from), np.float64)
    for i, xt in enumerate(x_to):
        d = xt - x_from
        hit = np.abs(d) < 1e-13
        if hit.any():
            J[i, int(np.argmax(hit))] = 1.0
        else:
            t = wbar / d
            J[i] = t / t.sum()
    return J


def interp3(u: torch.Tensor, M) -> torch.Tensor:
    """Apply ``M`` (n_out, n_in) along each local axis of ``u``
    (E, n_in, n_in, n_in), in the order i, then j, then k.  Returns
    (E, n_out, n_out, n_out) in ``u``'s dtype: K12's plain version
    (:func:`repro_torch.kernels.ref.nekbone_interp_plain`) on natural
    shapes."""
    from repro_torch.kernels.ref import nekbone_interp_plain

    M = torch.as_tensor(M, dtype=u.dtype, device=u.device)
    E, nout, nin = u.shape[0], M.shape[0], M.shape[1]
    v = nekbone_interp_plain(u.reshape(E, nin ** 3), M.T, nin=nin, nout=nout)
    return v.reshape(E, nout, nout, nout)


# ---------------------------------------------------------------------------
# spec + set-up
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PMGPrecond:
    """p-multigrid V-cycle preconditioner spec (plain data, hashable).

    ``ns`` is the degree ladder fine -> coarse (``pmg_degrees(n)``);
    ``intervals`` the Chebyshev smoothing interval ``(lmax/ratio, lmax)`` of
    each smoothed level (one per ``ns[:-1]`` entry); ``k`` the smoother
    order; ``coarse_iters`` the fixed CG iteration count of the base solve.
    """

    ns: tuple[int, ...]
    k: int
    intervals: tuple[tuple[float, float], ...]
    coarse_iters: int
    lengths: tuple[float, float, float] = (1.0, 1.0, 1.0)
    name: str = dataclasses.field(default="pmg", init=False)

    def scalars(self, level: int) -> np.ndarray:
        """(k+1, 2) f64 Chebyshev recurrence table of a smoothed level."""
        from repro_torch.core.precond import cheb_scalars

        lmin, lmax = self.intervals[level]
        return cheb_scalars(self.k, lmin, lmax)


@functools.lru_cache(maxsize=64)
def _level_mesh(n: int, grid: tuple[int, int, int],
                lengths: tuple[float, float, float]) -> BoxMesh:
    return BoxMesh(n, grid, lengths)


def level_operator(n: int, grid: tuple[int, int, int],
                   lengths: tuple[float, float, float] = (1.0, 1.0, 1.0), *,
                   dtype: torch.dtype = torch.float64, device="cpu"):
    """Rediscretized operator data at GLL order ``n``: ``(D, g, mask, c)``
    as tensors of ``dtype`` on ``device`` (``g``: (E, 6, n, n, n), the
    others (E, n, n, n), ``D``: (n, n)).

    The coarse levels are rediscretizations, not Galerkin products: the
    same box at a lower order, so every level is an operator the kernels
    already implement.
    """
    mesh = _level_mesh(int(n), tuple(grid), tuple(lengths))
    mask = mesh.dirichlet_mask()
    arrays = (mesh.ops.D, mesh.geometric_factors(), mask,
              mask / mesh.multiplicity())
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in arrays)


def make_pmg_preconditioner(*, D: torch.Tensor, g: torch.Tensor,
                            grid: tuple[int, int, int],
                            mask: torch.Tensor | None = None,
                            c: torch.Tensor | None = None,
                            k: int = PMG_DEFAULT_K,
                            lengths: tuple[float, float, float] = (1, 1, 1),
                            coarse_iters: int = PMG_COARSE_ITERS,
                            smooth_ratio: float = PMG_SMOOTH_RATIO,
                            intervals=None) -> PMGPrecond:
    """Build a :class:`PMGPrecond` for the operator ``(D, g)`` on ``grid``.

    Per smoothed level, ``lmax`` comes from the weighted-Lanczos estimate
    of the Chebyshev preconditioner
    (:func:`repro_torch.core.precond.estimate_interval`): level 0 on the
    caller's operator data when ``mask`` is given, every other level on its
    rediscretization (float64, on ``D``'s device).  The smoothing interval
    is ``[lmax / smooth_ratio, lmax]``.  ``intervals`` overrides the
    estimate (a tuple of per-level ``(lmin, lmax)``).
    """
    from repro_torch.core.precond import estimate_interval

    grid = tuple(grid)
    n = int(D.shape[-1])
    ns = pmg_degrees(n)
    if len(ns) < 2:
        raise ValueError(f"pmg needs n >= 3 to coarsen, got n = {n}")
    if intervals is not None:
        intervals = tuple((float(a), float(b)) for a, b in intervals)
        if len(intervals) != len(ns) - 1:
            raise ValueError(f"need {len(ns) - 1} per-level intervals for "
                             f"ladder {ns}, got {len(intervals)}")
    else:
        ivs = []
        for lev, nl in enumerate(ns[:-1]):
            if lev == 0 and mask is not None:
                lmax = estimate_interval(D, g, grid, mask, c)[1]
            else:
                Dl, gl, ml, cl = level_operator(nl, grid, lengths,
                                                device=D.device)
                lmax = estimate_interval(Dl, gl, grid, ml, cl)[1]
            ivs.append((lmax / float(smooth_ratio), lmax))
        intervals = tuple(ivs)
    return PMGPrecond(ns=ns, k=int(k), intervals=intervals,
                      coarse_iters=int(coarse_iters),
                      lengths=tuple(float(x) for x in lengths))


@functools.lru_cache(maxsize=8)
def level_operands(spec: PMGPrecond, grid: tuple[int, int, int],
                   op_dtype: torch.dtype, acc_dtype: torch.dtype,
                   device: str):
    """Per-level operands of the fused driver, built once per spec, grid,
    dtypes and device (the counterpart of the reference's
    ``pmg_level_pytree``).

    Returns ``(levels, coarse)``.  ``levels[l]`` for every smoothed level
    but the finest (whose operator data the driver takes from the caller)
    and the finest's transfer data, as dicts:

    * ``coef`` — the (k+1, 2) Chebyshev table (``acc_dtype``);
    * ``J`` / ``Jt`` — ``gll_interp_matrix(ns[l], ns[l+1])`` and its
      transpose in ``op_dtype``: K12 with ``mt = J`` restricts, with
      ``mt = Jt`` prolongs;
    * for ``l >= 1``: ``D``, ``g3`` and the factors ``m``/``c`` of the
      rediscretized level (``op_dtype``), the operands K4, K5 and K11 take.

    ``coarse`` is ``(D, g, mask, c)`` of the base level in natural shapes
    (``acc_dtype``) for :func:`coarse_solve_fixed`.
    """
    from repro_torch.kernels import ops as kernel_ops

    ns = spec.ns
    E = grid[0] * grid[1] * grid[2]
    levels = []
    for lev in range(len(ns) - 1):
        J = torch.as_tensor(gll_interp_matrix(ns[lev], ns[lev + 1]),
                            dtype=op_dtype, device=device)
        o = dict(n=ns[lev], J=J.contiguous(), Jt=J.T.contiguous(),
                 coef=torch.as_tensor(spec.scalars(lev), dtype=acc_dtype,
                                      device=device))
        if lev > 0:
            Dl, gl, _, _ = level_operator(ns[lev], grid, spec.lengths,
                                          dtype=op_dtype, device=device)
            o["m"], o["c"] = kernel_ops.slab_axis_factors(grid, ns[lev],
                                                          op_dtype, device)
            o["D"] = Dl.contiguous()
            o["g3"] = kernel_ops.diag_metric(gl, E, ns[lev])
        levels.append(o)
    coarse = level_operator(ns[-1], grid, spec.lengths, dtype=acc_dtype,
                            device=device)
    return tuple(levels), coarse


# ---------------------------------------------------------------------------
# base solve: shared by the fused and the plain cycles
# ---------------------------------------------------------------------------

def coarse_solve_fixed(r: torch.Tensor, D: torch.Tensor, g: torch.Tensor,
                       grid: tuple[int, int, int], mask: torch.Tensor,
                       c: torch.Tensor, *, iters: int) -> torch.Tensor:
    """``iters`` fixed CG iterations on the rediscretized base operator.

    Plain torch (``ax_local_fused`` + ``ds_sum_local`` + mask; c-weighted
    dots) from a zero initial guess.  The base system is tiny, so CG can
    converge exactly within ``iters``: the zero-guarded alpha and beta
    (``torch.where``, no host read) turn further iterations into no-ops
    instead of 0/0 NaNs.
    """
    grid = tuple(grid)

    def A(v):
        return ds_sum_local(ax_local_fused(v, D, g), grid) * mask

    def dot(u, v):
        return torch.sum(u * c * v)

    def safe_div(num, den):
        nz = den != 0
        return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                           torch.zeros_like(num))

    x = torch.zeros_like(r)
    res, p, rtz = r, r, dot(r, r)
    for _ in range(int(iters)):
        w = A(p)
        alpha = safe_div(rtz, dot(p, w))
        x = x + alpha * p
        res = res - alpha * w
        rtz_new = dot(res, res)
        beta = safe_div(rtz_new, rtz)
        p = res + beta * p
        rtz = rtz_new
    return x


# ---------------------------------------------------------------------------
# plain V-cycle: the reference route's M(r) and the fused driver's oracle
# ---------------------------------------------------------------------------

def pmg_vcycle_reference(spec: PMGPrecond, *, D: torch.Tensor,
                         g: torch.Tensor, grid: tuple[int, int, int],
                         mask: torch.Tensor, c: torch.Tensor):
    """Plain symmetric V-cycle ``M(r)`` on natural ``(E, n, n, n)`` fields.

    Level 0 runs on the caller's operator data (``D``/``g``/``mask``/``c``,
    the case's own fields); coarser levels on their rediscretizations in
    the same dtype and device.  Chebyshev pre-smooth, restrict the
    residual, recurse, prolong-correct, Chebyshev post-smooth; the base
    level by :func:`coarse_solve_fixed`.
    """
    grid = tuple(grid)
    ns = spec.ns
    L = len(ns)
    levels = [(D, g, mask, c)]
    for lev in range(1, L):
        levels.append(level_operator(ns[lev], grid, spec.lengths,
                                     dtype=g.dtype, device=g.device))
    transfers = [gll_interp_matrix(ns[lev], ns[lev + 1])
                 for lev in range(L - 1)]
    coefs = [spec.scalars(lev).tolist() for lev in range(L - 1)]

    def apply_a(v, lev):
        Dl, gl, ml, _ = levels[lev]
        return ds_sum_local(ax_local_fused(v, Dl, gl), grid) * ml

    def smooth(r, lev):
        coef = coefs[lev]
        d = coef[0][0] * r
        z = d
        res = r
        for i in range(1, spec.k + 1):
            res = res - apply_a(d, lev)
            d = coef[i][0] * d + coef[i][1] * res
            z = z + d
        return z

    def restrict(res, lev):
        t = interp3(res * levels[lev][3], transfers[lev].T)   # J^T (c_f r_f)
        return ds_sum_local(t, grid) * levels[lev + 1][2]

    def prolong(e, lev):
        return interp3(e, transfers[lev]) * levels[lev][2]

    def cycle(r, lev):
        if lev == L - 1:
            Dc, gc, mc, cc = levels[lev]
            return coarse_solve_fixed(r, Dc, gc, grid, mc, cc,
                                      iters=spec.coarse_iters)
        z = smooth(r, lev)
        z = z + prolong(
            cycle(restrict(r - apply_a(z, lev), lev), lev + 1), lev)
        return z + smooth(r - apply_a(z, lev), lev)

    def M(r):
        return cycle(r, 0)

    return M
