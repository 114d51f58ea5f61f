"""The solve routing table: pipeline × precond × tol × multi-RHS routing.

A *route* is a named row of :data:`REGISTRY`; :func:`route_name` is the pure
function (case, request) -> row, a verbatim copy of the reference's, and
:func:`solve_case` executes it.  The facade :func:`repro_torch.solve`
dispatches through here.

Routes ported so far (every route returns :class:`SolveResult`):

=================  ======================================================
``v2``             fused v2 fixed-iters over the CUDA kernels K4 and K5
                   (core/cg_fused.py), unpreconditioned
``reference``      reference CG (cg / cg_fixed_iters) over
                   ``NekboneCase.ax_full``; K1 when ``ax_impl='pallas'``
=================  ======================================================

The other routes of the reference (``block``, ``block_loop``, ``ir``,
``sstep``, ``v2_tol``, ``v1``) and every preconditioned request raise
``NotImplementedError`` naming their ROADMAP.md item; nothing is re-routed.
"""
from __future__ import annotations

import warnings
from typing import Callable

import torch

import repro_torch.core.cg as cg_mod
import repro_torch.core.cg_fused as cg_fused_mod
from repro_torch.core.cg import SolveResult

__all__ = ["REGISTRY", "NOT_PORTED", "route_name", "solve_case", "solve"]

# one-time flag for the documented b>1 s-step fallback warning below.
_SSTEP_BLOCK_WARNED = False


def _drive_v2(case, f, *, b, niter, tol, max_iter, pc_name):
    return cg_fused_mod.cg_fused_v2_fixed_iters(
        f, D=case.D, g=case.g, grid=case.grid, niter=niter,
        mask=case.mask, c=case.c, precision=case.precision)


def _drive_reference(case, f, *, b, niter, tol, max_iter, pc_name):
    if niter is not None:
        return cg_mod.cg_fixed_iters(case.ax_full, f, niter=niter,
                                     dot=case.dot())
    return cg_mod.cg(case.ax_full, f, tol=tol, max_iter=max_iter,
                     dot=case.dot())


REGISTRY: dict[str, Callable] = {
    "v2": _drive_v2,
    "reference": _drive_reference,
}

# Routes of the reference that are still to port, and where ROADMAP.md
# lists them.
NOT_PORTED: dict[str, str] = {
    "block": "queue 1 item 11 (multi-RHS block CG)",
    "block_loop": "queue 1 item 11 (multi-RHS block CG)",
    "ir": "queue 1 item 9 (iterative refinement)",
    "sstep": "queue 1 item 10 (s-step CG)",
    "v2_tol": "queue 1 item 8 (cg_fused_tol)",
    "v1": "queue 1 item 5 (v1 fused CG)",
}


def route_name(case, *, b: int = 1, niter: int | None = None,
               pc_name: str | None = None) -> str:
    """Which registry row serves this request — one pure function."""
    fused = case.ax_impl in ("pallas_fused_cg", "pallas_fused_cg_v2",
                             "pallas_sstep_v3")
    refined = False
    if fused and case.precision is not None:
        from repro_torch.core.precision import resolve_policy

        refined = resolve_policy(case.precision).refine
    fused_v2_family = case.ax_impl in ("pallas_fused_cg_v2",
                                       "pallas_sstep_v3")
    if b > 1:
        # the batched kernels are the (unpreconditioned, non-refined) v2
        # pipeline; everything else solves per RHS through this table.
        if pc_name is None and not refined and (
                fused_v2_family or case.ax_impl == "pallas_fused_cg"):
            if case.ax_impl == "pallas_sstep_v3":
                # explicit, documented fallback: there is no batched
                # matrix-powers kernel — a b>1 s-step case runs the
                # multi-RHS *v2* block pipeline instead (same answer,
                # the v2 byte books).  Warn once per process so the
                # substitution is visible without spamming sweeps.
                global _SSTEP_BLOCK_WARNED
                if not _SSTEP_BLOCK_WARNED:
                    _SSTEP_BLOCK_WARNED = True
                    warnings.warn(
                        "b>1 on ax_impl='pallas_sstep_v3': no batched "
                        "s-step kernel exists; routing through the "
                        "multi-RHS v2 block pipeline (fused_v2_rhs<b>). "
                        "Set ax_impl='pallas_fused_cg_v2' to silence.",
                        UserWarning, stacklevel=3)
            return "block"
        return "block_loop"
    if refined and niter is not None and pc_name is None:
        return "ir"
    if case.ax_impl == "pallas_sstep_v3" and pc_name is None \
            and not refined:
        return "sstep"
    if case.ax_impl == "pallas_fused_cg_v2" and not refined:
        return "v2" if niter is not None else "v2_tol"
    if case.ax_impl == "pallas_fused_cg" and niter is not None \
            and pc_name is None and not refined:
        return "v1"
    return "reference"


def solve_case(case, f: torch.Tensor, *, b: int | None = None,
               niter: int | None = None, tol: float = 1e-8,
               max_iter: int = 1000,
               precond: str | None = None) -> SolveResult:
    """Route one solve request through the registry.

    ``b`` is the RHS batch: ``None`` infers it from ``f``'s shape (a
    leading axis ahead of (E, n, n, n) is a batch).  Only single-RHS,
    unpreconditioned requests are ported.
    """
    if precond is not None:
        raise NotImplementedError(
            f"precond={precond!r}: preconditioning is not ported yet "
            "(ROADMAP.md queue 1 item 8)")
    batched = f.ndim == 5
    if b is None:
        b = f.shape[0] if batched else 1
    if batched and f.shape[0] != b:
        raise ValueError(f"b={b} but rhs has leading batch {f.shape[0]}")
    if b > 1 and not batched:
        raise ValueError(f"b={b} needs a (b, E, n, n, n) rhs; "
                         f"got {tuple(f.shape)}")
    f_in = f[0] if (batched and b == 1) else f
    name = route_name(case, b=b, niter=niter, pc_name=None)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"route {name!r} is not ported yet (ROADMAP.md "
            f"{NOT_PORTED[name]})")
    res = REGISTRY[name](case, f_in, b=b, niter=niter, tol=tol,
                         max_iter=max_iter, pc_name=None)
    # a batched rhs always comes back batched, even at b=1.
    if batched and res.x.ndim == 4:
        res = SolveResult(x=res.x[None], history=res.history[None],
                          iters_taken=res.iters_taken[None],
                          achieved_rtol=res.achieved_rtol[None],
                          rnorm=res.rnorm[None], pipeline=res.pipeline,
                          precond=res.precond)
    return res


def solve(case_or_config, f: torch.Tensor | None = None, *,
          b: int | None = None, niter: int | None = None,
          tol: float | None = None, max_iter: int = 1000,
          precond: str | None = None, device=None) -> SolveResult:
    """Top-level solve facade (re-exported as ``repro_torch.solve``).

    Args:
      case_or_config: a :class:`repro_torch.core.nekbone.NekboneCase`, a
          :class:`repro_torch.configs.nekbone.NekboneConfig`, or an int — a
          paper-grid element count (``PAPER_CASES`` key).
      f: right-hand side, (E, n, n, n).  ``None`` solves the case's
          manufactured problem.
      niter: fixed iteration count; ``None`` = tolerance-driven.
      tol: stopping tolerance for the tol-driven mode (default 1e-8).
      device: where a case built here lives (``None``: the card); a case
          passed in keeps its own.

    Returns a :class:`SolveResult`.
    """
    case = case_or_config
    if isinstance(case, int):
        from repro_torch.configs.nekbone import PAPER_CASES

        case = PAPER_CASES[case]
    if hasattr(case, "make_case"):          # NekboneConfig
        case = case.make_case(device=device)
    if f is None:
        _, f = case.manufactured()
    return solve_case(case, f, b=b, niter=niter,
                      tol=1e-8 if tol is None else tol,
                      max_iter=max_iter, precond=precond)
