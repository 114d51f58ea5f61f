"""The solve routing table: pipeline × precond × tol × multi-RHS routing.

A *route* is a named row of :data:`REGISTRY`; :func:`route_name` is the pure
function (case, request) -> row, a verbatim copy of the reference's, and
:func:`solve_case` executes it.  The facade :func:`repro_torch.solve`
dispatches through here.

Routes ported so far (every route returns :class:`SolveResult`):

=================  ======================================================
``block``          multi-RHS batched v2 over K6 + K7 (core/cg_block.py):
                   b > 1, unpreconditioned, fixed or tolerance-driven
``block_loop``     b > 1 with a preconditioner or another pipeline: each
                   RHS through this table, the results stacked
``v2``             fused v2 fixed-iters: unpreconditioned over K4 + K5
                   (core/cg_fused.py); Jacobi over K4 + K10, Chebyshev
                   over K11 + K4 + K5, pmg over K11, K12, K4 and K5
                   (core/precond.py)
``v2_tol``         the same bodies, tolerance-driven
                   (``precond.cg_fused_tol``)
``sstep``          s-step CG over K8 + K9 (core/cg_sstep.py), fixed or
                   tolerance-driven, theta estimated once per case
``v1``             fused v1 fixed-iters over K3 (core/cg_fused.py)
``ir``             iterative refinement (a refined policy, fixed
                   iterations, no preconditioner): sweeps of v2, v1 or
                   s-step inner solves in the policy's storage, and one
                   assembled K1 in ``b``'s precision per sweep
                   (``cg_fused.cg_ir_fixed_iters``)
``reference``      reference CG (cg / cg_fixed_iters) over
                   ``NekboneCase.ax_full``, K1 when ``ax_impl='pallas'``,
                   with the plain Jacobi, Chebyshev or pmg preconditioner
=================  ======================================================

Every route of the reference is ported: :data:`NOT_PORTED` is empty.
"""
from __future__ import annotations

import warnings
from typing import Callable

import torch

import repro_torch.core.cg as cg_mod
import repro_torch.core.precond as precond_mod
from repro_torch.core.cg import SolveResult

__all__ = ["REGISTRY", "NOT_PORTED", "route_name", "solve_case", "solve"]

# one-time flag for the documented b>1 s-step fallback warning below.
_SSTEP_BLOCK_WARNED = False


def _drive_block(case, f, *, b, niter, tol, max_iter, pc_name):
    from repro_torch.core.cg_block import cg_block_fixed_iters, cg_block_tol

    if niter is not None:
        return cg_block_fixed_iters(
            f, D=case.D, g=case.g, grid=case.grid, niter=niter,
            mask=case.mask, c=case.c, precision=case.precision)
    return cg_block_tol(
        f, D=case.D, g=case.g, grid=case.grid, tol=tol, max_iter=max_iter,
        mask=case.mask, c=case.c, precision=case.precision)


def _drive_block_loop(case, f, *, b, niter, tol, max_iter, pc_name):
    """Batched requests outside the block kernels' coverage (preconditioned,
    refined, or another pipeline): each RHS routes through the registry on
    its own and the results stack."""
    parts = [_solve_resolved(case, f[j], b=1, niter=niter, tol=tol,
                             max_iter=max_iter, pc_name=pc_name)
             for j in range(f.shape[0])]
    return SolveResult(
        x=torch.stack([p.x for p in parts]),
        history=torch.stack([p.history for p in parts]),
        iters_taken=torch.stack([p.iters_taken for p in parts]),
        achieved_rtol=torch.stack([p.achieved_rtol for p in parts]),
        rnorm=torch.stack([p.rnorm for p in parts]),
        pipeline=parts[0].pipeline, precond=parts[0].precond)


def _drive_v2(case, f, *, b, niter, tol, max_iter, pc_name):
    spec = case.precond_spec(pc_name) if pc_name else None
    return precond_mod.pcg_fused_v2_fixed_iters(
        f, D=case.D, g=case.g, grid=case.grid, niter=niter, precond=spec,
        mask=case.mask, c=case.c, precision=case.precision)


def _drive_v2_tol(case, f, *, b, niter, tol, max_iter, pc_name):
    spec = case.precond_spec(pc_name) if pc_name else None
    return precond_mod.cg_fused_tol(
        f, D=case.D, g=case.g, grid=case.grid, tol=tol, max_iter=max_iter,
        precond=spec, mask=case.mask, c=case.c, precision=case.precision)


def _drive_sstep(case, f, *, b, niter, tol, max_iter, pc_name):
    from repro_torch.core.cg_sstep import cg_sstep_fixed_iters, estimate_theta

    # the basis scale depends only on the case's operator — estimate once
    # per case, not once per solve.
    theta = getattr(case, "_sstep_theta", None)
    if theta is None:
        theta = estimate_theta(case.D, case.g, case.grid, case.mask)
        case._sstep_theta = theta
    if niter is not None:
        return cg_sstep_fixed_iters(
            f, D=case.D, g=case.g, grid=case.grid, niter=niter, s=case.s,
            mask=case.mask, c=case.c, theta=theta,
            precision=case.precision)
    # tolerance-driven: the per-cycle host read checks the stored-residual
    # reduction and the f64 Gram recurrence resolves the stopping point to
    # the iteration.
    return cg_sstep_fixed_iters(
        f, D=case.D, g=case.g, grid=case.grid, niter=max_iter, s=case.s,
        mask=case.mask, c=case.c, theta=theta, tol=tol,
        precision=case.precision)


def _drive_v1(case, f, *, b, niter, tol, max_iter, pc_name):
    from repro_torch.core.cg_fused import cg_fused_fixed_iters

    return cg_fused_fixed_iters(
        f, D=case.D, g=case.g, mask=case.mask, c=case.c, grid=case.grid,
        niter=niter, precision=case.precision)


def _drive_ir(case, f, *, b, niter, tol, max_iter, pc_name):
    from repro_torch.core.cg_fused import cg_ir_fixed_iters

    variant = {"pallas_fused_cg_v2": "v2",
               "pallas_sstep_v3": "sstep"}.get(case.ax_impl, "v1")
    return cg_ir_fixed_iters(
        f, D=case.D, g=case.g, grid=case.grid, niter=niter,
        precision=case.precision, mask=case.mask, c=case.c,
        variant=variant, s=case.s)


def _drive_reference(case, f, *, b, niter, tol, max_iter, pc_name):
    M = case._reference_preconditioner(pc_name)
    if niter is not None:
        return cg_mod.cg_fixed_iters(case.ax_full, f, niter=niter,
                                     dot=case.dot(), precond=M)
    return cg_mod.cg(case.ax_full, f, tol=tol, max_iter=max_iter,
                     dot=case.dot(), precond=M)


REGISTRY: dict[str, Callable] = {
    "block": _drive_block,
    "block_loop": _drive_block_loop,
    "sstep": _drive_sstep,
    "v2": _drive_v2,
    "v2_tol": _drive_v2_tol,
    "v1": _drive_v1,
    "ir": _drive_ir,
    "reference": _drive_reference,
}

# Routes of the reference that are still to port, and where ROADMAP.md
# lists them: none.
NOT_PORTED: dict[str, str] = {}


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
    leading axis ahead of (E, n, n, n) is a batch), 1 forces a single-RHS
    solve, > 1 needs ``f`` of shape (b, E, n, n, n); a batched request
    returns a batched :class:`SolveResult`.  ``precond`` takes the registry
    names (resolved by :meth:`NekboneCase._precond_name`; booleans raise
    ``TypeError`` there).
    """
    pc_name = case._precond_name(precond)
    batched = f.ndim == 5
    if b is None:
        b = f.shape[0] if batched else 1
    if batched and f.shape[0] != b:
        raise ValueError(f"b={b} but rhs has leading batch {f.shape[0]}")
    if b > 1 and not batched:
        raise ValueError(f"b={b} needs a (b, E, n, n, n) rhs; "
                         f"got {tuple(f.shape)}")
    f_in = f[0] if (batched and b == 1) else f
    from repro_torch.obs import trace as _trace

    rec = _trace.active()
    if rec is None:            # tracing off: the plain dispatch, nothing else
        res = _solve_resolved(case, f_in, b=b, niter=niter, tol=tol,
                              max_iter=max_iter, pc_name=pc_name)
    else:
        res = _traced_solve(rec, case, f_in, b=b, niter=niter, tol=tol,
                            max_iter=max_iter, pc_name=pc_name)
    # a batched rhs always comes back batched, even at b=1.
    if batched and res.x.ndim == 4:
        res = SolveResult(x=res.x[None], history=res.history[None],
                          iters_taken=res.iters_taken[None],
                          achieved_rtol=res.achieved_rtol[None],
                          rnorm=res.rnorm[None], pipeline=res.pipeline,
                          precond=res.precond, telemetry=res.telemetry)
    return res


def _solve_resolved(case, f, *, b, niter, tol, max_iter, pc_name):
    name = route_name(case, b=b, niter=niter, pc_name=pc_name)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"route {name!r} is not ported yet (ROADMAP.md "
            f"{NOT_PORTED[name]})")
    return REGISTRY[name](case, f, b=b, niter=niter, tol=tol,
                          max_iter=max_iter, pc_name=pc_name)


def _traced_solve(rec, case, f, *, b, niter, tol, max_iter, pc_name):
    """The tracing-on dispatch: the same :func:`_solve_resolved` call (so
    the solve output is bitwise the same), in a ``solve`` span, with a
    :class:`~repro_torch.obs.metrics.SolveTelemetry` attached to the
    result's ``telemetry`` field.  The synchronize here and the iters/rtol
    reads in ``capture_solve`` are waits the tracing-off path never pays."""
    import dataclasses

    from repro_torch.kernels import autotune as _autotune
    from repro_torch.kernels.timing import stopwatch
    from repro_torch.obs import metrics as obs_metrics

    route = route_name(case, b=b, niter=niter, pc_name=pc_name)
    at0 = _autotune.cache_stats()
    sw = stopwatch()
    with rec.span("solve", route=route, b=b, niter=niter,
                  precond=pc_name, ax_impl=getattr(case, "ax_impl", None)):
        res = _solve_resolved(case, f, b=b, niter=niter, tol=tol,
                              max_iter=max_iter, pc_name=pc_name)
        if res.x.is_cuda:
            torch.cuda.synchronize(res.x.device)
    wall = sw.us()
    at1 = _autotune.cache_stats()
    rec.count("solves")
    tel = obs_metrics.capture_solve(
        res, route=route, b=b, niter=niter,
        tol=None if niter is not None else tol, wall_us=wall,
        phases={"dispatch": round(wall, 3)},
        autotune={k: at1[k] - at0.get(k, 0) for k in at1})
    return dataclasses.replace(res, telemetry=tel)


def solve(case_or_config, f: torch.Tensor | None = None, *,
          b: int | None = None, niter: int | None = None,
          tol: float | None = None, max_iter: int = 1000,
          precond: str | None = None, device=None) -> SolveResult:
    """Top-level solve facade (re-exported as ``repro_torch.solve``).

    Args:
      case_or_config: a :class:`repro_torch.core.nekbone.NekboneCase`, a
          :class:`repro_torch.configs.nekbone.NekboneConfig`, or an int — a
          paper-grid element count (``PAPER_CASES`` key).
      f: right-hand side(s), (E, n, n, n) or (b, E, n, n, n).  ``None``
          solves the case's manufactured problem (replicated to ``b``).
      b: RHS batch; default: inferred from ``f``.
      niter: fixed iteration count; ``None`` = tolerance-driven.
      tol: stopping tolerance for the tol-driven mode (default 1e-8).
      precond: ``None`` (the case's own), ``"jacobi"``, ``"cheb[<k>]"``,
          ``"pmg"`` or ``"pmg[cheb<k>]"``.
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
        if b is not None and b > 1:
            f = torch.stack([f] * b)
    return solve_case(case, f, b=b, niter=niter,
                      tol=1e-8 if tol is None else tol,
                      max_iter=max_iter, precond=precond)
