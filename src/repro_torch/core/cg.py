"""Conjugate-gradient solvers, matching Nekbone's CG structure.

Nekbone stores vectors element-wise *duplicated* (each shared node appears in
every touching element); inner products therefore use a weight ``c`` equal to
``mask / multiplicity`` so each unique DOF is counted once.  The operator
``A`` is matrix-free: local tensor-product, gather-scatter, boundary mask.

Provided solvers:
  * :func:`cg` — tolerance-driven.
  * :func:`cg_fixed_iters` — fixed iteration count (Nekbone runs 100);
    returns the residual-norm history for benchmarking.
  * :func:`ir_solve` — generic mixed-precision iterative refinement around
    any inner solve (the fused pipelines' own refinement loop is
    ``cg_fused.cg_ir_fixed_iters``).

Both are Python loops over device tensors: ``alpha``, ``beta``, the inner
products and the history stay on the device, so the fixed-iteration loop
never waits for the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

__all__ = ["CGResult", "SolveResult", "cg", "cg_fixed_iters", "weighted_dot",
           "ir_solve", "jacobi_preconditioner"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor          # scalar int
    rnorm: torch.Tensor          # final weighted residual norm (sqrt(r.c.r))
    rnorm_history: torch.Tensor  # (max_iter+1,) padded with nan


@dataclasses.dataclass(eq=False)
class SolveResult:
    """Named result of every public solve entry point.

    The solution, the residual-norm history, how many iterations ran, the
    achieved relative tolerance ``rnorm / history[0]``, and which pipeline
    produced it.  Iterating still unpacks as the legacy two-tuple
    ``x, hist = result``, and the :class:`CGResult` attribute surface
    (``iters``, ``rnorm_history``) is aliased.
    """

    x: torch.Tensor
    history: torch.Tensor
    iters_taken: torch.Tensor
    achieved_rtol: torch.Tensor
    rnorm: torch.Tensor
    pipeline: str | None = None
    precond: str | None = None
    # host-side telemetry (obs/metrics.SolveTelemetry), attached by
    # solvers.solve_case only when a trace recorder is active
    telemetry: object = None

    # -- legacy (x, hist) tuple protocol --------------------------------
    def __iter__(self):
        return iter((self.x, self.history))

    def __len__(self) -> int:
        return 2

    def __getitem__(self, i):
        return (self.x, self.history)[i]

    # -- CGResult attribute aliases -------------------------------------
    @property
    def iters(self):
        return self.iters_taken

    @property
    def rnorm_history(self):
        return self.history

    @classmethod
    def from_cg(cls, res: CGResult, *, pipeline: str | None = None,
                precond: str | None = None) -> "SolveResult":
        """Lift a :class:`CGResult` into the named surface."""
        hist = res.rnorm_history
        r0 = hist[..., 0]
        denom = torch.where(r0 > 0, r0, torch.ones_like(r0))
        return cls(x=res.x, history=hist, iters_taken=res.iters,
                   achieved_rtol=res.rnorm / denom, rnorm=res.rnorm,
                   pipeline=pipeline, precond=precond)


def weighted_dot(c: torch.Tensor) -> Callable:
    """Nekbone ``glsc3``: ``dot(u, v) = sum(u * c * v)``."""

    def dot(u, v):
        return torch.sum(u * c * v)

    return dot


def _plain_dot(u, v):
    return torch.vdot(u.reshape(-1), v.reshape(-1))


# How often the tolerance-driven loop reads its stop flag on the host.
_CHECK_EVERY = 10


def cg(A: Callable, b: torch.Tensor, *, x0=None, dot: Callable | None = None,
       max_iter: int = 100, tol: float = 1e-8, precond: Callable | None = None,
       ) -> SolveResult:
    """Preconditioned conjugate gradients with early exit.

    The reference runs a ``while_loop``.  Here each iteration is computed
    under a device-side ``live`` flag that freezes the state once the
    residual has met ``tol``, and the host reads that flag once every
    ``_CHECK_EVERY`` iterations to stop the loop.  The frozen iterations
    change nothing, so the result is the while-loop's.
    """
    dot = dot or _plain_dot
    M = precond or (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x) if x0 is not None else b
    z = M(r)
    p = z
    rtz = dot(r, z)
    r0 = torch.sqrt(torch.abs(dot(r, r)))
    hist = torch.full((max_iter + 1,), float("nan"), dtype=r0.dtype,
                      device=b.device)
    hist[0] = r0
    slots = torch.arange(max_iter + 1, device=b.device)
    tol2 = torch.tensor(tol, dtype=r0.dtype, device=b.device) ** 2
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    rn = r0
    for it in range(max_iter):
        live = torch.abs(rtz) > tol2      # with M=I, rtz = r.c.r
        if it % _CHECK_EVERY == 0 and not bool(live):
            break
        w = A(p)
        pap = dot(p, w)
        alpha = rtz / pap
        x_new = x + alpha * p
        r_new = r - alpha * w
        z = M(r_new)
        rtz_new = dot(r_new, z)
        beta = rtz_new / rtz
        p_new = z + beta * p
        rn_new = torch.sqrt(torch.abs(dot(r_new, r_new)))
        x = torch.where(live, x_new, x)
        r = torch.where(live, r_new, r)
        p = torch.where(live, p_new, p)
        rtz = torch.where(live, rtz_new, rtz)
        rn = torch.where(live, rn_new, rn)
        hist = torch.where(live & (slots == k + 1), rn_new, hist)
        k = k + live.to(k.dtype)
    return SolveResult.from_cg(
        CGResult(x=x, iters=k, rnorm=rn, rnorm_history=hist),
        pipeline="reference")


def cg_fixed_iters(A: Callable, b: torch.Tensor, *, niter: int,
                   dot: Callable | None = None, x0=None,
                   precond: Callable | None = None) -> SolveResult:
    """Nekbone-style CG: exactly ``niter`` iterations."""
    dot = dot or _plain_dot
    M = precond or (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - A(x)
    z = M(r)
    p = z
    rtz = dot(r, z)
    norms = [torch.sqrt(torch.abs(dot(r, r)))]
    for _ in range(niter):
        w = A(p)
        pap = dot(p, w)
        alpha = rtz / pap
        x = x + alpha * p
        r = r - alpha * w
        z = M(r)
        rtz_new = dot(r, z)
        beta = rtz_new / rtz
        p = z + beta * p
        norms.append(torch.sqrt(torch.abs(dot(r, r))))
        rtz = rtz_new
    hist = torch.stack(norms)
    return SolveResult.from_cg(
        CGResult(x=x, iters=torch.tensor(niter, device=b.device),
                 rnorm=hist[niter], rnorm_history=hist),
        pipeline="reference")


def ir_solve(A_hi: Callable, b: torch.Tensor, inner_solve: Callable, *,
             outer_iters: int = 3,
             lo_dtype: torch.dtype = torch.float32) -> SolveResult:
    """Mixed-precision iterative refinement.

    ``x_{k+1} = x_k + inner_solve(lo(b - A_hi x_k))`` with the residual
    formed in the precision of ``b`` and the correction solved in
    ``lo_dtype``.  Returns a :class:`SolveResult` whose ``history`` holds
    the ``outer_iters + 1`` outer residual 2-norms.
    """
    hi = b.dtype
    x = torch.zeros_like(b)
    norms = [torch.linalg.vector_norm(b)]
    for _ in range(outer_iters):
        r = b - A_hi(x)
        e = inner_solve(r.to(lo_dtype))
        x = x + e.to(hi)
        norms.append(torch.linalg.vector_norm(b - A_hi(x)))
    hist = torch.stack(norms)
    return SolveResult.from_cg(
        CGResult(x=x, iters=torch.tensor(outer_iters, device=b.device),
                 rnorm=hist[-1], rnorm_history=hist),
        pipeline="ir")


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """Diagonal (Jacobi) preconditioner — the paper's future-work item."""
    inv = torch.where(diag != 0, 1.0 / diag, torch.zeros_like(diag))

    def M(r):
        return r * inv

    return M
