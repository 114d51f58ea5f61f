"""Multi-RHS (block) CG through the batched v2 kernels (the reference's
``core/cg_block.py``, DESIGN.md §12).

The serving side's amortization: one operator, b right-hand sides.  Each
iteration runs K6 (``kernels/csrc/nekbone_ax_slab_block.cu``), K4 over the
batch with D, the 3 metric diagonals and the mask factors read once per
element for all b lanes, and K7 (``nekbone_cg_update_block.cu``), K5 over
the batch with the weight ``c`` rebuilt once per element.  The shared
operator streams are divided by b; the vector streams stay per RHS
(:func:`repro_torch.core.cost.multi_rhs_streams`).

The CG scalars stay *independent per RHS*: rtz, alpha and beta are length-b
vectors, and the (b, E) pap and rcr partials are reduced one lane at a
time with the single-RHS ``torch.sum`` of an (E,) row, so each lane's
arithmetic is the v2 iteration's operation for operation: every lane of a
fixed-iteration block solve is bitwise its own single-RHS
:func:`repro_torch.core.cg_fused.cg_fused_v2_fixed_iters` solve, at b = 1
too.  The loop is ``core/cg_fused._run``; the tolerance-driven solve
iterates while any lane is above tol, so converged lanes keep iterating and
every lane's history is a prefix of its fixed-iteration one.

Both drivers take ``B`` of shape (b, E, n, n, n), or (E, n, n, n) as b = 1,
and return a :class:`repro_torch.core.cg.SolveResult` with a per-RHS
``history`` (b, max_iter + 1), ``rnorm`` and ``achieved_rtol`` (b,).
"""
from __future__ import annotations

import torch

from repro_torch.core.cg import SolveResult
from repro_torch.core.cg_fused import _prepare, _result, _run
from repro_torch.core.geom import box_outer
from repro_torch.kernels import nekbone_ax as _ax

__all__ = ["cg_block_fixed_iters", "cg_block_tol"]


def _lane_sums(parts: torch.Tensor) -> torch.Tensor:
    """Per-lane sums of (b, E) partials, each by the single-RHS call on
    its own contiguous (E,) row (a row-wise ``torch.sum(dim=-1)`` need not
    use the same reduction tree)."""
    return torch.stack([torch.sum(row) for row in parts])


def _block_iter(x3, r3, p3, rtz, beta, *, D, g3, mx, my, mz, cx, cy, cz,
                n: int):
    """One batched v2 CG iteration (K6 + K7), the multi-RHS sibling of
    :func:`repro_torch.core.cg_fused._v2_iter` with per-lane scalars
    (``rtz``, ``beta``: (b,)).  Returns ``(x3, r3, p3, rtz_new, beta)``."""
    p3, w3, pap_be = _ax.nekbone_ax_slab_block_cuda(p3, r3, D, g3, mx, my, mz,
                                                    beta, n=n)
    alpha = rtz / _lane_sums(pap_be)
    x3, r3, rcr_be = _ax.nekbone_cg_update_block_cuda(x3, p3, r3, w3, alpha,
                                                      cx, cy, cz, n=n)
    rtz_new = _lane_sums(rcr_be)
    return x3, r3, p3, rtz_new, rtz_new / rtz


def _block_init(B3, op, policy):
    """Initial state: per-lane rtz0 (one single-RHS-shaped reduction per
    lane, the v2 driver's own expression) and zero x, p and beta."""
    acc = policy.accum_dtype
    c2 = box_outer(op["cz"], op["cy"], op["cx"]).reshape(B3.shape[1:]) \
        .to(acc)
    rtz0 = torch.stack([torch.sum(bj.to(acc) * c2 * bj.to(acc))
                        for bj in B3])
    state = (torch.zeros(B3.shape, dtype=policy.x_storage_dtype,
                         device=B3.device),
             B3, torch.zeros_like(B3),
             torch.zeros(B3.shape[0], dtype=acc, device=B3.device))
    return state, rtz0


def _cg_block(B3, op, policy, tol2: float | None, max_iter: int):
    """Block CG over K6 + K7 under :func:`_run`; ``tol2=None`` runs exactly
    ``max_iter`` iterations."""
    state, rtz0 = _block_init(B3, op, policy)

    def body(state, rtz):
        x3, r3, p3, beta = state
        x3, r3, p3, rtz, beta = _block_iter(x3, r3, p3, rtz, beta, **op)
        return (x3, r3, p3, beta), rtz, torch.sqrt(torch.abs(rtz))

    (x3, *_), k, hist = _run(body, state, rtz0, torch.sqrt(torch.abs(rtz0)),
                             tol2, max_iter)
    return k, x3, hist


def _prepare_block(B, D, g, grid, mask, c, precision):
    """The batch-axis lift, then :func:`repro_torch.core.cg_fused._prepare`
    on one lane (policy, box-field check, operator operands).  Returns
    ``(policy, B, op)`` with ``B`` (b, E, n, n, n) in the storage dtype."""
    if B.ndim == 4:
        B = B[None]
    if B.ndim != 5:
        raise ValueError(f"cg_block expects (b, E, n, n, n) or (E, n, n, n); "
                         f"got shape {tuple(B.shape)}")
    policy, _, _, _, op = _prepare(B[0], D, g, grid, mask, c, precision)
    return policy, B.to(policy.storage_dtype), op


def _nrhs(B) -> int:
    return 1 if B.ndim == 4 else int(B.shape[0])


def _solve(B, D, g, grid, mask, c, precision, tol2, max_iter) -> SolveResult:
    policy, B, op = _prepare_block(B, D, g, grid, mask, c, precision)
    nrhs, E = B.shape[0], B.shape[1]
    k, x3, hist = _cg_block(B.reshape(nrhs, E, -1).contiguous(), op, policy,
                            tol2, max_iter)
    return SolveResult.from_cg(_result(x3, k, hist, B.shape),
                               pipeline=f"fused_v2_rhs{nrhs}")


def cg_block_fixed_iters(B: torch.Tensor, *, D: torch.Tensor, g: torch.Tensor,
                         grid: tuple[int, int, int], niter: int,
                         mask: torch.Tensor | None = None,
                         c: torch.Tensor | None = None,
                         precision=None) -> SolveResult:
    """Fixed-iteration multi-RHS CG through K6 + K7.

    Args:
      B:     (b, E, n, n, n) assembled, masked right-hand sides, or a single
             (E, n, n, n) one solved as b = 1; elements z-major over
             ``grid``.
      D, g, grid, niter, mask, c, precision: as
             :func:`repro_torch.core.cg_fused.cg_fused_v2_fixed_iters`.

    Returns a :class:`SolveResult` with per-RHS ``history`` (b, niter+1),
    ``rnorm`` and ``achieved_rtol`` (b,).  Each lane is bitwise its own
    single-RHS v2 solve.
    """
    # tracing: the host boundary of the batched solve is this dispatch,
    # one span when on
    from repro_torch.obs import trace as _trace

    rec = _trace.active()
    with (rec.span("block.dispatch", b=_nrhs(B), niter=niter)
          if rec is not None else _trace.NULL_SPAN):
        return _solve(B, D, g, grid, mask, c, precision, None, niter)


def cg_block_tol(B: torch.Tensor, *, D: torch.Tensor, g: torch.Tensor,
                 grid: tuple[int, int, int], tol: float = 1e-8,
                 max_iter: int = 100, mask: torch.Tensor | None = None,
                 c: torch.Tensor | None = None,
                 precision=None) -> SolveResult:
    """Tolerance-driven multi-RHS CG: iterate while any RHS is above
    :func:`repro_torch.core.cg.cg`'s stopping rule (``|rtz| > tol**2``,
    checked before each iteration) and ``max_iter`` is not reached.

    Converged lanes keep iterating until the whole batch is done; the
    per-RHS histories are prefixes of the fixed-iteration ones, NaN-padded
    to ``max_iter + 1``; ``iters`` is the joint count.
    """
    from repro_torch.obs import trace as _trace

    rec = _trace.active()
    with (rec.span("block.dispatch", b=_nrhs(B), tol=tol)
          if rec is not None else _trace.NULL_SPAN):
        return _solve(B, D, g, grid, mask, c, precision, float(tol) ** 2,
                      max_iter)
