"""Communication-avoiding (s-step) CG over the matrix-powers kernels.

s-step CG restructures s iterations into one **cycle** (DESIGN.md §8):

1. **matrix powers** (K8, ``kernels/csrc/nekbone_ax_powers.cu``) — the
   scaled Krylov basis ``V = [p, A'p, .., A'^s p, r, A'r, .., A'^{s-1} r]``
   (``A' = A/theta``) and the per-element partials of the ``(2s+1)^2`` Gram
   block ``G = V^T C V``, summed on the device;
2. **host recurrence** (:func:`sstep_recurrence`) — every alpha and beta of
   the cycle is a pair of O(s^2) quadratic forms in ``G``, solved in numpy
   float64 whatever the device dtype.  Only ``G`` crosses to the host: one
   host sync per cycle, and the (3, 2s+1) coefficients go back;
3. **multi-axpy update** (K9, ``kernels/csrc/nekbone_sstep_update.cu``) —
   the whole cycle's x/r/p updates in one pass over the basis, with the
   post-cycle ``r·c·r`` partials of the *stored* residual.

Stream budget per cycle: ``4s + 9`` (``cost.sstep_streams``), the v2 budget
at s=1.  On the TPU the cycle's one host round trip replaced v1/v2's two
scalar reads per iteration; the port's v2 keeps alpha and beta on the
device and never waits for the card, so here the round trip is a cost,
not a saving (PERF.md).

Stability: the monomial basis conditions the Gram block like
``kappa(A)^{2s}``; the theta scaling (a one-time power-iteration estimate
of ||A||, :func:`estimate_theta`) keeps basis norms O(1) but not the angles,
so parity with plain CG degrades as s grows — s <= 4 holds fp64 round-off
parity on the paper-grid cases.  K8 and K9 take s up to
``kernels.nekbone_ax.SSTEP_MAX_S``.

:func:`sstep_recurrence` and :func:`cycle_coefficients` are the reference's
numpy code, verbatim.  The reference's slab split ``sz``, contraction
``layout`` and ``grid_order`` tune its TPU kernel (the halo'd windows of
``sstep_extend_field``); they have no counterpart here and are dropped:
K8 computes the same function over the whole box.  Preconditions are the
v2 pipeline's: assembled and masked ``b``, the structured axis-aligned box,
unpreconditioned solves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cg import CGResult, SolveResult
from repro_torch.core.cg_fused import _prepare
from repro_torch.core.geom import box_axis_factors, box_outer
from repro_torch.kernels import nekbone_ax as _ax

__all__ = ["cg_sstep_fixed_iters", "sstep_recurrence", "cycle_coefficients",
           "estimate_theta"]


def sstep_recurrence(G: np.ndarray, s: int, m: int, theta: float):
    """Run m (<= s) CG iterations on s-step basis coordinates, in float64.

    With ``V = [p, A'p, .., A'^s p, r, A'r, .., A'^{s-1} r]`` and
    ``A V = theta * V T`` (``T`` the block shift), the CG two-term
    recurrence closes on coefficient vectors:

        rtz_j   = b_j' G b_j
        alpha_j = rtz_j / (a_j' G (theta T a_j))
        e_{j+1} = e_j + alpha_j a_j            (x - x0 coordinates)
        b_{j+1} = b_j - alpha_j theta T a_j    (r coordinates)
        beta_j  = rtz_{j+1} / rtz_j
        a_{j+1} = b_{j+1} + beta_j a_j         (p coordinates)

    The degree argument keeps T total: p_j involves powers <= j of p and
    <= j-1 of r, so ``T a_j`` for j <= s-1 never needs the truncated
    columns.  Everything is float64 numpy — the Gram/recurrence stays wide
    whatever the device precision.

    Args:
      G: (2s+1, 2s+1) assembled Gram matrix ``V^T C V``.
      s: basis powers; m: iterations to advance (final cycle may be short).
      theta: the basis scale (``A' = A/theta``).

    Returns ``(e, b, a, rtz_hist)`` — the three coefficient vectors after
    m steps and the list of the m start-of-iteration ``rtz`` values.
    """
    K = 2 * s + 1
    G = np.asarray(G, np.float64).reshape(K, K)
    G = 0.5 * (G + G.T)                  # kernel partials are symmetric
    T = np.zeros((K, K))
    for j in range(s):
        T[j + 1, j] = theta              # A (A'^j p) = theta A'^{j+1} p
    for j in range(s - 1):
        T[s + 2 + j, s + 1 + j] = theta
    a = np.zeros(K)
    a[0] = 1.0                           # p
    b = np.zeros(K)
    b[s + 1] = 1.0                       # r
    e = np.zeros(K)
    rtz_hist = []
    rtz = float(b @ G @ b)
    for _ in range(m):
        rtz_hist.append(rtz)
        Ta = T @ a
        alpha = rtz / float(a @ G @ Ta)
        e = e + alpha * a
        b = b - alpha * Ta
        rtz_new = float(b @ G @ b)
        beta = rtz_new / rtz
        a = b + beta * a
        rtz = rtz_new
    return e, b, a, rtz_hist


def cycle_coefficients(G: np.ndarray, s: int, m: int, theta: float,
                       tol2: float | None = None):
    """One cycle's recurrence + in-cycle tolerance resolution.

    Runs :func:`sstep_recurrence` for ``m`` steps; with ``tol2`` set,
    applies :func:`repro_torch.core.cg.cg`'s stopping rule at *iteration*
    granularity — stop before the first iteration whose start-of-iteration
    ``rtz`` is ``<= tol2`` — by re-running the O(s^2) f64 recurrence for
    the shorter count, so the update kernel applies exactly the iterations
    taken.

    Returns ``(coef, rtzs, m)``: the stacked f64 ``(3, 2s+1)`` coefficient
    block (x/r/p rows — the update kernel's layout), the ``m``
    start-of-iteration rtz values actually run, and the resolved step
    count (``m == 0`` means the tolerance was already met at cycle start
    and nothing should be applied).
    """
    e_c, b_c, a_c, rtzs = sstep_recurrence(G, s, m, theta)
    if tol2 is not None:
        stop = next((j for j, v in enumerate(rtzs) if abs(v) <= tol2), None)
        if stop is not None:
            if stop == 0:
                return None, [], 0
            e_c, b_c, a_c, rtzs = sstep_recurrence(G, s, stop, theta)
            m = stop
    return np.stack([e_c, b_c, a_c]), rtzs, m


def _theta_power_iter(D, g, mask, *, grid: tuple[int, int, int],
                      iters: int) -> torch.Tensor:
    """The whole power iteration on the device, read once at the end.

    Degenerate inputs (zero or non-finite operator norms) carry the
    previous theta forward; the caller maps a non-finite final value to
    1.0.  ``v0`` is numpy's ``linspace(1, 2)`` over the nodes, masked.
    """
    from repro_torch.core.ax import ax_local_fused
    from repro_torch.core.gs import ds_sum_local

    dev = mask.device
    tiny = torch.tensor(np.finfo(np.float64).tiny, dtype=mask.dtype,
                        device=dev)
    v = torch.as_tensor(np.linspace(1.0, 2.0, mask.numel()),
                        device=dev).reshape(mask.shape).to(mask.dtype) * mask
    theta = torch.ones((), dtype=mask.dtype, device=dev)
    for _ in range(iters):
        w = ds_sum_local(ax_local_fused(v, D, g), grid) * mask
        nrm = torch.max(torch.abs(w))
        ok = torch.isfinite(nrm) & (nrm > 0)
        theta = torch.where(
            ok, nrm / torch.maximum(torch.max(torch.abs(v)), tiny), theta)
        v = torch.where(ok, w / torch.where(ok, nrm, torch.ones_like(nrm)),
                        v)
    return theta


def estimate_theta(D: torch.Tensor, g: torch.Tensor,
                   grid: tuple[int, int, int], mask: torch.Tensor,
                   iters: int = 8) -> float:
    """Power-iteration estimate of ||A|| for the basis scale.

    Any fixed positive theta leaves the recurrence *exact* (it is a
    diagonal rescale of the basis, accounted for in T); a ||A||-sized one
    keeps the monomial basis norms O(1) so the f64 Gram stays conditioned.
    A handful of deterministic power iterations on the assembled masked
    operator (plain torch, on the fields' device) suffice — a one-time
    set-up cost per case (pass ``theta=`` to :func:`cg_sstep_fixed_iters`
    to reuse it).
    """
    theta = float(_theta_power_iter(D, g, mask, grid=tuple(grid),
                                    iters=iters))
    if not np.isfinite(theta) or theta <= 0.0:
        return 1.0
    return theta


def cg_sstep_fixed_iters(b: torch.Tensor, *, D: torch.Tensor,
                         g: torch.Tensor, grid: tuple[int, int, int],
                         niter: int, s: int = 4,
                         mask: torch.Tensor | None = None,
                         c: torch.Tensor | None = None,
                         theta: float | None = None,
                         tol: float | None = None,
                         precision=None) -> SolveResult:
    """Fixed-iteration s-step CG through K8 and K9.

    Args:
      b:     (E, n, n, n) assembled, masked right-hand side; elements
             z-major over ``grid``.
      D:     (n, n) derivative matrix.
      g:     (E, 6, n, n, n) axis-aligned metric, or pre-packed diagonal.
      grid:  element grid (EX, EY, EZ).
      niter: total CG iterations (any value — the final cycle runs the
             remainder ``niter % s`` recurrence steps on a full basis).
             With ``tol`` set this is the *ceiling* (``max_iter``).
      s:     iterations per cycle (1 <= s <= ``SSTEP_MAX_S``; s=1 is the
             v2 stream budget, s=4 the reference's tuned default).
      mask/c: optional structural fields, validated like the v2 path.
      theta: basis scale override (default: :func:`estimate_theta`).
      tol:   optional tolerance for early exit: stop, as
             :func:`repro_torch.core.cg.cg` does, *before* the first
             iteration whose start-of-iteration ``rtz = r·c·r`` is
             ``<= tol**2``.  Before each cycle the host reads the previous
             update's stored-residual reduction; inside a cycle the stop is
             resolved to the exact iteration from the f64 Gram quadratic
             forms, and K9 applies exactly the iterations taken.  The
             returned ``iters`` is the count actually run.
      precision: policy name / policy / ``None`` (DESIGN.md §7) — basis
             and vectors in the storage dtype, the Gram partials in the
             accumulation dtype, the recurrence always in host float64.

    Returns a :class:`SolveResult` whose history matches ``cg_fixed_iters``
    to round-off for small s (the in-cycle entries are the f64 Gram
    quadratic forms ``sqrt(b_j' G b_j)``; the final entry is K9's
    stored-residual reduction).  With ``tol``, the history holds the
    ``iters + 1`` entries actually produced — a prefix of the
    fixed-iteration trajectory.
    """
    if s < 1:
        raise ValueError(f"s-step CG needs s >= 1, got {s}")
    policy, b, n, grid, op = _prepare(b, D, g, grid, mask, c, precision)
    E = b.shape[0]
    n3 = n ** 3
    acc = policy.accum_dtype
    dev = b.device
    if theta is None:
        if mask is None:
            masks = box_axis_factors(grid, n)[0]
            mask = box_outer(*(torch.as_tensor(f) for f in reversed(masks)))
        theta = estimate_theta(D.to(b.dtype), g.to(b.dtype), grid,
                               mask.to(dtype=b.dtype, device=dev)
                               .reshape(b.shape))
    inv_theta = torch.full((1,), 1.0 / theta, dtype=acc, device=dev)
    cx, cy, cz = op["cx"], op["cy"], op["cz"]

    tol2 = None if tol is None else float(tol) ** 2
    x2 = torch.zeros((E, n3), dtype=policy.x_storage_dtype, device=dev)
    r2 = p2 = b.reshape(E, n3).contiguous()
    hist: list[float] = []
    rcr_last = None
    it = 0
    # tracing: the recorder is read once per solve; when off the loop pays
    # one `is None` test per cycle and allocates nothing
    from repro_torch.obs import trace as _trace

    rec = _trace.active()
    while it < niter:
        # per-cycle tolerance check on the previous update's stored-residual
        # reduction — the start-of-iteration rtz the next Gram would report.
        if tol2 is not None and rcr_last is not None \
                and abs(float(rcr_last)) <= tol2:
            break
        m = min(s, niter - it)
        with (rec.span("sstep.cycle", it=it, s=s)
              if rec is not None else _trace.NULL_SPAN):
            with _trace.profiler_annotation("nekbone.sstep_powers"):
                basis, gram_e = _ax.nekbone_ax_powers_cuda(
                    p2, r2, op["D"], op["g3"], op["mx"], op["my"], op["mz"],
                    cx, cy, cz, inv_theta, n=n, s=s)
            # the one host read of the cycle: the summed (2s+1)^2 Gram block
            G = torch.sum(gram_e, dim=0).cpu().numpy().astype(policy.gram)
            coef_np, rtzs, m = cycle_coefficients(G, s, m, theta, tol2)
            if m == 0:
                break
            hist.extend(np.sqrt(np.abs(v)) for v in rtzs)
            coef = torch.as_tensor(coef_np, dtype=acc, device=dev)
            with _trace.profiler_annotation("nekbone.sstep_update"):
                x2, r2, p2, rcr_e = _ax.nekbone_sstep_update_cuda(
                    x2, p2, r2, basis, coef, cx, cy, cz, n=n, s=s)
            rcr_last = torch.sum(rcr_e)
        it += m
        if tol2 is not None and m < s:
            break
    if rcr_last is None:                  # niter == 0 (or tol met at start)
        c2 = box_outer(cz, cy, cx).reshape(E, n3).to(acc)
        rcr_last = torch.sum(r2.to(acc) * c2 * r2.to(acc))
    hist.append(float(np.sqrt(abs(float(rcr_last)))))
    hist_t = torch.as_tensor(np.asarray(hist, np.float64), dtype=acc,
                             device=dev)
    return SolveResult.from_cg(
        CGResult(x=x2.reshape(b.shape), iters=torch.tensor(it, device=dev),
                 rnorm=hist_t[-1], rnorm_history=hist_t),
        pipeline="sstep_v3")
