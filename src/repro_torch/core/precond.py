"""Preconditioned and tolerance-driven v2 solves (the reference's
``core/precond.py``, DESIGN.md §9).

* **Jacobi PCG** (:func:`pcg_fused_v2_fixed_iters` with a
  :class:`JacobiPrecond`): the operator diagonal is computed once per case
  (:func:`operator_diagonal`) and inverted; the solver carries the
  preconditioned residual ``z = invdiag * r``, so K4
  (``kernels/csrc/nekbone_ax_slab.cu``) runs unchanged with z in its
  residual slot, and K10 (``nekbone_pcg_update.cu``) assembles the operator
  output, applies both axpys in z-coordinates and emits the ``r·c·z`` and
  ``r·c·r`` partials: K4 + K10 per iteration.
* **Chebyshev PCG** (:class:`ChebyshevPrecond`): ``z = q_k(A) r`` with
  ``q_k`` the degree-k Chebyshev approximation of ``A^-1`` on an interval
  bracketing the spectrum, evaluated by K11 (``nekbone_cheb_apply.cu``);
  K4 and K5 then run the unmodified v2 iteration on z.  Per iteration K11
  + K4 + K5, and one more K11 at the start.  The interval comes from
  :func:`estimate_interval`, a weighted-Lanczos estimate run once per case.
* **p-multigrid PCG** (:class:`repro_torch.core.pmg.PMGPrecond`): the
  Chebyshev driver's loop with ``z = M r`` a symmetric V-cycle over the
  degree ladder (``core/pmg.py``): per smoothed level a Chebyshev(k)
  pre-smooth by K11 on that level's rediscretized operator, the residual
  ``r - A z`` by K4 (beta = 0, z in the residual slot) and K5 (alpha = 1),
  the restriction (c-multiply, K12 with ``mt = J``, ``ds_sum_local``, the
  mask), the next level, the prolongation (K12 with ``mt = J^T``, the mask)
  and correction, a second residual and a post-smooth; the n=2 base level
  by :func:`repro_torch.core.pmg.coarse_solve_fixed`.
* **Tolerance-driven solves** (:func:`cg_fused_tol`): the same bodies under
  ``core/cg_fused._run``, which stops before an iteration once
  ``|rtz| <= tol**2`` (``rtz = r·c·z``, or ``r·c·r`` unpreconditioned).
  The host reads that condition before every iteration; the fixed drivers
  run the same loop without reading it, so a tolerance-driven history is
  bitwise a prefix of the fixed one, NaN-padded to ``max_iter + 1``.

The reference's TPU knobs (``sz``, ``cheb_sz``, ``layout``,
``grid_order``, ``interpret``, the autotune picks) have no counterpart.

Preconditions are the v2 pipeline's (structured axis-aligned box,
assembled and masked ``b``).  Both reduction partials see the *stored*
vectors; the operator diagonal and the Chebyshev scalars are operator data
(``op_storage`` and accumulation dtypes).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import repro_torch.core.gs as gs_mod
import repro_torch.core.pmg as pmg_mod
from repro_torch.core.ax import ax_local_fused
from repro_torch.core.cg import SolveResult
from repro_torch.core.cg_fused import _cg_v2_tol, _prepare, _result, _run
from repro_torch.core.cost import CHEB_DEFAULT_K, PMG_DEFAULT_K
from repro_torch.core.geom import box_axis_factors, box_outer
from repro_torch.core.pmg import PMGPrecond
from repro_torch.kernels import nekbone_ax as _ax

__all__ = ["CHEB_DEFAULT_K", "JacobiPrecond", "ChebyshevPrecond", "PMGPrecond",
           "make_preconditioner", "operator_diagonal", "estimate_interval",
           "cheb_scalars", "chebyshev_preconditioner",
           "pcg_fused_v2_fixed_iters", "cg_fused_tol"]


# ---------------------------------------------------------------------------
# operator diagonal (Jacobi)
# ---------------------------------------------------------------------------

def operator_diagonal(D: torch.Tensor, g: torch.Tensor, grid,
                      mask: torch.Tensor) -> torch.Tensor:
    """diag(A) of the assembled, masked SEM Poisson operator, structurally.

    For the tensor-product operator ``w = D^T G D u`` the element-local
    diagonal is three small contractions of ``D ∘ D`` against the metric
    diagonal; assembly (gather-scatter) then sums coincident copies.
    Masked rows are set to 1, so the inverse never divides by zero.

    Args:
      D: (n, n); g: (E, 6, n, n, n) metric or its (E, 3, ...) diagonal;
      grid: element grid; mask: (E, n, n, n) Dirichlet mask.
    """
    n = D.shape[-1]
    g = g.reshape(g.shape[0], g.shape[1], n, n, n)
    if g.shape[1] == 6:
        grr, gss, gtt = g[:, 0], g[:, 3], g[:, 5]
    elif g.shape[1] == 3:
        grr, gss, gtt = g[:, 0], g[:, 1], g[:, 2]
    else:
        raise ValueError(f"metric must have 3 or 6 components, got "
                         f"{tuple(g.shape)}")
    D2 = D * D
    dr = torch.einsum("li,ekjl->ekji", D2, grr)
    ds = torch.einsum("lj,ekli->ekji", D2, gss)
    dt = torch.einsum("lk,elji->ekji", D2, gtt)
    diag = gs_mod.ds_sum_local(dr + ds + dt, tuple(grid))
    return torch.where(mask > 0, diag, torch.ones_like(diag))


# ---------------------------------------------------------------------------
# Chebyshev recurrence scalars and the plain applier
# ---------------------------------------------------------------------------

def cheb_scalars(k: int, lmin: float, lmax: float) -> np.ndarray:
    """Chebyshev-semi-iteration recurrence scalars for ``q_k(A) ≈ A^-1``.

    The incremental-residual form (Saad, *Iterative Methods*, Alg. 12.1,
    started from ``x0 = 0``) applied for ``k`` operator applications:

        d = coef[0,0] * r;  z = d;  res = r
        for i in 1..k:
            res -= A d
            d    = coef[i,0] * d + coef[i,1] * res
            z   += d

    yields the degree-k polynomial whose error ``1 - λ q_k(λ)`` is the
    scaled-and-shifted Chebyshev polynomial minimizing the max over
    ``[lmin, lmax]``.  On that interval ``λ q_k(λ) ∈ (0, 2)``, so ``q_k``
    is positive there — ``M^-1 = q_k(A)`` is SPD whenever the interval
    covers the spectrum (over-estimating ``lmax`` is the safe direction;
    under-estimating ``lmin`` only costs effectiveness, §9.3).

    Returns an (k+1, 2) float64 array: row 0 = (1/θ, 0) with
    ``θ = (lmax+lmin)/2``; row i = (ρ_i ρ_{i-1}, 2 ρ_i / δ) with
    ``δ = (lmax-lmin)/2``, ``σ1 = θ/δ``, ``ρ_0 = 1/σ1``,
    ``ρ_i = 1/(2σ1 - ρ_{i-1})``.
    """
    if k < 1:
        raise ValueError(f"Chebyshev order must be >= 1, got {k}")
    lmin = float(lmin)
    lmax = float(lmax)
    if not (0.0 < lmin < lmax) or not np.isfinite(lmax):
        raise ValueError(f"need 0 < lmin < lmax, got [{lmin}, {lmax}]")
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho_prev = 1.0 / sigma1
    coef = np.zeros((k + 1, 2), np.float64)
    coef[0, 0] = 1.0 / theta
    for i in range(1, k + 1):
        rho = 1.0 / (2.0 * sigma1 - rho_prev)
        coef[i, 0] = rho * rho_prev
        coef[i, 1] = 2.0 * rho / delta
        rho_prev = rho
    return coef


def chebyshev_preconditioner(A, k: int, lmin: float, lmax: float):
    """Plain Chebyshev applier ``M(r) = q_k(A) r``.

    A ``precond=`` callable for :func:`repro_torch.core.cg.cg` /
    ``cg_fixed_iters`` on any operator ``A`` (not just the box): the
    ``reference`` route's preconditioner.
    """
    coef = cheb_scalars(k, lmin, lmax).tolist()

    def M(r):
        d = coef[0][0] * r
        z = d
        res = r
        for i in range(1, k + 1):
            res = res - A(d)
            d = coef[i][0] * d + coef[i][1] * res
            z = z + d
        return z

    return M


# ---------------------------------------------------------------------------
# spectrum interval estimate: weighted Lanczos
# ---------------------------------------------------------------------------

def _lanczos_tridiag(D, g, mask, c, *, grid: tuple[int, int, int],
                     iters: int):
    """``iters`` steps of Lanczos on the assembled masked operator.

    Runs in the c-weighted inner product (the one ``A`` is self-adjoint in
    on continuous fields); the start vector is one operator application of
    a deterministic ramp, which makes it continuous and drops any component
    outside range(A).  Plain torch on the fields' device.  Returns the
    tridiagonal entries ``(alphas[iters], betas[iters])`` — no
    reorthogonalization (the extreme Ritz values converge first, which is
    all the interval needs).
    """
    tiny = float(np.finfo(np.float32).tiny)

    def A(v):
        return gs_mod.ds_sum_local(ax_local_fused(v, D, g), grid) * mask

    def dot(u, v):
        return torch.sum(u * c * v)

    ramp = torch.as_tensor(np.linspace(1.0, 2.0, mask.numel()),
                           device=mask.device).to(mask.dtype)
    v0 = A(ramp.reshape(mask.shape) * mask)
    q = v0 / torch.sqrt(torch.abs(dot(v0, v0))).clamp_min(tiny)
    q_prev = torch.zeros_like(q)
    beta = torch.zeros((), dtype=mask.dtype, device=mask.device)
    alphas, betas = [], []
    for _ in range(iters):
        w = A(q)
        alpha = dot(w, q)
        w = w - alpha * q - beta * q_prev
        beta = torch.sqrt(torch.abs(dot(w, w)))
        q_prev, q = q, w / beta.clamp_min(tiny)
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)


def estimate_interval(D: torch.Tensor, g: torch.Tensor,
                      grid: tuple[int, int, int], mask: torch.Tensor,
                      c: torch.Tensor | None = None,
                      iters: int = 16) -> tuple[float, float]:
    """Lanczos estimate of ``[λmin, λmax]`` for the Chebyshev interval.

    The tridiagonal Ritz values of a short weighted-Lanczos run bracket the
    extreme eigenvalues from inside, so the returned interval applies
    safety factors in the *safe* directions: λmax inflated by 5% (the
    SPD-critical end), λmin deflated by 10%.  The Ritz values come from
    numpy's ``eigvalsh`` in float64 on the host.  A one-time set-up cost
    per case.

    Returns a ``(lmin, lmax)`` float pair, guaranteed ``0 < lmin < lmax``
    (degenerate estimates fall back to ``lmax / 100``).
    """
    grid = tuple(grid)
    if c is None:
        _, (cxf, cyf, czf) = box_axis_factors(grid, mask.shape[-1])
        c = box_outer(*(torch.as_tensor(f, device=mask.device)
                        for f in (czf, cyf, cxf))).reshape(mask.shape)
    alphas, betas = _lanczos_tridiag(D, g, mask, c.to(mask.dtype),
                                     grid=grid, iters=int(iters))
    # numpy has no bfloat16: widen on the device first, as the reference's
    # np.asarray(alphas, np.float64) does.
    alphas = alphas.to(torch.float64).cpu().numpy()
    betas = betas.to(torch.float64).cpu().numpy()
    # truncate at Krylov breakdown (beta ~ 0): later entries are noise.
    scale = max(np.abs(alphas).max(), 1.0)
    good = np.nonzero(betas < 1e-12 * scale)[0]
    m = int(good[0]) + 1 if good.size else alphas.size
    T = np.diag(alphas[:m])
    if m > 1:
        off = betas[:m - 1]
        T += np.diag(off, 1) + np.diag(off, -1)
    ritz = np.linalg.eigvalsh(T)
    lmax = float(ritz[-1]) * 1.05
    lmin = float(ritz[0]) * 0.9
    if not np.isfinite(lmax) or lmax <= 0.0:
        return 0.01, 1.0
    if not np.isfinite(lmin) or lmin <= 0.0 or lmin >= lmax:
        lmin = lmax / 100.0
    return lmin, lmax


# ---------------------------------------------------------------------------
# preconditioner specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JacobiPrecond:
    """Diagonal preconditioner: the assembled ``1/diag(A)``."""

    invdiag: torch.Tensor                # (E, n, n, n), 1 at masked rows
    name: str = dataclasses.field(default="jacobi", init=False)


@dataclasses.dataclass(frozen=True)
class ChebyshevPrecond:
    """Chebyshev polynomial preconditioner of order ``k`` on an interval."""

    k: int
    lmin: float
    lmax: float
    name: str = dataclasses.field(default="cheb", init=False)

    def scalars(self) -> np.ndarray:
        """The (k+1, 2) f64 recurrence-scalar table (:func:`cheb_scalars`)."""
        return cheb_scalars(self.k, self.lmin, self.lmax)


def make_preconditioner(name: str, *, D: torch.Tensor, g: torch.Tensor,
                        grid: tuple[int, int, int],
                        mask: torch.Tensor | None = None,
                        c: torch.Tensor | None = None,
                        k: int = CHEB_DEFAULT_K,
                        interval: tuple[float, float] | None = None,
                        lengths: tuple[float, float, float] = (1.0, 1.0,
                                                               1.0)):
    """Build a preconditioner spec from its registry name.

    Args:
      name: ``"jacobi"``; ``"cheb"``/``"chebyshev"`` (optionally with a
            trailing order, e.g. ``"cheb2"`` — overrides ``k``); ``"pmg"``
            or ``"pmg[cheb<k>]"``, the p-multigrid V-cycle with
            Chebyshev(k) smoothers (default :data:`PMG_DEFAULT_K`; ``k``
            does not reach it).
      D/g/grid: the operator's defining data, as the fused drivers take.
      mask/c: structural fields (rebuilt from the box factors if omitted).
      k: Chebyshev order (default :data:`CHEB_DEFAULT_K`).
      interval: Chebyshev ``(lmin, lmax)`` override (default: the
            :func:`estimate_interval` Lanczos estimate — a one-time setup
            cost per case).
      lengths: physical box extents (pmg only).
    """
    grid = tuple(grid)
    if mask is None:
        n = D.shape[-1]
        (mxf, myf, mzf), _ = box_axis_factors(grid, n)
        mask = box_outer(*(torch.as_tensor(f, device=D.device)
                           for f in (mzf, myf, mxf))).reshape(-1, n, n, n)
        mask = mask.to(g.dtype)
    key = str(name).lower()
    if key == "jacobi":
        return JacobiPrecond(invdiag=1.0 / operator_diagonal(D, g, grid,
                                                             mask))
    if key.startswith("pmg"):
        suffix = key.removeprefix("pmg")
        kk = PMG_DEFAULT_K
        if suffix:
            inner = suffix.removeprefix("[cheb").removesuffix("]")
            if (suffix == f"[cheb{inner}]" and inner.isdigit()
                    and int(inner) >= 1):
                kk = int(inner)
            else:
                raise ValueError(f"unknown preconditioner {name!r}; the "
                                 "pmg spellings are 'pmg' and "
                                 "'pmg[cheb<k>]'")
        return pmg_mod.make_pmg_preconditioner(D=D, g=g, grid=grid,
                                               mask=mask, c=c, k=kk,
                                               lengths=lengths)
    if key.startswith("cheb"):
        suffix = key.removeprefix("chebyshev").removeprefix("cheb")
        if suffix:
            k = int(suffix)
        if interval is None:
            interval = estimate_interval(D, g, grid, mask, c)
        return ChebyshevPrecond(k=int(k), lmin=float(interval[0]),
                                lmax=float(interval[1]))
    raise ValueError(f"unknown preconditioner {name!r}; expected 'jacobi', "
                     "'cheb[<k>]', 'pmg', or 'pmg[cheb<k>]'")


# ---------------------------------------------------------------------------
# solver cores.  Each runs under core/cg_fused._run: while k < max_iter and
# |rtz| > tol2, with tol2=None for the fixed-iteration drivers.
# ---------------------------------------------------------------------------

def _pcg_jacobi(b, invd, op, policy, tol2: float | None, max_iter: int):
    """Jacobi PCG: K4 (z in the residual slot) + K10 per iteration.

    The state carries ``z = invdiag * r`` instead of ``r``: K4's merged
    direction update ``p = z + beta p`` and its pap partial are then exactly
    PCG's.  ``rtz = r·c·z`` drives alpha, beta and the stopping rule; the
    history records the reconstructed ``sqrt(r·c·r)``, directly comparable
    to unpreconditioned CG's.
    """
    acc = policy.accum_dtype
    E = b.shape[0]
    b2 = b.reshape(E, -1).contiguous()
    invd2 = invd.reshape(E, -1).contiguous()
    n, cx, cy, cz = op["n"], op["cx"], op["cy"], op["cz"]
    c2 = box_outer(cz, cy, cx).reshape(b2.shape).to(acc)
    b_acc = b2.to(acc)
    # z0 rounded through storage: K4 reads the stored z.
    z0 = (invd2.to(acc) * b_acc).to(b2.dtype)
    rtz0 = torch.sum(b_acc * c2 * z0.to(acc))
    rcr0 = torch.sum(b_acc * c2 * b_acc)

    def body(state, rtz):
        x2, z2, p2, beta = state
        p2, w2, pap_e = _ax.nekbone_ax_slab_cuda(
            p2, z2, op["D"], op["g3"], op["mx"], op["my"], op["mz"], beta,
            n=n)
        alpha = rtz / torch.sum(pap_e)
        x2, z2, rtz_e, rcr_e = _ax.nekbone_pcg_update_cuda(
            x2, p2, z2, w2, alpha, invd2, cx, cy, cz, n=n)
        rtz_new = torch.sum(rtz_e)
        beta = rtz_new / rtz
        return ((x2, z2, p2, beta), rtz_new,
                torch.sqrt(torch.abs(torch.sum(rcr_e))))

    state = (torch.zeros(b2.shape, dtype=policy.x_storage_dtype,
                         device=b2.device),
             z0, torch.zeros_like(z0),
             torch.zeros((), dtype=acc, device=b2.device))
    (x2, *_), k, hist = _run(body, state, rtz0, torch.sqrt(torch.abs(rcr0)),
                             tol2, max_iter)
    return _result(x2, k, hist, b.shape)


def _pcg_apply(b, apply_m, op, policy, tol2: float | None, max_iter: int):
    """PCG with ``z, rtz = apply_m(r)`` and the unmodified v2 pair K4 + K5.

    ``apply_m`` (Chebyshev: K11; pmg: the V-cycle) runs at the *end* of
    each iteration, on the freshly updated residual, so the stopping rule
    sees the same ``rtz = r·c·z`` :func:`repro_torch.core.cg.cg` checks;
    one more application at the start gives ``z0``.
    """
    acc = policy.accum_dtype
    b2 = b.reshape(b.shape[0], -1).contiguous()
    n = op["n"]
    c2 = box_outer(op["cz"], op["cy"], op["cx"]).reshape(b2.shape).to(acc)
    rcr0 = torch.sum(b2.to(acc) * c2 * b2.to(acc))

    def body(state, rtz):
        x2, r2, z2, p2, rtz_prev = state
        beta = rtz / rtz_prev            # rtz_prev = 1 at k=0: p0 = 0
        # the v2 pair with z in K4's residual slot (p = z + beta p); K5
        # updates r, and its rcr partials are the history entry.
        p2, w2, pap_e = _ax.nekbone_ax_slab_cuda(
            p2, z2, op["D"], op["g3"], op["mx"], op["my"], op["mz"], beta,
            n=n)
        alpha = rtz / torch.sum(pap_e)
        x2, r2, rcr_e = _ax.nekbone_cg_update_cuda(
            x2, p2, r2, w2, alpha, op["cx"], op["cy"], op["cz"], n=n)
        rnorm = torch.sqrt(torch.abs(torch.sum(rcr_e)))
        z2, rtz_new = apply_m(r2)
        return (x2, r2, z2, p2, rtz), rtz_new, rnorm

    z0, rtz0 = apply_m(b2)
    state = (torch.zeros(b2.shape, dtype=policy.x_storage_dtype,
                         device=b2.device),
             b2, z0, torch.zeros_like(b2),
             torch.ones((), dtype=acc, device=b2.device))
    (x2, *_), k, hist = _run(body, state, rtz0, torch.sqrt(torch.abs(rcr0)),
                             tol2, max_iter)
    return _result(x2, k, hist, b.shape)


def _pcg_cheb(b, coef, kcheb: int, op, policy, tol2: float | None,
              max_iter: int):
    """Chebyshev PCG: K11, then the v2 pair K4 + K5."""
    def cheb(r2):
        z2, rtz_e = _ax.nekbone_cheb_apply_cuda(
            r2, op["D"], op["g3"], op["mx"], op["my"], op["mz"], op["cx"],
            op["cy"], op["cz"], coef, n=op["n"], k=kcheb)
        return z2, torch.sum(rtz_e)

    return _pcg_apply(b, cheb, op, policy, tol2, max_iter)


def _pcg_pmg(b, spec: PMGPrecond, op, policy, tol2: float | None,
             max_iter: int):
    """p-multigrid PCG: the V-cycle over K11, K4, K5 and K12, then K4 + K5.

    The recursion over the ladder ``spec.ns`` is a Python recursion; level
    0 runs on the caller's operands ``op``, the others on the cached
    :func:`repro_torch.core.pmg.level_operands`.  Per V-cycle, at each of
    the ``L - 1`` smoothed levels: two K11 calls, two K12 calls (restrict,
    prolong) and two residuals of K4 + K5 each.

    The residual ``r - A z``: K4 writes the *unassembled* masked ``A z``
    (beta = 0 and zeros in the direction slot make its stored p exactly z),
    and K5 with alpha = 1 assembles it in ``ds_sum_local``'s tree and forms
    ``r - 1 * w``, which equals ``r - w`` exactly; K5's x output (zeros + z)
    is scratch.  So the residual needs no kernel beyond the two the
    iteration already uses, and the reference's host-side plane stitching
    has no counterpart.
    """
    acc = policy.accum_dtype
    grid = (op["mx"].shape[0], op["my"].shape[0], op["mz"].shape[0])
    E = b.shape[0]
    ns = spec.ns
    L = len(ns)
    levels, coarse = pmg_mod.level_operands(
        spec, grid, policy.op_storage_dtype, acc, str(b.device))
    lops = [dict(levels[0], D=op["D"], g3=op["g3"],
                 m=(op["mx"], op["my"], op["mz"]),
                 c=(op["cx"], op["cy"], op["cz"]))]
    lops += [dict(o) for o in levels[1:]]
    dtype = b.dtype
    # tracing: the recorder is read once per solve.  The per-level operand
    # set-up is the V-cycle's host boundary level by level, so the
    # "pmg.vcycle.level" spans sit there; the solve is one "pmg.dispatch".
    from repro_torch.obs import trace as _trace

    rec = _trace.active()
    for lev, o in enumerate(lops):
        with (rec.span("pmg.vcycle.level", level=lev, n=o["n"], k=spec.k)
              if rec is not None else _trace.NULL_SPAN):
            nl3 = o["n"] ** 3
            # the coarser levels' factors come in the operator's dtype; the
            # kernels take them as vectors (exact in any dtype: 0, 1/2, 1)
            o["m"] = tuple(f.to(dtype) for f in o["m"])
            o["c"] = tuple(f.to(dtype) for f in o["c"])
            o["mask2"] = box_outer(o["m"][2], o["m"][1], o["m"][0]) \
                .reshape(E, nl3)
            o["c2"] = box_outer(o["c"][2], o["c"][1], o["c"][0]) \
                .reshape(E, nl3).to(acc)
            o["zero"] = torch.zeros(E, nl3, dtype=dtype, device=b.device)
            # K5's x slot of the residual (scratch), in the solution's dtype
            o["zero_x"] = torch.zeros(E, nl3, dtype=policy.x_storage_dtype,
                                      device=b.device)
    Dc, gc, maskc, cc = coarse
    nc = ns[-1]
    mask_c2 = maskc.reshape(E, nc ** 3)
    beta0 = torch.zeros((), dtype=acc, device=b.device)
    alpha1 = torch.ones((), dtype=acc, device=b.device)

    def smooth(r2l, o):
        z2l, _ = _ax.nekbone_cheb_apply_cuda(
            r2l, o["D"], o["g3"], *o["m"], *o["c"], o["coef"], n=o["n"],
            k=spec.k)
        return z2l

    def residual(r2l, z2l, o):
        p2, w2, _ = _ax.nekbone_ax_slab_cuda(o["zero"], z2l, o["D"], o["g3"],
                                             *o["m"], beta0, n=o["n"])
        _, res, _ = _ax.nekbone_cg_update_cuda(o["zero_x"], p2, r2l, w2,
                                               alpha1, *o["c"], n=o["n"])
        return res

    def restrict(res2, lev):
        o = lops[lev]
        ncl = ns[lev + 1]
        t2 = (res2.to(acc) * o["c2"]).to(dtype)
        rc2 = _ax.nekbone_interp_cuda(t2, o["J"], nin=o["n"], nout=ncl)
        rc2 = gs_mod.ds_sum_local(rc2.reshape(E, ncl, ncl, ncl),
                                  grid).reshape(E, ncl ** 3)
        mask = lops[lev + 1]["mask2"] if lev + 1 < L - 1 else mask_c2
        return rc2 * mask.to(dtype)

    def vcycle_level(r2l, lev):
        if lev == L - 1:
            e4 = pmg_mod.coarse_solve_fixed(
                r2l.reshape(E, nc, nc, nc).to(acc), Dc, gc, grid, maskc, cc,
                iters=spec.coarse_iters)
            return e4.reshape(E, nc ** 3).to(dtype)
        o = lops[lev]
        z2l = smooth(r2l, o)
        ec = vcycle_level(restrict(residual(r2l, z2l, o), lev), lev + 1)
        dz = _ax.nekbone_interp_cuda(ec, o["Jt"], nin=ns[lev + 1],
                                     nout=o["n"])
        z2l = (z2l.to(acc) + dz.to(acc) * o["mask2"].to(acc)).to(dtype)
        res = residual(r2l, z2l, o)
        return (z2l.to(acc) + smooth(res, o).to(acc)).to(dtype)

    c2 = lops[0]["c2"]

    def vcycle(r2):
        z2 = vcycle_level(r2, 0)
        return z2, torch.sum(r2.to(acc) * c2 * z2.to(acc))

    with (rec.span("pmg.dispatch", levels=L, coarse_n=ns[-1])
          if rec is not None else _trace.NULL_SPAN):
        with _trace.profiler_annotation("nekbone.pcg_pmg"):
            return _pcg_apply(b, vcycle, op, policy, tol2, max_iter)


# ---------------------------------------------------------------------------
# public drivers
# ---------------------------------------------------------------------------

def _resolve_precond(precond, *, D, g, grid, mask, c):
    if precond is None or isinstance(precond, (JacobiPrecond,
                                               ChebyshevPrecond,
                                               PMGPrecond)):
        return precond
    return make_preconditioner(str(precond), D=D, g=g, grid=grid, mask=mask,
                               c=c)


def _dispatch(b, precond, tol2: float | None, max_iter: int, *, policy, op):
    if precond is None:
        return _cg_v2_tol(b, op, policy, tol2, max_iter)
    if isinstance(precond, JacobiPrecond):
        invd = precond.invdiag.to(dtype=policy.op_storage_dtype,
                                  device=b.device)
        return _pcg_jacobi(b, invd, op, policy, tol2, max_iter)
    if isinstance(precond, ChebyshevPrecond):
        coef = torch.as_tensor(precond.scalars(), dtype=policy.accum_dtype,
                               device=b.device)
        return _pcg_cheb(b, coef, precond.k, op, policy, tol2, max_iter)
    if isinstance(precond, PMGPrecond):
        return _pcg_pmg(b, precond, op, policy, tol2, max_iter)
    raise TypeError(f"unsupported preconditioner {precond!r}")


def pcg_fused_v2_fixed_iters(b: torch.Tensor, *, D: torch.Tensor,
                             g: torch.Tensor, grid: tuple[int, int, int],
                             niter: int, precond,
                             mask: torch.Tensor | None = None,
                             c: torch.Tensor | None = None,
                             precision=None) -> SolveResult:
    """Fixed-iteration *preconditioned* CG through the v2 kernels.

    The PCG sibling of
    :func:`repro_torch.core.cg_fused.cg_fused_v2_fixed_iters` (same
    arguments and preconditions), with ``precond`` a :class:`JacobiPrecond`,
    a :class:`ChebyshevPrecond`, or a registry name (``"jacobi"`` /
    ``"cheb[<k>]"`` — built via :func:`make_preconditioner`, which costs a
    one-time diagonal / Lanczos set-up).  ``precond=None`` runs the
    unpreconditioned v2 loop.

    Matches ``cg_fixed_iters(A, b, precond=M, dot=weighted)`` to round-off;
    the history records ``sqrt(r·c·r)`` exactly like unpreconditioned CG.
    """
    policy, b, n, grid, op = _prepare(b, D, g, grid, mask, c, precision)
    precond = _resolve_precond(precond, D=D, g=g, grid=grid, mask=mask, c=c)
    return SolveResult.from_cg(
        _dispatch(b, precond, None, niter, policy=policy, op=op),
        pipeline="fused_v2", precond=getattr(precond, "name", None))


def cg_fused_tol(b: torch.Tensor, *, D: torch.Tensor, g: torch.Tensor,
                 grid: tuple[int, int, int], tol: float = 1e-8,
                 max_iter: int = 100, precond=None,
                 mask: torch.Tensor | None = None,
                 c: torch.Tensor | None = None,
                 precision=None) -> SolveResult:
    """Tolerance-driven v2 (P)CG: solve to ``tol``, not a fixed count.

    :func:`repro_torch.core.cg.cg`'s stopping rule: iterate while
    ``k < max_iter`` and ``|rtz| > tol**2`` (``rtz = r·c·z``; ``= r·c·r``
    unpreconditioned), checking *before* each iteration.  The bodies are
    the fixed-iteration bodies, so the returned history is a prefix of the
    fixed-iteration trajectory (NaN-padded to ``max_iter + 1``) and
    ``iters`` is the count actually run.

    Args are :func:`pcg_fused_v2_fixed_iters`'s with ``tol``/``max_iter``
    replacing ``niter``; ``precond=None`` runs the plain v2 pipeline.
    """
    policy, b, n, grid, op = _prepare(b, D, g, grid, mask, c, precision)
    precond = _resolve_precond(precond, D=D, g=g, grid=grid, mask=mask, c=c)
    return SolveResult.from_cg(
        _dispatch(b, precond, float(tol) ** 2, max_iter, policy=policy,
                  op=op),
        pipeline="fused_v2", precond=getattr(precond, "name", None))
