"""Public wrappers around the CUDA kernels, on natural shapes.

The Nekbone wrappers reshape ``(E, n, n, n)`` fields to the kernels' flat
``(E, n^3)`` layout (free for contiguous tensors) and call the kernel
wrapper of :mod:`repro_torch.kernels.nekbone_ax`; :func:`flash_attention`
(K13) and :func:`wkv6` (K14) call :mod:`repro_torch.kernels.flash_attn` and
:mod:`repro_torch.kernels.wkv6`.  Each runs its kernel on a CUDA tensor
and its plain version on a CPU tensor.  On ``torch.device("meta")`` (the
dry run, ``launch/dryrun.py``) K13 and K14 run a plain version on shapes
alone — K13 its whole-row form, K14 its chunked form's products batched
over the chunks (``ref.wkv6_chunked_batched``) — counted in
``_build.PLAIN_ON_META`` and launching nothing; the kernel wrappers
themselves refuse meta tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.geom import (GEOM_RR, GEOM_RS, GEOM_RT, GEOM_SS,
                                   GEOM_ST, GEOM_TT, box_axis_factors)
from repro_torch.core.gs import ds_sum_local
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import nekbone_ax as _ax
from repro_torch.kernels import wkv6 as _wkv6
from repro_torch.kernels.ref import accum_dtype

__all__ = ["nekbone_ax", "nekbone_ax_dots", "nekbone_ax_pap",
           "slab_axis_factors", "diag_metric", "nekbone_ax_dots_slab",
           "nekbone_cg_update", "nekbone_ax_dots_slab_block",
           "nekbone_cg_update_block", "nekbone_ax_powers",
           "nekbone_sstep_update", "nekbone_pcg_update",
           "nekbone_cheb_precond", "nekbone_interp", "flash_attention",
           "wkv6"]


def nekbone_ax(u: torch.Tensor, D: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """Fused local Poisson operator  w = D^T (G (D u))  through K1.

    Args:
      u: (E, n, n, n) nodal values, layout [e, k, j, i].
      D: (n, n) derivative matrix (dxm1).
      g: (E, 6, n, n, n) metric fields (rr, rs, rt, ss, st, tt).
    """
    E = u.shape[0]
    n = u.shape[-1]
    w2 = _ax.nekbone_ax_cuda(u.reshape(E, n ** 3), D.contiguous(),
                             g.reshape(E, 6, n ** 3), n=n)
    return w2.reshape(u.shape)


def nekbone_ax_dots(p: torch.Tensor, D: torch.Tensor, g: torch.Tensor,
                    mask: torch.Tensor, r: torch.Tensor, c: torch.Tensor):
    """Masked local Ax and the two CG inner products through K2.

    Args:
      p, r: (E, n, n, n) search direction / residual (p continuous).
      D: (n, n); g: (E, 6, n, n, n); mask, c: (E, n, n, n).

    Returns ``(w, pap, rcz)``: the *masked local* operator output (still to
    be assembled with gs — mask and gs commute) and the summed scalars
    ``pap == p·c·(mask gs w)`` and ``rcz == r·c·r``.  The reference's
    ``block_e`` and ``interpret`` have no counterpart: K2 works per element.
    """
    E = p.shape[0]
    n = p.shape[-1]
    n3 = n ** 3
    w2, pap_e, rcz_e = _ax.nekbone_ax_dots_cuda(
        p.reshape(E, n3), D.contiguous(), g.reshape(E, 6, n3),
        mask.reshape(E, n3), r.reshape(E, n3), c.reshape(E, n3), n=n)
    return w2.reshape(p.shape), torch.sum(pap_e), torch.sum(rcz_e)


def nekbone_ax_pap(p: torch.Tensor, D: torch.Tensor, g: torch.Tensor,
                   mask: torch.Tensor):
    """Masked local Ax and ``p·c·(mask gs w)`` through K3 (the v1 loop's
    kernel: :func:`nekbone_ax_dots` without the ``r·c·r`` partial).

    Returns ``(w, pap)``.
    """
    E = p.shape[0]
    n = p.shape[-1]
    n3 = n ** 3
    w2, pap_e = _ax.nekbone_ax_pap_cuda(
        p.reshape(E, n3), D.contiguous(), g.reshape(E, 6, n3),
        mask.reshape(E, n3), n=n)
    return w2.reshape(p.shape), torch.sum(pap_e)


def slab_axis_factors(grid: tuple[int, int, int], n: int, dtype: torch.dtype,
                      device):
    """Per-axis mask and c factors of the structured box, as tensors.

    Thin casting wrapper over :func:`repro_torch.core.geom.box_axis_factors`;
    the factor values (0, 1, 1/2) are exact in every supported dtype, so the
    in-kernel products reproduce the full fields bitwise.
    Returns ``((mx, my, mz), (cx, cy, cz))``.
    """
    masks, cs = box_axis_factors(grid, n)
    return (tuple(torch.as_tensor(m, dtype=dtype, device=device)
                  for m in masks),
            tuple(torch.as_tensor(c, dtype=dtype, device=device)
                  for c in cs))


def diag_metric(g: torch.Tensor, E: int, n: int) -> torch.Tensor:
    """Pack the metric to its (rr, ss, tt) diagonal, shape (E, 3, n^3).

    Accepts an already-packed (E, 3, ...) metric, or the general
    6-component one when its off-diagonal entries are zero — true for every
    axis-aligned ``BoxMesh``.  The check reads the card once, at set-up.
    """
    if g.shape[1] == 3:
        return g.reshape(E, 3, n ** 3).contiguous()
    if g.shape[1] != 6:
        raise ValueError(f"metric must have 3 or 6 components, got "
                         f"{tuple(g.shape)}")
    if bool(g[:, [GEOM_RS, GEOM_RT, GEOM_ST]].any()):
        raise ValueError(
            "the slab (v2) pipeline requires an axis-aligned (diagonal-"
            "metric) mesh; off-diagonal metric entries are non-zero")
    return g[:, [GEOM_RR, GEOM_SS, GEOM_TT]].reshape(E, 3, n ** 3).contiguous()


def _scalars(value, nrhs: int | None, dtype: torch.dtype, device):
    """A step scalar in the accumulation dtype of ``dtype``: one value, or
    (for ``nrhs`` lanes) a scalar or length-``nrhs`` vector broadcast."""
    t = torch.as_tensor(value, dtype=accum_dtype(dtype), device=device)
    if nrhs is None:
        return t.reshape(1)
    return torch.broadcast_to(t, (nrhs,)).contiguous()


def nekbone_ax_dots_slab(p_prev: torch.Tensor, r: torch.Tensor,
                         D: torch.Tensor, g3: torch.Tensor,
                         grid: tuple[int, int, int], *, beta=0.0):
    """The v2 front half (K4) on natural shapes, its output assembled.

    Computes ``p = r + beta * p_prev`` and the *fully assembled* masked
    operator output ``w = mask * gs(D^T G D p)``: K4 writes it unassembled
    and this wrapper assembles it (``core/gs.ds_sum_local``), as the
    reference's wrapper stitches its blocks' boundary planes.  The
    reference's ``sz``, ``layout``, ``grid_order`` and ``interpret`` are TPU
    knobs with no counterpart, and the accumulation dtype is the build's
    (f64 for f64, f32 otherwise).

    Args:
      p_prev, r: (E, n, n, n); elements z-major over ``grid``.
      D: (n, n); g3: (E, 3, n, n, n) metric diagonal (rr, ss, tt), or a
         6-component metric whose off-diagonal entries are zero
         (:func:`diag_metric`).
      grid: (EX, EY, EZ); beta: direction-update scalar.

    Returns ``(p, w, pap)`` with ``pap == p·c·(mask gs w_local)``.
    """
    E = p_prev.shape[0]
    n = p_prev.shape[-1]
    n3 = n ** 3
    grid = tuple(grid)
    (mx, my, mz), _ = slab_axis_factors(grid, n, p_prev.dtype,
                                        p_prev.device)
    p2, w2, pap_e = _ax.nekbone_ax_slab_cuda(
        p_prev.reshape(E, n3).contiguous(), r.reshape(E, n3).contiguous(),
        D.to(p_prev.dtype).contiguous(),
        diag_metric(g3.to(p_prev.dtype), E, n), mx, my, mz,
        _scalars(beta, None, p_prev.dtype, p_prev.device), n=n)
    w = ds_sum_local(w2.reshape(p_prev.shape), grid)
    return p2.reshape(p_prev.shape), w, torch.sum(pap_e)


def nekbone_cg_update(x: torch.Tensor, p: torch.Tensor, r: torch.Tensor,
                      w: torch.Tensor, alpha, grid: tuple[int, int, int]):
    """The v2 back half (K5) on natural shapes.

    Computes ``x + alpha p``, ``r - alpha gs(w)`` and the weighted norm
    ``sum(r_new * c * r_new)`` of the stored residual, ``c`` rebuilt in the
    kernel.  ``w`` is the masked *unassembled* operator output of K4
    (``kernels.nekbone_ax.nekbone_ax_slab_cuda``): the kernel assembles
    it, so the reference's ``addb``/``addt`` boundary planes have no
    counterpart, nor do its ``sz`` and ``interpret``.

    Args:
      x, p, r, w: (E, n, n, n); alpha: a float or a scalar tensor; grid:
      the element grid.

    Returns ``(x_new, r_new, rtz_new)``.
    """
    E = x.shape[0]
    n = x.shape[-1]
    n3 = n ** 3
    _, (cx, cy, cz) = slab_axis_factors(tuple(grid), n, p.dtype, p.device)
    x2, r2, rcr_e = _ax.nekbone_cg_update_cuda(
        x.reshape(E, n3), p.reshape(E, n3), r.reshape(E, n3),
        w.reshape(E, n3), _scalars(alpha, None, p.dtype, p.device), cx, cy,
        cz, n=n)
    return x2.reshape(x.shape), r2.reshape(x.shape), torch.sum(rcr_e)


def nekbone_ax_dots_slab_block(p_prev: torch.Tensor, r: torch.Tensor,
                               D: torch.Tensor, g3: torch.Tensor,
                               grid: tuple[int, int, int], *, beta=0.0):
    """The batched v2 front half (K6) on natural shapes, its output
    assembled: :func:`nekbone_ax_dots_slab` over a leading right-hand-side
    axis (b, E, n, n, n), ``beta`` a scalar or a length-b vector.

    Returns ``(p, w, pap)`` with ``pap`` a length-b vector of per-RHS
    ``p·c·(mask gs w_local)``, each lane's sum taken on its own row.
    """
    nrhs, E = p_prev.shape[0], p_prev.shape[1]
    n = p_prev.shape[-1]
    n3 = n ** 3
    grid = tuple(grid)
    (mx, my, mz), _ = slab_axis_factors(grid, n, p_prev.dtype,
                                        p_prev.device)
    p3, w3, pap_be = _ax.nekbone_ax_slab_block_cuda(
        p_prev.reshape(nrhs, E, n3).contiguous(),
        r.reshape(nrhs, E, n3).contiguous(),
        D.to(p_prev.dtype).contiguous(),
        diag_metric(g3.to(p_prev.dtype), E, n), mx, my, mz,
        _scalars(beta, nrhs, p_prev.dtype, p_prev.device), n=n)
    w = torch.stack([ds_sum_local(w3[j].reshape(E, n, n, n), grid)
                     for j in range(nrhs)])
    return (p3.reshape(p_prev.shape), w,
            torch.stack([torch.sum(row) for row in pap_be]))


def nekbone_cg_update_block(x: torch.Tensor, p: torch.Tensor,
                            r: torch.Tensor, w: torch.Tensor, alpha,
                            grid: tuple[int, int, int]):
    """The batched v2 back half (K7) on natural shapes:
    :func:`nekbone_cg_update` over a leading right-hand-side axis (b, E, n,
    n, n), ``alpha`` a scalar or a length-b vector, ``w`` K6's unassembled
    output.

    Returns ``(x_new, r_new, rtz_new)`` with ``rtz_new`` a length-b vector
    of per-RHS weighted norms of the stored residual.
    """
    nrhs, E = x.shape[0], x.shape[1]
    n = x.shape[-1]
    n3 = n ** 3
    _, (cx, cy, cz) = slab_axis_factors(tuple(grid), n, p.dtype, p.device)
    x3, r3, rcr_be = _ax.nekbone_cg_update_block_cuda(
        x.reshape(nrhs, E, n3), p.reshape(nrhs, E, n3),
        r.reshape(nrhs, E, n3), w.reshape(nrhs, E, n3),
        _scalars(alpha, nrhs, p.dtype, p.device), cx, cy, cz, n=n)
    return (x3.reshape(x.shape), r3.reshape(x.shape),
            torch.stack([torch.sum(row) for row in rcr_be]))


def nekbone_pcg_update(x: torch.Tensor, p: torch.Tensor, z: torch.Tensor,
                       w: torch.Tensor, alpha, invdiag: torch.Tensor,
                       grid: tuple[int, int, int]):
    """Merged Jacobi-PCG vector update (K10) on natural shapes.

    The solver carries ``z = invdiag * r``; this computes ``x + alpha p``,
    ``z - alpha invdiag gs(w)`` and the two weighted partials of the
    reconstructed residual ``r = z / invdiag``: ``rtz = r·c·z`` (the PCG
    beta numerator) and ``rcr = r·c·r`` (the history entry), ``c`` rebuilt
    in the kernel.

    Args:
      x, p, z: (E, n, n, n); w: (E, n, n, n) the masked *unassembled*
      operator output of K4 — the kernel assembles it, so the reference's
      ``addb``/``addt`` boundary planes have no counterpart; alpha: a float
      or a scalar tensor; invdiag: (E, n, n, n) assembled ``1/diag(A)``
      (1 at masked rows); grid: the element grid.

    Returns ``(x_new, z_new, rtz, rcr)``.
    """
    E = x.shape[0]
    n = x.shape[-1]
    n3 = n ** 3
    _, (cx, cy, cz) = slab_axis_factors(tuple(grid), n, x.dtype, x.device)
    x2, z2, rtz_e, rcr_e = _ax.nekbone_pcg_update_cuda(
        x.reshape(E, n3), p.reshape(E, n3), z.reshape(E, n3),
        w.reshape(E, n3),
        torch.as_tensor(alpha, dtype=accum_dtype(x.dtype), device=x.device),
        invdiag.reshape(E, n3), cx, cy, cz, n=n)
    return (x2.reshape(x.shape), z2.reshape(x.shape), torch.sum(rtz_e),
            torch.sum(rcr_e))


def nekbone_cheb_precond(r: torch.Tensor, D: torch.Tensor, g3: torch.Tensor,
                         coef, grid: tuple[int, int, int], *, k: int):
    """Chebyshev preconditioner application (K11) on natural shapes.

    Evaluates ``z = q_k(A) r`` — k chained masked, assembled operator
    applications combined by the Chebyshev recurrence scalars — and the
    weighted partial ``rtz = r·c·z``.

    Args:
      r: (E, n, n, n), continuous and masked, z-major over ``grid``.
      D: (n, n); g3: the (E, 3, ...) metric diagonal or a 6-component
         metric whose off-diagonal entries are zero; coef: (k+1, 2)
         recurrence scalars (:func:`repro_torch.core.precond.cheb_scalars`);
      k: polynomial degree (>= 1).

    Returns ``(z, rtz)``.
    """
    E = r.shape[0]
    n = r.shape[-1]
    (mx, my, mz), (cx, cy, cz) = slab_axis_factors(tuple(grid), n, r.dtype,
                                                   r.device)
    D = D.to(r.dtype).contiguous()
    g3 = diag_metric(g3.to(r.dtype), E, n)
    coef = torch.as_tensor(coef, dtype=accum_dtype(r.dtype),
                           device=r.device).contiguous()
    z2, rtz_e = _ax.nekbone_cheb_apply_cuda(
        r.reshape(E, n ** 3).contiguous(), D, g3, mx, my, mz, cx, cy, cz,
        coef, n=n, k=k)
    return z2.reshape(r.shape), torch.sum(rtz_e)


def nekbone_interp(u: torch.Tensor, M, grid: tuple[int, int, int]
                   ) -> torch.Tensor:
    """Tensor-product GLL-to-GLL interpolation (K12) on natural shapes.

    Applies ``M`` — (n_out, n_in), e.g.
    :func:`repro_torch.core.pmg.gll_interp_matrix` — along each local
    direction of ``u`` (E, n_in, n_in, n_in), elements z-major over
    ``grid``: the p-multigrid transfer.  ``M`` built fine-from-coarse
    prolongs; its transpose is the restriction core.  Element-local, so
    ``grid`` only fixes E.

    Returns (E, n_out, n_out, n_out) in ``u``'s dtype.
    """
    E = u.shape[0]
    nin = u.shape[-1]
    ex, ey, ez = grid
    if E != ex * ey * ez:
        raise ValueError(f"u has {E} elements, grid {tuple(grid)} has "
                         f"{ex * ey * ez}")
    M = torch.as_tensor(M, dtype=u.dtype, device=u.device)
    nout = M.shape[0]
    if tuple(M.shape) != (nout, nin):
        raise ValueError(f"M has shape {tuple(M.shape)}, expected "
                         f"({nout}, {nin})")
    v2 = _ax.nekbone_interp_cuda(u.reshape(E, nin ** 3).contiguous(),
                                 M.T.contiguous(), nin=nin, nout=nout)
    return v2.reshape(E, nout, nout, nout)


def nekbone_ax_powers(p: torch.Tensor, r: torch.Tensor, D: torch.Tensor,
                      g3: torch.Tensor, grid: tuple[int, int, int], *, s: int,
                      theta: float = 1.0):
    """The s-step matrix-powers kernel (K8) on natural shapes.

    Evaluates the scaled Krylov basis of one s-step cycle —
    ``A' = (gs mask ax_local) / theta`` chained s times from ``p`` and s-1
    times from ``r`` — and the (2s+1)^2 Gram block of ``V = [p, A'p..,
    r, A'r..]`` under the weight ``c``.  The reference's halo windows and
    its ``sz``, ``layout`` and ``grid_order`` are TPU knobs with no
    counterpart: K8 computes the same function over the whole box.

    Args:
      p, r: (E, n, n, n), z-major over ``grid``; both continuous and masked.
      D: (n, n); g3: diagonal (E, 3, ...) or a 6-component metric whose
         off-diagonal entries are zero; theta: basis scale; s: powers per
         cycle (1..``SSTEP_MAX_S``).

    Returns ``(basis, gram)``: basis (E, 2s-1, n, n, n) holding
    ``[A'p..A'^s p, A'r..A'^{s-1} r]`` and the summed (2s+1, 2s+1) Gram
    matrix.
    """
    E = p.shape[0]
    n = p.shape[-1]
    n3 = n ** 3
    (mx, my, mz), (cx, cy, cz) = slab_axis_factors(tuple(grid), n, p.dtype,
                                                   p.device)
    inv_theta = torch.full((1,), 1.0 / theta, dtype=accum_dtype(p.dtype),
                           device=p.device)
    basis, gram_e = _ax.nekbone_ax_powers_cuda(
        p.reshape(E, n3).contiguous(), r.reshape(E, n3).contiguous(),
        D.to(p.dtype).contiguous(), diag_metric(g3.to(p.dtype), E, n), mx, my,
        mz, cx, cy, cz, inv_theta, n=n, s=s)
    return basis.reshape(E, 2 * s - 1, n, n, n), torch.sum(gram_e, dim=0)


def nekbone_sstep_update(x: torch.Tensor, p: torch.Tensor, r: torch.Tensor,
                         basis: torch.Tensor, coef, grid: tuple[int, int, int],
                         *, s: int):
    """The s-step multi-axpy (K9) on natural shapes.

    ``x += V e``, ``r = V b``, ``p = V a`` with ``V`` in K8's column order
    and ``coef`` the (3, 2s+1) rows (e, b, a), plus the post-cycle
    ``sum(r * c * r)`` (``c`` rebuilt in the kernel).

    Args:
      x, p, r: (E, n, n, n); basis: (E, 2s-1, n, n, n) from
      :func:`nekbone_ax_powers`; coef: (3, 2s+1).

    Returns ``(x_new, r_new, p_new, rcr)``.
    """
    E = x.shape[0]
    n = x.shape[-1]
    n3 = n ** 3
    _, (cx, cy, cz) = slab_axis_factors(tuple(grid), n, x.dtype, x.device)
    coef = torch.as_tensor(coef, dtype=accum_dtype(x.dtype),
                           device=x.device).contiguous()
    x2, r2, p2, rcr_e = _ax.nekbone_sstep_update_cuda(
        x.reshape(E, n3), p.reshape(E, n3), r.reshape(E, n3),
        basis.reshape(E, 2 * s - 1, n3), coef, cx, cy, cz, n=n, s=s)
    return (x2.reshape(x.shape), r2.reshape(x.shape), p2.reshape(x.shape),
            torch.sum(rcr_e))


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window: int | None = None,
                    softcap: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Block online-softmax attention forward (K13), the reference's
    signature less ``block_q``, ``block_k`` and ``interpret``.

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d); returns (B, Hq, Sq, d) in
    q's dtype.  GQA (Hq a multiple of Hkv), causal mask, sliding ``window``
    (query i sees key j iff i - j < window), logit ``softcap`` and
    ``q_offset`` (the absolute position of q[0]).  The three left out have
    no counterpart: K13's tiles are fixed by its build (bf16: 64 query rows
    by 64 keys on the tensor cores; f32: 16 query rows by 32 keys), and a
    CPU tensor runs the plain version.
    """
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    if q.device.type == "meta":         # the dry run: shapes alone
        with _build.plain_on_meta("flash_attn"):
            return ref.flash_attention_plain(q, k, v, causal=causal,
                                             scale=scale, window=window,
                                             softcap=softcap,
                                             q_offset=q_offset)
    return _flash.flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                       window=window, softcap=softcap,
                                       q_offset=q_offset)


def wkv6(r, k, v, w, u, *, initial_state=None, return_state: bool = False,
         variant: str = "chunked"):
    """The RWKV6 recurrence (K14), the reference's signature less
    ``block_t`` and ``interpret``.

    r, k, v, w: (B, H, T, d); u: (H, d) -> o (B, H, T, d) [, final state
    (B, H, d, d) f32].  The reference's two ``variant`` bodies compute one
    function, and one kernel serves both (the name is still checked).  The
    two left out have no counterpart: the kernel needs no padding of T, and
    a CPU tensor runs the plain version.
    """
    if variant not in ("sequential", "chunked"):
        raise ValueError(f"unknown wkv6 variant {variant!r}")
    if r.device.type == "meta":
        # the dry run: the chunked plain form's products (the reference's
        # training body, 16 steps a chunk), batched over the chunks
        with _build.plain_on_meta("wkv6"):
            o, state = ref.wkv6_chunked_batched(
                r, k, v, w, u, initial_state=initial_state, chunk=16,
                return_state=True)
    else:
        o, state = _wkv6.wkv6_cuda(r, k, v, w, u,
                                   initial_state=initial_state)
    return (o, state) if return_state else o
