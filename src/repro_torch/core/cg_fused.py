"""Step-fused conjugate gradients: the v1 and v2 iterations in CUDA kernels.

**v1** (:func:`cg_fused_fixed_iters`, DESIGN.md §3.3): K3
(``kernels/csrc/nekbone_ax_dots.cu``) applies the full-metric operator and
the mask field and emits per-element ``p·w`` partials; the direct-stiffness
sum (``gs.ds_sum_local``) and the vector updates stay torch passes.  The
``r·c·r`` reduction is carried through the loop (it equals the previous
iteration's post-update reduction), so the kernel reads no ``r``/``c``:
17 streams per iteration.  v1 takes any mask and weight fields, not only
the structured box's.

**v2** (:func:`cg_fused_v2_fixed_iters`, DESIGN.md §3.4): no standalone
full-field pass.  Per iteration:

* K4 (``kernels/csrc/nekbone_ax_slab.cu``) folds ``p = r + beta p`` into
  the operator, applies the diagonal-metric ``Ax`` and the structural mask,
  and emits per-element ``p·w`` partials taken before assembly (the
  continuity identity, DESIGN.md §3.2);
* K5 (``kernels/csrc/nekbone_cg_update.cu``) assembles ``w`` by reading the
  neighbours' face copies in ``ds_sum_local``'s order, applies both axpys
  and emits per-element ``r·c·r`` partials of the stored residual.

The mask and the weight ``c`` are rebuilt in the kernels from per-axis
factors, and the axis-aligned metric collapses to its diagonal: 9 reads and
4 writes per iteration, the book of ``core/cost.py``.  The partials are
summed by ``torch.sum`` between the kernels; ``alpha``, ``beta`` and the
history stay on the device, so the fixed-iteration loop never waits for the
card.  The loop (:func:`_run`) and the operand preparation are shared with
the preconditioned and tolerance-driven drivers of ``core/precond.py``.

**ir** (:func:`cg_ir_fixed_iters`, DESIGN.md §7): iterative refinement.
Low-precision inner solves over v2, v1 or s-step, each scaled by the
residual's inf-norm, and an outer residual ``r = b - mask gs(A x)`` formed
in ``b``'s precision by one assembled K1 per sweep.  The ``bf16`` and
``bf16_ir`` policies run K4, K5, K3, K8 and K9 in their bf16 builds (bf16
storage, f32 accumulation), so both run over v2, v1 and s-step on the
card.

The reference's v1 ``block_e``, and its v2 slab split ``sz``, contraction
``layout`` and ``grid_order``, are TPU VMEM knobs with no counterpart here:
the kernels work per element.

**v1 sharded** (:func:`cg_fused_sharded_fixed_iters`, DESIGN.md §10): the
v1 iteration on one shard of a z-slab decomposition — K3 on the shard's
block, ``gs.ds_sum_sharded`` for the assembly (one exchange of the
boundary planes, two ppermutes) and the torch vector pass, with the
``pap`` and ``r·c·r`` partials summed by two psums in the accumulation
dtype.

Preconditions: ``b`` must be assembled (coincident copies equal —
manufactured right-hand sides are) and masked.
"""
from __future__ import annotations

import torch

from repro_torch.core.cg import CGResult, SolveResult
from repro_torch.core.geom import box_axis_factors, box_outer
from repro_torch.core.gs import ds_sum_local, ds_sum_sharded
from repro_torch.core.precision import resolve_policy
from repro_torch.kernels import nekbone_ax as _ax

__all__ = ["cg_fused_fixed_iters", "cg_fused_v2_fixed_iters",
           "cg_fused_sharded_fixed_iters", "cg_ir_fixed_iters"]


def cg_fused_fixed_iters(b: torch.Tensor, *, D: torch.Tensor,
                         g: torch.Tensor, mask: torch.Tensor,
                         c: torch.Tensor, grid: tuple[int, int, int],
                         niter: int, precision=None) -> SolveResult:
    """Fixed-iteration CG through the fused-iteration pipeline (v1, K3).

    Args:
      b:     (E, n, n, n) assembled, masked right-hand side.
      D:     (n, n) derivative matrix.
      g:     (E, 6, n, n, n) metric fields.
      mask:  (E, n, n, n) Dirichlet mask (0/1 valued).
      c:     (E, n, n, n) inner-product weight (mask / multiplicity).
      grid:  element grid (EX, EY, EZ) with EX*EY*EZ == E.
      niter: iteration count (the paper runs 100).
      precision: policy name / policy / ``None`` (infer from ``b.dtype``):
             operands are cast to the storage dtype, the partials and
             scalars live in the accumulation dtype.

    Per iteration: K3 (masked ``Ax`` and ``p·w`` partials), ``torch.sum``,
    ``ds_sum_local``, the two axpys, the ``r·c·r`` of the stored ``r`` and
    ``p = r + beta p``; alpha, beta and the history stay on the device, so
    the loop never waits for the card.  Returns a :class:`SolveResult`
    whose history matches ``cg_fixed_iters`` to round-off.
    """
    policy, b = _policy(b, precision)
    E = b.shape[0]
    n = b.shape[-1]
    n3 = n ** 3
    grid = tuple(grid)
    acc = policy.accum_dtype
    D = D.to(policy.op_storage_dtype).contiguous()
    g2 = g.to(policy.op_storage_dtype).reshape(E, 6, n3).contiguous()
    mask2 = mask.to(b.dtype).reshape(E, n3).contiguous()
    c_acc = c.to(b.dtype).to(acc)
    # r·c·r is carried through the loop: each iteration's post-update
    # reduction is the next iteration's rtz, so K3 needs no r/c operands.
    rtz = torch.sum(b.to(acc) * c_acc * b.to(acc))

    def body(state, rtz):
        x, r, p = state
        w2, pap_e = _ax.nekbone_ax_pap_cuda(p.reshape(E, n3), D, g2, mask2,
                                            n=n)
        pap = torch.sum(pap_e)
        # mask commutes with gs (coincident copies share their mask value),
        # so the kernel's masked output assembles directly.
        w = ds_sum_local(w2.reshape(b.shape), grid)
        alpha = rtz / pap
        x = (x.to(acc) + alpha * p.to(acc)).to(policy.x_storage_dtype)
        r = (r.to(acc) - alpha * w.to(acc)).to(b.dtype)
        # over the *stored* r, the residual the next iteration reads
        rtz_new = torch.sum(r.to(acc) * c_acc * r.to(acc))
        beta = rtz_new / rtz
        p = (r.to(acc) + beta * p.to(acc)).to(b.dtype)
        return (x, r, p), rtz_new, torch.sqrt(torch.abs(rtz_new))

    state = (torch.zeros(b.shape, dtype=policy.x_storage_dtype,
                         device=b.device), b, b)
    (x, *_), k, hist = _run(body, state, rtz, torch.sqrt(torch.abs(rtz)),
                            None, niter)
    return SolveResult.from_cg(_result(x, k, hist, b.shape),
                               pipeline="fused_v1")


def cg_fused_sharded_fixed_iters(b: torch.Tensor, *, D: torch.Tensor,
                                 g: torch.Tensor, mask: torch.Tensor,
                                 c: torch.Tensor,
                                 grid_local: tuple[int, int, int],
                                 niter: int, mesh=None,
                                 precision=None) -> SolveResult:
    """Fixed-iteration v1 CG on one shard of a z-slab decomposition.

    Every shard of ``mesh`` (default
    :func:`repro_torch.distributed.sharding.solver_mesh`) calls it with its
    own blocks: ``b``, ``g``, ``mask``, ``c`` its ``(E_local, ...)`` slices
    of the global fields (``sharding.shard_leading``) and ``grid_local``
    its element grid ``(EX, EY, EZ_local)``.  Per iteration: K3 on the
    block, one psum of ``pap``, ``ds_sum_sharded`` (two ppermutes), the
    axpys, one psum of ``r·c·r``.  The psum'd partials travel in the
    accumulation dtype, so every shard takes the same ``alpha`` and
    ``beta``, and the history (replicated) matches
    :func:`cg_fused_fixed_iters` to round-off.  Returns the shard's block
    of ``x`` with the global history, as the reference's ``shard_map`` body
    does.
    """
    from repro_torch.distributed import sharding

    mesh = sharding.solver_mesh() if mesh is None else mesh
    policy, b = _policy(b, precision)
    E = b.shape[0]
    n = b.shape[-1]
    n3 = n ** 3
    acc = policy.accum_dtype
    D = D.to(policy.op_storage_dtype).contiguous()
    g2 = g.to(policy.op_storage_dtype).reshape(E, 6, n3).contiguous()
    mask2 = mask.to(b.dtype).reshape(E, n3).contiguous()
    c_acc = c.to(b.dtype).to(acc)

    def gsum(v):
        return sharding.psum(v.reshape(1), mesh)[0]

    rtz = gsum(torch.sum(b.to(acc) * c_acc * b.to(acc)))

    def body(state, rtz):
        x, r, p = state
        w2, pap_e = _ax.nekbone_ax_pap_cuda(p.reshape(E, n3), D, g2, mask2,
                                            n=n)
        pap = gsum(torch.sum(pap_e))
        w = ds_sum_sharded(w2.reshape(b.shape), tuple(grid_local), mesh)
        alpha = rtz / pap
        x = (x.to(acc) + alpha * p.to(acc)).to(policy.x_storage_dtype)
        r = (r.to(acc) - alpha * w.to(acc)).to(b.dtype)
        rtz_new = gsum(torch.sum(r.to(acc) * c_acc * r.to(acc)))
        beta = rtz_new / rtz
        p = (r.to(acc) + beta * p.to(acc)).to(b.dtype)
        return (x, r, p), rtz_new, torch.sqrt(torch.abs(rtz_new))

    state = (torch.zeros(b.shape, dtype=policy.x_storage_dtype,
                         device=b.device), b, b)
    (x, *_), k, hist = _run(body, state, rtz, torch.sqrt(torch.abs(rtz)),
                            None, niter)
    return SolveResult.from_cg(_result(x, k, hist, b.shape),
                               pipeline="fused_v1_sharded")


def _check_box_fields(grid, n, mask, c) -> None:
    """Verify caller-supplied mask/c match the structural box fields.

    The v2 kernels *rebuild* both from per-axis factors
    (``geom.box_axis_factors``), so silently accepting a different mask or
    weight would compute a different problem.  The structural fields are
    built from the factors on the fields' own device, and one flag per field
    is read to the host, at set-up.
    """
    (mx, my, mz), (cx, cy, cz) = box_axis_factors(grid, n)
    for name, field, factors in (("mask", mask, (mz, my, mx)),
                                 ("c", c, (cz, cy, cx))):
        if field is None:
            continue
        want = box_outer(*(torch.as_tensor(f, device=field.device)
                           for f in factors)).reshape(-1, n, n, n)
        if tuple(field.shape) != tuple(want.shape) or not torch.equal(
                field.to(torch.float64), want):
            raise ValueError(
                f"pallas_fused_cg_v2 requires the structured box {name} "
                "(per-axis factorizable); supplied field differs")


def _v2_iter(x2, r2, p2, rtz, beta, *, D, g3, mx, my, mz, cx, cy, cz,
             n: int):
    """One full v2 CG iteration (both kernels).

    Returns ``(x2, r2, p2, rtz_new, beta_new)``.
    """
    # front half: p = r + beta p, masked Ax, per-element pap partials.
    p2, w2, pap_e = _ax.nekbone_ax_slab_cuda(p2, r2, D, g3, mx, my, mz, beta,
                                             n=n)
    pap = torch.sum(pap_e)
    alpha = rtz / pap
    # back half: assemble w, both axpys, post-update r·c·r partials.
    x2, r2, rcr_e = _ax.nekbone_cg_update_cuda(x2, p2, r2, w2, alpha, cx, cy,
                                               cz, n=n)
    rtz_new = torch.sum(rcr_e)
    beta = rtz_new / rtz
    return x2, r2, p2, rtz_new, beta


def _policy(b, precision):
    """The precision policy of a solve and ``b`` cast to its storage dtype.

    A refined policy passed to a v1, v2 or s-step solve runs as its storage
    policy, as in the reference: the refinement loop is
    :func:`cg_ir_fixed_iters`.
    """
    policy = resolve_policy(precision, b.dtype)
    return policy, b.to(policy.storage_dtype)


def _prepare(b, D, g, grid, mask, c, precision):
    """Operands of the v2-family drivers (here and in core/precond.py).

    Returns ``(policy, b, n, grid, op)``: the precision policy, ``b`` cast
    to its storage dtype, and ``op``, the keyword operands of the kernels —
    D and the metric diagonal in the operator-storage dtype, and the
    per-axis mask and ``c`` factors.
    """
    from repro_torch.kernels import ops as kernel_ops

    policy, b = _policy(b, precision)
    E = b.shape[0]
    n = b.shape[-1]
    grid = tuple(grid)
    _check_box_fields(grid, n, mask, c)
    (mx, my, mz), (cx, cy, cz) = kernel_ops.slab_axis_factors(
        grid, n, b.dtype, b.device)
    op = dict(D=D.to(policy.op_storage_dtype).contiguous(),
              g3=kernel_ops.diag_metric(g.to(policy.op_storage_dtype), E, n),
              mx=mx, my=my, mz=mz, cx=cx, cy=cy, cz=cz, n=n)
    return policy, b, n, grid, op


def _run(body, state, rtz, r0, tol2: float | None, max_iter: int):
    """The iteration loop shared by every v2-family driver.

    Runs ``state, rtz, rnorm = body(state, rtz)`` while fewer than
    ``max_iter`` iterations have run and ``|rtz| > tol2`` — the reference's
    ``while_loop`` condition, checked before each iteration; for a batch
    (``rtz`` of shape (b,), core/cg_block.py) while any lane is above it.
    With ``tol2=None`` exactly ``max_iter`` iterations run and the host
    never waits for the card; otherwise the host reads the condition before
    every iteration.  Since the fixed and the tolerance-driven runs share
    this loop and their bodies, the tolerance-driven history is bitwise a
    prefix of the fixed one.

    Returns ``(state, k, hist)``: ``k`` iterations ran, and ``hist`` holds
    ``r0`` and the ``k`` norms the body returned along its last axis,
    NaN-padded to ``max_iter + 1`` entries (shape ``(*r0.shape,
    max_iter + 1)``).
    """
    norms = [r0]
    k = 0
    while k < max_iter and (tol2 is None or _live(rtz, tol2)):
        state, rtz, rnorm = body(state, rtz)
        norms.append(rnorm)
        k += 1
    hist = torch.full((*r0.shape, max_iter + 1), float("nan"),
                      dtype=r0.dtype, device=r0.device)
    hist[..., :k + 1] = torch.stack(norms, dim=-1)
    return state, k, hist


def _live(rtz, tol2: float) -> bool:
    """Host read of the stop rule: some ``|rtz|`` is above ``tol2``."""
    above = torch.abs(rtz) > tol2
    return bool(above.any() if above.ndim else above)


def _result(x2, k: int, hist, shape) -> CGResult:
    return CGResult(x=x2.reshape(shape),
                    iters=torch.tensor(k, device=hist.device),
                    rnorm=hist[..., k], rnorm_history=hist)


def _cg_v2_tol(b, op, policy, tol2: float | None,
               max_iter: int) -> CGResult:
    """Unpreconditioned v2 CG over K4 + K5, under :func:`_run`.

    The reference keeps this tolerance-driven core in core/precond.py; here
    it sits beside :func:`_v2_iter`, and the fixed driver below runs it with
    ``tol2=None``.
    """
    acc = policy.accum_dtype
    b2 = b.reshape(b.shape[0], -1).contiguous()
    c2 = box_outer(op["cz"], op["cy"], op["cx"]).reshape(
        b2.shape).to(acc)
    rtz = torch.sum(b2.to(acc) * c2 * b2.to(acc))

    def body(state, rtz):
        x2, r2, p2, beta = state
        x2, r2, p2, rtz, beta = _v2_iter(x2, r2, p2, rtz, beta, **op)
        return (x2, r2, p2, beta), rtz, torch.sqrt(torch.abs(rtz))

    state = (torch.zeros(b2.shape, dtype=policy.x_storage_dtype,
                         device=b2.device),
             b2, torch.zeros_like(b2), torch.zeros((), dtype=acc,
                                                   device=b2.device))
    (x2, *_), k, hist = _run(body, state, rtz, torch.sqrt(torch.abs(rtz)),
                             tol2, max_iter)
    return _result(x2, k, hist, b.shape)


def cg_fused_v2_fixed_iters(b: torch.Tensor, *, D: torch.Tensor,
                            g: torch.Tensor, grid: tuple[int, int, int],
                            niter: int, mask: torch.Tensor | None = None,
                            c: torch.Tensor | None = None,
                            precision=None) -> SolveResult:
    """Fixed-iteration CG, whole iteration in two CUDA kernels (v2).

    Args:
      b:     (E, n, n, n) assembled, masked right-hand side; elements
             z-major over ``grid``.
      D:     (n, n) derivative matrix.
      g:     (E, 6, n, n, n) metric (off-diagonals must be zero — the
             axis-aligned box), or pre-packed (E, 3, n, n, n) diagonal.
      grid:  element grid (EX, EY, EZ).
      niter: iteration count.
      mask/c: optional — the kernels rebuild both from per-axis factors;
             when passed they are validated against the structural fields
             and otherwise unused.
      precision: policy name / policy / ``None`` (infer from ``b.dtype``):
             b and the metric are cast to the storage dtype.

    Returns a :class:`SolveResult` whose history matches ``cg_fixed_iters``
    to round-off.
    """
    policy, b, n, grid, op = _prepare(b, D, g, grid, mask, c, precision)
    return SolveResult.from_cg(_cg_v2_tol(b, op, policy, None, niter),
                               pipeline="fused_v2")


# ---------------------------------------------------------------------------
# iterative refinement: low-precision fused inner solves, high-precision
# residuals (DESIGN.md §7)
# ---------------------------------------------------------------------------

IR_VARIANTS = ("v2", "v1", "sstep")


def cg_ir_fixed_iters(b: torch.Tensor, *, D: torch.Tensor, g: torch.Tensor,
                      grid: tuple[int, int, int], niter: int = 100,
                      precision="bf16_ir", outer_iters: int | None = None,
                      inner_iters: int | None = None,
                      mask: torch.Tensor | None = None,
                      c: torch.Tensor | None = None, variant: str = "v2",
                      s: int = 4) -> SolveResult:
    """Mixed-precision CG: fused low-precision inner solves wrapped in an
    iterative-refinement outer loop.

    Low-precision storage stalls plain CG at the storage dtype's round-off
    floor (bf16: ~4e-3 relative).  Each sweep

        r_k = b - mask gs(A x_k)          (b's precision, one K1 launch)
        e_k = solve(A e = r_k / s_k)      (v2, v1 or s-step, the policy's
                                           storage, ``inner_iters`` its)
        x_{k+1} = x_k + s_k e_k           (b's precision)

    with ``s_k = max|r_k|``, taken on the device, so the narrow mantissa
    holds the digits that are still wrong.  The sweeps restart CG, so each
    runs the full ``inner_iters``.

    Args:
      b:     (E, n, n, n) assembled, masked right-hand side, in the
             precision the refined residuals should reach (f64: the
             paper's).
      D, g, grid: as :func:`cg_fused_fixed_iters` (``g`` the full
             6-component metric: the outer refresh applies it).
      niter: inner iterations per sweep (the paper's protocol runs 100).
      precision: the policy (default ``bf16_ir``); its storage prices the
             inner iterations.
      outer_iters: sweeps; default 5 for storage narrower than 4 bytes and
             2 otherwise (the reference's code; its docstring says 3).
      inner_iters: overrides ``niter`` per sweep.
      mask/c: structural fields; built from the box's per-axis factors
             when omitted.
      variant: inner pipeline, ``"v2"`` (K4 + K5), ``"v1"`` (K3) or
             ``"sstep"`` (K8 + K9, s iterations per cycle; theta is
             estimated once per solve).

    Returns a :class:`SolveResult`: ``x`` in ``b``'s dtype, ``history``
    the ``outer_iters + 1`` outer norms ``sqrt(r·c·r)`` of the true
    residual, ``iters`` the total inner count.
    """
    if variant not in IR_VARIANTS:
        raise ValueError(f"variant must be one of {IR_VARIANTS}, got "
                         f"{variant!r}")
    policy = resolve_policy(precision, b.dtype)
    hi = b.dtype
    grid = tuple(grid)
    E = b.shape[0]
    n = b.shape[-1]
    if outer_iters is None:
        outer_iters = 5 if policy.storage_dtype.itemsize < 4 else 2
    if inner_iters is None:
        inner_iters = niter
    if mask is None or c is None:
        (mxf, myf, mzf), (cxf, cyf, czf) = box_axis_factors(grid, n)

        def structural(fz, fy, fx):
            return box_outer(*(torch.as_tensor(f, device=b.device)
                               for f in (fz, fy, fx))).reshape(b.shape)

        if mask is None:
            mask = structural(mzf, myf, mxf)
        if c is None:
            c = structural(czf, cyf, cxf)
    mask_hi = mask.to(hi)
    c_hi = c.to(hi)
    D_hi = D.to(hi).contiguous()
    g2_hi = g.to(hi).reshape(E, 6, n ** 3).contiguous()

    def refresh(x):
        """The residual in b's precision and its weighted norm."""
        w = _ax.nekbone_ax_cuda(x.reshape(E, n ** 3), D_hi, g2_hi, n=n)
        r = b - ds_sum_local(w.reshape(b.shape), grid) * mask_hi
        return r, torch.sqrt(torch.abs(torch.sum(r * c_hi * r)))

    theta = None
    if variant == "sstep":
        from repro_torch.core.cg_sstep import estimate_theta

        # theta depends only on the operator: once per solve, not per sweep
        theta = estimate_theta(D_hi, g.to(hi), grid, mask_hi)

    def inner(r_scaled):
        if variant == "sstep":
            from repro_torch.core.cg_sstep import cg_sstep_fixed_iters

            return cg_sstep_fixed_iters(
                r_scaled, D=D, g=g, grid=grid, niter=inner_iters, s=s,
                mask=mask, c=c, theta=theta, precision=policy)
        if variant == "v2":
            # the caller's mask/c are validated against the box fields the
            # kernels rebuild: the refresh applies them.
            return cg_fused_v2_fixed_iters(
                r_scaled, D=D, g=g, grid=grid, niter=inner_iters, mask=mask,
                c=c, precision=policy)
        return cg_fused_fixed_iters(
            r_scaled, D=D, g=g, mask=mask, c=c, grid=grid,
            niter=inner_iters, precision=policy)

    x = torch.zeros_like(b)
    r = b
    norms = [torch.sqrt(torch.abs(torch.sum(b * c_hi * b)))]
    # tracing: the recorder is read once per solve; one `is None` test per
    # sweep when off, an "ir.sweep" span per refinement when on
    from repro_torch.obs import trace as _trace

    rec = _trace.active()
    for sweep in range(outer_iters):
        with (rec.span("ir.sweep", sweep=sweep, variant=variant,
                       inner_iters=inner_iters)
              if rec is not None else _trace.NULL_SPAN):
            # inf-norm scaling, on the device: no host read per sweep
            scale = torch.max(torch.abs(r))
            scale = torch.where(scale > 0, scale, torch.ones_like(scale))
            e = inner(r / scale).x
            x = x + scale * e.to(hi)
            r, rn = refresh(x)
            norms.append(rn)
    hist = torch.stack(norms)
    return SolveResult.from_cg(
        CGResult(x=x, iters=torch.tensor(outer_iters * inner_iters,
                                         device=b.device),
                 rnorm=hist[-1], rnorm_history=hist),
        pipeline="ir")
