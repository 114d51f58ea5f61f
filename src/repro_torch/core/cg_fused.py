"""Step-fused conjugate gradients: the v2 iteration in two CUDA kernels.

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
history stay on the device, so the loop never waits for the card.

The reference's slab split ``sz``, contraction ``layout`` and
``grid_order`` are TPU VMEM knobs with no counterpart here.  The v1 and
sharded pipelines and iterative refinement are not ported yet
(ROADMAP.md).

Preconditions: ``b`` must be assembled (coincident copies equal —
manufactured right-hand sides are) and masked; unpreconditioned CG only.
"""
from __future__ import annotations

import torch

from repro_torch.core.cg import CGResult, SolveResult
from repro_torch.core.geom import box_axis_factors, box_outer
from repro_torch.core.precision import resolve_policy
from repro_torch.kernels import nekbone_ax as _ax

__all__ = ["cg_fused_v2_fixed_iters"]


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
    from repro_torch.kernels import ops as kernel_ops

    policy = resolve_policy(precision, b.dtype)
    if policy.refine:
        raise NotImplementedError(
            f"precision {policy.name!r} needs iterative refinement "
            "(cg_ir_fixed_iters), not ported yet: ROADMAP.md queue 1 item 9")
    b = b.to(policy.storage_dtype)
    E = b.shape[0]
    n = b.shape[-1]
    grid = tuple(grid)
    dev = b.device
    acc = policy.accum_dtype
    _check_box_fields(grid, n, mask, c)
    (mx, my, mz), (cx, cy, cz) = kernel_ops.slab_axis_factors(
        grid, n, b.dtype, dev)
    D = D.to(policy.op_storage_dtype).contiguous()
    g3 = kernel_ops.diag_metric(g.to(policy.op_storage_dtype), E, n)

    b2 = b.reshape(E, n ** 3).contiguous()
    c2 = box_outer(cz, cy, cx).reshape(E, n ** 3).to(acc)
    rtz = torch.sum(b2.to(acc) * c2 * b2.to(acc))
    x2 = torch.zeros(b2.shape, dtype=policy.x_storage_dtype, device=dev)
    r2 = b2
    p2 = torch.zeros_like(b2)
    beta = torch.zeros((), dtype=acc, device=dev)
    norms = []
    for _ in range(niter):
        norms.append(torch.sqrt(torch.abs(rtz)))
        x2, r2, p2, rtz, beta = _v2_iter(
            x2, r2, p2, rtz, beta, D=D, g3=g3, mx=mx, my=my, mz=mz,
            cx=cx, cy=cy, cz=cz, n=n)
    norms.append(torch.sqrt(torch.abs(rtz)))
    hist = torch.stack(norms)
    return SolveResult.from_cg(
        CGResult(x=x2.reshape(b.shape), iters=torch.tensor(niter, device=dev),
                 rnorm=hist[niter], rnorm_history=hist),
        pipeline="fused_v2")
