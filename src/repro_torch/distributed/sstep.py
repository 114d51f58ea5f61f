"""Sharded s-step CG: the K8 + K9 cycle over a z-slab decomposition.

Single-device s-step CG (``core/cg_sstep.py``, DESIGN.md §8) amortises
memory traffic over s iterations; this module amortises the network the
same way (DESIGN.md §10).  Elements are split along z over a 1-D
:class:`repro_torch.distributed.sharding.SolverMesh` — z-major element
order makes the leading axis a stack of contiguous z-slabs — and one cycle
issues exactly one exchange and one all-reduce:

1. **one s-deep ghost-slab exchange** — K8 applies the operator s times, so
   a shard needs its neighbours' s edge layers of both p and r.  Both
   fields' layers go in one buffer and one :func:`repro_torch.distributed.
   sharding.ppermute_pair` (two ppermutes, one a direction).  K8 then runs
   unchanged on the shard's extended grid (``distributed/halo.py``), and
   the shard keeps its own layers' basis and Gram partials.
2. **one psum** — the own elements' ``(2s+1)^2`` Gram partials, summed on
   the shard, with the previous update's ``r·c·r`` partial riding in the
   same buffer: one all-reduce gives every shard the same ``G`` and the
   reduced ``r·c·r``.  (The reference sums the update's partials on its one
   host; a multi-process program would need a second collective for that.
   The last update's partial is reduced once after the loop.)

Everything else is local: the f64 recurrence runs on every shard's host on
the replicated ``G`` (``core/cg_sstep.cycle_coefficients``), and K9 updates
the shard's own x, p and r with no collective.  The answer comes back with
one all-gather after the loop.

The reference's interior/boundary split of the powers call, which lets XLA
overlap the halo transfer with interior compute, is a scheduling choice of
XLA's, not a result, and is not ported.  The loop-invariant windows of the
metric diagonal and the z factors are cut once per solve from the global
arrays (every shard holds them), so only p and r cross between shards.

Correctness: the sharded trajectory equals the single-device one to fp64
round-off (the Gram psum and the ``r·c·r`` psum reassociate sums;
everything else is bitwise).  :func:`cycle_collective_counts` reads the
counter over one cycle and one update: ``{"ppermute": 2, "psum": 1}`` and
``{}``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cg import CGResult, SolveResult
from repro_torch.core.cg_fused import _prepare
from repro_torch.core.cg_sstep import cycle_coefficients, estimate_theta
from repro_torch.core.geom import box_axis_factors, box_outer
from repro_torch.distributed import sharding
from repro_torch.distributed.halo import ghost_window
from repro_torch.kernels import nekbone_ax as _ax

__all__ = ["exchange_ghost_slabs", "cg_sstep_sharded_fixed_iters",
           "cycle_collective_counts"]


def exchange_ghost_slabs(f: torch.Tensor, ez_local: int, halo: int, mesh):
    """Exchange ``halo`` ghost z-slabs of a shard's field.

    ``f`` is ``(ez_local, ...)`` slab-major (reshape ``(E_local, n^3)``
    fields to ``(ez_l, EY*EX, n^3)`` first).  Returns ``(below, above)`` —
    the neighbour shards' ``halo`` edge slabs, zeros at the global ends.
    Two ppermutes.
    """
    if not 0 < halo <= ez_local:
        raise ValueError(f"halo {halo} out of range for ez_local "
                         f"{ez_local}")
    return sharding.ppermute_pair(f[ez_local - halo:].contiguous(),
                                  f[:halo].contiguous(), mesh)


class _Shard:
    """One shard's operands of the cycle and the update: the loop-invariant
    windows (cut once) and the local factors."""

    def __init__(self, op, grid, s: int, mesh, inv_theta):
        ex, ey, _ = grid
        self.n = op["n"]
        self.s = s
        self.mesh = mesh
        self.win = ghost_window(mesh, grid, s)
        win = self.win
        self.ez_l = win.ez_local
        self.eyex = ex * ey
        self.D = op["D"]
        self.mx, self.my, self.cx, self.cy = (op["mx"], op["my"], op["cx"],
                                              op["cy"])
        self.g3_ext = win.cut(op["g3"])
        self.mz_ext = win.cut_z(op["mz"])
        self.cz_ext = win.cut_z(op["cz"])
        self.cz = op["cz"][win.z0:win.z0 + win.ez_local].contiguous()
        self.inv_theta = inv_theta

    def cycle(self, p2, r2, rcr_prev):
        """Exchange, K8 on the extended grid, the one psum.  Returns
        ``(basis, G, rcr)``: the own elements' basis, the global Gram block
        and the global reduction of ``rcr_prev`` (this shard's partial of
        the previous update's ``r·c·r``)."""
        n3 = self.n ** 3
        layers = (self.ez_l, self.eyex, n3)
        buf = torch.stack([p2.reshape(layers), r2.reshape(layers)], dim=1)
        below, above = exchange_ghost_slabs(buf, self.ez_l, self.s,
                                            self.mesh)
        pext = self.win.extend(p2, below[:, 0], above[:, 0])
        rext = self.win.extend(r2, below[:, 1], above[:, 1])
        basis, gram_e = _ax.nekbone_ax_powers_cuda(
            pext, rext, self.D, self.g3_ext, self.mx, self.my, self.mz_ext,
            self.cx, self.cy, self.cz_ext, self.inv_theta, n=self.n, s=self.s)
        K = 2 * self.s + 1
        part = torch.cat([torch.sum(self.win.own(gram_e), dim=0).reshape(-1),
                          rcr_prev.reshape(1).to(gram_e.dtype)])
        total = sharding.psum(part, self.mesh)
        return (self.win.own(basis), total[:K * K].reshape(K, K),
                total[K * K])

    def update(self, x2, p2, r2, basis, coef):
        """K9 on the shard's own grid: no collective.  Returns ``(x, r, p,
        rcr)`` with ``rcr`` this shard's summed partial."""
        x2, r2, p2, rcr_e = _ax.nekbone_sstep_update_cuda(
            x2, p2, r2, basis, coef, self.cx, self.cy, self.cz, n=self.n,
            s=self.s)
        return x2, r2, p2, torch.sum(rcr_e)


def _setup(b, D, g, grid, s, mask, c, theta, precision, mesh):
    if s < 1:
        raise ValueError(f"s-step CG needs s >= 1, got {s}")
    policy, b, n, grid, op = _prepare(b, D, g, grid, mask, c, precision)
    acc = policy.accum_dtype
    if theta is None:
        if mask is None:
            masks = box_axis_factors(grid, n)[0]
            mask = box_outer(*(torch.as_tensor(f) for f in reversed(masks)))
        theta = estimate_theta(D.to(b.dtype), g.to(b.dtype), grid,
                               mask.to(dtype=b.dtype, device=b.device)
                               .reshape(b.shape))
    inv_theta = torch.full((1,), 1.0 / theta, dtype=acc, device=b.device)
    return policy, b, n, grid, op, theta, _Shard(op, grid, s, mesh,
                                                 inv_theta)


def cg_sstep_sharded_fixed_iters(
        b: torch.Tensor, *, D: torch.Tensor, g: torch.Tensor,
        grid: tuple[int, int, int], niter: int, s: int = 4,
        mask: torch.Tensor | None = None, c: torch.Tensor | None = None,
        theta: float | None = None, tol: float | None = None,
        precision=None, mesh=None) -> SolveResult:
    """Sharded s-step CG over a z-slab decomposition.

    Drop-in for :func:`repro_torch.core.cg_sstep.cg_sstep_fixed_iters`:
    global arrays in (every shard passes the same ones), a result with the
    global ``x`` on every shard out, the trajectory equal to fp64
    round-off; one exchange and one psum per cycle, nothing else.

    Extra argument: ``mesh``, the solver mesh (default
    :func:`repro_torch.distributed.sharding.solver_mesh`).  Constraints:
    ``EZ % ndev == 0`` and ``s <= EZ / ndev`` (ghost slabs come from the
    adjacent shard only).

    With ``tol``, the stop rule reads the previous update's reduced
    ``r·c·r``, which arrives with the next cycle's Gram psum; every shard
    reads the same value, so all stop together (one cycle's K8 is then
    spent for the reading).
    """
    mesh = sharding.solver_mesh() if mesh is None else mesh
    policy, b, n, grid, op, theta, sh = _setup(b, D, g, grid, s, mask, c,
                                               theta, precision, mesh)
    E = b.shape[0]
    n3 = n ** 3
    acc = policy.accum_dtype
    dev = b.device
    b_l = sharding.shard_leading(b.reshape(E, n3), mesh).contiguous()
    x2 = torch.zeros(b_l.shape, dtype=policy.x_storage_dtype, device=dev)
    r2 = p2 = b_l
    tol2 = None if tol is None else float(tol) ** 2
    hist: list[float] = []
    rcr_part = None
    rcr_last = None
    it = 0
    zero = torch.zeros((), dtype=acc, device=dev)
    from repro_torch.obs import trace as _trace

    rec = _trace.active()
    while it < niter:
        m = min(s, niter - it)
        with (rec.span("sstep.sharded_cycle", it=it, s=s, ndev=mesh.ndev)
              if rec is not None else _trace.NULL_SPAN):
            basis, G, rcr_red = sh.cycle(
                p2, r2, rcr_part if rcr_part is not None else zero)
            if rcr_part is not None:
                rcr_last = float(rcr_red)
                if tol2 is not None and abs(rcr_last) <= tol2:
                    rcr_part = None
                    break
            Gh = G.cpu().numpy().astype(policy.gram)
            coef_np, rtzs, m = cycle_coefficients(Gh, s, m, theta, tol2)
            if m == 0:
                rcr_part = None
                break
            hist.extend(np.sqrt(np.abs(v)) for v in rtzs)
            coef = torch.as_tensor(coef_np, dtype=acc, device=dev)
            x2, r2, p2, rcr_part = sh.update(x2, p2, r2, basis, coef)
        it += m
        if tol2 is not None and m < s:
            break
    if rcr_part is not None:
        # the last update's partial: its own psum, once, after the loop
        rcr_last = float(sharding.psum(rcr_part.reshape(1), mesh)[0])
    if rcr_last is None:                  # niter == 0 (or tol met at start)
        c2 = box_outer(sh.cz, op["cy"], op["cx"]).reshape(-1, n3).to(acc)
        rcr_last = float(sharding.psum(
            torch.sum(r2.to(acc) * c2 * r2.to(acc)).reshape(1), mesh)[0])
    hist.append(float(np.sqrt(abs(rcr_last))))
    hist_t = torch.as_tensor(np.asarray(hist, np.float64), dtype=acc,
                             device=dev)
    x = sharding.all_gather(x2, mesh)
    return SolveResult.from_cg(
        CGResult(x=x.reshape(b.shape), iters=torch.tensor(it, device=dev),
                 rnorm=hist_t[-1], rnorm_history=hist_t),
        pipeline="sstep_v3_sharded")


def cycle_collective_counts(*, grid: tuple[int, int, int], n: int,
                            s: int = 4, mesh=None, device=None) -> dict:
    """The collectives of one sharded cycle and one update, counted.

    Runs one cycle and one update of the sharded driver on a random fp64
    field of the global ``grid`` on ``device`` (the card unless
    ``"cpu"`` is asked for; every shard of ``mesh`` calls it together) and reads
    :mod:`repro_torch.distributed.sharding`'s counter over each.
    Returns ``{"cycle": {...}, "update": {...}}`` (calls by kind, kinds
    with none left out) and ``"bytes"``, the cycle's bytes by kind.  The
    DESIGN.md §10 contract is ``cycle == {"ppermute": 2, "psum": 1}`` and
    ``update == {}``.
    """
    from repro_torch.core.nekbone import NekboneCase

    mesh = sharding.solver_mesh() if mesh is None else mesh
    case = NekboneCase(n=n, grid=tuple(grid), dtype=torch.float64,
                       device=device)
    gen = torch.Generator().manual_seed(0)
    f = torch.randn(case.mask.shape, generator=gen,
                    dtype=torch.float64).to(case.mask.device) * case.mask
    _, b, _, _, _, _, sh = _setup(f, case.D, case.g, case.grid, s, None,
                                  None, 2.25, None, mesh)
    E = b.shape[0]
    b_l = sharding.shard_leading(b.reshape(E, n ** 3), mesh).contiguous()
    rcr = torch.zeros((), dtype=b.dtype, device=b.device)
    with sharding.collective_log() as cyc:
        basis, G, _ = sh.cycle(b_l, b_l, rcr)
    Gh = G.cpu().numpy().astype(np.float64)
    coef_np, _, _ = cycle_coefficients(Gh, s, s, 2.25)
    coef = torch.as_tensor(coef_np, dtype=b.dtype, device=b.device)
    with sharding.collective_log() as upd:
        sh.update(torch.zeros_like(b_l), b_l, b_l, basis, coef)
    return {"cycle": cyc.counts, "update": upd.counts, "bytes": cyc.bytes}
