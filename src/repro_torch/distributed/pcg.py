"""Sharded Jacobi and Chebyshev PCG over the z-slab decomposition.

The two fused PCG pipelines of ``core/precond.py`` (DESIGN.md §9) split
over the same 1-D solver mesh as the sharded s-step driver
(:mod:`repro_torch.distributed.sstep`), with per iteration:

* **Jacobi** — K4 on the shard's own grid; one psum of ``pap``; the edge
  planes of K4's unassembled ``w`` (``core/gs.edge_planes``: the x,y sums
  of the bottom layer's ``k = 0`` face and the top layer's ``k = n-1``
  face) go to the neighbour shards in one exchange (two ppermutes); K10
  takes the planes that arrive and adds them in the z step of its
  assembly, where the single-shard K10 adds the neighbour layer's value,
  so the assembled ``w`` is bitwise the single-device one; one psum of
  ``rtz`` stacked with ``rcr``.  2 ppermutes and 2 psums.
* **Chebyshev** — K4, the ``pap`` psum, the plane exchange and K5 with the
  planes, as above; then ``z = q_k(A) r``: k ghost layers of ``r`` from
  each neighbour (one exchange, two ppermutes) and K11 unchanged on the
  shard's extended grid (``distributed/halo.py``), whose own layers are
  exact after k operator applications; one psum of ``rtz`` stacked with
  ``rcr``.  4 ppermutes and 2 psums.

Both run under ``core/cg_fused._run``: the stop rule reads the psum'd
``rtz``, which every shard holds bitwise alike, so all shards stop
together, and the tolerance-driven history is bitwise a prefix of the
fixed run's.  Both match the single-device trajectories to fp64 round-off
(the psums reassociate the partial sums; the planes are bitwise).

The reference's slab knobs (``sz``, ``cheb_sz``) and ``interpret`` are TPU
knobs with no counterpart.  Global arrays go in, every shard passing the
same ones; the preconditioner is built from them (the diagonal, the
Lanczos interval) on every shard, and the answer comes back with one
all-gather.
"""
from __future__ import annotations

import torch

from repro_torch.core.cg import SolveResult
from repro_torch.core.cg_fused import _prepare, _result, _run
from repro_torch.core.geom import box_outer
from repro_torch.core.gs import edge_planes
from repro_torch.core.precond import (ChebyshevPrecond, JacobiPrecond,
                                      _resolve_precond)
from repro_torch.distributed import sharding
from repro_torch.distributed.halo import ghost_window
from repro_torch.distributed.sstep import exchange_ghost_slabs
from repro_torch.kernels import nekbone_ax as _ax

__all__ = ["pcg_sharded_fixed_iters", "pcg_sharded_tol"]


class _Shard:
    """One shard's operands (its blocks of the global ones) and the two
    exchanges of an iteration."""

    def __init__(self, op, grid, mesh, policy):
        ex, ey, ez = grid
        self.mesh = mesh
        self.full = op                     # the global operands
        self.n = op["n"]
        self.acc = policy.accum_dtype
        self.ez_l = ez // mesh.ndev
        self.grid_local = (ex, ey, self.ez_l)
        self.eyex = ex * ey
        z0 = mesh.shard * self.ez_l
        self.op = dict(op, g3=sharding.shard_leading(op["g3"], mesh),
                       mz=op["mz"][z0:z0 + self.ez_l].contiguous(),
                       cz=op["cz"][z0:z0 + self.ez_l].contiguous())
        self.c2 = box_outer(self.op["cz"], op["cy"], op["cx"]) \
            .reshape(-1, self.n ** 3).to(self.acc)

    def ax(self, p2, r2, beta):
        """K4 and the pap psum: ``(p, w, pap)``."""
        o = self.op
        p2, w2, pap_e = _ax.nekbone_ax_slab_cuda(
            p2, r2, o["D"], o["g3"], o["mx"], o["my"], o["mz"], beta,
            n=self.n)
        return p2, w2, sharding.psum(torch.sum(pap_e).reshape(1),
                                     self.mesh)[0]

    def planes(self, w2):
        """The neighbours' edge planes of ``w2``, as K5 and K10 take them
        (None at a global end)."""
        bottom, top = edge_planes(w2, self.grid_local, self.acc)
        from_below, from_above = sharding.ppermute_pair(top, bottom,
                                                        self.mesh)
        return (None if self.mesh.first else from_below,
                None if self.mesh.last else from_above)

    def psum2(self, a, b):
        """One psum of two partial sums."""
        return sharding.psum(torch.stack([torch.sum(a), torch.sum(b)]),
                             self.mesh)


def _pcg_jacobi(sh: _Shard, b2, invd2, policy, tol2, max_iter):
    """Sharded mirror of ``core/precond._pcg_jacobi``: K4, psum, planes,
    K10 with the planes, psum."""
    acc = sh.acc
    o = sh.op
    b_acc = b2.to(acc)
    z0 = (invd2.to(acc) * b_acc).to(b2.dtype)
    s0 = sh.psum2(b_acc * sh.c2 * z0.to(acc), b_acc * sh.c2 * b_acc)

    def body(state, rtz):
        x2, z2, p2, beta = state
        p2, w2, pap = sh.ax(p2, z2, beta)
        alpha = rtz / pap
        below, above = sh.planes(w2)
        x2, z2, rtz_e, rcr_e = _ax.nekbone_pcg_update_cuda(
            x2, p2, z2, w2, alpha, invd2, o["cx"], o["cy"], o["cz"],
            n=sh.n, from_below=below, from_above=above)
        ss = sh.psum2(rtz_e, rcr_e)
        return (x2, z2, p2, ss[0] / rtz), ss[0], torch.sqrt(torch.abs(ss[1]))

    state = (torch.zeros(b2.shape, dtype=policy.x_storage_dtype,
                         device=b2.device),
             z0, torch.zeros_like(z0),
             torch.zeros((), dtype=acc, device=b2.device))
    return _run(body, state, s0[0], torch.sqrt(torch.abs(s0[1])), tol2,
                max_iter)


def _pcg_cheb(sh: _Shard, b2, coef, k: int, grid, policy, tol2, max_iter):
    """Sharded mirror of ``core/precond._pcg_cheb``: K4, psum, planes, K5
    with the planes, the k-deep ghost exchange of r, K11 on the extended
    grid, psum."""
    acc = sh.acc
    o = sh.op
    win = ghost_window(sh.mesh, grid, k)
    g3_ext = win.cut(sh.full["g3"])
    mz_ext = win.cut_z(sh.full["mz"])
    cz_ext = win.cut_z(sh.full["cz"])
    n3 = sh.n ** 3

    def cheb(r2):
        rb, ra = exchange_ghost_slabs(r2.reshape(sh.ez_l, sh.eyex, n3),
                                      sh.ez_l, k, sh.mesh)
        z_ext, rtz_e = _ax.nekbone_cheb_apply_cuda(
            win.extend(r2, rb, ra), o["D"], g3_ext, o["mx"], o["my"], mz_ext,
            o["cx"], o["cy"], cz_ext, coef, n=sh.n, k=k)
        return win.own(z_ext), win.own(rtz_e)

    def body(state, rtz):
        x2, r2, z2, p2, rtz_prev = state
        p2, w2, pap = sh.ax(p2, z2, rtz / rtz_prev)
        alpha = rtz / pap
        below, above = sh.planes(w2)
        x2, r2, rcr_e = _ax.nekbone_cg_update_cuda(
            x2, p2, r2, w2, alpha, o["cx"], o["cy"], o["cz"], n=sh.n,
            from_below=below, from_above=above)
        z2, rtz_e = cheb(r2)
        ss = sh.psum2(rtz_e, rcr_e)
        return (x2, r2, z2, p2, rtz), ss[0], torch.sqrt(torch.abs(ss[1]))

    z0, rtz0_e = cheb(b2)
    s0 = sh.psum2(rtz0_e, b2.to(acc) * sh.c2 * b2.to(acc))
    state = (torch.zeros(b2.shape, dtype=policy.x_storage_dtype,
                         device=b2.device),
             b2, z0, torch.zeros_like(b2),
             torch.ones((), dtype=acc, device=b2.device))
    return _run(body, state, s0[0], torch.sqrt(torch.abs(s0[1])), tol2,
                max_iter)


def _solve(b, precond, tol2, max_iter, *, D, g, grid, mask, c, precision,
           mesh) -> SolveResult:
    mesh = sharding.solver_mesh() if mesh is None else mesh
    policy, b, n, grid, op = _prepare(b, D, g, grid, mask, c, precision)
    E = b.shape[0]
    if grid[2] % mesh.ndev:
        raise ValueError(f"EZ {grid[2]} not divisible by {mesh.ndev} "
                         "shards")
    precond = _resolve_precond(precond, D=D, g=g, grid=grid, mask=mask, c=c)
    if precond is None:
        raise ValueError(
            "sharded PCG needs a preconditioner; for unpreconditioned "
            "sharded solves use distributed.sstep or "
            "core.cg_fused.cg_fused_sharded_fixed_iters")
    sh = _Shard(op, grid, mesh, policy)
    b2 = sharding.shard_leading(b.reshape(E, n ** 3), mesh).contiguous()
    from repro_torch.obs import trace as _trace

    rec = _trace.active()
    if isinstance(precond, JacobiPrecond):
        invd = precond.invdiag.to(dtype=policy.op_storage_dtype,
                                  device=b.device).reshape(E, n ** 3)
        invd2 = sharding.shard_leading(invd, mesh).contiguous()
        with (rec.span("pcg.sharded_dispatch", precond="jacobi",
                       ndev=mesh.ndev)
              if rec is not None else _trace.NULL_SPAN):
            (x2, *_), kk, hist = _pcg_jacobi(sh, b2, invd2, policy, tol2,
                                             max_iter)
    elif isinstance(precond, ChebyshevPrecond):
        k = int(precond.k)
        coef = torch.as_tensor(precond.scalars(), dtype=policy.accum_dtype,
                               device=b.device)
        with (rec.span("pcg.sharded_dispatch", precond=f"cheb{k}",
                       ndev=mesh.ndev)
              if rec is not None else _trace.NULL_SPAN):
            (x2, *_), kk, hist = _pcg_cheb(sh, b2, coef, k, grid, policy,
                                           tol2, max_iter)
    else:
        raise TypeError(f"unsupported preconditioner {precond!r} (sharded "
                        "PCG takes Jacobi or Chebyshev)")
    x = sharding.all_gather(x2, mesh)
    return SolveResult.from_cg(_result(x, kk, hist, b.shape),
                               pipeline="fused_v2_sharded",
                               precond=precond.name)


def pcg_sharded_fixed_iters(b: torch.Tensor, *, D: torch.Tensor,
                            g: torch.Tensor, grid: tuple[int, int, int],
                            niter: int, precond,
                            mask: torch.Tensor | None = None,
                            c: torch.Tensor | None = None, precision=None,
                            mesh=None) -> SolveResult:
    """Fixed-iteration sharded PCG (Jacobi or Chebyshev), z-slab mesh.

    Drop-in for :func:`repro_torch.core.precond.pcg_fused_v2_fixed_iters`
    on global arrays (the same trajectory to fp64 round-off), with
    ``mesh`` the solver mesh (default
    :func:`repro_torch.distributed.sharding.solver_mesh`).  The
    tolerance-driven run (:func:`pcg_sharded_tol`) is a bitwise prefix of
    this one.
    """
    return _solve(b, precond, None, niter, D=D, g=g, grid=grid, mask=mask,
                  c=c, precision=precision, mesh=mesh)


def pcg_sharded_tol(b: torch.Tensor, *, D: torch.Tensor, g: torch.Tensor,
                    grid: tuple[int, int, int], precond, tol: float = 1e-8,
                    max_iter: int = 100, mask: torch.Tensor | None = None,
                    c: torch.Tensor | None = None, precision=None,
                    mesh=None) -> SolveResult:
    """Tolerance-driven sharded PCG: stop before an iteration once the
    psum'd ``|rtz| <= tol**2``, which every shard reads alike.  History
    NaN-padded to ``max_iter + 1``."""
    return _solve(b, precond, float(tol) ** 2, max_iter, D=D, g=g,
                  grid=grid, mask=mask, c=c, precision=precision, mesh=mesh)
