"""Port parity: p-multigrid (``core/pmg.py``, the pmg branch of
``core/precond.py``, K12's plain version and ``ops.nekbone_interp``) against
the JAX package in fp64 on the CPU.

Two ladders: n=5 on grid (2, 2, 4) (5 -> 3 -> 2) and n=10 on grid (2, 2, 2)
(the paper's 10 -> 5 -> 3 -> 2).  Inputs come from numpy seeds.  The JAX
side runs the plain ``interp3`` and its Pallas kernels in interpret mode;
the port runs the plain versions its kernel wrappers take for CPU tensors.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.cg as jax_cg
import repro.core.cost as jax_cost
import repro.core.pmg as jax_pmg
import repro.core.precond as jax_pc
from repro.core.gs import ds_sum_local as jax_ds_sum
from repro.core.nekbone import NekboneCase as JaxCase
from repro_torch.convert import precond_from_reference
from repro_torch.core import cost as torch_cost
from repro_torch.core import pmg as torch_pmg
from repro_torch.core import precond as torch_pc
from repro_torch.core.gs import ds_sum_local
from repro_torch.core.nekbone import NekboneCase as TorchCase
from repro_torch.kernels import ops
from repro_torch.kernels.ref import nekbone_interp_plain

# PR 11's bar for PCG histories and solutions against the reference.
RTOL = 1e-10
LADDERS = [(5, (2, 2, 4)), (10, (2, 2, 2))]
PAIRS = [(10, 5), (5, 10), (5, 3), (3, 5), (3, 2), (2, 3)]


def _cases(n, grid, ax_impl="pallas_fused_cg_v2"):
    return (JaxCase(n=n, grid=grid, dtype=jnp.float64, ax_impl=ax_impl),
            TorchCase(n=n, grid=grid, dtype=torch.float64, ax_impl=ax_impl,
                      device="cpu"))


def _random_rhs(jcase, seed):
    """A random assembled, masked field, as numpy."""
    rng = np.random.default_rng(seed)
    u = jnp.asarray(rng.normal(size=jcase.mask.shape))
    return np.array(jax_ds_sum(u, jcase.grid) * jcase.mask)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _assert_parity(ref, got, rtol=RTOL):
    h_ref = np.asarray(ref.rnorm_history)
    h = got.rnorm_history.numpy()
    assert h.shape == h_ref.shape
    np.testing.assert_allclose(h, h_ref, rtol=0, atol=rtol * h_ref[0])
    xs = np.abs(np.asarray(ref.x)).max()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                               atol=rtol * xs)


# ---------------------------------------------------------------------------
# ladder, transfer matrices, books
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nf,nc", [(10, 5), (5, 3), (3, 2), (7, 4), (16, 8)])
def test_gll_interp_matrix_bitwise(nf, nc):
    """numpy f64 in the same order: bitwise, both directions, with exact
    0/1 endpoint rows."""
    for a, b in ((nf, nc), (nc, nf)):
        J = torch_pmg.gll_interp_matrix(a, b)
        np.testing.assert_array_equal(J, jax_pmg.gll_interp_matrix(a, b))
        e0 = np.zeros(b)
        e0[0] = 1.0
        np.testing.assert_array_equal(J[0], e0)
        np.testing.assert_array_equal(J[-1], e0[::-1])


@pytest.mark.parametrize("n", [3, 5, 7, 10, 16])
def test_pmg_books_match_reference(n):
    assert torch_cost.pmg_degrees(n) == jax_cost.pmg_degrees(n)
    assert torch_cost.pmg_dof_fracs(n) == jax_cost.pmg_dof_fracs(n)
    assert torch_cost.pmg_vcycle_streams(n) == jax_cost.pmg_vcycle_streams(n)
    assert torch_cost.pmg_streams(n) == jax_cost.pmg_streams(n)
    for k in (1, 3):
        assert torch_cost.pmg_flops_per_dof(n, k) == \
            jax_cost.pmg_flops_per_dof(n, k)
    assert (torch_cost.PMG_DEFAULT_K, torch_cost.PMG_COARSE_ITERS,
            torch_cost.PMG_SMOOTH_RATIO) == (jax_cost.PMG_DEFAULT_K,
                                             jax_cost.PMG_COARSE_ITERS,
                                             jax_cost.PMG_SMOOTH_RATIO)
    assert torch_cost.pmg_degrees(10) == (10, 5, 3, 2)


# ---------------------------------------------------------------------------
# K12's plain version and the ops wrapper against interp3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nin,nout", PAIRS)
def test_interp_plain_and_ops_match_interp3(x64, nin, nout):
    """Both directions of each ladder step: 1e-14 relative (summation order
    of the contractions only)."""
    grid = (2, 2, 2) if max(nin, nout) == 10 else (2, 2, 4)
    E = grid[0] * grid[1] * grid[2]
    rng = np.random.default_rng(nin * 17 + nout)
    u = rng.normal(size=(E, nin, nin, nin))
    M = (torch_pmg.gll_interp_matrix(nout, nin) if nout > nin
         else torch_pmg.gll_interp_matrix(nin, nout).T)      # (nout, nin)
    want = np.asarray(jax_pmg.interp3(jnp.asarray(u), jnp.asarray(M)))
    got = ops.nekbone_interp(torch.as_tensor(u), torch.as_tensor(M), grid)
    assert got.shape == (E, nout, nout, nout)
    assert _rel(got.numpy(), want) <= 1e-14
    flat = nekbone_interp_plain(torch.as_tensor(u).reshape(E, -1),
                                torch.as_tensor(M.T.copy()), nin=nin,
                                nout=nout)
    np.testing.assert_array_equal(flat.numpy(), got.numpy().reshape(E, -1))
    np.testing.assert_array_equal(
        torch_pmg.interp3(torch.as_tensor(u), M).numpy(), got.numpy())
    with pytest.raises(ValueError, match="elements"):
        ops.nekbone_interp(torch.as_tensor(u), torch.as_tensor(M), (1, 1, 1))


@pytest.mark.parametrize("nf,nc", [(10, 5), (5, 3), (3, 2)])
def test_prolongation_keeps_faces_bitwise(nf, nc):
    """J's endpoint rows are 0/1: element corners keep the coarse corner
    values, and a continuous coarse field prolongs to a field whose
    coincident copies are bitwise equal."""
    grid = (2, 2, 2)
    rng = np.random.default_rng(nf)
    ec = ds_sum_local(torch.as_tensor(rng.normal(size=(8, nc, nc, nc))),
                      grid)
    up = torch_pmg.interp3(ec, torch_pmg.gll_interp_matrix(nf, nc))
    ends = [0, -1]
    for a in ends:
        for b in ends:
            for c in ends:
                assert torch.equal(up[:, a, b, c], ec[:, a, b, c])
    v = up.reshape(2, 2, 2, nf, nf, nf)
    assert torch.equal(v[:, :, 0, :, :, -1], v[:, :, 1, :, :, 0])
    assert torch.equal(v[:, 0, :, :, -1, :], v[:, 1, :, :, 0, :])
    assert torch.equal(v[0, :, :, -1, :, :], v[1, :, :, 0, :, :])


# ---------------------------------------------------------------------------
# set-up, base solve, plain V-cycle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,grid", LADDERS)
def test_pmg_spec_matches_reference(x64, n, grid):
    """Per-level Lanczos estimates: ladder and counts equal, intervals at
    1e-8 relative (the Chebyshev interval's bar)."""
    jcase, tcase = _cases(n, grid)
    want = jcase.precond_spec("pmg")
    got = tcase.precond_spec("pmg")
    assert isinstance(got, torch_pc.PMGPrecond)
    assert got is tcase.precond_spec("pmg")          # cached per case
    assert got.ns == want.ns == torch_cost.pmg_degrees(n)
    assert (got.k, got.coarse_iters, got.lengths) == (
        want.k, want.coarse_iters, want.lengths)
    np.testing.assert_allclose(np.asarray(got.intervals),
                               np.asarray(want.intervals), rtol=1e-8)
    carried = precond_from_reference(want, dtype=torch.float64, device="cpu")
    assert carried == torch_pc.PMGPrecond(
        ns=want.ns, k=want.k, intervals=want.intervals,
        coarse_iters=want.coarse_iters, lengths=want.lengths)
    for lev in range(len(want.ns) - 1):
        np.testing.assert_array_equal(carried.scalars(lev),
                                      want.scalars(lev))


def test_make_preconditioner_pmg_spellings():
    case = TorchCase(n=5, grid=(2, 2, 4), dtype=torch.float64, device="cpu")
    kw = dict(D=case.D, g=case.g, grid=case.grid, mask=case.mask, c=case.c)
    spec = torch_pc.make_preconditioner("pmg", **kw)
    assert spec.ns == (5, 3, 2) and spec.k == torch_cost.PMG_DEFAULT_K
    spec2 = torch_pc.make_preconditioner("pmg[cheb2]", **kw)
    assert spec2.k == 2 and spec2.intervals == spec.intervals
    for bad in ("pmg[cheb]", "pmgX", "pmg[cheb0]", "pmg cheb2"):
        with pytest.raises(ValueError, match="pmg spellings"):
            torch_pc.make_preconditioner(bad, **kw)
    tiny = TorchCase(n=2, grid=(2, 2, 2), dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="n >= 3"):
        torch_pc.make_preconditioner("pmg", D=tiny.D, g=tiny.g,
                                     grid=tiny.grid, mask=tiny.mask,
                                     c=tiny.c)
    with pytest.raises(ValueError, match="per-level intervals"):
        torch_pmg.make_pmg_preconditioner(intervals=((0.1, 1.0),), **kw)


@pytest.mark.parametrize("grid", [(2, 2, 4), (3, 3, 3)])
def test_coarse_solve_fixed_matches_reference(x64, grid):
    """12 fixed CG iterations on the n=2 base level: 1e-13 relative.  On
    (2, 2, 4) the base system has 3 unknowns, so CG converges exactly and
    the zero-guarded alpha and beta carry the rest."""
    D, g, mask, c = jax_pmg.level_operator(2, grid)
    rng = np.random.default_rng(7)
    r = np.asarray(jax_ds_sum(jnp.asarray(rng.normal(size=mask.shape)), grid)
                   * mask)
    want = jax_pmg.coarse_solve_fixed(jnp.asarray(r), jnp.asarray(D),
                                      jnp.asarray(g), grid,
                                      jnp.asarray(mask), jnp.asarray(c),
                                      iters=12)
    tD, tg, tmask, tc = torch_pmg.level_operator(2, grid)
    for mine, theirs in zip((tD, tg, tmask, tc), (D, g, mask, c)):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    got = torch_pmg.coarse_solve_fixed(torch.as_tensor(r), tD, tg, grid,
                                       tmask, tc, iters=12)
    assert np.isfinite(got.numpy()).all()
    assert _rel(got.numpy(), want) <= 1e-13


@pytest.mark.parametrize("n,grid", LADDERS)
def test_vcycle_reference_matches_reference(x64, n, grid):
    """One application of the plain V-cycle on the reference's spec:
    1e-12 relative."""
    jcase, tcase = _cases(n, grid, ax_impl="fused")
    jspec = jcase.precond_spec("pmg")
    tspec = precond_from_reference(jspec, dtype=torch.float64, device="cpu")
    r = _random_rhs(jcase, 11)
    want = jax_pmg.pmg_vcycle_reference(
        jspec, D=jcase.D, g=jcase.g, grid=grid, mask=jcase.mask,
        c=jcase.c)(jnp.asarray(r))
    M = torch_pmg.pmg_vcycle_reference(tspec, D=tcase.D, g=tcase.g,
                                       grid=grid, mask=tcase.mask, c=tcase.c)
    got = M(torch.as_tensor(r))
    assert _rel(got.numpy(), want) <= 1e-12
    # symmetric and positive in the c-weighted inner product
    v = torch.as_tensor(_random_rhs(jcase, 12))
    u = torch.as_tensor(r)
    dot = tcase.dot()
    a1, a2 = float(dot(u, M(v))), float(dot(M(u), v))
    assert abs(a1 - a2) <= 1e-12 * abs(a1) and float(dot(u, got)) > 0.0


# ---------------------------------------------------------------------------
# the fused driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,grid,niter", [(5, (2, 2, 4), 8),
                                          (10, (2, 2, 2), 6)])
def test_fused_pmg_pcg_matches_reference(x64, n, grid, niter):
    """The reference's fused pmg PCG (interpret mode) and the port's, on
    the reference's spec carried across by ``convert``: history and x at
    1e-10."""
    jcase, tcase = _cases(n, grid)
    f = _random_rhs(jcase, n)
    jspec = jcase.precond_spec("pmg")
    ref = jax_pc.pcg_fused_v2_fixed_iters(
        jnp.asarray(f), D=jcase.D, g=jcase.g, grid=grid, niter=niter,
        precond=jspec, mask=jcase.mask, c=jcase.c, interpret=True)
    tspec = precond_from_reference(jspec, dtype=torch.float64, device="cpu")
    got = torch_pc.pcg_fused_v2_fixed_iters(
        torch.as_tensor(f), D=tcase.D, g=tcase.g, grid=grid, niter=niter,
        precond=tspec, mask=tcase.mask, c=tcase.c)
    assert got.precond == "pmg" and got.pipeline == "fused_v2"
    _assert_parity(ref, got)
    # and the plain V-cycle inside the port's reference CG loop
    M = torch_pmg.pmg_vcycle_reference(tspec, D=tcase.D, g=tcase.g,
                                       grid=grid, mask=tcase.mask, c=tcase.c)
    from repro_torch.core.cg import cg_fixed_iters

    plain = cg_fixed_iters(tcase.ax_full, torch.as_tensor(f), niter=niter,
                           dot=tcase.dot(), precond=M)
    _assert_parity(plain, got)


def test_pmg_tol_history_is_a_prefix_of_the_fixed_one():
    n, grid, niter = 5, (2, 2, 4), 10
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64,
                      ax_impl="pallas_fused_cg_v2", device="cpu")
    _, f = tcase.manufactured()
    spec = tcase.precond_spec("pmg")
    kw = dict(D=tcase.D, g=tcase.g, grid=grid, mask=tcase.mask, c=tcase.c,
              precond=spec)
    fixed = torch_pc.pcg_fused_v2_fixed_iters(f, niter=niter, **kw)
    h_fix = fixed.history.numpy()
    tol = float(h_fix[4]) * (1.0 + 1e-12)
    res = torch_pc.cg_fused_tol(f, tol=tol, max_iter=niter, **kw)
    it = int(res.iters)
    h = res.history.numpy()
    assert 0 < it < niter and h.shape == (niter + 1,)
    np.testing.assert_array_equal(h[:it + 1], h_fix[:it + 1])
    assert np.isnan(h[it + 1:]).all() and float(res.rnorm) == h[it]


# ---------------------------------------------------------------------------
# through NekboneCase.solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ax_impl,niter", [("pallas_fused_cg_v2", 8),
                                           ("pallas_fused_cg_v2", None),
                                           ("fused", 8)])
def test_case_solve_pmg_routes(x64, ax_impl, niter):
    """``precond="pmg"`` through the ``v2``, ``v2_tol`` and ``reference``
    routes, each case with its own Lanczos intervals, against the
    reference case's solve: iteration counts equal, histories at 1e-10."""
    from repro_torch.core.solvers import route_name

    n, grid = 5, (2, 2, 4)
    jcase, tcase = _cases(n, grid, ax_impl=ax_impl)
    _, jf = jcase.manufactured()
    _, tf = tcase.manufactured()
    kw = dict(niter=niter, tol=1e-9, max_iter=40, precond="pmg")
    ref = jcase.solve(jf, **kw)
    got = tcase.solve(tf, **kw)
    assert route_name(tcase, niter=niter, pc_name="pmg") == {
        ("pallas_fused_cg_v2", 8): "v2", ("pallas_fused_cg_v2", None):
        "v2_tol", ("fused", 8): "reference"}[(ax_impl, niter)]
    assert int(got.iters) == int(ref.iters)
    _assert_parity(ref, got)
    if niter is None:
        assert float(got.rnorm) <= 1e-9 < float(got.history[0])


def test_vcycle_plain_matches_jax_cg_with_reference_cycle(x64):
    """The reference route's whole solve: the reference's ``cg`` with its
    own plain V-cycle and the port's, on one spec, stop at the same
    iteration with histories at 1e-10."""
    n, grid = 10, (2, 2, 2)
    jcase, tcase = _cases(n, grid, ax_impl="fused")
    jspec = jcase.precond_spec("pmg")
    tspec = precond_from_reference(jspec, dtype=torch.float64, device="cpu")
    f = _random_rhs(jcase, 5)
    jM = jax_pmg.pmg_vcycle_reference(jspec, D=jcase.D, g=jcase.g, grid=grid,
                                      mask=jcase.mask, c=jcase.c)
    ref = jax_cg.cg(jcase.ax_full, jnp.asarray(f), tol=1e-10, max_iter=30,
                    dot=jcase.dot(), precond=jM)
    from repro_torch.core.cg import cg

    tM = torch_pmg.pmg_vcycle_reference(tspec, D=tcase.D, g=tcase.g,
                                        grid=grid, mask=tcase.mask, c=tcase.c)
    got = cg(tcase.ax_full, torch.as_tensor(f), tol=1e-10, max_iter=30,
             dot=tcase.dot(), precond=tM)
    assert int(got.iters) == int(ref.iters)
    _assert_parity(ref, got)


# ---------------------------------------------------------------------------
# the reduced-precision policies (n=6, grid 2x2x4: the ladder 6 -> 3 -> 2)
# ---------------------------------------------------------------------------

def _policy_cases(precision):
    kw = dict(n=6, grid=(2, 2, 4), precision=precision,
              ax_impl="pallas_fused_cg_v2")
    return (JaxCase(dtype=jnp.float64, **kw),
            TorchCase(dtype=torch.float64, device="cpu", **kw))


@pytest.mark.parametrize("precision,rtol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_reduced_precision_pmg_spec_matches_reference(x64, precision, rtol):
    """The pmg set-up of an f32 or bf16 case (bf16 raised before: numpy has
    no bfloat16): the same ladder, and per-level intervals whose fine level
    comes from a Lanczos run in storage (f32 1e-5, bf16 1e-2; measured 2e-6
    and 2.2e-3) and whose coarser levels are the f64 level operators'."""
    jcase, tcase = _policy_cases(precision)
    want = jcase.precond_spec("pmg")
    got = tcase.precond_spec("pmg")
    assert got.ns == want.ns == (6, 3, 2)
    np.testing.assert_allclose(np.asarray(got.intervals),
                               np.asarray(want.intervals), rtol=rtol)


@pytest.mark.parametrize("precision,entries,rtol", [("f32", 11, 1e-4),
                                                    ("bf16", 4, 2e-2)])
def test_reduced_precision_pmg_pcg_matches_reference(x64, precision, entries,
                                                     rtol):
    """pmg-PCG in f32 and bf16 storage through ``case.solve`` (12
    iterations), each side on its own set-up: the history over its
    pre-asymptotic entries.  f32: 1e-4 over entries 0..10 (measured 4.6e-5;
    entry 11 is at f32's floor, 1e-13 of entry 0); bf16: 2e-2 over entries
    0..3 (measured 5.8e-3; pmg reaches bf16's floor by entry 4)."""
    jcase, tcase = _policy_cases(precision)
    _, jf = jcase.manufactured()
    tf = torch.as_tensor(np.asarray(jf, np.float64)).to(tcase.dtype)
    ref = jcase.solve(jf, niter=12, precond="pmg")
    got = tcase.solve(tf, niter=12, precond="pmg")
    assert got.x.dtype == tcase.dtype and got.precond == "pmg"
    h_ref = np.asarray(ref.rnorm_history, np.float64)[:entries]
    h = got.history.double().numpy()[:entries]
    rel = np.abs(h - h_ref) / h_ref
    assert rel.max() <= rtol, rel
