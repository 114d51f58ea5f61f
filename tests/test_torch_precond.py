"""Port parity: ``core/precond.py`` and the routes it serves, against the
JAX package in fp64 on the CPU.

Set-up pieces (operator diagonal, Chebyshev scalars, the Lanczos interval),
the fixed-iteration PCG drivers, the tolerance-driven drivers' prefix and
padding semantics, and the case / config / solve wiring.  The JAX side runs
its Pallas kernels in interpret mode; the port runs the plain versions its
kernel wrappers take for CPU tensors.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.cg as jax_cg
import repro_torch
from repro.core import precond as jax_pc
from repro.core.cg_fused import cg_fused_v2_fixed_iters as jax_v2_fixed
from repro.core.nekbone import NekboneCase as JaxCase
from repro_torch.configs.nekbone import NekboneConfig
from repro_torch.convert import precond_from_reference
from repro_torch.core import cg_fused as torch_cg_fused
from repro_torch.core import precond as torch_pc
from repro_torch.core.nekbone import NekboneCase as TorchCase

# The reference's own PCG parity budget (tests/test_precond.py): round-off
# through different partial-sum associations plus, for Jacobi, the
# z-carried reformulation's reciprocal reconstruction, eps-level per
# iteration over 10 iterations.
RTOL = 1e-10


def _cases(n, grid, ax_impl="fused"):
    return (JaxCase(n=n, grid=grid, dtype=jnp.float64, ax_impl=ax_impl),
            TorchCase(n=n, grid=grid, dtype=torch.float64, ax_impl=ax_impl,
                      device="cpu"))


def _random_rhs(jcase, seed):
    """A random assembled, masked right-hand side, as numpy."""
    from repro.core import gs as jax_gs

    rng = np.random.default_rng(seed)
    u = jnp.asarray(rng.normal(size=jcase.mask.shape))
    return np.array(jax_gs.ds_sum_local(u, jcase.grid) * jcase.mask)


def _assert_parity(ref, got, rtol=RTOL):
    h_ref = np.asarray(ref.rnorm_history)
    h = got.rnorm_history.numpy()
    assert h.shape == h_ref.shape
    np.testing.assert_allclose(h, h_ref, rtol=0, atol=rtol * h_ref[0])
    xs = np.abs(np.asarray(ref.x)).max() + 1e-300
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                               atol=rtol * xs)


# ---------------------------------------------------------------------------
# set-up pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,grid", [(3, (2, 2, 2)), (6, (3, 1, 2))])
def test_operator_diagonal_matches_reference(x64, n, grid):
    """Three D∘D contractions and an assembly: 1e-13 relative (summation
    order of the contractions only)."""
    jcase, tcase = _cases(n, grid)
    want = np.asarray(jcase.operator_diagonal())
    got = tcase.operator_diagonal().numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    # the structural spelling from the 3-component diagonal agrees too
    g3 = tcase.g[:, [0, 3, 5]]
    np.testing.assert_array_equal(
        torch_pc.operator_diagonal(tcase.D, g3, grid, tcase.mask).numpy(),
        got)


def test_cheb_scalars_bitwise():
    """Scalar float64 arithmetic in the same order: bitwise."""
    for k, lmin, lmax in ((1, 0.1, 2.0), (2, 0.03, 2.7), (4, 0.0227, 3.1),
                          (6, 1e-3, 40.0)):
        np.testing.assert_array_equal(torch_pc.cheb_scalars(k, lmin, lmax),
                                      jax_pc.cheb_scalars(k, lmin, lmax))
    with pytest.raises(ValueError, match="lmin < lmax"):
        torch_pc.cheb_scalars(2, 1.0, 0.5)
    with pytest.raises(ValueError, match="order"):
        torch_pc.cheb_scalars(0, 0.1, 1.0)


@pytest.mark.parametrize("n,grid", [(4, (2, 2, 3)), (5, (2, 3, 4))])
def test_estimate_interval_matches_reference(x64, n, grid):
    """16 Lanczos steps without reorthogonalisation amplify round-off, but
    the extreme Ritz values converge first: 1e-8 relative."""
    jcase, tcase = _cases(n, grid)
    want = jax_pc.estimate_interval(jcase.D, jcase.g, jcase.grid, jcase.mask,
                                    jcase.c)
    got = torch_pc.estimate_interval(tcase.D, tcase.g, tcase.grid,
                                     tcase.mask, tcase.c)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert 0.0 < got[0] < got[1]


def test_make_preconditioner_names():
    case = TorchCase(n=4, grid=(2, 2, 2), dtype=torch.float32, device="cpu")
    kw = dict(D=case.D, g=case.g, grid=case.grid, mask=case.mask, c=case.c)
    assert isinstance(torch_pc.make_preconditioner("jacobi", **kw),
                      torch_pc.JacobiPrecond)
    chb = torch_pc.make_preconditioner("cheb2", **kw)
    assert isinstance(chb, torch_pc.ChebyshevPrecond) and chb.k == 2
    assert torch_pc.make_preconditioner("chebyshev", interval=(0.1, 2.0),
                                        **kw).k == torch_pc.CHEB_DEFAULT_K
    with pytest.raises(ValueError, match="unknown preconditioner"):
        torch_pc.make_preconditioner("ilu", **kw)
    pmg = torch_pc.make_preconditioner("pmg[cheb2]", **kw)
    assert isinstance(pmg, torch_pc.PMGPrecond) and pmg.k == 2


# ---------------------------------------------------------------------------
# fixed-iteration PCG drivers (grids of the reference's Jacobi parity test)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,grid,seed", [(4, (2, 2, 2), 0), (5, (2, 3, 4), 1),
                                         (3, (1, 2, 4), 2)])
def test_pcg_jacobi_matches_reference(x64, n, grid, seed):
    jcase, tcase = _cases(n, grid)
    f = _random_rhs(jcase, seed)
    jspec = jax_pc.JacobiPrecond(invdiag=1.0 / jcase.operator_diagonal())
    ref = jax_pc.pcg_fused_v2_fixed_iters(
        jnp.asarray(f), D=jcase.D, g=jcase.g, grid=grid, niter=10,
        precond=jspec, mask=jcase.mask, c=jcase.c, interpret=True)
    got = torch_pc.pcg_fused_v2_fixed_iters(
        torch.as_tensor(f), D=tcase.D, g=tcase.g, grid=grid, niter=10,
        precond="jacobi", mask=tcase.mask, c=tcase.c)
    _assert_parity(ref, got)
    assert got.precond == "jacobi" and got.pipeline == "fused_v2"


@pytest.mark.parametrize("n,grid,seed", [(4, (2, 2, 2), 0),
                                         (5, (2, 3, 4), 1)])
def test_pcg_cheb_matches_reference(x64, n, grid, seed):
    """k=2 on the reference's own interval, carried across by convert."""
    jcase, tcase = _cases(n, grid)
    f = _random_rhs(jcase, seed)
    lmin, lmax = jax_pc.estimate_interval(jcase.D, jcase.g, grid, jcase.mask,
                                          jcase.c)
    jspec = jax_pc.ChebyshevPrecond(k=2, lmin=lmin, lmax=lmax)
    ref = jax_pc.pcg_fused_v2_fixed_iters(
        jnp.asarray(f), D=jcase.D, g=jcase.g, grid=grid, niter=10,
        precond=jspec, mask=jcase.mask, c=jcase.c, interpret=True)
    tspec = precond_from_reference(jspec, dtype=torch.float64, device="cpu")
    assert (tspec.k, tspec.lmin, tspec.lmax) == (2, lmin, lmax)
    got = torch_pc.pcg_fused_v2_fixed_iters(
        torch.as_tensor(f), D=tcase.D, g=tcase.g, grid=grid, niter=10,
        precond=tspec, mask=tcase.mask, c=tcase.c)
    _assert_parity(ref, got)


def test_convert_carries_the_jacobi_diagonal(x64):
    jcase, _ = _cases(3, (2, 1, 2))
    jspec = jax_pc.JacobiPrecond(invdiag=1.0 / jcase.operator_diagonal())
    tspec = precond_from_reference(jspec, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(tspec.invdiag.numpy(),
                                  np.asarray(jspec.invdiag))
    with pytest.raises(ValueError, match="carry"):
        precond_from_reference(object(), dtype=torch.float64, device="cpu")


# ---------------------------------------------------------------------------
# tolerance-driven drivers
# ---------------------------------------------------------------------------

def _spec_pair(precond, jcase, tcase):
    if precond is None:
        return None, None
    if precond == "jacobi":
        jspec = jax_pc.JacobiPrecond(invdiag=1.0 / jcase.operator_diagonal())
    else:
        jspec = jax_pc.ChebyshevPrecond(k=2, lmin=0.05, lmax=4.5)
    return jspec, precond_from_reference(jspec, dtype=torch.float64,
                                         device="cpu")


@pytest.mark.parametrize("precond", [None, "jacobi", "cheb"])
def test_cg_fused_tol_prefix_padding_and_iters(x64, precond):
    """A tolerance the fixed run crosses inside: the history is bitwise the
    port's own fixed run's prefix, NaN after ``iters``, and ``iters`` is
    the reference's on the same tolerance."""
    n, grid, niter = 4, (2, 2, 4), 15
    jcase, tcase = _cases(n, grid)
    _, jf = jcase.manufactured()
    _, tf = tcase.manufactured()
    jspec, tspec = _spec_pair(precond, jcase, tcase)
    kw = dict(D=tcase.D, g=tcase.g, grid=grid, mask=tcase.mask, c=tcase.c)
    if tspec is None:
        fixed = torch_cg_fused.cg_fused_v2_fixed_iters(tf, niter=niter, **kw)
    else:
        fixed = torch_pc.pcg_fused_v2_fixed_iters(tf, niter=niter,
                                                  precond=tspec, **kw)
    h_fix = fixed.history.numpy()
    # the rtz measure the loop stops on tracks the history's r.c.r within
    # the preconditioner's spectral scale, so this level lands mid-run.
    tol = float(h_fix[-4]) * (1.0 + 1e-12)
    res = torch_pc.cg_fused_tol(tf, tol=tol, max_iter=niter, precond=tspec,
                                **kw)
    it = int(res.iters)
    h = res.history.numpy()
    assert 0 < it < niter
    assert h.shape == (niter + 1,)
    np.testing.assert_array_equal(h[:it + 1], h_fix[:it + 1])
    assert np.isnan(h[it + 1:]).all()
    assert float(res.rnorm) == h[it]
    ref = jax_pc.cg_fused_tol(jf, D=jcase.D, g=jcase.g, grid=grid, tol=tol,
                              max_iter=niter, precond=jspec, mask=jcase.mask,
                              c=jcase.c, interpret=True)
    assert int(ref.iters) == it
    np.testing.assert_allclose(h[:it + 1],
                               np.asarray(ref.rnorm_history)[:it + 1],
                               rtol=0, atol=RTOL * h[0])


@pytest.mark.parametrize("precond", [None, "jacobi", "cheb"])
def test_cg_fused_tol_max_iter_cap(x64, precond):
    n, grid = 4, (2, 2, 2)
    jcase, tcase = _cases(n, grid)
    _, tspec = _spec_pair(precond, jcase, tcase)
    _, tf = tcase.manufactured()
    res = torch_pc.cg_fused_tol(tf, D=tcase.D, g=tcase.g, grid=grid, tol=0.0,
                                max_iter=7, precond=tspec)
    assert int(res.iters) == 7
    assert np.isfinite(res.history.numpy()).all()
    assert res.history.shape == (8,)


# ---------------------------------------------------------------------------
# case / config / solve wiring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precond", ["jacobi", "cheb"])
def test_config_precond_through_solve_facade(x64, precond):
    """NekboneConfig(precond=..., cheb_k=2) on the v2 pipeline, through
    ``repro_torch.solve``, against the reference case's own solve (each side
    runs its own Lanczos for the Chebyshev interval; the two agree to
    round-off, well inside the tolerance)."""
    from repro.configs.nekbone import NekboneConfig as JaxConfig

    kw = dict(name="t", n=4, grid=(2, 2, 4), dtype="float64",
              ax_impl="pallas_fused_cg_v2", precond=precond, cheb_k=2)
    jcase = JaxConfig(**kw).make_case()
    assert jcase.precond == precond
    ref, _ = jcase.solve_manufactured(niter=8)
    cfg = NekboneConfig(**kw)
    got = repro_torch.solve(cfg, niter=8, device="cpu")
    _assert_parity(ref, got)
    assert got.precond == precond
    case = cfg.make_case(device="cpu")
    assert case.precond == precond and case.cheb_k == 2
    if precond == "cheb":
        assert case.precond_spec().k == 2
        assert case.precond_spec() is case.precond_spec("cheb2")


def test_tolerance_solve_through_case_stops_at_tol(x64):
    """The README's example, small: a Chebyshev case solves to tol."""
    case = TorchCase(n=4, grid=(2, 2, 4), dtype=torch.float64,
                     ax_impl="pallas_fused_cg_v2", precond="cheb",
                     device="cpu")
    res, u_ex = case.solve_manufactured(tol=1e-8, max_iter=100)
    it = int(res.iters)
    assert 0 < it < 100 and float(res.rnorm) <= 1e-8
    assert res.history.shape == (101,) and np.isnan(
        res.history.numpy()[it + 1:]).all()
    # precond=None inherits the case's own; the plain solve needs a case
    # without one
    plain, _ = TorchCase(n=4, grid=(2, 2, 4), dtype=torch.float64,
                         ax_impl="pallas_fused_cg_v2", device="cpu"
                         ).solve_manufactured(tol=1e-8, max_iter=100)
    assert it < int(plain.iters)
    assert case.solve_manufactured(tol=1e-8, max_iter=100,
                                   precond=None)[0].precond == "cheb"


def test_precond_booleans_raise():
    case = TorchCase(n=3, grid=(2, 1, 2), dtype=torch.float64, device="cpu")
    for flag in (True, False):
        with pytest.raises(TypeError, match="removed"):
            case.solve_manufactured(niter=3, precond=flag)


@pytest.mark.parametrize("ax_impl", ["pallas_fused_cg_v2", "pallas"])
def test_pmg_solves_through_case(x64, ax_impl):
    """precond='pmg' on the fused route (the V-cycle over K11, K12, K4 and
    K5's plain versions) and on the reference route (the plain V-cycle in
    the reference CG loop), against the reference case's own solve on the
    same ladder (3 -> 2)."""
    jcase = JaxCase(n=3, grid=(1, 1, 2), dtype=jnp.float64, ax_impl=ax_impl)
    case = TorchCase(n=3, grid=(1, 1, 2), dtype=torch.float64,
                     ax_impl=ax_impl, device="cpu")
    res, u_ex = case.solve_manufactured(niter=3, precond="pmg")
    assert res.precond == ("pmg" if ax_impl == "pallas_fused_cg_v2"
                           else None)
    assert case.precond_spec("pmg").ns == (3, 2)
    h = res.history.numpy()
    assert h.shape == (4,) and np.isfinite(h).all() and h[-1] < h[0]
    ref, _ = jcase.solve_manufactured(niter=3, precond="pmg")
    _assert_parity(ref, res)


@pytest.mark.parametrize("niter", [8, None])
def test_reference_route_cheb_matches_reference(x64, niter):
    """``ax_impl='fused'`` with precond='cheb2': the plain Chebyshev M inside
    the reference CG loop, fixed and tolerance-driven.  Each case runs its
    own Lanczos; the intervals agree to round-off."""
    n, grid = 4, (2, 2, 3)
    jcase, tcase = _cases(n, grid)
    spec = jcase.precond_spec("cheb2")
    np.testing.assert_allclose(
        (tcase.precond_spec("cheb2").lmin, tcase.precond_spec("cheb2").lmax),
        (spec.lmin, spec.lmax), rtol=1e-8)
    _, jf = jcase.manufactured()
    _, tf = tcase.manufactured()
    kw = dict(niter=niter, tol=1e-7, max_iter=60, precond="cheb2")
    ref = jcase.solve(jf, **kw)
    got = tcase.solve(tf, **kw)
    assert int(got.iters) == int(ref.iters)
    _assert_parity(ref, got)
    if niter is None:
        want = jax_cg.cg(jcase.ax_full, jf, tol=1e-7, max_iter=60,
                         dot=jcase.dot(),
                         precond=jax_pc.chebyshev_preconditioner(
                             jcase.ax_full, 2, spec.lmin, spec.lmax))
        assert int(want.iters) == int(got.iters)


def test_fixed_v2_history_is_a_prefix_of_itself_via_cg_fused_tol(x64):
    """The unpreconditioned fixed driver and ``cg_fused_tol(tol=0)`` run one
    loop: the same history bitwise, at the reference's values."""
    jcase, tcase = _cases(4, (2, 2, 2))
    _, jf = jcase.manufactured()
    _, tf = tcase.manufactured()
    kw = dict(D=tcase.D, g=tcase.g, grid=tcase.grid)
    fixed = torch_cg_fused.cg_fused_v2_fixed_iters(tf, niter=9, **kw)
    capped = torch_pc.cg_fused_tol(tf, tol=0.0, max_iter=9, **kw)
    np.testing.assert_array_equal(capped.history.numpy(),
                                  fixed.history.numpy())
    ref = jax_v2_fixed(jf, D=jcase.D, g=jcase.g, grid=jcase.grid, niter=9,
                       interpret=True)
    _assert_parity(ref, fixed)


# ---------------------------------------------------------------------------
# the reduced-precision policies (n=6, grid 2x2x4, 12 iterations)
# ---------------------------------------------------------------------------

def _policy_cases(precision):
    kw = dict(n=6, grid=(2, 2, 4), precision=precision,
              ax_impl="pallas_fused_cg_v2")
    return (JaxCase(dtype=jnp.float64, **kw),
            TorchCase(dtype=torch.float64, device="cpu", **kw))


@pytest.mark.parametrize("precision,rtol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_reduced_precision_cheb_interval_matches_reference(x64, precision,
                                                           rtol):
    """The Chebyshev set-up of an f32 or bf16 case (bf16 raised before:
    numpy has no bfloat16).  The Lanczos vectors round to storage at every
    step, so the extreme Ritz values agree to f32's 1e-5 and bf16's 1e-2
    (measured: 2e-6 and 2.3e-3)."""
    jcase, tcase = _policy_cases(precision)
    want = jcase.precond_spec("cheb2")
    got = tcase.precond_spec("cheb2")
    assert got.k == 2
    np.testing.assert_allclose((got.lmin, got.lmax), (want.lmin, want.lmax),
                               rtol=rtol)


@pytest.mark.parametrize("precision,pc,entries,rtol", [
    ("f32", "jacobi", 11, 1e-4), ("f32", "cheb2", 11, 1e-4),
    ("bf16", "jacobi", 7, 2e-2), ("bf16", "cheb2", 7, 2e-2)])
def test_reduced_precision_pcg_matches_reference(x64, precision, pc, entries,
                                                 rtol):
    """Jacobi and Chebyshev(2) PCG in f32 and bf16 storage through
    ``case.solve``, each side on its own set-up: the history over its
    pre-asymptotic entries.  f32: 1e-4 over entries 0..10 (measured 1.6e-5);
    bf16: 2e-2 over entries 0..6 (measured 9.4e-3: f32 sums in another
    order flip bf16 steps of the stored vectors)."""
    jcase, tcase = _policy_cases(precision)
    _, jf = jcase.manufactured()
    tf = torch.as_tensor(np.asarray(jf, np.float64)).to(tcase.dtype)
    ref = jcase.solve(jf, niter=12, precond=pc)
    got = tcase.solve(tf, niter=12, precond=pc)
    assert got.x.dtype == tcase.dtype and got.precond == ref.precond
    h_ref = np.asarray(ref.rnorm_history, np.float64)[:entries]
    h = got.history.double().numpy()[:entries]
    rel = np.abs(h - h_ref) / h_ref
    assert rel.max() <= rtol, rel
