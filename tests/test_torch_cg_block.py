"""Port parity: multi-RHS block CG (``core/cg_block.py``, the ``block`` and
``block_loop`` routes, K6's and K7's plain versions) against the port's own
single-RHS v2 solves (bitwise) and the JAX package (fp64, CPU).

The JAX side runs its block kernels in interpret mode; the port runs the
plain versions its kernel wrappers take for CPU tensors.  Inputs come from
numpy seeds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.cg_block as jax_block
import repro.core.cost as jax_cost
from repro.core.nekbone import NekboneCase as JaxCase
from repro_torch.core import cg_block as torch_block
from repro_torch.core import cost as torch_cost
from repro_torch.core.cg_fused import cg_fused_v2_fixed_iters
from repro_torch.core.gs import ds_sum_local
from repro_torch.core.nekbone import NekboneCase as TorchCase
from repro_torch.kernels import nekbone_ax as K
from repro_torch.kernels import ops

# PR 11's bar for solve histories and solutions against the reference.
RTOL = 1e-10
N, GRID = 5, (2, 2, 4)


def _cases(n=N, grid=GRID, ax_impl="pallas_fused_cg_v2"):
    return (JaxCase(n=n, grid=grid, dtype=jnp.float64, ax_impl=ax_impl),
            TorchCase(n=n, grid=grid, dtype=torch.float64, ax_impl=ax_impl,
                      device="cpu"))


def _torch_case(n=N, grid=GRID):
    return TorchCase(n=n, grid=grid, dtype=torch.float64,
                     ax_impl="pallas_fused_cg_v2", device="cpu")


def _batch(case, b, seed):
    """The port case's manufactured rhs and b-1 random assembled, masked
    ones, as a (b, E, n, n, n) numpy array fed to both packages."""
    rng = np.random.default_rng(seed)
    _, f0 = case.manufactured()
    lanes = [f0]
    for _ in range(b - 1):
        u = torch.as_tensor(rng.normal(size=tuple(f0.shape)))
        lanes.append(ds_sum_local(u, case.grid) * case.mask)
    return torch.stack(lanes).numpy()


def _kw(case):
    return dict(D=case.D, g=case.g, grid=case.grid, mask=case.mask, c=case.c)


def _assert_parity(ref, got, rtol=RTOL):
    h_ref = np.asarray(ref.history)
    h = got.history.numpy()
    assert h.shape == h_ref.shape
    np.testing.assert_allclose(h, h_ref, rtol=0,
                               atol=rtol * np.nanmax(h_ref[..., 0]))
    xs = np.abs(np.asarray(ref.x)).max()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                               atol=rtol * xs)


# ---------------------------------------------------------------------------
# bitwise against the port's own single-RHS v2
# ---------------------------------------------------------------------------

def test_b1_bitwise_parity_with_v2():
    case = _torch_case()
    _, f = case.manufactured()
    niter = 12
    ref = cg_fused_v2_fixed_iters(f, niter=niter, **_kw(case))
    res = torch_block.cg_block_fixed_iters(f, niter=niter, **_kw(case))
    assert res.pipeline == "fused_v2_rhs1"
    assert res.x.shape == (1,) + tuple(f.shape)
    assert res.history.shape == (1, niter + 1)
    assert torch.equal(res.x[0], ref.x)
    assert torch.equal(res.history[0], ref.history)
    assert int(res.iters) == niter


@pytest.mark.parametrize("b", [2, 3])
def test_lanes_match_independent_v2_solves(b):
    case = _torch_case()
    B = torch.as_tensor(_batch(case, b, seed=b))
    niter = 10
    res = torch_block.cg_block_fixed_iters(B, niter=niter, **_kw(case))
    assert res.x.shape == B.shape and res.history.shape == (b, niter + 1)
    assert res.rnorm.shape == (b,) and res.achieved_rtol.shape == (b,)
    for j in range(b):
        solo = cg_fused_v2_fixed_iters(B[j], niter=niter, **_kw(case))
        assert torch.equal(res.x[j], solo.x)
        assert torch.equal(res.history[j], solo.history)


@pytest.mark.parametrize("b", [1, 3])
def test_block_plain_kernels_are_the_single_rhs_ones_per_lane(b):
    """K6's and K7's plain versions lane by lane: bitwise K4's and K5's."""
    case = _torch_case()
    E, n = case.mesh.nelt, case.n
    rng = np.random.default_rng(b)
    P = torch.as_tensor(rng.normal(size=(b, E, n ** 3)))
    R = torch.as_tensor(rng.normal(size=(b, E, n ** 3)))
    X = torch.as_tensor(rng.normal(size=(b, E, n ** 3)))
    beta = torch.as_tensor(rng.normal(size=b))
    alpha = torch.as_tensor(rng.normal(size=b))
    (m, c) = ops.slab_axis_factors(case.grid, n, torch.float64, "cpu")
    g3 = ops.diag_metric(case.g, E, n)
    p3, w3, pap = K.nekbone_ax_slab_block_cuda(P, R, case.D, g3, *m, beta,
                                               n=n)
    x3, r3, rcr = K.nekbone_cg_update_block_cuda(X, p3, R, w3, alpha, *c,
                                                 n=n)
    assert pap.shape == rcr.shape == (b, E)
    for j in range(b):
        p, w, pp = K.nekbone_ax_slab_cuda(P[j], R[j], case.D, g3, *m,
                                          beta[j], n=n)
        x, r, rr = K.nekbone_cg_update_cuda(X[j], p, R[j], w, alpha[j], *c,
                                            n=n)
        for got, want in ((p3[j], p), (w3[j], w), (pap[j], pp), (x3[j], x),
                          (r3[j], r), (rcr[j], rr)):
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [2, 3])
def test_block_fixed_matches_reference(x64, b):
    jcase, tcase = _cases()
    B = _batch(tcase, b, seed=10 + b)
    niter = 10
    ref = jax_block.cg_block_fixed_iters(jnp.asarray(B), niter=niter,
                                         interpret=True, **_kw(jcase))
    got = torch_block.cg_block_fixed_iters(torch.as_tensor(B), niter=niter,
                                           **_kw(tcase))
    assert got.pipeline == ref.pipeline == f"fused_v2_rhs{b}"
    _assert_parity(ref, got)


def test_tol_driver_converges_every_lane(x64):
    """Every lane ends at or below tol; the joint count is the reference's,
    and each lane's history is bitwise a prefix of its fixed-iteration
    one, NaN after."""
    jcase, tcase = _cases()
    B = _batch(tcase, 3, seed=4)
    tol, max_iter = 2.0, 60          # the random lanes pass it near 16
    got = torch_block.cg_block_tol(torch.as_tensor(B), tol=tol,
                                   max_iter=max_iter, **_kw(tcase))
    it = int(got.iters)
    h = got.history.numpy()
    assert 0 < it < max_iter and h.shape == (3, max_iter + 1)
    assert (got.rnorm.numpy() <= tol).all()
    assert np.isnan(h[:, it + 1:]).all()
    fixed = torch_block.cg_block_fixed_iters(torch.as_tensor(B), niter=it,
                                             **_kw(tcase))
    np.testing.assert_array_equal(h[:, :it + 1], fixed.history.numpy())
    ref = jax_block.cg_block_tol(jnp.asarray(B), tol=tol, max_iter=max_iter,
                                 interpret=True, **_kw(jcase))
    assert int(ref.iters) == it
    for j in range(3):
        np.testing.assert_allclose(h[j, :it + 1],
                                   np.asarray(ref.history)[j, :it + 1],
                                   rtol=0, atol=RTOL * h[j, 0])


@pytest.mark.parametrize("shape", [(4, 4, 4), (1, 2, 1, 4, 4, 4, 4)])
def test_rejects_bad_rank(shape):
    case = TorchCase(n=4, grid=(1, 1, 1), dtype=torch.float64,
                     ax_impl="pallas_fused_cg_v2", device="cpu")
    with pytest.raises(ValueError, match="cg_block expects"):
        torch_block.cg_block_fixed_iters(torch.zeros(shape), niter=2,
                                         **_kw(case))


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_multi_rhs_books_match_reference(b):
    assert torch_cost.multi_rhs_streams(b) == jax_cost.multi_rhs_streams(b)
    assert torch_cost.MULTI_RHS_SHARED_STREAMS == \
        jax_cost.MULTI_RHS_SHARED_STREAMS
    for s in (1, 2, 4):
        assert torch_cost.multi_rhs_streams(b, "sstep_v3", s=s) == \
            jax_cost.multi_rhs_streams(b, "sstep_v3", s=s)
    with pytest.raises(ValueError):
        torch_cost.multi_rhs_streams(b, "eq2")


# ---------------------------------------------------------------------------
# through NekboneCase.solve and repro_torch.solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precond,niter,tol,route", [
    (None, 8, None, "block"), (None, None, 0.5, "block"),
    ("cheb2", 8, None, "block_loop"), ("pmg", 6, None, "block_loop"),
    ("pmg", None, 1e-8, "block_loop")])
def test_case_batched_solve_routes(x64, precond, niter, tol, route):
    """``NekboneCase.solve(F, b=2)`` on the v2 case through ``block`` and
    ``block_loop`` (each case runs its own Lanczos set-up), against the
    reference case's own batched solve at 1e-10.  The tolerances keep the
    runs short: over tens of unpreconditioned iterations two valid fp64
    evaluation orders drift apart by far more than round-off."""
    from repro_torch.core.solvers import route_name

    jcase, tcase = _cases()
    B = _batch(tcase, 2, seed=21)
    kw = dict(b=2, niter=niter, tol=tol, max_iter=60, precond=precond)
    ref = jcase.solve(jnp.asarray(B), **kw)
    got = tcase.solve(torch.as_tensor(B), **kw)
    assert route_name(tcase, b=2, niter=niter, pc_name=precond) == route
    assert got.x.shape == B.shape and got.history.shape[0] == 2
    assert got.pipeline == ref.pipeline and got.precond == ref.precond
    np.testing.assert_array_equal(np.asarray(got.iters),
                                  np.asarray(ref.iters))
    _assert_parity(ref, got)


def test_facade_replicates_the_manufactured_rhs():
    import repro_torch
    from repro_torch.configs.nekbone import NekboneConfig

    cfg = NekboneConfig("tiny", n=4, grid=(2, 1, 2), dtype="float64",
                        ax_impl="pallas_fused_cg_v2")
    res = repro_torch.solve(cfg, b=3, niter=5, device="cpu")
    assert res.pipeline == "fused_v2_rhs3" and res.history.shape == (3, 6)
    one = repro_torch.solve(cfg, niter=5, device="cpu")
    for j in range(3):
        assert torch.equal(res.history[j], one.history)
    with pytest.raises(ValueError, match="needs a"):
        cfg.make_case(device="cpu").solve(one.x, b=2, niter=2)
