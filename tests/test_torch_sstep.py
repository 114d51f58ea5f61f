"""Port parity: s-step CG — K8 and K9's plain versions, the numpy
recurrence, the basis scale theta and the ``sstep`` route — against the JAX
package in fp64 on the CPU.

The JAX side runs its Pallas kernels in interpret mode; the port runs the
plain versions its wrappers take for CPU tensors.  The bars are the
reference suite's (tests/test_cg_sstep.py): basis 1e-12, Gram 1e-11, the
update 1e-13, histories 1e-9 with an absolute floor of 1e-11·h0.  Both
packages run one theta, carried across with ``convert``.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.cost as jax_cost
from repro.core import cg_sstep as jax_sstep
from repro.core import gs as jax_gs
from repro.core.nekbone import NekboneCase as JaxCase
from repro.kernels import nekbone_ax as jax_kernels
from repro.kernels import ops as jax_ops
from repro_torch.convert import sstep_theta_from_reference
from repro_torch.core import cg_sstep as torch_sstep
from repro_torch.core import cost as torch_cost
from repro_torch.core import solvers as torch_solvers
from repro_torch.core.nekbone import NekboneCase as TorchCase
from repro_torch.kernels import nekbone_ax as torch_kernels
from repro_torch.kernels import ops as torch_ops

HIST_RTOL = 1e-9
HIST_ATOL = 1e-11          # times history[0]


def _t(a):
    return torch.as_tensor(np.array(a))


def _continuous(rng, jcase):
    u = rng.normal(size=jcase.mask.shape)
    return np.array(jax_gs.ds_sum_local(jnp.asarray(u), jcase.grid)
                    * jcase.mask)


def _assert_hist(got, want):
    want = np.asarray(want)
    assert np.asarray(got).shape == want.shape
    np.testing.assert_allclose(np.asarray(got), want, rtol=HIST_RTOL,
                               atol=HIST_ATOL * want[0])


# ---------------------------------------------------------------------------
# K8 and K9: the plain versions against the reference's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("n,grid,sz", [(4, (2, 2, 3), 3), (3, (1, 3, 2), 1)])
def test_powers_matches_reference(x64, n, grid, sz, s):
    """``ops.nekbone_ax_powers`` (K8's plain version over the whole box)
    against the reference's halo-windowed kernel: basis to 1e-12, the
    summed Gram to 1e-11."""
    rng = np.random.default_rng(31)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    p, r = _continuous(rng, jcase), _continuous(rng, jcase)
    theta = 2.25
    jb, jg = jax_ops.nekbone_ax_powers(
        jnp.asarray(p), jnp.asarray(r), jcase.D, jcase.g, grid, s=s,
        theta=theta, sz=sz, interpret=True)
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    tb, tg = torch_ops.nekbone_ax_powers(_t(p), _t(r), tcase.D, tcase.g,
                                         grid, s=s, theta=theta)
    assert tb.shape == (jcase.mesh.nelt, 2 * s - 1, n, n, n)
    assert tg.shape == (2 * s + 1, 2 * s + 1)
    jb = np.asarray(jb)
    for m in range(2 * s - 1):
        scale = np.abs(jb[:, m]).max() + 1e-300
        np.testing.assert_allclose(tb[:, m].numpy(), jb[:, m], rtol=1e-12,
                                   atol=1e-12 * scale, err_msg=f"basis {m}")
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-11,
                               atol=1e-12 * np.abs(jg).max())


@pytest.mark.parametrize("s", [1, 2, 4])
def test_powers_gram_partials_sum_per_element(x64, s):
    """K8's per-element Gram partials are symmetric, and sum to
    ``V^T C V`` over the stored basis."""
    rng = np.random.default_rng(32)
    n, grid = 4, (2, 1, 2)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    E, n3 = jcase.mesh.nelt, n ** 3
    p, r = _continuous(rng, jcase), _continuous(rng, jcase)
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    (mx, my, mz), (cx, cy, cz) = torch_ops.slab_axis_factors(
        grid, n, torch.float64, "cpu")
    basis, gram = torch_kernels.nekbone_ax_powers_cuda(
        _t(p).reshape(E, n3), _t(r).reshape(E, n3), tcase.D,
        torch_ops.diag_metric(tcase.g, E, n), mx, my, mz, cx, cy, cz,
        torch.tensor([0.5], dtype=torch.float64), n=n, s=s)
    assert gram.shape == (E, 2 * s + 1, 2 * s + 1)
    assert torch.equal(gram, gram.transpose(1, 2))
    V = torch.stack([_t(p).reshape(E, n3)] + [basis[:, m] for m in range(s)]
                    + [_t(r).reshape(E, n3)]
                    + [basis[:, s + m] for m in range(s - 1)])
    c = tcase.c.reshape(E, n3)
    want = torch.einsum("ael,bel->ab", V * c, V)
    np.testing.assert_allclose(gram.sum(0).numpy(), want.numpy(),
                               rtol=1e-12, atol=1e-13 * float(want.abs().max()))


@pytest.mark.parametrize("grid,n,sz,s", [((2, 3, 4), 4, 2, 2),
                                         ((1, 2, 3), 5, 1, 4),
                                         ((2, 2, 2), 3, 2, 1)])
def test_sstep_update_matches_reference(x64, grid, n, sz, s):
    """K9's plain version against ``nekbone_sstep_update_pallas``: x, r, p
    to 1e-13, the summed rcr partials to 1e-12."""
    rng = np.random.default_rng(33)
    E = grid[0] * grid[1] * grid[2]
    n3 = n ** 3
    x, p, r = (rng.normal(size=(E, n3)) for _ in range(3))
    basis = rng.normal(size=(E, 2 * s - 1, n3))
    coef = rng.normal(size=(3, 2 * s + 1))
    _, (jcx, jcy, jcz) = jax_ops.slab_axis_factors(grid, n, jnp.float64)
    jx, jr, jp, jrcr = jax_kernels.nekbone_sstep_update_pallas(
        jnp.asarray(x), jnp.asarray(p), jnp.asarray(r), jnp.asarray(basis),
        jnp.asarray(coef), jcx, jcy, jcz, n=n, grid=grid, sz=sz, s=s,
        interpret=True)
    _, (cx, cy, cz) = torch_ops.slab_axis_factors(grid, n, torch.float64,
                                                  "cpu")
    tx, tr, tp, trcr = torch_kernels.nekbone_sstep_update_cuda(
        _t(x), _t(p), _t(r), _t(basis), _t(coef), cx, cy, cz, n=n, s=s)
    for name, got, want in (("x", tx, jx), ("r", tr, jr), ("p", tp, jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                                   atol=1e-13, err_msg=name)
    np.testing.assert_allclose(float(trcr.sum()), float(jnp.sum(jrcr)),
                               rtol=1e-12)
    # the natural-shape entry returns the same, with rcr summed
    ox, o_r, op, orcr = torch_ops.nekbone_sstep_update(
        _t(x).reshape(E, n, n, n), _t(p).reshape(E, n, n, n),
        _t(r).reshape(E, n, n, n), _t(basis).reshape(E, 2 * s - 1, n, n, n),
        coef, grid, s=s)
    assert torch.equal(ox.reshape(E, n3), tx) and torch.equal(
        o_r.reshape(E, n3), tr) and torch.equal(op.reshape(E, n3), tp)
    assert float(orcr) == float(trcr.sum())


# ---------------------------------------------------------------------------
# The host recurrence and theta
# ---------------------------------------------------------------------------

def _spd_gram(rng, s):
    K = 2 * s + 1
    A = rng.normal(size=(K, K))
    return A @ A.T + K * np.eye(K)


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_recurrence_bitwise_reference(s):
    """``sstep_recurrence`` and ``cycle_coefficients`` are the reference's
    numpy code: bitwise the same on random SPD Grams, with and without an
    in-cycle stop."""
    rng = np.random.default_rng(40 + s)
    for _ in range(3):
        G = _spd_gram(rng, s)
        theta = float(rng.uniform(0.5, 3.0))
        for m in range(s + 1):
            got = torch_sstep.sstep_recurrence(G, s, m, theta)
            want = jax_sstep.sstep_recurrence(G, s, m, theta)
            for a, b in zip(got[:3], want[:3]):
                assert np.array_equal(a, b)
            assert got[3] == want[3]
        rtzs = jax_sstep.sstep_recurrence(G, s, s, theta)[3]
        for tol2 in (None, rtzs[0] * 1.01, rtzs[-1] * 1.01, 0.0):
            got = torch_sstep.cycle_coefficients(G, s, s, theta, tol2)
            want = jax_sstep.cycle_coefficients(G, s, s, theta, tol2)
            assert got[2] == want[2] and got[1] == want[1]
            if want[0] is None:
                assert got[0] is None
            else:
                assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("n,grid", [(4, (2, 2, 3)), (6, (1, 2, 2))])
def test_estimate_theta_matches_reference(x64, n, grid):
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    want = jax_sstep.estimate_theta(jcase.D, jcase.g, grid, jcase.mask)
    got = torch_sstep.estimate_theta(tcase.D, tcase.g, grid, tcase.mask)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_estimate_theta_degenerate_is_one():
    tcase = TorchCase(n=3, grid=(1, 1, 1), dtype=torch.float64,
                      device="cpu")
    assert torch_sstep.estimate_theta(tcase.D, tcase.g, (1, 1, 1),
                                      torch.zeros_like(tcase.mask)) == 1.0


# ---------------------------------------------------------------------------
# The sstep route against the reference's cg_sstep_fixed_iters
# ---------------------------------------------------------------------------

def _cases(n, grid, s):
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64,
                    ax_impl="pallas_sstep_v3", s=s)
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64,
                      ax_impl="pallas_sstep_v3", s=s, device="cpu")
    _, jf = jcase.manufactured()
    theta = jax_sstep.estimate_theta(jcase.D, jcase.g, grid, jcase.mask)
    jcase._sstep_theta = theta
    sstep_theta_from_reference(jcase, tcase)
    return jcase, tcase, jf, theta


@pytest.mark.parametrize("n,grid,s,niter", [(4, (2, 2, 2), 1, 8),
                                            (4, (2, 2, 2), 2, 8),
                                            (5, (2, 3, 2), 4, 8),
                                            (5, (2, 3, 2), 4, 10)])
def test_sstep_route_matches_reference(x64, n, grid, s, niter):
    """``case.solve`` on ``pallas_sstep_v3`` (route ``sstep``, K8 + K9)
    against the reference's ``cg_sstep_fixed_iters`` on one theta; niter=10
    at s=4 ends with a remainder cycle of 2."""
    jcase, tcase, jf, theta = _cases(n, grid, s)
    ref = jax_sstep.cg_sstep_fixed_iters(
        jf, D=jcase.D, g=jcase.g, grid=grid, niter=niter, s=s,
        theta=theta, interpret=True)
    res = tcase.solve(_t(jf), niter=niter)
    assert res.pipeline == "sstep_v3" and int(res.iters) == niter
    _assert_hist(res.history.numpy(), ref.rnorm_history)
    xs = float(np.abs(np.asarray(ref.x)).max())
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x),
                               atol=1e-10 * xs)


@pytest.mark.parametrize("s", [2, 4])
def test_sstep_tol_mode_matches_reference(x64, s):
    """``tol=``: the stop lands on the reference's iteration, the history
    matches the reference's to its bar and, but for the last entry (the
    stored residual after the shortened cycle), is bitwise a prefix of the
    port's own fixed run."""
    n, grid = 4, (2, 2, 2)
    jcase, tcase, jf, theta = _cases(n, grid, s)
    fixed = tcase.solve(_t(jf), niter=12).history.numpy()
    tol = float(fixed[5]) * 0.999
    first = int(np.nonzero(fixed <= tol)[0][0])
    ref = jax_sstep.cg_sstep_fixed_iters(
        jf, D=jcase.D, g=jcase.g, grid=grid, niter=40, s=s, theta=theta,
        tol=tol, interpret=True)
    res = tcase.solve(_t(jf), tol=tol, max_iter=40)
    k = int(res.iters)
    assert k == int(ref.iters) == first
    h = res.history.numpy()
    _assert_hist(h, ref.rnorm_history)
    assert np.array_equal(h[:k], fixed[:k]) and h[k] <= tol < h[k - 1]


def test_sstep_s1_matches_port_v2(x64):
    """s=1 is the v2 iteration's algebra: the two port routes agree to
    1e-10."""
    case = TorchCase(n=4, grid=(2, 2, 4), dtype=torch.float64,
                     ax_impl="pallas_sstep_v3", s=1, device="cpu")
    v2 = TorchCase(n=4, grid=(2, 2, 4), dtype=torch.float64,
                   ax_impl="pallas_fused_cg_v2", device="cpu")
    _, f = case.manufactured()
    h1 = case.solve(f, niter=8).history.numpy()
    h2 = v2.solve(f, niter=8).history.numpy()
    np.testing.assert_allclose(h1, h2, rtol=1e-10, atol=1e-12 * h2[0])


def test_sstep_batch_warns_and_routes_to_block(monkeypatch):
    """b > 1 on ``pallas_sstep_v3``: no batched s-step kernel; the request
    goes to the v2 block route, with a one-time warning."""
    monkeypatch.setattr(torch_solvers, "_SSTEP_BLOCK_WARNED", False)
    case = TorchCase(n=3, grid=(1, 1, 2), dtype=torch.float64,
                     ax_impl="pallas_sstep_v3", device="cpu")
    _, f = case.manufactured()
    F = torch.stack([f, 2 * f])
    with pytest.warns(UserWarning, match="no batched s-step kernel"):
        res = case.solve(F, niter=3)
    assert res.pipeline == "fused_v2_rhs2" and res.history.shape == (2, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        case.solve(F, niter=3)               # once per process


def test_sstep_rejects_bad_inputs():
    case = TorchCase(n=3, grid=(1, 1, 2), dtype=torch.float64,
                     device="cpu")
    _, f = case.manufactured()
    kw = dict(D=case.D, g=case.g, grid=case.grid, niter=2)
    with pytest.raises(ValueError, match="s >= 1"):
        torch_sstep.cg_sstep_fixed_iters(f, s=0, **kw)
    bad = case.mask.clone()
    bad[0, 1, 1, 1] = 0.0
    with pytest.raises(ValueError, match="structured box mask"):
        torch_sstep.cg_sstep_fixed_iters(f, s=2, mask=bad, **kw)
    with pytest.raises(ValueError, match="no s-step theta"):
        sstep_theta_from_reference(type("Ref", (), {"_sstep_theta": None}),
                                   case)


def test_sstep_books_match_reference():
    assert torch_cost.SSTEP_DEFAULT_S == jax_cost.SSTEP_DEFAULT_S == 4
    for s in range(1, 9):
        assert torch_cost.sstep_cycle_streams(s) == \
            jax_cost.sstep_cycle_streams(s)
        assert torch_cost.sstep_streams(s) == jax_cost.sstep_streams(s)
        for sz in (1, 2, 4):
            assert torch_cost.sstep_halo_streams(s, sz) == \
                jax_cost.sstep_halo_streams(s, sz)
        for n in (4, 10):
            assert torch_cost.sstep_intensity(n, s) == \
                jax_cost.sstep_intensity(n, s)
    assert torch_cost.sstep_streams(1) == (9.0, 4.0)


def test_sstep_wrappers_raise_off_the_cpu_without_a_card():
    """A tensor off the CPU goes to the kernel or raises: no fallback."""
    n, E, s = 3, 2, 2
    t = torch.empty(E, n ** 3, dtype=torch.float64, device="meta")
    f = torch.empty(1, n, dtype=torch.float64, device="meta")
    g = torch.empty(E, 3, n ** 3, dtype=torch.float64, device="meta")
    D = torch.empty(n, n, dtype=torch.float64, device="meta")
    one = torch.empty(1, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        torch_kernels.nekbone_ax_powers_cuda(t, t, D, g, f, f, f, f, f, f,
                                             one, n=n, s=s)
    basis = torch.empty(E, 2 * s - 1, n ** 3, dtype=torch.float64,
                        device="meta")
    coef = torch.empty(3, 2 * s + 1, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        torch_kernels.nekbone_sstep_update_cuda(t, t, t, basis, coef, f, f,
                                                f, n=n, s=s)
    with pytest.raises(ValueError, match="built range"):
        torch_kernels.nekbone_ax_powers_cuda(t, t, D, g, f, f, f, f, f, f,
                                             one, n=n, s=11)
