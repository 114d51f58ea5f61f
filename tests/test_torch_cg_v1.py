"""Port parity: the v1 fused CG iteration — K3 and K2's plain versions and
the ``v1`` route — against the JAX package in fp64 on the CPU.

The JAX side runs its Pallas kernels in interpret mode; the port runs the
plain versions its wrappers take for CPU tensors.  The bars are the
reference suite's: the operator output to 1e-13, the summed partials to
1e-12, residual histories to 1e-12.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.cost as jax_cost
from repro.core import gs as jax_gs
from repro.core.cg_fused import cg_fused_fixed_iters as jax_cg_fused
from repro.core.nekbone import NekboneCase as JaxCase
from repro.kernels import nekbone_ax as jax_kernels
from repro.kernels import ops as jax_ops
from repro_torch.convert import FIELDS, case_from_arrays
from repro_torch.core import cost as torch_cost
from repro_torch.core.cg_fused import cg_fused_fixed_iters
from repro_torch.core.geom import random_spd_metric
from repro_torch.core.nekbone import NekboneCase as TorchCase
from repro_torch.kernels import nekbone_ax as torch_kernels
from repro_torch.kernels import ops as torch_ops


def _operands(rng, n, E):
    """p, r (random), a random SPD metric, a random 0/1 mask and a weight."""
    shape = (E, n, n, n)
    p = rng.normal(size=shape)
    r = rng.normal(size=shape)
    g = random_spd_metric(rng, E, n)
    mask = (rng.random(shape) > 0.2).astype(np.float64)
    c = mask * rng.choice([1.0, 0.5, 0.25], size=shape)
    from repro_torch.core.sem import derivative_matrix

    return p, r, derivative_matrix(n), g, mask, c


def _t(a):
    return torch.as_tensor(np.array(a))


def _assert_field(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("n,E,block_e", [(4, 6, 2), (10, 2, 1)])
def test_ax_pap_plain_matches_reference(x64, n, E, block_e):
    """K3's plain version against ``nekbone_ax_pap_pallas``: w to 1e-13 and
    the summed pap partials to 1e-12 (random SPD metric and mask)."""
    rng = np.random.default_rng(21)
    p, _, D, g, mask, _ = _operands(rng, n, E)
    n3 = n ** 3
    jw, jpap = jax_kernels.nekbone_ax_pap_pallas(
        jnp.asarray(p.reshape(E, n3)), jnp.asarray(D), jnp.asarray(D.T),
        jnp.asarray(g.reshape(E, 6, n3)), jnp.asarray(mask.reshape(E, n3)),
        n=n, block_e=block_e, interpret=True)
    tw, tpap = torch_kernels.nekbone_ax_pap_cuda(
        _t(p.reshape(E, n3)), _t(D), _t(g.reshape(E, 6, n3)),
        _t(mask.reshape(E, n3)), n=n)
    assert tw.shape == (E, n3) and tpap.shape == (E,)
    _assert_field(tw, jw, 1e-13)
    np.testing.assert_allclose(float(tpap.sum()), float(jnp.sum(jpap)),
                               rtol=1e-12)


@pytest.mark.parametrize("n,E,block_e", [(4, 6, 3), (10, 2, 2)])
def test_ax_dots_matches_reference(x64, n, E, block_e):
    """``ops.nekbone_ax_dots`` (K2's plain version) against the reference's:
    w to 1e-13, pap and rcz to 1e-12; ``ops.nekbone_ax_pap`` (K3) gives
    K2's w and pap bitwise."""
    rng = np.random.default_rng(22)
    p, r, D, g, mask, c = _operands(rng, n, E)
    jw, jpap, jrcz = jax_ops.nekbone_ax_dots(
        jnp.asarray(p), jnp.asarray(D), jnp.asarray(g), jnp.asarray(mask),
        jnp.asarray(r), jnp.asarray(c), block_e=block_e, interpret=True)
    tw, tpap, trcz = torch_ops.nekbone_ax_dots(_t(p), _t(D), _t(g), _t(mask),
                                               _t(r), _t(c))
    assert tw.shape == (E, n, n, n)
    _assert_field(tw, jw, 1e-13)
    np.testing.assert_allclose(float(tpap), float(jpap), rtol=1e-12)
    np.testing.assert_allclose(float(trcz), float(jrcz), rtol=1e-12)
    w3, pap3 = torch_ops.nekbone_ax_pap(_t(p), _t(D), _t(g), _t(mask))
    assert torch.equal(w3, tw) and torch.equal(pap3, tpap)


def test_ax_dots_pap_identity(x64):
    """For a continuous p, the pre-assembly partial is p·c·(mask gs w)."""
    rng = np.random.default_rng(23)
    case = TorchCase(n=5, grid=(2, 2, 2), dtype=torch.float64, device="cpu")
    jcase = JaxCase(n=5, grid=(2, 2, 2), dtype=jnp.float64)
    u = rng.normal(size=tuple(case.mask.shape))
    p = np.asarray(jax_gs.ds_sum_local(jnp.asarray(u), jcase.grid)
                   * jcase.mask)
    w, pap, rcz = torch_ops.nekbone_ax_dots(_t(p), case.D, case.g, case.mask,
                                            _t(p), case.c)
    from repro_torch.core.gs import ds_sum_local

    wa = ds_sum_local(w, case.grid)
    want = torch.sum(_t(p) * case.c * wa)
    np.testing.assert_allclose(float(pap), float(want), rtol=1e-12)
    np.testing.assert_allclose(float(rcz),
                               float(torch.sum(_t(p) * case.c * _t(p))),
                               rtol=1e-12)


@pytest.mark.parametrize("n,grid,niter", [(4, (2, 2, 3), 12),
                                          (5, (3, 1, 2), 10)])
def test_v1_route_matches_reference(x64, n, grid, niter):
    """``case.solve`` on ``pallas_fused_cg`` (route ``v1``, K3) against the
    reference's ``cg_fused_fixed_iters``: history to 1e-12, x to 1e-12."""
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64,
                    ax_impl="pallas_fused_cg")
    _, jf = jcase.manufactured()
    ref = jax_cg_fused(jf, D=jcase.D, g=jcase.g, mask=jcase.mask, c=jcase.c,
                       grid=grid, niter=niter, interpret=True)
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64,
                      ax_impl="pallas_fused_cg", device="cpu")
    res = tcase.solve(_t(jf), niter=niter)
    assert res.pipeline == "fused_v1"
    h_ref = np.asarray(ref.rnorm_history)
    assert res.history.shape == h_ref.shape
    np.testing.assert_allclose(res.history.numpy(), h_ref, rtol=1e-12,
                               atol=1e-13 * h_ref[0])
    _assert_field(res.x, ref.x, 1e-12)
    assert int(res.iters) == niter


def test_v1_general_fields_match_reference(x64):
    """v1 takes any metric, mask and weight: a random SPD metric carried
    into both packages gives the same history."""
    rng = np.random.default_rng(24)
    n, grid = 4, (2, 1, 2)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    E = jcase.mesh.nelt
    _, jf = jcase.manufactured()
    arrays = {name: np.asarray(getattr(jcase, name)) for name in FIELDS}
    arrays["g"] = random_spd_metric(rng, E, n)
    ref = jax_cg_fused(jf, D=jcase.D, g=jnp.asarray(arrays["g"]),
                       mask=jcase.mask, c=jcase.c, grid=grid, niter=8,
                       interpret=True)
    tcase = case_from_arrays(n, grid, (1.0, 1.0, 1.0), arrays,
                             dtype=torch.float64, device="cpu",
                             ax_impl="pallas_fused_cg")
    got = cg_fused_fixed_iters(_t(jf), D=tcase.D, g=tcase.g, mask=tcase.mask,
                               c=tcase.c, grid=grid, niter=8)
    h_ref = np.asarray(ref.rnorm_history)
    np.testing.assert_allclose(got.history.numpy(), h_ref, rtol=1e-12,
                               atol=1e-13 * h_ref[0])


def test_v1_matches_the_plain_route(x64):
    """v1 and the plain reference CG loop on the port agree to 1e-12."""
    case = TorchCase(n=4, grid=(2, 2, 2), dtype=torch.float64,
                     ax_impl="pallas_fused_cg", device="cpu")
    plain = TorchCase(n=4, grid=(2, 2, 2), dtype=torch.float64,
                      ax_impl="fused", device="cpu")
    _, f = case.manufactured()
    h = case.solve(f, niter=15).history.numpy()
    h_plain = plain.solve(f, niter=15).history.numpy()
    np.testing.assert_allclose(h, h_plain, rtol=1e-12, atol=1e-13 * h[0])


def test_v1_refined_precision_raises(x64):
    """A refined policy passed straight to the v1 solve no longer raises:
    it runs as its storage policy, as the reference's does — bitwise the
    port's own f32 run, and within 1e-4 of the reference's f32_ir run over
    entries 0..8 (the f32 envelope of tests/test_torch_ir.py)."""
    jcase = JaxCase(n=4, grid=(2, 2, 2), dtype=jnp.float64)
    case = TorchCase(n=4, grid=(2, 2, 2), dtype=torch.float64, device="cpu")
    f = np.array(jcase.manufactured()[1])
    kw = dict(D=case.D, g=case.g, mask=case.mask, c=case.c, grid=case.grid,
              niter=8)
    got = cg_fused_fixed_iters(torch.as_tensor(f), precision="f32_ir", **kw)
    plain = cg_fused_fixed_iters(torch.as_tensor(f), precision="f32", **kw)
    assert got.x.dtype == torch.float32
    assert torch.equal(got.history, plain.history)
    assert torch.equal(got.x, plain.x)
    ref = jax_cg_fused(jnp.asarray(f), D=jcase.D, g=jcase.g, mask=jcase.mask,
                       c=jcase.c, grid=jcase.grid, niter=8,
                       precision="f32_ir")
    h_ref = np.asarray(ref.rnorm_history, np.float64)
    h = got.history.double().numpy()
    assert np.abs(h - h_ref).max() <= 1e-4 * h_ref.min()


def test_v1_books_match_reference():
    for ndof in (1000, 1024 * 1000):
        for itemsize in (8, 4):
            assert torch_cost.fused_cg_iter_bytes(ndof, itemsize) == \
                jax_cost.fused_cg_iter_bytes(ndof, itemsize)
    for n in (4, 10):
        assert torch_cost.fused_intensity(n) == jax_cost.fused_intensity(n)
    assert (torch_cost.FUSED_CG_READ_STREAMS,
            torch_cost.FUSED_CG_WRITE_STREAMS) == (
                jax_cost.FUSED_CG_READ_STREAMS,
                jax_cost.FUSED_CG_WRITE_STREAMS) == (13, 4)


def test_v1_wrappers_raise_off_the_cpu_without_a_card():
    """A tensor off the CPU goes to the kernel or raises: no fallback."""
    n, E = 3, 2
    t = torch.empty(E, n ** 3, dtype=torch.float64, device="meta")
    g = torch.empty(E, 6, n ** 3, dtype=torch.float64, device="meta")
    D = torch.empty(n, n, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        torch_kernels.nekbone_ax_pap_cuda(t, D, g, t, n=n)
    with pytest.raises(ValueError, match="CUDA device"):
        torch_kernels.nekbone_ax_dots_cuda(t, D, g, t, t, t, n=n)
