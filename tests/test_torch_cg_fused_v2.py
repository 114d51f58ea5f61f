"""Port parity: the v2 CG iteration (K4 + K5 plain versions) and both routes
of the slice, against the JAX package in fp64 on the CPU.

The JAX side runs its Pallas kernels in interpret mode; the port runs the
plain versions its wrappers take for CPU tensors.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import gs as jax_gs
from repro.core.nekbone import NekboneCase as JaxCase
from repro.kernels import nekbone_ax as jax_kernels
from repro.kernels import ops as jax_ops
from repro_torch.core import cg_fused as torch_cg_fused
from repro_torch.core.gs import ds_sum_local
from repro_torch.core.nekbone import NekboneCase as TorchCase
from repro_torch.kernels import nekbone_ax as torch_kernels
from repro_torch.kernels import ops as torch_ops


def _continuous(rng, case):
    """A continuous, masked field (the CG invariant), as numpy."""
    u = rng.normal(size=case.mask.shape)
    return np.asarray(jax_gs.ds_sum_local(jnp.asarray(u), case.grid)
                      * case.mask)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / (np.abs(np.asarray(b)).max() + 1e-300))


@pytest.mark.parametrize("n,grid,sz", [(4, (2, 2, 4), 2), (10, (2, 2, 2), 1)])
def test_v2_iteration_matches_reference(x64, n, grid, sz):
    """One iteration, composed as ``_v2_iter`` does on both sides: each
    kernel's outputs (p, w, pap; x, r, rcr) to 1e-12."""
    rng = np.random.default_rng(3)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    E = jcase.mesh.nelt
    n3 = n ** 3
    p_prev = _continuous(rng, jcase).reshape(E, n3)
    r = _continuous(rng, jcase).reshape(E, n3)
    x = rng.normal(size=(E, n3))
    beta, rtz = 0.61, 2.3

    # JAX: slab kernel, plane shift, update kernel (interpret mode)
    (mx, my, mz), (cx, cy, cz) = jax_ops.slab_axis_factors(grid, n,
                                                           jnp.float64)
    D = jcase.D
    g3 = jax_ops.diag_metric(jcase.g, E, n)
    jp, jw, bot, top, jpap_b = jax_kernels.nekbone_ax_slab_pallas(
        jnp.asarray(p_prev), jnp.asarray(r), D, D.T, g3, mx, my, mz,
        jnp.full((1, 1), beta), n=n, grid=grid, sz=sz, interpret=True)
    jpap = float(jnp.sum(jpap_b))
    zero = jnp.zeros((1, bot.shape[1]), jnp.float64)
    addb = jnp.concatenate([zero, top[:-1]], axis=0)
    addt = jnp.concatenate([bot[1:], zero], axis=0)
    jalpha = rtz / jpap
    jx, jr, jrcr_b = jax_kernels.nekbone_cg_update_pallas(
        jnp.asarray(x), jp, jnp.asarray(r), jw, addb, addt,
        jnp.full((1, 1), jalpha), cx, cy, cz, n=n, grid=grid, sz=sz,
        interpret=True)
    # the fully assembled w of the reference: its in-block sums plus planes
    ex, ey, ez = grid
    nblk = ez // sz
    vb = np.asarray(jw).reshape(nblk, sz, ey, ex, n, n, n).copy()
    vb[:, 0, :, :, 0] += np.asarray(addb).reshape(nblk, ey, ex, n, n)
    vb[:, -1, :, :, -1] += np.asarray(addt).reshape(nblk, ey, ex, n, n)
    jw_full = vb.reshape(E, n3)

    # port: K4 then K5, plain versions on the CPU
    (tmx, tmy, tmz), (tcx, tcy, tcz) = torch_ops.slab_axis_factors(
        grid, n, torch.float64, "cpu")
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    tg3 = torch_ops.diag_metric(tcase.g, E, n)
    tp, tw, tpap_e = torch_kernels.nekbone_ax_slab_cuda(
        torch.as_tensor(p_prev), torch.as_tensor(r), tcase.D, tg3, tmx, tmy,
        tmz, torch.tensor(beta, dtype=torch.float64), n=n)
    tpap = float(torch.sum(tpap_e))
    talpha = torch.tensor(rtz, dtype=torch.float64) / torch.sum(tpap_e)
    tx, tr, trcr_e = torch_kernels.nekbone_cg_update_cuda(
        torch.as_tensor(x), tp, torch.as_tensor(r), tw, talpha, tcx, tcy,
        tcz, n=n)

    assert _rel(tp, jp) <= 1e-12
    tw_full = ds_sum_local(tw.reshape(E, n, n, n), grid).reshape(E, n3)
    assert _rel(tw_full, jw_full) <= 1e-12
    assert abs(tpap - jpap) <= 1e-12 * abs(jpap)
    assert _rel(tx, jx) <= 1e-12
    assert _rel(tr, jr) <= 1e-12
    jrcr = float(jnp.sum(jrcr_b))
    assert abs(float(torch.sum(trcr_e)) - jrcr) <= 1e-12 * abs(jrcr)

    # the port's _v2_iter is this same composition
    out = torch_cg_fused._v2_iter(
        torch.as_tensor(x), torch.as_tensor(r), torch.as_tensor(p_prev),
        torch.tensor(rtz, dtype=torch.float64),
        torch.tensor(beta, dtype=torch.float64), D=tcase.D, g3=tg3, mx=tmx,
        my=tmy, mz=tmz, cx=tcx, cy=tcy, cz=tcz, n=n)
    for got, want in zip(out[:3], (tx, tr, tp)):
        assert torch.equal(got, want)
    assert abs(float(out[3]) - jrcr) <= 1e-12 * abs(jrcr)


@pytest.mark.parametrize("grid,n", [((2, 3, 4), 3), ((3, 1, 2), 5),
                                    ((2, 2, 2), 10)])
def test_update_assembles_w_bitwise(x64, grid, n):
    """K5 assembles w in ds_sum_local's tree: with r = 0 and alpha = -1 its
    stored r is exactly the assembled w, bitwise the reference's."""
    E = grid[0] * grid[1] * grid[2]
    rng = np.random.default_rng(5)
    w = rng.normal(size=(E, n, n, n))
    want = np.asarray(jax_gs.ds_sum_local(jnp.asarray(w), grid))
    (_, (cx, cy, cz)) = torch_ops.slab_axis_factors(grid, n, torch.float64,
                                                    "cpu")
    zero = torch.zeros(E, n ** 3, dtype=torch.float64)
    _, r, _ = torch_kernels.nekbone_cg_update_cuda(
        zero, zero, zero, torch.as_tensor(w.reshape(E, n ** 3)),
        torch.tensor(-1.0, dtype=torch.float64), cx, cy, cz, n=n)
    np.testing.assert_array_equal(r.numpy().reshape(w.shape), want)


def test_cpu_v2_wrappers_count_nothing():
    n, grid = 3, (1, 2, 2)
    case = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    E = case.mesh.nelt
    (mx, my, mz), (cx, cy, cz) = torch_ops.slab_axis_factors(
        grid, n, torch.float64, "cpu")
    g3 = torch_ops.diag_metric(case.g, E, n)
    f = torch.ones(E, n ** 3, dtype=torch.float64)
    one = torch.tensor(1.0, dtype=torch.float64)
    torch_kernels.reset_launches()
    p, w, _ = torch_kernels.nekbone_ax_slab_cuda(f, f, case.D, g3, mx, my,
                                                 mz, one, n=n)
    torch_kernels.nekbone_cg_update_cuda(f, p, f, w, one, cx, cy, cz, n=n)
    assert sum(torch_kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("ax_impl", ["pallas", "pallas_fused_cg_v2"])
@pytest.mark.parametrize("n,grid,niter", [(4, (2, 2, 2), 10),
                                          (10, (2, 2, 4), 5)])
def test_slice_solve_matches_reference(x64, ax_impl, n, grid, niter):
    """The whole slice through ``NekboneCase.solve``, same ax_impl on both
    sides: history to rtol 1e-12 (atol 1e-13 h[0]) and x to 1e-12 max|x|."""
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64, ax_impl=ax_impl)
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64, ax_impl=ax_impl,
                      device="cpu")
    _, jf = jcase.manufactured()
    _, tf = tcase.manufactured()
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))

    jres = jcase.solve(jf, niter=niter)
    tres = tcase.solve(tf, niter=niter)
    h_ref = np.asarray(jres.rnorm_history)
    h = tres.rnorm_history.numpy()
    assert h.shape == h_ref.shape == (niter + 1,)
    np.testing.assert_allclose(h, h_ref, rtol=1e-12, atol=1e-13 * h_ref[0])
    xs = np.abs(np.asarray(jres.x)).max()
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-12 * xs)
    x, hist = tres                      # the legacy two-tuple unpack
    assert x is tres.x and hist is tres.history
    assert int(tres.iters) == niter


def test_v2_rejects_a_mask_it_would_not_rebuild():
    case = TorchCase(n=3, grid=(2, 1, 2), dtype=torch.float64, device="cpu")
    _, f = case.manufactured()
    mask = case.mask.clone()
    mask[0, 1, 1, 1] = 0.0
    with pytest.raises(ValueError, match="structured box mask"):
        torch_cg_fused.cg_fused_v2_fixed_iters(
            f, D=case.D, g=case.g, grid=case.grid, niter=2, mask=mask,
            c=case.c)
