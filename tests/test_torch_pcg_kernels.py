"""Port parity: the PCG kernels K10 (Jacobi update) and K11 (Chebyshev
apply), through their natural-shape entries in ``kernels/ops.py``, against
the JAX package in fp64 on the CPU.

The JAX side runs its Pallas kernels in interpret mode; the port runs the
plain versions its wrappers take for CPU tensors.  Only the summation
order differs between the two, so every output is held to 1e-12 relative.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import gs as jax_gs
from repro.core import precond as jax_precond
from repro.core.nekbone import NekboneCase as JaxCase
from repro.kernels import nekbone_ax as jax_kernels
from repro.kernels import ops as jax_ops
from repro_torch.core import precond as torch_precond
from repro_torch.core.gs import ds_sum_local
from repro_torch.core.nekbone import NekboneCase as TorchCase
from repro_torch.kernels import _build
from repro_torch.kernels import nekbone_ax as torch_kernels
from repro_torch.kernels import ops as torch_ops

RTOL = 1e-12


def _continuous(rng, case):
    """A continuous, masked field (the CG invariant), as numpy."""
    u = rng.normal(size=case.mask.shape)
    return np.array(jax_gs.ds_sum_local(jnp.asarray(u), case.grid)
                    * case.mask)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-300))


@pytest.mark.parametrize("n,grid,sz", [(4, (2, 2, 4), 1), (4, (2, 2, 4), 2),
                                       (10, (2, 1, 2), 1),
                                       (10, (2, 1, 2), 2)])
def test_pcg_update_matches_reference(x64, n, grid, sz):
    """One Jacobi-PCG back half after the v2 front half (z in its residual
    slot), at two slab splits of the reference: x, z, rtz and rcr."""
    rng = np.random.default_rng(11)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    E = jcase.mesh.nelt
    shape = (E, n, n, n)
    p_prev = _continuous(rng, jcase)
    z = _continuous(rng, jcase)
    x = rng.normal(size=shape)
    invd = np.array(1.0 / jcase.operator_diagonal())
    beta, alpha = 0.43, 0.77

    # JAX: slab kernel (in-block sums + boundary planes), then the update
    (mx, my, mz), _ = jax_ops.slab_axis_factors(grid, n, jnp.float64)
    g3 = jax_ops.diag_metric(jcase.g, E, n)
    jp, jw, bot, top, _ = jax_kernels.nekbone_ax_slab_pallas(
        jnp.asarray(p_prev.reshape(E, -1)), jnp.asarray(z.reshape(E, -1)),
        jcase.D, jcase.D.T, g3, mx, my, mz, jnp.full((1, 1), beta), n=n,
        grid=grid, sz=sz, interpret=True)
    zero = jnp.zeros((1, bot.shape[1]), jnp.float64)
    jx, jz, jrtz, jrcr = jax_ops.nekbone_pcg_update(
        jnp.asarray(x), jp.reshape(shape), jnp.asarray(z), jw.reshape(shape),
        alpha, jnp.asarray(invd), grid,
        addb=jnp.concatenate([zero, top[:-1]], axis=0),
        addt=jnp.concatenate([bot[1:], zero], axis=0), sz=sz,
        interpret=True)

    # port: K4 (plain) writes the unassembled w; K10 assembles it
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    (tmx, tmy, tmz), _ = torch_ops.slab_axis_factors(grid, n, torch.float64,
                                                     "cpu")
    tp, tw, _ = torch_kernels.nekbone_ax_slab_cuda(
        torch.as_tensor(p_prev.reshape(E, -1)),
        torch.as_tensor(z.reshape(E, -1)), tcase.D,
        torch_ops.diag_metric(tcase.g, E, n), tmx, tmy, tmz,
        torch.tensor(beta, dtype=torch.float64), n=n)
    tx, tz, trtz, trcr = torch_ops.nekbone_pcg_update(
        torch.as_tensor(x), tp.reshape(shape), torch.as_tensor(z),
        tw.reshape(shape), alpha, torch.as_tensor(invd), grid)

    assert _rel(tx, jx) <= RTOL
    assert _rel(tz, jz) <= RTOL
    assert abs(float(trtz) - float(jrtz)) <= RTOL * abs(float(jrtz))
    assert abs(float(trcr) - float(jrcr)) <= RTOL * abs(float(jrcr))


def test_pcg_update_assembles_and_reconstructs_exactly(x64):
    """With invd = 1, x = p = 0, z = 0 and alpha = -1 the stored z is the
    assembled w bitwise, and rtz = rcr = sum(z c z)."""
    n, grid = 5, (3, 2, 2)
    E = 12
    rng = np.random.default_rng(2)
    w = rng.normal(size=(E, n, n, n))
    want = np.asarray(jax_gs.ds_sum_local(jnp.asarray(w), grid))
    zero = torch.zeros(E, n, n, n, dtype=torch.float64)
    one = torch.ones_like(zero)
    _, z, rtz, rcr = torch_ops.nekbone_pcg_update(
        zero, zero, zero, torch.as_tensor(w), -1.0, one, grid)
    np.testing.assert_array_equal(z.numpy(), want)
    assert float(rtz) == float(rcr)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_cheb_precond_matches_reference(x64, k):
    """z = q_k(A) r and r·c·z against the reference's halo'd kernel at a
    slab split below EZ (sz=2 of 4), so its ghost slabs are exercised."""
    n, grid = 4, (2, 2, 4)
    rng = np.random.default_rng(20 + k)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    r = _continuous(rng, jcase)
    coef = jax_precond.cheb_scalars(k, 0.06, 4.3)
    jz, jrtz = jax_ops.nekbone_cheb_precond(
        jnp.asarray(r), jcase.D, jcase.g, jnp.asarray(coef), grid, k=k, sz=2,
        layout="fold", grid_order="parallel", interpret=True)
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    tz, trtz = torch_ops.nekbone_cheb_precond(
        torch.as_tensor(r), tcase.D, tcase.g, torch.as_tensor(coef), grid,
        k=k)
    assert _rel(tz, jz) <= RTOL
    assert abs(float(trtz) - float(jrtz)) <= RTOL * abs(float(jrtz))


def test_cheb_apply_is_the_plain_preconditioner(x64):
    """K11's plain version is chebyshev_preconditioner over the assembled
    masked operator (the reference route's M), to round-off."""
    n, grid, k = 5, (2, 3, 2), 3
    case = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(4)
    u = torch.as_tensor(rng.normal(size=tuple(case.mask.shape)))
    r = ds_sum_local(u, grid) * case.mask
    M = torch_precond.chebyshev_preconditioner(case.ax_full, k, 0.05, 3.5)
    z, _ = torch_ops.nekbone_cheb_precond(
        r, case.D, case.g, torch_precond.cheb_scalars(k, 0.05, 3.5), grid,
        k=k)
    assert _rel(z, M(r)) <= RTOL


def test_cpu_pcg_wrappers_count_nothing():
    n, grid = 3, (1, 2, 2)
    case = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    f = torch.ones(4, n, n, n, dtype=torch.float64)
    _build.reset_launches()
    torch_ops.nekbone_pcg_update(f, f, f, f, 0.5, f, grid)
    torch_ops.nekbone_cheb_precond(f, case.D, case.g,
                                   torch_precond.cheb_scalars(2, 0.1, 2.0),
                                   grid, k=2)
    assert sum(_build.LAUNCHES.values()) == 0
    assert {"nekbone_pcg_update", "nekbone_cheb_apply"} <= set(
        _build.LAUNCHES)


def test_wrappers_refuse_a_device_they_do_not_launch_on():
    """A tensor off the CPU goes to the kernel or raises: no fallback."""
    n, E = 3, 2
    t = torch.empty(E, n ** 3, dtype=torch.float64, device="meta")
    f = torch.empty(1, n, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        torch_kernels.nekbone_pcg_update_cuda(
            t, t, t, t, torch.empty(1, device="meta"), t, f, f,
            torch.empty(2, n, dtype=torch.float64, device="meta"), n=n)
    with pytest.raises(ValueError, match="CUDA device"):
        torch_kernels.nekbone_cheb_apply_cuda(
            t, torch.empty(n, n, device="meta"), t, f, f, f, f, f, f,
            torch.empty(3, 2, device="meta"), n=n, k=2)
