"""Port parity: gather-scatter and the local operator (K1's plain version).

The same numpy inputs go through the JAX function and its port, both on the
CPU in fp64.  ``ds_sum_local`` must be bitwise equal; the operator agrees to
1e-12 of the field's max (the contractions sum in a different order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ax as jax_ax
from repro.core import gs as jax_gs
from repro.core.geom import random_spd_metric
from repro.core.nekbone import NekboneCase as JaxCase
from repro.kernels import nekbone_ax as jax_kernels
from repro_torch.convert import case_from_arrays
from repro_torch.core import ax as torch_ax
from repro_torch.core import gs as torch_gs
from repro_torch.kernels import nekbone_ax as torch_kernels


@pytest.mark.parametrize("grid,n", [((2, 3, 4), 3), ((1, 1, 3), 4),
                                    ((3, 2, 1), 5), ((2, 2, 2), 10)])
def test_ds_sum_local_bitwise(x64, grid, n):
    E = grid[0] * grid[1] * grid[2]
    u = np.random.default_rng(1).normal(size=(E, n, n, n))
    want = np.asarray(jax_gs.ds_sum_local(jnp.asarray(u), grid))
    got = torch_gs.ds_sum_local(torch.as_tensor(u), grid)
    np.testing.assert_array_equal(got.numpy(), want)
    # the input is left as it was
    np.testing.assert_array_equal(
        torch.as_tensor(u).numpy(), u)


@pytest.mark.parametrize("n", [2, 3, 5, 10, 16])
def test_ax_local_matches_reference(x64, n):
    """listing1, fused and the plain K1 against the reference's fused XLA
    operator and its Pallas kernel in interpret mode, on a random SPD
    metric fed to both packages through ``convert.case_from_arrays``."""
    grid = (2, 1, 2) if n < 16 else (1, 1, 2)
    E = grid[0] * grid[1] * grid[2]
    rng = np.random.default_rng(n)
    g = random_spd_metric(rng, E, n)
    u = rng.normal(size=(E, n, n, n))
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    D = np.asarray(jcase.D)

    want = np.asarray(jax_ax.ax_local_fused(jnp.asarray(u), jnp.asarray(D),
                                            jnp.asarray(g)))
    want_kernel = np.asarray(jax_kernels.nekbone_ax_pallas(
        jnp.asarray(u.reshape(E, n ** 3)), jnp.asarray(D),
        jnp.asarray(D.T), jnp.asarray(g.reshape(E, 6, n ** 3)), n=n,
        block_e=E, interpret=True)).reshape(u.shape)
    scale = np.abs(want).max()

    tcase = case_from_arrays(n, grid, (1.0, 1.0, 1.0), {"D": D, "g": g},
                             dtype=torch.float64, device="cpu",
                             ax_impl="pallas")
    tu = torch.as_tensor(u)
    got = {
        "listing1": torch_ax.ax_local_listing1(tu, tcase.D, tcase.g),
        "fused": torch_ax.ax_local_fused(tu, tcase.D, tcase.g),
        "kernel_plain": tcase.ax_local(tu),
    }
    for name, w in got.items():
        for ref_name, ref in (("xla", want), ("pallas", want_kernel)):
            np.testing.assert_allclose(w.numpy(), ref, rtol=0,
                                       atol=1e-12 * scale,
                                       err_msg=f"{name} vs {ref_name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_wrapper_runs_plain_and_counts_nothing(dtype):
    n, E = 4, 3
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.normal(size=(E, n ** 3)), dtype=dtype)
    g = torch.as_tensor(rng.normal(size=(E, 6, n ** 3)), dtype=dtype)
    D = torch.as_tensor(rng.normal(size=(n, n)), dtype=dtype)
    torch_kernels.reset_launches()
    w = torch_kernels.nekbone_ax_cuda(u, D, g, n=n)
    assert torch.equal(w, torch_kernels.nekbone_ax_plain(u, D, g, n=n))
    assert w.dtype == dtype
    assert torch_kernels.LAUNCHES == {name: 0 for name in
                                      torch_kernels.LAUNCHES}
