"""Port: routing, entry points, the device rule and ``convert``."""
import itertools
import types
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro_torch
from repro.core import solvers as jax_solvers
from repro.core.nekbone import NekboneCase as JaxCase
from repro_torch.configs.nekbone import PAPER_CASES, NekboneConfig, paper_case
from repro_torch.convert import FIELDS, case_from_arrays
from repro_torch.core import solvers as torch_solvers
from repro_torch.core.nekbone import NekboneCase

IMPLS = ("listing1", "fused", "pallas", "pallas_fused_cg",
         "pallas_fused_cg_v2", "pallas_sstep_v3")
PRECISIONS = (None, "f64", "f32", "f32_ir", "bf16_ir")


def test_route_name_agrees_with_reference():
    table = itertools.product(IMPLS, PRECISIONS, (1, 3), (None, 7),
                              (None, "jacobi"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for impl, prec, b, niter, pc in table:
            case = types.SimpleNamespace(ax_impl=impl, precision=prec)
            want = jax_solvers.route_name(case, b=b, niter=niter, pc_name=pc)
            got = torch_solvers.route_name(case, b=b, niter=niter, pc_name=pc)
            assert got == want, (impl, prec, b, niter, pc)
            assert got in torch_solvers.REGISTRY or \
                got in torch_solvers.NOT_PORTED


@pytest.mark.parametrize("kw,solve_kw", [
    (dict(ax_impl="pallas_fused_cg"), dict(niter=3)),             # v1
    (dict(ax_impl="pallas_sstep_v3"), dict(niter=3)),             # sstep
    (dict(ax_impl="pallas_fused_cg_v2"), dict(tol=1e-6)),         # v2_tol
    (dict(ax_impl="pallas_fused_cg_v2", precision="f32_ir"),
     dict(niter=3)),                                              # ir
    (dict(ax_impl="pallas_fused_cg_v2"), dict(niter=3, b=2)),     # block
    (dict(ax_impl="fused"), dict(niter=3, b=2)),                  # block_loop
    (dict(ax_impl="pallas"), dict(niter=3, precond="jacobi")),    # precond
])
def test_unported_routes_raise(kw, solve_kw):
    case = NekboneCase(n=3, grid=(1, 1, 2), dtype=torch.float64,
                       device="cpu", **kw)
    _, f = case.manufactured()
    b = solve_kw.pop("b", None)
    if b:
        f = torch.stack([f] * b)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        case.solve(f, b=b, **solve_kw)


def test_auto_impl_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NekboneCase(n=3, grid=(1, 1, 1), ax_impl="auto", device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NekboneCase(n=3, grid=(1, 1, 1))
    with pytest.raises(RuntimeError):
        repro_torch.solve(NekboneConfig("tiny", n=3, grid=(1, 1, 2)),
                          niter=2)
    assert NekboneCase(n=3, grid=(1, 1, 1), device="cpu").D.device.type \
        == "cpu"


def test_solve_facade_and_tolerance_mode():
    cfg = NekboneConfig("tiny", n=4, grid=(2, 1, 2), dtype="float64",
                        ax_impl="pallas_fused_cg_v2")
    res = repro_torch.solve(cfg, niter=6, device="cpu")
    assert res.pipeline == "fused_v2" and res.history.shape == (7,)
    case = cfg.make_case(device="cpu", ax_impl="fused")
    ref = case.solve(case.manufactured()[1], niter=6)
    h_ref = ref.history.numpy()
    np.testing.assert_allclose(res.history.numpy(), h_ref, rtol=1e-12,
                               atol=1e-13 * h_ref[0])
    # tolerance-driven reference CG stops where the residual meets tol and
    # keeps its history as a prefix of the fixed-iteration one
    tres = case.solve(case.manufactured()[1], tol=1e-3, max_iter=40)
    k = int(tres.iters)
    h = tres.history.numpy()
    assert 0 < k < 40 and h[k] <= 1e-3 < h[k - 1]
    assert np.isnan(h[k + 1:]).all()
    fixed = case.solve(case.manufactured()[1], niter=k).history.numpy()
    np.testing.assert_allclose(h[:k + 1], fixed, rtol=1e-12)


def test_paper_cases_mirror_reference():
    from repro.configs import nekbone as jax_configs

    assert set(PAPER_CASES) == set(jax_configs.PAPER_CASES)
    for key, cfg in PAPER_CASES.items():
        ref = jax_configs.PAPER_CASES[key]
        assert (cfg.name, cfg.n, cfg.grid, cfg.niter, cfg.dtype,
                cfg.ax_impl) == (ref.name, ref.n, ref.grid, ref.niter,
                                 ref.dtype, ref.ax_impl)
    assert paper_case(1024, precision="f64").precision == "f64"


def test_convert_round_trips_reference_case(x64):
    jcase = JaxCase(n=5, grid=(2, 1, 3), lengths=(1.0, 2.0, 1.0),
                    dtype=jnp.float64)
    arrays = {name: np.asarray(getattr(jcase, name)) for name in FIELDS}
    tcase = case_from_arrays(5, (2, 1, 3), (1.0, 2.0, 1.0), arrays,
                             dtype=torch.float64, device="cpu")
    own = NekboneCase(n=5, grid=(2, 1, 3), lengths=(1.0, 2.0, 1.0),
                      dtype=torch.float64, device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tcase, name).numpy(),
                                      arrays[name], err_msg=name)
        # the port builds the same fields itself
        np.testing.assert_array_equal(getattr(own, name).numpy(),
                                      arrays[name], err_msg=name)
    with pytest.raises(ValueError):
        case_from_arrays(5, (2, 1, 3), (1.0, 1.0, 1.0),
                         {"g": arrays["g"][:1]}, dtype=torch.float64,
                         device="cpu")
