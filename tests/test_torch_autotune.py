"""Port: ``kernels/autotune.py`` — the pipeline pick behind
``ax_impl="auto"`` and its cache (the reference's
``tests/test_autotune.py`` cache and ``pick_pipeline`` cases, on the port).

The port's cache is its own file, ``$REPRO_CACHE_DIR/autotune_torch.json``,
only measured picks persist, and every key carries the device's name.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.nekbone import NekboneCase as JaxCase
from repro.kernels import autotune as jax_autotune
from repro_torch.core.nekbone import NekboneCase
from repro_torch.kernels import autotune

V1, V2 = "pallas_fused_cg", "pallas_fused_cg_v2"


@pytest.fixture(autouse=True)
def _fresh_cache(tmp_path, monkeypatch):
    # the disk layer in a per-test dir: no test touches ~/.cache
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def _forget_memory():
    """A fresh process: memory dropped, the file kept."""
    autotune._CACHE.clear()
    autotune._MEASURED.clear()
    autotune._DISK_LOADED = False


def _boom(pipeline):
    raise AssertionError("a cached pick must not re-measure")


def test_cache_file_is_the_ports_own(tmp_path):
    assert autotune.cache_path() == tmp_path / "autotune_torch.json"
    assert autotune.cache_path() != jax_autotune.cache_path()


def test_pick_is_cached_per_key_and_key_carries_device():
    calls = []

    def measure(p):
        calls.append(p)
        return 1.0 if p == V2 else 2.0

    got = autotune.pick_pipeline((2, 2, 2), 4, torch.float64, device="cpu",
                                 measure=measure)
    assert got == V2 and sorted(calls) == [V1, V2]
    # same key: served from the cache, the measure never runs again
    assert autotune.pick_pipeline((2, 2, 2), 4, torch.float64,
                                  device="cpu", measure=_boom) == V2
    assert ("pipeline", 4, 2, 2, 2, "float64", "float64", "cpu") in \
        autotune.cache_info()
    # the device name is part of the key: another card is another key
    autotune.pick_pipeline((2, 2, 2), 4, torch.float64, device="cpu",
                           precision="f32", measure=measure)
    assert len(autotune.cache_info()) == 2
    for key in autotune.cache_info():
        assert key[-1] == autotune.device_name("cpu") == "cpu"


def test_cache_stats_count_hits_and_misses():
    s0 = autotune.cache_stats()
    autotune.pick_pipeline((2, 2, 2), 4, device="cpu")
    autotune.pick_pipeline((2, 2, 2), 4, device="cpu")
    s1 = autotune.cache_stats()
    assert s1["misses"] - s0["misses"] == 1
    assert s1["hits"] - s0["hits"] == 1


def test_measured_pick_persists_and_reloads():
    got = autotune.pick_pipeline((4, 4, 8), 4, torch.float32, device="cpu",
                                 measure=lambda p: 1.0 if p == V1 else 2.0)
    assert got == V1
    assert autotune.cache_path().exists()
    data = json.loads(autotune.cache_path().read_text())
    assert [tuple(e["key"]) for e in data["entries"]] == [
        ("pipeline", 4, 4, 4, 8, "float32", "float32", "cpu")]
    _forget_memory()
    assert autotune.pick_pipeline((4, 4, 8), 4, torch.float32,
                                  device="cpu", measure=_boom) == V1
    # str values survive the JSON round trip as str
    assert isinstance(autotune.pick_pipeline(
        (4, 4, 8), 4, torch.float32, device="cpu"), str)


def test_heuristic_pick_is_never_written():
    autotune.pick_pipeline((2, 2, 2), 4, device="cpu")
    assert not autotune.cache_path().exists()
    # a heuristic pick memoized before a measured one stays off the disk
    autotune.pick_pipeline((4, 4, 4), 4, device="cpu",
                           measure=lambda p: float(p == V1))
    data = json.loads(autotune.cache_path().read_text())
    keys = {tuple(e["key"]) for e in data["entries"]}
    assert keys == {("pipeline", 4, 4, 4, 4, "float32", "float32", "cpu")}


@pytest.mark.parametrize("content", ["{ not json !!", "[1, 2]",
                                     '{"entries": [{"key": 1}]}',
                                     '{"entries": [{"key": ["x"], '
                                     '"value": "not-a-pipeline"}]}'])
def test_corrupt_cache_file_is_tolerated(content):
    path = autotune.cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(content)
    calls = []

    def measure(p):
        calls.append(p)
        return float(p == V1)

    assert autotune.pick_pipeline((2, 2, 4), 4, device="cpu",
                                  measure=measure) == V2
    assert calls                       # re-measured, no crash
    data = json.loads(path.read_text())
    assert [tuple(e["key"]) for e in data["entries"]] == [
        ("pipeline", 4, 2, 2, 4, "float32", "float32", "cpu")]


def test_clear_cache_removes_the_file():
    autotune.pick_pipeline((2, 2, 2), 4, device="cpu",
                           measure=lambda p: float(p == V1))
    assert autotune.cache_path().exists()
    autotune.clear_cache(disk=False)
    assert autotune.cache_path().exists() and not autotune.cache_info()
    autotune.clear_cache()
    assert not autotune.cache_path().exists()
    assert not autotune.cache_info()


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 2, 2), (4, 4, 4)])
def test_preconditioned_pick_is_always_v2(grid):
    before = dict(autotune.cache_info())
    assert autotune.pick_pipeline(grid, 4, device="cpu", precond="jacobi",
                                  measure=_boom) == V2
    assert autotune.cache_info() == before      # no measure, no entry


@pytest.mark.parametrize("winner", [V1, V2])
def test_injected_measure_winner_is_used(winner):
    assert autotune.pick_pipeline(
        (2, 2, 2), 3, torch.float64, device="cpu",
        measure=lambda p: 1.0 if p == winner else 5.0) == winner


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 2, 2), (4, 4, 4)])
def test_cpu_pick_without_a_measure_is_v2(grid):
    """Off the card, with no measure, the pick is v2 at every E (v2 was
    the faster at every E measured on the card) and is never written."""
    assert autotune.pick_pipeline(grid, 4, device="cpu") == V2
    assert not autotune.cache_path().exists()


@pytest.mark.parametrize("precision", [None, "f64", "f32", "bf16", "f32_ir",
                                       "bf16_ir"])
def test_card_measure_receives_the_precision_policy(monkeypatch, precision):
    """On the card the pick is timed with the case's own policy, and the
    cache key carries that policy."""
    seen = []

    def fake_measure(grid, n, dtype, device, policy=None):
        seen.append((tuple(grid), n, dtype, torch.device(device).type,
                     policy))
        return lambda p: 1.0 if p == V2 else 2.0

    monkeypatch.setattr(autotune, "_default_measure_pipeline", fake_measure)
    monkeypatch.setattr(autotune, "device_name", lambda d: "card")
    assert autotune.pick_pipeline((2, 2, 2), 4, torch.float32,
                                  precision=precision, device="cuda") == V2
    assert seen == [((2, 2, 2), 4, torch.float32, "cuda", precision)]
    assert list(autotune.cache_info()) == [
        ("pipeline", 4, 2, 2, 2, "float32",
         "float32" if precision is None else precision, "card")]


@pytest.mark.parametrize("precision", [None, "f32", "bf16", "f32_ir"])
def test_default_measure_solves_with_the_policy(monkeypatch, precision):
    """The measure's solves are the case's own: each pipeline solved with
    the policy the case will run (a refined one through its ``ir``
    route)."""
    from repro_torch.core import solvers

    seen = []
    solve_case = solvers.solve_case

    def spy(case, f, **kw):
        seen.append((case.ax_impl, case.precision,
                     solvers.route_name(case, niter=kw["niter"])))
        return solve_case(case, f, **kw)

    monkeypatch.setattr(solvers, "solve_case", spy)
    monkeypatch.setattr(autotune._timing, "measure",
                        lambda fn, *a, **kw: (fn(*a), 1.0)[1])
    m = autotune._default_measure_pipeline((1, 1, 2), 3, torch.float64,
                                           "cpu", precision)
    for p in (V1, V2):
        m(p)
    assert {s[0] for s in seen} == {V1, V2}
    assert all(s[1] == precision for s in seen)
    routes = {s[2] for s in seen}
    assert routes == ({"ir"} if precision == "f32_ir" else {"v1", "v2"})


def test_default_measure_times_one_iteration_without_setup(monkeypatch):
    """The card's measure: a (1 + MEASURE_ITERS)-iteration solve less a
    one-iteration solve, over MEASURE_ITERS (the solve's set-up out)."""
    m = autotune._default_measure_pipeline((1, 1, 2), 3, torch.float64,
                                           "cpu")
    for p in (V1, V2):                  # the real solves run on the CPU
        assert np.isfinite(m(p))
    seen = []
    t = {(V1, 1): 1.0, (V1, 11): 9.0, (V2, 1): 5.0, (V2, 11): 7.0}

    def scripted(fn, pipeline, niter, **kw):
        seen.append((pipeline, niter))
        return t[(pipeline, niter)]

    monkeypatch.setattr(autotune, "MEASURE_ITERS", 10)
    monkeypatch.setattr(autotune._timing, "measure", scripted)
    assert m(V2) == pytest.approx(0.2) and m(V1) == pytest.approx(0.8)
    assert seen == [(V2, 1), (V2, 11), (V1, 1), (V1, 11)]
    assert autotune.pick_pipeline((1, 1, 2), 3, torch.float64,
                                  device="cpu", measure=m) == V2


def test_pick_on_the_card_without_one_raises(monkeypatch):
    """``device=None`` is the card: no fallback to the CPU's threshold."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        autotune.pick_pipeline((2, 2, 2), 4)


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_case_auto_resolves_and_solves_like_the_reference(x64, precond):
    """``NekboneCase(ax_impl="auto", device="cpu")`` resolves through
    ``pick_pipeline`` and solves; its history matches the reference's
    solve through the same pipeline (fp64, rtol 1e-10)."""
    case = NekboneCase(n=4, grid=(2, 2, 2), dtype=torch.float64,
                       ax_impl="auto", precond=precond, device="cpu")
    assert case.ax_impl_requested == "auto"
    assert case.ax_impl == autotune.pick_pipeline(
        (2, 2, 2), 4, torch.float64, device="cpu", precond=precond)
    if precond is not None:
        assert case.ax_impl == V2
    jcase = JaxCase(n=4, grid=(2, 2, 2), dtype=jnp.float64,
                    ax_impl=case.ax_impl, precond=precond)
    _, f = jcase.manufactured()
    ref = jcase.solve(f, niter=6)
    res = case.solve(torch.as_tensor(np.array(f)), niter=6)
    h, h_ref = res.history.numpy(), np.asarray(ref.rnorm_history)
    np.testing.assert_allclose(h, h_ref, rtol=1e-10)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x),
                               rtol=1e-10, atol=1e-12)
