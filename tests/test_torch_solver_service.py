"""Port: ``launch/solver_service.py`` — the reference's
``tests/test_solver_service.py`` scheduling cases on the port, and the
port's service against the reference's on the same requests (fp64: the
same request-id groups and batch sizes, ``x`` and the histories within
1e-12 relative).

The reference's own failing case is its f32 bitwise one (ROADMAP queue 3),
so the port is held to fp64; its batched answers are bitwise the direct
solves of the same batch in fp64 and f32.
"""
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.nekbone import NekboneConfig as JaxConfig
from repro.launch import solver_service as jax_service
from repro_torch.configs.nekbone import NekboneConfig
from repro_torch.core.gs import ds_sum_local
from repro_torch.launch.solver_service import (DispatchRecord, SolveRequest,
                                               SolverService, _nearest_rank,
                                               bench_service)
from repro_torch.obs import trace

RTOL = 1e-12


def _cfg(**over):
    base = dict(name="svc", n=4, grid=(2, 2, 2), dtype="float64",
                ax_impl="pallas_fused_cg_v2")
    base.update(over)
    return NekboneConfig(**base)


def _rhs(case, k, seed=1):
    """The manufactured rhs and k-1 random assembled, masked ones."""
    rng = np.random.default_rng(seed)
    _, f0 = case.manufactured()
    return [f0] + [ds_sum_local(torch.as_tensor(
        rng.normal(size=tuple(f0.shape)), dtype=case.dtype), case.grid)
        * case.mask for _ in range(k - 1)]


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    case = cfg.make_case(device="cpu")
    _, f = case.manufactured()
    return cfg, case, f


def test_empty_queue_drains_empty():
    svc = SolverService(max_b=4, device="cpu")
    assert svc.drain() == []
    assert svc.dispatch_log == []
    assert svc.pending == 0


def test_mixed_buckets_never_co_scheduled(setup):
    cfg, case, f = setup
    cfg_pc = _cfg(precond="jacobi")
    svc = SolverService(max_b=8, device="cpu")
    ids_a = [svc.submit(SolveRequest(f=f, config=cfg, niter=4))
             for _ in range(2)]
    ids_b = [svc.submit(SolveRequest(f=f, config=cfg_pc, niter=4))]
    ids_c = [svc.submit(SolveRequest(f=f, config=cfg, tol=1e-6))]
    results = svc.drain()
    assert [r.request_id for r in results] == ids_a + ids_b + ids_c
    assert len(svc.dispatch_log) == 3
    groups = [set(rids) for _, rids in svc.dispatch_log]
    assert set(ids_a) in groups
    assert set(ids_b) in groups
    assert set(ids_c) in groups
    assert len({k for k, _ in svc.dispatch_log}) == 3


def test_bucket_overflow_splits(setup):
    cfg, case, f = setup
    svc = SolverService(max_b=3, device="cpu")
    ids = [svc.submit(SolveRequest(f=f, config=cfg, niter=3))
           for _ in range(7)]
    results = svc.drain()
    assert [r.request_id for r in results] == ids
    sizes = [len(rids) for _, rids in svc.dispatch_log]
    assert sizes == [3, 3, 1]
    assert all(s <= svc.max_b for s in sizes)
    assert [r.batch_size for r in results] == [3, 3, 3, 3, 3, 3, 1]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batched_answers_match_direct_solve(dtype):
    """Each answer is bitwise the direct solve of the same batch: the block
    route's lanes are each its own v2 solve in the port."""
    cfg = _cfg(dtype=dtype)
    svc = SolverService(max_b=4, device="cpu")
    case = svc._case_for(cfg)
    fs = _rhs(case, 2)
    for fi in fs:
        svc.submit(SolveRequest(f=fi, config=cfg, niter=6))
    results = svc.drain()
    assert len(svc.dispatch_log) == 1
    direct = case.solve(torch.stack(fs), niter=6)
    for j, (r, fi) in enumerate(zip(results, fs)):
        assert torch.equal(r.x, direct.x[j])
        assert torch.equal(r.x, case.solve(fi, niter=6).x)
        assert r.pipeline == "fused_v2_rhs2"
        assert int(r.iters_taken) == 6


def test_warm_start_builds_the_case_and_resolves_auto(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    from repro_torch.kernels import autotune

    autotune.clear_cache()
    svc = SolverService(max_b=2, device="cpu")
    cfg = _cfg(ax_impl="auto")
    s0 = autotune.cache_stats()
    assert svc.warm_start([cfg], batches=[1, 2], niter=1) == 2
    assert len(svc._cases) == 1
    case = next(iter(svc._cases.values()))
    assert case.ax_impl_requested == "auto"
    assert case.ax_impl in ("pallas_fused_cg", "pallas_fused_cg_v2")
    assert autotune.cache_stats()["misses"] == s0["misses"] + 1
    autotune.clear_cache()


def test_rejects_bad_max_b():
    with pytest.raises(ValueError, match="max_b"):
        SolverService(max_b=0)


def test_dispatch_record_tuple_shim():
    rec = DispatchRecord(bucket=("bk",), request_ids=[1, 2, 3],
                         wall_us=5.0, pipeline="fused_v2_rhs3")
    assert len(rec) == 2
    assert rec[0] == ("bk",) and rec[1] == [1, 2, 3]
    bucket, rids = rec
    assert bucket == ("bk",) and rids == [1, 2, 3]
    assert rec == (("bk",), [1, 2, 3])
    assert rec != (("other",), [1, 2, 3])
    assert rec == DispatchRecord(bucket=("bk",), request_ids=[1, 2, 3])
    assert isinstance(hash(rec), int)
    assert rec.batch_size == 3


def test_dispatch_log_records_carry_telemetry(setup):
    cfg, case, f = setup
    svc = SolverService(max_b=2, device="cpu")
    for _ in range(3):
        svc.submit(SolveRequest(f=f, config=cfg, niter=2))
    svc.drain()
    assert len(svc.dispatch_log) == 2
    for rec in svc.dispatch_log:
        assert isinstance(rec, DispatchRecord)
        assert rec.wall_us > 0
        assert rec.pipeline is not None
    assert [r.batch_size for r in svc.dispatch_log] == [2, 1]
    snap = svc.metrics.snapshot()
    assert snap["dispatches"] == 2
    assert snap["requests_served"] == 3
    assert snap["queue_high_water"] == 3
    assert snap["latency_ms"]["count"] == 2


def test_traced_drain_is_bitwise_and_carries_telemetry(setup, tmp_path):
    cfg, case, f = setup
    fs = _rhs(case, 3)

    def drain():
        svc = SolverService(max_b=2, device="cpu")
        for fi in fs:
            svc.submit(SolveRequest(f=fi, config=cfg, niter=3))
        svc.submit(SolveRequest(f=fs[0], config=cfg, niter=3,
                                precond="jacobi"))
        return svc.drain()

    off = drain()
    path = tmp_path / "svc.jsonl"
    with trace.recording(path) as rec:
        on = drain()
    assert trace.validate_trace_file(path) == []
    names = {r["name"] for r in rec.records if r["type"] == "span"}
    assert {"service.dispatch", "solve", "block.dispatch"} <= names
    assert rec.counters["service.dispatches"] == 3
    assert rec.counters["service.requests"] == 4
    for a, b in zip(off, on):
        assert a.telemetry is None and b.telemetry is not None
        assert torch.equal(a.x, b.x) and a.request_id == b.request_id


# ---------------------------------------------------------------------------
# the port's service against the reference's, fp64
# ---------------------------------------------------------------------------

def _both(requests, max_b):
    """Drain the same (cfg kwargs, rhs index, request kwargs) list through
    both services; returns (port results, port log, ref results, ref log)."""
    svc = SolverService(max_b=max_b, device="cpu")
    jsvc = jax_service.SolverService(max_b=max_b)
    base = dict(name="svc", n=4, grid=(2, 2, 2), dtype="float64",
                ax_impl="pallas_fused_cg_v2")
    case = svc._case_for(_cfg())
    fs = _rhs(case, 5, seed=7)
    for cfg_kw, i, req_kw in requests:
        kw = dict(base, **cfg_kw)
        svc.submit(SolveRequest(f=fs[i], config=NekboneConfig(**kw),
                                **req_kw))
        jsvc.submit(jax_service.SolveRequest(
            f=jnp.asarray(fs[i].numpy()), config=JaxConfig(**kw), **req_kw))
    return svc.drain(), svc.dispatch_log, jsvc.drain(), jsvc.dispatch_log


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    assert np.array_equal(fin, np.isfinite(a))
    return float(np.max(np.abs(a[fin] - b[fin])) /
                 max(np.max(np.abs(b[fin])), 1e-300))


MIXES = {
    "one_bucket_split": ([({}, i % 5, dict(niter=5)) for i in range(7)], 3),
    "three_buckets": ([({}, 0, dict(niter=5)), ({}, 1, dict(niter=5)),
                       ({}, 2, dict(niter=5, precond="jacobi")),
                       ({}, 3, dict(niter=5, precond="jacobi")),
                       ({}, 4, dict(tol=1e-6, max_iter=40)),
                       ({}, 1, dict(niter=5))], 2),
    "configs_differ": ([({}, 0, dict(niter=4)),
                        (dict(precond="jacobi"), 1, dict(niter=4)),
                        (dict(ax_impl="pallas_fused_cg"), 2,
                         dict(niter=4)),
                        ({}, 3, dict(niter=4))], 4),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_service_matches_reference_fp64(x64, mix):
    requests, max_b = MIXES[mix]
    res, log, jres, jlog = _both(requests, max_b)
    assert [list(r) for _, r in log] == [list(r) for _, r in jlog]
    assert [d.batch_size for d in log] == [d.batch_size for d in jlog]
    assert [r.request_id for r in res] == [r.request_id for r in jres]
    for r, jr in zip(res, jres):
        assert r.batch_size == jr.batch_size
        assert r.batch_index == jr.batch_index
        assert int(r.iters_taken) == int(np.asarray(jr.iters_taken))
        assert _rel(r.x.numpy(), jr.x) <= RTOL, r.request_id
        assert _rel(r.history.numpy(), jr.history) <= RTOL, r.request_id


def test_bench_service_rows_on_the_cpu():
    """The bench's shape (its numbers on the CPU time the plain versions
    and are not a device metric)."""
    out = bench_service(nelt=64, n=3, requests=4, max_b=2, niter=2,
                        repeats=1, warm=False, dtype="float64",
                        device="cpu")
    assert out["device"] == "cpu" and out["nelt"] == 64
    assert set(out["rows"]) == {"1", "2"}
    assert out["rows"]["1"]["dispatches"] == 4
    assert out["rows"]["2"]["dispatches"] == 2
    for row in out["rows"].values():
        assert 0 < row["latency_ms_p50"] <= row["latency_ms_p99"] \
            <= row["latency_ms_max"]
        assert row["throughput_req_s"] > 0
        assert row["ms_per_request"] == pytest.approx(
            1e3 / row["throughput_req_s"])


@pytest.mark.parametrize("q,want", [(0.0, 1.0), (0.25, 1.0), (0.5, 2.0),
                                    (0.51, 3.0), (0.99, 4.0), (1.0, 4.0)])
def test_bench_latency_quantile_is_an_observed_value(q, want):
    """Nearest rank over the requests' latencies: no interpolation."""
    assert _nearest_rank([4.0, 1.0, 3.0, 2.0], q) == want


def test_dispatch_records_when_its_solve_finished(setup):
    """``done_s`` (the clock a request's latency ends on) is stamped after
    each dispatch's solve, in dispatch order."""
    cfg, _, f = setup
    svc = SolverService(max_b=2, device="cpu")
    t0 = time.perf_counter()
    for _ in range(5):
        svc.submit(SolveRequest(f=f, config=cfg, niter=2))
    svc.drain()
    done = [d.done_s for d in svc.dispatch_log]
    assert len(done) == 3 and t0 < done[0] <= done[1] <= done[2] \
        <= time.perf_counter()
