"""Port: ``obs/trace.py`` and ``obs/metrics.py`` — the reference's
``tests/test_obs_trace.py`` and ``tests/test_obs_metrics.py`` cases on the
port, the trace files of both packages held to one schema, and every route
that carries a span solving bitwise the same with tracing on and off, with
``telemetry`` attached only when tracing."""
import json

import numpy as np
import pytest
import torch

from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro_torch.core.gs import ds_sum_local
from repro_torch.core.nekbone import NekboneCase
from repro_torch.obs import trace
from repro_torch.obs.metrics import (Histogram, ServiceMetrics,
                                     capture_solve, measure_collectives)


# ---------------------------------------------------------------------------
# off-path contract: no recorder, no allocation
# ---------------------------------------------------------------------------

def test_active_is_none_by_default():
    assert trace.active() is None


def test_module_span_is_null_singleton_when_off():
    s1 = trace.span("anything", attr=1)
    s2 = trace.span("else")
    assert s1 is trace.NULL_SPAN and s2 is trace.NULL_SPAN
    with s1:
        pass


def test_module_count_gauge_event_noop_when_off():
    trace.count("c")
    trace.gauge("g", 2.0)
    trace.event("e", k=1)


def test_profiler_annotation_null_without_env(monkeypatch):
    monkeypatch.delenv("REPRO_PROFILE", raising=False)
    assert trace.profiler_annotation("x") is trace.NULL_SPAN


def test_profiler_annotation_is_a_record_function_with_env(monkeypatch):
    monkeypatch.setenv("REPRO_PROFILE", "1")
    ann = trace.profiler_annotation("nekbone.x")
    assert isinstance(ann, torch.profiler.record_function)
    with ann:
        torch.zeros(2) + 1


def test_profiling_exports_a_chrome_trace(tmp_path):
    with trace.profiling(tmp_path / "prof") as prof:
        assert prof is not None
        with torch.profiler.record_function("nekbone.step"):
            torch.ones(8) * 2
    data = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert "traceEvents" in data
    with trace.profiling(None) as prof:
        assert prof is None


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

def test_recording_activates_and_restores():
    assert trace.active() is None
    with trace.recording() as rec:
        assert trace.active() is rec
        with trace.recording() as inner:
            assert trace.active() is inner
        assert trace.active() is rec
    assert trace.active() is None


def test_span_records_on_exit_with_depth_and_attrs():
    with trace.recording() as rec:
        with rec.span("outer", a=1):
            with rec.span("inner"):
                pass
    names = [(r["name"], r["depth"]) for r in rec.records]
    assert names == [("inner", 1), ("outer", 0)]
    outer = rec.records[1]
    assert outer["attrs"] == {"a": 1}
    assert outer["dur_us"] >= 0
    assert outer["type"] == "span"


def test_counters_and_gauges_land_in_summary():
    with trace.recording() as rec:
        rec.count("solves")
        rec.count("solves")
        rec.count("bytes", 7)
        rec.gauge("depth", 3)
        rec.gauge("depth", 1)
    s = rec.summary()
    assert s["counters"] == {"solves": 2, "bytes": 7}
    assert s["gauges"] == {"depth": 1}
    assert s["spans"] == 0 and s["events"] == 0


def test_lines_are_valid_jsonl_with_header_and_summary():
    with trace.recording(meta={"case": "unit"}) as rec:
        with rec.span("s", x=2):
            rec.event("ev", y=np.int64(3), t=torch.tensor(2.5))
    lines = rec.lines()
    head = json.loads(lines[0])
    tail = json.loads(lines[-1])
    assert head["type"] == "header"
    assert head["schema"] == trace.TRACE_SCHEMA == jax_trace.TRACE_SCHEMA
    assert head["meta"] == {"case": "unit"}
    assert set(head["provenance"]) >= {"machine", "python"}
    assert tail["type"] == "summary"
    assert tail["spans"] == 1 and tail["events"] == 1
    assert trace.validate_trace_lines(lines) == []
    # one schema: the reference's validator accepts the port's trace
    assert jax_trace.validate_trace_lines(lines) == []


def test_write_and_validate_file(tmp_path):
    path = tmp_path / "sub" / "t.trace.jsonl"
    with trace.recording(path) as rec:
        with rec.span("s"):
            pass
    assert path.exists()
    assert trace.validate_trace_file(path) == []
    lines = path.read_text().splitlines()
    head = json.loads(lines[0])
    head["schema"] = "not-a-trace/9"
    path.write_text("\n".join([json.dumps(head)] + lines[1:]) + "\n")
    assert trace.validate_trace_file(path) != []


@pytest.mark.parametrize("lines", [
    [], ["not json"], ['{"type": "span"}'],
    ['{"type": "header", "schema": "repro-trace/1", "schema_version": 1, '
     '"provenance": {}}', '{"type": "summary", "spans": 2, "events": 0, '
     '"counters": {}, "gauges": {}}'],
])
def test_validator_rejects_like_reference(lines):
    got = trace.validate_trace_lines(lines)
    assert got and got == jax_trace.validate_trace_lines(lines)


def test_recording_writes_file_on_exception(tmp_path):
    path = tmp_path / "fail.trace.jsonl"
    with pytest.raises(RuntimeError):
        with trace.recording(path) as rec:
            with rec.span("doomed"):
                pass
            raise RuntimeError("solve blew up")
    assert path.exists()
    assert trace.validate_trace_file(path) == []


def test_machine_tag_is_hostname_free_and_the_references():
    import platform

    tag = trace.machine_tag()
    assert platform.node() not in tag or platform.node() == ""
    assert tag.startswith(platform.system().lower())
    assert tag == jax_trace.machine_tag()


def test_provenance_keys():
    prov = trace.provenance()
    assert {"machine", "python", "torch_version", "cuda_version",
            "device"} <= set(prov)
    assert not any(k.startswith("jax") for k in prov)
    assert prov["torch_version"] == torch.__version__
    if not torch.cuda.is_available():
        assert prov["device"] is None


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bounds,values", [
    ((1.0, 10.0), (0.5, 5.0, 5.0, 50.0)),
    ((1.0, 10.0), (1.0,)),
    ((0.25, 0.5, 0.75, 1.0), (0.25, 1.0, 0.3, 2.0, 0.75)),
    ((1.0,), ()),
])
def test_histogram_matches_reference(bounds, values):
    h, hr = Histogram(bounds), jax_metrics.Histogram(bounds)
    for v in values:
        h.record(v)
        hr.record(v)
    assert h.snapshot() == hr.snapshot()


def test_histogram_buckets_and_stats():
    h = Histogram((1.0, 10.0))
    for v in (0.5, 5.0, 5.0, 50.0):
        h.record(v)
    snap = h.snapshot()
    assert snap["buckets"] == {"le_1": 1, "le_10": 2, "inf": 1}
    assert snap["count"] == 4
    assert snap["min"] == 0.5 and snap["max"] == 50.0
    assert snap["mean"] == pytest.approx(60.5 / 4)


def test_histogram_empty_snapshot_and_bounds():
    snap = Histogram((1.0,)).snapshot()
    assert snap["count"] == 0
    assert snap["mean"] is None and snap["min"] is None
    with pytest.raises(ValueError):
        Histogram(())
    h = Histogram((1.0, 10.0))
    h.record(1.0)          # upper edges are inclusive
    assert h.snapshot()["buckets"]["le_1"] == 1


def _drive_metrics(m):
    m.observe_submit(1)
    m.observe_submit(2)
    m.observe_submit(3)
    m.observe_depth(0)
    bucket = ((8, 5), "f32")
    m.observe_dispatch(bucket, batch=2, max_b=4, wall_us=2_000.0)
    m.observe_dispatch(bucket, batch=1, max_b=4, wall_us=20_000.0)
    return bucket


def test_service_metrics_queue_and_dispatch():
    m = ServiceMetrics()
    bucket = _drive_metrics(m)
    snap = m.snapshot()
    assert snap["submitted"] == 3
    assert snap["queue_depth"] == 0
    assert snap["queue_high_water"] == 3
    assert snap["dispatches"] == 2
    assert snap["requests_served"] == 3
    assert snap["latency_ms"]["count"] == 2
    assert snap["occupancy"]["buckets"]["le_0.25"] == 1
    assert snap["occupancy"]["buckets"]["le_0.5"] == 1
    per = snap["per_bucket"]
    assert list(per) == [repr(bucket)]
    assert per[repr(bucket)]["latency_ms"]["count"] == 2
    # the same snapshot as the reference's, buckets and all
    mr = jax_metrics.ServiceMetrics()
    _drive_metrics(mr)
    assert snap == mr.snapshot()


def test_service_metrics_emit_to_active_recorder():
    m = ServiceMetrics()
    with trace.recording() as rec:
        m.observe_submit(5)
        m.observe_dispatch(("b",), batch=3, max_b=4, wall_us=1.0)
    assert rec.gauges["service.queue_depth"] == 5
    assert rec.counters["service.dispatches"] == 1
    assert rec.counters["service.requests"] == 3


class _FakeResult:
    pipeline = "fused_v2"
    precond = None
    iters_taken = torch.tensor([3, 5])
    achieved_rtol = torch.tensor([1e-9, 1e-7], dtype=torch.float64)


def test_capture_solve_reduces_over_batch():
    tel = capture_solve(_FakeResult(), route="block", b=2, niter=5,
                        tol=None, wall_us=123.4,
                        phases={"dispatch": 123.4},
                        autotune={"hits": 1, "misses": 0})
    assert tel.iters == 5
    assert tel.achieved_rtol == pytest.approx(1e-7)
    assert tel.route == "block" and tel.pipeline == "fused_v2"
    assert tel.autotune == {"hits": 1, "misses": 0}
    assert tel.provenance["machine"] == trace.machine_tag()
    d = tel.to_dict()
    assert d["wall_us"] == pytest.approx(123.4)
    assert d["phases"] == {"dispatch": 123.4}
    assert set(d) == set(dataclass_fields(jax_metrics.SolveTelemetry))


def dataclass_fields(cls):
    import dataclasses

    return [f.name for f in dataclasses.fields(cls)]


def test_measure_collectives_names_its_roadmap_item():
    """The sharded drivers of ROADMAP.md queue 1 item 14 landed, so
    measure_collectives counts the collectives a call issues (here on the
    one-shard mesh: a psum and a plane exchange), and none for a call
    that issues none."""
    import torch

    from repro_torch.distributed import sharding

    mesh = sharding.solver_mesh()

    def step():
        sharding.psum(torch.ones(3), mesh)
        sharding.ppermute_pair(torch.ones(2), torch.ones(2), mesh)

    assert measure_collectives(lambda: None) == {}
    assert measure_collectives(step) == {"ppermute": 2, "psum": 1}


# ---------------------------------------------------------------------------
# span sites: bitwise on/off, telemetry only when tracing
# ---------------------------------------------------------------------------

# (case kwargs, solve kwargs, batch, the route, the spans it must record)
ROUTES = {
    "v2": (dict(ax_impl="pallas_fused_cg_v2"), dict(niter=4), 1, "v2",
           {"solve"}),
    "block": (dict(ax_impl="pallas_fused_cg_v2"), dict(niter=4), 2,
              "block", {"solve", "block.dispatch"}),
    "block_tol": (dict(ax_impl="pallas_fused_cg_v2"),
                  dict(tol=1e-6, max_iter=30), 2, "block",
                  {"solve", "block.dispatch"}),
    "ir": (dict(ax_impl="pallas_fused_cg_v2", precision="f32_ir"),
           dict(niter=3), 1, "ir", {"solve", "ir.sweep"}),
    "sstep": (dict(ax_impl="pallas_sstep_v3", s=2), dict(niter=4), 1,
              "sstep", {"solve", "sstep.cycle"}),
    "pmg": (dict(ax_impl="pallas_fused_cg_v2", precond="pmg"),
            dict(niter=2), 1, "v2",
            {"solve", "pmg.vcycle.level", "pmg.dispatch"}),
    "pmg_tol": (dict(ax_impl="pallas_fused_cg_v2", precond="pmg"),
                dict(tol=1e-6, max_iter=10), 1, "v2_tol",
                {"solve", "pmg.vcycle.level", "pmg.dispatch"}),
}


def _rhs(case, b, seed=3):
    _, f0 = case.manufactured()
    if b == 1:
        return f0
    rng = np.random.default_rng(seed)
    lanes = [f0] + [ds_sum_local(torch.as_tensor(
        rng.normal(size=tuple(f0.shape))), case.grid) * case.mask
        for _ in range(b - 1)]
    return torch.stack(lanes)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_bitwise_with_tracing_on_and_off(name, tmp_path):
    case_kw, solve_kw, b, route, spans = ROUTES[name]
    case = NekboneCase(n=5, grid=(2, 2, 2), dtype=torch.float64,
                       device="cpu", **case_kw)
    f = _rhs(case, b)
    from repro_torch.core import solvers

    assert solvers.route_name(case, b=b, niter=solve_kw.get("niter"),
                              pc_name=case.precond) == route
    off = case.solve(f, **solve_kw)
    assert off.telemetry is None
    path = tmp_path / f"{name}.jsonl"
    with trace.recording(path) as rec:
        on = case.solve(f, **solve_kw)
    assert trace.validate_trace_file(path) == []
    names = {r["name"] for r in rec.records if r["type"] == "span"}
    assert spans <= names, names
    assert rec.counters.get("solves") == 1
    tel = on.telemetry
    assert tel is not None and tel.route == route and tel.b == b
    assert tel.wall_us > 0 and tel.iters == int(torch.max(on.iters_taken))
    for field in ("x", "history", "iters_taken", "achieved_rtol", "rnorm"):
        a, c = getattr(off, field), getattr(on, field)
        assert a.dtype == c.dtype and a.shape == c.shape
        assert a.numpy().tobytes() == c.numpy().tobytes(), field
