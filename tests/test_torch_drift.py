"""obs/drift.py of the port: the stream charging, the bands, the pinned
collective contracts and the gate, against the reference's drift module.

The collective contracts are the reference's (``EXPECTED_COLLECTIVES``),
read from the port's counter; the bytes ratios sit in the port's own
bands, calibrated on its count (``STREAM_BYTE_BANDS``' comment); a
stand-in that charges one full-field operand stream more at each launch
falls outside every band and makes ``assert_no_drift`` raise; the report's
``to_dict`` keys are the reference's.
"""
import numpy as np
import pytest
import torch

from repro.obs import drift as JD
from repro_torch.kernels import _build, ops
from repro_torch.obs import drift

PIPELINES = list(drift.DEFAULT_PIPELINES)


@pytest.fixture(scope="module")
def report():
    return drift.check(device="cpu")


def test_pipelines_and_contracts_are_the_reference_ones():
    assert drift.DEFAULT_PIPELINES == JD.DEFAULT_PIPELINES
    assert drift.EXPECTED_COLLECTIVES == JD.EXPECTED_COLLECTIVES
    assert set(drift.STREAM_BYTE_BANDS) == set(JD.STREAM_BYTE_BANDS)


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_collectives_match_the_pinned_contract(report, pipeline):
    row = next(r for r in report.rows
               if r.pipeline == pipeline and r.check == "collectives")
    assert row.ok, row
    assert row.measured == JD.EXPECTED_COLLECTIVES[pipeline]


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_bytes_ratio_inside_the_band(report, pipeline):
    row = next(r for r in report.rows
               if r.pipeline == pipeline and r.check == "bytes_per_dof_iter")
    lo, hi = drift.STREAM_BYTE_BANDS[pipeline]
    assert row.ok and lo <= row.ratio <= hi, row
    assert row.band == (lo, hi)


def test_assert_no_drift_passes_on_the_cpu(report):
    assert drift.assert_no_drift(report) is report
    assert drift.assert_no_drift(device="cpu").ok


def test_checks_run_on_the_card_by_default(monkeypatch):
    """device=None is the card, as for every entry point of the port:
    without one the checks raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: drift.check_bytes("fused_v2"),
                 lambda: drift.check_collectives("fused_v2"),
                 lambda: drift.check_collectives("sstep_v3"),
                 lambda: drift.assert_no_drift()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _one_more_stream(monkeypatch):
    """Every launch charges one full field of the drift case more."""
    field = int(np.prod(drift._DRIFT_GRID)) * drift._DRIFT_N ** 3 * 4
    real = drift.StreamCount.charge

    def charge(self, name, reads, writes):
        real(self, name, reads + field, writes)

    monkeypatch.setattr(drift.StreamCount, "charge", charge)


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_an_extra_stream_a_launch_is_drift(monkeypatch, pipeline):
    _one_more_stream(monkeypatch)
    row = drift.check_bytes(pipeline, device="cpu")
    assert not row.ok and row.ratio > drift.STREAM_BYTE_BANDS[pipeline][1]
    rep = drift.DriftReport(rows=[row])
    with pytest.raises(drift.ModelDriftError, match=pipeline):
        drift.assert_no_drift(rep)


def test_unknown_pipeline_raises():
    with pytest.raises(ValueError):
        drift.check_bytes("made_up_pipeline")
    with pytest.raises(ValueError):
        drift.check_collectives("made_up_pipeline")


def test_report_to_dict_keys_match_reference():
    kw = dict(pipeline="p", check="c", measured=[1.0, 2.0],
              expected=[1.0, 2.0], ok=True, ratio=1.0, band=(0.9, 1.1))
    got, want = drift.DriftRow(**kw), JD.DriftRow(**kw)
    assert got.to_dict() == want.to_dict()
    rep, jrep = drift.DriftReport(rows=[got]), JD.DriftReport(rows=[want])
    assert set(rep.to_dict()) == set(jrep.to_dict())
    assert rep.to_dict()["schema"] == jrep.to_dict()["schema"]
    assert rep.to_dict()["rows"] == jrep.to_dict()["rows"]
    assert rep.ok and rep.failures() == []
    bad = drift.DriftRow(**{**kw, "ok": False})
    assert drift.DriftReport(rows=[got, bad]).failures() == [bad]


def test_eager_ops_are_charged_and_views_are_not():
    a = torch.zeros(8, dtype=torch.float32)
    r, w = drift.measure_call_bytes(lambda x, y: x + y, a, a)
    assert (r, w) == (2 * 32, 32)
    r, w = drift.measure_call_bytes(lambda x: x.reshape(2, 4).t()[0], a)
    assert (r, w) == (0, 0)
    # a copy to another device (here the meta device) is no stream
    r, w = drift.measure_call_bytes(lambda x: x.to("meta"), a)
    assert (r, w) == (0, 0)


def test_a_wrapper_is_charged_once_with_its_operands():
    """K1's wrapper on the CPU (its plain version): its operands and
    result, once; nothing of its plain version's own ops."""
    n, E = 4, 3
    u = torch.randn(E, n, n, n, dtype=torch.float64)
    D = torch.randn(n, n, dtype=torch.float64)
    g = torch.randn(E, 6, n ** 3, dtype=torch.float64)
    with drift.count_streams() as rec:
        w = ops.nekbone_ax(u, D, g)
    (name, (reads, writes, calls)), = rec.launches.items()
    assert name == "nekbone_ax_cuda" and calls == 1
    assert reads == (E * n ** 3 + n * n + E * 6 * n ** 3) * 8
    assert writes == w.numel() * 8
    assert _build.CHARGE is None
    # the ops around the wrapper (the reshapes are views, a contiguous
    # copy of D is none: D is contiguous) charge nothing here
    assert rec.eager_read == rec.eager_write == 0


def test_iteration_bytes_are_a_difference_of_two_runs():
    def driver(niter):
        x = torch.zeros(16)
        for _ in range(niter):
            x = x + 1.0
        return x

    r, w = drift.measure_iteration_bytes(driver, 2, 5)
    # one add an iteration: x read and written (the Python scalar is no
    # tensor); the zeros of the set-up cancel
    assert (r, w) == (16 * 4, 16 * 4)
    with pytest.raises(ValueError):
        drift.measure_iteration_bytes(driver, 3, 3)
