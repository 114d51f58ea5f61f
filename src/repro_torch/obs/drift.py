"""Cost-model drift detection: do the ``core/cost.py`` books still describe
the programs that run? (DESIGN.md §14.3)

The port of the reference's ``obs/drift.py``.  The reference traces each
pipeline's driver to a jaxpr and walks it; a torch program has no jaxpr, so
the two checks are rebuilt on what the port can count while a pipeline runs:

* **bytes/iter** — every kernel wrapper of ``kernels/nekbone_ax.py`` (the
  ``*_cuda`` functions, K1 to K12) charges the bytes of its tensor operands
  and results at its entry (``kernels/_build.charged``), whether it then
  launches its kernel or, on the CPU, runs its plain version; and a
  ``TorchDispatchMode`` charges each eager aten op between launches the
  bytes of its tensor inputs and outputs (views, which move nothing, are
  not charged, nor copies between the host and the card, which have no
  counterpart on the CPU; nothing inside a charged wrapper is charged
  twice).  Both counts read shapes and dtypes only, so the CPU and the
  card give the same count but for the host's own small tensors (the
  s-step recurrence's coefficients and Gram matrix), which the CPU charges
  as eager ops and the card moves by uncharged copies: a few hundred bytes
  a cycle, 2e-4 of s-step's ratio.  Per-iteration bytes are the
  difference of two runs of the public driver that differ by one
  iteration (s-step: by one cycle, divided by ``s``), after a warm run,
  so set-up and the answer's read-back cancel.
  The measured bytes/DOF/iter are held, as a ratio to
  ``cost.bytes_per_dof_iter(..., exact=True)``, in a per-pipeline band
  (:data:`STREAM_BYTE_BANDS`) calibrated on this count.

* **collectives** — the counter of ``distributed/sharding.py`` (read through
  ``obs/metrics.measure_collectives``) against the pinned contracts
  (:data:`EXPECTED_COLLECTIVES`, the reference's): the single-device v2
  family issues none, and the sharded s-step cycle, run on the one-shard
  ``SolverMesh`` (a call is counted where it is issued, also on one shard),
  issues two ppermutes and one psum, its update none.  The port's contract
  differs from the reference's in one place that the pin does not see: the
  update's ``r·c·r`` partial has no psum of its own; it rides in the next
  cycle's Gram psum, and the last one is reduced once after the loop
  (``distributed/sstep.py``).

``check()`` returns a :class:`DriftReport` (the JSON ``model_drift``
payload, with provenance); ``assert_no_drift()`` raises
:class:`ModelDriftError` with the drifted rows.  Like every entry point of
the port, the checks run on the card unless ``device="cpu"`` is given, and
raise without a card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels._build import _tensor_bytes as _nbytes

__all__ = ["DriftRow", "DriftReport", "ModelDriftError",
           "DEFAULT_PIPELINES", "STREAM_BYTE_BANDS", "EXPECTED_COLLECTIVES",
           "StreamCount", "count_streams", "measure_call_bytes",
           "measure_iteration_bytes", "check_bytes", "check_collectives",
           "check", "assert_no_drift"]


#: Pipelines the drift gate covers by default (the reference's set).
DEFAULT_PIPELINES = ("fused_v2", "fused_v2_jacobi", "sstep_v3")

#: (lo, hi) bands for measured/model *total* bytes/DOF/iter.
#: Calibration (CPU, torch 2.13, n=10, grid=(2,2,4), f32, the books at
#: sz=2 and s=4): fused_v2 0.9865, fused_v2_jacobi 0.9876 — K4's and K5's
#: (K10's) operands and results are the book's streams, less its TPU plane
#: side channel, which the port's kernels do not materialise, plus the
#: eager scalar ops; sstep_v3 0.5600 — K8 and K9 move the book's streams,
#: and the book's s-step halo (10/sz streams of window copies that the TPU
#: kernel materialises) has no counterpart in the port's single-device K8.
#: The reference's bands (about +-13 % and +-16 %) absorb jaxpr
#: differences between jax versions; this count is an exact tally with no
#: compiler in between, so its bands are +-5 %: one full-field operand
#: more or less a launch leaves them in every pipeline (s-step's moves the
#: ratio by 2/s of a stream an iteration, 8 %).
STREAM_BYTE_BANDS = {
    "fused_v2": (0.94, 1.04),
    "fused_v2_jacobi": (0.94, 1.04),
    "sstep_v3": (0.53, 0.59),
}

#: Pinned collective contracts per pipeline (the reference's).
EXPECTED_COLLECTIVES = {
    "fused_v2": {},
    "fused_v2_jacobi": {},
    "sstep_v3": {"cycle": {"ppermute": 2, "psum": 1}, "update": {}},
}

# The drift case: the paper degree on the smallest grid the reference's
# gate accepts, the books at its pinned (sz, s).
_DRIFT_N = 10
_DRIFT_GRID = (2, 2, 4)
_DRIFT_SZ = 2
_DRIFT_S = 4
_DRIFT_PRECISION = "f32"
# theta of the drift case's s-step basis, fixed so no power iteration runs
_DRIFT_THETA = 2.25


# ---------------------------------------------------------------------------
# stream-byte charging
# ---------------------------------------------------------------------------

def _is_view(func) -> bool:
    """An aten op whose results alias its inputs without writing them."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _device_types(obj, out: set) -> set:
    if isinstance(obj, torch.Tensor):
        out.add(obj.device.type)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _device_types(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _device_types(o, out)
    return out


@dataclasses.dataclass
class StreamCount:
    """Bytes charged while :func:`count_streams` was open: by the kernel
    wrappers (``launches``: reads, writes and calls by wrapper) and by the
    eager ops between them (``eager_read``, ``eager_write``)."""

    launches: dict = dataclasses.field(default_factory=dict)
    eager_read: int = 0
    eager_write: int = 0
    depth: int = 0

    def charge(self, name: str, reads: int, writes: int) -> None:
        r, w, k = self.launches.get(name, (0, 0, 0))
        self.launches[name] = (r + reads, w + writes, k + 1)

    @property
    def read(self) -> int:
        return self.eager_read + sum(r for r, _, _ in self.launches.values())

    @property
    def write(self) -> int:
        return self.eager_write + sum(w for _, w, _ in
                                      self.launches.values())


class _EagerBytes(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self, rec: StreamCount):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (self.rec.depth == 0 and not _is_view(func)
                and len(_device_types((args, kwargs, out), set())) <= 1):
            self.rec.eager_read += _nbytes((args, kwargs))
            self.rec.eager_write += _nbytes(out)
        return out


class count_streams:
    """``with count_streams() as rec:`` charges the block's kernel wrappers
    and eager ops to ``rec`` (a :class:`StreamCount`)."""

    def __enter__(self) -> StreamCount:
        from repro_torch.kernels import _build

        if _build.CHARGE is not None:
            raise RuntimeError("count_streams does not nest")
        self.rec = StreamCount()
        _build.CHARGE = self.rec
        self.mode = _EagerBytes(self.rec)
        self.mode.__enter__()
        return self.rec

    def __exit__(self, *exc):
        from repro_torch.kernels import _build

        try:
            self.mode.__exit__(*exc)
        finally:
            _build.CHARGE = None
        return False


def measure_call_bytes(fn, *args, **kwargs) -> tuple[int, int]:
    """(read, write) bytes charged by one call of ``fn``."""
    with count_streams() as rec:
        fn(*args, **kwargs)
    return rec.read, rec.write


def measure_iteration_bytes(driver, lo: int, hi: int) -> tuple[float, float]:
    """Per-iteration (read, write) bytes of ``driver(niter)``: the bytes of
    ``driver(hi)`` less those of ``driver(lo)``, over ``hi - lo``, after a
    warm call of ``driver(lo)`` (plans and caches filled once)."""
    if hi <= lo:
        raise ValueError(f"need hi > lo, got lo={lo}, hi={hi}")
    driver(lo)
    r0, w0 = measure_call_bytes(driver, lo)
    r1, w1 = measure_call_bytes(driver, hi)
    return (r1 - r0) / (hi - lo), (w1 - w0) / (hi - lo)


# ---------------------------------------------------------------------------
# report types
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DriftRow:
    """One pipeline x one check."""

    pipeline: str
    check: str                          # "bytes_per_dof_iter"|"collectives"
    measured: object                    # bytes: [r, w]; collectives: dict
    expected: object
    ok: bool
    ratio: float | None = None          # bytes only: measured/model total
    band: tuple | None = None
    detail: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DriftReport:
    """The ``model_drift`` payload: one row per (pipeline, check)."""

    rows: list

    @property
    def ok(self) -> bool:
        return all(row.ok for row in self.rows)

    def failures(self) -> list:
        return [row for row in self.rows if not row.ok]

    def to_dict(self) -> dict:
        from repro_torch.obs import trace

        return {"schema": "model-drift/1", "ok": self.ok,
                "provenance": trace.provenance(),
                "rows": [row.to_dict() for row in self.rows]}


class ModelDriftError(RuntimeError):
    """The cost books no longer describe the program that runs."""


# ---------------------------------------------------------------------------
# per-pipeline checks
# ---------------------------------------------------------------------------

def _drift_case(precision: str, device):
    from repro_torch.core.nekbone import NekboneCase, _resolve_device

    device = _resolve_device(device)
    return NekboneCase(n=_DRIFT_N, grid=_DRIFT_GRID, ax_impl="fused",
                       precision=precision, device=device)


def _driver(case, pipeline: str, precision: str, s: int):
    """``niter -> result`` of the pipeline's public single-device driver on
    the drift case's manufactured right-hand side."""
    from repro_torch.core.cg_sstep import cg_sstep_fixed_iters
    from repro_torch.core.precond import pcg_fused_v2_fixed_iters

    f = case.manufactured()[1]
    common = dict(D=case.D, g=case.g, grid=case.grid, mask=case.mask,
                  c=case.c, precision=precision)
    if pipeline == "sstep_v3":
        return lambda niter: cg_sstep_fixed_iters(
            f, niter=niter, s=s, theta=_DRIFT_THETA, **common)
    spec = (case.precond_spec("jacobi")
            if pipeline == "fused_v2_jacobi" else None)
    return lambda niter: pcg_fused_v2_fixed_iters(
        f, niter=niter, precond=spec, **common)


def check_bytes(pipeline: str, *, precision: str = _DRIFT_PRECISION,
                sz: int = _DRIFT_SZ, s: int = _DRIFT_S,
                device=None) -> DriftRow:
    """Measured vs modelled bytes/DOF/iter for one pipeline, on
    ``device`` (the card unless given; without a card, pass ``"cpu"``)."""
    from repro_torch.core import cost

    if pipeline not in STREAM_BYTE_BANDS:
        raise ValueError(
            f"no calibrated drift band for pipeline {pipeline!r} "
            f"(known: {sorted(STREAM_BYTE_BANDS)})")
    case = _drift_case(precision, device)
    ndof = case.mesh.nelt * _DRIFT_N ** 3
    drv = _driver(case, pipeline, precision, s)
    if pipeline == "sstep_v3":
        r, w = measure_iteration_bytes(drv, s, 2 * s)
        rm, wm = cost.bytes_per_dof_iter(pipeline, precision, exact=True,
                                         n=_DRIFT_N, sz=sz, s=s)
    else:
        r, w = measure_iteration_bytes(drv, 2, 3)
        rm, wm = cost.bytes_per_dof_iter(pipeline, precision, exact=True,
                                         n=_DRIFT_N, sz=sz)
    meas_r, meas_w = r / ndof, w / ndof
    ratio = (meas_r + meas_w) / (rm + wm)
    lo, hi = STREAM_BYTE_BANDS[pipeline]
    ok = lo <= ratio <= hi
    return DriftRow(
        pipeline=pipeline, check="bytes_per_dof_iter",
        measured=[round(meas_r, 3), round(meas_w, 3)],
        expected=[round(rm, 3), round(wm, 3)], ok=ok,
        ratio=round(ratio, 4), band=(lo, hi),
        detail=(f"measured/model total ratio {ratio:.3f} "
                f"{'within' if ok else 'OUTSIDE'} [{lo}, {hi}] "
                f"(n={_DRIFT_N}, grid={_DRIFT_GRID}, sz={sz}, "
                f"{case.device.type})"))


def check_collectives(pipeline: str, *,
                      precision: str = _DRIFT_PRECISION,
                      sz: int = _DRIFT_SZ, s: int = _DRIFT_S,
                      device=None) -> DriftRow:
    """Measured vs pinned collective counts for one pipeline, on
    ``device`` as :func:`check_bytes`."""
    from repro_torch.obs.metrics import measure_collectives

    if pipeline not in EXPECTED_COLLECTIVES:
        raise ValueError(
            f"no pinned collective contract for pipeline {pipeline!r} "
            f"(known: {sorted(EXPECTED_COLLECTIVES)})")
    expected = EXPECTED_COLLECTIVES[pipeline]
    if pipeline == "sstep_v3":
        from repro_torch.distributed.sharding import SolverMesh
        from repro_torch.distributed.sstep import cycle_collective_counts

        got = cycle_collective_counts(grid=_DRIFT_GRID, n=_DRIFT_N, s=s,
                                      mesh=SolverMesh(order=(0,), shard=0),
                                      device=device)
        measured = {"cycle": got["cycle"], "update": got["update"]}
        where = "sharded cycle/update on the one-shard mesh"
    else:
        case = _drift_case(precision, device)
        measured = measure_collectives(_driver(case, pipeline, precision, s),
                                       3)
        where = "single-device driver"
    ok = measured == expected
    return DriftRow(
        pipeline=pipeline, check="collectives", measured=measured,
        expected=expected, ok=ok,
        detail=(f"{where}: {'matches' if ok else 'DRIFTED from'} "
                f"the pinned contract"))


def check(pipelines=DEFAULT_PIPELINES, *,
          precision: str = _DRIFT_PRECISION, device=None) -> DriftReport:
    """Run both drift checks over ``pipelines``; never raises on drift —
    inspect ``report.ok`` or call :func:`assert_no_drift`."""
    rows = []
    for pipeline in pipelines:
        rows.append(check_bytes(pipeline, precision=precision,
                                device=device))
        rows.append(check_collectives(pipeline, precision=precision,
                                      device=device))
    return DriftReport(rows=rows)


def assert_no_drift(report: DriftReport | None = None,
                    pipelines=DEFAULT_PIPELINES, *,
                    device=None) -> DriftReport:
    """Run (or take) a drift report and fail loudly on any drifted row."""
    if report is None:
        report = check(pipelines, device=device)
    if not report.ok:
        lines = [f"  {row.pipeline}/{row.check}: measured={row.measured} "
                 f"expected={row.expected} ({row.detail})"
                 for row in report.failures()]
        raise ModelDriftError(
            "cost-model drift detected — core/cost.py books no longer "
            "describe the pipelines:\n" + "\n".join(lines))
    return report
