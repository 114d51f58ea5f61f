"""Per-solve and service-level metrics (the reference's ``obs/metrics.py``).

Two consumers:

* :func:`capture_solve` builds a :class:`SolveTelemetry` for one routed
  solve — called by :func:`repro_torch.core.solvers.solve_case` **only
  when a recorder is active**, so the tracing-off path allocates nothing
  and the result stays bitwise identical.  The per-phase wall-µs come from
  :func:`repro_torch.kernels.timing.stopwatch`, the autotune cache hit/miss
  deltas from :func:`repro_torch.kernels.autotune.cache_stats`.
  :func:`measure_collectives` counts the collectives a call of the
  sharded drivers issues (the reference walks their jaxprs; here the
  solver mesh's collectives count themselves, ``distributed/sharding``).

* :class:`ServiceMetrics` is the solver service's queue/dispatch
  instrument: a queue-depth gauge (+ high-water mark), a dispatch
  counter, and per-bucket latency / batch-occupancy histograms — always
  on (the service is a host-side object; a handful of floats per
  dispatch is free next to a batched solve) and snapshot-able as plain
  JSON for the bench payload.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["SolveTelemetry", "capture_solve", "measure_collectives",
           "Histogram", "ServiceMetrics"]


# ---------------------------------------------------------------------------
# per-solve telemetry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SolveTelemetry:
    """What one routed solve did — attached as ``SolveResult.telemetry``
    when tracing is on (None otherwise; host data only)."""

    route: str                          # REGISTRY row that served it
    pipeline: str | None                # SolveResult.pipeline
    precond: str | None
    b: int                              # RHS batch
    niter: int | None                   # fixed-iteration request (or None)
    tol: float | None                   # tol-driven request (or None)
    iters: int                          # iterations actually run (max over b)
    achieved_rtol: float                # worst lane for batched solves
    wall_us: float                      # dispatch wall time, host clock
    phases: dict[str, float] = dataclasses.field(default_factory=dict)
    autotune: dict[str, int] = dataclasses.field(default_factory=dict)
    collectives: dict[str, int] | None = None
    provenance: dict | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def capture_solve(res, *, route: str, b: int, niter: int | None,
                  tol: float | None, wall_us: float,
                  phases: dict[str, float] | None = None,
                  autotune: dict[str, int] | None = None,
                  collectives: dict[str, int] | None = None
                  ) -> SolveTelemetry:
    """Build telemetry from a finished :class:`SolveResult`.

    Reads ``iters_taken``/``achieved_rtol`` off the device (a sync —
    acceptable because this only runs when tracing is on).
    """
    from repro_torch.obs import trace

    iters = int(_host_max(res.iters_taken))
    rtol = float(_host_max(res.achieved_rtol))
    return SolveTelemetry(
        route=route, pipeline=res.pipeline, precond=res.precond, b=b,
        niter=niter, tol=tol, iters=iters, achieved_rtol=rtol,
        wall_us=wall_us, phases=dict(phases or {}),
        autotune=dict(autotune or {}), collectives=collectives,
        provenance=trace.provenance())


def _host_max(v) -> float:
    """Max of a scalar, a sequence or a tensor (on any device), on the
    host."""
    import numpy as np
    import torch

    if isinstance(v, torch.Tensor):
        return float(v.detach().to("cpu", torch.float64).max())
    return float(np.max(np.asarray(v)))


def measure_collectives(fn, *args, **kwargs) -> dict[str, int]:
    """Collective calls of ``fn(*args, **kwargs)`` by kind (``ppermute``,
    ``psum``, ``all_gather``; kinds with no call left out), read from the
    counter of :mod:`repro_torch.distributed.sharding`.  The reference
    traces ``fn`` and counts the primitives of its jaxpr; here ``fn`` runs,
    on every shard of its mesh together."""
    from repro_torch.distributed.sharding import collective_log

    with collective_log() as log:
        fn(*args, **kwargs)
    return log.counts


# ---------------------------------------------------------------------------
# histograms + service metrics
# ---------------------------------------------------------------------------

class Histogram:
    """Fixed-boundary histogram with summary stats.

    ``bounds`` are the upper edges of the finite buckets; everything
    above the last edge lands in the ``+inf`` bucket.  Snapshot is plain
    JSON: counts per bucket plus count/mean/min/max.
    """

    __slots__ = ("bounds", "bucket_counts", "n", "total", "vmin", "vmax")

    def __init__(self, bounds):
        self.bounds = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError("Histogram needs at least one bucket bound")
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        i = 0
        for i, edge in enumerate(self.bounds):  # noqa: B007
            if v <= edge:
                break
        else:
            i = len(self.bounds)
        self.bucket_counts[i] += 1
        self.n += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def snapshot(self) -> dict:
        labels = [f"le_{edge:g}" for edge in self.bounds] + ["inf"]
        return {"count": self.n,
                "mean": (self.total / self.n) if self.n else None,
                "min": self.vmin if self.n else None,
                "max": self.vmax if self.n else None,
                "buckets": dict(zip(labels, self.bucket_counts))}


# dispatch latency in ms (the reference's decade edges) and batch occupancy
# as a fraction of max_b.
_LATENCY_BOUNDS_MS = (1.0, 10.0, 100.0, 1_000.0, 10_000.0)
_OCCUPANCY_BOUNDS = (0.25, 0.5, 0.75, 1.0)


class ServiceMetrics:
    """Queue/dispatch metrics for :class:`~repro_torch.launch.
    solver_service.SolverService` — always-on host counters,
    JSON-snapshot-able."""

    def __init__(self):
        self.queue_depth = 0
        self.queue_high_water = 0
        self.submitted = 0
        self.dispatches = 0
        self.requests_served = 0
        self.latency_ms = Histogram(_LATENCY_BOUNDS_MS)
        self.occupancy = Histogram(_OCCUPANCY_BOUNDS)
        self.per_bucket: dict[tuple, dict] = {}

    # -- queue ----------------------------------------------------------
    def observe_submit(self, depth: int) -> None:
        self.submitted += 1
        self.observe_depth(depth)

    def observe_depth(self, depth: int) -> None:
        self.queue_depth = depth
        self.queue_high_water = max(self.queue_high_water, depth)
        from repro_torch.obs import trace

        trace.gauge("service.queue_depth", depth)

    # -- dispatch -------------------------------------------------------
    def observe_dispatch(self, bucket: tuple, batch: int, max_b: int,
                         wall_us: float) -> None:
        ms = wall_us / 1e3
        occ = batch / max(max_b, 1)
        self.dispatches += 1
        self.requests_served += batch
        self.latency_ms.record(ms)
        self.occupancy.record(occ)
        per = self.per_bucket.get(bucket)
        if per is None:
            per = self.per_bucket[bucket] = {
                "latency_ms": Histogram(_LATENCY_BOUNDS_MS),
                "occupancy": Histogram(_OCCUPANCY_BOUNDS),
            }
        per["latency_ms"].record(ms)
        per["occupancy"].record(occ)
        from repro_torch.obs import trace

        trace.count("service.dispatches")
        trace.count("service.requests", batch)

    # -- export ---------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "queue_depth": self.queue_depth,
            "queue_high_water": self.queue_high_water,
            "submitted": self.submitted,
            "dispatches": self.dispatches,
            "requests_served": self.requests_served,
            "latency_ms": self.latency_ms.snapshot(),
            "occupancy": self.occupancy.snapshot(),
            "per_bucket": {repr(k): {name: h.snapshot()
                                     for name, h in v.items()}
                           for k, v in self.per_bucket.items()},
        }
