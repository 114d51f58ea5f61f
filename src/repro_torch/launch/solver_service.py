"""Solver service: queued solve requests, bucketed onto batched solves.

The port of the reference's ``launch/solver_service.py``, the serving
entry point of the multi-RHS path: clients submit single right-hand sides;
the service groups compatible requests — same (grid, n, dtype, precision,
precond, stopping rule) — into buckets and dispatches each bucket as ONE
solve of batch up to ``max_b`` through the routing table
(:func:`repro_torch.core.solvers.solve_case`).  An unpreconditioned v2
bucket runs the batched kernels K6 + K7 (route ``block``), which read the
shared operator streams once for the batch
(:func:`repro_torch.core.cost.multi_rhs_streams`); a preconditioned one
runs each right-hand side through its own route (``block_loop``).

Rules (pinned by tests/test_torch_solver_service.py):
  * requests in *different* buckets are never co-scheduled — a dispatch
    contains one bucket only;
  * a bucket with more than ``max_b`` pending requests splits into
    ceil(k / max_b) dispatches (overflow never silently truncates);
  * ``drain()`` on an empty queue returns ``[]`` and dispatches nothing;
  * results come back in submission order, each carrying its request id.

Warm start: :meth:`SolverService.warm_start` builds each case, resolves
``ax_impl="auto"`` through the autotune cache
(``$REPRO_CACHE_DIR/autotune_torch.json`` persists measured picks across
processes) and runs one solve per expected (case, batch), taking the
kernels' first-use ``nvcc`` build, their launch plans and the pipeline
measurement off the first request's latency.

Every case lives on the service's ``device`` (``None``: the card).  A
build or launch failure raises; nothing falls back.

Bench: ``python -m repro_torch.launch.solver_service --requests 16
--max-b 8`` prints each batch's request latency (p50, p99: submit to the
synchronize after its dispatch) and its throughput over the whole window
(requests/s, and ms per request as its inverse).
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import math
import time
from typing import Any

import torch

from repro_torch.core.cg import SolveResult

__all__ = ["SolveRequest", "ServiceResult", "DispatchRecord",
           "SolverService", "bench_service"]


@dataclasses.dataclass
class SolveRequest:
    """One queued solve: a right-hand side plus its case/stopping params.

    ``config`` is a :class:`repro_torch.configs.nekbone.NekboneConfig`
    (the case is instantiated once per distinct case key and cached).
    ``precond=None`` inherits the config's preconditioner; pass a
    registry name to override (the boolean spellings are deprecated at
    the solve layer and not accepted here).
    """

    f: Any                                  # (E, n, n, n) rhs (a tensor)
    config: Any                             # NekboneConfig
    niter: int | None = None
    tol: float = 1e-8
    max_iter: int = 1000
    precond: str | None = None
    request_id: int = -1                    # assigned by submit()


@dataclasses.dataclass
class ServiceResult:
    """Per-request outcome of a dispatched bucket solve."""

    request_id: int
    x: Any
    history: Any
    iters_taken: Any
    achieved_rtol: Any
    rnorm: Any
    pipeline: str | None
    precond: str | None
    bucket: tuple                           # the bucket key it ran under
    batch_size: int                         # b of the dispatch it rode in
    batch_index: int                        # its lane in that dispatch
    telemetry: Any = None                   # the dispatch's, when tracing


@dataclasses.dataclass(eq=False)
class DispatchRecord:
    """One dispatched batch: the audit row of ``SolverService.dispatch_log``.

    The typed fields feed :class:`repro_torch.obs.metrics.ServiceMetrics`
    and the trace.  The reference's tuple shim is kept: iterating or
    indexing a record yields ``(bucket, request_ids)`` and records compare
    equal to that tuple — new code should use the named fields.
    """

    bucket: tuple
    request_ids: list
    batch_size: int = 0
    wall_us: float = 0.0
    pipeline: str | None = None
    done_s: float = 0.0       # time.perf_counter() once its solve finished

    def __post_init__(self):
        if not self.batch_size:
            self.batch_size = len(self.request_ids)

    # -- legacy (bucket, request_ids) tuple protocol --------------------
    def __iter__(self):
        return iter((self.bucket, self.request_ids))

    def __len__(self) -> int:
        return 2

    def __getitem__(self, i):
        return (self.bucket, self.request_ids)[i]

    def __eq__(self, other):
        if isinstance(other, tuple):
            return (self.bucket, self.request_ids) == other
        if isinstance(other, DispatchRecord):
            return ((self.bucket, self.request_ids)
                    == (other.bucket, other.request_ids))
        return NotImplemented

    def __hash__(self):
        return hash((self.bucket, tuple(self.request_ids)))


def _bucket_key(req: SolveRequest) -> tuple:
    """Compatibility key: everything that must match for two requests to
    share one batched solve (same compiled case + same stopping rule)."""
    cfg = req.config
    pc = req.precond if req.precond is not None else cfg.precond
    stop = (("niter", req.niter) if req.niter is not None
            else ("tol", float(req.tol), req.max_iter))
    return (tuple(cfg.grid), cfg.n, str(cfg.dtype), cfg.ax_impl,
            cfg.precision, pc, cfg.s, cfg.cheb_k, stop)


def _case_key(cfg) -> tuple:
    return (tuple(cfg.grid), cfg.n, str(cfg.dtype), cfg.ax_impl,
            cfg.precision, cfg.precond, cfg.s, cfg.cheb_k)


class SolverService:
    """Request queue + bucketed batch dispatch over the routing table.

    ``device`` is where every case of the service lives (``None``: the
    card; ``"cpu"`` runs the plain versions, as the tests do).
    """

    def __init__(self, *, max_b: int = 8, device=None):
        if max_b < 1:
            raise ValueError(f"max_b must be >= 1, got {max_b}")
        from repro_torch.obs.metrics import ServiceMetrics

        self.max_b = max_b
        self.device = device
        self._queue: list[SolveRequest] = []
        self._next_id = itertools.count()
        self._cases: dict[tuple, Any] = {}
        # One DispatchRecord per dispatched batch, in dispatch order —
        # the audit trail the scheduling tests pin.
        self.dispatch_log: list[DispatchRecord] = []
        # always-on queue/dispatch metrics: a handful of host floats per
        # dispatch, JSON-snapshot-able.
        self.metrics = ServiceMetrics()

    # ------------------------------------------------------------------
    @property
    def pending(self) -> int:
        return len(self._queue)

    def submit(self, req: SolveRequest) -> int:
        """Enqueue one request; returns its assigned request id."""
        rid = next(self._next_id)
        req.request_id = rid
        self._queue.append(req)
        self.metrics.observe_submit(len(self._queue))
        return rid

    # ------------------------------------------------------------------
    def _case_for(self, cfg):
        key = _case_key(cfg)
        case = self._cases.get(key)
        if case is None:
            case = cfg.make_case(device=self.device)
            self._cases[key] = case
        return case

    def _dispatch(self, bucket: tuple, chunk: list[SolveRequest]
                  ) -> list[ServiceResult]:
        from repro_torch.core import solvers as solvers_mod
        from repro_torch.kernels.timing import stopwatch
        from repro_torch.obs import trace as _trace

        case = self._case_for(chunk[0].config)
        first = chunk[0]
        f = torch.stack([torch.as_tensor(r.f, dtype=case.dtype,
                                         device=case.device)
                         for r in chunk])
        rec = _trace.active()
        sw = stopwatch()
        with (rec.span("service.dispatch", batch=len(chunk),
                       max_b=self.max_b)
              if rec is not None else _trace.NULL_SPAN):
            res: SolveResult = solvers_mod.solve_case(
                case, f, b=len(chunk), niter=first.niter, tol=first.tol,
                max_iter=first.max_iter, precond=first.precond)
            _sync(res.x)
        wall = sw.us()
        self.dispatch_log.append(DispatchRecord(
            bucket=bucket, request_ids=[r.request_id for r in chunk],
            batch_size=len(chunk), wall_us=wall, pipeline=res.pipeline,
            done_s=time.perf_counter()))
        self.metrics.observe_dispatch(bucket, len(chunk), self.max_b, wall)

        def lane(a, j):
            return a[j] if a.ndim and a.shape[0] == len(chunk) else a

        return [ServiceResult(
            request_id=r.request_id, x=res.x[j],
            history=lane(res.history, j),
            iters_taken=lane(res.iters_taken, j),
            achieved_rtol=lane(res.achieved_rtol, j),
            rnorm=lane(res.rnorm, j), pipeline=res.pipeline,
            precond=res.precond, bucket=bucket, batch_size=len(chunk),
            batch_index=j, telemetry=res.telemetry)
            for j, r in enumerate(chunk)]

    def drain(self) -> list[ServiceResult]:
        """Dispatch everything queued; results in submission order.

        Buckets are formed over the *current* queue contents; each bucket
        splits into chunks of at most ``max_b`` (in submission order) and
        each chunk is one batched solve.
        """
        if not self._queue:
            return []
        queue, self._queue = self._queue, []
        self.metrics.observe_depth(0)
        buckets: dict[tuple, list[SolveRequest]] = {}
        for req in queue:
            buckets.setdefault(_bucket_key(req), []).append(req)
        out: dict[int, ServiceResult] = {}
        for bucket, reqs in buckets.items():
            for lo in range(0, len(reqs), self.max_b):
                for sr in self._dispatch(bucket, reqs[lo:lo + self.max_b]):
                    out[sr.request_id] = sr
        return [out[r.request_id] for r in queue]

    # ------------------------------------------------------------------
    def warm_start(self, configs, *, batches=None, niter: int = 1) -> int:
        """Build, tune and run the expected (case, batch) shapes once.

        For every config: builds its case on the service's device (an
        ``ax_impl="auto"`` config resolves through
        ``autotune.pick_pipeline``, which on the card measures v1 against
        v2 once and caches the pick in ``$REPRO_CACHE_DIR``), then runs one
        ``niter``-iteration solve of its manufactured right-hand side at
        each batch size.  On the card that takes the kernels' first-use
        build and their launch plans off the first request.  Returns the
        number of (case, b) combinations warmed.
        """
        from repro_torch.core import solvers as solvers_mod

        batches = sorted(set(batches or (1, self.max_b)))
        warmed = 0
        for cfg in configs:
            case = self._case_for(cfg)
            _, f1 = case.manufactured()
            for b in batches:
                f = f1[None] if b == 1 else torch.stack([f1] * b)
                res = solvers_mod.solve_case(case, f, b=b, niter=niter)
                _sync(res.x)
                warmed += 1
        return warmed


def _sync(x) -> None:
    """Wait for the card when ``x`` lives there."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


# ---------------------------------------------------------------------------
# latency / throughput bench
# ---------------------------------------------------------------------------

def _nearest_rank(values, q: float) -> float:
    """The ``q``-quantile of ``values`` by nearest rank (no interpolation:
    always a value that was observed)."""
    v = sorted(values)
    return v[min(len(v), max(1, math.ceil(round(q * len(v), 9)))) - 1]


def bench_service(*, nelt: int = 64, n: int | None = None,
                  requests: int = 16, max_b: int = 8,
                  niter: int = 25, warm: bool = True,
                  repeats: int = 3, dtype: str | None = None,
                  device=None) -> dict:
    """Measure request latency and drain throughput at several batches.

    Submits ``requests`` manufactured-RHS requests of the paper case with
    ``nelt`` elements and drains with ``max_b`` in {1, ..., max_b}: b=1 is
    the sequential baseline (one solve per request), larger b amortizes
    the operator streams; this is done ``repeats`` times per b.  A
    request's latency is the host clock from its ``submit`` to the
    synchronize after its dispatch's solve; a drain's time runs from its
    start to that synchronize after its last solve.  Returns
    ``{str(b): {latency_ms_p50, latency_ms_p99, latency_ms_max,
    ms_per_request, throughput_req_s, dispatches}}`` plus the case and the
    device's name: the latencies are quantiles over every request of every
    repeat, the throughput is all the requests over the sum of all the
    drains' times, and ``ms_per_request`` is its inverse.
    """
    from repro_torch.configs.nekbone import paper_case
    from repro_torch.kernels.autotune import device_name

    cfg = paper_case(nelt)
    if n is not None:
        cfg = dataclasses.replace(cfg, n=n)
    cfg = dataclasses.replace(cfg, ax_impl="pallas_fused_cg_v2")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    case = cfg.make_case(device=device)
    _, f1 = case.manufactured()
    rows: dict[str, dict] = {}
    bs = sorted({b for b in (1, 2, 4, 8) if b <= max_b} | {max_b})
    for b in bs:
        svc = SolverService(max_b=b, device=device)
        svc._cases[_case_key(cfg)] = case
        if warm:
            svc.warm_start([cfg], batches=[min(b, requests)], niter=niter)
        window = 0.0
        latencies = []
        dispatches = 0
        for _ in range(repeats):
            submitted = {}
            for _ in range(requests):
                rid = svc.submit(SolveRequest(f=f1, config=cfg, niter=niter))
                submitted[rid] = time.perf_counter()
            t0 = time.perf_counter()
            results = svc.drain()
            _sync(results[-1].x)
            window += time.perf_counter() - t0
            latencies += [d.done_s - submitted[rid]
                          for d in svc.dispatch_log for rid in d.request_ids]
            dispatches = len(svc.dispatch_log)
            svc.dispatch_log.clear()
        rows[str(b)] = {
            "latency_ms_p50": _nearest_rank(latencies, 0.50) * 1e3,
            "latency_ms_p99": _nearest_rank(latencies, 0.99) * 1e3,
            "latency_ms_max": max(latencies) * 1e3,
            "ms_per_request": window * 1e3 / (requests * repeats),
            "throughput_req_s": requests * repeats / window,
            "dispatches": dispatches,
        }
    return {"nelt": cfg.nelt, "n": cfg.n, "dtype": cfg.dtype,
            "niter": niter, "requests": requests, "repeats": repeats,
            "device": device_name(case.device), "rows": rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nelt", type=int, default=64)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-b", type=int, default=8)
    ap.add_argument("--niter", type=int, default=25)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--dtype", default=None,
                    help="float64 or float32 (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args()
    payload = bench_service(nelt=args.nelt, n=args.n,
                            requests=args.requests, max_b=args.max_b,
                            niter=args.niter, repeats=args.repeats,
                            dtype=args.dtype, device=args.device)
    print(f"[solver-service] E={payload['nelt']} n={payload['n']} "
          f"{payload['dtype']} niter={payload['niter']} "
          f"requests={payload['requests']} ({payload['device']})")
    for b, row in payload["rows"].items():
        print(f"  b<={b:>2}: latency p50 {row['latency_ms_p50']:8.2f} ms  "
              f"p99 {row['latency_ms_p99']:8.2f} ms  "
              f"{row['ms_per_request']:8.2f} ms/request  "
              f"{row['throughput_req_s']:8.2f} req/s  "
              f"({row['dispatches']} dispatches)")


if __name__ == "__main__":
    main()
