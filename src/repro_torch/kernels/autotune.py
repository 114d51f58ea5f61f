"""The fused-CG pipeline pick (``ax_impl="auto"``), with a persistent cache.

The port's counterpart of the reference's ``kernels/autotune.py``: its
cache layer and :func:`pick_pipeline`.  The reference's slab pickers
(``vmem_block_e``, ``pick_block_e``, ``pick_slab_sz*``,
``pick_slab_config``, ``pick_sstep_config``, ``pick_cheb_config``) size
Pallas slabs against a VMEM budget and have no counterpart here: the port's
planners (``kernels/nekbone_ax.py``, ``k1_plan`` .. ``k12_plan``) derive
each launch from the card's occupancy (PERF.md says, picker by picker, what
serves that role).

:func:`pick_pipeline` resolves ``NekboneCase(ax_impl="auto")`` to
``"pallas_fused_cg"`` (v1, K3) or ``"pallas_fused_cg_v2"`` (v2, K4 + K5):

* preconditioned cases always pick v2 (the fused PCG drivers exist only
  there);
* on the card one v1 iteration is timed against one v2 iteration on the
  real case shape and precision policy
  (:func:`repro_torch.kernels.timing.measure`, the solve's one-time set-up
  taken out), the faster wins, and the pick is cached;
* on the CPU, or with no measure, v2: it was the faster at every E the
  card was measured at (see :func:`pick_pipeline`).

Picks are memoized in the process and — for *measured* picks only —
persisted as JSON in ``$REPRO_CACHE_DIR/autotune_torch.json`` (default
``~/.cache/repro``).  The file is the port's own: the reference's
``autotune.json`` beside it is never read, written or cleared here.  Every
key carries the device's name (``torch.cuda.get_device_name``, or
``"cpu"``), so a pick measured on one card never serves another.  An
unreadable or malformed file is ignored and rewritten at the next measured
pick; ``clear_cache`` wipes both layers (``disk=False`` keeps the file).
"""
from __future__ import annotations

import json
import os
import pathlib
import threading
from typing import Callable

import torch

from repro_torch.kernels import timing as _timing

__all__ = ["pick_pipeline", "clear_cache", "cache_info", "cache_path",
           "cache_stats", "device_name"]

_CACHE: dict[tuple, object] = {}
_MEASURED: set[tuple] = set()     # keys whose value came from a timing
_LOCK = threading.Lock()
_DISK_LOADED = False
# hit/miss totals for the telemetry layer (obs/metrics.SolveTelemetry
# reports the per-solve delta); guarded by _LOCK like the cache itself.
_STATS = {"hits": 0, "misses": 0}

PIPELINES = ("pallas_fused_cg", "pallas_fused_cg_v2")


# ---------------------------------------------------------------------------
# disk persistence
# ---------------------------------------------------------------------------

def cache_path() -> pathlib.Path:
    """Location of the port's on-disk autotune cache (JSON)."""
    root = os.environ.get("REPRO_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro")
    return pathlib.Path(root) / "autotune_torch.json"


def _load_disk_locked() -> None:
    """Merge the disk cache into memory once per process (caller holds the
    lock).  A missing, unreadable or corrupt file is ignored."""
    global _DISK_LOADED
    if _DISK_LOADED:
        return
    _DISK_LOADED = True
    try:
        raw = json.loads(cache_path().read_text())
        entries = raw["entries"]
    except (OSError, ValueError, KeyError, TypeError):
        return
    for item in entries:
        try:
            key, val = tuple(item["key"]), item["value"]
        except (KeyError, TypeError):
            continue
        if isinstance(val, str) and val in PIPELINES:
            _CACHE.setdefault(key, val)
            _MEASURED.add(key)     # the file only ever holds measured picks


def _save_disk_locked() -> None:
    """Atomically rewrite the disk cache with the measured picks (caller
    holds the lock).  A read-only cache directory leaves the picks in
    memory only."""
    path = cache_path()
    entries = [{"key": list(k), "value": v}
               for k, v in sorted(_CACHE.items(), key=lambda kv: str(kv[0]))
               if k in _MEASURED]
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps({"version": 1, "entries": entries},
                                  indent=1))
        tmp.replace(path)
    except OSError:
        pass


def cache_stats() -> dict:
    """Process-lifetime autotune cache counters ``{"hits", "misses"}``."""
    with _LOCK:
        return dict(_STATS)


def _cached_pick(key: tuple, pick: Callable[[], tuple]):
    """Lookup -> pick -> memoize (+ persist if measured).

    ``pick`` runs only on a miss (it may build a case and time it) and
    returns ``(best, measured)``.
    """
    from repro_torch.obs import trace

    with _LOCK:
        _load_disk_locked()
        if key in _CACHE:
            _STATS["hits"] += 1
            trace.count("autotune.cache_hits")
            return _CACHE[key]
        _STATS["misses"] += 1
    trace.count("autotune.cache_misses")

    best, measured = pick()

    with _LOCK:
        _CACHE.setdefault(key, best)
        if measured:
            _MEASURED.add(key)
            _save_disk_locked()
        return _CACHE[key]


def device_name(device) -> str:
    """The name a cache key carries: the card's, or ``"cpu"``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


# ---------------------------------------------------------------------------
# pipeline dispatch (NekboneCase ax_impl="auto")
# ---------------------------------------------------------------------------

# iterations the measure adds to a one-iteration solve to time one
# iteration without the solve's set-up
MEASURE_ITERS = 10


def _default_measure_pipeline(grid: tuple[int, int, int], n: int, dtype,
                              device, precision=None
                              ) -> Callable[[str], float]:
    """Times one CG iteration of each pipeline on the real case shape and
    precision policy (manufactured right-hand side), in seconds: the median
    time of a ``1 + MEASURE_ITERS``-iteration solve less that of a
    one-iteration solve, over ``MEASURE_ITERS``.  Each solve is the case's
    own (``NekboneCase.solve`` through the routing table), so a refined
    policy times its refinement route.  The difference takes out the
    set-up a solve pays once (operands, factors, the first residual), which
    on the card outweighs an iteration of either pipeline (PERF.md §6);
    each time is a median of 3 after 1 warmup, each solve ending in
    a synchronize."""
    from repro_torch.core.nekbone import NekboneCase

    cases = {p: NekboneCase(n=n, grid=tuple(grid), dtype=dtype, ax_impl=p,
                            precision=precision, device=device)
             for p in PIPELINES}
    _, b = cases[PIPELINES[0]].manufactured()

    def solve(pipeline: str, niter: int):
        return cases[pipeline].solve(b, niter=niter).x

    def measure(pipeline: str) -> float:
        t1 = _timing.measure(solve, pipeline, 1, reps=3, warmup=1)
        tm = _timing.measure(solve, pipeline, 1 + MEASURE_ITERS, reps=3,
                             warmup=1)
        return (tm - t1) / MEASURE_ITERS

    return measure


def pick_pipeline(grid: tuple[int, int, int], n: int,
                  dtype: torch.dtype = torch.float32, *, precision=None,
                  device=None, precond: str | None = None,
                  measure=None) -> str:
    """The measured-fastest fused-CG pipeline for a case, memoized.

    Returns an ``ax_impl`` name: ``"pallas_fused_cg"`` (v1) or
    ``"pallas_fused_cg_v2"``.  Preconditioned cases always resolve to v2,
    without a cache entry.  On the card (``device=None`` is the card), or
    with an explicit ``measure(pipeline) -> seconds``, both pipelines are
    timed with the case's ``precision`` policy and the faster wins,
    persisted per policy and device name.  On the CPU without a measure
    the pick is v2, unpersisted: on an NVIDIA H100 80GB HBM3 at 700.00 W
    this module's measure (fp64, n = 10) timed v2 at 0.145-0.320 ms an
    iteration and v1 at 0.254-0.835 ms over E = 1, 8, 64, 512 and 1024, v2
    the faster at every E in three runs (PERF.md §6), so no element
    count picks v1.
    """
    if precond is not None:
        return "pallas_fused_cg_v2"
    device = torch.device("cuda" if device is None else device)
    ex, ey, ez = grid
    dname = str(dtype).removeprefix("torch.")
    if precision is not None:
        from repro_torch.core.precision import resolve_policy

        precision = resolve_policy(precision).name
    key = ("pipeline", n, ex, ey, ez, dname,
           dname if precision is None else precision, device_name(device))

    def pick() -> tuple:
        m = measure
        if m is None and device.type == "cuda":
            m = _default_measure_pipeline(grid, n, dtype, device, precision)
        if m is None:
            return "pallas_fused_cg_v2", False
        return min(PIPELINES, key=m), True

    return _cached_pick(key, pick)


# ---------------------------------------------------------------------------
# cache maintenance
# ---------------------------------------------------------------------------

def clear_cache(*, disk: bool = True) -> None:
    """Forget all memoized picks; also removes the port's disk cache unless
    ``disk=False`` (tests use that to exercise the reload path)."""
    global _DISK_LOADED
    with _LOCK:
        _CACHE.clear()
        _MEASURED.clear()
        _DISK_LOADED = False           # next pick re-merges the file, if any
        if disk:
            cache_path().unlink(missing_ok=True)


def cache_info() -> dict[tuple, str]:
    """Snapshot of the memoized picks (for tests / diagnostics)."""
    with _LOCK:
        return dict(_CACHE)
