"""The port's timing helpers: one module for every measured time.

The reference's ``kernels/timing.py`` (``Stopwatch``, ``stopwatch``,
``median``, ``measure``) with the same contract, plus the two device
timers ``chip_smoke.py`` has used since the port began:

* :func:`measure` — median wall-clock seconds of ``sync(fn(*args))`` over
  ``reps`` calls after ``warmup`` discarded ones; ``timer`` and ``sync``
  can be injected (tests), and the *upper* median is used (timing noise
  only ever adds time).  The default ``sync`` is
  ``torch.cuda.synchronize`` when the result is a CUDA tensor or holds
  one, and a no-op otherwise.  ``kernels/autotune.pick_pipeline`` times
  through it.
* :func:`device_ms` — device time of one call: CUDA events around
  ``calls`` back-to-back calls queued behind a spin kernel, median over
  ``reps``.
* :func:`wall_ms` — host-clock time of one call that ends in a
  synchronize (what a caller waits).
* :class:`Stopwatch` — the telemetry layer's phase timer
  (``sw = stopwatch(); ...; sw.us()``).

Importing this module imports nothing but ``torch``; nothing here runs on
the card until a timer is called.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

__all__ = ["measure", "median", "stopwatch", "Stopwatch", "device_ms",
           "wall_ms", "SPIN_CYCLES"]

# about 10 ms of spin at the H100's clock: longer than the host takes to
# enqueue the calls that device_ms times after it.
SPIN_CYCLES = 20_000_000


class Stopwatch:
    """Monotonic elapsed-µs reader (``time.perf_counter_ns``)."""

    __slots__ = ("_t0",)

    def __init__(self):
        self._t0 = time.perf_counter_ns()

    def us(self) -> float:
        """Microseconds since construction."""
        return (time.perf_counter_ns() - self._t0) / 1e3


def stopwatch() -> Stopwatch:
    """Start a :class:`Stopwatch` now."""
    return Stopwatch()


def median(xs) -> float:
    """Median of a non-empty sequence (upper median for even lengths —
    the conservative choice for one-sided timing noise)."""
    xs = sorted(xs)
    if not xs:
        raise ValueError("median() of empty sequence")
    return xs[len(xs) // 2]


def _holds_cuda(x) -> bool:
    """Whether ``x`` is a CUDA tensor or holds one (sequences, dicts,
    dataclasses such as ``SolveResult``)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (list, tuple)):
        return any(_holds_cuda(v) for v in x)
    if isinstance(x, dict):
        return any(_holds_cuda(v) for v in x.values())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return any(_holds_cuda(getattr(x, f.name))
                   for f in dataclasses.fields(x))
    return False


def _default_sync(x):
    if _holds_cuda(x):
        import torch

        torch.cuda.synchronize()
    return x


def measure(fn, *args, reps: int = 5, warmup: int = 1, timer=None,
            sync=None) -> float:
    """Median wall-clock seconds of ``sync(fn(*args))`` over ``reps`` calls,
    after ``warmup`` discarded calls.

    Args:
      fn: callable under test; its (asynchronously launched) result is
        passed through ``sync`` so the work is finished inside the timed
        region.
      reps: timed repetitions (>= 1); the *median* is returned.
      warmup: discarded leading calls (first-use builds, caches; may be 0).
      timer: monotonic clock, ``time.perf_counter`` by default.
      sync: completion barrier; by default ``torch.cuda.synchronize`` when
        the result is or holds a CUDA tensor, else nothing.
    """
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    timer = time.perf_counter if timer is None else timer
    sync = _default_sync if sync is None else sync
    for _ in range(warmup):
        sync(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = timer()
        sync(fn(*args))
        ts.append(timer() - t0)
    return median(ts)


def device_ms(fn, *, calls: int = 20, reps: int = 5,
              warmup: int = 3) -> float:
    """Device time of one call of ``fn``: CUDA events around ``calls``
    back-to-back calls, median over ``reps``.  A spin kernel queued first
    lets the host enqueue all the calls before the first one runs, so the
    host's own time per call (wrapper checks, launch) stays out of it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def wall_ms(fn, *, reps: int = 5, warmup: int = 1) -> float:
    """Host-clock time of one call of ``fn`` that ends in a synchronize,
    median over ``reps`` (what a caller of ``fn`` waits)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
