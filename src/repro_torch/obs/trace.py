"""Structured solver traces: spans, events, counters -> JSONL files.

The port's copy of the reference's ``obs/trace.py``, with the same record
shapes and schema.  A :class:`Recorder` collects *host-side* spans and
events — instrumentation sits only at the host boundaries of the pipelines
(the s-step cycle loop, the refinement sweep loop, driver dispatch, service
drain); no span adds a synchronize or a device operation, so the kernels
launched are the same with tracing on or off.

Zero-overhead-when-off contract:

* the active recorder is a context-local (``contextvars``) slot, read
  once per solve at the host boundary — hot loops hold the local and
  skip every span with a single ``is None`` test;
* :func:`span` with no active recorder returns the shared
  :data:`NULL_SPAN` singleton without evaluating span attributes (the
  instrumented sites spell ``rec.span(...) if rec is not None else
  NULL_SPAN`` so even the attrs dict is never allocated);
* solve *output* is bitwise identical either way — pinned by
  tests/test_torch_obs.py and ``chip_smoke.py``'s service phase.

Trace files are JSON Lines with a versioned schema
(:data:`TRACE_SCHEMA`): a ``header`` record first (schema + provenance),
then ``span``/``event`` records in completion order, then one closing
``summary`` record (counters, gauges).  :func:`validate_trace_lines` is
the schema check ``chip_smoke.py`` and the tests share.

Opt-in ``torch.profiler`` hooks: :func:`profiler_annotation` wraps kernel
launches in ``torch.profiler.record_function`` when ``$REPRO_PROFILE`` is
set (otherwise it is the no-op span), and :func:`profiling` runs a
``torch.profiler.profile`` around a block and exports a Chrome trace into
a log dir when one is given.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import pathlib
import platform
import time
from typing import Any

__all__ = ["TRACE_SCHEMA", "TRACE_SCHEMA_VERSION", "NULL_SPAN", "Recorder",
           "recording", "active", "span", "event", "count", "gauge",
           "provenance", "machine_tag", "validate_trace_lines",
           "validate_trace_file", "profiler_annotation", "profiling"]

TRACE_SCHEMA = "repro-trace/1"
TRACE_SCHEMA_VERSION = 1

_RECORDER: contextvars.ContextVar["Recorder | None"] = \
    contextvars.ContextVar("repro_obs_recorder", default=None)


class _NullSpan:
    """Shared no-op context manager — what instrumented code enters when
    tracing is off.  A singleton: entering it allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """One timed region; records itself on ``__exit__`` (completion
    order), carrying the recorder's nesting depth at entry."""

    __slots__ = ("_rec", "name", "attrs", "_t0", "_depth")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._depth = 0

    def __enter__(self):
        rec = self._rec
        self._depth = rec._depth
        rec._depth += 1
        self._t0 = rec.now_us()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        dur = rec.now_us() - self._t0
        rec._depth -= 1
        ev: dict[str, Any] = {"type": "span", "name": self.name,
                              "t_us": round(self._t0, 3),
                              "dur_us": round(dur, 3),
                              "depth": self._depth}
        if self.attrs:
            ev["attrs"] = self.attrs
        rec.records.append(ev)
        return False


class Recorder:
    """Collects spans/events/counters for one recording session.

    Timestamps are microseconds since the recorder's creation
    (``time.perf_counter_ns`` — monotonic, never wall-clock).  Not
    thread-safe by design: one recorder belongs to one context (the
    ``contextvars`` slot keeps concurrent contexts independent).
    """

    def __init__(self, *, meta: dict | None = None):
        self.records: list[dict] = []
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.meta = dict(meta or {})
        self._depth = 0
        self._t0 = time.perf_counter_ns()

    def now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    # -- recording ------------------------------------------------------
    def span(self, name: str, /, **attrs) -> _Span:
        """Context manager timing one host-side region."""
        return _Span(self, name, attrs)

    def event(self, name: str, /, **attrs) -> None:
        """One instantaneous record."""
        ev: dict[str, Any] = {"type": "event", "name": name,
                              "t_us": round(self.now_us(), 3),
                              "depth": self._depth}
        if attrs:
            ev["attrs"] = attrs
        self.records.append(ev)

    def count(self, name: str, value: float = 1) -> None:
        """Monotonic counter increment (totals land in the summary)."""
        self.counters[name] = self.counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        """Last-value-wins gauge (e.g. queue depth)."""
        self.gauges[name] = value

    # -- serialization --------------------------------------------------
    def header(self) -> dict:
        h = {"type": "header", "schema": TRACE_SCHEMA,
             "schema_version": TRACE_SCHEMA_VERSION,
             "provenance": provenance()}
        if self.meta:
            h["meta"] = self.meta
        return h

    def summary(self) -> dict:
        return {"type": "summary", "spans": sum(
                    1 for r in self.records if r["type"] == "span"),
                "events": sum(
                    1 for r in self.records if r["type"] == "event"),
                "counters": dict(self.counters),
                "gauges": dict(self.gauges)}

    def lines(self) -> list[str]:
        recs = [self.header(), *self.records, self.summary()]
        return [json.dumps(r, sort_keys=True, default=_jsonable)
                for r in recs]

    def write(self, path) -> pathlib.Path:
        """Write the trace as JSONL (parent dirs created)."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(self.lines()) + "\n")
        return path


def _jsonable(x):
    """Trace attrs may carry numpy or torch scalars; coerce, never crash."""
    for conv in (float, str):
        try:
            return conv(x)
        except (TypeError, ValueError):
            continue
    return repr(x)


# ---------------------------------------------------------------------------
# the context-local slot + module-level convenience surface
# ---------------------------------------------------------------------------

def active() -> Recorder | None:
    """The context's active recorder, or None when tracing is off.

    Host boundaries call this **once per solve** and thread the result
    through their loops — the per-iteration cost when off is one local
    ``is None`` test, no allocation.
    """
    return _RECORDER.get()


@contextlib.contextmanager
def recording(path=None, *, meta: dict | None = None,
              recorder: Recorder | None = None):
    """Activate a recorder for the enclosed block; yields it.

        with trace.recording("out/solve.trace.jsonl") as rec:
            repro_torch.solve(1024, niter=100)
        # rec.records / the JSONL file now hold the spans

    ``path`` (optional) writes the JSONL trace on exit — also on
    exception, so a failing solve still leaves its evidence.  Nested
    recordings shadow the outer recorder for their extent.
    """
    rec = recorder if recorder is not None else Recorder(meta=meta)
    token = _RECORDER.set(rec)
    try:
        yield rec
    finally:
        _RECORDER.reset(token)
        if path is not None:
            rec.write(path)


def span(name: str, /, **attrs):
    """Module-level span: records under the active recorder, or returns
    the shared no-op singleton when tracing is off."""
    rec = _RECORDER.get()
    return rec.span(name, **attrs) if rec is not None else NULL_SPAN


def event(name: str, /, **attrs) -> None:
    rec = _RECORDER.get()
    if rec is not None:
        rec.event(name, **attrs)


def count(name: str, value: float = 1) -> None:
    rec = _RECORDER.get()
    if rec is not None:
        rec.count(name, value)


def gauge(name: str, value: float) -> None:
    rec = _RECORDER.get()
    if rec is not None:
        rec.gauge(name, value)


# ---------------------------------------------------------------------------
# provenance — recorded in every trace header and in BENCH_*.json
# ---------------------------------------------------------------------------

def machine_tag() -> str:
    """Hostname-free machine fingerprint: OS, ISA, core count.

    Enough to explain "why do these timings differ" across environments
    without leaking a hostname into committed baselines or uploaded
    artifacts."""
    return "-".join((platform.system().lower() or "unknown",
                     platform.machine() or "unknown",
                     f"{os.cpu_count() or 0}cpu"))


def provenance() -> dict:
    """Where a measurement came from: machine tag, Python, torch and CUDA
    versions, and the card's name (``None`` without one)."""
    prov = {"machine": machine_tag(),
            "python": platform.python_version()}
    try:
        import torch

        prov["torch_version"] = torch.__version__
        prov["cuda_version"] = torch.version.cuda
        prov["device"] = (torch.cuda.get_device_name(0)
                          if torch.cuda.is_available() else None)
    except Exception:  # noqa: BLE001 — provenance must never sink a trace
        prov["device"] = None
    return prov


# ---------------------------------------------------------------------------
# JSONL schema validation (shared by the tests and chip_smoke.py)
# ---------------------------------------------------------------------------

_REQUIRED = {
    "header": ("schema", "schema_version", "provenance"),
    "span": ("name", "t_us", "dur_us", "depth"),
    "event": ("name", "t_us"),
    "summary": ("spans", "events", "counters", "gauges"),
}


def validate_trace_lines(lines) -> list[str]:
    """All schema violations of a JSONL trace (empty list == valid).

    Checks: every line parses as a JSON object; first record is a
    ``header`` with the known schema; last is a ``summary`` whose span
    count matches; required fields per record type; span timings are
    finite and non-negative."""
    problems: list[str] = []
    records = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            problems.append(f"line {i + 1}: not valid JSON ({e})")
            continue
        if not isinstance(rec, dict):
            problems.append(f"line {i + 1}: not a JSON object")
            continue
        records.append((i + 1, rec))
    if not records:
        problems.append("empty trace: no records")
        return problems
    for ln, rec in records:
        typ = rec.get("type")
        if typ not in _REQUIRED:
            problems.append(f"line {ln}: unknown record type {typ!r}")
            continue
        for field in _REQUIRED[typ]:
            if field not in rec:
                problems.append(f"line {ln}: {typ} record missing "
                                f"{field!r}")
        if typ == "span":
            for field in ("t_us", "dur_us"):
                v = rec.get(field)
                if not isinstance(v, (int, float)) or v < 0 or v != v:
                    problems.append(f"line {ln}: span {field}={v!r} is "
                                    "not a non-negative number")
    first, last = records[0][1], records[-1][1]
    if first.get("type") != "header":
        problems.append("first record is not a header")
    elif first.get("schema") != TRACE_SCHEMA:
        problems.append(f"header schema {first.get('schema')!r} != "
                        f"{TRACE_SCHEMA!r}")
    if last.get("type") != "summary":
        problems.append("last record is not a summary")
    else:
        nspan = sum(1 for _, r in records if r.get("type") == "span")
        if last.get("spans") != nspan:
            problems.append(f"summary claims {last.get('spans')} spans, "
                            f"trace holds {nspan}")
    return problems


def validate_trace_file(path) -> list[str]:
    """:func:`validate_trace_lines` over a file path."""
    try:
        text = pathlib.Path(path).read_text()
    except OSError as e:
        return [f"cannot read trace file {path}: {e}"]
    return validate_trace_lines(text.splitlines())


# ---------------------------------------------------------------------------
# opt-in torch.profiler hooks
# ---------------------------------------------------------------------------

def profiler_annotation(name: str):
    """``torch.profiler.record_function(name)`` when ``$REPRO_PROFILE`` is
    set — the launches inside show up under that name on the profiler's
    timeline — else the shared no-op span."""
    if not os.environ.get("REPRO_PROFILE"):
        return NULL_SPAN
    import torch.profiler

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiling(logdir=None):
    """A ``torch.profiler.profile`` of the host and the card around a block,
    exported as a Chrome trace (``trace.json``) into ``logdir``; a no-op
    when ``logdir`` is falsy.  Yields the profiler (or None)."""
    if not logdir:
        yield None
        return
    import torch
    import torch.profiler

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))
