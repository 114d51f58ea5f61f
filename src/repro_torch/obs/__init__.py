"""Solver observability: structured traces and metrics.

Two layers, both zero-overhead when tracing is off (the reference's
``obs/``, without its jaxpr-walking drift check: ROADMAP.md queue 1 item
13):

* :mod:`repro_torch.obs.trace` — span/event/counter/gauge API writing JSONL
  trace files with a versioned schema, behind a context-local
  :class:`~repro_torch.obs.trace.Recorder`.
* :mod:`repro_torch.obs.metrics` — per-solve
  :class:`~repro_torch.obs.metrics.SolveTelemetry` (attached to
  ``SolveResult`` when tracing is on) and the solver service's
  queue/dispatch metrics.
"""
from repro_torch.obs import trace  # noqa: F401  (re-export the core surface)
from repro_torch.obs.trace import (  # noqa: F401
    Recorder, active, count, event, gauge, provenance, recording, span,
)

__all__ = ["trace", "Recorder", "active", "count", "event", "gauge",
           "provenance", "recording", "span"]
