"""Solver observability: structured traces and metrics.

Three modules (the reference's ``obs/``); the first two cost nothing when
tracing is off:

* :mod:`repro_torch.obs.trace` — span/event/counter/gauge API writing JSONL
  trace files with a versioned schema, behind a context-local
  :class:`~repro_torch.obs.trace.Recorder`.
* :mod:`repro_torch.obs.metrics` — per-solve
  :class:`~repro_torch.obs.metrics.SolveTelemetry` (attached to
  ``SolveResult`` when tracing is on) and the solver service's
  queue/dispatch metrics.
* :mod:`repro_torch.obs.drift` — the cost-model drift check: the bytes a
  pipeline's launches and eager ops move, and the collectives it issues,
  against the ``core/cost.py`` books and the pinned contracts.
"""
from repro_torch.obs import trace  # noqa: F401  (re-export the core surface)
from repro_torch.obs.trace import (  # noqa: F401
    Recorder, active, count, event, gauge, provenance, recording, span,
)

__all__ = ["trace", "Recorder", "active", "count", "event", "gauge",
           "provenance", "recording", "span"]
