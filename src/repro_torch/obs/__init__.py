"""repro_torch.obs — measured runtime tracing, drift analysis, and metrics.

Port of ``repro/obs``.  Three layers, one import:

- :mod:`repro_torch.obs.trace` — :class:`TraceRecorder` ring buffer; pass
  one as ``OOCSolver.factor(a, trace=rec)`` and every executor records
  one measured :class:`Span` per schedule op (on a card, fenced with a
  synchronize of the op's CUDA stream).  The :data:`NULL` recorder is the
  zero-cost default.
- :mod:`repro_torch.obs.export` / :mod:`repro_torch.obs.drift` — render
  measured traces as chrome://tracing JSON in the simulator's lane
  vocabulary, and align them op-by-op against
  ``simulate``/``simulate_multi`` into a :class:`DriftReport` (per-kind
  ratios, top mispredictions, overlap efficiency).
- :mod:`repro_torch.obs.metrics` — the process-wide :data:`REGISTRY`
  absorbing plan-cache stats and solver counters under one
  :func:`snapshot` / :func:`render_text`.
"""
from .drift import MODELED_KINDS, DriftReport, drift_report, total_abs_error
from .export import chrome_trace_measured, trace_view, write_jsonl
from .metrics import REGISTRY, MetricsRegistry, render_text, snapshot
from .trace import NULL, NullRecorder, Span, TraceRecorder, is_active, resolve

__all__ = [
    "TraceRecorder", "NullRecorder", "Span", "NULL", "resolve", "is_active",
    "chrome_trace_measured", "trace_view", "write_jsonl",
    "DriftReport", "drift_report", "total_abs_error", "MODELED_KINDS",
    "MetricsRegistry", "REGISTRY", "snapshot", "render_text",
]
