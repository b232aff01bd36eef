"""Render measured traces in the simulator's event vocabulary.

Port of ``repro/obs/export.py``.  :func:`trace_view` reshapes a
:class:`~repro_torch.obs.trace.TraceRecorder` into the duck type
:func:`repro_torch.core.analytics.chrome_trace` consumes —
a ``timeline`` of ``(engine, start, end, label)`` spans in seconds plus
``makespan``/``tflops`` — using the *same* engine names and labels the
simulators emit (``h2d``/``cmp``/``d2h``/``dsk`` at ndev=1;
``d{d}:h2d|cmp|d2h``, shared ``link`` and ``dsk``, and ``d{d}:pipe``
ahead/trail lanes at lookahead>0 for ndev>1).  That shared vocabulary is
the point: a measured chrome trace opens side-by-side with the simulated
one and the lanes line up.

:func:`chrome_trace_measured` is the one-call path to chrome://tracing
JSON; :func:`write_jsonl` emits the raw spans as a JSON-lines structured
event log (one object per line — greppable, streamable, no schema
beyond the :class:`~repro_torch.obs.trace.Span` fields).
"""
from __future__ import annotations

import json

_COMPUTE = {"syrk", "gemm", "potrf", "trsm"}
# dispatch phases emitted ahead of the trailing update (must match
# analytics.simulate_multi's _AHEAD_PHASES)
_AHEAD_PHASES = {"push", "recv-ahead", "advance"}


class _TraceView:
    """Measured-trace adapter satisfying the ``chrome_trace`` duck type
    (``timeline`` + ``makespan`` + ``tflops``)."""

    def __init__(self, timeline, makespan, flops_useful):
        self.timeline = timeline
        self.makespan = makespan
        self.flops_useful = flops_useful

    @property
    def tflops(self) -> float:
        if self.makespan <= 0:
            return 0.0
        return self.flops_useful / self.makespan / 1e12


def _engine_label(span, ndev):
    """Map one measured span onto the simulator's (engine, label) pair."""
    k, d, i, j = span.kind, span.device, span.i, span.j
    if ndev == 1:
        if k == "load":
            return "h2d", f"L{i},{j}"
        if k == "store":
            return "d2h", f"S{i},{j}"
        if k == "fetch":
            return "dsk", f"F{i},{j}"
        if k == "spill":
            return "dsk", f"W{i},{j}"
        return "cmp", k if k in _COMPUTE else k
    if k == "load":
        return f"d{d}:h2d", f"L{i},{j}"
    if k == "store":
        return f"d{d}:d2h", f"S{i},{j}"
    if k == "fetch":
        return "dsk", f"F{i},{j}@d{d}"
    if k == "spill":
        return "dsk", f"W{i},{j}@d{d}"
    if k == "recv":
        return "link", f"B{i},{j}->d{d}"
    return f"d{d}:cmp", k


def trace_view(trace) -> _TraceView:
    """Build a simulator-shaped view of a measured trace.

    Spans are rebased to the trace's first start (``t=0``) and converted
    to seconds; engines/labels follow the simulator vocabulary for the
    trace's ``meta["ndev"]`` (inferred from span devices when unset).
    At ``lookahead > 0`` every compute span is mirrored onto its
    device's ``d{d}:pipe`` lane with the ``ahead:``/``trail:`` prefix
    :func:`~repro_torch.core.analytics.chrome_trace` colors.
    """
    spans = trace.spans
    meta = getattr(trace, "meta", {}) or {}
    ndev = meta.get("ndev") or (max((s.device for s in spans), default=0) + 1)
    lookahead = meta.get("lookahead", 0)
    if not spans:
        return _TraceView([], 0.0, 0.0)
    t0 = min(s.t_start for s in spans)
    timeline = []
    for s in spans:
        engine, label = _engine_label(s, ndev)
        start = (s.t_start - t0) / 1e9
        end = (s.t_end - t0) / 1e9
        timeline.append((engine, start, end, label))
        if ndev > 1 and lookahead > 0 and s.kind in _COMPUTE:
            tag = "ahead" if s.phase in _AHEAD_PHASES else "trail"
            timeline.append((f"d{s.device}:pipe", start, end,
                             f"{tag}:{s.kind}"))
    makespan = max(e for _, _, e, _ in timeline)
    n = meta.get("n", 0)
    return _TraceView(timeline, makespan, n**3 / 3.0)


def chrome_trace_measured(trace, path=None) -> dict:
    """Export a measured trace as chrome://tracing JSON (reusing
    :func:`repro_torch.core.analytics.chrome_trace`'s event emission, so
    the lanes/colors match the simulated traces).  Returns the trace
    dict; with ``path`` it is also written there."""
    from ..core.analytics import chrome_trace
    view = trace_view(trace)
    if not view.timeline:
        raise ValueError("empty trace: run factor(..., trace=recorder) "
                         "before exporting")
    return chrome_trace(view, path)


def write_jsonl(trace, path) -> int:
    """Write the trace as a JSON-lines event log: one header line with
    the run ``meta`` + ``dropped``, then one object per span.  Returns
    the number of span lines written."""
    spans = trace.spans
    meta = getattr(trace, "meta", {}) or {}
    with open(path, "w") as f:
        f.write(json.dumps({"event": "meta", "meta": meta,
                            "spans": len(spans),
                            "dropped": getattr(trace, "dropped", 0)}) + "\n")
        for s in spans:
            f.write(json.dumps({
                "event": "span", "op_index": s.op_index, "kind": s.kind,
                "device": s.device, "t_start": s.t_start, "t_end": s.t_end,
                "bytes": s.bytes, "cls": s.cls, "i": s.i, "j": s.j,
                "phase": s.phase,
            }) + "\n")
    return len(spans)
