"""Model-vs-measured drift: align a measured trace against the simulator.

Port of ``repro/obs/drift.py``.  The traced executors and the event simulators replay the *same* static
op stream in the *same* dispatch order, so alignment is positional: the
k-th modeled span of the measured trace corresponds to the k-th span of
the predicted timeline.  The only bookkeeping is agreeing on which ops
produce spans — the simulators emit none for ALLOC/FREE/BCAST (and add
decorative ``d{d}:pipe`` lanes at lookahead>0), so the measured side
filters to :data:`MODELED_KINDS` and the predicted side drops pipe
lanes; after that both sequences must match kind-for-kind or the report
refuses (rather than attribute a GEMM's drift to a LOAD).

:func:`drift_report` produces a :class:`DriftReport`: per-op-kind
measured/predicted time ratios, the top-N mispredicted ops, both sides'
overlap efficiency (how much copy/disk/link time hides under compute),
and the total absolute per-op error — the scalar a refined hardware
model is scored against.

Caveat worth stating plainly: traced runs fence every op (a stream
synchronize on a card), so the *measured* overlap efficiency of a traced
run is genuinely ~0 — tracing serializes the engines it observes.  On a
card a span is a host clock around the op and its fence, so an op of
tens of microseconds reads mostly the fence's own latency.  Per-op durations and kind ratios are the trustworthy signal;
the measured-vs-predicted overlap gap quantifies what fencing forfeits.
"""
from __future__ import annotations

import dataclasses

#: op kinds the simulators model with a timeline span (everything else —
#: ALLOC/FREE/BCAST — is bookkeeping with no span to align against)
MODELED_KINDS = frozenset(
    {"load", "store", "fetch", "spill", "recv",
     "syrk", "gemm", "potrf", "trsm"})

_COPY_KINDS = frozenset({"load", "store", "fetch", "spill", "recv"})
_COMPUTE_KINDS = frozenset({"syrk", "gemm", "potrf", "trsm"})


def _predicted_ops(timeline) -> list:
    """Flatten a simulator timeline into ``(kind, duration_s)`` in op
    order, dropping the decorative ``:pipe`` lanes."""
    out = []
    for engine, start, end, label in timeline:
        if engine.endswith(":pipe"):
            continue
        if engine == "link":
            kind = "recv"
        elif engine == "dsk":
            kind = "fetch" if label.startswith("F") else "spill"
        elif engine.endswith("h2d") or engine == "h2d":
            kind = "load"
        elif engine.endswith("d2h") or engine == "d2h":
            kind = "store"
        else:                      # cmp lanes carry the kind as the label
            kind = label
        out.append((kind, end - start))
    return out


def _overlap_efficiency(makespan, compute_busy, copy_busy):
    """Fraction of copy/disk/link time hidden under compute: busy copy
    time minus the part of the makespan compute cannot cover, over total
    copy time.  ``None`` when there is no copy time to hide."""
    if copy_busy <= 0:
        return None
    exposed = max(makespan - compute_busy, 0.0)
    return max(copy_busy - exposed, 0.0) / copy_busy


@dataclasses.dataclass
class DriftReport:
    """Measured-vs-predicted comparison of one traced run."""
    nops: int                       # aligned (modeled) op count
    measured_makespan: float        # seconds, first start to last end
    predicted_makespan: float
    measured_total: float           # summed span durations, seconds
    predicted_total: float
    total_abs_error: float          # sum of |measured - predicted| per op
    per_kind: dict                  # kind -> {count, measured_s, predicted_s, ratio}
    top_mispredicted: list          # worst ops by |measured - predicted|
    measured_overlap_efficiency: float | None
    predicted_overlap_efficiency: float | None

    @property
    def makespan_ratio(self) -> float:
        return (self.measured_makespan / self.predicted_makespan
                if self.predicted_makespan > 0 else float("inf"))

    def summary(self) -> str:
        lines = [
            f"drift: {self.nops} ops, makespan measured "
            f"{self.measured_makespan * 1e3:.2f} ms vs predicted "
            f"{self.predicted_makespan * 1e3:.2f} ms "
            f"(x{self.makespan_ratio:.2f}), "
            f"total |error| {self.total_abs_error * 1e3:.2f} ms",
        ]
        for kind in sorted(self.per_kind):
            row = self.per_kind[kind]
            lines.append(
                f"  {kind:>6s}: n={row['count']:<4d} measured "
                f"{row['measured_s'] * 1e3:8.2f} ms  predicted "
                f"{row['predicted_s'] * 1e3:8.2f} ms  x{row['ratio']:.2f}")
        m, p = (self.measured_overlap_efficiency,
                self.predicted_overlap_efficiency)
        lines.append(
            "  overlap eff: measured "
            + ("n/a" if m is None else f"{m:.2f}")
            + " vs predicted "
            + ("n/a" if p is None else f"{p:.2f}")
            + " (traced runs fence per-op, so measured ~0 is expected)")
        for t in self.top_mispredicted:
            lines.append(
                f"  worst: op#{t['op_index']} {t['kind']}"
                f"({t['i']},{t['j']})@d{t['device']} measured "
                f"{t['measured_s'] * 1e6:.0f} us vs "
                f"{t['predicted_s'] * 1e6:.0f} us")
        return "\n".join(lines)


def drift_report(trace, predicted, top_n: int = 10) -> DriftReport:
    """Align a measured trace against a simulator result positionally.

    ``predicted`` is a :class:`~repro_torch.core.analytics.SimResult` or
    :class:`~repro_torch.core.analytics.MultiSimResult` produced from the
    *same schedule* with ``record_timeline=True``.  Raises ``ValueError``
    on a truncated trace (ring-buffer drops), an unrecorded timeline, or
    any positional kind mismatch — misalignment must fail loudly, never
    produce a subtly wrong report.
    """
    if getattr(trace, "dropped", 0):
        raise ValueError(
            f"trace dropped {trace.dropped} spans (ring buffer too small "
            f"for this schedule): raise TraceRecorder(capacity=...)")
    if not predicted.timeline:
        raise ValueError("predicted timeline not recorded: simulate with "
                         "record_timeline=True")
    measured = [s for s in trace.spans if s.kind in MODELED_KINDS]
    modeled = _predicted_ops(predicted.timeline)
    if len(measured) != len(modeled):
        raise ValueError(
            f"cannot align: {len(measured)} measured modeled spans vs "
            f"{len(modeled)} predicted — trace and simulation must come "
            f"from the same schedule (and one full traced run)")

    per_kind: dict = {}
    rows = []
    total_err = 0.0
    for pos, (span, (pkind, pdur)) in enumerate(zip(measured, modeled)):
        if span.kind != pkind:
            raise ValueError(
                f"kind mismatch at modeled op {pos}: measured "
                f"{span.kind!r} vs predicted {pkind!r} — dispatch orders "
                f"diverge, refusing to misattribute drift")
        mdur = span.duration_s
        err = abs(mdur - pdur)
        total_err += err
        agg = per_kind.setdefault(
            span.kind, {"count": 0, "measured_s": 0.0, "predicted_s": 0.0})
        agg["count"] += 1
        agg["measured_s"] += mdur
        agg["predicted_s"] += pdur
        rows.append({
            "op_index": span.op_index, "kind": span.kind,
            "i": span.i, "j": span.j, "device": span.device,
            "measured_s": mdur, "predicted_s": pdur, "abs_error_s": err,
        })
    for agg in per_kind.values():
        agg["ratio"] = (agg["measured_s"] / agg["predicted_s"]
                        if agg["predicted_s"] > 0 else float("inf"))

    m_make = ((max(s.t_end for s in measured)
               - min(s.t_start for s in measured)) / 1e9 if measured else 0.0)
    m_cmp = sum(s.duration_s for s in measured
                if s.kind in _COMPUTE_KINDS)
    m_copy = sum(s.duration_s for s in measured if s.kind in _COPY_KINDS)
    p_cmp = sum(d for k, d in modeled if k in _COMPUTE_KINDS)
    p_copy = sum(d for k, d in modeled if k in _COPY_KINDS)

    rows.sort(key=lambda r: r["abs_error_s"], reverse=True)
    return DriftReport(
        nops=len(measured),
        measured_makespan=m_make,
        predicted_makespan=predicted.makespan,
        measured_total=sum(r["measured_s"] for r in rows),
        predicted_total=sum(r["predicted_s"] for r in rows),
        total_abs_error=total_err,
        per_kind=per_kind,
        top_mispredicted=rows[:top_n],
        measured_overlap_efficiency=_overlap_efficiency(
            m_make, m_cmp, m_copy),
        predicted_overlap_efficiency=_overlap_efficiency(
            predicted.makespan, p_cmp, p_copy),
    )


def total_abs_error(trace, predicted) -> float:
    """Summed per-op |measured - predicted| seconds — the scalar a
    refined :class:`~repro_torch.core.analytics.HardwareModel` must
    reduce."""
    return drift_report(trace, predicted, top_n=0).total_abs_error
