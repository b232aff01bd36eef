"""Measured per-op runtime tracing: the span recorder executors report to.

Port of ``repro/obs/trace.py``.  Every executor accepts a ``trace=``
recorder (threaded through ``OOCSolver.factor(a, trace=...)`` /
``plan().compile(trace=...)``) and, when it is *active*, switches to a
fenced op-by-op execution mode: each schedule op is issued, the op's CUDA
stream is synchronized (without the fence, asynchronous launches would
timestamp queue insertion, not execution; on the CPU every op is already
synchronous), and one :class:`Span` is recorded.  The result is a
*measured* timeline with exactly one span per executed op, positionally
aligned with the static schedule's dispatch order — which is what lets
:mod:`repro_torch.obs.drift` compare it op-by-op against the event
simulator's prediction.  A span is a host clock around the op and its
fence, never CUDA-event time, as the reference's are host clocks around
its fence.

The default is :data:`NULL`, a :class:`NullRecorder` whose ``active``
flag is ``False``: executors test that one attribute and take their
ordinary (unfenced, segment-batched or fused) path, so untraced runs are
the untraced code path, with unchanged ``executor_builds``.

Timestamps are ``time.perf_counter_ns`` integers (monotonic,
process-local); :meth:`TraceRecorder.duration_s` and friends convert.
The buffer is a bounded ring (``capacity`` spans): tracing a schedule
larger than the ring keeps the *most recent* spans and counts the rest
in ``dropped`` — drift analysis refuses truncated traces rather than
misaligning silently.
"""
from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple


class Span(NamedTuple):
    """One executed op: ``(op_index, kind, device, t_start, t_end, bytes)``
    plus alignment metadata (precision class name, tile coordinates, and
    the dispatch phase for pipelined multi-device schedules)."""
    op_index: int
    kind: str                # OpKind.value ("load", "gemm", "recv", ...)
    device: int              # executing device stream (0 for ndev=1)
    t_start: int             # time.perf_counter_ns
    t_end: int
    bytes: int               # transfer bytes (0 for compute/bookkeeping)
    cls: str = ""            # precision class name (plan.ladder[op.cls])
    i: int = -1              # tile row
    j: int = -1              # tile col
    phase: str = ""          # dispatch-chunk phase (lookahead pipelines)

    @property
    def duration_s(self) -> float:
        return (self.t_end - self.t_start) / 1e9


class TraceRecorder:
    """Bounded ring buffer of measured :class:`Span` records.

    Pass one to ``OOCSolver.factor(a, trace=rec)`` (or pin it at
    ``plan.compile(trace=rec)``) and the executor records one span per
    op it runs.  ``meta`` is stamped by the solver with the run's shape
    (``n``/``tb``/``ndev``/``policy``/``backend``/...), the reference's
    keys, which a calibration needs to turn spans back into kernel
    rates.

    Not thread-safe by design: one recorder traces one run.  Reuse
    across runs is fine — call :meth:`clear` between them, or let the
    spans of consecutive runs concatenate (``op_index`` restarts at 0).
    """

    #: default ring capacity — comfortably above any test/bench schedule,
    #: bounded so tracing a huge factorization cannot exhaust memory
    DEFAULT_CAPACITY = 1 << 20

    active = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._spans: deque[Span] = deque(maxlen=capacity)
        self.dropped = 0         # spans evicted by the ring bound
        self.meta: dict = {}     # run metadata stamped by the executor

    @staticmethod
    def now() -> int:
        """The recorder's clock: ``time.perf_counter_ns``."""
        return time.perf_counter_ns()

    def record(self, op_index: int, kind: str, device: int,
               t_start: int, t_end: int, nbytes: int, cls: str = "",
               i: int = -1, j: int = -1, phase: str = "") -> None:
        if len(self._spans) == self.capacity:
            self.dropped += 1
        self._spans.append(Span(op_index, kind, device, t_start, t_end,
                                nbytes, cls, i, j, phase))

    @property
    def spans(self) -> list[Span]:
        """The recorded spans, oldest first."""
        return list(self._spans)

    def __len__(self) -> int:
        return len(self._spans)

    def __bool__(self) -> bool:        # an empty recorder is still a recorder
        return True

    def clear(self) -> None:
        self._spans.clear()
        self.dropped = 0
        self.meta = {}

    # -- aggregate views ---------------------------------------------------
    def makespan_s(self) -> float:
        """Wall span of the trace (first start to last end), seconds."""
        if not self._spans:
            return 0.0
        t0 = min(s.t_start for s in self._spans)
        t1 = max(s.t_end for s in self._spans)
        return (t1 - t0) / 1e9

    def busy_s(self, kinds=None) -> float:
        """Summed span durations, optionally restricted to ``kinds``."""
        return sum(s.duration_s for s in self._spans
                   if kinds is None or s.kind in kinds)

    def by_kind(self) -> dict:
        """``{kind: (count, total_seconds, total_bytes)}``."""
        out: dict = {}
        for s in self._spans:
            c, t, b = out.get(s.kind, (0, 0.0, 0))
            out[s.kind] = (c + 1, t + s.duration_s, b + s.bytes)
        return out


class NullRecorder:
    """The zero-cost default: ``active`` is False, so executors never
    leave their ordinary (unfenced) path — a ``trace=NULL`` run is the
    *same objects and code path* as ``trace=None``, checkable by
    identity, not timing."""

    active = False
    dropped = 0
    capacity = 0
    meta: dict = {}

    @staticmethod
    def now() -> int:
        return 0

    def record(self, *a, **kw) -> None:
        pass

    @property
    def spans(self) -> list:
        return []

    def __len__(self) -> int:
        return 0

    def clear(self) -> None:
        pass


#: process-wide no-op recorder; ``resolve(None) is NULL``
NULL = NullRecorder()


def resolve(trace) -> "TraceRecorder | NullRecorder":
    """Normalize a ``trace=`` argument: ``None`` -> the :data:`NULL`
    singleton, anything else passes through unchanged."""
    return NULL if trace is None else trace


def is_active(trace) -> bool:
    """True when ``trace`` is a recorder that wants spans (executors'
    one-attribute fast path; ``None`` and :data:`NULL` are inactive)."""
    return trace is not None and getattr(trace, "active", False)
