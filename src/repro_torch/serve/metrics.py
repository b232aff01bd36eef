"""Service observability: counters, latency percentiles, and a timeline
(port of ``repro/serve/metrics.py``).

:class:`ServiceMetrics` is the single sink every serve component reports
into — the front end on submit/reject, the workers on execute.  It is
deliberately boring: a lock, monotonically growing counters, and a list
of per-request records; :meth:`snapshot` reduces them to the metrics
schema documented in docs/serving.md (latency p50/p99, queue depth,
batch occupancy, plan-cache hit/miss deltas, solver reuse), and
:meth:`timeline` re-expresses the executed batches as a
``(engine, start, end, label)`` span list shaped exactly like the event
simulator's, so :func:`repro_torch.core.analytics.chrome_trace` renders a
served traffic window with the same tooling as a simulated
factorization (one track per worker thread).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np

from ..core import api as _api


@dataclasses.dataclass
class RequestRecord:
    """One completed (or rejected) request, timestamps in service time."""
    kind: str
    session: str
    worker: int = -1
    k: int = 1                 # RHS columns this request carried
    batch_k: int = 1           # total columns of the batch it rode in
    t_arrive: float = 0.0
    t_start: float = 0.0
    t_end: float = 0.0
    ok: bool = True

    @property
    def latency(self) -> float:
        return self.t_end - self.t_arrive


@dataclasses.dataclass
class ServiceTimeline:
    """Span view of a traffic window; duck-compatible with the simulator
    results that :func:`repro_torch.core.analytics.chrome_trace` accepts."""
    timeline: list
    makespan: float
    tflops: float = 0.0


def _pct(xs, q):
    """Percentile of a series, or ``None`` when nothing was recorded —
    an empty window reads as "no data", never as a zero-latency claim."""
    return float(np.percentile(np.asarray(xs), q)) if xs else None


class ServiceMetrics:
    """Thread-safe metrics sink shared by the service front end and its
    workers; see module docstring for the consumer surface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._records: List[RequestRecord] = []
        self._rejected = 0
        self._submitted = 0
        self._kind_counts: dict = {}
        self._queue_depth_samples: List[int] = []
        self._batches = 0            # executed work items
        self._batched_solves = 0     # work items coalescing >= 2 requests
        self._batch_occupancy: List[int] = []   # RHS columns per solve batch
        self._solver_compiles = 0    # sessions that built their solver
        self._solver_reuse = 0       # requests served by an existing solver
        self._cache0 = _api.plan_cache_stats()

    def now(self) -> float:
        """Service-relative clock (seconds since metrics creation)."""
        return time.perf_counter() - self._t0

    # -- front end ---------------------------------------------------------
    def on_submit(self, kind: str, queue_depth: int) -> None:
        with self._lock:
            self._submitted += 1
            self._kind_counts[kind] = self._kind_counts.get(kind, 0) + 1
            self._queue_depth_samples.append(queue_depth)

    def on_reject(self, kind: str, session: str) -> None:
        with self._lock:
            self._rejected += 1
            now = self.now()
            self._records.append(RequestRecord(
                kind=kind, session=session, t_arrive=now, t_start=now,
                t_end=now, ok=False))

    # -- workers -----------------------------------------------------------
    def on_solver_compile(self) -> None:
        with self._lock:
            self._solver_compiles += 1

    def on_execute(self, worker: int, records: List[RequestRecord],
                   solve_batch: bool, reused_solver: bool) -> None:
        """Record one executed work item (possibly a coalesced batch)."""
        with self._lock:
            self._batches += 1
            if solve_batch:
                self._batch_occupancy.append(sum(r.k for r in records))
                if len(records) >= 2:
                    self._batched_solves += 1
            if reused_solver:
                self._solver_reuse += len(records)
            self._records.extend(records)

    # -- consumers ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Reduce everything recorded so far to one JSON-able dict.

        Latency/occupancy aggregates are ``None`` (not 0.0) when the
        window holds no completed requests.  The plan-cache poll happens
        *outside* ``self._lock`` — it takes the cache's own lock, and
        nesting foreign locks inside ours is how deadlocks are born.
        """
        cache = _api.plan_cache_stats()
        with self._lock:
            recs = [r for r in self._records if r.ok]
            lat = [r.latency for r in recs]
            occ = list(self._batch_occupancy)
            t_lo = min((r.t_arrive for r in recs), default=0.0)
            t_hi = max((r.t_end for r in recs), default=0.0)
            wall = max(t_hi - t_lo, 1e-12)
            solves = sum(r.k for r in recs
                         if r.kind in ("solve", "solve_lower"))
            return {
                "submitted": self._submitted,
                "completed": len(recs),
                "rejected": self._rejected,
                "kinds": dict(self._kind_counts),
                "latency_s": {"p50": _pct(lat, 50), "p99": _pct(lat, 99),
                              "mean": float(np.mean(lat)) if lat else None,
                              "max": max(lat, default=None)},
                "queue_depth": {
                    "max": max(self._queue_depth_samples, default=0),
                    "mean": (float(np.mean(self._queue_depth_samples))
                             if self._queue_depth_samples else 0.0)},
                "batch": {"batches": self._batches,
                          "batched_solves": self._batched_solves,
                          "max_occupancy": max(occ, default=0),
                          "mean_occupancy": (float(np.mean(occ))
                                             if occ else 0.0)},
                "plan_cache": {
                    "hits": cache["hits"] - self._cache0["hits"],
                    "misses": cache["misses"] - self._cache0["misses"],
                    "size": cache["size"]},
                "solver": {"compiles": self._solver_compiles,
                           "reuse": self._solver_reuse},
                "wall_s": wall,
                "solves_per_s": solves / wall,
                "requests_per_s": len(recs) / wall,
            }

    def timeline(self) -> ServiceTimeline:
        """Executed-request spans, one engine track per worker thread."""
        with self._lock:
            spans = [(f"worker{r.worker}", r.t_start, r.t_end,
                      f"{r.kind}:{r.session}"
                      + (f" k={r.batch_k}" if r.batch_k > 1 else ""))
                     for r in self._records if r.ok and r.worker >= 0]
            makespan = max((r.t_end for r in self._records if r.ok),
                           default=0.0)
        return ServiceTimeline(timeline=spans, makespan=makespan)
