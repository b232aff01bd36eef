"""Process-wide counter/gauge registry: one snapshot for every subsystem.

Port of ``repro/obs/metrics.py``.  :data:`REGISTRY` absorbs the port's
stats surfaces: the plan cache (``repro_torch.plan_cache_stats()``) as a
source polled at snapshot time, and the solvers' counters
(``repro.factor.*``, ``repro.solve.calls``, the reference's names),
bumped as they execute.  :func:`repro_torch.obs.snapshot` returns the
union as one nested dict, with :func:`render_text` as a text exposition
format for scraping/logging.  The port's registry is its own: a process
that imports both packages holds two.

Lock discipline: counter/gauge mutation and the registry's own state are
guarded by one lock; **source callables are invoked outside it** (they
take their own locks — e.g. ``ServiceMetrics.snapshot()`` — and calling
foreign code under a registry lock is how deadlocks are built).
"""
from __future__ import annotations

import threading


class MetricsRegistry:
    """Counters (monotonic), gauges (last-write-wins), and named source
    callables polled at snapshot time.  All methods are thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._sources: dict[str, object] = {}

    # -- mutation ----------------------------------------------------------
    def inc(self, name: str, delta: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def register_source(self, name: str, fn) -> None:
        """Register ``fn`` (zero-arg, returns a dict) to be polled under
        ``name`` at every snapshot.  Re-registering a name overwrites —
        the latest component owns it."""
        with self._lock:
            self._sources[name] = fn

    def unregister_source(self, name: str, fn=None) -> None:
        """Drop a source; with ``fn`` given, only when it is still the
        registered callable (a replaced registration is left alone)."""
        with self._lock:
            if name in self._sources and (fn is None
                                          or self._sources[name] is fn):
                del self._sources[name]

    def clear(self) -> None:
        """Reset counters/gauges and drop all sources (tests)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._sources.clear()

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """``{"counters": {...}, "gauges": {...}, "sources": {name: dict}}``.

        Counters/gauges are copied under the lock; sources are polled
        *after* it is released.  A source that raises reports
        ``{"error": repr(exc)}`` instead of poisoning the snapshot.
        """
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            sources = dict(self._sources)
        polled = {}
        for name, fn in sources.items():
            try:
                polled[name] = fn()
            except Exception as exc:  # noqa: BLE001 — snapshot must not die
                polled[name] = {"error": repr(exc)}
        return {"counters": counters, "gauges": gauges, "sources": polled}

    def render_text(self) -> str:
        """Flat ``name value`` exposition (one metric per line, sorted;
        nested source dicts flatten with ``.`` separators; non-numeric
        leaves are skipped)."""
        snap = self.snapshot()
        lines = []

        def emit(prefix, value):
            if isinstance(value, dict):
                for k in sorted(value):
                    emit(f"{prefix}.{k}", value[k])
            elif isinstance(value, bool):
                lines.append(f"{prefix} {int(value)}")
            elif isinstance(value, (int, float)):
                lines.append(f"{prefix} {value:g}")

        for name in sorted(snap["counters"]):
            emit(name, snap["counters"][name])
        for name in sorted(snap["gauges"]):
            emit(name, snap["gauges"][name])
        for name in sorted(snap["sources"]):
            emit(name, snap["sources"][name])
        return "\n".join(lines) + "\n" if lines else ""


#: the process-wide registry every subsystem reports into
REGISTRY = MetricsRegistry()


def _plan_cache_source() -> dict:
    from ..core import api  # lazy: obs must import without core
    return api.plan_cache_stats()


# the plan cache is process-global, so its source is registered at
# import time
REGISTRY.register_source("plan_cache", _plan_cache_source)


def snapshot() -> dict:
    """Snapshot the process-wide registry (module-level convenience)."""
    return REGISTRY.snapshot()


def render_text() -> str:
    """Text exposition of the process-wide registry."""
    return REGISTRY.render_text()
