"""`SolverService` — concurrent, plan-cached factor/solve serving (port of
``repro/serve/service.py``).

The paper's motivating application (geospatial Matérn MLE) does not
issue one factorization: every optimizer step fans out many correlated
``factor``/``solve``/``logdet`` calls.  This module turns the planner
API into a front end for exactly that request stream:

* **Sessions** are tenants.  ``service.session(key, n, config)`` routes
  through the process-wide ``(n, config)`` plan cache (`repro_torch.plan`),
  so same-shape tenants share one static schedule and one executor; each
  session owns its *own* :class:`~repro_torch.core.api.OOCSolver`,
  because a solver is single-factor stateful (``factor()`` overwrites
  the tile store — see its docstring).
* **The request queue** is per-session FIFO with one in-flight work
  item per session (serial semantics per tenant, concurrency across
  tenants) and round-robin dispatch across session keys (a flooding
  tenant cannot starve the others).
* **Batching**: bursts of single-RHS ``solve``/``solve_lower`` against
  the same factor coalesce into one stacked ``solve(B)`` within a
  deadline window (:mod:`repro_torch.serve.batching`).
* **Admission** reserves device memory per in-flight plan against the
  service's :class:`~repro_torch.core.analytics.HardwareModel` and
  rejects plans that can never fit (:mod:`repro_torch.serve.admission`).
* **Metrics**: every submit/execute lands in
  :class:`~repro_torch.serve.metrics.ServiceMetrics`
  (``service.metrics.snapshot()`` / chrome-trace timeline).

Requests return :class:`concurrent.futures.Future`; each session also
exposes a synchronous facade that duck-types the solver surface, so
e.g. :func:`repro_torch.geo.likelihood.gaussian_loglik` evaluates against
a served session exactly as it does against a local solver.  Workers are
threads: every tenant shares one plan cache and one card.  The port's one
argument beyond the reference's is ``device`` (the card unless
``"cpu"``), which each session's ``plan.compile(device=...)`` gets.

One device runs one work item at a time: a factor or a solve on the
torch backend holds a process-wide lock for each device it runs on
(:func:`device_locks`), whichever service or worker issues it.  The
executors issue every op from the calling Python thread, one op at a
time, so one thread already keeps the host busy; two threads issuing to
one card at once hand the GIL to each other at every launch, and their
pair took longer than the two factors one after the other (``PERF.md``).
Workers still overlap what holds no device: queueing, batching, logdet,
and the numpy backend's replays, which take no lock.  The kernel counters
take a lock of their own.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from concurrent.futures import Future
from typing import Any, List, Optional, Tuple

import numpy as np

import torch

from ..core import api as _api
from ..core.analytics import HardwareModel
from ..core.api import CholeskyConfig
from ..obs.metrics import REGISTRY

from .admission import AdmissionController, AdmissionError
from .batching import BATCHABLE, coalesce_head, split_solutions, stack_rhs
from .metrics import RequestRecord, ServiceMetrics

KINDS = ("factor", "solve", "solve_lower", "logdet", "factor_solve")

_DEVICE_LOCKS: dict = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def device_locks(solver) -> list:
    """The process-wide locks of the devices ``solver`` runs its factor and
    solves on, in one global order (so that two holders cannot deadlock);
    none on the numpy backend, whose replays and solves run on the host."""
    if solver.config.resolved_backend() == "numpy":
        return []
    keys = set()
    for d in solver.devices:
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        keys.add(str(d))
    with _DEVICE_LOCKS_GUARD:
        return [_DEVICE_LOCKS.setdefault(k, threading.Lock())
                for k in sorted(keys)]


@contextlib.contextmanager
def _holding(locks):
    with contextlib.ExitStack() as stack:
        for lock in locks:
            stack.enter_context(lock)
        yield


@dataclasses.dataclass
class _Request:
    kind: str
    payload: Any
    future: Future
    t_arrive: float
    t_deadline: float     # batch-window deadline (batchable kinds only)
    k: int = 1            # RHS columns carried


class Session:
    """One tenant's handle: per-session FIFO ordering, one pooled solver.

    Async methods (``*_async``) return futures; the plain methods block
    on them and — together with ``n`` — make a session duck-compatible
    with :class:`~repro_torch.core.api.OOCSolver` for read-style consumers
    like :func:`repro_torch.geo.likelihood.gaussian_loglik`.
    """

    def __init__(self, service: "SolverService", key: str, n: int,
                 config: CholeskyConfig, plan):
        self._service = service
        self.key = key
        self.n = n
        self.config = config
        self._plan = plan            # shared CholeskyPlan (plan cache)
        self._solver = None          # this session's pooled OOCSolver
        self._factored = False
        self._queue: collections.deque = collections.deque()
        self._in_flight = False
        self._closed = False

    # -- async surface -----------------------------------------------------
    def factor_async(self, a, materialize: bool = False) -> Future:
        """``a``: numpy, or a tensor on any device (as ``OOCSolver.factor``
        takes it)."""
        return self._service._submit(self, "factor",
                                     (self._matrix(a), materialize))

    def solve_async(self, b: np.ndarray) -> Future:
        return self._service._submit(self, "solve", self._rhs(b),
                                     k=self._cols(b))

    def solve_lower_async(self, b: np.ndarray) -> Future:
        return self._service._submit(self, "solve_lower", self._rhs(b),
                                     k=self._cols(b))

    def solve_batch_async(self, b: np.ndarray) -> Future:
        """Explicitly stacked ``(n, k)`` request (one future for all k)."""
        b = self._rhs(b)
        if b.ndim != 2:
            raise ValueError(f"solve_batch expects stacked columns (n, k), "
                             f"got shape {b.shape}")
        return self._service._submit(self, "solve", b, k=b.shape[1])

    def logdet_async(self) -> Future:
        return self._service._submit(self, "logdet", None)

    def factor_solve_async(self, a, b: np.ndarray,
                           materialize: bool = False) -> Future:
        """Fused factor+solve: one queue slot, no inter-request gap."""
        return self._service._submit(self, "factor_solve",
                                     (self._matrix(a), materialize,
                                      self._rhs(b)))

    # -- sync facade (OOCSolver duck type) ---------------------------------
    def factor(self, a, materialize: bool = False):
        return self.factor_async(a, materialize=materialize).result()

    def solve(self, b: np.ndarray) -> np.ndarray:
        return self.solve_async(b).result()

    def solve_lower(self, b: np.ndarray) -> np.ndarray:
        return self.solve_lower_async(b).result()

    def solve_batch(self, b: np.ndarray) -> np.ndarray:
        return self.solve_batch_async(b).result()

    def logdet(self) -> float:
        return self.logdet_async().result()

    def factor_solve(self, a, b: np.ndarray, materialize: bool = False):
        return self.factor_solve_async(a, b,
                                       materialize=materialize).result()

    def close(self) -> None:
        """Retire the session: queued work still drains, new submits
        raise, and the admission reservation is released once idle."""
        self._service._close_session(self)

    # -- validation --------------------------------------------------------
    def _matrix(self, a):
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a, dtype=np.float64)
        if tuple(a.shape) != (self.n, self.n):
            raise ValueError(f"matrix shape {tuple(a.shape)} does not match "
                             f"the session's n={self.n}")
        return a

    def _rhs(self, b) -> np.ndarray:
        b = np.asarray(b)
        if b.dtype.kind not in "fiub":
            raise TypeError(f"rhs dtype {b.dtype} is not real-valued")
        if b.ndim not in (1, 2) or b.shape[0] != self.n \
                or (b.ndim == 2 and b.shape[1] == 0):
            raise ValueError(f"rhs shape {b.shape} does not match the "
                             f"session's n={self.n} (expect (n,) or (n, k))")
        return np.asarray(b, dtype=np.float64)

    @staticmethod
    def _cols(b) -> int:
        b = np.asarray(b)
        return b.shape[1] if b.ndim == 2 else 1


class SolverService:
    """Front end + worker pool over the plan cache; see module docstring.

    ``workers`` threads execute admitted work items; ``hw`` bounds the
    admitted set (None = unbounded); ``batch_window``/``max_batch``
    shape the solve coalescing (window 0 or max_batch 1 = the
    one-RHS-at-a-time baseline); ``device`` is where the sessions' solvers
    run (``plan.compile(device=...)``: the card unless ``"cpu"``).  Use as
    a context manager or call :meth:`close`.
    """

    def __init__(self, workers: int = 4,
                 hw: Optional[HardwareModel] = None,
                 batch_window: float = 0.002, max_batch: int = 32,
                 device="cuda"):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if batch_window < 0:
            raise ValueError(f"batch_window must be >= 0 seconds, "
                             f"got {batch_window}")
        self._batch_window = batch_window
        self._max_batch = max_batch
        self.device = device
        self.admission = AdmissionController(hw)
        self.metrics = ServiceMetrics()
        self._obs_source = self.metrics.snapshot
        REGISTRY.register_source("serve", self._obs_source)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._sessions: dict = {}
        self._rr: List[str] = []      # round-robin key order
        self._rr_idx = 0
        self._stop = False
        self._threads = [
            threading.Thread(target=self._worker_loop, args=(i,),
                             name=f"repro-serve-w{i}", daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "SolverService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Drain queued work, then stop and join the workers."""
        with self._work:
            self._stop = True
            self._work.notify_all()
        for t in self._threads:
            t.join()
        # fn-matched: a newer service that took the name keeps it
        REGISTRY.unregister_source("serve", self._obs_source)

    # -- tenants -----------------------------------------------------------
    def session(self, key: str, n: int,
                config: Optional[CholeskyConfig] = None,
                **overrides) -> Session:
        """Open (or re-fetch) the tenant session ``key``.

        The static plan is built/fetched *here*, through the process-wide
        plan cache — same-shape tenants share it.  The config must be
        fully resolved (``tb > 0``, concrete policy, no ``eps_target``):
        serving cannot re-tune per request, so open dimensions are a
        caller decision (``repro_torch.tune.tune`` or ``repro_torch.plan``
        resolve them ahead of session creation).
        """
        if config is None:
            config = CholeskyConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        if config.needs_tuning:
            raise ValueError(
                "serve sessions need a fully resolved config (tb > 0 and a "
                "concrete policy): resolve open dimensions first, e.g. "
                "cfg = repro_torch.plan(n, cfg).config after autotuning")
        plan = _api.plan(n, config)
        with self._work:
            if self._stop:
                raise RuntimeError("service is closed")
            existing = self._sessions.get(key)
            if existing is not None:
                if existing.n != n or existing.config != plan.config:
                    raise ValueError(
                        f"session {key!r} already exists with n="
                        f"{existing.n} and a different config")
                return existing
            s = Session(self, key, n, plan.config, plan)
            self._sessions[key] = s
            self._rr.append(key)
            return s

    def _close_session(self, session: Session) -> None:
        with self._work:
            session._closed = True
            self._finish_session_locked(session)
            self._work.notify_all()

    def _finish_session_locked(self, session: Session) -> None:
        """Release a retired session's reservation once it has drained."""
        if (session._closed and not session._queue
                and not session._in_flight
                and session.key in self._sessions):
            self.admission.release(session.key)
            del self._sessions[session.key]
            self._rr.remove(session.key)

    # -- front end ---------------------------------------------------------
    def _submit(self, session: Session, kind: str, payload,
                k: int = 1) -> Future:
        fut: Future = Future()
        now = self.metrics.now()
        deadline = now + (self._batch_window if kind in BATCHABLE else 0.0)
        req = _Request(kind=kind, payload=payload, future=fut,
                       t_arrive=now, t_deadline=deadline, k=k)
        with self._work:
            if self._stop:
                raise RuntimeError("service is closed")
            if session._closed or session.key not in self._sessions:
                raise RuntimeError(f"session {session.key!r} is closed")
            try:
                self.admission.check_feasible(session._plan)
            except AdmissionError as e:
                self.metrics.on_reject(kind, session.key)
                fut.set_exception(e)
                return fut
            session._queue.append(req)
            depth = sum(len(s._queue) for s in self._sessions.values())
            self.metrics.on_submit(kind, depth)
            self._work.notify_all()
        return fut

    # -- dispatch ----------------------------------------------------------
    def _has_pending_locked(self) -> bool:
        return any(s._queue or s._in_flight
                   for s in self._sessions.values())

    def _next_item_locked(self) -> Tuple[Optional[tuple], Optional[float]]:
        """Round-robin pick of the next work item; ``(None, wait)`` when
        nothing is ready (wait = seconds until the nearest held-batch
        deadline, None = wait for a notify)."""
        best_wait = None
        nrr = len(self._rr)
        for off in range(nrr):
            idx = (self._rr_idx + off) % nrr
            s = self._sessions[self._rr[idx]]
            if s._in_flight or not s._queue:
                continue
            if not self.admission.try_reserve(s.key, s._plan):
                continue          # oversubscribed: keep queued
            now = self.metrics.now()
            count, hold = coalesce_head(
                s._queue, now, self._max_batch,
                # a closing service flushes held batches immediately
                0.0 if self._stop else self._batch_window)
            if count == 0:
                wait = max(hold - now, 0.0)
                best_wait = wait if best_wait is None \
                    else min(best_wait, wait)
                continue
            reqs = [s._queue.popleft() for _ in range(count)]
            self._rr_idx = (idx + 1) % max(nrr, 1)
            return (s, reqs), None
        return None, best_wait

    def _worker_loop(self, wid: int) -> None:
        while True:
            with self._work:
                while True:
                    item, wait = self._next_item_locked()
                    if item is not None:
                        break
                    if self._stop and not self._has_pending_locked():
                        return
                    self._work.wait(timeout=wait)
                session, reqs = item
                session._in_flight = True
            try:
                self._execute(wid, session, reqs)
            finally:
                with self._work:
                    session._in_flight = False
                    self._finish_session_locked(session)
                    self._work.notify_all()

    # -- execution (worker threads, no service lock held) ------------------
    def _ensure_solver(self, session: Session):
        if session._solver is None:
            session._solver = session._plan.compile(device=self.device)
            self.metrics.on_solver_compile()
        return session._solver

    def _require_factor(self, session: Session):
        if session._solver is None or not session._factored:
            raise RuntimeError(
                f"session {session.key!r} has no factor: submit factor() "
                f"(or factor_solve()) before solve()/logdet()")
        return session._solver

    def _execute(self, wid: int, session: Session,
                 reqs: List[_Request]) -> None:
        kind = reqs[0].kind
        reused = session._factored
        t_start = self.metrics.now()
        results: List[Any] = []        # per-request values, parallel to reqs
        error: Optional[Exception] = None
        try:
            if kind in ("factor", "factor_solve"):
                solver = self._ensure_solver(session)
                (a, materialize, *rest) = reqs[0].payload
                with _holding(device_locks(solver)):
                    l = solver.factor(a, materialize=materialize)
                    session._factored = True
                    if kind == "factor_solve":
                        x = solver.solve(rest[0])
                if kind == "factor_solve":
                    results = [(l, x) if materialize else x]
                else:
                    results = [l]
            elif kind in BATCHABLE:
                solver = self._require_factor(session)
                op = solver.solve if kind == "solve" else solver.solve_lower
                if len(reqs) == 1:
                    with _holding(device_locks(solver)):
                        results = [op(reqs[0].payload)]
                else:
                    stacked, splits = stack_rhs([r.payload for r in reqs])
                    with _holding(device_locks(solver)):
                        x = op(stacked)
                    results = split_solutions(x, splits)
            elif kind == "logdet":
                solver = self._require_factor(session)
                results = [solver.logdet()]
            else:                                    # pragma: no cover
                raise AssertionError(f"unknown request kind {kind!r}")
        except Exception as e:  # noqa: BLE001 — fault isolation per batch
            error = e
        t_end = self.metrics.now()
        batch_k = sum(r.k for r in reqs)
        # metrics first, futures second: a client that wakes on its
        # future must already see its own request in snapshot()
        self.metrics.on_execute(
            wid,
            [RequestRecord(kind=r.kind, session=session.key, worker=wid,
                           k=r.k, batch_k=batch_k, t_arrive=r.t_arrive,
                           t_start=t_start, t_end=t_end, ok=error is None)
             for r in reqs],
            solve_batch=kind in BATCHABLE, reused_solver=reused)
        if error is not None:
            for r in reqs:
                r.future.set_exception(error)
        else:
            for r, value in zip(reqs, results):
                r.future.set_result(value)
