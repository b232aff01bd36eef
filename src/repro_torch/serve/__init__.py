"""`repro_torch.serve` — solver-as-a-service over the static-plan
machinery (port of ``repro.serve``).

The planner API amortizes schedule construction and executor builds
across same-shape calls; this package exploits that at traffic scale: an
admission-controlled request queue in front of a pool of per-session
:class:`~repro_torch.core.api.OOCSolver`\\ s, with multi-RHS batching of
concurrent solves and first-class observability.  The solvers run on the
card unless the service is made with ``device="cpu"``.

    from repro_torch.serve import SolverService

    with SolverService(workers=4) as svc:
        s = svc.session("tenant-a", n, tb=64, policy="v3")
        s.factor(sigma)                       # sync facade, or *_async
        x = s.solve(b)                        # coalesced under load
        print(svc.metrics.snapshot())

Layers:

* :mod:`~repro_torch.serve.service` — front end, sessions, worker pool
* :mod:`~repro_torch.serve.batching` — multi-RHS solve coalescing
* :mod:`~repro_torch.serve.admission` — device-memory admission control
* :mod:`~repro_torch.serve.metrics` — latency/queue/batch/cache counters
  and a chrome-trace timeline
"""
from .admission import (AdmissionController, AdmissionError,
                        plan_device_bytes, plan_device_slots)
from .batching import coalesce_head, split_solutions, stack_rhs
from .metrics import RequestRecord, ServiceMetrics, ServiceTimeline
from .service import Session, SolverService

__all__ = [
    "SolverService", "Session",
    "AdmissionController", "AdmissionError",
    "plan_device_slots", "plan_device_bytes",
    "stack_rhs", "split_solutions", "coalesce_head",
    "ServiceMetrics", "ServiceTimeline", "RequestRecord",
]
