"""Multi-RHS coalescing: many queued solves -> one stacked sweep (a copy
of ``repro/serve/batching.py``; pure NumPy).

The OOC solve cost is dominated by streaming the factor's tiles through
host memory, and that traffic is identical for 1 or ``k`` right-hand
sides (``repro_torch.core.solve`` sweeps once per call, with the per-block
update a ``(tb, tb) @ (tb, k)`` GEMM).  The batcher therefore turns a
burst of concurrent single-RHS ``solve``/``solve_lower`` requests
against the *same* factor into one stacked ``solve(B)`` call:

* :func:`coalesce_head` decides, under the service lock, how many
  requests at the head of a session queue ride together — contiguous
  same-kind solves only (a ``factor`` in between is a barrier: requests
  after it target a different matrix), capped at ``max_batch`` total
  columns.  A batch that could still grow (queue tail, under the cap)
  is held back until the oldest member's deadline
  (``arrival + batch_window``) expires — the classic
  latency-for-throughput window, sized in milliseconds.
* :func:`stack_rhs` / :func:`split_solutions` do the column packing and
  unpacking around the solver call, preserving each request's original
  rhs shape (vector in, vector out).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

#: request kinds the batcher may coalesce (same stacked code path)
BATCHABLE = ("solve", "solve_lower")


def coalesce_head(queue: Sequence, now: float, max_batch: int,
                  batch_window: float) -> Tuple[int, Optional[float]]:
    """How many head-of-queue requests execute as one work item.

    ``queue`` holds request objects with ``kind``/``k``/``t_deadline``
    attributes.  Returns ``(count, hold_until)``: ``count >= 1`` means
    the first ``count`` requests form the next work item; ``count == 0``
    means the batch at the head should be *held* until time
    ``hold_until`` (it may still grow and no member's window has
    expired).  Non-batchable head kinds always dispatch alone, as does
    everything when batching is disabled (``max_batch <= 1`` or a
    non-positive window) — the one-RHS-at-a-time baseline.
    """
    head = queue[0]
    if head.kind not in BATCHABLE or max_batch <= 1 or batch_window <= 0:
        return 1, None
    count, cols = _take(queue, head.kind, max_batch)
    if (count == len(queue) and cols < max_batch
            and now < head.t_deadline):
        # still growable and within the window: hold for more arrivals
        return 0, head.t_deadline
    return count, None


def _take(queue: Sequence, kind: str, max_batch: int) -> Tuple[int, int]:
    """(requests, total columns) of the contiguous same-kind head run."""
    count = cols = 0
    for req in queue:
        if req.kind != kind or (cols and cols + req.k > max_batch):
            break
        count += 1
        cols += req.k
    return count, cols


def stack_rhs(rhss: List[np.ndarray]) -> Tuple[np.ndarray, List[Tuple[int,
                                                                      bool]]]:
    """Pack per-request rhs arrays into one ``(n, K)`` column stack.

    Returns the stack and per-request ``(k, was_vector)`` so
    :func:`split_solutions` can restore original shapes.  All rhss must
    share the row count (the service validated each against the plan).
    """
    cols, splits = [], []
    for b in rhss:
        b = np.asarray(b, dtype=np.float64)
        if b.ndim == 1:
            cols.append(b[:, None])
            splits.append((1, True))
        else:
            cols.append(b)
            splits.append((b.shape[1], False))
    return np.concatenate(cols, axis=1), splits


def split_solutions(x: np.ndarray,
                    splits: List[Tuple[int, bool]]) -> List[np.ndarray]:
    """Slice the stacked solution back into per-request results."""
    out, c = [], 0
    for k, was_vector in splits:
        part = x[:, c:c + k]
        out.append(part[:, 0] if was_vector else part)
        c += k
    return out
