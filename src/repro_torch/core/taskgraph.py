# A copy of repro/core/taskgraph.py, kept line for line so that the port builds
# the same plans and op streams (and digests) without importing repro.
"""Explicit tile-task DAG + topological lookahead emitter.

Schedule construction used to be a single per-column emission loop
(``build_multidevice_schedule``).  This module splits it into the paper's
two conceptual stages:

1. :func:`build_task_dag` — the *task graph*: one node per compute task
   (POTRF / TRSM / SYRK / GEMM) with its true value dependencies
   (operand finalization) and accumulation-chain edges.  The graph is
   pure math — no devices, no slots, no transfers.
2. :func:`emit_pipelined_streams` — the *topological emitter*: walks the
   DAG in a lookahead-pipelined order and emits one op stream per device
   (LOAD / STORE / BCAST / RECV data movement realized against the
   per-device cache tables of Algorithm 3).  Every compute op is checked
   against the DAG as it is emitted: emitting a task whose predecessors
   have not been emitted raises, so a reordering bug in the emitter
   cannot silently produce a wrong-answer schedule.

Lookahead (Donfack et al., arXiv:1110.2677): with ``lookahead = L > 0``
the emitter interleaves up to ``L`` panels ahead of the trailing update.
At dispatch step ``s`` it emits

* the **final chunk** of column ``s`` — the last ``L`` update sweeps
  (``n in [s-L, s)``), the TRSM/POTRF finalizations, the panel/ownership
  broadcasts — *and*, for every finalized tile ``(m, s)`` with
  ``m - s <= L``, an **eager panel push** to column ``m``'s grid-row
  peers, so panel ``m`` never waits for its owner's POTRF step;
* the **advance chunk** of column ``s + L`` — all early updates
  (``n in [0, s)``) on that column's grid-column devices, with the
  partially-updated accumulators stored back to the host (the V4
  partial-store trick keeps the slot minimum independent of ``nt``),
  preceded by a **bulk panel push** of the already-final tiles
  ``(s+L, n < s)``.

``lookahead = 0`` reproduces the historical per-column emission loop
bit-identically (golden digests unchanged): the final chunk covers the
whole update sweep, no advance chunks exist, and the panel row is pushed
wholesale after POTRF.

In-flight panels land in *rotating panel-slot regions*: tile ``(k, n)``
received for column ``k`` occupies slot
``panel_base + (k % (L+1)) * nt + n``, so ``L+1`` panel rows can be
resident at once — which is exactly why each lookahead depth pins ``nt``
extra slots (see ``TileLayout.panel_slots`` and
``min_cache_slots(..., lookahead=...)``).

:func:`verify_dispatch` is the independent referee: it replays a built
schedule's dispatch order *symbolically* (slot contents, per-device host
slabs, broadcast wires, per-tile update counts) and asserts that no op
consumes a tile before its DAG predecessors completed and that every
task of the graph runs exactly once.
"""
from __future__ import annotations

import dataclasses

from .precision import BYTES, PrecisionPlan
from .tiling import grid_owner

POTRF, TRSM, SYRK, GEMM = "potrf", "trsm", "syrk", "gemm"


@dataclasses.dataclass(frozen=True)
class Task:
    """One compute node of the tile-Cholesky DAG.

    ``(i, j)`` is the output tile; ``n`` is the update column for
    SYRK/GEMM accumulations (``-1`` for POTRF/TRSM finalizations).
    """
    kind: str
    i: int
    j: int
    n: int = -1


def potrf(k: int) -> Task:
    return Task(POTRF, k, k)


def trsm(m: int, k: int) -> Task:
    return Task(TRSM, m, k)


def syrk(k: int, n: int) -> Task:
    return Task(SYRK, k, k, n)


def gemm(m: int, k: int, n: int) -> Task:
    return Task(GEMM, m, k, n)


class TaskDag:
    """Predecessor map over the ``O(nt^3)`` compute tasks, plus the
    completion state the emitter advances through.

    ``complete(task)`` is the topological-order contract: it raises if a
    predecessor has not completed or if the task runs twice."""

    def __init__(self, preds: dict[Task, tuple[Task, ...]]):
        self.preds = preds
        self.done: set[Task] = set()

    def __len__(self) -> int:
        return len(self.preds)

    def complete(self, task: Task) -> None:
        if task not in self.preds:
            raise AssertionError(f"unknown task {task}")
        if task in self.done:
            raise AssertionError(f"task emitted twice: {task}")
        for t in self.preds[task]:
            if t not in self.done:
                raise AssertionError(
                    f"emitter ordering bug: {task} before predecessor {t}")
        self.done.add(task)

    def all_done(self) -> bool:
        return len(self.done) == len(self.preds)


def build_task_dag(nt: int) -> TaskDag:
    """Value + accumulation dependencies of the left-looking factorization.

    * ``SYRK(k, n)``  needs ``TRSM(k, n)`` (operand final) and
      ``SYRK(k, n-1)`` (in-order accumulation into ``(k, k)``);
    * ``POTRF(k)``    needs ``SYRK(k, k-1)`` (all diagonal updates);
    * ``GEMM(m,k,n)`` needs ``TRSM(m, n)`` + ``TRSM(k, n)`` (operands)
      and ``GEMM(m, k, n-1)`` (accumulation into ``(m, k)``);
    * ``TRSM(m, k)``  needs ``POTRF(k)`` and ``GEMM(m, k, k-1)``.
    """
    preds: dict[Task, tuple[Task, ...]] = {}
    for k in range(nt):
        for n in range(k):
            dep = [trsm(k, n)]
            if n > 0:
                dep.append(syrk(k, n - 1))
            preds[syrk(k, n)] = tuple(dep)
        preds[potrf(k)] = (syrk(k, k - 1),) if k > 0 else ()
        for m in range(k + 1, nt):
            for n in range(k):
                dep = [trsm(m, n), trsm(k, n)]
                if n > 0:
                    dep.append(gemm(m, k, n - 1))
                preds[gemm(m, k, n)] = tuple(dep)
            dep = [potrf(k)]
            if k > 0:
                dep.append(gemm(m, k, k - 1))
            preds[trsm(m, k)] = tuple(dep)
    return TaskDag(preds)


def emit_pipelined_streams(nt: int, tb: int, ndev: int, policy: str,
                           cache_slots: int, plan: PrecisionPlan,
                           grid: tuple, lookahead: int):
    """Walk the task DAG and emit per-device op streams + dispatch chunks.

    Returns ``(streams, dispatch, caches)`` where ``dispatch`` is the
    list of ``(dev, start, stop, k, phase)`` chunk tuples in dispatch
    order (``None`` for ``lookahead = 0``, where the historical
    column-major order is derivable from the streams) and ``caches`` is
    the per-device cache-table list (``None`` for policies without an
    operand cache).  Called through
    :func:`repro.core.schedule.build_multidevice_schedule`; see that
    docstring for the schedule semantics.
    """
    from .schedule import Op, OpKind, _CacheTable

    p, q = grid
    L = lookahead
    operand_cache = policy in ("v2", "v3")
    reuse_accum = policy in ("v1", "v2", "v3")
    pin_diag = policy == "v3"
    panel_base = cache_slots

    dag = build_task_dag(nt)
    streams: list[list[Op]] = [[] for _ in range(ndev)]
    emits = [s.append for s in streams]
    caches = ([_CacheTable(cache_slots, emits[d], plan, tb)
               for d in range(ndev)] if operand_cache else None)
    dispatch: list[tuple] = []
    committed = [0] * ndev              # stream prefix already chunked
    pending: list[list[Op]] = [[] for _ in range(ndev)]  # queued RECVs

    def close_chunk(d, k, phase):
        end = len(streams[d])
        if end > committed[d]:
            dispatch.append((d, committed[d], end, k, phase))
            committed[d] = end

    def flush_pending(d):
        for op in pending[d]:
            emits[d](op)
        pending[d].clear()

    def pslot(kc, n):
        """Rotating panel region: column kc's RECVed tile (kc, n)."""
        return panel_base + (kc % (L + 1)) * nt + n

    def tbytes(i, j):
        cls = int(plan.classes[i, j])
        return cls, BYTES[plan.ladder[cls]] * tb * tb

    def ccls(*tiles):
        return max(int(plan.classes[i, j]) for i, j in tiles)

    def store(d, i, j, s, k):
        cls, nb = tbytes(i, j)
        emits[d](Op(OpKind.STORE, i=i, j=j, slot_c=s, cls=cls, bytes=nb, k=k))

    def naive_load(d, i, j, k, slot):
        cls, nb = tbytes(i, j)
        emits[d](Op(OpKind.LOAD, i=i, j=j, slot_c=slot, cls=cls, bytes=nb,
                    k=k))
        return slot

    def push_panel(kc, n, sender):
        """Ship finalized panel tile (kc, n) of column kc to the other
        devices of grid column ``kc % q`` (BCAST on the sender stream;
        RECVs queued so they land at the head of the receiver's next
        dispatch chunk, never inside one already being emitted)."""
        receivers = [grid_owner(r, kc, p, q) for r in range(p)
                     if r != kc % p]
        if not receivers:
            return
        cls, nb = tbytes(kc, n)
        emits[sender](Op(OpKind.BCAST, i=kc, j=n, cls=cls,
                         bytes=nb * len(receivers), k=kc, src=sender))
        for d in receivers:
            pending[d].append(Op(OpKind.RECV, i=kc, j=n, slot_c=pslot(kc, n),
                                 cls=cls, bytes=nb, k=kc, src=sender))

    def push_row_peers(k, m, d):
        """Row-scoped ownership broadcast (q > 1 only): host-slab
        coherence for the grid-row peers that later load (m, k)."""
        receivers = [grid_owner(m, c, p, q) for c in range(q) if c != k % q]
        if not receivers:
            return
        cls, nb = tbytes(m, k)
        emits[d](Op(OpKind.BCAST, i=m, j=k, cls=cls,
                    bytes=nb * len(receivers), k=k, src=d))
        for r in receivers:
            emits[r](Op(OpKind.RECV, i=m, j=k, slot_c=-1,
                        cls=cls, bytes=nb, k=k, src=d))

    def update_rows(d, kc, n_lo, n_hi, finalize):
        """Update sweep ``n in [n_lo, n_hi)`` over device d's rows of
        column kc; ``finalize`` adds TRSM + broadcasts + eager pushes
        (the final chunk), otherwise the partial accumulator is stored
        back so an advance chunk's work survives any later eviction."""
        for m in range(kc + 1, nt):
            if grid_owner(m, kc, p, q) != d:
                continue
            local = m % p == kc % p   # row-kc operands on-device vs panel
            if operand_cache:
                cache = caches[d]
                c = cache.load(m, kc, kc, pin=True)
                for n in range(n_lo, n_hi):
                    a = cache.load(m, n, kc, pin=True)
                    b = (cache.load(kc, n, kc, pin=True) if local
                         else pslot(kc, n))
                    emits[d](Op(OpKind.GEMM, slot_c=c, slot_a=a, slot_b=b,
                                k=kc, cls=ccls((m, n), (kc, n))))
                    dag.complete(gemm(m, kc, n))
                    cache.unpin(a)
                    if local:
                        cache.unpin(b)
                if finalize:
                    dslot = (cache.load(kc, kc, kc, pin=True) if local
                             else pslot(kc, kc))
                    emits[d](Op(OpKind.TRSM, slot_c=c, slot_a=dslot, k=kc,
                                cls=ccls((kc, kc), (m, kc))))
                    dag.complete(trsm(m, kc))
                    if local and not pin_diag:
                        cache.unpin(dslot)
                store(d, m, kc, c, kc)
                if finalize:
                    cache.adopt(m, kc, c)
                cache.unpin(c)
            elif reuse_accum:  # v1
                c = naive_load(d, m, kc, kc, 0)
                for n in range(n_lo, n_hi):
                    a = naive_load(d, m, n, kc, 1)
                    b = (naive_load(d, kc, n, kc, 2) if local
                         else pslot(kc, n))
                    emits[d](Op(OpKind.GEMM, slot_c=c, slot_a=a, slot_b=b,
                                k=kc, cls=ccls((m, n), (kc, n))))
                    dag.complete(gemm(m, kc, n))
                if finalize:
                    dslot = (naive_load(d, kc, kc, kc, 3) if local
                             else pslot(kc, kc))
                    emits[d](Op(OpKind.TRSM, slot_c=c, slot_a=dslot, k=kc,
                                cls=ccls((kc, kc), (m, kc))))
                    dag.complete(trsm(m, kc))
                store(d, m, kc, c, kc)
            else:  # sync
                for n in range(n_lo, n_hi):
                    c = naive_load(d, m, kc, kc, 0)
                    a = naive_load(d, m, n, kc, 1)
                    b = (naive_load(d, kc, n, kc, 2) if local
                         else pslot(kc, n))
                    emits[d](Op(OpKind.GEMM, slot_c=c, slot_a=a, slot_b=b,
                                k=kc, cls=ccls((m, n), (kc, n))))
                    dag.complete(gemm(m, kc, n))
                    store(d, m, kc, c, kc)
                if finalize:
                    c = naive_load(d, m, kc, kc, 0)
                    dslot = (naive_load(d, kc, kc, kc, 1) if local
                             else pslot(kc, kc))
                    emits[d](Op(OpKind.TRSM, slot_c=c, slot_a=dslot, k=kc,
                                cls=ccls((kc, kc), (m, kc))))
                    dag.complete(trsm(m, kc))
                    store(d, m, kc, c, kc)
            if finalize:
                push_row_peers(kc, m, d)
                if 0 < m - kc <= L:
                    # eager panel push: (m, kc) is a panel tile of a
                    # column inside the lookahead window — ship it now
                    # instead of at column m's POTRF step
                    push_panel(m, kc, d)

    def update_diag(d, kc, n_lo, n_hi, finalize):
        """Diagonal update sweep ``n in [n_lo, n_hi)`` on the owner;
        ``finalize`` adds the POTRF (the final chunk)."""
        if not finalize and n_hi <= n_lo:
            return -1
        if operand_cache:
            cache = caches[d]
            c = cache.load(kc, kc, kc, pin=True)
            for n in range(n_lo, n_hi):
                a = cache.load(kc, n, kc, pin=True)
                emits[d](Op(OpKind.SYRK, slot_c=c, slot_a=a, k=kc,
                            cls=ccls((kc, n))))
                dag.complete(syrk(kc, n))
                cache.unpin(a)
            if finalize:
                emits[d](Op(OpKind.POTRF, slot_c=c, k=kc,
                            cls=ccls((kc, kc))))
                dag.complete(potrf(kc))
            store(d, kc, kc, c, kc)
            cache.unpin(c)
            if finalize:
                cache.adopt(kc, kc, c, pin=pin_diag)
            return c
        if reuse_accum:  # v1
            c = naive_load(d, kc, kc, kc, 0)
            for n in range(n_lo, n_hi):
                a = naive_load(d, kc, n, kc, 1)
                emits[d](Op(OpKind.SYRK, slot_c=c, slot_a=a, k=kc,
                            cls=ccls((kc, n))))
                dag.complete(syrk(kc, n))
            if finalize:
                emits[d](Op(OpKind.POTRF, slot_c=c, k=kc,
                            cls=ccls((kc, kc))))
                dag.complete(potrf(kc))
            store(d, kc, kc, c, kc)
            return c
        # sync
        for n in range(n_lo, n_hi):
            c = naive_load(d, kc, kc, kc, 0)
            a = naive_load(d, kc, n, kc, 1)
            emits[d](Op(OpKind.SYRK, slot_c=c, slot_a=a, k=kc,
                        cls=ccls((kc, n))))
            dag.complete(syrk(kc, n))
            store(d, kc, kc, c, kc)
        if finalize:
            c = naive_load(d, kc, kc, kc, 0)
            emits[d](Op(OpKind.POTRF, slot_c=c, k=kc, cls=ccls((kc, kc))))
            dag.complete(potrf(kc))
            store(d, kc, kc, c, kc)
            return c
        return -1

    for s in range(nt):
        ow = grid_owner(s, s, p, q)
        # final-chunk update range: everything the advance chunk (emitted
        # L steps ago, covering n < s-L) did not already apply
        lo = max(0, s - L) if L > 0 else 0

        # ---- final chunk, owner head: last updates + POTRF + panel push
        diag_slot = update_diag(ow, s, lo, s, finalize=True)
        if L == 0:
            for n in range(s + 1):
                push_panel(s, n, ow)
        else:
            # tiles (s, n < s) were bulk/eager-pushed in earlier steps;
            # only the fresh diagonal factor remains
            push_panel(s, s, ow)
        close_chunk(ow, s, "panel")

        # ---- final chunk, grid-column workers: rows of column s ----
        workers = [grid_owner(r, s, p, q) for r in range(p)
                   if grid_owner(r, s, p, q) != ow]
        for d in [ow] + workers:
            flush_pending(d)   # panel RECVs queued for this column
            update_rows(d, s, lo, s, finalize=True)
            if d == ow and operand_cache and pin_diag:
                caches[ow].unpin(diag_slot)
            close_chunk(d, s, "update")

        # ---- row-scoped host-landing receives (q > 1 only) ----
        for d in range(ndev):
            if d != ow and d % q != s % q:
                close_chunk(d, s, "recv")

        # ---- eager panel receives queued by this column's finalizers ----
        for d in range(ndev):
            if pending[d]:
                flush_pending(d)
                close_chunk(d, s, "recv-ahead")

        # ---- advance chunk: open column s+L's window ----
        kf = s + L
        if L > 0 and kf < nt and s > 0:
            owf = grid_owner(kf, kf, p, q)
            for n in range(s):
                push_panel(kf, n, owf)   # bulk push of already-final tiles
            close_chunk(owf, kf, "push")
            peers = [grid_owner(r, kf, p, q) for r in range(p)
                     if grid_owner(r, kf, p, q) != owf]
            for d in [owf] + peers:
                flush_pending(d)
                if d == owf:
                    update_diag(owf, kf, 0, s, finalize=False)
                update_rows(d, kf, 0, s, finalize=False)
                close_chunk(d, kf, "advance")

    assert dag.all_done(), \
        f"emitter dropped {len(dag.preds) - len(dag.done)} tasks"
    assert all(not pend for pend in pending)
    assert all(committed[d] == len(streams[d]) for d in range(ndev))
    return streams, (dispatch if L > 0 else None), caches


def verify_dispatch(msched) -> int:
    """Symbolically replay a schedule's dispatch order and assert DAG
    safety: no compute op consumes a tile before its predecessors
    completed, broadcasts only ship finalized tiles, accumulations apply
    in order, and every task of the graph runs exactly once.

    Tracks per-device slot contents, per-device host slabs (the 2D-grid
    coherence surface), and broadcast wires — an independent referee for
    the emitter *and* for the dispatch order executors replay (the same
    ``iter_dispatch_order`` both the NumPy replay and the JAX executor
    follow).  Returns the number of verified compute tasks.
    """
    from .schedule import OpKind

    nt = msched.nt
    p, q = msched.grid
    dag = build_task_dag(nt)
    FINAL = "final"
    # version of a tile = number of update sweeps applied, or FINAL
    host: list[dict] = [dict() for _ in range(msched.ndev)]
    for d in range(msched.ndev):
        for i in range(nt):
            if i % p == d // q:
                for j in range(i + 1):
                    host[d][(i, j)] = 0
    slots: list[dict] = [dict() for _ in range(msched.ndev)]
    wires: dict = {}

    for d, op in msched.iter_dispatch_order():
        kind = op.kind
        if kind is OpKind.LOAD:
            slots[d][op.slot_c] = ((op.i, op.j), host[d][(op.i, op.j)])
        elif kind is OpKind.STORE:
            tile, v = slots[d][op.slot_c]
            assert tile == (op.i, op.j), (op, tile)
            host[d][tile] = v
        elif kind is OpKind.BCAST:
            wires[(op.i, op.j, op.k, op.src)] = host[op.src][(op.i, op.j)]
        elif kind is OpKind.RECV:
            v = wires[(op.i, op.j, op.k, op.src)]
            assert v == FINAL, f"broadcast of unfinalized tile: {op} ({v})"
            if op.slot_c < 0:
                host[d][(op.i, op.j)] = v
            else:
                slots[d][op.slot_c] = ((op.i, op.j), v)
        elif kind is OpKind.SYRK:
            (ci, cj), v = slots[d][op.slot_c]
            (ai, aj), av = slots[d][op.slot_a]
            assert ci == cj and ai == ci, (op, (ci, cj), (ai, aj))
            assert av == FINAL, f"SYRK reads unfinalized operand: {op}"
            assert v == aj, f"out-of-order accumulation: {op} v={v} n={aj}"
            dag.complete(syrk(ci, aj))
            slots[d][op.slot_c] = ((ci, cj), v + 1)
        elif kind is OpKind.GEMM:
            (ci, cj), v = slots[d][op.slot_c]
            (ai, aj), av = slots[d][op.slot_a]
            (bi, bj), bv = slots[d][op.slot_b]
            assert ai == ci and bi == cj and aj == bj, (op,)
            assert av == FINAL and bv == FINAL, \
                f"GEMM reads unfinalized operand: {op}"
            assert v == aj, f"out-of-order accumulation: {op} v={v} n={aj}"
            dag.complete(gemm(ci, cj, aj))
            slots[d][op.slot_c] = ((ci, cj), v + 1)
        elif kind is OpKind.POTRF:
            (ci, cj), v = slots[d][op.slot_c]
            assert ci == cj and v == ci, f"POTRF before all updates: {op}"
            dag.complete(potrf(ci))
            slots[d][op.slot_c] = ((ci, cj), FINAL)
        elif kind is OpKind.TRSM:
            (ci, cj), v = slots[d][op.slot_c]
            (ai, aj), av = slots[d][op.slot_a]
            assert (ai, aj) == (cj, cj), (op,)
            assert av == FINAL, f"TRSM reads unfinalized diagonal: {op}"
            assert v == cj, f"TRSM before all updates: {op} v={v}"
            dag.complete(trsm(ci, cj))
            slots[d][op.slot_c] = ((ci, cj), FINAL)
        # ALLOC/FREE (async single-device streams) carry no value state
    assert dag.all_done(), \
        f"{len(dag.preds) - len(dag.done)} tasks never executed"
    return len(dag.done)
