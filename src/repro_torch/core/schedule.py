# A copy of repro/core/schedule.py, kept line for line so that the port builds
# the same plans and op streams (and digests) without importing repro.
"""Static task schedule for the left-looking tile Cholesky (Algorithms 1-3).

The paper's static scheduler assigns tasks ahead of time and consults a
runtime *cache table* (Algorithm 3) to decide whether a tile must be copied
host->device.  Because the schedule is deterministic, the entire cache
behaviour — every hit, miss, and eviction — is computable *before* execution.

This module replays Algorithms 1+2+3 in Python and emits a flat list of
:class:`Op` records (LOAD / compute / STORE).  The emitted program contains
exactly the transfers the paper's runtime would perform; executors
(``cholesky.py``) simply trace it, and ``analytics.py`` folds it into the
byte-volume numbers of Fig. 8 / Fig. 12.

Policies (paper §IV-A/B):
  * ``sync`` / ``async`` — naive OOC: every task loads its operands and
    stores its output.  (``async`` differs at runtime by multi-stream
    overlap and per-tile malloc/free; the op stream is identical, the
    allocation events are counted for the analytics.)
  * ``v1``  — the accumulator tile C of ``C = -A @ B.T + C`` is loaded once
    per update sweep and stored once when it reaches its final state.
  * ``v2``  — V1 + operand cache table: GEMM/SYRK/TRSM operands already on
    the device are reused; least-recently-used unpinned slots are repurposed
    when the device memory budget is exhausted.
  * ``v3``  — V2 + the column's diagonal tile is pinned until every TRSM of
    that column block has consumed it.

Multi-device (paper §IV-D, Fig. 5/9): :func:`build_multidevice_schedule`
extends the same static trace to ``ndev`` devices arranged as a ``p x q``
block-cyclic grid (``grid=(p, q)``, ``p*q == ndev``; the default
``(ndev, 1)`` is the paper's 1D tile-row ownership) and emits *one op
stream per device*, each with its own cache table.  Tile ``(i, j)``
belongs to device ``(i % p) * q + (j % q)``
(:meth:`TileLayout.owner_grid`); the column-``k`` tasks therefore all
live on the ``p`` devices of grid column ``k % q``, and two scoped
partial broadcasts are the only inter-device communication:

* **column-scoped panel broadcast** — after the diagonal owner of step
  ``k`` finalizes ``(k, k)``, it ships the panel row ``(k, 0..k)`` to the
  ``p - 1`` other devices of grid column ``k % q`` (one ``BCAST`` per
  tile on the owner stream, bytes = tile bytes x receivers; one ``RECV``
  per receiver into its dedicated panel slot ``panel_base + n``);
* **row-scoped ownership broadcast** (``q > 1`` only) — when a device
  finalizes column tile ``(m, k)`` it ships it to the ``q - 1`` peers of
  grid row ``m % p``, whose *host slabs* must stay coherent for the
  later steps where they load ``(m, k)`` as a GEMM operand.  These
  ``RECV`` ops land host-side (``slot_c = -1``), not in a device slot.

With ``grid=(ndev, 1)`` the row-scoped broadcast is empty and the stream
is op-for-op the 1D schedule of earlier releases: each tile-row is
broadcast once per factorization to all ``ndev - 1`` peers and the
collective volume matches ``distributed.panel_broadcast_bytes`` exactly.
A 2D grid trades that for ``(p-1)`` panel receivers plus ``(q-1)``
ownership receivers — ``distributed.grid_broadcast_bytes`` — which is
strictly less for every true 2D factorization of ``ndev >= 2`` (the
classic O(sqrt(P)) communication argument, Donfack et al. 2011).
Everything else — operand loads, accumulator stores, cache decisions — is
device-local and policy-identical to the single-device trace; with
``ndev=1`` no BCAST/RECV is emitted and the stream's byte volumes equal
:func:`build_schedule`'s.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from .precision import PrecisionPlan, BYTES, uniform_plan
from .tiling import grid_owner


def min_cache_slots(policy: str, block: tuple = (4, 4),
                    lookahead: int = 0) -> int:
    """Smallest device-slot budget a policy's schedule can be built with.

    These are the worst-case *concurrent pin* counts of each builder (one
    victim slot must remain findable at every cache load), previously
    inlined where they were needed:

      * ``sync``/``async`` use fixed slots 0..2 (C, A, B);
      * ``v1`` adds slot 3 for the TRSM diagonal;
      * ``v2`` pins C+A+B during a GEMM;
      * ``v3`` additionally keeps the column's diagonal tile pinned;
      * ``v4`` pins an h x w accumulator block plus w panel operands plus
        the A operand and the diagonal (``h*w + w + 2``).

    Each lookahead depth of a pipelined multi-device schedule pins one
    extra slot on top: the advance chunks of an in-flight panel hold
    their own accumulator/operand pins concurrently with the final
    chunk's, and the panel-slot region itself starts at ``cache_slots``
    (growing the budget moves ``panel_base`` up with it).

    The tuner's feasibility filter and ``CholeskyConfig``'s eager
    validation both consult this instead of re-deriving the constants.
    """
    policy = policy.lower()
    if policy == "v4":
        h, w = block
        return h * w + w + 2
    return ({"sync": 3, "async": 3, "v1": 4, "v2": 3, "v3": 4}[policy]
            + lookahead)


def default_cache_slots(policy: str, nt: int, block: tuple = (4, 4),
                        multidevice: bool = False,
                        lookahead: int = 0) -> int:
    """Slot budget the builders use when ``cache_slots`` is 0 (unset).

    Exactly the historical inlined defaults (golden op streams depend on
    them): ``2*nt + 2`` (floor 4) for the cache-table policies, the fixed
    4-slot window for multi-device sync/v1, and ``h*w + h + w + 4`` for
    the 2D-blocked v4 — plus one slot per lookahead depth (see
    :func:`min_cache_slots`).
    """
    policy = policy.lower()
    if policy == "v4":
        h, w = block
        return h * w + h + w + 4
    if multidevice and policy not in ("v2", "v3"):
        return 4 + lookahead
    return max(4, nt * 2 + 2) + lookahead


class OpKind(enum.Enum):
    LOAD = "load"        # host tile (i,j) -> device slot (cast to tile class)
    STORE = "store"      # device slot -> host tile (i,j) (cast to tile class)
    SYRK = "syrk"        # C[slot_c] += -A[slot_a] @ A[slot_a].T
    GEMM = "gemm"        # C[slot_c] += -A[slot_a] @ B[slot_b].T
    POTRF = "potrf"      # C[slot_c] = chol(C[slot_c])
    TRSM = "trsm"        # C[slot_c] = C[slot_c] @ inv(L[slot_a]).T
    ALLOC = "alloc"      # async policy only: per-tile cudaMalloc analogue
    FREE = "free"
    BCAST = "bcast"      # owner device sends tile (i,j) to all peers
    RECV = "recv"        # peer device receives tile (i,j) into a panel slot
    FETCH = "fetch"      # disk tile (i,j) -> host slab slot_c (bytes=0: bind
    #                      the slab without reading — the next op overwrites)
    SPILL = "spill"      # host slab slot_c -> disk tile (i,j)


#: ops that move data on the host<->disk tier; their ``slot_c`` is a *host
#: slab* index, not a device slot (executors and slot sizing must skip them)
HOST_IO = frozenset((OpKind.FETCH, OpKind.SPILL))


@dataclasses.dataclass(frozen=True)
class Op:
    kind: OpKind
    i: int = -1              # tile row (LOAD/STORE target tile)
    j: int = -1              # tile col
    slot_c: int = -1         # destination / accumulator slot
    slot_a: int = -1         # first operand slot
    slot_b: int = -1         # second operand slot
    cls: int = 0             # precision class (index into plan.ladder)
    bytes: int = 0           # transfer bytes (LOAD/STORE/BCAST/RECV only)
    k: int = -1              # column step this op belongs to (for tracing)
    src: int = -1            # source device (BCAST/RECV only)


def _ops_digest_update(h, ops) -> None:
    for o in ops:
        h.update((f"{o.kind.value}:{o.i},{o.j},{o.slot_c},{o.slot_a},"
                  f"{o.slot_b},{o.cls},{o.bytes},{o.k},{o.src};").encode())


@dataclasses.dataclass
class Schedule:
    ops: list[Op]
    nt: int
    tb: int
    policy: str
    cache_slots: int
    plan: PrecisionPlan
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    host_slots: int = 0      # >0: host cache bounded, SPILL/FETCH in stream

    def loads_bytes(self) -> int:
        return sum(o.bytes for o in self.ops if o.kind is OpKind.LOAD)

    def stores_bytes(self) -> int:
        return sum(o.bytes for o in self.ops if o.kind is OpKind.STORE)

    def fetch_bytes(self) -> int:
        return sum(o.bytes for o in self.ops if o.kind is OpKind.FETCH)

    def spill_bytes(self) -> int:
        return sum(o.bytes for o in self.ops if o.kind is OpKind.SPILL)

    def flops(self) -> float:
        """Model FLOPs of the factorization: n^3/3 for the full matrix."""
        n = self.nt * self.tb
        return n**3 / 3.0

    def count(self, kind: OpKind) -> int:
        return sum(1 for o in self.ops if o.kind is kind)

    def digest(self) -> str:
        """Content hash of the op stream (golden-schedule regression).

        A spill schedule (``host_slots > 0``) folds the host-slab budget
        in as executor-facing metadata — the slab buffer the executors
        size from it is as execution-visible as an op; plain schedules
        hash ops only so historical digests stay valid."""
        import hashlib
        h = hashlib.sha256()
        if self.host_slots > 0:
            h.update(f"|hslots{self.host_slots}|".encode())
        _ops_digest_update(h, self.ops)
        return h.hexdigest()[:16]


class _CacheTable:
    """Trace-time replay of Algorithm 3 (load_tile with cache table).

    O(1) amortized per access: free slots on a stack, LRU order in an
    OrderedDict (linear scans made 100k-tile schedules untraceable)."""

    def __init__(self, slots: int, emit, plan: PrecisionPlan, tb: int):
        import collections
        self.slots = slots
        self.emit = emit
        self.plan = plan
        self.tb = tb
        self.where: dict[tuple[int, int], int] = {}   # tile -> slot
        self.resident: list[Optional[tuple[int, int]]] = [None] * slots
        self.pinned: set[int] = set()
        self.free: list[int] = list(range(slots - 1, -1, -1))
        self.lru = collections.OrderedDict()          # slot -> None, LRU first
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _touch(self, s: int):
        self.lru[s] = None
        self.lru.move_to_end(s)

    def _victim(self) -> int:
        while self.free:
            s = self.free.pop()
            if self.resident[s] is None:
                return s
        for s in self.lru:
            if s not in self.pinned:
                return s
        raise RuntimeError(
            f"cache thrash: all {self.slots} slots pinned; "
            "increase cache_slots"
        )

    def lookup(self, i: int, j: int) -> Optional[int]:
        return self.where.get((i, j))

    def load(self, i: int, j: int, k: int, pin: bool = False,
             cacheable: bool = True) -> int:
        """Algorithm 3: return a slot holding tile (i, j), loading on miss."""
        s = self.where.get((i, j))
        if s is not None:
            self.hits += 1
            self._touch(s)
            if pin:
                self.pinned.add(s)
            return s
        self.misses += 1
        s = self._victim()
        if self.resident[s] is not None:
            self.evictions += 1
            del self.where[self.resident[s]]
            self.lru.pop(s, None)
        cls = int(self.plan.classes[i, j])
        nbytes = BYTES[self.plan.ladder[cls]] * self.tb * self.tb
        self.emit(Op(OpKind.LOAD, i=i, j=j, slot_c=s, cls=cls, bytes=nbytes, k=k))
        if cacheable:
            self.resident[s] = (i, j)
            self.where[(i, j)] = s
        self._touch(s)
        if pin:
            self.pinned.add(s)
        return s

    def adopt(self, i: int, j: int, s: int, pin: bool = False):
        """Register a tile produced on-device (e.g. fresh L[k,k]) in slot s."""
        if self.resident[s] is not None and self.resident[s] != (i, j):
            self.where.pop(self.resident[s], None)
        self.resident[s] = (i, j)
        self.where[(i, j)] = s
        self._touch(s)
        if pin:
            self.pinned.add(s)

    def unpin(self, s: int):
        self.pinned.discard(s)

    def invalidate(self, i: int, j: int):
        s = self.where.pop((i, j), None)
        if s is not None:
            self.resident[s] = None
            self.pinned.discard(s)
            self.lru.pop(s, None)
            self.free.append(s)


def with_host_cache(ops: list[Op], tb: int, host_slots: int) -> list[Op]:
    """Bound a stream's host residency to ``host_slots`` slabs (disk tier).

    The third-tier analogue of the device cache table: the host store is
    no longer the full ``[Nt, Nt, tb, tb]`` array but a bounded cache of
    ``host_slots`` fp64 slabs over a disk-backed tile store
    (:class:`repro.core.spill.DiskTileStore`).  This post-pass replays
    the stream's host accesses through an LRU slab table and interleaves
    the tier traffic as explicit ops — the same ahead-of-time treatment
    Algorithm 3 gives device residency:

    * a host *read* (LOAD of an operand, BCAST publishing a tile) of a
      non-resident tile emits ``FETCH`` (disk -> slab, full tile bytes);
    * a host *write* (STORE, host-landing RECV) of a non-resident tile
      emits a binding ``FETCH`` with ``bytes = 0`` — the write fully
      overwrites the slab, so nothing is read from disk;
    * evicting a dirty slab (written since it was bound) emits ``SPILL``
      (slab -> disk); clean slabs are dropped for free;
    * at stream end every dirty resident slab is spilled, so the disk
      store finishes coherent and the scheduled SPILL/FETCH byte totals
      are exact ahead of time (the simulator's disk lane and the
      executors replay precisely these ops).

    Host slabs always hold the fp64 host representation (8 bytes/elem),
    whatever the tile's precision class: the class cast happens on the
    device edge (LOAD/STORE), exactly as with the unbounded host store.
    """
    if host_slots < 1:
        raise ValueError(f"host_slots must be >= 1, got {host_slots}")
    import collections
    slab_bytes = 8 * tb * tb
    out: list[Op] = []
    where: dict[tuple[int, int], int] = {}     # tile -> slab
    tile_of: list[Optional[tuple[int, int]]] = [None] * host_slots
    dirty = [False] * host_slots
    free = list(range(host_slots - 1, -1, -1))
    lru = collections.OrderedDict()            # slab -> None, LRU first

    def touch(s: int):
        lru[s] = None
        lru.move_to_end(s)

    def ensure(i: int, j: int, k: int, read: bool):
        s = where.get((i, j))
        if s is not None:
            touch(s)
            return
        s = free.pop() if free else next(iter(lru))
        old = tile_of[s]
        if old is not None:
            if dirty[s]:
                out.append(Op(OpKind.SPILL, i=old[0], j=old[1], slot_c=s,
                              bytes=slab_bytes, k=k))
            del where[old]
            lru.pop(s, None)
        out.append(Op(OpKind.FETCH, i=i, j=j, slot_c=s,
                      bytes=slab_bytes if read else 0, k=k))
        tile_of[s] = (i, j)
        where[(i, j)] = s
        dirty[s] = False
        touch(s)

    last_k = 0
    for op in ops:
        if op.k >= 0:
            last_k = op.k
        if op.kind is OpKind.LOAD or op.kind is OpKind.BCAST:
            ensure(op.i, op.j, op.k, read=True)
        elif op.kind is OpKind.STORE or (op.kind is OpKind.RECV
                                         and op.slot_c < 0):
            ensure(op.i, op.j, op.k, read=False)
            dirty[where[(op.i, op.j)]] = True
        out.append(op)
    for s in range(host_slots):
        if tile_of[s] is not None and dirty[s]:
            out.append(Op(OpKind.SPILL, i=tile_of[s][0], j=tile_of[s][1],
                          slot_c=s, bytes=slab_bytes, k=last_k))
    return out


def build_schedule(
    nt: int,
    tb: int,
    policy: str = "v3",
    cache_slots: int = 0,
    plan: PrecisionPlan | None = None,
    block: tuple = (4, 4),
    host_slots: int = 0,
) -> Schedule:
    """Emit the static op stream for one left-looking tile Cholesky.

    ``v4`` is the beyond-paper 2D-blocked left-looking variant (see
    :func:`_build_v4`); ``block=(h, w)`` are its row/column block sizes.
    ``host_slots > 0`` bounds the host tier to that many fp64 tile slabs
    over a disk-backed store and interleaves the SPILL/FETCH traffic
    into the stream (:func:`with_host_cache`); 0 keeps the historical
    unbounded host store (no disk tier, digests unchanged).
    """
    policy = policy.lower()
    if policy not in ("sync", "async", "v1", "v2", "v3", "v4"):
        raise ValueError(f"unknown policy {policy!r}")
    if plan is None:
        plan = uniform_plan(nt)
    if plan.classes.shape[0] != nt:
        raise ValueError("precision plan Nt mismatch")
    if host_slots < 0:
        raise ValueError(f"host_slots must be >= 0, got {host_slots}")
    if policy == "v4":
        sched = _build_v4(nt, tb, plan, cache_slots, block)
        if host_slots > 0:
            sched.ops = with_host_cache(sched.ops, tb, host_slots)
            sched.host_slots = host_slots
        return sched
    if cache_slots <= 0:
        cache_slots = default_cache_slots(policy, nt)

    def finish(sched: Schedule) -> Schedule:
        if host_slots > 0:
            sched.ops = with_host_cache(sched.ops, tb, host_slots)
            sched.host_slots = host_slots
        return sched

    ops: list[Op] = []
    emit = ops.append

    def ccls(*tiles: tuple[int, int]) -> int:
        """Compute class of a task = lowest precision among its operands
        (tensor-core engines run at the rate of the narrowest operand)."""
        return max(int(plan.classes[i, j]) for i, j in tiles)
    operand_cache = policy in ("v2", "v3")
    reuse_accum = policy in ("v1", "v2", "v3")
    pin_diag = policy == "v3"
    per_task_alloc = policy == "async"

    cache = _CacheTable(cache_slots, emit, plan, tb)

    def store(i, j, s, k):
        cls = int(plan.classes[i, j])
        emit(Op(OpKind.STORE, i=i, j=j, slot_c=s, cls=cls,
                bytes=BYTES[plan.ladder[cls]] * tb * tb, k=k))

    def naive_load(i, j, k, slot):
        """sync/async path: unconditional transfer into a fixed slot."""
        cls = int(plan.classes[i, j])
        if per_task_alloc:
            emit(Op(OpKind.ALLOC, i=i, j=j, slot_c=slot, k=k))
        emit(Op(OpKind.LOAD, i=i, j=j, slot_c=slot, cls=cls,
                bytes=BYTES[plan.ladder[cls]] * tb * tb, k=k))
        return slot

    if not reuse_accum:
        # ---- sync / async: no cache table, fixed slots 0=C, 1=A, 2=B ----
        for k in range(nt):
            # diagonal tile
            for n in range(k):
                c = naive_load(k, k, k, 0)
                a = naive_load(k, n, k, 1)
                emit(Op(OpKind.SYRK, slot_c=c, slot_a=a, k=k, cls=ccls((k, n))))
                store(k, k, c, k)
                if per_task_alloc:
                    emit(Op(OpKind.FREE, slot_c=1, k=k))
            c = naive_load(k, k, k, 0)
            emit(Op(OpKind.POTRF, slot_c=c, k=k, cls=ccls((k, k))))
            store(k, k, c, k)
            # off-diagonal tiles of column k
            for m in range(k + 1, nt):
                for n in range(k):
                    c = naive_load(m, k, k, 0)
                    a = naive_load(m, n, k, 1)
                    b = naive_load(k, n, k, 2)
                    emit(Op(OpKind.GEMM, slot_c=c, slot_a=a, slot_b=b, k=k, cls=ccls((m, n), (k, n))))
                    store(m, k, c, k)
                    if per_task_alloc:
                        emit(Op(OpKind.FREE, slot_c=1, k=k))
                        emit(Op(OpKind.FREE, slot_c=2, k=k))
                c = naive_load(m, k, k, 0)
                d = naive_load(k, k, k, 1)
                emit(Op(OpKind.TRSM, slot_c=c, slot_a=d, k=k, cls=ccls((k, k), (m, k))))
                store(m, k, c, k)
                if per_task_alloc:
                    emit(Op(OpKind.FREE, slot_c=0, k=k))
                    emit(Op(OpKind.FREE, slot_c=1, k=k))
        sched = Schedule(ops, nt, tb, policy, cache_slots, plan)
        sched.misses = sched.count(OpKind.LOAD)
        return finish(sched)

    if not operand_cache:
        # ---- V1: accumulator reuse only, no cache table ----
        # Fixed slots: 0 = accumulator C, 1 = operand A, 2 = operand B,
        # 3 = diagonal for TRSM.  Every operand access transfers.
        for k in range(nt):
            c = naive_load(k, k, k, 0)       # accumulator: loaded ONCE
            for n in range(k):
                a = naive_load(k, n, k, 1)
                emit(Op(OpKind.SYRK, slot_c=c, slot_a=a, k=k, cls=ccls((k, n))))
            emit(Op(OpKind.POTRF, slot_c=c, k=k, cls=ccls((k, k))))
            store(k, k, c, k)                # stored ONCE, in final state
            for m in range(k + 1, nt):
                c = naive_load(m, k, k, 0)
                for n in range(k):
                    a = naive_load(m, n, k, 1)
                    b = naive_load(k, n, k, 2)
                    emit(Op(OpKind.GEMM, slot_c=c, slot_a=a, slot_b=b, k=k, cls=ccls((m, n), (k, n))))
                d = naive_load(k, k, k, 3)   # V1: diagonal reloaded per TRSM
                emit(Op(OpKind.TRSM, slot_c=c, slot_a=d, k=k, cls=ccls((k, k), (m, k))))
                store(m, k, c, k)
        sched = Schedule(ops, nt, tb, policy, cache_slots, plan)
        sched.misses = sched.count(OpKind.LOAD)
        return finish(sched)

    # ---- V2/V3: accumulator reuse + cache table for operands ----
    for k in range(nt):
        # --- diagonal tile A[k,k]: SYRK sweep then POTRF ---
        c = cache.load(k, k, k, pin=True)
        for n in range(k):
            a = cache.load(k, n, k, pin=True)
            emit(Op(OpKind.SYRK, slot_c=c, slot_a=a, k=k, cls=ccls((k, n))))
            cache.unpin(a)
        emit(Op(OpKind.POTRF, slot_c=c, k=k, cls=ccls((k, k))))
        store(k, k, c, k)
        # the fresh diagonal factor stays registered; V3 pins it for the
        # whole column block (paper Fig. 3c)
        cache.unpin(c)
        cache.adopt(k, k, c, pin=pin_diag)
        diag_slot = c

        # --- off-diagonal tiles A[m,k]: GEMM sweep then TRSM ---
        for m in range(k + 1, nt):
            c = cache.load(m, k, k, pin=True)
            for n in range(k):
                a = cache.load(m, n, k, pin=True)
                b = cache.load(k, n, k, pin=True)
                emit(Op(OpKind.GEMM, slot_c=c, slot_a=a, slot_b=b, k=k, cls=ccls((m, n), (k, n))))
                cache.unpin(a)
                cache.unpin(b)
            d = cache.load(k, k, k, pin=True)
            emit(Op(OpKind.TRSM, slot_c=c, slot_a=d, k=k, cls=ccls((k, k), (m, k))))
            if not pin_diag:
                cache.unpin(d)
            store(m, k, c, k)
            cache.adopt(m, k, c)   # factored tile stays reusable (V2/V3)
            cache.unpin(c)
        if pin_diag:
            cache.unpin(diag_slot)

    sched = Schedule(ops, nt, tb, policy, cache_slots, plan,
                     hits=cache.hits, misses=cache.misses,
                     evictions=cache.evictions)
    return finish(sched)


def _build_v4(nt: int, tb: int, plan: PrecisionPlan, cache_slots: int,
              block: tuple) -> Schedule:
    """Beyond-paper V4: 2D-blocked left-looking schedule.

    The paper's V1-V3 stream operands per GEMM: even with a perfect
    cache, the external-update sweep loads ~1 tile per GEMM once the
    working set exceeds the cache.  Blocking the update into (h rows x w
    panel columns) amortizes each loaded operand over h*w GEMMs:
    loads/GEMM ~ (h+w)/(h*w) ~ 2/w — the classic surface-to-volume
    trade, applied to the host-device link instead of a cache line.

    Structure per panel [k0, k0+w):
      phase 1 — external updates (n < k0) for all panel tiles, 2D-blocked;
                partially-updated accumulators are stored back (one extra
                triangular G2C pass vs V3 — cheap next to the C2G win);
      phase 2 — internal left-looking factorization of the w panel
                columns (operands are panel-resident).
    """
    h, w = block
    if cache_slots <= 0:
        cache_slots = default_cache_slots("v4", nt, block)
    if cache_slots < min_cache_slots("v4", block):
        raise ValueError(
            f"v4 needs >= h*w + w + 2 = {min_cache_slots('v4', block)} "
            f"slots, got {cache_slots}")

    ops: list[Op] = []
    emit = ops.append
    cache = _CacheTable(cache_slots, emit, plan, tb)

    def ccls(*tiles):
        return max(int(plan.classes[i, j]) for i, j in tiles)

    def store(i, j, s, k):
        cls = int(plan.classes[i, j])
        emit(Op(OpKind.STORE, i=i, j=j, slot_c=s, cls=cls,
                bytes=BYTES[plan.ladder[cls]] * tb * tb, k=k))

    for k0 in range(0, nt, w):
        k1 = min(k0 + w, nt)
        cols = list(range(k0, k1))

        # ---- phase 1: external updates, blocked (h rows x w cols) ----
        if k0 > 0:
            for m0 in range(k0, nt, h):
                rows = list(range(m0, min(m0 + h, nt)))
                accs = {}
                for m in rows:
                    for j in cols:
                        if j <= m:
                            accs[(m, j)] = cache.load(m, j, k0, pin=True)
                for n in range(k0):
                    bslots = {j: cache.load(j, n, k0, pin=True)
                              for j in cols}
                    for m in rows:
                        a = cache.load(m, n, k0, pin=True)
                        for j in cols:
                            if j > m:
                                continue
                            if m == j:
                                emit(Op(OpKind.SYRK, slot_c=accs[(m, j)],
                                        slot_a=a, k=k0, cls=ccls((m, n))))
                            else:
                                emit(Op(OpKind.GEMM, slot_c=accs[(m, j)],
                                        slot_a=a, slot_b=bslots[j], k=k0,
                                        cls=ccls((m, n), (j, n))))
                        cache.unpin(a)
                    for j in cols:
                        cache.unpin(bslots[j])
                # write partially-updated tiles back; host stays coherent
                for (m, j), s in accs.items():
                    store(m, j, s, k0)
                    cache.unpin(s)

        # ---- phase 2: internal panel factorization ----
        for j in cols:
            c = cache.load(j, j, j, pin=True)
            for n in range(k0, j):
                a = cache.load(j, n, j, pin=True)
                emit(Op(OpKind.SYRK, slot_c=c, slot_a=a, k=j,
                        cls=ccls((j, n))))
                cache.unpin(a)
            emit(Op(OpKind.POTRF, slot_c=c, k=j, cls=ccls((j, j))))
            store(j, j, c, j)
            cache.unpin(c)
            cache.adopt(j, j, c, pin=True)
            diag = c
            for m in range(j + 1, nt):
                c2 = cache.load(m, j, j, pin=True)
                for n in range(k0, j):
                    a = cache.load(m, n, j, pin=True)
                    b = cache.load(j, n, j, pin=True)
                    emit(Op(OpKind.GEMM, slot_c=c2, slot_a=a, slot_b=b,
                            k=j, cls=ccls((m, n), (j, n))))
                    cache.unpin(a)
                    cache.unpin(b)
                d = cache.load(j, j, j, pin=True)
                emit(Op(OpKind.TRSM, slot_c=c2, slot_a=d, k=j,
                        cls=ccls((j, j), (m, j))))
                if d != diag:
                    cache.unpin(d)
                store(m, j, c2, j)
                cache.adopt(m, j, c2)
                cache.unpin(c2)
            cache.unpin(diag)

    return Schedule(ops, nt, tb, "v4", cache_slots, plan,
                    hits=cache.hits, misses=cache.misses,
                    evictions=cache.evictions)


# ---------------------------------------------------------------------------
# Multi-device static schedule (paper §IV-D, Fig. 5/9)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MultiDeviceSchedule:
    """One static op stream per device, ``p x q`` block-cyclic ownership.

    Stream ``d`` contains every op device ``d`` executes, in order; the
    only cross-stream edges are BCAST (sender) -> RECV (receivers) pairs:
    the column-scoped panel broadcast (RECV into a panel slot) and, for
    2D grids (``q > 1``), the row-scoped ownership broadcast of each
    finalized column tile (RECV with ``slot_c = -1``, landing in the
    receiver's host slab).  ``grid`` is the device grid ``(p, q)``
    (``(ndev, 1)`` = the 1D tile-row layout).  ``hits``/``misses``/
    ``evictions`` are per-device cache-table counters (v2/v3 only).

    ``panel_base`` is the executor-facing slot contract: every slot id
    ``>= panel_base`` is a *panel slot* — the dedicated landing region for
    RECVed row-``k`` tiles (tile ``(k, n)`` lands in ``panel_base + n``),
    outside the cache table's managed range, so a broadcast tile can never
    be evicted by a device-local operand load.  Executors (the NumPy
    replay and the per-device JAX executor) size each device's slot
    buffer with :meth:`stream_nslots`.

    This is the *unified* schedule type of the public API: a single-device
    :class:`Schedule` is represented as its ``ndev=1`` degenerate form via
    :meth:`from_single` (one stream, no BCAST/RECV), so planners and
    executors expose one type instead of the old
    ``Schedule | MultiDeviceSchedule`` union.  :meth:`to_single` recovers
    the flat view where a single op list is needed (executors, the
    three-engine simulator).
    """
    streams: list[list[Op]]
    nt: int
    tb: int
    ndev: int
    policy: str
    cache_slots: int
    plan: PrecisionPlan
    hits: list[int] = dataclasses.field(default_factory=list)
    misses: list[int] = dataclasses.field(default_factory=list)
    evictions: list[int] = dataclasses.field(default_factory=list)
    panel_base: int = -1     # first panel slot id; -1 = no panel region
    grid: tuple = ()         # (p, q) device grid; () normalizes to (ndev, 1)
    lookahead: int = 0       # pipelined-panel depth (0 = column-major)
    dispatch: Optional[list] = None  # (dev, start, stop, k, phase) chunks;
    #                          None = derivable column-major order
    host_slots: int = 0      # >0: per-device host cache bounded to this many
    #                          slabs; streams carry SPILL/FETCH disk-tier ops

    def __post_init__(self):
        if not self.grid:
            self.grid = (self.ndev, 1)
        self.grid = tuple(self.grid)

    @classmethod
    def from_single(cls, sched: Schedule) -> "MultiDeviceSchedule":
        """Wrap a single-device schedule as the ndev=1 degenerate form."""
        return cls(streams=[list(sched.ops)], nt=sched.nt, tb=sched.tb,
                   ndev=1, policy=sched.policy, cache_slots=sched.cache_slots,
                   plan=sched.plan, hits=[sched.hits], misses=[sched.misses],
                   evictions=[sched.evictions], host_slots=sched.host_slots)

    def stream_nslots(self, dev: int) -> int:
        """Slot-buffer length device ``dev``'s stream requires (cache slots
        actually referenced plus its RECV panel region).  FETCH/SPILL ops
        address *host slabs* through ``slot_c``, not device slots, so they
        are excluded."""
        return max((max(o.slot_c, o.slot_a, o.slot_b)
                    for o in self.streams[dev] if o.kind not in HOST_IO),
                   default=-1) + 1

    def to_single(self) -> Schedule:
        """Flat single-device view; only valid for the ndev=1 degenerate."""
        if self.ndev != 1:
            raise ValueError(
                f"schedule has ndev={self.ndev}; only the ndev=1 degenerate "
                "form has a single-device view (use the per-device streams "
                "or simulate_multi/volume_report_multi)")
        return Schedule(list(self.streams[0]), self.nt, self.tb, self.policy,
                        self.cache_slots, self.plan,
                        hits=self.hits[0] if self.hits else 0,
                        misses=self.misses[0] if self.misses else 0,
                        evictions=self.evictions[0] if self.evictions else 0,
                        host_slots=self.host_slots)

    def _bytes(self, kind: OpKind, dev: Optional[int]) -> int:
        streams = self.streams if dev is None else [self.streams[dev]]
        return sum(o.bytes for s in streams for o in s if o.kind is kind)

    def loads_bytes(self, dev: Optional[int] = None) -> int:
        return self._bytes(OpKind.LOAD, dev)

    def stores_bytes(self, dev: Optional[int] = None) -> int:
        return self._bytes(OpKind.STORE, dev)

    def bcast_bytes(self) -> int:
        """Total interconnect volume = sum of per-receiver RECV bytes."""
        return self._bytes(OpKind.RECV, None)

    def fetch_bytes(self, dev: Optional[int] = None) -> int:
        return self._bytes(OpKind.FETCH, dev)

    def spill_bytes(self, dev: Optional[int] = None) -> int:
        return self._bytes(OpKind.SPILL, dev)

    def count(self, kind: OpKind, dev: Optional[int] = None) -> int:
        streams = self.streams if dev is None else [self.streams[dev]]
        return sum(1 for s in streams for o in s if o.kind is kind)

    def flops(self) -> float:
        n = self.nt * self.tb
        return n**3 / 3.0

    def digest(self) -> str:
        """Content hash over all device streams (golden-schedule tests).

        For ``ndev > 1`` the hash also pins the executor-facing metadata
        (``panel_base`` and each stream's slot-buffer length): the JAX
        executor sizes and addresses device buffers from these, so a
        change there is as execution-visible as a reordered op.  A
        genuinely 2D grid (``q > 1``) is folded in too — it changes the
        executor's host-slab layout; the 1D default ``(ndev, 1)`` is
        left out so pre-grid digests stay valid.  The ndev=1 degenerate
        hashes ops only, keeping ``from_single(s).digest()`` equal to
        the planner's digest.
        """
        import hashlib
        h = hashlib.sha256()
        if self.host_slots > 0:
            # the host-slab budget is executor-facing metadata for any
            # ndev (same prefix as Schedule.digest so the ndev=1
            # degenerate keeps matching the planner's digest)
            h.update(f"|hslots{self.host_slots}|".encode())
        if self.ndev > 1:
            h.update(f"|panel{self.panel_base}|".encode())
            if self.grid[1] > 1:
                h.update(f"grid{self.grid[0]}x{self.grid[1]}|".encode())
            if self.lookahead > 0:
                # a pipelined schedule's dispatch chunks are executor
                # metadata exactly like panel_base: the segment waves the
                # JAX executor jits follow them, so fold them in (the
                # lookahead=0 column-major order is derivable and stays
                # out, keeping historical digests valid)
                h.update(f"look{self.lookahead}|".encode())
                for c in self.dispatch or ():
                    h.update(f"{c[0]}:{c[1]}:{c[2]}:{c[3]}:{c[4]};".encode())
        for d, stream in enumerate(self.streams):
            h.update(f"|dev{d}|".encode())
            if self.ndev > 1:
                h.update(f"slots{self.stream_nslots(d)}|".encode())
            _ops_digest_update(h, stream)
        return h.hexdigest()[:16]

    def column_device_order(self, k: int) -> list[int]:
        """Device replay order for column step ``k``: the diagonal owner
        first, then the grid-column workers, then the row-scoped
        receivers.  This is exactly the partial order the BCAST->RECV
        edges impose — a panel RECV must observe the owner's finalized
        copy, and a row-scoped (host-landing) RECV must observe the
        worker's final STORE of that tile."""
        p, q = self.grid
        dv = grid_owner(k, k, p, q)
        workers = [grid_owner(r, k, p, q) for r in range(p)
                   if grid_owner(r, k, p, q) != dv]
        rest = [d for d in range(self.ndev)
                if d != dv and d % q != k % q]
        return [dv] + workers + rest

    def dispatch_chunks(self) -> list[tuple]:
        """The schedule's dispatch order as ``(dev, start, stop, k,
        phase)`` stream slices — the one order every op-stream consumer
        (NumPy replay, JAX executor segments, event simulator) shares
        with the builder.

        Pipelined schedules (``lookahead > 0``) carry the emitter's
        chunk list verbatim (final / advance / push waves interleave
        across columns); for ``lookahead = 0`` the historical
        column-major order is derived from :meth:`column_device_order`,
        splitting each diagonal owner's column ops at its last panel
        BCAST (the head every receiver's RECV depends on)."""
        if self.dispatch is not None:
            return self.dispatch
        chunks = []
        ptr = [0] * self.ndev
        q = self.grid[1]
        for k in range(self.nt):
            order = self.column_device_order(k)
            dv = order[0]
            for d in order:
                stream = self.streams[d]
                start = ptr[d]
                while ptr[d] < len(stream) and stream[ptr[d]].k == k:
                    ptr[d] += 1
                if ptr[d] == start:
                    continue
                if d == dv:
                    ops = stream[start:ptr[d]]
                    split = max((i + 1 for i, o in enumerate(ops)
                                 if o.kind is OpKind.BCAST and o.i == k),
                                default=len(ops))
                    chunks.append((d, start, start + split, k, "panel"))
                    if start + split < ptr[d]:
                        chunks.append((d, start + split, ptr[d], k, "update"))
                else:
                    phase = "update" if d % q == k % q else "recv"
                    chunks.append((d, start, ptr[d], k, phase))
        assert all(ptr[d] == len(self.streams[d]) for d in range(self.ndev))
        return chunks

    def iter_dispatch_order(self, with_phase: bool = False):
        """Yield ``(device, op)`` (or ``(device, op, phase)``) in
        dispatch-chunk order — see :meth:`dispatch_chunks`."""
        for d, start, stop, _k, phase in self.dispatch_chunks():
            stream = self.streams[d]
            for idx in range(start, stop):
                if with_phase:
                    yield d, stream[idx], phase
                else:
                    yield d, stream[idx]

    def iter_column_order(self):
        """Back-compat alias for :meth:`iter_dispatch_order` (the name
        predates lookahead pipelining, when the dispatch order was
        always column-major)."""
        return self.iter_dispatch_order()


def build_multidevice_schedule(
    nt: int,
    tb: int,
    ndev: int = 1,
    policy: str = "v3",
    cache_slots: int = 0,
    plan: PrecisionPlan | None = None,
    grid: tuple | None = None,
    lookahead: int = 0,
    host_slots: int = 0,
) -> MultiDeviceSchedule:
    """Emit per-device op streams for the block-cyclic tile Cholesky.

    ``grid=(p, q)`` (``p*q == ndev``; default ``(ndev, 1)``) arranges the
    devices as a 2D block-cyclic grid: tile ``(i, j)`` is owned by device
    ``TileLayout.owner_grid(i, j, grid)`` = ``(i % p) * q + (j % q)``.
    At column step ``k`` the diagonal owner updates and factors
    ``(k, k)``, ships the finalized panel row ``(k, 0..k)`` to the
    ``p - 1`` other devices of grid column ``k % q`` (BCAST on the owner
    stream, one RECV per receiver into its panel slot region), and each
    grid-column device then updates/factors its own rows of column ``k``
    locally under its own cache table.  For ``q > 1`` every finalized
    column tile ``(m, k)`` is additionally shipped to the ``q - 1``
    grid-row peers whose host slabs consume it in later steps (row-scoped
    BCAST; host-landing RECV with ``slot_c = -1``).

    With the default 1D grid this degenerates to the paper's tile-row
    ownership (every device computes at every step, one full-ndev panel
    broadcast per column); with ``ndev=1`` the single stream is
    op-for-op identical to :func:`build_schedule` for the same policy
    (no BCAST/RECV emitted).

    ``lookahead = L > 0`` pipelines up to ``L`` panels ahead of the
    trailing update (Donfack et al., arXiv:1110.2677): construction runs
    as an explicit task DAG plus a topological emitter
    (:mod:`repro.core.taskgraph`), finalized panel tiles are pushed
    eagerly to their grid-row peers, and the dispatch order becomes the
    emitter's chunk list (``dispatch``) instead of the column-major
    walk.  ``lookahead = 0`` reproduces the historical streams
    bit-identically.
    """
    policy = policy.lower()
    if policy not in ("sync", "v1", "v2", "v3"):
        raise ValueError(
            f"multi-device schedule supports sync/v1/v2/v3, got {policy!r}")
    if ndev < 1:
        raise ValueError(f"ndev must be >= 1, got {ndev}")
    if grid is None:
        grid = (ndev, 1)
    grid = tuple(grid)
    if (len(grid) != 2 or any(not isinstance(x, int) or x < 1 for x in grid)
            or grid[0] * grid[1] != ndev):
        raise ValueError(
            f"grid must be two positive ints with p*q == ndev={ndev}, "
            f"got {grid!r}")
    p, q = grid
    if plan is None:
        plan = uniform_plan(nt)
    if plan.classes.shape[0] != nt:
        raise ValueError("precision plan Nt mismatch")

    operand_cache = policy in ("v2", "v3")
    if lookahead < 0 or lookahead >= nt:
        raise ValueError(
            f"lookahead must be in [0, nt); got {lookahead} at nt={nt}")
    if lookahead > 0 and ndev < 2:
        raise ValueError("lookahead pipelines panels across devices; "
                         "it needs ndev > 1")
    if host_slots < 0:
        raise ValueError(f"host_slots must be >= 0, got {host_slots}")
    if host_slots > 0 and lookahead > 0:
        raise ValueError(
            "host_slots (the disk spill tier) is not supported with "
            "lookahead > 0: the spill post-pass inserts ops into each "
            "stream, which would invalidate the pipelined emitter's "
            "explicit dispatch-chunk indices")
    if cache_slots <= 0:
        cache_slots = default_cache_slots(policy, nt, multidevice=True,
                                          lookahead=lookahead)
    elif lookahead > 0 \
            and cache_slots < min_cache_slots(policy, lookahead=lookahead):
        raise ValueError(
            f"lookahead={lookahead} {policy} schedules need >= "
            f"{min_cache_slots(policy, lookahead=lookahead)} cache slots "
            f"(each in-flight panel pins one more), got {cache_slots}")

    # stage 1+2 (core/taskgraph.py): explicit task DAG -> topological
    # lookahead emitter; imported lazily to keep the module cycle one-way
    from .taskgraph import emit_pipelined_streams
    streams, dispatch, caches = emit_pipelined_streams(
        nt, tb, ndev, policy, cache_slots, plan, grid, lookahead)
    if host_slots > 0:
        # per-device host tier: each device bounds its own slab cache over
        # the shared disk store.  Host accesses are disjoint across
        # devices (a device LOADs/STOREs only owned rows; row-scoped
        # RECVs land in the receiver's own stream), so the per-stream
        # rewrite composes without cross-stream coordination.
        streams = [with_host_cache(s, tb, host_slots) for s in streams]

    msched = MultiDeviceSchedule(streams, nt, tb, ndev, policy, cache_slots,
                                 plan, panel_base=cache_slots if ndev > 1
                                 else -1, grid=grid, lookahead=lookahead,
                                 dispatch=dispatch, host_slots=host_slots)
    if operand_cache:
        msched.hits = [c.hits for c in caches]
        msched.misses = [c.misses for c in caches]
        msched.evictions = [c.evictions for c in caches]
    else:
        msched.misses = [msched.count(OpKind.LOAD, d) for d in range(ndev)]
        msched.hits = [0] * ndev
        msched.evictions = [0] * ndev
    return msched
