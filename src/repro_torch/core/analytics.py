# A copy of repro/core/analytics.py over the port's own schedule module, kept
# in the reference's arithmetic order so that every simulated time, byte
# count and trace is equal to the reference's on the same schedule.
"""Exact data-movement analytics and a deterministic performance model.

Because the schedule is static, the byte volume of every policy (Fig. 8,
Fig. 12) is an exact replay, not an estimate.  The performance model is a
three-engine event simulator (H2D copy engine, D2H copy engine, compute
engine) over the op stream, the structure of the paper's stream timeline
(Fig. 2/7): ``sync`` serializes everything on one engine, the
``async``/V* policies let the engines run concurrently subject to the data
dependencies encoded in the slot indices.

:func:`simulate_multi` extends the same model to the multi-device op
streams of :func:`~repro_torch.core.schedule.build_multidevice_schedule`:
every device gets its own H2D/D2H/compute engine triple, and the
broadcasts (the column-scoped panel BCAST/RECV pairs plus, for 2D device
grids, the row-scoped ownership broadcasts) ride one shared interconnect
engine.  Its bandwidth defaults to the model's ``link_bw`` when one is
recorded, else the preset's host-link speed.

The simulators' times are model readings of a :class:`HardwareModel`, not
measurements: the :data:`HW` presets carry datasheet peaks.
"""
from __future__ import annotations

import dataclasses

from .schedule import HOST_IO, MultiDeviceSchedule, OpKind, Schedule

GB = 1e9
TFLOP = 1e12

# disk bandwidth assumed when a model records none: a mid-range NVMe doing
# large sequential tile I/O.
_DISK_BW_FALLBACK = 2 * GB


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    name: str
    # peak GEMM-engine throughput per precision class name, FLOP/s
    flops: dict
    h2d_bw: float          # host->device bytes/s (per direction)
    d2h_bw: float
    alloc_overhead: float  # seconds per malloc/free pair (async policy)
    launch_overhead: float = 3e-6
    mem_bytes: float = 0.0   # device memory capacity (0 = unknown/unbounded)
    # device-to-device interconnect bytes/s for the multi-device broadcast
    # (0 = unknown: simulate_multi falls back to h2d_bw)
    link_bw: float = 0.0
    source: str = "datasheet"            # "datasheet" | "measured"
    fingerprint: str = ""    # hardware identity hash (tuning-db cache key)
    # optional per-kernel rates, FLOP/s: {"gemm": {"f64": r, ...}, ...};
    # None runs every task at the class peak
    kernel_flops: dict | None = None
    # disk tier (spill schedules, host_slots > 0): sequential read/write
    # bytes/s of the tile-store device and host RAM capacity.  0 = unknown:
    # the simulators fall back to _DISK_BW_FALLBACK and treat host memory
    # as unbounded.
    disk_read_bw: float = 0.0
    disk_write_bw: float = 0.0
    host_mem_bytes: float = 0.0

    def task_rate(self, task: str, cls_name: str) -> float:
        """FLOP/s for one task kind (``"gemm"``/``"syrk"``/...) at one
        precision class; falls back to the per-class peak when no
        per-kernel rate is recorded.  The scaled-FP8 class ``"f8e4m3s"``
        runs on the same e4m3 GEMM engine as the unscaled class, so
        models without it alias its rate to ``"f8e4m3"``."""
        if self.kernel_flops:
            per_cls = self.kernel_flops.get(task)
            if per_cls:
                if cls_name in per_cls:
                    return per_cls[cls_name]
                if cls_name == "f8e4m3s" and "f8e4m3" in per_cls:
                    return per_cls["f8e4m3"]
        if cls_name not in self.flops and cls_name == "f8e4m3s":
            return self.flops["f8e4m3"]
        return self.flops[cls_name]

    def max_cache_slots(self, tb: int, reserve_slots: int = 0) -> int:
        """Largest cache-slot budget that fits ``mem_bytes`` for tb x tb
        f64 device tiles, after reserving ``reserve_slots`` (panel region,
        ndev > 1).  Unbounded when ``mem_bytes`` is unknown (0)."""
        if self.mem_bytes <= 0:
            return 2**31 - 1
        return int(self.mem_bytes // (8 * tb * tb)) - reserve_slots

    def max_host_slots(self, tb: int) -> int:
        """Largest host-slab budget that fits ``host_mem_bytes`` for
        tb x tb f64 slabs; unbounded when the capacity is unknown (0)."""
        if self.host_mem_bytes <= 0:
            return 2**31 - 1
        return int(self.host_mem_bytes // (8 * tb * tb))


# The reference's datasheet presets, value for value (the simulators are
# held equal to the reference's on every one of them).  None was measured
# on the card this port runs on: a time simulated from them is a model
# reading, never the card's.
HW = {
    "a100-pcie": HardwareModel(
        "a100-pcie",
        {"f64": 19.5 * TFLOP, "f32": 19.5 * TFLOP, "f16": 312 * TFLOP,
         "bf16": 312 * TFLOP, "f8e4m3": 312 * TFLOP},
        25 * GB, 25 * GB, 12e-6, mem_bytes=80 * GB,
        disk_read_bw=3.2 * GB, disk_write_bw=2.8 * GB),
    "h100-pcie": HardwareModel(
        "h100-pcie",
        {"f64": 60 * TFLOP, "f32": 60 * TFLOP, "f16": 750 * TFLOP,
         "bf16": 750 * TFLOP, "f8e4m3": 1500 * TFLOP},
        50 * GB, 50 * GB, 12e-6, mem_bytes=80 * GB,
        disk_read_bw=6.5 * GB, disk_write_bw=5.0 * GB),
    "gh200": HardwareModel(
        "gh200",
        {"f64": 62 * TFLOP, "f32": 62 * TFLOP, "f16": 990 * TFLOP,
         "bf16": 990 * TFLOP, "f8e4m3": 1980 * TFLOP},
        450 * GB, 450 * GB, 12e-6, mem_bytes=96 * GB,
        disk_read_bw=6.5 * GB, disk_write_bw=5.0 * GB),
    "tpu-v5e": HardwareModel(
        "tpu-v5e",
        {"f64": 6.2 * TFLOP, "f32": 49 * TFLOP, "f16": 197 * TFLOP,
         "bf16": 197 * TFLOP, "f8e4m3": 394 * TFLOP},
        32 * GB, 32 * GB, 0.0, mem_bytes=16 * GB,
        disk_read_bw=2.0 * GB, disk_write_bw=1.2 * GB),
}

_TASK_FLOPS = {
    OpKind.SYRK: lambda tb: tb**3,          # C -= A A^T (symmetric half)
    OpKind.GEMM: lambda tb: 2 * tb**3,
    OpKind.POTRF: lambda tb: tb**3 / 3.0,
    OpKind.TRSM: lambda tb: tb**3,
}


@dataclasses.dataclass
class SimResult:
    makespan: float
    compute_busy: float
    h2d_busy: float
    d2h_busy: float
    h2d_bytes: int
    d2h_bytes: int
    alloc_events: int
    timeline: list           # (engine, start, end, label)
    flops_useful: float      # n^3/3
    # disk lane (spill schedules only; zero for host_slots == 0)
    disk_busy: float = 0.0
    fetch_bytes: int = 0
    spill_bytes: int = 0

    @property
    def tflops(self) -> float:
        return self.flops_useful / self.makespan / TFLOP

    @property
    def total_bytes(self) -> int:
        return self.h2d_bytes + self.d2h_bytes


def _as_single(sched) -> Schedule:
    """Accept the unified MultiDeviceSchedule in its ndev=1 degenerate form
    (the type the planner API returns) wherever a flat Schedule is wanted;
    ndev>1 raises, pointing at simulate_multi/volume_report_multi."""
    if isinstance(sched, MultiDeviceSchedule):
        return sched.to_single()
    return sched


def simulate(sched: Schedule, hw: HardwareModel, record_timeline: bool = False) -> SimResult:
    """Event-driven simulation of the op stream on a three-engine machine.

    Spill schedules (``host_slots > 0``) add a fourth engine: the disk
    lane.  FETCH occupies it for ``bytes / disk_read_bw`` (a binding
    fetch, ``bytes == 0``, only rebinds the slab), SPILL for
    ``bytes / disk_write_bw``; LOAD/STORE pick up RAW/WAR hazards on the
    host slab the schedule bound their tile to, so host-tier contention
    shows up in the makespan exactly like device-tier contention does.
    """
    sched = _as_single(sched)
    tb = sched.tb
    lad = sched.plan.ladder
    overlap = sched.policy != "sync"
    spill = sched.host_slots > 0
    read_bw = hw.disk_read_bw or _DISK_BW_FALLBACK
    write_bw = hw.disk_write_bw or _DISK_BW_FALLBACK

    nslots = max(max(o.slot_c, o.slot_a, o.slot_b)
                 for o in sched.ops if o.kind not in HOST_IO) + 1
    ready = [0.0] * nslots        # time the slot's contents become valid
    reads = [0.0] * nslots        # time the slot's pending reads complete
    t_h2d = t_d2h = t_cmp = 0.0   # engine-free times
    t_dsk = 0.0
    busy = {"h2d": 0.0, "d2h": 0.0, "cmp": 0.0, "dsk": 0.0}
    nbytes = {"h2d": 0, "d2h": 0, "fetch": 0, "spill": 0}
    allocs = 0
    timeline = []
    # host tier: slab validity/read hazards + the static tile->slab map,
    # replayed from the FETCH records exactly as the executors replay it
    hready = [0.0] * sched.host_slots
    hreads = [0.0] * sched.host_slots
    tile_at = [None] * sched.host_slots
    hslot_of = {}                 # (i, j) -> slab
    disk_ready = {}               # (i, j) -> time the disk copy is valid

    def run_on(engine_free, dep, dur, engine, label):
        start = max(engine_free, dep)
        end = start + dur
        busy[engine] += dur
        if record_timeline:
            timeline.append((engine, start, end, label))
        return end

    for op in sched.ops:
        if op.kind is OpKind.FETCH:
            s = op.slot_c
            if tile_at[s] is not None:
                del hslot_of[tile_at[s]]
            dur = op.bytes / read_bw
            nbytes["fetch"] += op.bytes
            dep = max(hreads[s], hready[s],
                      disk_ready.get((op.i, op.j), 0.0))
            if overlap:
                t_dsk = run_on(t_dsk, dep, dur, "dsk", f"F{op.i},{op.j}")
                end = t_dsk
            else:
                t_cmp = run_on(t_cmp, dep, dur, "dsk", f"F{op.i},{op.j}")
                t_dsk = end = t_cmp
            hready[s] = end
            tile_at[s] = (op.i, op.j)
            hslot_of[(op.i, op.j)] = s
        elif op.kind is OpKind.SPILL:
            s = op.slot_c
            dur = op.bytes / write_bw
            nbytes["spill"] += op.bytes
            if overlap:
                t_dsk = run_on(t_dsk, hready[s], dur, "dsk",
                               f"W{op.i},{op.j}")
                end = t_dsk
            else:
                t_cmp = run_on(t_cmp, hready[s], dur, "dsk",
                               f"W{op.i},{op.j}")
                t_dsk = end = t_cmp
            disk_ready[(op.i, op.j)] = end
            hreads[s] = max(hreads[s], end)
        elif op.kind is OpKind.ALLOC:
            allocs += 1
            t_cmp += hw.alloc_overhead  # cudaMalloc stalls the stream
            # a fresh buffer: the recycled slot id carries no hazards
            reads[op.slot_c] = ready[op.slot_c] = 0.0
        elif op.kind is OpKind.FREE:
            t_cmp += hw.alloc_overhead * 0.3
        elif op.kind is OpKind.LOAD:
            dur = op.bytes / hw.h2d_bw
            nbytes["h2d"] += op.bytes
            # a LOAD overwrites the slot: it must wait for pending reads
            # (WAR — e.g. a STORE still draining the slot) and for any
            # in-flight write of the previous contents (WAW)
            dep = max(reads[op.slot_c], ready[op.slot_c])
            hs = hslot_of.get((op.i, op.j)) if spill else None
            if hs is not None:      # RAW on the host slab's FETCH
                dep = max(dep, hready[hs])
            if overlap:
                t_h2d = run_on(t_h2d, dep, dur, "h2d", f"L{op.i},{op.j}")
                ready[op.slot_c] = t_h2d
            else:
                t_cmp = run_on(t_cmp, dep, dur, "h2d", f"L{op.i},{op.j}")
                t_h2d = t_cmp
                ready[op.slot_c] = t_cmp
            if hs is not None:
                hreads[hs] = max(hreads[hs], ready[op.slot_c])
        elif op.kind is OpKind.STORE:
            dur = op.bytes / hw.d2h_bw
            nbytes["d2h"] += op.bytes
            dep = ready[op.slot_c]
            hs = hslot_of.get((op.i, op.j)) if spill else None
            if hs is not None:      # WAR on the target host slab
                dep = max(dep, hreads[hs])
            if overlap:
                t_d2h = run_on(t_d2h, dep, dur, "d2h", f"S{op.i},{op.j}")
                end = t_d2h
            else:
                t_cmp = run_on(t_cmp, dep, dur, "d2h", f"S{op.i},{op.j}")
                t_d2h = t_cmp
                end = t_cmp
            reads[op.slot_c] = max(reads[op.slot_c], end)
            if hs is not None:
                hready[hs] = end
        else:  # compute
            flops = _TASK_FLOPS[op.kind](tb)
            rate = hw.task_rate(op.kind.value, lad[op.cls])
            dur = flops / rate + hw.launch_overhead
            deps = [ready[s] for s in (op.slot_c, op.slot_a, op.slot_b) if s >= 0]
            deps.append(reads[op.slot_c])   # WAR: output slot still being read
            t_cmp = run_on(t_cmp, max(deps), dur, "cmp", op.kind.value)
            ready[op.slot_c] = t_cmp
            for s in (op.slot_a, op.slot_b):
                if s >= 0 and s != op.slot_c:
                    reads[s] = max(reads[s], t_cmp)

    makespan = max(t_h2d, t_d2h, t_cmp, t_dsk)
    return SimResult(
        makespan=makespan,
        compute_busy=busy["cmp"], h2d_busy=busy["h2d"], d2h_busy=busy["d2h"],
        h2d_bytes=nbytes["h2d"], d2h_bytes=nbytes["d2h"],
        alloc_events=allocs, timeline=timeline,
        flops_useful=sched.flops(),
        disk_busy=busy["dsk"],
        fetch_bytes=nbytes["fetch"], spill_bytes=nbytes["spill"],
    )


def volume_report(sched: Schedule) -> dict:
    """Exact C2G/G2C byte volumes (paper Fig. 8 / Fig. 12)."""
    sched = _as_single(sched)
    rep = {
        "policy": sched.policy,
        "nt": sched.nt,
        "tb": sched.tb,
        "c2g_bytes": sched.loads_bytes(),
        "g2c_bytes": sched.stores_bytes(),
        "total_bytes": sched.loads_bytes() + sched.stores_bytes(),
        "loads": sched.count(OpKind.LOAD),
        "stores": sched.count(OpKind.STORE),
        "cache_hits": sched.hits,
        "evictions": sched.evictions,
        "allocs": sched.count(OpKind.ALLOC),
        "matrix_bytes": 8 * (sched.nt * sched.tb) ** 2,
    }
    if sched.host_slots:
        rep.update({
            "host_slots": sched.host_slots,
            "host_bytes": 8 * sched.host_slots * sched.tb ** 2,
            "fetch_bytes": sched.fetch_bytes(),
            "spill_bytes": sched.spill_bytes(),
            "fetches": sched.count(OpKind.FETCH),
            "spills": sched.count(OpKind.SPILL),
        })
    return rep


# ---------------------------------------------------------------------------
# Multi-device event simulation (paper Fig. 9)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceSimStats:
    compute_busy: float
    h2d_busy: float
    d2h_busy: float
    h2d_bytes: int
    d2h_bytes: int
    recv_bytes: int
    finish: float          # when this device's last engine goes idle
    fetch_bytes: int = 0   # disk lane (spill schedules only)
    spill_bytes: int = 0


@dataclasses.dataclass
class MultiSimResult:
    makespan: float
    devices: list          # DeviceSimStats per device
    link_busy: float
    link_bytes: int
    flops_useful: float
    timeline: list         # (engine, start, end, label); engine "d<k>:h2d" etc.
    # shared disk lane (spill schedules only; zero for host_slots == 0)
    disk_busy: float = 0.0
    fetch_bytes: int = 0
    spill_bytes: int = 0

    @property
    def tflops(self) -> float:
        return self.flops_useful / self.makespan / TFLOP

    @property
    def compute_efficiency(self) -> float:
        """Fraction of the run the compute engines are busy, averaged over
        devices — the Fig. 9 scaling metric (1.0 = perfect overlap of the
        broadcast and OOC traffic behind compute)."""
        busy = sum(d.compute_busy for d in self.devices)
        return busy / (len(self.devices) * self.makespan)


def simulate_multi(msched: MultiDeviceSchedule, hw: HardwareModel,
                   link_bw: float | None = None,
                   record_timeline: bool = False) -> MultiSimResult:
    """Event simulation of the per-device op streams + shared interconnect.

    Every device runs the same three-engine model as :func:`simulate`
    (its own H2D/D2H/compute engines, slot RAW/WAR tracking); both
    broadcast kinds — the column-scoped panel broadcast and, for 2D
    grids, the row-scoped ownership broadcast — ride one *shared* link
    engine of bandwidth ``link_bw``.  The default is the hardware
    model's ``hw.link_bw`` when it has one, else ``hw.h2d_bw`` (PCIe-switch
    platforms share a slow link, NVLink-C2C a fast one).  Broadcasts are
    staged through the sender's host-coherent copy, so each RECV waits
    until that copy exists (the sender's STORE, or the host-landing RECV
    that delivered it to the sender), then occupies the link for its own
    ingress bytes — a per-receiver-copy collective on a shared medium.
    A host-landing RECV (``slot_c < 0``) updates the receiver's host-slab
    coherence instead of a device slot: later LOADs of that tile on the
    receiver wait for it.

    Streams are replayed in :meth:`MultiDeviceSchedule.dispatch_chunks`
    order — column-by-column owner-first for ``lookahead=0`` (exactly
    the partial order the BCAST/RECV edges impose), and the emitter's
    interleaved final/advance waves for pipelined schedules, where the
    advance chunk of column ``k+lookahead`` overlaps the other grid
    columns' trailing updates.  With ``record_timeline`` and
    ``lookahead > 0`` an extra ``d{d}:pipe`` lane per device tags every
    compute span ``ahead:`` (lookahead-panel work: push/advance phases)
    or ``trail:`` (trailing-update work) so the overlap is visible in
    :func:`chrome_trace`.
    """
    if link_bw is None:
        link_bw = hw.link_bw or hw.h2d_bw
    tb, lad, ndev = msched.tb, msched.plan.ladder, msched.ndev
    overlap = msched.policy != "sync"
    spill = msched.host_slots > 0
    read_bw = hw.disk_read_bw or _DISK_BW_FALLBACK
    write_bw = hw.disk_write_bw or _DISK_BW_FALLBACK

    ready = [[0.0] * msched.stream_nslots(d) for d in range(ndev)]
    reads = [[0.0] * msched.stream_nslots(d) for d in range(ndev)]
    # host tier (spill schedules): per-device slab hazards + tile->slab
    # maps, one *shared* disk engine (the stores all target one device)
    hready = [[0.0] * msched.host_slots for _ in range(ndev)]
    hreads = [[0.0] * msched.host_slots for _ in range(ndev)]
    tile_at = [[None] * msched.host_slots for _ in range(ndev)]
    hslot_of = [{} for _ in range(ndev)]
    disk_ready = {}
    t_dsk = 0.0
    disk_busy = 0.0
    # (i, j) -> time the tile's final value is available in device d's
    # host slab (its own STOREs + host-landing RECVs); recv_host is the
    # RECV-delivered subset, the only tiles whose LOAD must wait (a
    # device's own STOREs keep the 1D model's engine-FIFO approximation)
    host_avail = [{} for _ in range(ndev)]
    recv_host = [{} for _ in range(ndev)]
    t_h2d = [0.0] * ndev
    t_d2h = [0.0] * ndev
    t_cmp = [0.0] * ndev
    t_link = 0.0
    busy = [{"h2d": 0.0, "d2h": 0.0, "cmp": 0.0} for _ in range(ndev)]
    nbytes = [{"h2d": 0, "d2h": 0, "recv": 0, "fetch": 0, "spill": 0}
              for _ in range(ndev)]
    link_busy = 0.0
    link_bytes = 0
    timeline = []

    def span(engine, start, end, label):
        if record_timeline:
            timeline.append((engine, start, end, label))

    # phases emitted ahead of the trailing update (lookahead pipeline)
    _AHEAD_PHASES = {"push", "recv-ahead", "advance"}
    pipe_lane = record_timeline and msched.lookahead > 0

    def run_op(d, op, phase="update"):
        nonlocal t_link, link_busy, link_bytes, t_dsk, disk_busy
        if op.kind is OpKind.FETCH:
            s = op.slot_c
            if tile_at[d][s] is not None:
                del hslot_of[d][tile_at[d][s]]
            dur = op.bytes / read_bw
            nbytes[d]["fetch"] += op.bytes
            dep = max(hreads[d][s], hready[d][s],
                      disk_ready.get((op.i, op.j), 0.0))
            if not overlap:
                dep = max(dep, t_cmp[d])
            start = max(t_dsk, dep)
            t_dsk = start + dur
            disk_busy += dur
            if not overlap:
                t_cmp[d] = t_dsk
            hready[d][s] = t_dsk
            tile_at[d][s] = (op.i, op.j)
            hslot_of[d][(op.i, op.j)] = s
            # the fetched slab is this device's host copy of the tile
            host_avail[d][(op.i, op.j)] = max(
                host_avail[d].get((op.i, op.j), 0.0), t_dsk)
            span("dsk", start, t_dsk, f"F{op.i},{op.j}@d{d}")
        elif op.kind is OpKind.SPILL:
            s = op.slot_c
            dur = op.bytes / write_bw
            nbytes[d]["spill"] += op.bytes
            dep = hready[d][s]
            if not overlap:
                dep = max(dep, t_cmp[d])
            start = max(t_dsk, dep)
            t_dsk = start + dur
            disk_busy += dur
            if not overlap:
                t_cmp[d] = t_dsk
            disk_ready[(op.i, op.j)] = t_dsk
            hreads[d][s] = max(hreads[d][s], t_dsk)
            span("dsk", start, t_dsk, f"W{op.i},{op.j}@d{d}")
        elif op.kind is OpKind.LOAD:
            dur = op.bytes / hw.h2d_bw
            nbytes[d]["h2d"] += op.bytes
            dep = max(reads[d][op.slot_c], ready[d][op.slot_c],
                      recv_host[d].get((op.i, op.j), 0.0))
            hs = hslot_of[d].get((op.i, op.j)) if spill else None
            if hs is not None:      # RAW on the host slab's FETCH
                dep = max(dep, hready[d][hs])
            if overlap:
                start = max(t_h2d[d], dep)
                t_h2d[d] = start + dur
                end = t_h2d[d]
            else:
                start = max(t_cmp[d], dep)
                t_cmp[d] = start + dur
                t_h2d[d] = end = t_cmp[d]
            busy[d]["h2d"] += dur
            ready[d][op.slot_c] = end
            if hs is not None:
                hreads[d][hs] = max(hreads[d][hs], end)
            span(f"d{d}:h2d", start, end, f"L{op.i},{op.j}")
        elif op.kind is OpKind.STORE:
            dur = op.bytes / hw.d2h_bw
            nbytes[d]["d2h"] += op.bytes
            dep = ready[d][op.slot_c]
            hs = hslot_of[d].get((op.i, op.j)) if spill else None
            if hs is not None:      # WAR on the target host slab
                dep = max(dep, hreads[d][hs])
            if overlap:
                start = max(t_d2h[d], dep)
                t_d2h[d] = start + dur
                end = t_d2h[d]
            else:
                start = max(t_cmp[d], dep)
                t_cmp[d] = start + dur
                t_d2h[d] = end = t_cmp[d]
            busy[d]["d2h"] += dur
            reads[d][op.slot_c] = max(reads[d][op.slot_c], end)
            host_avail[d][(op.i, op.j)] = end
            if hs is not None:
                hready[d][hs] = end
            span(f"d{d}:d2h", start, end, f"S{op.i},{op.j}")
        elif op.kind is OpKind.BCAST:
            pass    # availability tracked via host_avail; RECVs carry cost
        elif op.kind is OpKind.RECV:
            dur = op.bytes / link_bw
            nbytes[d]["recv"] += op.bytes
            link_bytes += op.bytes
            # the sender's host-coherent copy must exist before the wire
            dep = (host_avail[op.src].get((op.i, op.j), 0.0)
                   if op.src >= 0 else 0.0)
            if op.slot_c >= 0:      # panel-slot landing (WAR/WAW on slot)
                dep = max(dep, reads[d][op.slot_c], ready[d][op.slot_c])
            if not overlap:
                dep = max(dep, t_cmp[d])   # sync: one engine per device
            start = max(t_link, dep)
            t_link = start + dur
            link_busy += dur
            if not overlap:
                t_cmp[d] = t_link
            if op.slot_c >= 0:
                ready[d][op.slot_c] = t_link
            else:                   # host-landing: receiver slab coherence
                host_avail[d][(op.i, op.j)] = t_link
                recv_host[d][(op.i, op.j)] = t_link
                if spill:           # the landing writes a bound host slab
                    hs = hslot_of[d].get((op.i, op.j))
                    if hs is not None:
                        hready[d][hs] = t_link
            span("link", start, t_link, f"B{op.i},{op.j}->d{d}")
        else:  # compute
            flops = _TASK_FLOPS[op.kind](tb)
            dur = (flops / hw.task_rate(op.kind.value, lad[op.cls])
                   + hw.launch_overhead)
            deps = [ready[d][s]
                    for s in (op.slot_c, op.slot_a, op.slot_b) if s >= 0]
            deps.append(reads[d][op.slot_c])
            start = max(t_cmp[d], max(deps))
            t_cmp[d] = start + dur
            busy[d]["cmp"] += dur
            ready[d][op.slot_c] = t_cmp[d]
            for s in (op.slot_a, op.slot_b):
                if s >= 0 and s != op.slot_c:
                    reads[d][s] = max(reads[d][s], t_cmp[d])
            span(f"d{d}:cmp", start, t_cmp[d], op.kind.value)
            if pipe_lane:
                tag = "ahead" if phase in _AHEAD_PHASES else "trail"
                span(f"d{d}:pipe", start, t_cmp[d],
                     f"{tag}:{op.kind.value}")

    # replay in dispatch-chunk order (owner-first per column at
    # lookahead=0; the emitter's interleaved waves for lookahead>0)
    for d, op, phase in msched.iter_dispatch_order(with_phase=True):
        run_op(d, op, phase)

    devices = [
        DeviceSimStats(
            compute_busy=busy[d]["cmp"], h2d_busy=busy[d]["h2d"],
            d2h_busy=busy[d]["d2h"], h2d_bytes=nbytes[d]["h2d"],
            d2h_bytes=nbytes[d]["d2h"], recv_bytes=nbytes[d]["recv"],
            finish=max(t_h2d[d], t_d2h[d], t_cmp[d]),
            fetch_bytes=nbytes[d]["fetch"], spill_bytes=nbytes[d]["spill"])
        for d in range(ndev)
    ]
    makespan = max([t_link, t_dsk] + [dv.finish for dv in devices])
    return MultiSimResult(
        makespan=makespan, devices=devices,
        link_busy=link_busy, link_bytes=link_bytes,
        flops_useful=msched.flops(), timeline=timeline,
        disk_busy=disk_busy,
        fetch_bytes=sum(n["fetch"] for n in nbytes),
        spill_bytes=sum(n["spill"] for n in nbytes),
    )


def volume_report_multi(msched: MultiDeviceSchedule) -> dict:
    """Per-device + aggregate byte volumes of a multi-device schedule."""
    per_device = []
    for d in range(msched.ndev):
        per_device.append({
            "device": d,
            "c2g_bytes": msched.loads_bytes(d),
            "g2c_bytes": msched.stores_bytes(d),
            "recv_bytes": sum(o.bytes for o in msched.streams[d]
                              if o.kind is OpKind.RECV),
            "loads": msched.count(OpKind.LOAD, d),
            "stores": msched.count(OpKind.STORE, d),
            "cache_hits": msched.hits[d] if msched.hits else 0,
            "evictions": msched.evictions[d] if msched.evictions else 0,
        })
    rep = {
        "policy": msched.policy,
        "nt": msched.nt,
        "tb": msched.tb,
        "ndev": msched.ndev,
        "grid": list(msched.grid),
        "c2g_bytes": msched.loads_bytes(),
        "g2c_bytes": msched.stores_bytes(),
        "bcast_bytes": msched.bcast_bytes(),
        "matrix_bytes": 8 * (msched.nt * msched.tb) ** 2,
        "per_device": per_device,
    }
    if msched.host_slots:
        rep.update({
            "host_slots": msched.host_slots,
            "fetch_bytes": msched.fetch_bytes(),
            "spill_bytes": msched.spill_bytes(),
        })
        for dev in per_device:
            d = dev["device"]
            dev["fetch_bytes"] = msched.fetch_bytes(d)
            dev["spill_bytes"] = msched.spill_bytes(d)
    return rep


def crosscheck_executed_volume(msched: MultiDeviceSchedule, executed: dict,
                               hw: HardwareModel | None = None) -> dict:
    """Check an executor's *executed* transfer counters against the model.

    ``executed`` is the counter dict a multi-device executor reports after
    a run: BCAST/RECV op counts and the bytes that actually crossed the
    interconnect.  The static-schedule claim is
    that these are knowable ahead of time — so they must equal, exactly,
    the op stream's own accounting and (when ``hw`` is given) the bytes
    :func:`simulate_multi` pushes through its shared link engine.

    Returns ``{"match": bool, "expected": ..., "executed": ...,
    "mismatches": {field: (expected, executed)}}``.  The byte-level
    check assumes the executor's wire format is the tile class.
    """
    if executed is None:
        raise ValueError(
            "no executed transfer counters: the last factor() did not run "
            "a multi-device executor (the numpy replay and the "
            "single-device backends count no broadcasts)")
    expected = {
        "bcast_ops": msched.count(OpKind.BCAST),
        "recv_ops": msched.count(OpKind.RECV),
        "bcast_bytes": sum(o.bytes for s in msched.streams for o in s
                           if o.kind is OpKind.BCAST),
        "recv_bytes": msched.bcast_bytes(),
    }
    if hw is not None:
        expected["simulated_link_bytes"] = simulate_multi(msched, hw).link_bytes
        executed = dict(executed,
                        simulated_link_bytes=executed.get("recv_bytes"))
    mismatches = {k: (v, executed.get(k)) for k, v in expected.items()
                  if executed.get(k) != v}
    return {"match": not mismatches, "expected": expected,
            "executed": executed, "mismatches": mismatches}


def chrome_trace(result, path=None) -> dict:
    """Export a recorded timeline as chrome://tracing ("Trace Event") JSON.

    Works for both :class:`SimResult` and :class:`MultiSimResult` (any
    object with a ``timeline`` of ``(engine, start, end, label)`` spans
    and a ``makespan``); each engine becomes one named track ("thread"),
    every span a complete ``"X"`` event with microsecond timestamps.
    Load the file at chrome://tracing or https://ui.perfetto.dev.

    Multi-device timelines recorded from a ``lookahead > 0`` schedule
    carry per-device ``d{d}:pipe`` "panel pipeline" lanes whose spans
    are prefixed ``ahead:`` / ``trail:``; those get distinct chrome
    colors (``cname``) so lookahead-panel work is visually separable
    from the trailing update it overlaps.

    Returns the trace dict; with ``path`` given it is also written there
    as JSON.  Simulations must be run with ``record_timeline=True``.
    """
    if not result.timeline:
        raise ValueError("timeline not recorded: simulate with "
                         "record_timeline=True before exporting a trace")
    engines = []
    for engine, _, _, _ in result.timeline:
        if engine not in engines:
            engines.append(engine)
    events = [
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": t,
         "args": {"name": engine}}
        for t, engine in enumerate(engines)
    ]
    tids = {engine: t for t, engine in enumerate(engines)}
    for engine, start, end, label in result.timeline:
        ev = {
            "name": label, "cat": engine, "ph": "X",
            "ts": start * 1e6, "dur": (end - start) * 1e6,
            "pid": 0, "tid": tids[engine],
        }
        if engine.endswith(":pipe"):
            ev["cname"] = ("thread_state_running"
                           if label.startswith("ahead:")
                           else "grey")
        events.append(ev)
    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"makespan_s": result.makespan,
                     "tflops": result.tflops},
    }
    if path is not None:
        import json
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def ascii_trace(result: SimResult, width: int = 100) -> str:
    """Fig. 7-style trace: one row per engine."""
    if not result.timeline:
        return "(timeline not recorded)"
    span = result.makespan
    rows = {"h2d": [" "] * width, "cmp": [" "] * width,
            "d2h": [" "] * width, "dsk": [" "] * width}
    glyph = {"h2d": "o", "cmp": "#", "d2h": "g", "dsk": "d"}
    seen_dsk = False
    for engine, s, e, _ in result.timeline:
        seen_dsk = seen_dsk or engine == "dsk"
        a = int(s / span * (width - 1))
        b = max(a + 1, int(e / span * (width - 1)))
        for x in range(a, min(b, width)):
            rows[engine][x] = glyph[engine]
    lanes = [("G2C", rows["h2d"]), ("Work", rows["cmp"]),
             ("C2G", rows["d2h"])]
    if seen_dsk:
        lanes.append(("Disk", rows["dsk"]))
    return "\n".join(f"{name:>4s} |{''.join(row)}|"
                     for name, row in lanes)
