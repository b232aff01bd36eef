"""Single-device executor of the static op stream, in PyTorch.

Port of the reference's ``make_jax_executor`` (``repro/core/cholesky.py``)
with its class round (``_jx_round``/``_jx_fp8_scale``), kernel table
(``_make_kernel_fns``) and op interpreter (``_jx_interpret_op``).  Where the
reference unrolls the op stream into one jit, PyTorch runs it eagerly, op
by op, on one stream:

* the host tile store is a ``[nt, nt, tb, tb]`` CPU tensor in the compute
  dtype, pinned when the slots live on a CUDA device;
* the slot buffer ``[nslots, tb, tb]`` lives on the device;
* LOAD is a non-blocking host-to-device copy into the slot followed by the
  class round on the device; STORE rounds on the device, writes the rounded
  tile back into the slot and copies it to the host, non-blocking.  One
  stream orders a later LOAD of a tile after its earlier STORE.

Transfers carry compute-dtype bytes, as the reference's do.

``MultiDeviceTorchExecutor`` runs a multi-device schedule the same way on
one stream per logical device, each over the host slab of its grid row,
with the BCAST/RECV edges as class-precision wires ordered by CUDA events
(port of the reference's ``MultiDeviceJaxExecutor``).

``SpillTorchExecutor`` runs a single-device spill schedule (``host_slots >
0``) over a bounded host tier of pinned slabs in front of a disk tile store
(port of the reference's ``SpillJaxExecutor``).

Every executor has a measured path, taken only for an active ``trace=``
recorder: the op stream op by op, each op's CUDA stream synchronized after
it, one span per op (``run_traced_torch``; ``MultiDeviceTorchExecutor`` and
``SpillTorchExecutor`` with ``trace=``).  It runs the unfused interpreter,
so a traced factor is bitwise the untraced unfused one.

It also holds the reference's NumPy replays, ``run_schedule_numpy`` and
``run_multidevice_numpy`` (``backend="numpy"``), with their spill forms
``run_schedule_spill`` and ``run_multidevice_spill``: host oracles that need
no card, bitwise the reference's on the same schedule.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.ref import _CLASS_DTYPES, _fp8_scale, _round
from .precision import (PrecisionPlan, assign_precision, tile_amax,
                        tile_norms, uniform_plan)
from .schedule import HOST_IO, MultiDeviceSchedule, Op, OpKind, Schedule
from .tiling import grid_owner


def _make_kernel_fns(use_pallas: bool) -> dict:
    """Stock PyTorch ops in the compute dtype, or (``use_pallas``, the
    reference's name for it) the hand-written tile kernels via ops."""
    if not use_pallas:
        return kops.STOCK
    return {"potrf": kops.potrf, "trsm": kops.trsm,
            "syrk": kops.syrk_update, "gemm": kops.gemm_update}


def _device_nslots(ops) -> int:
    return max((max(o.slot_c, o.slot_a, o.slot_b)
                for o in ops if o.kind not in HOST_IO), default=-1) + 1


# --------------------------------------------------------------------------
# NumPy replays (the reference's oracles)
# --------------------------------------------------------------------------

def _np_round(x: np.ndarray, cls_name: str) -> np.ndarray:
    """Round an f64 tile through its class, in NumPy: the port's class
    round on a zero-copy CPU view, which is bitwise the reference's
    ``_np_round`` (held by ``tests/test_torch_rounding.py``)."""
    return _round(torch.from_numpy(x), cls_name).numpy()


def _np_interpret_op(host: np.ndarray, slots: np.ndarray, op: Op,
                     lad: tuple) -> None:
    """Execute one op against the shared host store and a slot buffer.

    The numerical semantics of both replays, op for op the reference's: a
    RECV is a LOAD whose bytes crossed the interconnect, a host-landing
    RECV (``slot_c < 0``) is coherence bookkeeping against the shared
    store, BCAST/ALLOC/FREE are bookkeeping only, and FETCH/SPILL delegate
    to a host store object that has ``fetch``/``spill``."""
    if op.kind is OpKind.FETCH:
        host.fetch(op)
    elif op.kind is OpKind.SPILL:
        host.spill(op)
    elif op.kind is OpKind.LOAD or op.kind is OpKind.RECV:
        if op.slot_c < 0:
            return
        slots[op.slot_c] = _np_round(host[op.i, op.j], lad[op.cls])
    elif op.kind is OpKind.STORE:
        rounded = _np_round(slots[op.slot_c], lad[op.cls])
        slots[op.slot_c] = rounded
        host[op.i, op.j] = rounded
    elif op.kind is OpKind.SYRK:
        a = slots[op.slot_a]
        slots[op.slot_c] = slots[op.slot_c] - a @ a.T
    elif op.kind is OpKind.GEMM:
        slots[op.slot_c] = slots[op.slot_c] - slots[op.slot_a] @ slots[op.slot_b].T
    elif op.kind is OpKind.POTRF:
        slots[op.slot_c] = np.linalg.cholesky(
            0.5 * (slots[op.slot_c] + slots[op.slot_c].T))
    elif op.kind is OpKind.TRSM:
        import scipy.linalg as sla
        l = slots[op.slot_a]
        slots[op.slot_c] = sla.solve_triangular(
            l, slots[op.slot_c].T, lower=True).T


def _no_spill(host_slots: int, why: str) -> None:
    if host_slots > 0:
        raise ValueError(why)


def run_schedule_numpy(host_tiles: np.ndarray, sched: Schedule,
                       trace=None) -> np.ndarray:
    """Interpret the op stream with NumPy; returns the factored tile store.

    A spill schedule (``host_slots > 0``) is replayed through a bounded
    host cache over an in-memory backing store with the disk store's
    interface; :func:`run_schedule_spill` drives a real on-disk
    :class:`~repro_torch.core.spill.DiskTileStore`.

    ``trace``: an active recorder (``active``, ``now()``, ``record(...)``)
    records one span per op; ``None`` or an inactive one leaves the loop
    untouched."""
    if sched.host_slots > 0:
        from .spill import ArrayTileStore
        store = ArrayTileStore(host_tiles)
        run_schedule_spill(store, sched, trace=trace)
        return store.to_tiles()
    host = host_tiles.astype(np.float64).copy()
    tb = sched.tb
    nslots = _device_nslots(sched.ops)
    slots = np.zeros((nslots, tb, tb), dtype=np.float64)
    lad = sched.plan.ladder
    if trace is not None and getattr(trace, "active", False):
        for idx, op in enumerate(sched.ops):
            t0 = trace.now()
            _np_interpret_op(host, slots, op, lad)
            trace.record(idx, op.kind.value, 0, t0, trace.now(), op.bytes,
                         lad[op.cls], op.i, op.j)
        return host
    for op in sched.ops:
        _np_interpret_op(host, slots, op, lad)
    return host


def run_schedule_spill(store, sched: Schedule, trace=None):
    """Replay a spill schedule against a disk-backed tile store in place.

    ``store`` is a :class:`~repro_torch.core.spill.DiskTileStore` (or
    anything with its tile interface) holding the input tiles; on return
    it holds the factored tiles.  Host memory holds one ``[host_slots, tb,
    tb]`` slab cache plus the slot buffer.  Returns the
    :class:`~repro_torch.core.spill.SpilledHostStore`, whose fetch/spill
    counters crosscheck the schedule.  An active ``trace`` recorder gets
    one span per op, disk I/O included."""
    from .spill import SpilledHostStore
    if sched.host_slots < 1:
        raise ValueError("run_schedule_spill needs a spill schedule "
                         "(build with host_slots > 0)")
    host = SpilledHostStore(store, sched.host_slots)
    slots = np.zeros((_device_nslots(sched.ops), sched.tb, sched.tb),
                     dtype=np.float64)
    lad = sched.plan.ladder
    if trace is not None and getattr(trace, "active", False):
        for idx, op in enumerate(sched.ops):
            t0 = trace.now()
            _np_interpret_op(host, slots, op, lad)
            trace.record(idx, op.kind.value, 0, t0, trace.now(), op.bytes,
                         lad[op.cls], op.i, op.j)
    else:
        for op in sched.ops:
            _np_interpret_op(host, slots, op, lad)
    store.flush()
    return host


def run_multidevice_numpy(host_tiles: np.ndarray,
                          msched: MultiDeviceSchedule,
                          trace=None) -> np.ndarray:
    """Interpret all per-device op streams against one host tile store.

    Each device gets its own slot buffer; the streams are replayed in
    :meth:`MultiDeviceSchedule.iter_column_order` (traced: in
    ``iter_dispatch_order``, each span tagged with its device stream and
    dispatch phase), so every RECV observes the sender's finalized tile.
    A spill schedule replays through :func:`run_multidevice_spill` over an
    in-memory backing store."""
    if msched.host_slots > 0:
        from .spill import ArrayTileStore
        store = ArrayTileStore(host_tiles)
        run_multidevice_spill(store, msched, trace=trace)
        return store.to_tiles()
    host = host_tiles.astype(np.float64).copy()
    tb = msched.tb
    lad = msched.plan.ladder
    slots = [np.zeros((msched.stream_nslots(d), tb, tb), dtype=np.float64)
             for d in range(msched.ndev)]
    if trace is not None and getattr(trace, "active", False):
        for idx, (d, op, phase) in enumerate(
                msched.iter_dispatch_order(with_phase=True)):
            t0 = trace.now()
            _np_interpret_op(host, slots[d], op, lad)
            trace.record(idx, op.kind.value, d, t0, trace.now(), op.bytes,
                         lad[op.cls], op.i, op.j, phase)
        return host
    for d, op in msched.iter_column_order():
        _np_interpret_op(host, slots[d], op, lad)
    return host


def run_multidevice_spill(store, msched: MultiDeviceSchedule, trace=None):
    """Replay a multi-device spill schedule against one shared tile store.

    Each device bounds its own host tier (one
    :class:`~repro_torch.core.spill.SpilledHostStore` per stream) over the
    one shared store.  A BCAST snapshots the sender's resident slab onto a
    wire keyed ``(i, j, k, src)`` and each RECV consumes the wire, into a
    panel slot (class-rounded) or, for a host-landing RECV, into the
    receiver's own slab.  Replayed in dispatch order; returns the
    per-device host stores (fetch/spill counters)."""
    from .spill import SpilledHostStore
    if msched.host_slots < 1:
        raise ValueError("run_multidevice_spill needs a spill schedule "
                         "(build with host_slots > 0)")
    tb = msched.tb
    lad = msched.plan.ladder
    hosts = [SpilledHostStore(store, msched.host_slots)
             for _ in range(msched.ndev)]
    slots = [np.zeros((msched.stream_nslots(d), tb, tb), dtype=np.float64)
             for d in range(msched.ndev)]
    wires: dict = {}
    recording = trace is not None and getattr(trace, "active", False)
    for idx, (d, op, phase) in enumerate(
            msched.iter_dispatch_order(with_phase=True)):
        t0 = trace.now() if recording else 0
        if op.kind is OpKind.BCAST:
            wires[(op.i, op.j, op.k, op.src)] = np.array(hosts[d][op.i, op.j])
        elif op.kind is OpKind.RECV:
            t = wires[(op.i, op.j, op.k, op.src)]
            if op.slot_c >= 0:
                slots[d][op.slot_c] = _np_round(t, lad[op.cls])
            else:
                hosts[d][op.i, op.j] = t
        else:
            _np_interpret_op(hosts[d], slots[d], op, lad)
        if recording:
            trace.record(idx, op.kind.value, d, t0, trace.now(), op.bytes,
                         lad[op.cls], op.i, op.j, phase)
    store.flush()
    return hosts


# --------------------------------------------------------------------------
# The torch executor
# --------------------------------------------------------------------------

def _host_tile(host: torch.Tensor, op: Op, at=None) -> torch.Tensor:
    """The host store's view of tile ``(op.i, op.j)``.  ``at`` maps an op
    to its index in ``host``: None for the full ``[nt, nt]`` store, a
    device's ``(local row, j)`` in its slab, or the tile's slab in a spill
    executor's host tier."""
    return host[op.i, op.j] if at is None else host[at(op)]


def _load(host: torch.Tensor, slots: torch.Tensor, op: Op, lad,
          io: dict, at=None) -> None:
    s = slots[op.slot_c]
    s.copy_(_host_tile(host, op, at), non_blocking=True)
    r = _round(s, lad[op.cls])
    if r is not s:
        s.copy_(r)
    io["h2d_ops"] += 1
    io["h2d_bytes"] += s.numel() * s.element_size()


def _write_host(host: torch.Tensor, op: Op, tile: torch.Tensor,
                io: dict, at=None) -> None:
    _host_tile(host, op, at).copy_(tile, non_blocking=True)
    io["d2h_ops"] += 1
    io["d2h_bytes"] += tile.numel() * tile.element_size()


def _store(host: torch.Tensor, slots: torch.Tensor, op: Op, lad,
           io: dict, at=None) -> None:
    s = slots[op.slot_c]
    r = _round(s, lad[op.cls])
    if r is not s:
        s.copy_(r)
    _write_host(host, op, s, io, at)


def _interpret_op(host: torch.Tensor, slots: torch.Tensor, op: Op, lad,
                  kf: dict, io: dict, at=None) -> None:
    """Run one op against the host store (addressed through ``at``, as
    :func:`_host_tile`) and the slot buffer, in place."""
    kind = op.kind
    if kind is OpKind.LOAD:
        _load(host, slots, op, lad, io, at)
    elif kind is OpKind.STORE:
        _store(host, slots, op, lad, io, at)
    elif kind is OpKind.SYRK:
        slots[op.slot_c] = kf["syrk"](slots[op.slot_c], slots[op.slot_a])
    elif kind is OpKind.GEMM:
        slots[op.slot_c] = kf["gemm"](slots[op.slot_c], slots[op.slot_a],
                                      slots[op.slot_b])
    elif kind is OpKind.POTRF:
        slots[op.slot_c] = kf["potrf"](slots[op.slot_c])
    elif kind is OpKind.TRSM:
        slots[op.slot_c] = kf["trsm"](slots[op.slot_a], slots[op.slot_c])


def _new_io() -> dict:
    return {"h2d_ops": 0, "h2d_bytes": 0, "d2h_ops": 0, "d2h_bytes": 0}


def _fence(stream) -> None:
    """Wait until everything issued on ``stream`` has run (None: the CPU,
    where an op has finished when it returns)."""
    if stream is not None:
        stream.synchronize()


def _stream_of(device: torch.device):
    """The stream the executors issue on for ``device`` (None: the CPU)."""
    return (torch.cuda.current_stream(device) if device.type == "cuda"
            else None)


def _on_card(device: torch.device):
    """Issue on ``device``'s card (the kernels launch on the current one)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _check_host(host: torch.Tensor, compute_dtype) -> None:
    if host.dtype != compute_dtype or host.device.type != "cpu":
        raise ValueError(f"host store must be a CPU {compute_dtype} "
                         f"tensor, got {host.dtype} on {host.device}")


# --------------------------------------------------------------------------
# Fused column steps (CholeskyConfig.fuse_columns)
# --------------------------------------------------------------------------
#
# Port of the reference's grouping (``_parse_column_group``,
# ``_flush_group_fused``, ``_run_ops_fused``): the compute ops of one column
# step (same ``op.k``) gather into a pending group that runs as one
# ``fused_column_step`` launch when it matches the kernel's pattern, and op
# by op otherwise.  LOADs run ahead of the group and its STOREs are
# deferred behind it.  Two things differ.
#
# The slot buffer.  The reference's slots are immutable arrays, so an
# operand snapshot is a value.  Here a LOAD writes its slot in place and
# ``slots[s]`` is a view, so a snapshot holds a box around the live view,
# and a LOAD into a slot that a live box names first moves the old tile
# aside (copy on write).  A column's B row, which no LOAD touches while its
# group is pending, is never copied.
#
# Reloaded output slots.  The reference flushes the group when a LOAD
# targets a slot that the group writes: a finished row of this column
# whose STORE is still deferred.  Out of core that is the common case (at
# nt = 64 with v3's default 130 slots it splits 60 of 64 columns into 411
# groups, 52 of them fused), so here the LOAD instead retires that row
# under a private name (its start value is copied aside, its result goes
# to its deferred STORE and to no slot, as the LOAD has overwritten the
# slot in the unfused order too) and marks a cut where the reference would
# flush.  At the flush the parse decides: a group that matches the kernel
# whole, as a v2/v3 column does, is one launch; one that does not (the
# rows of sync/async/v1/v4 store mid-accumulation, re-read their operands
# or split into blocks) runs part by part between its cuts, which are the
# reference's groups.  The parse keys outputs by name and operands by
# snapshot, which is what the kernel reads.


class _Name:
    """A pending group's output: the slot it lives in, or None once a
    LOAD has retired it."""
    __slots__ = ("slot",)

    def __init__(self, slot):
        self.slot = slot


_FUSABLE = (OpKind.SYRK, OpKind.GEMM, OpKind.POTRF, OpKind.TRSM)


def _parse_column_group(group):
    """Match one column step's pending group against the kernel's pattern;
    ``None`` runs it per op.  ``group`` holds ``(op, snap, name)``.

    The reference's rules, op for op: an optional diagonal phase (SYRKs
    into one output, then its POTRF), then rows (GEMMs into one output,
    then its TRSM against the diagonal) with one history depth and one B
    operand sequence; at most one STORE per output, after its last
    compute; no output doubling as a history operand.  Where the
    reference compares slot numbers, this compares output names and
    operand snapshots, which is what the kernel reads: a name is one
    output of the group, a snapshot one version of a slot."""
    def out(e):
        return e[2]

    def opnd(e, role):
        t = e[1][role]
        return t[1] if t[0] == "slot" else id(t[1])

    ents = [e for e in group if e[0].kind is not OpKind.STORE]
    last_compute_pos = {}
    for pos, e in enumerate(group):
        if e[0].kind is not OpKind.STORE:
            last_compute_pos[out(e)] = pos
    store_of = {}
    for pos, e in enumerate(group):
        if e[0].kind is OpKind.STORE:
            if out(e) in store_of:          # two roundings of one slot
                return None
            if pos < last_compute_pos.get(out(e), -1):
                return None                 # mid-accumulation store
            store_of[out(e)] = e[0]
    idx, n = 0, len(ents)
    syrks: list = []
    potrf = None
    while idx < n and ents[idx][0].kind is OpKind.SYRK:
        syrks.append(ents[idx])
        idx += 1
    if idx < n and ents[idx][0].kind is OpKind.POTRF:
        potrf = ents[idx]
        idx += 1
        if any(out(e) != out(potrf) for e in syrks):
            return None
    elif syrks:
        return None
    rows = []
    while idx < n:
        gemms: list = []
        while idx < n and ents[idx][0].kind is OpKind.GEMM:
            gemms.append(ents[idx])
            idx += 1
        if idx >= n or ents[idx][0].kind is not OpKind.TRSM:
            return None
        trsm = ents[idx]
        idx += 1
        if any(out(e) != out(trsm) for e in gemms):
            return None
        rows.append((gemms, trsm))
    with_diag = potrf is not None
    if not with_diag and not rows:
        return None
    k_steps = len(syrks) if with_diag else len(rows[0][0])
    b_ops = ([opnd(e, "a") for e in syrks] if with_diag
              else [opnd(e, "b") for e in rows[0][0]])
    for gemms, _t in rows:
        if len(gemms) != k_steps \
                or [opnd(e, "b") for e in gemms] != b_ops:
            return None
    diag = out(potrf) if with_diag else opnd(rows[0][1], "l")
    if any(opnd(t, "l") != diag for _g, t in rows):
        return None
    outputs = ([diag] if with_diag else []) + [out(t) for _g, t in rows]
    if len(set(outputs)) != len(outputs):
        return None
    if not set(store_of) <= set(outputs):
        return None     # a store of a tile this launch doesn't produce
    operands = set(b_ops)
    for gemms, _t in rows:
        operands.update(opnd(e, "a") for e in gemms)
    if set(outputs) & operands:
        # an output doubling as a history operand: the operand would be
        # an in-launch intermediate, which the kernel cannot read
        return None
    return {"with_diag": with_diag, "rows": rows, "syrks": syrks,
            "k_steps": k_steps, "outputs": outputs, "store_of": store_of}


def _run_segment(seg, parsed, local, lad, kf):
    """Run one matched or unmatched part of a pending group over ``local``
    (output name -> value, updated in place): one fused launch when
    ``parsed`` holds its pattern, the per-op kernels otherwise.  Returns
    ``(store_op, rounded_tile)`` in stream order."""
    def val(t):
        return local[t[1]] if t[0] == "slot" else t[1][0]

    if parsed is None:
        # per-op replay over the snapshots, STORE roundings at their exact
        # stream position
        host_writes = []
        for op, snap, name in seg:
            if op.kind is OpKind.STORE:
                r = _round(local[name], lad[op.cls])
                local[name] = r
                host_writes.append((op, r))
            elif op.kind is OpKind.SYRK:
                local[name] = kf["syrk"](local[name], val(snap["a"]))
            elif op.kind is OpKind.GEMM:
                local[name] = kf["gemm"](local[name], val(snap["a"]),
                                         val(snap["b"]))
            elif op.kind is OpKind.POTRF:
                local[name] = kf["potrf"](local[name])
            elif op.kind is OpKind.TRSM:
                local[name] = kf["trsm"](val(snap["l"]), local[name])
        return host_writes

    rows = parsed["rows"]
    with_diag = parsed["with_diag"]
    k_steps = parsed["k_steps"]
    names = parsed["outputs"]
    c_stack = torch.stack([local[nm] for nm in names])
    tb = c_stack.shape[-1]
    if k_steps:
        hist_rows = [[val(e[1]["a"]) for e in gemms] for gemms, _t in rows]
        if with_diag:
            bhist_tiles = [val(e[1]["a"]) for e in parsed["syrks"]]
            hist_rows = [bhist_tiles] + hist_rows
        else:
            bhist_tiles = [val(e[1]["b"]) for e in rows[0][0]]
        hist = torch.stack([t for r in hist_rows for t in r]).view(
            len(names), k_steps, tb, tb)
        bhist = torch.stack(bhist_tiles)
    else:
        hist = c_stack.new_empty((len(names), 0, tb, tb))
        bhist = c_stack.new_empty((0, tb, tb))
    l_kk = (c_stack.new_zeros((tb, tb)) if with_diag
            else val(rows[0][1][1]["l"]).contiguous())
    store_of = parsed["store_of"]
    cls_ids = [store_of[nm].cls if nm in store_of else -1 for nm in names]
    out = kops.fused_column_step(c_stack, hist, bhist, l_kk, cls_ids,
                                 ladder=lad, with_diag=with_diag)
    row_of = {}
    for r, nm in enumerate(names):
        row_of[nm] = r
        local[nm] = out[r]
    return [(op, out[row_of[name]])
            for op, _s, name in seg if op.kind is OpKind.STORE]


def _open_stores(group, cut):
    """The end of the STOREs that open the part at ``cut``: the reference,
    whose group is empty after its flush there, runs them alone."""
    while cut < len(group) and group[cut][0].kind is OpKind.STORE:
        cut += 1
    return cut


def _flush_group_fused(group, cuts, values, lad, kf):
    """Run one pending group over ``values`` (output name -> value, updated
    in place).

    ``group`` holds ``(op, snap, name)``: compute ops with their operands
    as taken at the op's stream position (``snap``) and the name of the
    output they write, plus the column's STOREs; ``cuts`` are the group
    positions where a LOAD retired an output, where the reference flushes.
    A group that matches the column-step pattern whole is one fused
    launch.  One that does not runs part by part between the cuts, as the
    reference's groups: each part fused where it matches and per op where
    it does not.  Returns ``(store_op, rounded_tile)`` in stream order for
    the caller to write to the host."""
    parts = [(group, _parse_column_group(group))]
    if parts[0][1] is None and cuts:
        parts = []
        bounds = [0, *cuts, len(group)]
        for a, b in zip(bounds, bounds[1:]):
            m = _open_stores(group[:b], a)
            parts += [(group[a:m], None),
                      (group[m:b], _parse_column_group(group[m:b]))]
    host_writes = []
    for seg, parsed in parts:
        host_writes += _run_segment(seg, parsed, values, lad, kf)
    return host_writes


def _run_ops_fused(ops, host, slots, lad, kf, io, at=None) -> None:
    """Run an op stream with column-step fusion, in place (the host store
    addressed through ``at``, as :func:`_interpret_op`).

    Compute ops of one column accumulate into a pending group launched as
    one kernel.  Each op's operands are taken at its stream position: a
    marker when the operand is itself a pending output, else a box around
    the slot's view, which a later LOAD into that slot replaces by a copy
    of the old tile first.  STOREs are deferred behind the launch.  A LOAD
    into a pending output's slot retires that output and marks a cut.  A
    LOAD of a host tile with a deferred STORE runs the group first: up to
    its last cut when the STORE lies before it, as the reference had
    flushed there, else whole."""
    group: list = []        # (op, operand snapshots, output name)
    cuts: list = []         # group positions of the retiring LOADs
    names: dict = {}        # slot -> the pending output living in it
    values: dict = {}       # output name -> its value (at first touch)
    dtiles: dict = {}       # host tile -> group position of its STORE
    live: dict = {}         # slot -> the box holding its live view
    recent: set = set()     # outputs touched since the last cut

    def snap_operand(s):
        if s in names:
            return ("slot", names[s])
        box = live.get(s)
        if box is None:
            box = live[s] = [slots[s]]
        return ("val", box)

    def output(s):
        name = names.get(s)
        if name is None:
            name = names[s] = _Name(s)
            values[name] = slots[s]
        recent.add(name)
        return name

    def run(upto):
        """Run ``group[:upto]`` and keep the rest pending."""
        for o, r in _flush_group_fused(group[:upto], cuts, values, lad, kf):
            _write_host(host, o, r, io, at)
        del group[:upto]
        cuts.clear()
        for t, pos in list(dtiles.items()):
            if pos < upto:
                del dtiles[t]
            else:
                dtiles[t] = pos - upto

    def flush():
        run(len(group))
        for name, v in values.items():
            if name.slot is not None:
                slots[name.slot] = v
        names.clear()
        values.clear()
        live.clear()
        recent.clear()

    for op in ops:
        if op.kind is OpKind.LOAD:
            pos = dtiles.get((op.i, op.j))
            if pos is not None:
                # the host tile's STORE hasn't landed yet
                cut = _open_stores(group, cuts[-1]) if cuts else 0
                run(cut) if pos < cut else flush()
            box = live.pop(op.slot_c, None)
            if box is not None:
                # a pending snapshot still reads this tile: move it aside
                box[0] = box[0].clone()
            name = names.pop(op.slot_c, None)
            if name is not None:
                # retire the pending output living here
                name.slot = None
                values[name] = values[name].clone()
                if name in recent:
                    # the reference flushes here (its group holds only
                    # what came since its last flush)
                    cuts.append(len(group))
                    recent.clear()
            _load(host, slots, op, lad, io, at)
        elif op.kind is OpKind.STORE:
            if group:
                # ride in the group: the rounding applies at this exact
                # stream position (launch epilogue / fallback replay),
                # the host write lands at flush
                dtiles[(op.i, op.j)] = len(group)
                group.append((op, None, output(op.slot_c)))
            else:
                _store(host, slots, op, lad, io, at)
        elif op.kind in _FUSABLE:
            if group and op.k != group[0][0].k:
                flush()
            snap = {}
            if op.kind is OpKind.SYRK:
                snap["a"] = snap_operand(op.slot_a)
            elif op.kind is OpKind.GEMM:
                snap["a"] = snap_operand(op.slot_a)
                snap["b"] = snap_operand(op.slot_b)
            elif op.kind is OpKind.TRSM:
                snap["l"] = snap_operand(op.slot_a)
            group.append((op, snap, output(op.slot_c)))
        # ALLOC/FREE are bookkeeping-only, as in the unfused run
    flush()


def make_torch_executor(sched: Schedule, compute_dtype=torch.float64,
                        use_pallas: bool = False, device="cuda",
                        fuse_columns: bool = False):
    """Build a function that replays ``sched`` on a host tile store.

    The store is the ``[nt, nt, tb, tb]`` CPU tensor in ``compute_dtype``
    (pinned for a CUDA ``device``); the function factors it in place and
    returns the executed transfer counters (copies and bytes each way)
    once every op is queued.  The caller synchronises the device before it
    reads the store.  ``fuse_columns`` runs each column step's compute ops
    as one ``fused_column_step`` launch (:func:`_run_ops_fused`); the
    transfers are unchanged.
    """
    _no_spill(sched.host_slots,
              "make_torch_executor replays over the full host store; a "
              "spill schedule bounds host residency: use SpillTorchExecutor")
    device = torch.device(device)
    tb = sched.tb
    lad = sched.plan.ladder
    nslots = max(_device_nslots(sched.ops), 1)
    kf = _make_kernel_fns(use_pallas)

    def run(host: torch.Tensor) -> dict:
        _check_host(host, compute_dtype)
        io = _new_io()
        with _on_card(device):
            slots = torch.zeros((nslots, tb, tb), dtype=compute_dtype,
                                device=device)
            if fuse_columns:
                _run_ops_fused(sched.ops, host, slots, lad, kf, io)
                return io
            for op in sched.ops:
                _interpret_op(host, slots, op, lad, kf, io)
        return io

    return run


def run_traced_torch(sched: Schedule, host: torch.Tensor, trace,
                     compute_dtype=torch.float64, use_pallas: bool = False,
                     device="cuda") -> dict:
    """Single-device execution in *measured* mode (port of the reference's
    measured single-device path): the op stream op by op through the
    interpreter and kernel table of :func:`make_torch_executor`, with the
    device's current stream synchronized after every op, so that each span
    covers that op's execution and not its queue insertion (a LOAD's
    non-blocking H2D and a STORE's D2H included).

    Factors ``host`` in place, as the executor does, and returns the same
    transfer counters, with every copy finished.  It records exactly one
    span per schedule op; ALLOC/FREE do no work, so their spans are the
    fence's own width.  A traced run is unfused even for a
    ``fuse_columns`` plan, as the reference's is, so its factor is bitwise
    the untraced unfused one.  The fences serialize the device, so a
    traced run is slower by construction."""
    _no_spill(sched.host_slots,
              "run_traced_torch runs host-resident schedules; spill "
              "schedules trace through SpillTorchExecutor")
    _check_host(host, compute_dtype)
    device = torch.device(device)
    lad = sched.plan.ladder
    kf = _make_kernel_fns(use_pallas)
    io = _new_io()
    with _on_card(device):
        stream = _stream_of(device)
        slots = torch.zeros((max(_device_nslots(sched.ops), 1), sched.tb,
                             sched.tb), dtype=compute_dtype, device=device)
        _fence(stream)                  # set-up outside the first span
        for idx, op in enumerate(sched.ops):
            t0 = trace.now()
            _interpret_op(host, slots, op, lad, kf, io)
            _fence(stream)
            trace.record(idx, op.kind.value, 0, t0, trace.now(), op.bytes,
                         lad[op.cls], op.i, op.j)
    return io


# --------------------------------------------------------------------------
# The spill executor (a bounded host tier over a disk tile store)
# --------------------------------------------------------------------------

def _bind(where: dict, op: Op) -> None:
    """FETCH ``op`` binds its tile to its slab, unbinding the slab's old
    tile: the only change of the tile -> slab map."""
    for t, s in list(where.items()):
        if s == op.slot_c:
            del where[t]
    where[(op.i, op.j)] = op.slot_c


class SpillTorchExecutor:
    """Replay a single-device spill schedule (``host_slots > 0``).

    Port of the reference's ``SpillJaxExecutor``.  The host tier is
    ``[host_slots, tb, tb]`` slabs in the compute dtype, pinned for a card
    (allocated at the first run and kept); the slot buffer lives on the
    device.  The stream is cut at its FETCH/SPILL ops into segments.
    Within a segment the tile -> slab map is constant (it changes only at
    a FETCH), so its LOAD/STOREs address ``slab = where[(i, j)]``, the map
    the reference bakes into its segments, through the in-core executor's
    own interpreter (:func:`_interpret_op`) or, with ``fuse_columns``, its
    fused groups (:func:`_run_ops_fused`), which never span a FETCH/SPILL
    since the segment ends there.

    FETCH and SPILL run on the host between segments: a FETCH reads one
    tile from the store into its slab (the f64 store narrowed to the
    compute dtype; a binding FETCH of 0 bytes reads nothing, as the next
    op overwrites the slab), a SPILL writes one slab back (widened to f64:
    both exact for values that went through an f32-or-lower class).  A
    slab may still be read by a queued LOAD's H2D or written by a queued
    STORE's D2H, so each segment records a CUDA event after its copies,
    and a FETCH or SPILL first waits on the event of the last segment
    that touched its slab.

    ``last_io_stats`` holds the executed FETCH/SPILL op and byte counters
    of the last run, as the reference's."""

    def __init__(self, sched: Schedule, compute_dtype=torch.float64,
                 use_pallas: bool = False, device="cuda",
                 fuse_columns: bool = False):
        if sched.host_slots < 1:
            raise ValueError("SpillTorchExecutor needs a spill schedule "
                             "(build with host_slots > 0)")
        self.sched = sched
        self.device = torch.device(device)
        self.dtype = compute_dtype
        self.last_io_stats = None
        self._kf = _make_kernel_fns(use_pallas)
        self._fuse = fuse_columns
        self._nslots = max(_device_nslots(sched.ops), 1)
        self._slabs = None
        self._lock = threading.Lock()   # solvers of one plan share the tier
        self._segments = self._build_segments()

    def _build_segments(self) -> list:
        """``("io", op)`` per FETCH/SPILL and ``("run", ops, at, slabs)``
        per stretch between them: its ops, the slab of each tile, and the
        slabs its LOAD/STOREs copy to or from."""
        where: dict = {}
        segments: list = []
        pending: list = []

        def close_run():
            if pending:
                snap = dict(where)
                segments.append(("run", list(pending),
                                 lambda o: snap[(o.i, o.j)],
                                 {snap[(o.i, o.j)] for o in pending
                                  if o.kind in (OpKind.LOAD, OpKind.STORE)}))
                pending.clear()

        for op in self.sched.ops:
            if op.kind in HOST_IO:
                close_run()
                if op.kind is OpKind.FETCH:
                    _bind(where, op)
                segments.append(("io", op))
            elif op.kind not in (OpKind.ALLOC, OpKind.FREE):
                pending.append(op)
        close_run()
        return segments

    def _tier(self):
        """The host tier and a zeroed slot buffer."""
        tb = self.sched.tb
        if self._slabs is None:
            self._slabs = torch.zeros(
                (self.sched.host_slots, tb, tb), dtype=self.dtype,
                pin_memory=self.device.type == "cuda")
        slots = torch.zeros((self._nslots, tb, tb), dtype=self.dtype,
                            device=self.device)
        return self._slabs, slots

    def _disk_io(self, store, slabs, op, disk: dict) -> None:
        """A FETCH or SPILL between the slab and the store, on the host."""
        if op.kind is OpKind.FETCH:
            disk["fetch_ops"] += 1
            disk["fetched_bytes"] += op.bytes
            if op.bytes:
                slabs[op.slot_c].copy_(
                    torch.from_numpy(store.read_tile(op.i, op.j)))
        else:
            disk["spill_ops"] += 1
            disk["spilled_bytes"] += op.bytes
            store.write_tile(op.i, op.j,
                             slabs[op.slot_c].to(torch.float64).numpy())

    def run_store(self, store, trace=None) -> dict:
        """Factor the tile store in place (input tiles -> L tiles); returns
        the executed H2D/D2H counters, every copy finished.  An active
        ``trace`` recorder takes the measured path: the stream op by op,
        each op fenced, one span per op, disk I/O included."""
        with self._lock:
            if trace is not None and getattr(trace, "active", False):
                return self._run_traced_store(store, trace)
            return self._run_store(store)

    def _run_store(self, store) -> dict:
        lad = self.sched.plan.ladder
        io = _new_io()
        disk = dict.fromkeys(("fetch_ops", "spill_ops", "fetched_bytes",
                              "spilled_bytes"), 0)
        with _on_card(self.device):
            stream = _stream_of(self.device)
            slabs, slots = self._tier()
            ready: dict = {}            # slab -> event after its last copy
            for seg in self._segments:
                if seg[0] == "io":
                    op = seg[1]
                    ev = ready.pop(op.slot_c, None)
                    if ev is not None:
                        ev.synchronize()
                    self._disk_io(store, slabs, op, disk)
                    continue
                _, ops, at, touched = seg
                if self._fuse:
                    _run_ops_fused(ops, slabs, slots, lad, self._kf, io, at)
                else:
                    for op in ops:
                        _interpret_op(slabs, slots, op, lad, self._kf, io,
                                      at)
                if stream is not None and touched:
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    ready.update(dict.fromkeys(touched, ev))
            _fence(stream)
        store.flush()
        self.last_io_stats = disk
        return io

    def _run_traced_store(self, store, trace) -> dict:
        """The measured replay: the stream op by op, each op fenced, with
        the tile -> slab map kept as the segments bake it."""
        lad = self.sched.plan.ladder
        io = _new_io()
        disk = dict.fromkeys(("fetch_ops", "spill_ops", "fetched_bytes",
                              "spilled_bytes"), 0)
        where: dict = {}

        def at(o):
            return where[(o.i, o.j)]

        with _on_card(self.device):
            stream = _stream_of(self.device)
            slabs, slots = self._tier()
            _fence(stream)              # set-up outside the first span
            for idx, op in enumerate(self.sched.ops):
                t0 = trace.now()
                if op.kind in HOST_IO:
                    if op.kind is OpKind.FETCH:
                        _bind(where, op)
                    self._disk_io(store, slabs, op, disk)
                else:
                    _interpret_op(slabs, slots, op, lad, self._kf, io, at)
                    _fence(stream)
                trace.record(idx, op.kind.value, 0, t0, trace.now(),
                             op.bytes, lad[op.cls], op.i, op.j)
        store.flush()
        self.last_io_stats = disk
        return io

    def __call__(self, host_tiles: np.ndarray, trace=None) -> np.ndarray:
        """Array in, array out: factor a ``[nt, nt, tb, tb]`` tile array
        through an in-memory backing store; returns the f64 tiles."""
        from .spill import ArrayTileStore
        store = ArrayTileStore(host_tiles)
        self.run_store(store, trace=trace)
        return store.to_tiles()


# --------------------------------------------------------------------------
# The multi-device executor (one CUDA stream per logical device)
# --------------------------------------------------------------------------

def _wire_dtype(cls_name: str) -> torch.dtype:
    """Dtype a broadcast tile travels in: its precision class (the
    interconnect carries class-precision bytes, paper §IV-C).  An f64
    class travels as f64, as the reference's does under x64."""
    return _CLASS_DTYPES[cls_name]


def _make_wire(tile: torch.Tensor, cls_name: str) -> tuple:
    """Round a finalized tile onto the interconnect wire: a fresh
    ``(payload, scale)`` pair, the payload in the class dtype.  The scaled
    FP8 class carries its power-of-two scale (a 0-d tensor); every other
    class has ``scale=None``.  The payload goes through the port's class
    round, so an e4m3 value past the band is NaN, as the reference's cast
    gives.  Byte accounting counts the payload only."""
    if cls_name == "f8e4m3s":
        s = _fp8_scale(tile.abs().amax())
        return _round(tile * s, "f8e4m3").to(torch.float8_e4m3fn), s
    return _round(tile, cls_name).to(_wire_dtype(cls_name), copy=True), None


def _unwire(wire: tuple, compute_dtype: torch.dtype) -> torch.Tensor:
    """Promote a received wire back to the compute dtype, inverting the
    scaled-FP8 scale when one rode along."""
    payload, scale = wire
    t = payload.to(compute_dtype)
    return t if scale is None else t / scale


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _wire_key(op: Op) -> tuple:
    """A wire's name: with eager panel pushes one tile can be on two wires
    at once (row-scoped now, panel-scoped for a later column), so the
    tile alone is not a key."""
    return op.i, op.j, op.k, op.src


class MultiDeviceTorchExecutor:
    """Replay a :class:`MultiDeviceSchedule` on ``ndev`` logical devices.

    Port of the reference's ``MultiDeviceJaxExecutor``.  Each logical
    device has its own CUDA stream, its slot buffer on its card and its
    host slab: the CPU rows of its grid row, in the compute dtype, pinned
    for a card.  A 1D grid's slabs are views of the caller's store; a 2D
    grid replicates each slab across its ``q`` grid-row peers, the first
    peer's being the view and the others' allocated at the first call and
    kept (``q - 1`` copies of the store in all).  The streams run as segments, one per
    :meth:`MultiDeviceSchedule.dispatch_chunks` entry (with
    ``fuse_columns``, recv-free chunks merge into the segment before them,
    as the reference merges them), each issued under its device and
    stream, so the kernels launch there.

    A segment first lands its RECVs, then runs its ops as the
    single-device executor does, then cuts the wires its BCASTs publish
    and records an event.  A wire is cut from the sender's host slab at
    the segment's end, as the reference cuts it: the tile comes back with
    an H2D on the sender's stream, counted apart from the LOADs.  A RECV
    waits on the sender's event, copies the wire to its card (or reads it
    on the same card), unwires it into its slot, or for a host-landing
    RECV (``slot_c < 0``) into its slab with a D2H.  A wire is dropped
    after its last receiver.

    With an active ``trace`` recorder the call takes the measured path
    instead (:meth:`_run_traced`): every op of every stream in
    ``iter_dispatch_order``, unfused, on its device's stream, which is
    synchronized after each op, one span per op.

    Numerics are op for op those of :func:`run_multidevice_numpy`.
    ``last_transfer_stats`` holds the executed BCAST/RECV op and byte
    counters of the last run, as the reference counts them.
    """

    def __init__(self, msched: MultiDeviceSchedule,
                 compute_dtype=torch.float64, use_pallas: bool = False,
                 devices=None, fuse_columns: bool = False):
        if msched.ndev < 2:
            raise ValueError(
                f"MultiDeviceTorchExecutor needs ndev >= 2 (got "
                f"{msched.ndev}); use make_torch_executor for one device")
        _no_spill(msched.host_slots,
                  "the multi-device executor keeps full row slabs; "
                  "multi-device spill schedules run on the NumPy replay "
                  "(backend='numpy')")
        from .api import logical_devices
        devices = logical_devices(devices, msched.ndev)
        self.msched = msched
        self.devices = devices
        self.dtype = compute_dtype
        self.last_transfer_stats = None
        self._kf = _make_kernel_fns(use_pallas)
        self._fuse = fuse_columns
        p, q = msched.grid
        self._rows = [[i for i in range(msched.nt) if i % p == d // q]
                      for d in range(msched.ndev)]
        self._local_row = [{g: l for l, g in enumerate(rows)}
                           for rows in self._rows]
        self._at = [lambda o, lrow=lrow: (lrow[o.i], o.j)
                    for lrow in self._local_row]
        self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                         else None for d in devices]
        self._replicas: dict = {}   # d -> its pinned slab (2D grid peers)
        self._lock = threading.Lock()   # solvers of one plan share both
        self._segments = self._build_segments()

    def _build_segments(self) -> list:
        """``(device, RECVs, body, BCASTs)`` per segment."""
        msched = self.msched
        nrecv: dict = {}
        for stream in msched.streams:
            for o in stream:
                if o.kind is OpKind.RECV:
                    nrecv[_wire_key(o)] = nrecv.get(_wire_key(o), 0) + 1
        self._nrecv = nrecv
        chunks = [(d, list(msched.streams[d][start:stop]))
                  for d, start, stop, _k, _ph in msched.dispatch_chunks()]
        if self._fuse:
            # a recv-free chunk depends on nothing another device issued
            # between it and the chunk before it (data crosses only on
            # wires), so it may join that segment
            merged: list = []
            for d, ops in chunks:
                if (merged and merged[-1][0] == d
                        and not any(o.kind is OpKind.RECV for o in ops)):
                    merged[-1][1].extend(ops)
                else:
                    merged.append((d, ops))
            chunks = merged
        return [(d, [o for o in ops if o.kind is OpKind.RECV],
                 [o for o in ops
                  if o.kind not in (OpKind.RECV, OpKind.BCAST)],
                 [o for o in ops if o.kind is OpKind.BCAST])
                for d, ops in chunks]

    @contextlib.contextmanager
    def _on(self, d: int):
        """Issue on logical device ``d``: its card and its stream."""
        s = self._streams[d]
        if s is None:
            yield
            return
        with torch.cuda.device(self.devices[d]), torch.cuda.stream(s):
            yield

    def _take(self, x, d: int):
        """Wire tensor ``x`` for logical device ``d``'s stream: copied to
        its card, or read where it is on the same card.  The allocator is
        told which stream reads ``x`` so that dropping the wire is safe."""
        if x is None or self._streams[d] is None:
            return x
        if x.device == self.devices[d]:
            x.record_stream(self._streams[d])
            return x
        # a copy between cards runs on the source card's current stream
        x.record_stream(torch.cuda.current_stream(x.device))
        return x.to(self.devices[d], non_blocking=True)

    def __call__(self, host: torch.Tensor, trace=None) -> dict:
        """Factor the ``[nt, nt, tb, tb]`` CPU store (compute dtype, pinned
        for a card) in place; returns the executed transfer counters summed
        over the devices.  Every stream has finished when it returns.  An
        active ``trace`` recorder takes the measured path."""
        with self._lock:
            if trace is not None and getattr(trace, "active", False):
                return self._run_traced(host, trace)
            return self._factor(host)

    def _setup(self, host: torch.Tensor) -> tuple:
        """Each device's slab (a view of ``host``, or a grid-row peer's
        replica filled from it) and zeroed slot buffer."""
        msched = self.msched
        nt, tb, cdt = msched.nt, msched.tb, self.dtype
        if (host.dtype != cdt or host.device.type != "cpu"
                or tuple(host.shape) != (nt, nt, tb, tb)):
            raise ValueError(
                f"host store must be a CPU {cdt} [{nt}, {nt}, {tb}, {tb}] "
                f"tensor, got {host.dtype} {tuple(host.shape)} on "
                f"{host.device}")
        p, q = msched.grid
        slabs, slots = [], []
        for d, dev in enumerate(self.devices):
            slab = host[d // q::p]
            if d % q:                       # a grid-row peer's replica
                if d not in self._replicas:
                    self._replicas[d] = torch.empty(
                        slab.shape, dtype=cdt, pin_memory=dev.type == "cuda")
                slab = self._replicas[d].copy_(slab)
            slabs.append(slab)
            with self._on(d):
                slots.append(torch.zeros(
                    (max(msched.stream_nslots(d), 1), tb, tb), dtype=cdt,
                    device=dev))
        return slabs, slots

    @staticmethod
    def _counters() -> tuple:
        stats = dict.fromkeys(("bcast_ops", "recv_ops", "bcast_bytes",
                               "recv_bytes"), 0)
        io = dict.fromkeys(("h2d_ops", "h2d_bytes", "d2h_ops", "d2h_bytes",
                            "wire_h2d_ops", "wire_h2d_bytes",
                            "recv_d2h_ops", "recv_d2h_bytes"), 0)
        return stats, io

    def _cut(self, d: int, o: Op, slab, io: dict, stats: dict) -> tuple:
        """Cut BCAST ``o``'s wire from device ``d``'s slab, on its stream:
        ``(key, payload, scale)``."""
        tile = torch.empty((self.msched.tb,) * 2, dtype=self.dtype,
                           device=self.devices[d])
        tile.copy_(_host_tile(slab, o, self._at[d]), non_blocking=True)
        io["wire_h2d_ops"] += 1
        io["wire_h2d_bytes"] += _nbytes(tile)
        payload, scale = _make_wire(tile, self.msched.plan.ladder[o.cls])
        key = _wire_key(o)
        stats["bcast_ops"] += 1
        stats["bcast_bytes"] += _nbytes(payload) * self._nrecv[key]
        return key, payload, scale

    def _land(self, d: int, o: Op, payload, scale, slab, slots, io: dict,
              stats: dict) -> None:
        """Land RECV ``o``'s wire on device ``d``, on its stream: into its
        slot, or for a host-landing RECV into its slab."""
        payload = self._take(payload, d)
        t = _unwire((payload, self._take(scale, d)), self.dtype)
        if o.slot_c >= 0:
            slots[o.slot_c].copy_(t)
        else:
            _host_tile(slab, o, self._at[d]).copy_(t, non_blocking=True)
            io["recv_d2h_ops"] += 1
            io["recv_d2h_bytes"] += _nbytes(t)
        stats["recv_ops"] += 1
        stats["recv_bytes"] += _nbytes(payload)

    def _finish(self, host: torch.Tensor, slabs: list, stats: dict) -> None:
        """Wait for every stream, gather the diagonal tiles a 2D grid never
        ships, and keep the run's BCAST/RECV counters."""
        for s in self._streams:
            _fence(s)
        p, q = self.msched.grid
        if q > 1:
            # slabs are replicated along grid rows and kept coherent by the
            # row-scoped broadcast, except the diagonal tiles, which no
            # later task reads and which are never shipped: read each one
            # from its own diagonal owner
            for k in range(self.msched.nt):
                if k % q:
                    dv = grid_owner(k, k, p, q)
                    host[k, k].copy_(slabs[dv][self._local_row[dv][k], k])
        self.last_transfer_stats = stats

    def _factor(self, host: torch.Tensor) -> dict:
        lad = self.msched.plan.ladder
        slabs, slots = self._setup(host)
        stats, io = self._counters()
        wire_of: dict = {}                  # key -> (payload, scale, event)
        pending = dict(self._nrecv)         # key -> receivers still to land
        for d, recvs, body, bcasts in self._segments:
            stream, at = self._streams[d], self._at[d]
            with self._on(d):
                for o in recvs:
                    key = _wire_key(o)
                    payload, scale, ready = wire_of[key]
                    pending[key] -= 1
                    if pending[key] == 0:   # last receiver: drop the wire
                        del wire_of[key]
                    if ready is not None:
                        stream.wait_event(ready)
                    self._land(d, o, payload, scale, slabs[d], slots[d], io,
                               stats)
                if self._fuse:
                    _run_ops_fused(body, slabs[d], slots[d], lad, self._kf,
                                   io, at)
                else:
                    for o in body:
                        _interpret_op(slabs[d], slots[d], o, lad, self._kf,
                                      io, at)
                made = [self._cut(d, o, slabs[d], io, stats) for o in bcasts]
                ready = None
                if made and stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(stream)
                for key, payload, scale in made:
                    wire_of[key] = (payload, scale, ready)
        self._finish(host, slabs, stats)
        return io

    def _run_traced(self, host: torch.Tensor, trace) -> dict:
        """The measured replay (the reference's ``_run_traced``): every op
        of every stream in ``iter_dispatch_order``, unfused, issued on its
        logical device's stream, which is synchronized after the op; one
        span per op, tagged with its device and dispatch phase.  Wires are
        cut and landed as :meth:`_factor` does, each at its op's place in
        the order, and ``last_transfer_stats`` is kept as there."""
        lad = self.msched.plan.ladder
        slabs, slots = self._setup(host)
        for s in self._streams:             # set-up outside the first span
            _fence(s)
        stats, io = self._counters()
        wire_of: dict = {}
        pending = dict(self._nrecv)
        for idx, (d, op, phase) in enumerate(
                self.msched.iter_dispatch_order(with_phase=True)):
            t0 = trace.now()
            with self._on(d):
                if op.kind is OpKind.BCAST:
                    key, payload, scale = self._cut(d, op, slabs[d], io,
                                                    stats)
                    wire_of[key] = (payload, scale)
                elif op.kind is OpKind.RECV:
                    key = _wire_key(op)
                    payload, scale = wire_of[key]
                    pending[key] -= 1
                    if pending[key] == 0:
                        del wire_of[key]
                    self._land(d, op, payload, scale, slabs[d], slots[d],
                               io, stats)
                else:
                    _interpret_op(slabs[d], slots[d], op, lad, self._kf, io,
                                  self._at[d])
                _fence(self._streams[d])
            trace.record(idx, op.kind.value, d, t0, trace.now(), op.bytes,
                         lad[op.cls], op.i, op.j, phase)
        self._finish(host, slabs, stats)
        return io


def make_multidevice_torch_executor(msched: MultiDeviceSchedule,
                                    compute_dtype=torch.float64,
                                    use_pallas: bool = False, devices=None,
                                    fuse_columns: bool = False,
                                    ) -> MultiDeviceTorchExecutor:
    """Build the multi-device executor of ``msched``: a callable that
    factors a ``[nt, nt, tb, tb]`` CPU store in place and returns the
    executed transfer counters.  ``devices`` names the ``msched.ndev``
    logical devices as ``CholeskyPlan.compile`` takes them
    (:func:`repro_torch.core.api.logical_devices`; default: the first
    ``ndev`` cards, RuntimeError when fewer are visible); see
    :class:`MultiDeviceTorchExecutor`."""
    return MultiDeviceTorchExecutor(msched, compute_dtype,
                                    use_pallas=use_pallas, devices=devices,
                                    fuse_columns=fuse_columns)


def _tile_stats(a: torch.Tensor, tb: int):
    """Per-tile Frobenius norms and absolute maxima of an [n, n] tensor,
    on its own device, one tile row at a time, and ||A||_F from the lower
    tiles, summed as precision.tile_norms does."""
    nt = a.shape[0] // tb
    norms = torch.empty((nt, nt), dtype=torch.float64)
    amax = torch.empty((nt, nt), dtype=torch.float64)
    for i in range(nt):
        rows = a[i * tb:(i + 1) * tb].to(torch.float64).reshape(tb, nt, tb)
        norms[i] = rows.square().sum(dim=(0, 2)).sqrt().cpu()
        amax[i] = rows.abs().amax(dim=(0, 2)).cpu()
    norms = norms.numpy()
    total = 0.0
    for j in range(nt):
        for i in range(j, nt):
            total += (1.0 if i == j else 2.0) * norms[i, j] ** 2
    return norms, amax.numpy(), float(np.sqrt(total))


def plan_for_matrix(a, eps_target: float | None, ladder: str = "tpu",
                    tb: int | None = None) -> PrecisionPlan:
    """Higham-Mary precision plan of a matrix (port of the reference's
    ``plan_for_matrix``).

    ``a`` is a numpy ``[nt, nt, tb, tb]`` tile store, as in the reference,
    or an ``[n, n]`` tensor on any device together with ``tb``; the tile
    norms and maxima of a tensor are taken on its device.
    """
    if isinstance(a, torch.Tensor):
        if tb is None:
            raise ValueError("plan_for_matrix: pass tb with an [n, n] tensor")
        nt = a.shape[0] // tb
        if eps_target is None:
            return uniform_plan(nt, "f64", ladder)
        norms, amax, total = _tile_stats(a, tb)
    else:
        if eps_target is None:
            return uniform_plan(a.shape[0], "f64", ladder)
        norms, total = tile_norms(a)
        amax = tile_amax(a)
    return assign_precision(norms, total, eps_target, ladder, tile_amax=amax)


def ooc_cholesky(
    a,
    tb: int,
    policy: str = "v3",
    eps_target: float | None = None,
    ladder: str = "tpu",
    cache_slots: int = 0,
    backend: str | None = None,
    compute_dtype=None,
    use_pallas: bool = False,
    block: tuple = (4, 4),
    ndev: int = 1,
    device=None,
) -> tuple[np.ndarray, MultiDeviceSchedule]:
    """One-shot out-of-core Cholesky — deprecated shim over the planner API
    (port of the reference's ``ooc_cholesky``).

    .. deprecated::
       Use ``repro_torch.plan(n, CholeskyConfig(...)).compile()``: the
       static schedule and the executor are then built once and reused
       across every same-shape factorization.  Each keyword is the
       ``CholeskyConfig`` field of the same name; ``eps_target`` is frozen
       with ``specialize(a)``.

    ``a`` is an ndarray or a tensor on any device.  ``backend`` takes the
    port's names (``"torch"``, ``"numpy"``, ``"auto"``, the default) and
    reads the reference's ``"jax"`` as ``"torch"``; ``compute_dtype`` is a
    torch dtype, as the config's.  ``device`` goes to ``compile``: the
    card unless ``"cpu"`` (with ``ndev > 1``: one device or ``ndev`` of
    them).  Returns ``(L, schedule)``: L lower-triangular (upper part
    zero) as a host f64 ndarray, bitwise the planner path's factor, and
    the unified :class:`MultiDeviceSchedule` (``ndev=1`` degenerate on one
    device).  ``ndev > 1`` on the torch backend with fewer cards than
    ``ndev`` raises ``RuntimeError`` at compile; invalid combinations
    raise eagerly from config validation.
    """
    import warnings

    from ..convert import _BACKENDS
    from .api import CholeskyConfig, plan as _plan

    warnings.warn(
        "ooc_cholesky() is deprecated: use "
        "repro_torch.plan(n, CholeskyConfig(...)).compile() to amortize "
        "the schedule build and the executor across factorizations",
        DeprecationWarning, stacklevel=2)
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a, dtype=np.float64)
    backend = backend or "auto"
    cfg = CholeskyConfig(
        tb=tb, policy=policy, eps_target=eps_target, ladder=ladder,
        cache_slots=cache_slots, backend=_BACKENDS.get(backend, backend),
        compute_dtype=compute_dtype, use_pallas=use_pallas,
        block=block, ndev=ndev,
    ).specialize(a)
    solver = _plan(a.shape[0], cfg).compile(device=device)
    return solver.factor(a), solver.schedule
