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

It also holds the reference's NumPy replays, ``run_schedule_numpy`` and
``run_multidevice_numpy`` (``backend="numpy"``): host oracles that need no
card, bitwise the reference's on the same schedule.
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


def _no_spill(host_slots: int) -> None:
    if host_slots > 0:
        raise NotImplementedError(
            "spill schedules (host_slots > 0) are not ported yet "
            "(ROADMAP queue 1, item 7)")


def run_schedule_numpy(host_tiles: np.ndarray, sched: Schedule,
                       trace=None) -> np.ndarray:
    """Interpret the op stream with NumPy; returns the factored tile store.

    ``trace``: an active recorder (``active``, ``now()``, ``record(...)``)
    records one span per op; ``None`` or an inactive one leaves the loop
    untouched."""
    _no_spill(sched.host_slots)
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


def run_multidevice_numpy(host_tiles: np.ndarray,
                          msched: MultiDeviceSchedule,
                          trace=None) -> np.ndarray:
    """Interpret all per-device op streams against one host tile store.

    Each device gets its own slot buffer; the streams are replayed in
    :meth:`MultiDeviceSchedule.iter_column_order` (traced: in
    ``iter_dispatch_order``, each span tagged with its device stream and
    dispatch phase), so every RECV observes the sender's finalized tile."""
    _no_spill(msched.host_slots)
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


# --------------------------------------------------------------------------
# The torch executor
# --------------------------------------------------------------------------

def _host_tile(host: torch.Tensor, op: Op, lrow=None) -> torch.Tensor:
    """The host store's view of tile ``(op.i, op.j)``; ``lrow`` maps a
    global tile row to its row in a device's slab (None: the full store)."""
    return host[op.i if lrow is None else lrow[op.i], op.j]


def _load(host: torch.Tensor, slots: torch.Tensor, op: Op, lad,
          io: dict, lrow=None) -> None:
    s = slots[op.slot_c]
    s.copy_(_host_tile(host, op, lrow), non_blocking=True)
    r = _round(s, lad[op.cls])
    if r is not s:
        s.copy_(r)
    io["h2d_ops"] += 1
    io["h2d_bytes"] += s.numel() * s.element_size()


def _write_host(host: torch.Tensor, op: Op, tile: torch.Tensor,
                io: dict, lrow=None) -> None:
    _host_tile(host, op, lrow).copy_(tile, non_blocking=True)
    io["d2h_ops"] += 1
    io["d2h_bytes"] += tile.numel() * tile.element_size()


def _store(host: torch.Tensor, slots: torch.Tensor, op: Op, lad,
           io: dict, lrow=None) -> None:
    s = slots[op.slot_c]
    r = _round(s, lad[op.cls])
    if r is not s:
        s.copy_(r)
    _write_host(host, op, s, io, lrow)


def _interpret_op(host: torch.Tensor, slots: torch.Tensor, op: Op, lad,
                  kf: dict, io: dict, lrow=None) -> None:
    """Run one op against the host store (a device's slab, with ``lrow``)
    and the slot buffer, in place."""
    kind = op.kind
    if kind is OpKind.LOAD:
        _load(host, slots, op, lad, io, lrow)
    elif kind is OpKind.STORE:
        _store(host, slots, op, lad, io, lrow)
    elif kind is OpKind.SYRK:
        slots[op.slot_c] = kf["syrk"](slots[op.slot_c], slots[op.slot_a])
    elif kind is OpKind.GEMM:
        slots[op.slot_c] = kf["gemm"](slots[op.slot_c], slots[op.slot_a],
                                      slots[op.slot_b])
    elif kind is OpKind.POTRF:
        slots[op.slot_c] = kf["potrf"](slots[op.slot_c])
    elif kind is OpKind.TRSM:
        slots[op.slot_c] = kf["trsm"](slots[op.slot_a], slots[op.slot_c])


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


def _run_ops_fused(ops, host, slots, lad, kf, io, lrow=None) -> None:
    """Run an op stream with column-step fusion, in place (on a device's
    slab with ``lrow``, as :func:`_interpret_op`).

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
            _write_host(host, o, r, io, lrow)
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
            _load(host, slots, op, lad, io, lrow)
        elif op.kind is OpKind.STORE:
            if group:
                # ride in the group: the rounding applies at this exact
                # stream position (launch epilogue / fallback replay),
                # the host write lands at flush
                dtiles[(op.i, op.j)] = len(group)
                group.append((op, None, output(op.slot_c)))
            else:
                _store(host, slots, op, lad, io, lrow)
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
    _no_spill(sched.host_slots)
    device = torch.device(device)
    tb = sched.tb
    lad = sched.plan.ladder
    nslots = max(_device_nslots(sched.ops), 1)
    kf = _make_kernel_fns(use_pallas)

    def run(host: torch.Tensor) -> dict:
        if host.dtype != compute_dtype or host.device.type != "cpu":
            raise ValueError(f"host store must be a CPU {compute_dtype} "
                             f"tensor, got {host.dtype} on {host.device}")
        io = {"h2d_ops": 0, "h2d_bytes": 0, "d2h_ops": 0, "d2h_bytes": 0}
        # the kernels launch on the current card: issue on ``device``'s
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            slots = torch.zeros((nslots, tb, tb), dtype=compute_dtype,
                                device=device)
            if fuse_columns:
                _run_ops_fused(sched.ops, host, slots, lad, kf, io)
                return io
            for op in sched.ops:
                _interpret_op(host, slots, op, lad, kf, io)
        return io

    return run


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
        _no_spill(msched.host_slots)
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

    def __call__(self, host: torch.Tensor) -> dict:
        """Factor the ``[nt, nt, tb, tb]`` CPU store (compute dtype, pinned
        for a card) in place; returns the executed transfer counters summed
        over the devices.  Every stream has finished when it returns."""
        with self._lock:
            return self._factor(host)

    def _factor(self, host: torch.Tensor) -> dict:
        msched = self.msched
        nt, tb, cdt = msched.nt, msched.tb, self.dtype
        if (host.dtype != cdt or host.device.type != "cpu"
                or tuple(host.shape) != (nt, nt, tb, tb)):
            raise ValueError(
                f"host store must be a CPU {cdt} [{nt}, {nt}, {tb}, {tb}] "
                f"tensor, got {host.dtype} {tuple(host.shape)} on "
                f"{host.device}")
        p, q = msched.grid
        lad = msched.plan.ladder
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
        stats = dict.fromkeys(("bcast_ops", "recv_ops", "bcast_bytes",
                               "recv_bytes"), 0)
        io = dict.fromkeys(("h2d_ops", "h2d_bytes", "d2h_ops", "d2h_bytes",
                            "wire_h2d_ops", "wire_h2d_bytes",
                            "recv_d2h_ops", "recv_d2h_bytes"), 0)
        wire_of: dict = {}                  # key -> (payload, scale, event)
        pending = dict(self._nrecv)         # key -> receivers still to land
        for d, recvs, body, bcasts in self._segments:
            stream, lrow = self._streams[d], self._local_row[d]
            with self._on(d):
                for o in recvs:
                    key = _wire_key(o)
                    payload, scale, ready = wire_of[key]
                    pending[key] -= 1
                    if pending[key] == 0:   # last receiver: drop the wire
                        del wire_of[key]
                    if ready is not None:
                        stream.wait_event(ready)
                    payload = self._take(payload, d)
                    t = _unwire((payload, self._take(scale, d)), cdt)
                    if o.slot_c >= 0:
                        slots[d][o.slot_c].copy_(t)
                    else:
                        _host_tile(slabs[d], o, lrow).copy_(
                            t, non_blocking=True)
                        io["recv_d2h_ops"] += 1
                        io["recv_d2h_bytes"] += _nbytes(t)
                    stats["recv_ops"] += 1
                    stats["recv_bytes"] += _nbytes(payload)
                if self._fuse:
                    _run_ops_fused(body, slabs[d], slots[d], lad, self._kf,
                                   io, lrow)
                else:
                    for o in body:
                        _interpret_op(slabs[d], slots[d], o, lad, self._kf,
                                      io, lrow)
                made = []
                for o in bcasts:
                    tile = torch.empty((tb, tb), dtype=cdt,
                                       device=self.devices[d])
                    tile.copy_(_host_tile(slabs[d], o, lrow),
                               non_blocking=True)
                    io["wire_h2d_ops"] += 1
                    io["wire_h2d_bytes"] += _nbytes(tile)
                    payload, scale = _make_wire(tile, lad[o.cls])
                    key = _wire_key(o)
                    stats["bcast_ops"] += 1
                    stats["bcast_bytes"] += _nbytes(payload) * self._nrecv[key]
                    made.append((key, payload, scale))
                ready = None
                if made and stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(stream)
                for key, payload, scale in made:
                    wire_of[key] = (payload, scale, ready)
        for s in self._streams:
            if s is not None:
                s.synchronize()
        if q > 1:
            # slabs are replicated along grid rows and kept coherent by the
            # row-scoped broadcast, except the diagonal tiles, which no
            # later task reads and which are never shipped: read each one
            # from its own diagonal owner
            for k in range(nt):
                if k % q:
                    dv = grid_owner(k, k, p, q)
                    host[k, k].copy_(slabs[dv][self._local_row[dv][k], k])
        self.last_transfer_stats = stats
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
    on its own device, one tile row at a time."""
    nt = a.shape[0] // tb
    norms = torch.empty((nt, nt), dtype=torch.float64)
    amax = torch.empty((nt, nt), dtype=torch.float64)
    for i in range(nt):
        rows = a[i * tb:(i + 1) * tb].to(torch.float64).reshape(tb, nt, tb)
        norms[i] = rows.square().sum(dim=(0, 2)).sqrt().cpu()
        amax[i] = rows.abs().amax(dim=(0, 2)).cpu()
    return norms.numpy(), amax.numpy()


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
        norms, amax = _tile_stats(a, tb)
        # ||A||_F from the lower tiles, summed as precision.tile_norms does
        total = 0.0
        for j in range(nt):
            for i in range(j, nt):
                total += (1.0 if i == j else 2.0) * norms[i, j] ** 2
        total = float(np.sqrt(total))
    else:
        if eps_target is None:
            return uniform_plan(a.shape[0], "f64", ladder)
        norms, total = tile_norms(a)
        amax = tile_amax(a)
    return assign_precision(norms, total, eps_target, ladder, tile_amax=amax)
