"""Hardware calibration: micro-benchmarks -> a *measured* HardwareModel
(port of ``repro/tune/calibrate.py``).

The datasheet presets in :data:`repro_torch.core.analytics.HW` carry
published peaks; the simulator is only as predictive as those numbers are
honest for the device actually running.  This module times, on ``device``
(the card unless the caller passes ``device="cpu"``):

  * tb x tb POTRF / TRSM / SYRK / GEMM per precision class, through the
    executor's own kernel table (``_make_kernel_fns(use_pallas)``: on the
    card with ``use_pallas=True``, the default, the hand-written kernels),
    each operand first rounded through the class (the port's ``_round``,
    what LOAD does to a tile);
  * the fused column step, through the same entry the fused executor calls
    (``kernels.ops.fused_column_step``: the CUDA kernel on the card);
  * host<->device bandwidth from a pinned host tensor (the executor's tile
    store) at several transfer sizes, keeping the steady-state rate;
  * card-to-card bandwidth (``link_bw``) when two or more cards are
    visible, else 0.0 as in the reference;
  * the host's cost of one kernel call and of one allocation;
  * device memory (``torch.cuda.mem_get_info``; 8 GB for ``device="cpu"``,
    the reference's fallback), disk bandwidth and physical host RAM.

Where it differs from the reference: the reference times its plain path
(``use_pallas=False, interpret=True``) by host clock; the port times what
its executor runs on the card, the hand-written kernels, and takes each
rate from the device time a call, so that a kernel's rate leaves out the
host's issue, whose per-call cost goes to ``launch_overhead`` only.  The
device time is read by CUDA events around calls queued behind a spin
kernel (:func:`call_seconds`), not by ``torch.profiler``: in one
``chip_smoke.py`` process on an H100 the profiler recorded no device event
in 13 of the 39 sessions after its LM phase.  ``chip_smoke.py`` times its
kernels' device time with the same helper.  On the CPU, where every call
is synchronous, rates come from the host clock.
``compute_dtype`` and ``use_pallas`` are keywords where the reference reads
JAX's global x64 flag.  A kernel that fails to build or launch raises: no
rate is filled in from another.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import platform
import statistics
import tempfile
import time

import numpy as np
import torch

from ..core.analytics import GB, HW, HardwareModel
from ..core.precision import BYTES, LADDERS

# classes measured by default: every precision name any ladder can assign
_ALL_CLASSES = ("f64", "f32", "f16", "bf16", "f8e4m3", "f8e4m3s")

# device-memory capacity for device="cpu", the reference's fallback:
# deliberately small so OOC feasibility filtering stays exercised.
_FALLBACK_MEM_BYTES = 8 * GB

_TASK_FLOP_COUNT = {
    "gemm": lambda tb: 2 * tb**3,
    "syrk": lambda tb: tb**3,
    "trsm": lambda tb: tb**3,
    "potrf": lambda tb: tb**3 / 3.0,
}


def _device(device) -> torch.device:
    """``device`` resolved as the port's entry points do: the card unless
    the caller asks for the CPU, and RuntimeError when no card is there."""
    from ..core.api import _resolve_device
    return _resolve_device(device, "torch")


def hardware_fingerprint(device=None) -> str:
    """Identity hash of ``device`` (tuning-db cache key).

    On a card: the torch and CUDA versions, the card's name and compute
    capability, and the visible card count.  On the CPU: the torch version,
    the machine type and the core count."""
    dev = _device(device)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        parts = ["cuda", torch.__version__, str(torch.version.cuda),
                 torch.cuda.get_device_name(idx),
                 "sm_%d%d" % torch.cuda.get_device_capability(idx),
                 str(torch.cuda.device_count())]
    else:
        parts = ["cpu", torch.__version__, platform.machine(),
                 str(os.cpu_count())]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_seconds(fn, repeats: int, dev: torch.device) -> float:
    """Min-of-repeats wall time of ``fn()``, the device synchronized."""
    best = float("inf")
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return max(best, 1e-9)


#: GPU clock cycles the stream is held for before a timed batch (about
#: 25 ms at the H100's 1.98 GHz), multiplied until the host has queued the
#: whole batch before the device reaches it
_HOLD_CYCLES = 50_000_000
_MAX_HOLDS = 4


def call_seconds(fn, repeats: int, dev: torch.device) -> float:
    """Seconds of one call of ``fn``: on a card, its device time; on the
    CPU, the best host time.

    On a card the stream is first held by a spin kernel
    (``torch.cuda._sleep``) while the host queues ``repeats`` calls between
    two CUDA events, so that the device runs them back to back once the
    hold ends: the events then time the device's work without the host's
    issue between calls (which ``launch_overhead`` takes).  If the device
    reached the first event before the host had queued the last call, the
    hold was too short and the batch is timed again with a longer one."""
    if dev.type != "cuda":
        return _best_seconds(fn, repeats, dev)
    fn()                                    # warm: build, load, allocate
    torch.cuda.synchronize(dev)
    cycles = _HOLD_CYCLES
    for _ in range(_MAX_HOLDS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(repeats):
            fn()
        stop.record()
        drained = start.query()
        torch.cuda.synchronize(dev)
        if not drained:
            return start.elapsed_time(stop) / 1e3 / repeats
        cycles *= 4
    raise RuntimeError("calibrate: the host could not queue a timed batch "
                       "within the longest hold of the stream")


def _measure_kernels(tb: int, classes, repeats: int, dev: torch.device,
                     compute_dtype, use_pallas: bool) -> dict:
    """Time the executor's own kernel fns per (task, class) and return
    ``{task: {class: flop_rate}}``.

    The kernel runs as the executor would: operands round-trip through the
    class, the arithmetic runs in the compute dtype (f64 tiles take the
    stock path, as in the executor)."""
    from ..core.cholesky import _make_kernel_fns
    from ..kernels.ref import _round

    kf = _make_kernel_fns(use_pallas)
    rng = np.random.default_rng(0)
    spd = np.eye(tb) * (2.0 * tb)
    spd += rng.standard_normal((tb, tb)) @ rng.standard_normal((tb, tb)).T / tb

    def put(x):
        return torch.as_tensor(x, dtype=compute_dtype, device=dev)

    c_host, l_host = put(spd), put(np.linalg.cholesky(spd))
    a_host = put(rng.standard_normal((tb, tb)))
    b_host = put(rng.standard_normal((tb, tb)))

    rates: dict = {task: {} for task in _TASK_FLOP_COUNT}
    for cls_name in classes:

        def through(x, cls_name=cls_name):
            # class round-trip: what LOAD does to every operand tile
            return _round(x, cls_name)

        jobs = {
            "gemm": lambda: kf["gemm"](through(c_host), through(a_host),
                                       through(b_host)),
            "syrk": lambda: kf["syrk"](through(c_host), through(a_host)),
            "trsm": lambda: kf["trsm"](through(l_host), through(b_host)),
            "potrf": lambda: kf["potrf"](through(c_host)),
        }
        for task, fn in jobs.items():
            rates[task][cls_name] = (_TASK_FLOP_COUNT[task](tb)
                                     / call_seconds(fn, repeats, dev))
    return rates


def _measure_fused(tb: int, classes, repeats: int, dev: torch.device,
                   compute_dtype, r_tiles: int = 4, k_hist: int = 2) -> dict:
    """Time the fused column step per class and return
    ``{"fused_column": {class: flop_rate}}``.

    One launch runs the whole column step (update wave + POTRF + row
    TRSMs with the epilogue cast fused in), so its rate is directly
    comparable to the sum of the unfused per-op rates.  On a card, a tile
    size the kernel does not take (:func:`repro_torch.tune.search.
    fused_step_takes`) measures nothing: the fused route cannot run it."""
    from ..kernels import ops
    from .search import fused_step_takes

    if dev.type == "cuda" and not fused_step_takes(tb):
        return {}
    rng = np.random.default_rng(0)
    spd = np.eye(tb) * (2.0 * tb)
    spd += rng.standard_normal((tb, tb)) @ rng.standard_normal((tb, tb)).T / tb
    c_stack = torch.as_tensor(
        np.stack([spd] + [rng.standard_normal((tb, tb))
                          for _ in range(r_tiles - 1)]),
        dtype=compute_dtype, device=dev)
    hist = torch.as_tensor(rng.standard_normal((r_tiles, k_hist, tb, tb)) / tb,
                           dtype=compute_dtype, device=dev)
    bhist = hist[0].contiguous()
    l_kk = torch.zeros((tb, tb), dtype=compute_dtype, device=dev)
    # FLOPs of the whole step: R*K tile GEMMs + POTRF + (R-1) TRSMs
    flops = (r_tiles * k_hist * 2 * tb**3 + tb**3 / 3.0
             + (r_tiles - 1) * tb**3)

    rates: dict = {}
    for cls_name in classes:
        # the class's position in whichever ladder carries it (the
        # epilogue is ladder-indexed)
        lad = next((l for l in LADDERS.values() if cls_name in l), None)
        if lad is None:
            continue
        cls_ids = [lad.index(cls_name)] * r_tiles

        def run(lad=lad, cls_ids=cls_ids):
            return ops.fused_column_step(c_stack, hist, bhist, l_kk, cls_ids,
                                         ladder=lad, with_diag=True)
        rates[cls_name] = flops / call_seconds(run, repeats, dev)
    return {"fused_column": rates} if rates else {}


def _measure_bandwidth(sizes_mb, repeats: int,
                       dev: torch.device) -> tuple[float, float]:
    """Steady-state host->device / device->host bytes per second, from and
    to a host tensor pinned as the executor's tile store is."""
    h2d = d2h = 0.0
    for mb in sizes_mb:
        nbytes = int(mb * 1e6)
        host = torch.zeros(nbytes // 4, dtype=torch.float32,
                           pin_memory=dev.type == "cuda")
        x = torch.empty(host.shape, dtype=host.dtype, device=dev)
        dt_up = _best_seconds(lambda: x.copy_(host, non_blocking=True),
                              repeats, dev)
        dt_down = _best_seconds(lambda: host.copy_(x, non_blocking=True),
                                repeats, dev)
        # keep the best (largest-transfer) rate: small transfers are
        # latency-bound and would understate the link
        h2d = max(h2d, nbytes / dt_up)
        d2h = max(d2h, nbytes / dt_down)
    return h2d, d2h


def _measure_link_bandwidth(sizes_mb, repeats: int,
                            dev: torch.device) -> float:
    """Steady-state card-to-card bytes/s (a copy from ``dev`` to the next
    visible card) — the interconnect the multi-device wires ride.  Returns
    0.0 when fewer than two cards are visible (``simulate_multi`` then
    falls back to ``h2d_bw``)."""
    if dev.type != "cuda" or torch.cuda.device_count() < 2:
        return 0.0
    src = dev.index if dev.index is not None else torch.cuda.current_device()
    dst = torch.device("cuda", (src + 1) % torch.cuda.device_count())
    best = 0.0
    for mb in sizes_mb:
        nbytes = int(mb * 1e6)
        x = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
        y = torch.empty(x.shape, dtype=x.dtype, device=dst)

        def copy():
            y.copy_(x)
            torch.cuda.synchronize(dst)
        best = max(best, nbytes / _best_seconds(copy, repeats, dev))
    return best


def _measure_overheads(repeats: int, dev: torch.device, compute_dtype,
                       use_pallas: bool) -> tuple[float, float]:
    """(host seconds a kernel call, host seconds an allocation).

    The call is the executor's GEMM on 8 x 8 tiles, issued 50 times back to
    back and timed on the host clock before the device is synchronized:
    what the host pays to issue one op, whatever the device does."""
    from ..core.cholesky import _make_kernel_fns
    gemm = _make_kernel_fns(use_pallas)["gemm"]
    tiny = torch.ones((8, 8), dtype=compute_dtype, device=dev)
    gemm(tiny, tiny, tiny)                   # build, load
    n = 50
    best = float("inf")
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            gemm(tiny, tiny, tiny)
        best = min(best, time.perf_counter() - t0)
        _sync(dev)
    launch = max(best / n, 1e-8)
    alloc = _best_seconds(lambda: torch.zeros((256, 256), device=dev),
                          repeats, dev)
    return launch, alloc


def _measure_disk_bandwidth(sizes_mb, repeats: int,
                            directory: str | None = None
                            ) -> tuple[float, float]:
    """Sequential (read_bw, write_bw) bytes/s of the filesystem holding
    the spill tier's tile store.

    Writes fsync to make the number honest for SPILL durability; reads
    go through the page cache (so the measured read rate is the *replay's*
    effective rate — a FETCH of a recently spilled tile is usually warm —
    not the device's cold-read floor).  ``directory`` targets the
    filesystem the :class:`~repro_torch.core.spill.DiskTileStore` will live
    on (default: the system tmpdir)."""
    read_bw = write_bw = 0.0
    host = torch.device("cpu")
    with tempfile.TemporaryDirectory(dir=directory) as td:
        path = os.path.join(td, "disk_probe.bin")
        for mb in sizes_mb:
            nbytes = int(mb * 1e6)
            buf = bytes(nbytes)

            def wr():
                with open(path, "wb") as f:
                    f.write(buf)
                    f.flush()
                    os.fsync(f.fileno())

            def rd():
                with open(path, "rb") as f:
                    return f.read()

            write_bw = max(write_bw,
                           nbytes / _best_seconds(wr, repeats, host))
            read_bw = max(read_bw, nbytes / _best_seconds(rd, repeats, host))
    return read_bw, write_bw


def _host_mem_bytes() -> float:
    """Physical host RAM (``os.sysconf``); 0.0 where unavailable —
    the search then treats host memory as unbounded."""
    try:
        return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    except (AttributeError, OSError, ValueError):
        return 0.0


def _device_mem_bytes(dev: torch.device) -> float:
    """The card's total memory; the reference's fallback on the CPU."""
    if dev.type == "cuda":
        return float(torch.cuda.mem_get_info(dev)[1])
    return float(_FALLBACK_MEM_BYTES)


def refine_from_trace(trace, base: HardwareModel | None = None,
                      name: str | None = None, device=None) -> HardwareModel:
    """Refit a :class:`HardwareModel` from a *measured* execution trace.

    ``trace`` is a :class:`repro_torch.obs.TraceRecorder` filled by a
    traced ``OOCSolver.factor(a, trace=...)`` (its ``meta`` must carry
    ``tb``).  Per-op fenced spans are the honest record of what this
    machine did on the actual factorization ops:

    * compute spans refit ``kernel_flops[task][class]`` as
      ``task_flops(tb) / median(duration)``;
    * LOAD/STORE spans refit ``h2d_bw``/``d2h_bw`` as the median of
      ``bytes / duration``; RECV spans refit ``link_bw``; FETCH/SPILL
      spans refit the disk bandwidths;
    * everything the trace did not exercise keeps ``base``'s value
      (default: the ``a100-pcie`` datasheet preset).

    ``device`` names the machine the trace was recorded on, for the
    model's fingerprint (the card unless ``"cpu"``).
    """
    spans = trace.spans
    if not spans:
        raise ValueError("refine_from trace is empty: run "
                         "factor(..., trace=recorder) first")
    meta = getattr(trace, "meta", {}) or {}
    tb = meta.get("tb")
    if not tb:
        raise ValueError(
            "trace.meta carries no 'tb': refine from a trace recorded by "
            "OOCSolver.factor(a, trace=...) (which stamps run metadata), "
            "or set trace.meta['tb'] yourself")
    if base is None:
        base = HW["a100-pcie"]

    by_task: dict = {}
    bw: dict = {"load": [], "store": [], "recv": [], "fetch": [], "spill": []}
    for s in spans:
        dur = s.duration_s
        if dur <= 0:
            continue
        if s.kind in _TASK_FLOP_COUNT:
            by_task.setdefault((s.kind, s.cls or "f64"), []).append(dur)
        elif s.kind in bw and s.bytes > 0:
            bw[s.kind].append(s.bytes / dur)
    if not by_task and not any(bw.values()):
        raise ValueError("trace contains no compute or transfer spans to "
                         "refine from")

    kernel_flops = {task: dict(per)
                    for task, per in (base.kernel_flops or {}).items()}
    for (task, cls_name), durs in by_task.items():
        rate = _TASK_FLOP_COUNT[task](tb) / statistics.median(durs)
        kernel_flops.setdefault(task, {})[cls_name] = rate
    # class peaks follow the measured GEMM rates (the dominant kernel),
    # exactly as the micro-benchmark calibration does
    flops = dict(base.flops)
    flops.update(kernel_flops.get("gemm", {}))

    def med(rates, fallback):
        return statistics.median(rates) if rates else fallback

    return dataclasses.replace(
        base,
        name=name or f"refined-{base.name}",
        flops=flops,
        kernel_flops=kernel_flops,
        h2d_bw=med(bw["load"], base.h2d_bw),
        d2h_bw=med(bw["store"], base.d2h_bw),
        link_bw=med(bw["recv"], base.link_bw),
        disk_read_bw=med(bw["fetch"], base.disk_read_bw),
        disk_write_bw=med(bw["spill"], base.disk_write_bw),
        source="measured",
        fingerprint=hardware_fingerprint(device),
    )


def calibrate(tb: int = 256,
              classes=None,
              repeats: int = 3,
              transfer_sizes_mb=(1, 8, 32),
              mem_bytes: float | None = None,
              name: str | None = None,
              disk_dir: str | None = None,
              refine_from=None,
              base: HardwareModel | None = None,
              *,
              device=None,
              compute_dtype: torch.dtype = torch.float64,
              use_pallas: bool = True) -> HardwareModel:
    """Measure ``device`` (the card unless ``"cpu"``) and return a
    ``source="measured"`` model.

    The result plugs into everything the datasheet presets do —
    ``simulate``/``simulate_multi``, the tuner's candidate search — with
    per-kernel, per-class rates measured through the executor's own kernel
    table in ``compute_dtype`` (``use_pallas``: the hand-written kernels),
    real host-link and (with two or more cards) card-to-card bandwidth, and
    the card's memory (``mem_bytes`` overrides it, e.g. to model a smaller
    slot budget than the card has).

    ``refine_from``: instead of running micro-benchmarks, refit the model
    from a measured execution trace (:class:`repro_torch.obs.TraceRecorder`)
    — see :func:`refine_from_trace`; ``base`` seeds the un-exercised fields
    (default ``a100-pcie``).
    """
    if refine_from is not None:
        return refine_from_trace(refine_from, base=base, name=name,
                                 device=device)
    dev = _device(device)
    classes = tuple(classes) if classes is not None else _ALL_CLASSES
    for c in classes:
        if c not in BYTES:
            raise ValueError(f"unknown precision class {c!r}; "
                             f"expected a subset of {_ALL_CLASSES}")
    from ..core.cholesky import _on_card
    with _on_card(dev):
        kernel_flops = _measure_kernels(tb, classes, repeats, dev,
                                        compute_dtype, use_pallas)
        # the fused column step, timed as one launch: rates land under
        # kernel_flops["fused_column"] next to the per-op kernels
        kernel_flops.update(_measure_fused(tb, classes, repeats, dev,
                                           compute_dtype))
        h2d_bw, d2h_bw = _measure_bandwidth(transfer_sizes_mb, repeats, dev)
        link_bw = _measure_link_bandwidth(transfer_sizes_mb, repeats, dev)
        launch, alloc = _measure_overheads(repeats, dev, compute_dtype,
                                           use_pallas)
    disk_read_bw, disk_write_bw = _measure_disk_bandwidth(
        transfer_sizes_mb, repeats, directory=disk_dir)
    fp = hardware_fingerprint(dev)
    if name is None:
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        name = f"measured-{kind.lower().replace(' ', '-')}-{fp[:6]}"
    return HardwareModel(
        name=name,
        # class peaks = the measured GEMM rate (the dominant kernel);
        # per-kernel detail rides in kernel_flops for the simulator
        flops={c: kernel_flops["gemm"][c] for c in classes},
        h2d_bw=h2d_bw,
        d2h_bw=d2h_bw,
        link_bw=link_bw,
        alloc_overhead=alloc,
        launch_overhead=launch,
        mem_bytes=float(mem_bytes) if mem_bytes else _device_mem_bytes(dev),
        source="measured",
        fingerprint=fp,
        kernel_flops=kernel_flops,
        disk_read_bw=disk_read_bw,
        disk_write_bw=disk_write_bw,
        host_mem_bytes=_host_mem_bytes(),
    )


def model_to_dict(hw: HardwareModel) -> dict:
    """JSON-serializable form of a model (see :func:`model_from_dict`)."""
    return dataclasses.asdict(hw)


def model_from_dict(d: dict) -> HardwareModel:
    return HardwareModel(**d)
