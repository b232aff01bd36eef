"""Two-phase planner/executor API: ``CholeskyConfig`` -> plan -> solve.

Port of ``repro/core/api.py``::

    import repro_torch

    cfg = repro_torch.CholeskyConfig(tb=256, policy="v3")
    solver = repro_torch.plan(n, cfg).compile()   # device="cuda" by default
    l = solver.factor(a)                          # numpy or torch [n, n]
    x = solver.solve(b)

The config mirrors the reference field for field, so one config drives
both packages (:func:`repro_torch.convert.config_from_reference`).  It
differs where PyTorch does: ``compute_dtype`` is a torch dtype (``None``
means float64, the reference's x64 default), ``backend`` is ``"auto"``,
``"torch"`` or ``"numpy"``, and ``use_pallas`` keeps its name but selects
the hand-written Hopper tile kernels.  There is no jit here: ``compile()``
builds the op-by-op executor once per plan and device.  With ``ndev > 1``
it builds the multi-device executor over ``ndev`` logical devices: the
first ``ndev`` cards, a sequence of devices (one card may repeat, each
logical device getting a stream of its own), or ``ndev`` CPU handles.

``backend="numpy"`` runs the reference's NumPy replays on the host, for one
device or for the multi-device schedules of ``ndev``/``grid``/``lookahead``.
It runs only when asked for: ``"auto"`` resolves to ``"torch"``, also when
fewer than ``ndev`` cards are visible (that raises at ``compile()``).

Disk tier: ``host_slots=H > 0`` bounds host residency to ``H`` tile slabs
over a disk-backed store (the schedule's FETCH/SPILL ops).  One device runs
it on either backend, the torch backend through
:class:`~repro_torch.core.cholesky.SpillTorchExecutor`; ``ndev > 1`` runs it
on ``backend="numpy"`` only, and unlike the reference ``"auto"`` does not
resolve to that replay quietly: it raises, naming ``backend="numpy"``.

Tracing: ``factor(a, trace=rec)`` with an active
:class:`repro_torch.obs.TraceRecorder` (or one pinned at
``compile(trace=rec)``) runs the executor's measured path, one fenced span
per schedule op (:mod:`repro_torch.obs`).

Open dimensions: ``tb=0`` and/or ``policy="auto"`` leave those axes to
the autotuner (:mod:`repro_torch.tune`): ``plan()`` resolves them through
:func:`repro_torch.tune.resolve_config`, an exact simulation against the
config's ``hw`` preset or the process default model, and caches the plan
under the auto config too.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Optional

import numpy as np
import torch

from .precision import LADDERS, PrecisionPlan, uniform_plan
from .schedule import (MultiDeviceSchedule, OpKind,
                       build_multidevice_schedule, build_schedule,
                       min_cache_slots)
from .tiling import TileLayout, from_tiles, to_tiles

_POLICIES = ("sync", "async", "v1", "v2", "v3", "v4", "auto")
_MULTIDEV_POLICIES = ("sync", "v1", "v2", "v3")
_BACKENDS = ("auto", "torch", "numpy")
_COMPUTE_DTYPES = (torch.float64, torch.float32)
_DEFAULT_BLOCK = (4, 4)


def _obs_registry():
    """The process-wide obs metrics registry, imported lazily so that the
    planner stays importable without the obs package."""
    from ..obs.metrics import REGISTRY
    return REGISTRY


@dataclasses.dataclass(frozen=True)
class CholeskyConfig:
    """Frozen, hashable description of one OOC Cholesky pipeline (the
    reference's fields; see ``repro.core.api.CholeskyConfig``)."""

    tb: int
    policy: str = "v3"
    eps_target: Optional[float] = None
    ladder: str = "tpu"
    plan: Optional[PrecisionPlan] = None
    cache_slots: int = 0
    backend: str = "auto"
    compute_dtype: Any = None                 # torch dtype; None = float64
    use_pallas: bool = False                  # hand-written tile kernels
    fuse_columns: bool = False
    block: tuple = _DEFAULT_BLOCK
    ndev: int = 1
    grid: Optional[tuple] = None
    hw: Optional[str] = None
    lookahead: Optional[int] = None
    host_slots: int = 0

    def __post_init__(self):
        object.__setattr__(self, "policy", str(self.policy).lower())
        object.__setattr__(self, "block", tuple(self.block))
        if self.tb < 0:
            raise ValueError(f"tb must be >= 1, or 0 to let the tuner "
                             f"pick it, got {self.tb}")
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"expected one of {_POLICIES}")
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {_BACKENDS}")
        if self.ladder not in LADDERS:
            raise ValueError(f"unknown ladder {self.ladder!r}; "
                             f"expected one of {tuple(LADDERS)}")
        if self.eps_target is not None and self.eps_target <= 0:
            raise ValueError(f"eps_target must be > 0, got {self.eps_target}")
        if self.eps_target is not None and self.plan is not None:
            raise ValueError("pass either eps_target or an explicit plan, "
                             "not both")
        if self.cache_slots < 0:
            raise ValueError(f"cache_slots must be >= 0 (0 = policy "
                             f"default), got {self.cache_slots}")
        if self.ndev < 1:
            raise ValueError(f"ndev must be >= 1, got {self.ndev}")
        if self.grid is not None:
            object.__setattr__(self, "grid", tuple(self.grid))
            if (len(self.grid) != 2
                    or any(not isinstance(x, int) or x < 1
                           for x in self.grid)):
                raise ValueError(f"grid must be two positive ints (p, q), "
                                 f"got {self.grid!r}")
            if self.grid[0] * self.grid[1] != self.ndev:
                raise ValueError(
                    f"grid={self.grid} does not factor ndev={self.ndev} "
                    f"(need p*q == ndev)")
        if self.lookahead is not None:
            if (isinstance(self.lookahead, bool)
                    or not isinstance(self.lookahead, int)
                    or self.lookahead < 0):
                raise ValueError(f"lookahead must be an int >= 0 (or None), "
                                 f"got {self.lookahead!r}")
            if self.lookahead > 0 and self.ndev < 2:
                raise ValueError(
                    f"lookahead={self.lookahead} pipelines panels across "
                    f"devices and needs ndev > 1 (got ndev={self.ndev}); "
                    f"the single-device analogue is policy='async'/'v4'")
        if (len(self.block) != 2
                or any(not isinstance(x, int) or x < 1 for x in self.block)):
            raise ValueError(f"block must be two positive ints, "
                             f"got {self.block!r}")
        if self.policy not in ("v4", "auto") and self.block != _DEFAULT_BLOCK:
            raise ValueError(
                f"block={self.block} is only meaningful for policy='v4' "
                f"(got policy={self.policy!r})")
        if self.ndev > 1 and self.policy not in _MULTIDEV_POLICIES \
                and self.policy != "auto":
            raise ValueError(
                f"multi-device schedules support sync/v1/v2/v3, "
                f"got {self.policy!r}")
        if self.host_slots < 0:
            raise ValueError(f"host_slots must be >= 0 (0 = host-resident "
                             f"store, no spill tier), got {self.host_slots}")
        if self.host_slots > 0:
            if (self.lookahead or 0) > 0:
                raise ValueError(
                    "host_slots > 0 (disk spill tier) is incompatible with "
                    "lookahead > 0: the spill post-pass inserts ops into "
                    "each stream, which would invalidate the pipelined "
                    "emitter's dispatch-chunk indices")
            if self.ndev > 1 and self.backend != "numpy":
                raise ValueError(
                    "host_slots > 0 with ndev > 1 runs on the NumPy replay "
                    "(the multi-device executor keeps full row slabs); "
                    "pass backend='numpy'")
        if self.compute_dtype is not None \
                and self.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES} "
                             f"(or None for float64), got "
                             f"{self.compute_dtype!r}")
        if self.cache_slots > 0 and self.policy != "auto":
            floor = min_cache_slots(self.policy, self.block,
                                    self.lookahead or 0)
            if self.cache_slots < floor:
                raise ValueError(
                    f"policy {self.policy!r}"
                    + (f" with block={self.block}" if self.policy == "v4"
                       else "")
                    + (f" at lookahead={self.lookahead}"
                       if self.lookahead else "")
                    + f" needs >= {floor} cache slots"
                    + (" (h*w + w + 2)" if self.policy == "v4" else
                       " (each lookahead depth pins one extra slot)"
                       if self.lookahead else "")
                    + f", got {self.cache_slots}")
        if self.hw is not None:
            from .analytics import HW
            if self.hw not in HW:
                raise ValueError(f"unknown hw preset {self.hw!r}; "
                                 f"expected one of {tuple(HW)}")
            mem = HW[self.hw].mem_bytes
            if mem > 0 and self.tb > 0 and self.cache_slots > 0:
                # 8-byte device tiles, as the reference counts them
                need = self.cache_slots * self.tb * self.tb * 8
                if need > mem:
                    raise ValueError(
                        f"cache_slots={self.cache_slots} of "
                        f"{self.tb}x{self.tb} f64 tiles needs "
                        f"{need / 1e9:.1f} GB, but hw={self.hw!r} has "
                        f"mem_bytes={mem / 1e9:.1f} GB")
        for name, on in (("use_pallas", self.use_pallas),
                         ("fuse_columns", self.fuse_columns),
                         ("compute_dtype", self.compute_dtype is not None)):
            if on and self.resolved_backend() != "torch":
                raise ValueError(
                    f"{name} requires the 'torch' backend, got "
                    f"backend={self.backend!r} (resolved "
                    f"{self.resolved_backend()!r})")

    @property
    def needs_tuning(self) -> bool:
        """True when an open dimension (``tb=0`` / ``policy="auto"``)
        must be resolved by :func:`repro_torch.tune.resolve_config` before
        a schedule can be built."""
        return self.tb == 0 or self.policy == "auto"

    def resolved_backend(self) -> str:
        """Backend ``'auto'`` runs on: ``'torch'``.  The NumPy replays run
        only when ``backend='numpy'`` asks for them."""
        return "torch" if self.backend == "auto" else self.backend

    @property
    def resolved_compute_dtype(self) -> torch.dtype:
        return self.compute_dtype or torch.float64

    def specialize(self, a) -> "CholeskyConfig":
        """Freeze the matrix-dependent precision plan into the config.

        ``a`` is a numpy array or a tensor on any device; a tensor's tile
        norms are taken on its device.  A config that is already static is
        returned as-is."""
        if self.eps_target is None:
            return self
        if self.tb == 0:
            raise ValueError(
                "specialize() tiles the matrix with tb, which is still "
                "open (tb=0): resolve the config first — e.g. "
                "repro_torch.tune.tune(n, config, sample=a, eps_target=...) "
                "searches tb and the precision plan together")
        from .cholesky import plan_for_matrix
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a, dtype=np.float64)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected a square matrix, got {tuple(a.shape)}")
        if isinstance(a, torch.Tensor):
            pplan = plan_for_matrix(a, self.eps_target, self.ladder,
                                    tb=self.tb)
        else:
            pplan = plan_for_matrix(to_tiles(a, self.tb), self.eps_target,
                                    self.ladder)
        return dataclasses.replace(self, eps_target=None, plan=pplan)


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")


def _resolve_device(device, backend: str) -> torch.device:
    if backend == "numpy":
        device = torch.device("cpu" if device is None else device)
        if device.type != "cpu":
            raise ValueError(f"backend='numpy' replays on the host and "
                             f"solves on the CPU, got device {device}")
        return device
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        _need_cuda()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def logical_devices(device, ndev: int) -> tuple:
    """The ``ndev`` logical devices of a multi-device executor.

    ``"cuda"`` (or None): the first ``ndev`` visible cards, RuntimeError
    when fewer are visible.  ``"cpu"``: ``ndev`` CPU handles.  A sequence
    of ``ndev`` devices names each one; a card may repeat, and its logical
    devices then share it, each on a stream of its own."""
    if device is None or isinstance(device, (str, torch.device)):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cpu":
            return (device,) * ndev
        if device.type != "cuda" or device.index is not None:
            raise ValueError(
                f"ndev={ndev} takes 'cuda' (the first {ndev} cards), 'cpu' "
                f"or a sequence of {ndev} devices, got {device}")
        _need_cuda()
        visible = torch.cuda.device_count()
        if visible < ndev:
            raise RuntimeError(
                f"ndev={ndev} needs {ndev} CUDA devices, found {visible}; "
                f"pass a sequence of {ndev} devices to run several logical "
                f"devices on one card")
        return tuple(torch.device("cuda", i) for i in range(ndev))
    devs = tuple(torch.device(d) for d in device)
    if len(devs) != ndev:
        raise ValueError(f"ndev={ndev} needs {ndev} devices, got "
                         f"{len(devs)}")
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return devs
    if kinds != {"cuda"}:
        raise ValueError(f"the logical devices must all be CUDA or all CPU, "
                         f"got {devs}")
    _need_cuda()
    return tuple(torch.device("cuda", torch.cuda.current_device()
                              if d.index is None else d.index) for d in devs)


class OOCSolver:
    """Solver over one compiled ``(n, config)`` plan.

    ``factor(a)`` fills this solver's host tile store and replays the
    plan's schedule (across the logical devices with ``ndev > 1``, whose
    slabs are rows of that store); ``solve``/``solve_lower``/``logdet``
    run blocked substitution against that store on the solver's (first)
    device;
    ``simulate(hw)``/``volume()`` expose the plan's analytics.  Each
    ``compile()`` returns a fresh solver: the executor is shared through
    the plan, the factored store is not."""

    def __init__(self, plan: "CholeskyPlan", executor: "_CompiledExecutor",
                 default_trace=None):
        self._plan = plan
        self._executor = executor
        self._default_trace = default_trace   # from compile(trace=...)
        self._tiles = None          # host tile store (compute dtype)
        self._factored = False      # the store holds a finished factor
        self._last_io = None        # executed transfers of the last factor
        self._last_wires = None     # executed BCAST/RECV of the last factor
        self._last_disk = None      # executed FETCH/SPILL of the last factor
        self._factor_calls = 0
        self._solve_calls = 0

    @property
    def config(self) -> CholeskyConfig:
        return self._plan.config

    @property
    def n(self) -> int:
        return self._plan.n

    @property
    def device(self) -> torch.device:
        """The device of the solves: the first logical device."""
        return self._executor.device

    @property
    def devices(self) -> tuple:
        """Every logical device the factor runs on (one without ``ndev``)."""
        return self._executor.devices

    @property
    def schedule(self) -> MultiDeviceSchedule:
        return self._plan.schedule

    @property
    def tiles(self) -> torch.Tensor:
        """The factored ``[nt, nt, tb, tb]`` host store (lower tiles hold
        L; strictly upper tiles hold the input)."""
        return self._factored_tiles()

    @property
    def stats(self) -> dict:
        """``executor_builds`` is plan-wide; ``factor_calls``/
        ``solve_calls`` count this solver's own use.  ``transfers`` holds
        the schedule's class-precision LOAD/STORE volumes and, after a
        ``factor()``, the executed copies, which carry compute-dtype
        bytes, and with ``ndev > 1`` the executed BCAST/RECV counters
        (:meth:`transfer_stats`), the H2D of wires cut from a slab
        (``wire_h2d``) and the D2H of host-landing RECVs (``recv_d2h``).
        A spill plan adds the schedule's FETCH/SPILL volumes
        (``scheduled_fetch_bytes``/``scheduled_spill_bytes``) and, after a
        ``factor()``, the executed FETCH/SPILL counters under the
        reference's keys (``fetch_ops``, ``fetched_bytes``, ...)."""
        sched = self._plan.schedule
        transfers = {
            "loads": sched.count(OpKind.LOAD),
            "stores": sched.count(OpKind.STORE),
            "h2d_bytes": sched.loads_bytes(),
            "d2h_bytes": sched.stores_bytes(),
        }
        if self.config.ndev > 1:
            transfers["bcast_bytes"] = sched.bcast_bytes()
        for done in (self._last_io, self._last_wires):
            if done is not None:
                transfers.update({"executed_" + k: v
                                  for k, v in done.items()})
        if sched.host_slots:
            transfers["scheduled_fetch_bytes"] = sched.fetch_bytes()
            transfers["scheduled_spill_bytes"] = sched.spill_bytes()
            if self._last_disk is not None:
                transfers.update(self._last_disk)
        return {"executor_builds": self._plan.executor_builds,
                "factor_calls": self._factor_calls,
                "solve_calls": self._solve_calls,
                "transfers": transfers}

    def simulate(self, hw, link_bw=None, record_timeline: bool = False):
        return self._plan.simulate(hw, link_bw=link_bw,
                                   record_timeline=record_timeline)

    def volume(self) -> dict:
        return self._plan.volume()

    def _store(self) -> torch.Tensor:
        if self._tiles is None:
            nt, tb = self.schedule.nt, self.config.tb
            self._tiles = torch.empty(
                (nt, nt, tb, tb), dtype=self._executor.dtype,
                pin_memory=self.device.type == "cuda")
        return self._tiles

    def factor(self, a, materialize: bool = True,
               trace=None) -> np.ndarray | None:
        """Factor SPD ``a`` (numpy, or a tensor on any device) through the
        cached schedule; returns tril L as a numpy f64 array, or None with
        ``materialize=False`` (the factor then stays in the tile store for
        ``solve``/``solve_lower``/``logdet``).  Each call overwrites this
        solver's previous factor.

        ``trace``: an *active* :class:`repro_torch.obs.TraceRecorder`
        switches every backend to its measured path, op by op with a fence
        per op, recording exactly one span per schedule op (analyze with
        :func:`repro_torch.obs.drift_report`).  ``None`` (or the inactive
        :data:`repro_torch.obs.NULL`) runs the ordinary path unchanged.  A
        default recorder can be pinned at :meth:`CholeskyPlan.compile`.
        A traced factor on the torch backend is unfused, as the
        reference's, and bitwise the untraced unfused one."""
        if trace is None:
            trace = self._default_trace
        active = trace is not None and getattr(trace, "active", False)
        if active:
            cfg = self.config
            trace.meta.update({
                "n": self.n, "tb": cfg.tb, "nt": self.schedule.nt,
                "ndev": cfg.ndev, "policy": self.schedule.policy,
                "lookahead": cfg.lookahead or 0,
                "host_slots": cfg.host_slots,
                "grid": list(self.schedule.grid),
                "backend": cfg.resolved_backend(),
            })
        else:
            trace = None
        if self._executor.replay is not None:
            self._factor_numpy(a, trace)
        elif self._executor.spill is not None:
            self._factor_spill(a, trace)
        else:
            self._factor_torch(a, trace)
        self._factored = True
        self._factor_calls += 1
        reg = _obs_registry()
        sched = self._plan.schedule
        reg.inc("repro.factor.calls")
        reg.inc("repro.factor.h2d_bytes", sched.loads_bytes())
        reg.inc("repro.factor.d2h_bytes", sched.stores_bytes())
        if sched.host_slots:
            reg.inc("repro.factor.fetch_bytes", sched.fetch_bytes())
            reg.inc("repro.factor.spill_bytes", sched.spill_bytes())
        reg.set_gauge("repro.factor.executor_builds",
                      self._plan.executor_builds)
        if not materialize:
            return None
        return np.tril(from_tiles(self._tiles.to(torch.float64).numpy()))

    def _check_shape(self, a) -> None:
        if tuple(a.shape) != (self.n, self.n):
            raise ValueError(
                f"matrix shape {tuple(a.shape)} does not match the plan's "
                f"n={self.n}; build a new plan for a different size")

    def _factor_torch(self, a, trace) -> None:
        """The in-core torch executors: the host store filled from ``a``
        one tile row at a time, factored in place."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a, dtype=np.float64))
        self._check_shape(a)
        tb = self.config.tb
        nt = self.n // tb
        host = self._store()
        self._factored = False
        for i in range(nt):      # one tile row at a time: bounded temporaries
            rows = a[i * tb:(i + 1) * tb].to(host.dtype)
            host[i].copy_(rows.reshape(tb, nt, tb)
                          .permute(1, 0, 2))
        ex = self._executor
        if ex.multidevice is not None:
            self._last_io = ex.multidevice(host, trace=trace)
            self._last_wires = dict(ex.multidevice.last_transfer_stats)
            return
        if trace is not None:
            from .cholesky import run_traced_torch
            self._last_io = run_traced_torch(
                self._plan.single_schedule(), host, trace, ex.dtype,
                use_pallas=self.config.use_pallas, device=self.device)
            return
        self._last_io = ex.run(host)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _host_tiles(self, a) -> np.ndarray:
        """``a`` as an f64 numpy tile array (the replays' and the disk
        tier's input)."""
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.asarray(a, dtype=np.float64)
        self._check_shape(a)
        return to_tiles(a, self.config.tb)

    def _factor_spill(self, a, trace) -> None:
        """The torch backend's disk tier: :class:`SpillTorchExecutor` over
        an in-memory store with the disk store's interface; the factor
        lands in an f64 CPU tile store."""
        from .spill import ArrayTileStore
        store = ArrayTileStore(self._host_tiles(a))
        self._factored = False
        spill = self._executor.spill
        self._last_io = spill.run_store(store, trace=trace)
        self._last_disk = dict(spill.last_io_stats)
        self._tiles = torch.from_numpy(store.to_tiles())

    def _factor_numpy(self, a, trace) -> None:
        """The NumPy replays of ``backend='numpy'``: the factor lands in an
        f64 CPU tile store.  A spill plan replays through a bounded host
        tier over an in-memory store with the disk store's interface."""
        from .cholesky import (run_multidevice_spill, run_schedule_spill)
        from .spill import ArrayTileStore
        tiles = self._host_tiles(a)
        self._factored = False
        if self._plan.schedule.host_slots > 0:
            store = ArrayTileStore(tiles)
            if self.config.ndev > 1:
                hosts = run_multidevice_spill(store, self._plan.schedule,
                                              trace=trace)
            else:
                hosts = [run_schedule_spill(
                    store, self._plan.single_schedule(), trace=trace)]
            self._last_disk = {
                k: sum(getattr(h, k) for h in hosts)
                for k in ("fetch_ops", "spill_ops", "fetched_bytes",
                          "spilled_bytes")}
            out = store.to_tiles()
        else:
            out = self._executor.replay(tiles, trace)
        self._tiles = torch.from_numpy(out)

    def _factored_tiles(self) -> torch.Tensor:
        if not self._factored:
            raise RuntimeError("no factor available: call factor(a) before "
                               "solve()/solve_lower()/logdet()")
        return self._tiles

    def _check_rhs(self, b) -> np.ndarray:
        if isinstance(b, torch.Tensor):
            b = b.detach().cpu().numpy()
        b = np.asarray(b)
        if b.dtype.kind not in "fiub":
            raise TypeError(
                f"rhs dtype {b.dtype} is not real-valued; the tiled "
                f"substitution runs in float64")
        if b.ndim not in (1, 2):
            raise ValueError(
                f"rhs must be a vector (n,) or stacked columns (n, k), "
                f"got shape {b.shape}")
        if b.shape[0] != self.n:
            raise ValueError(
                f"rhs has {b.shape[0]} rows but this solver's plan is "
                f"n={self.n}; build a plan for the rhs size or reshape")
        if b.ndim == 2 and b.shape[1] == 0:
            raise ValueError("rhs has 0 columns; nothing to solve")
        return np.asarray(b, dtype=np.float64)

    def solve(self, b) -> np.ndarray:
        """Solve ``A x = b`` (``b`` is ``(n,)`` or ``(n, k)``) with the
        last factored ``A = L L^T``; f64 on the solver's device."""
        from .solve import cho_solve_tiles
        x = cho_solve_tiles(self._factored_tiles(), self._check_rhs(b),
                            self.device)
        self._solve_calls += 1
        _obs_registry().inc("repro.solve.calls")
        return x.cpu().numpy()

    def solve_lower(self, b) -> np.ndarray:
        """Forward substitution ``L z = b`` against the current factor."""
        from .solve import solve_lower_tiles
        z = solve_lower_tiles(self._factored_tiles(), self._check_rhs(b),
                              self.device)
        self._solve_calls += 1
        _obs_registry().inc("repro.solve.calls")
        return z.cpu().numpy()

    def logdet(self) -> float:
        """``log|A|`` of the last factored matrix, from the tile store."""
        from .solve import logdet_tiles
        return logdet_tiles(self._factored_tiles())

    def transfer_stats(self) -> Optional[dict]:
        """Executed BCAST/RECV op and byte counters of this solver's last
        ``factor()`` on the multi-device executor (None on one device, on
        the numpy backend and before a factor); cross-check against the
        schedule with :func:`repro_torch.core.analytics.
        crosscheck_executed_volume`."""
        return None if self._last_wires is None else dict(self._last_wires)


class _CompiledExecutor:
    """The per-plan executor for one device (or ``ndev`` logical devices)
    and compute dtype, shared by every solver of the plan.  Holds no
    factored data.  On the numpy backend it builds nothing: ``replay`` runs
    the plan's NumPy replay (the solver runs a spill plan's replay itself,
    for its counters).  On the torch backend it holds one of ``run`` (the
    single-device executor), ``multidevice`` or ``spill``
    (:class:`~repro_torch.core.cholesky.SpillTorchExecutor`, one device
    with ``host_slots > 0``)."""

    def __init__(self, plan: "CholeskyPlan", devices: tuple):
        from .cholesky import (SpillTorchExecutor,
                               make_multidevice_torch_executor,
                               make_torch_executor, run_multidevice_numpy,
                               run_schedule_numpy)
        cfg = plan.config
        self.devices = devices
        self.device = devices[0]
        self.dtype = cfg.resolved_compute_dtype
        self.run = self.replay = self.multidevice = self.spill = None
        if cfg.resolved_backend() == "numpy":
            if cfg.ndev > 1:
                self.replay = lambda tiles, trace=None: run_multidevice_numpy(
                    tiles, plan.schedule, trace=trace)
            else:
                self.replay = lambda tiles, trace=None: run_schedule_numpy(
                    tiles, plan.single_schedule(), trace=trace)
            return
        if cfg.ndev > 1:
            self.multidevice = self.run = make_multidevice_torch_executor(
                plan.schedule, self.dtype, use_pallas=cfg.use_pallas,
                devices=devices, fuse_columns=cfg.fuse_columns)
        elif cfg.host_slots > 0:
            self.spill = SpillTorchExecutor(
                plan.single_schedule(), self.dtype,
                use_pallas=cfg.use_pallas, device=self.device,
                fuse_columns=cfg.fuse_columns)
        else:
            self.run = make_torch_executor(plan.single_schedule(), self.dtype,
                                           use_pallas=cfg.use_pallas,
                                           device=self.device,
                                           fuse_columns=cfg.fuse_columns)
        plan.executor_builds += 1


@dataclasses.dataclass
class CholeskyPlan:
    """Cached static schedule for one ``(n, config)``; ``compile()`` hands
    out per-call-site solvers over one shared executor per device."""

    n: int
    config: CholeskyConfig
    schedule: MultiDeviceSchedule
    _single: Any = None
    _executor: Optional[_CompiledExecutor] = None
    executor_builds: int = 0
    _compile_lock: Any = dataclasses.field(default_factory=threading.Lock,
                                           repr=False, compare=False)
    _device_slots: Optional[int] = dataclasses.field(default=None,
                                                     repr=False, compare=False)

    def single_schedule(self):
        """The flat single-device Schedule backing the ndev=1 degenerate."""
        if self._single is None:
            self._single = self.schedule.to_single()
        return self._single

    def device_slots(self) -> int:
        """Worst per-device slot count the schedule pins (cache table +
        panel region), read off the streams once: a read walks every op
        (93,462 at n = 32768, tb 512), and the serve tier's admission asks
        at every submit and dispatch."""
        if self._device_slots is None:
            self._device_slots = max(self.schedule.stream_nslots(d)
                                     for d in range(self.schedule.ndev))
        return self._device_slots

    def compile(self, device=None, trace=None) -> OOCSolver:
        """A fresh solver over this plan's executor on ``device``
        (``"cuda"`` unless the caller asks for ``"cpu"``; raises when CUDA
        is asked for and absent).  With ``ndev > 1`` on the torch backend
        ``device`` is one device or a sequence of ``ndev``
        (:func:`logical_devices`).  The executor is built on first call and
        rebuilt only when the devices change.  The numpy backend needs no
        card: its solver runs on the CPU.

        ``trace``: a :class:`repro_torch.obs.TraceRecorder` pinned as the
        solver's default: every ``factor()`` without an explicit
        ``trace=`` records into it (a per-call ``trace=`` overrides)."""
        backend = self.config.resolved_backend()
        if self.config.ndev > 1 and backend == "torch":
            devices = logical_devices(device, self.config.ndev)
        else:
            devices = (_resolve_device(device, backend),)
        with self._compile_lock:
            if self._executor is None or self._executor.devices != devices:
                self._executor = _CompiledExecutor(self, devices)
            return OOCSolver(self, self._executor, default_trace=trace)

    def simulate(self, hw, link_bw=None, record_timeline: bool = False):
        """Three-engine event model of the schedule on the hardware model
        ``hw`` (per device and a shared link for ndev > 1): a model
        reading, not a measurement."""
        from . import analytics
        if self.config.ndev > 1:
            return analytics.simulate_multi(self.schedule, hw,
                                            link_bw=link_bw,
                                            record_timeline=record_timeline)
        return analytics.simulate(self.single_schedule(), hw,
                                  record_timeline=record_timeline)

    def volume(self) -> dict:
        """Exact byte-volume report of the static schedule (Fig. 8/12)."""
        from . import analytics
        if self.config.ndev > 1:
            return analytics.volume_report_multi(self.schedule)
        return analytics.volume_report(self.single_schedule())


_PLAN_CACHE: "collections.OrderedDict[tuple, CholeskyPlan]" = \
    collections.OrderedDict()
_PLAN_CACHE_MAX = 32
_PLAN_CACHE_LOCK = threading.RLock()
_PLAN_CACHE_HITS = 0
_PLAN_CACHE_MISSES = 0
_SCHEDULE_BUILDS = 0     # module-wide build counter (amortization tests)


def schedule_build_count() -> int:
    return _SCHEDULE_BUILDS


def plan_cache_stats() -> dict:
    """Hit/miss/occupancy counters of the process-wide plan cache."""
    with _PLAN_CACHE_LOCK:
        return {"hits": _PLAN_CACHE_HITS, "misses": _PLAN_CACHE_MISSES,
                "size": len(_PLAN_CACHE), "max": _PLAN_CACHE_MAX}


def clear_plan_cache() -> None:
    with _PLAN_CACHE_LOCK:
        _PLAN_CACHE.clear()


def plan(n: int, config: CholeskyConfig | None = None,
         **overrides) -> CholeskyPlan:
    """Build (or fetch) the static plan for an ``n x n`` factorization.

    ``plan(n, config)`` or ``plan(n, tb=..., ...)``.  Plans are cached by
    ``(n, config)`` value: equal configs return the *same* plan object.
    Configs with open dimensions (``tb=0``, ``policy="auto"``) are resolved
    through the autotuner first (:func:`repro_torch.tune.resolve_config`).
    ``eps_target`` configs must be frozen with
    :meth:`CholeskyConfig.specialize` first.
    """
    global _SCHEDULE_BUILDS, _PLAN_CACHE_HITS, _PLAN_CACHE_MISSES
    if config is None:
        config = CholeskyConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    if config.eps_target is not None:
        raise ValueError(
            "eps_target makes the precision plan matrix-dependent, so it "
            "cannot be planned ahead of the data: freeze it with "
            "config.specialize(a) (or pass plan=plan_for_matrix(...))")
    # the lock spans lookup *and* build: concurrent misses on one key
    # collapse to a single schedule construction
    with _PLAN_CACHE_LOCK:
        auto_key = None
        if config.needs_tuning:
            # open dimensions: resolve through the autotuner, memoized in
            # the tuning db; the plan is cached under the auto key too,
            # which carries the resolving model's identity, so installing
            # another default hardware model re-resolves
            from ..tune import resolution_token, resolve_config
            auto_key = (n, config, resolution_token(config))
            cached = _PLAN_CACHE.get(auto_key)
            if cached is not None:
                _PLAN_CACHE.move_to_end(auto_key)
                _PLAN_CACHE_HITS += 1
                return cached
            config = resolve_config(n, config)
        if config.grid == (config.ndev, 1):
            # the reference's canonical forms: both build the default
            # schedule
            config = dataclasses.replace(config, grid=None)
        if config.lookahead == 0:
            config = dataclasses.replace(config, lookahead=None)
        layout = TileLayout(n, config.tb)   # validates n % tb == 0
        key = (n, config)
        cached = _PLAN_CACHE.get(key)
        if cached is not None:
            _PLAN_CACHE.move_to_end(key)
            _PLAN_CACHE_HITS += 1
            if auto_key is not None:
                _PLAN_CACHE[auto_key] = cached
            return cached
        _SCHEDULE_BUILDS += 1
        _PLAN_CACHE_MISSES += 1
        pplan = config.plan or uniform_plan(layout.nt, "f64", config.ladder)
        if config.ndev > 1:
            msched = build_multidevice_schedule(
                layout.nt, config.tb, config.ndev, config.policy,
                config.cache_slots, pplan, grid=config.grid,
                lookahead=config.lookahead or 0,
                host_slots=config.host_slots)
            single = None
        else:
            single = build_schedule(layout.nt, config.tb, config.policy,
                                    config.cache_slots, pplan,
                                    block=config.block,
                                    host_slots=config.host_slots)
            msched = MultiDeviceSchedule.from_single(single)
        p = CholeskyPlan(n=n, config=config, schedule=msched, _single=single)
        _PLAN_CACHE[key] = p
        if auto_key is not None:
            _PLAN_CACHE[auto_key] = p
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
        return p
