"""Candidate search: enumerate feasible configs, score by exact simulation
(port of ``repro/tune/search.py``).

Because the schedule is static, every candidate ``(tb, policy,
cache_slots, precision plan, ndev)`` has an *exact* deterministic cost
under a hardware model — :func:`repro_torch.core.analytics.simulate` /
:func:`simulate_multi` replay the op stream event by event.  The search
is therefore a plain enumerate-build-simulate loop; no noisy on-device
trials, no search heuristics, and the same code path scores datasheet
presets (CPU CI) and calibrated measured models.

Feasibility is enforced *before* scoring, mirroring exactly what the
builders/executors would reject later:

  * ``tb | n`` (the tile grid must cover the matrix);
  * per-policy slot minimums
    (:func:`repro_torch.core.schedule.min_cache_slots`);
  * the OOC device-memory cap: ``(cache_slots + panel slots) * tb^2 * 8
    <= hw.mem_bytes`` — at large ``n`` this is the constraint that rules
    out cache-everything configs and forces real policy selection;
  * the port's own: the tile sizes the hand-written kernels can run
    (:func:`route_allows`).  A config that routes to them on the card —
    the torch backend with ``use_pallas`` and a compute dtype below f64
    (TRSM up to ``trsm.MAX_N``, POTRF up to ``potrf.MAX_N``; f64 tiles take
    the stock ops) or ``fuse_columns`` (the fused step at multiples
    of 64 up to ``fused_column.MAX_TB``) — is offered no other tile size.
    The Pallas kernels have no such limits, so where one binds the
    candidate table is the reference's without those tile sizes; elsewhere
    it equals the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.analytics import HW, HardwareModel, simulate, simulate_multi
from ..core.api import _DEFAULT_BLOCK, CholeskyConfig
from ..core.precision import PrecisionPlan, uniform_plan
from ..core.schedule import (build_multidevice_schedule, build_schedule,
                             default_cache_slots, min_cache_slots)
from ..core.tiling import TileLayout
from ..kernels import fused_column, potrf, trsm

# lookahead depths worth scoring (ndev > 1): 0 is today's column loop,
# deeper pipelines trade panel slots for overlap; past 2 the emitter's
# extra in-flight panels stop changing the simulated makespan on every
# preset we model (the panel critical path is already hidden)
_LOOKAHEADS = (0, 1, 2)

# search-space bounds: nt below 2 is in-core (no schedule to tune), nt
# above NT_MAX makes candidate *scoring* itself the bottleneck (schedule
# construction is O(nt^3) ops) without changing the ranking — past ~48
# tiles per side the per-op overheads are amortized and bigger grids only
# move more bytes.
NT_MIN = 2
NT_MAX = 48
TB_MIN = 8

_SINGLE_POLICIES = ("sync", "async", "v1", "v2", "v3", "v4")
_MULTI_POLICIES = ("sync", "v1", "v2", "v3")
_POLICY_RANK = {p: i for i, p in enumerate(_SINGLE_POLICIES)}


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One scored point of the search space."""
    config: CholeskyConfig
    makespan: float
    tflops: float
    loads_bytes: int
    stores_bytes: int
    link_bytes: int = 0          # interconnect volume (ndev > 1)
    footprint_bytes: int = 0     # device slot-buffer bytes the config needs
    fetch_bytes: int = 0         # disk lane volume (host_slots > 0)
    spill_bytes: int = 0

    def row(self) -> dict:
        """Flat machine-readable record (bench JSON / TuneResult table)."""
        c = self.config
        return {
            "tb": c.tb, "policy": c.policy, "cache_slots": c.cache_slots,
            "ndev": c.ndev,
            "grid": list(c.grid) if c.grid else [c.ndev, 1],
            "lookahead": c.lookahead or 0,
            "host_slots": c.host_slots,
            "makespan_s": self.makespan,
            "tflops": self.tflops, "loads_bytes": self.loads_bytes,
            "stores_bytes": self.stores_bytes,
            "link_bytes": self.link_bytes,
            "footprint_bytes": self.footprint_bytes,
            "fetch_bytes": self.fetch_bytes,
            "spill_bytes": self.spill_bytes,
        }


@dataclasses.dataclass
class TuneResult:
    """Ranked outcome of one search: ``config`` is the winner, ``table``
    the full predicted makespan/volume comparison."""
    n: int
    ndev: int
    hw: HardwareModel
    candidates: list        # Candidate, ranked best-first
    eps_target: Optional[float] = None

    @property
    def config(self) -> CholeskyConfig:
        return self.candidates[0].config

    @property
    def best(self) -> Candidate:
        return self.candidates[0]

    def table(self) -> list[dict]:
        return [c.row() for c in self.candidates]


def fused_step_takes(tb: int) -> bool:
    """Whether the fused column-step kernel takes tiles of edge ``tb``."""
    return tb % fused_column.NB == 0 and tb <= fused_column.MAX_TB


def route_allows(config: CholeskyConfig, tb: int) -> bool:
    """Whether the hand-written kernels ``config`` routes its tiles to on
    the card can run tiles of edge ``tb`` (always, off the torch backend
    and on the stock route).  The per-op limits bind only below f64: f64
    tiles take the stock ops (``kernels.ops``) even with ``use_pallas``;
    the fused step runs f32 and f64 alike."""
    if config.resolved_backend() != "torch":
        return True
    if (config.use_pallas
            and config.resolved_compute_dtype != torch.float64
            and tb > min(trsm.MAX_N, potrf.MAX_N)):
        return False
    return not config.fuse_columns or fused_step_takes(tb)


def feasible_tbs(n: int, hw: HardwareModel, ndev: int = 1,
                 policies=_SINGLE_POLICIES,
                 config: CholeskyConfig | None = None) -> list[int]:
    """Tile sizes whose grid covers ``n`` and whose *minimum* working set
    fits the device (largest tb first: fewer, bigger tiles are the cheap
    end of the search); with ``config``, only those its kernel route can
    run (:func:`route_allows`)."""
    out = []
    for nt in range(max(NT_MIN, ndev), NT_MAX + 1):
        if n % nt:
            continue
        tb = n // nt
        if tb < TB_MIN:
            break
        if config is not None and not route_allows(config, tb):
            continue
        reserve = TileLayout(n, tb).panel_slots(0) if ndev > 1 else 0
        least = min(min_cache_slots(p) for p in policies)
        if hw.max_cache_slots(tb, reserve) >= least:
            out.append(tb)
    return out


def slot_candidates(policy: str, nt: int, tb: int, hw: HardwareModel,
                    ndev: int = 1, block: tuple = (4, 4),
                    lookahead: int = 0) -> list[int]:
    """Feasible cache-slot budgets worth scoring for one (policy, tb).

    Three probes bound the interesting range: the policy minimum (the
    thrash-iest feasible point), the builder default, and the
    memory-capped maximum (cache as much as the device holds).  Slot
    counts only change the op stream for the cache-table policies; the
    fixed-slot policies get their single minimum.  ``lookahead`` lifts
    both the minimum (one extra pinned slot per depth) and the panel
    reserve (one extra ``nt``-slot bank per in-flight panel).
    """
    reserve = (TileLayout(nt * tb, tb).panel_slots(lookahead)
               if ndev > 1 else 0)
    cap = hw.max_cache_slots(tb, reserve)
    mn = min_cache_slots(policy, block, lookahead)
    if cap < mn:
        return []
    if policy in ("sync", "async", "v1"):
        return [mn]
    default = default_cache_slots(policy, nt, block, multidevice=ndev > 1,
                                  lookahead=lookahead)
    # nt*(nt+1)//2 + 1 slots hold every lower tile at once: beyond that,
    # extra slots cannot change a single cache decision
    useful_max = min(cap, nt * (nt + 1) // 2 + 1 + lookahead)
    return sorted({max(s, mn) for s in (mn, min(default, cap), useful_max)})


def host_slot_candidates(nt: int, tb: int, hw: HardwareModel) -> list[int]:
    """Host-slab budgets worth scoring for one tile grid.

    ``[0]`` (host-resident store, no spill tier) whenever the full
    ``[nt, nt]`` tile store fits ``host_mem_bytes`` (or the capacity is
    unknown); once it overflows, spilling is mandatory and two probes
    bound the interesting range: a lean column working set (``nt + 2``
    slabs — the panel streams through, updates thrash) and the
    memory-capped maximum (as host-resident as the machine allows).
    Empty when not even one slab fits — no feasible config at this tb.
    """
    store_bytes = 8 * (nt * tb) ** 2
    if hw.host_mem_bytes <= 0 or store_bytes <= hw.host_mem_bytes:
        return [0]
    cap = hw.max_host_slots(tb)
    if cap < 1:
        return []
    # nt*(nt+1)//2 slabs hold every lower tile: past that, extra slabs
    # cannot remove a single FETCH
    return sorted({min(nt + 2, cap), min(cap, nt * (nt + 1) // 2)})


def is_feasible(n: int, config: CholeskyConfig, hw: HardwareModel) -> bool:
    """The exact predicate the search promises of every returned config."""
    if config.tb < 1 or n % config.tb or not route_allows(config, config.tb):
        return False
    nt = n // config.tb
    la = config.lookahead or 0
    if la >= nt:
        return False
    if config.cache_slots < min_cache_slots(config.policy, config.block, la):
        return False
    if config.host_slots > 0:
        # eager config validation already rejects host_slots with
        # lookahead; here only the host-memory cap can fail
        if config.host_slots > hw.max_host_slots(config.tb):
            return False
    elif hw.host_mem_bytes > 0 and 8 * n * n > hw.host_mem_bytes:
        # no spill tier and the full tile store overflows host memory
        return False
    reserve = (TileLayout(n, config.tb).panel_slots(la)
               if config.ndev > 1 else 0)
    return config.cache_slots <= hw.max_cache_slots(config.tb, reserve)


def _score(n, tb, policy, slots, pplan, ndev, hw, base: CholeskyConfig,
           grid=None, lookahead=0, host_slots=0):
    nt = n // tb
    if ndev > 1:
        msched = build_multidevice_schedule(nt, tb, ndev, policy, slots,
                                            pplan, grid=grid,
                                            lookahead=lookahead,
                                            host_slots=host_slots)
        r = simulate_multi(msched, hw)
        loads, stores = msched.loads_bytes(), msched.stores_bytes()
        link = r.link_bytes
        nslots = max(msched.stream_nslots(d) for d in range(ndev))
    else:
        sched = build_schedule(nt, tb, policy, slots, pplan,
                               block=base.block, host_slots=host_slots)
        r = simulate(sched, hw)
        loads, stores = sched.loads_bytes(), sched.stores_bytes()
        link = 0
        nslots = slots
    cfg = dataclasses.replace(
        base, tb=tb, policy=policy, cache_slots=slots, ndev=ndev,
        grid=grid if ndev > 1 else None,
        # the winner pins the searched depth (0 included) so a db
        # round-trip replays the same schedule; ndev=1 has no pipeline
        lookahead=lookahead if ndev > 1 else None,
        host_slots=host_slots,
        # a custom v4 block must not ride along into non-v4 candidates
        block=base.block if policy == "v4" else _DEFAULT_BLOCK,
        plan=pplan if pplan is not None and not _is_uniform_f64(pplan)
        else base.plan)
    return Candidate(config=cfg, makespan=r.makespan, tflops=r.tflops,
                     loads_bytes=loads, stores_bytes=stores,
                     link_bytes=link,
                     footprint_bytes=nslots * tb * tb * 8,
                     fetch_bytes=r.fetch_bytes, spill_bytes=r.spill_bytes)


def _is_uniform_f64(pplan: PrecisionPlan) -> bool:
    return bool((pplan.classes == 0).all())


def score_config(n: int, config: CholeskyConfig,
                 hw: HardwareModel) -> Candidate:
    """Exact simulated cost of one *pinned* config, as the builders would
    run it (``cache_slots=0`` resolves to the builder default) — no
    feasibility filtering.  This is the honest baseline for
    tuned-vs-default comparisons: a hand-picked config is scored exactly
    as written even where the tuner would have rejected it (e.g. a slot
    budget overflowing ``mem_bytes``)."""
    if config.tb < 1 or n % config.tb:
        raise ValueError(f"tb={config.tb} does not tile n={n}")
    nt = n // config.tb
    slots = config.cache_slots or default_cache_slots(
        config.policy, nt, config.block, multidevice=config.ndev > 1,
        lookahead=config.lookahead or 0)
    pplan = config.plan or uniform_plan(nt, "f64", config.ladder)
    return _score(n, config.tb, config.policy, slots, pplan, config.ndev,
                  hw, config, grid=config.grid,
                  lookahead=config.lookahead or 0,
                  host_slots=config.host_slots)


def search(n: int,
           hw: HardwareModel,
           config: CholeskyConfig | None = None,
           plans_by_tb: dict | None = None,
           eps_target: Optional[float] = None) -> TuneResult:
    """Enumerate + score every feasible candidate; return them ranked.

    ``config`` pins the non-searched dimensions and declares which are
    open: ``tb=0`` searches tile sizes, ``policy="auto"`` searches
    policies, ``cache_slots=0`` searches slot budgets, and (for
    ``ndev > 1``) ``grid=None`` searches every ``(p, q)`` factorization
    of ``ndev`` while ``lookahead=None`` searches pipeline depths
    ``{0, 1, 2}``; a concrete value freezes that axis.  The disk tier is
    its own axis: ``host_slots=0`` scores host-resident candidates
    unless the full tile store overflows ``hw.host_mem_bytes``, in which
    case spill budgets are probed (:func:`host_slot_candidates`); a
    pinned ``host_slots > 0`` is honoured exactly.  ``plans_by_tb``
    optionally maps tile size -> :class:`PrecisionPlan` (built from a
    representative matrix by :func:`repro.tune.tune`) to score
    mixed-precision candidates; absent entries score uniform f64.

    Deterministic by construction: candidates are scored by an exact
    event simulation and ranked by ``(makespan, fewer bytes, policy
    order, larger tb, fewer slots, shallower lookahead, grid)`` — equal
    inputs always return the identical ranking.
    """
    base = config if config is not None else CholeskyConfig(
        tb=0, policy="auto")
    if base.hw is not None and HW.get(base.hw) is not hw:
        # scored against a different model than the config names (e.g. a
        # calibrated one): drop the tag so the returned configs validate
        # against the model that actually ranked them
        base = dataclasses.replace(base, hw=None)
    ndev = base.ndev
    policy_space = _MULTI_POLICIES if ndev > 1 else _SINGLE_POLICIES
    policies = (policy_space if base.policy == "auto"
                else (base.policy,))
    for p in policies:
        if p not in policy_space:
            raise ValueError(f"policy {p!r} unsupported for ndev={ndev}")

    if base.tb > 0:
        if n % base.tb:
            raise ValueError(f"tb={base.tb} does not divide n={n}")
        tbs = [base.tb]
    else:
        if base.plan is not None:
            # an explicit per-tile plan fixes the grid to its nt
            if n % base.plan.nt:
                raise ValueError(
                    f"explicit precision plan has nt={base.plan.nt}, "
                    f"which does not tile n={n}")
            tbs = [n // base.plan.nt]
        else:
            tbs = feasible_tbs(n, hw, ndev, policies, config=base)
    if len(tbs) == 1 and not route_allows(base, tbs[0]):
        raise ValueError(
            f"tb={tbs[0]} exceeds the tile limits of the hand-written "
            f"kernels this config routes to (use_pallas below f64: tb "
            f"<= {min(trsm.MAX_N, potrf.MAX_N)}; fuse_columns: a multiple of "
            f"{fused_column.NB} up to {fused_column.MAX_TB})")
    if not tbs:
        raise ValueError(
            f"no feasible tile size for n={n} on {hw.name} "
            f"(mem_bytes={hw.mem_bytes:.3g}): every divisor in "
            f"nt=[{NT_MIN}, {NT_MAX}] either leaves tb < {TB_MIN}, "
            f"overflows device memory at the policy minimum slot count or "
            f"exceeds the tile limits of the kernels the config routes to")

    if ndev == 1:
        grids = [None]
    elif base.grid is not None:
        grids = [base.grid]
    else:
        # the grid dimension: every (p, q) factorization of ndev, the 1D
        # tile-row layout (ndev, 1) among them
        grids = [(d, ndev // d) for d in range(1, ndev + 1) if ndev % d == 0]

    if ndev == 1:
        lookaheads = [0]
    elif base.lookahead is not None:
        lookaheads = [base.lookahead]
    else:
        lookaheads = list(_LOOKAHEADS)

    candidates = []
    for tb in tbs:
        nt = n // tb
        if base.plan is not None and base.plan.nt == nt:
            pplan = base.plan
        elif plans_by_tb and tb in plans_by_tb:
            pplan = plans_by_tb[tb]
        else:
            pplan = uniform_plan(nt, "f64", base.ladder)
        if base.host_slots > 0:
            hs_opts = ([base.host_slots]
                       if base.host_slots <= hw.max_host_slots(tb) else [])
        else:
            # the spill tier engages only when the full tile store
            # overflows the model's host memory (otherwise [0])
            hs_opts = host_slot_candidates(nt, tb, hw)
        for policy in policies:
            for la in lookaheads:
                if la >= nt:
                    continue        # the builder rejects lookahead >= nt
                if base.cache_slots > 0:
                    # primitive feasibility probe: constructing a config
                    # here would re-run eager validation and *raise* on
                    # the very combinations this filter exists to skip
                    # (e.g. a pinned budget below v4's minimum while
                    # policy="auto")
                    blk = base.block if policy == "v4" else _DEFAULT_BLOCK
                    reserve = (TileLayout(n, tb).panel_slots(la)
                               if ndev > 1 else 0)
                    ok = (base.cache_slots
                          >= min_cache_slots(policy, blk, la)
                          and base.cache_slots
                          <= hw.max_cache_slots(tb, reserve))
                    slot_opts = [base.cache_slots] if ok else []
                else:
                    slot_opts = slot_candidates(policy, nt, tb, hw, ndev,
                                                base.block, lookahead=la)
                for hs in hs_opts:
                    if hs > 0 and la > 0:
                        continue    # spill post-pass excludes pipelining
                    for slots in slot_opts:
                        for grid in grids:
                            candidates.append(
                                _score(n, tb, policy, slots, pplan, ndev,
                                       hw, base, grid=grid, lookahead=la,
                                       host_slots=hs))
    if not candidates:
        raise ValueError(
            f"no feasible (policy, cache_slots) candidate for n={n} on "
            f"{hw.name}: the pinned dimensions of {base} violate the "
            f"slot minimums or the device-memory cap")
    candidates.sort(key=lambda c: (
        c.makespan,
        c.loads_bytes + c.stores_bytes + c.link_bytes
        + c.fetch_bytes + c.spill_bytes,
        _POLICY_RANK[c.config.policy],
        -c.config.tb,
        c.config.cache_slots,
        c.config.lookahead or 0,     # shallower pipeline on ties
        c.config.host_slots,         # leaner host tier on ties
        c.config.grid or (c.config.ndev, 1),
    ))
    return TuneResult(n=n, ndev=ndev, hw=hw, candidates=candidates,
                      eps_target=eps_target)
