"""`repro_torch.tune` orchestration: model selection -> db lookup -> search
(port of ``repro/tune/autotune.py``).

Two entry points:

* :func:`tune` — the user-facing campaign: pick (or calibrate) a hardware
  model, enumerate and score every feasible schedule, persist the winner,
  return the full ranked :class:`~repro_torch.tune.search.TuneResult`
  table.
* :func:`resolve_config` — the planner hook: ``repro_torch.plan(n, config)``
  calls this when the config has open dimensions (``tb=0`` /
  ``policy="auto"``) and needs a concrete one.  Simulation-only scoring
  against a preset model by default (never calibrates implicitly), so a
  CPU CI run is fast and bit-deterministic.

Hardware-model resolution order (first match wins):

  1. an explicit ``hw`` argument (a :class:`HardwareModel` or a preset
     name);
  2. the config's own ``hw`` preset tag;
  3. the process default set by :func:`set_default_hardware` — e.g. a
     calibrated model, after which every auto config in the process is
     tuned for the measured machine;
  4. the ``gh200`` datasheet preset (the paper's flagship platform).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

import torch

from ..core.analytics import HW, HardwareModel
from ..core.api import CholeskyConfig
from ..core.precision import assign_precision, tile_norms
from ..core.tiling import to_tiles

from .calibrate import calibrate
from .db import TuningDB, default_db_path
from .search import TuneResult, route_allows, search

DEFAULT_HW_PRESET = "gh200"

_default_hw: Optional[HardwareModel] = None
_process_db: Optional[TuningDB] = None


def set_default_hardware(hw: Union[HardwareModel, str, None]) -> None:
    """Install the model auto configs resolve against in this process
    (a calibrated :class:`HardwareModel`, a preset name, or None to
    restore the ``gh200`` preset default)."""
    global _default_hw
    _default_hw = HW[hw] if isinstance(hw, str) else hw


def _resolve_hw(hw: Union[HardwareModel, str, None],
                config: Optional[CholeskyConfig]) -> HardwareModel:
    if isinstance(hw, str):
        if hw not in HW:
            raise ValueError(f"unknown hardware preset {hw!r}; "
                             f"expected one of {tuple(HW)}")
        return HW[hw]
    if hw is not None:
        return hw
    if config is not None and config.hw is not None:
        return HW[config.hw]
    return _default_hw if _default_hw is not None else HW[DEFAULT_HW_PRESET]


def _db_fingerprint(hw: HardwareModel) -> str:
    return hw.fingerprint if hw.fingerprint else f"preset:{hw.name}"


def resolution_token(config: CholeskyConfig) -> str:
    """Identity of the hardware model :func:`resolve_config` would score
    ``config`` against right now.  ``repro_torch.plan()`` folds this into its
    auto-config cache key so a later :func:`set_default_hardware` (e.g.
    installing a calibrated model) is not masked by a plan tuned for the
    previous model."""
    return _db_fingerprint(_resolve_hw(None, config))


def _process_tuning_db() -> TuningDB:
    """Lazy process-wide db: file-backed iff ``REPRO_TUNE_DB`` is set."""
    global _process_db
    if _process_db is None:
        _process_db = TuningDB(default_db_path())
    return _process_db


def clear_tuning_cache() -> None:
    """Drop the process-wide tuning db (tests / after recalibration)."""
    global _process_db
    _process_db = None


def _mxp_plans_by_tb(n: int, sample, eps_target: float,
                     ladder: str, tbs_needed) -> dict:
    """Per-tile-size Higham-Mary precision plans from a representative
    matrix: the precision dimension of the search (paper §IV-C).

    ``sample`` is a numpy array (tile norms as the reference takes them,
    bitwise) or a tensor on any device, whose tile norms are taken on its
    device, one tile row at a time."""
    if isinstance(sample, torch.Tensor):
        from ..core.cholesky import _tile_stats
        shape = tuple(sample.shape)
    else:
        sample = np.asarray(sample, dtype=np.float64)
        shape = sample.shape
    if shape != (n, n):
        raise ValueError(f"sample matrix shape {shape} does not "
                         f"match n={n}")
    plans = {}
    for tb in tbs_needed:
        if isinstance(sample, torch.Tensor):
            norms, _, total = _tile_stats(sample, tb)
        else:
            norms, total = tile_norms(to_tiles(sample, tb))
        plans[tb] = assign_precision(norms, total, eps_target, ladder)
    return plans


def tune(n: int,
         config: CholeskyConfig | None = None,
         hw: Union[HardwareModel, str, None] = None,
         run_calibration: bool = False,
         db: TuningDB | None = None,
         sample: np.ndarray | None = None,
         eps_target: Optional[float] = None,
         use_db: bool = True) -> TuneResult:
    """Pick the schedule for this machine (or the given model) at size n.

    ``config`` pins any dimensions you have opinions about (see
    :func:`repro_torch.tune.search.search`); the default searches everything —
    tile size, policy, slot budget, and (for ``ndev > 1``) the device
    grid ``(p, q)``.  ``run_calibration=True`` measures the live backend
    first (:func:`repro_torch.tune.calibrate.calibrate`, on the card, including the
    device-to-device ``link_bw`` the multi-device simulator rides) and
    scores against the measured model instead of a datasheet preset.
    ``sample`` + ``eps_target`` add the mixed-precision dimension:
    per-tb Higham-Mary plans are computed from the sample's tile norms
    and scored exactly like everything else.  docs/tuning.md is the
    narrative version of this docstring.

    Returns the ranked result; ``result.config`` is ready for
    ``repro_torch.plan(n, result.config)``.  Winners are memoized in ``db``
    (the process db by default) keyed by hardware fingerprint and
    ``(n, ndev, eps_target)``.
    """
    if run_calibration and hw is None:
        hw = calibrate()
    hw_model = _resolve_hw(hw, config)
    base = config if config is not None else CholeskyConfig(
        tb=0, policy="auto")
    if base.eps_target is not None:
        # fold a config-side accuracy level into the search's precision
        # dimension (the search attaches explicit per-tile plans instead)
        if eps_target is not None and eps_target != base.eps_target:
            raise ValueError("conflicting eps_target in config and tune()")
        eps_target = base.eps_target
        base = dataclasses.replace(base, eps_target=None)
    if eps_target is not None and base.plan is not None:
        raise ValueError("pass either eps_target (with a sample matrix) "
                         "or a config with an explicit plan, not both")

    plans_by_tb = None
    if eps_target is not None:
        if sample is None:
            raise ValueError(
                "eps_target precision plans depend on the matrix tile "
                "norms: pass a representative `sample` matrix to tune()")
        from .search import feasible_tbs
        tbs = ([base.tb] if base.tb > 0
               else feasible_tbs(n, hw_model, base.ndev, config=base))
        plans_by_tb = _mxp_plans_by_tb(n, sample, eps_target,
                                       base.ladder, tbs)

    result = search(n, hw_model, base, plans_by_tb=plans_by_tb,
                    eps_target=eps_target)
    if use_db:
        the_db = db if db is not None else _process_tuning_db()
        the_db.put(_db_fingerprint(hw_model), n, base.ndev, eps_target,
                   result.config, result.best.makespan,
                   hw_name=hw_model.name, hw_source=hw_model.source)
    return result


def resolve_config(n: int, config: CholeskyConfig,
                   hw: Union[HardwareModel, str, None] = None,
                   db: TuningDB | None = None) -> CholeskyConfig:
    """Resolve an auto config (``tb=0`` / ``policy="auto"``) to a
    concrete one — the hook ``repro_torch.plan()`` calls.

    Pure simulation against the resolved hardware model (no calibration,
    no jit, no device work): deterministic and cheap enough for the
    planner path, with repeat calls served from the tuning db.
    """
    if not config.needs_tuning:
        return config
    hw_model = _resolve_hw(hw, config)
    the_db = db if db is not None else _process_tuning_db()
    fp = _db_fingerprint(hw_model)
    cached = the_db.get(fp, n, config.ndev, config.eps_target)
    # the key does not name the kernel route: a winner tuned without its
    # tile limits (another route, or a file the reference wrote) re-searches
    if (cached is not None and _matches_pins(cached, config, n)
            and route_allows(cached, cached.tb)):
        return cached
    result = tune(n, config, hw=hw_model, db=the_db)
    return result.config


def _matches_pins(cached: CholeskyConfig, requested: CholeskyConfig,
                  n: int) -> bool:
    """A db hit only counts if it honours the requested pinned axes
    (the db key does not encode them)."""
    if n % max(cached.tb, 1):
        return False
    if requested.tb > 0 and cached.tb != requested.tb:
        return False
    if requested.policy != "auto" and cached.policy != requested.policy:
        return False
    if (requested.cache_slots > 0
            and cached.cache_slots != requested.cache_slots):
        return False
    if requested.ladder != cached.ladder or requested.ndev != cached.ndev:
        return False
    if requested.grid is not None and cached.grid != requested.grid:
        # the grid is a searched dimension when open (None); a pinned
        # request must get exactly its layout back
        return False
    if (requested.lookahead is not None
            and cached.lookahead != requested.lookahead):
        # same contract for the pipeline depth: open (None) accepts any
        # searched winner, a pinned depth must be honoured exactly
        return False
    if (requested.host_slots > 0
            and cached.host_slots != requested.host_slots):
        # a pinned host-slab budget must come back exactly; 0 leaves the
        # spill tier to the search (engaged only when the full store
        # overflows the model's host memory)
        return False
    if requested.block != cached.block:
        # a non-default block changes the v4 candidates the cached search
        # saw (and a cached v4 winner with another block violates the
        # pin outright): re-search
        return False
    if requested.plan is not None and cached.plan != requested.plan:
        return False
    if (requested.backend, requested.compute_dtype, requested.use_pallas,
            requested.fuse_columns) != (cached.backend, cached.compute_dtype,
                                        cached.use_pallas,
                                        cached.fuse_columns):
        # the kernel route, fused or per op, is the caller's: a winner of
        # another route is not returned in its place
        return False
    return True


def default_config(n: int, ndev: int = 1,
                   target_nt: int = 32) -> CholeskyConfig:
    """The hand-picked pre-tuner baseline: V3, builder-default slots, and
    the tile size the repo's benchmarks reach for (a grid of ~32 tiles
    per side).  The tuner's acceptance bar — and the ``bench_tune``
    tuned-vs-default trajectory — is measured against this.
    """
    nt = target_nt
    while nt > 1 and n % nt:
        nt -= 1
    return CholeskyConfig(tb=n // nt, policy="v3", ndev=ndev)
