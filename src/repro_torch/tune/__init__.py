"""repro_torch.tune — hardware calibration + cost-model autotuner (port of
``repro.tune``).

Three layers, as in the reference:

  1. **calibration** (:mod:`repro_torch.tune.calibrate`) — micro-benchmarks
     on the card (or ``device="cpu"``) produce a *measured*
     ``HardwareModel``: per-kernel per-class rates of the hand-written
     kernels from their device time, host-link and card-to-card
     bandwidth, the host's cost a call and an allocation, the card's
     memory, and a hardware fingerprint;
  2. **search** (:mod:`repro_torch.tune.search`) — enumerate every
     feasible ``(tb, policy, cache_slots, precision plan)`` candidate and
     rank them by exact event simulation; a config that routes to the
     hand-written kernels is offered only the tile sizes they can run;
  3. **persistence + planner integration** (:mod:`repro_torch.tune.db`,
     :mod:`repro_torch.tune.autotune`) — winners memoized by hardware
     fingerprint in the reference's db format;
     ``repro_torch.plan(n, CholeskyConfig(tb=0, policy="auto"))`` resolves
     through :func:`resolve_config`.

Quickstart::

    import repro_torch
    from repro_torch import tune

    # fully automatic: plan() tunes tb/policy/cache_slots (a simulation
    # against the gh200 preset unless a default model is installed)
    solver = repro_torch.plan(n, repro_torch.CholeskyConfig(
        tb=0, policy="auto", hw="gh200")).compile()

    # explicit campaign against the measured card
    model = tune.calibrate()                  # micro-benchmark the card
    result = tune.tune(n, hw=model)           # ranked candidate table
    solver = repro_torch.plan(n, result.config).compile()
"""
from .autotune import (DEFAULT_HW_PRESET, clear_tuning_cache, default_config,
                       resolution_token, resolve_config,
                       set_default_hardware, tune)
from .calibrate import (calibrate, hardware_fingerprint, model_from_dict,
                        model_to_dict, refine_from_trace)
from .db import TuningDB, config_from_dict, config_to_dict, default_db_path
from .search import (Candidate, TuneResult, feasible_tbs, is_feasible,
                     score_config, search, slot_candidates)

__all__ = [
    "tune", "resolve_config", "resolution_token", "default_config",
    "set_default_hardware", "clear_tuning_cache", "DEFAULT_HW_PRESET",
    "calibrate", "hardware_fingerprint", "model_to_dict", "model_from_dict",
    "refine_from_trace",
    "TuningDB", "config_to_dict", "config_from_dict", "default_db_path",
    "search", "TuneResult", "Candidate", "feasible_tbs", "is_feasible",
    "slot_candidates", "score_config",
]
