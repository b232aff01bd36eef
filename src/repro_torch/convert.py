"""Carry a reference configuration across to the port.

The reference has no weights: its state is the config, the precision plan
(a ``classes`` int8 array, a ``ladder`` tuple and ``eps_target``) and the
tile store.  :func:`config_from_reference` takes the reference config as
plain Python/numpy values, ``dataclasses.asdict(repro.CholeskyConfig(...))``
(which turns the plan into a dict of those three fields), and returns the
port's :class:`~repro_torch.core.api.CholeskyConfig` with the same plan.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.api import CholeskyConfig
from .core.precision import PrecisionPlan

_BACKENDS = {"jax": "torch", "auto": "auto", "numpy": "numpy"}
_DTYPES = {"float64": torch.float64, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def _torch_dtype(dt):
    """A numpy dtype, a jnp scalar type or a dtype name -> torch dtype."""
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    name = getattr(dt, "__name__", None) if isinstance(dt, type) else None
    if name not in _DTYPES:
        try:
            name = np.dtype(getattr(dt, "dtype", dt)).name
        except TypeError:
            name = str(dt)
    if name not in _DTYPES:
        raise ValueError(f"no torch counterpart for compute dtype {dt!r}")
    return _DTYPES[name]


def config_from_reference(fields: dict) -> CholeskyConfig:
    """The port's config for a reference config given as plain values."""
    f = dict(fields)
    p = f.get("plan")
    if isinstance(p, dict):
        f["plan"] = PrecisionPlan(
            np.asarray(p["classes"], dtype=np.int8), tuple(p["ladder"]),
            float(p["eps_target"]))
    f["backend"] = _BACKENDS.get(f.get("backend", "auto"), f.get("backend"))
    f["compute_dtype"] = _torch_dtype(f.get("compute_dtype"))
    for key in ("block", "grid"):
        if f.get(key) is not None:
            f[key] = tuple(f[key])
    return CholeskyConfig(**f)
