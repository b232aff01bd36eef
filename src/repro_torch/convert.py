"""Carry a reference configuration or LM parameter tree across to the port.

The Cholesky reference has no weights: its state is the config, the
precision plan (a ``classes`` int8 array, a ``ladder`` tuple and
``eps_target``) and the tile store.  :func:`config_from_reference` takes the
reference config as plain Python/numpy values,
``dataclasses.asdict(repro.CholeskyConfig(...))`` (which turns the plan into
a dict of those three fields), and returns the port's
:class:`~repro_torch.core.api.CholeskyConfig` with the same plan.

:func:`params_from_reference` takes the LM scaffold's parameter tree
(``repro.models.transformer.init_model``) as numpy arrays and returns the
port's :class:`~repro_torch.models.transformer.Model` holding the same
values; :func:`opt_state_from_reference` carries an AdamW state
(``repro.optim.adamw_init``/``adamw_update``) across the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.api import CholeskyConfig
from .core.precision import PrecisionPlan
from .models.transformer import Model, _regions
from .optim import OptState, Q8

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


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _flatten(sub, f"{prefix}{key}.", out)
    else:
        out[prefix[:-1]] = tree
    return out


def _group(leaf, g: int):
    """Scan group ``g`` of a stacked leaf: an array's ``[g]``, or a
    ``Q8``'s payload and scale each split along that axis."""
    if isinstance(leaf, tuple):
        return type(leaf)(*(x[g] for x in leaf))
    return leaf[g]


def _flat_state(tree: dict, cfg) -> dict:
    """``{state_dict name: leaf}`` for a reference tree shaped like the
    parameters (the parameters, a gradient, an AdamW moment)."""
    _, n_groups, _ = _regions(cfg)
    layers = [_flatten(lp, "", {}) for lp in tree["prefix"]]
    if tree.get("stack") is not None:
        group = [_flatten(lp, "", {}) for lp in tree["stack"]]
        layers += [{k: _group(v, g) for k, v in lp.items()}
                   for g in range(n_groups) for lp in group]
    layers += [_flatten(lp, "", {}) for lp in tree["remainder"]]
    flat = {"embed.tok": tree["embed"]["tok"],
            "final_norm": tree["final_norm"]}
    if not cfg.tie_embeddings:
        flat["unembed.out"] = tree["unembed"]["out"]
    for n, layer in enumerate(layers):
        flat.update({f"layers.{n}.{k}": v for k, v in layer.items()})
    if cfg.is_encdec:
        for n, lp in enumerate(tree["encoder"]):
            flat.update({f"encoder.{n}.{k}": v
                         for k, v in _flatten(lp, "", {}).items()})
        flat["enc_final_norm"] = tree["enc_final_norm"]
    return flat


def _tensor(x, device):
    return torch.from_numpy(np.array(x)).to(device)


def params_from_reference(tree: dict, cfg, device="cuda") -> Model:
    """The port's model for a reference parameter tree of numpy arrays (or
    for a gradient tree of the same shape, whose values it then holds).

    The reference keeps ``prefix`` and ``remainder`` layers as lists and
    the scanned region as ``stack``: a list of ``scan_group`` layer dicts
    whose leaves carry a leading ``n_groups`` axis.  Here the layers are
    one list in layer order: the prefix, then group by group the stack's
    j-th layer, then the remainder.  With tied embeddings there is no
    ``unembed``; an encoder-decoder model's ``encoder`` list and
    ``enc_final_norm`` come across under the same names."""
    state = {k: _tensor(v, device) for k, v in _flat_state(tree, cfg).items()}
    model = Model(cfg, None, "meta")
    model.load_state_dict(state, strict=True, assign=True)
    return model


def opt_state_from_reference(opt, cfg, device="cuda") -> OptState:
    """The port's :class:`~repro_torch.optim.OptState` for the reference's
    ``OptState`` of numpy leaves (``jax.tree.map(np.asarray, opt)``): the
    moments keyed by the model's ``state_dict`` names, by
    :func:`params_from_reference`'s layer mapping; a ``Q8`` leaf becomes the
    port's ``Q8``, a stacked one split along the group axis, its payload and
    its scale alike."""
    def leaf(x):
        if isinstance(x, tuple):
            return Q8(_tensor(x[0], device), _tensor(x[1], device))
        return _tensor(x, device)

    def moments(tree):
        return {k: leaf(v) for k, v in _flat_state(tree, cfg).items()}

    return OptState(step=_tensor(np.asarray(opt[0], np.int32), device),
                    m=moments(opt[1]), v=moments(opt[2]))
