"""Persistent tuning database: ``(fingerprint, n, ndev, eps_target)`` ->
winning config (port of ``repro/tune/db.py``).

The search is deterministic but not free (it builds and simulates dozens
of op streams), so winners are memoized.  The key is the hardware
fingerprint — :func:`repro_torch.tune.calibrate.hardware_fingerprint` for
measured models, ``"preset:<name>"`` for datasheet presets — plus the
problem shape.

Two storage modes:

  * ``TuningDB(path)`` — a human-readable JSON file, written atomically
    (tmp file + rename) so concurrent readers never see a torn write;
  * ``TuningDB(None)`` — in-memory only.  This is the default inside
    ``repro_torch.plan()``, unless the user opts into a file via the
    ``REPRO_TUNE_DB`` environment variable.

The file is the reference's, schema for schema: a record written by either
package reads in the other.  A config is stored in the reference's
vocabulary (the device backend is ``"jax"``, a compute dtype is its NumPy
name) and mapped back to the port's on reading
(:func:`repro_torch.convert.config_from_reference`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

from ..convert import config_from_reference
from ..core.analytics import HW
from ..core.api import CholeskyConfig

ENV_DB_PATH = "REPRO_TUNE_DB"
_SCHEMA = 1
#: the port's backend names as the reference spells them
_REF_BACKENDS = {"torch": "jax", "auto": "auto", "numpy": "numpy"}


def config_to_dict(config: CholeskyConfig) -> dict:
    """JSON-serializable form of a config in the reference's vocabulary
    (round-trips through :func:`config_from_dict`)."""
    d = dataclasses.asdict(config)
    d["block"] = list(config.block)
    d["backend"] = _REF_BACKENDS[config.backend]
    if config.grid is not None:
        d["grid"] = list(config.grid)
    if config.plan is not None:
        d["plan"] = {
            "classes": config.plan.classes.tolist(),
            "ladder": list(config.plan.ladder),
            "eps_target": config.plan.eps_target,
        }
    if config.compute_dtype is not None:
        d["compute_dtype"] = str(config.compute_dtype).replace("torch.", "")
    return d


def config_from_dict(d: dict) -> CholeskyConfig:
    d = dict(d)
    if d.get("hw") is not None and d["hw"] not in HW:
        # a measured model registered in some other process: the rates
        # are gone, only the choice survives — drop the dangling tag
        d["hw"] = None
    return config_from_reference(d)


def default_db_path() -> Optional[str]:
    """File path from ``REPRO_TUNE_DB`` (None = stay in-memory)."""
    return os.environ.get(ENV_DB_PATH) or None


class TuningDB:
    """Tiny persistent (or in-memory) map of tuning winners."""

    def __init__(self, path: Optional[str] = None):
        self.path = os.path.expanduser(path) if path else None
        self._mem: dict[str, dict] = {}
        if self.path and os.path.exists(self.path):
            self._mem = self._read()

    @staticmethod
    def key(fingerprint: str, n: int, ndev: int,
            eps_target: Optional[float]) -> str:
        return f"{fingerprint}|n={n}|ndev={ndev}|eps={eps_target}"

    def _read(self) -> dict:
        try:
            with open(self.path) as f:
                blob = json.load(f)
        except (json.JSONDecodeError, OSError):
            return {}
        if blob.get("schema") != _SCHEMA:
            return {}
        return blob.get("records", {})

    def _write(self) -> None:
        if not self.path:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d or ".", prefix=".tune-db-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"schema": _SCHEMA, "records": self._mem}, f,
                          indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            os.unlink(tmp)
            raise

    def get(self, fingerprint: str, n: int, ndev: int,
            eps_target: Optional[float]) -> Optional[CholeskyConfig]:
        rec = self._mem.get(self.key(fingerprint, n, ndev, eps_target))
        return None if rec is None else config_from_dict(rec["config"])

    def get_record(self, fingerprint: str, n: int, ndev: int,
                   eps_target: Optional[float]) -> Optional[dict]:
        return self._mem.get(self.key(fingerprint, n, ndev, eps_target))

    def put(self, fingerprint: str, n: int, ndev: int,
            eps_target: Optional[float], config: CholeskyConfig,
            predicted_makespan: float, hw_name: str = "",
            hw_source: str = "") -> None:
        self._mem[self.key(fingerprint, n, ndev, eps_target)] = {
            "config": config_to_dict(config),
            "predicted_makespan_s": predicted_makespan,
            "hw_name": hw_name,
            "hw_source": hw_source,
        }
        self._write()

    def __len__(self) -> int:
        return len(self._mem)

    def clear(self) -> None:
        self._mem.clear()
        self._write()
