"""Device-memory admission control for the serve front end (port of
``repro/serve/admission.py``).

A plan's device footprint is static — the schedule pins ``cache_slots``
managed slots plus (multi-device) its RECV panel region, all ``tb x tb``
f64 tiles — so admission is exact bookkeeping, not heuristics: the
controller reads each plan's per-device slot requirement straight off
the built schedule (:meth:`MultiDeviceSchedule.stream_nslots`), converts
to bytes, and reserves against :attr:`HardwareModel.mem_bytes`.

Decisions, in the order the service applies them:

* **reject** — a plan whose slot requirement alone exceeds
  :meth:`HardwareModel.max_cache_slots` for its tile size can *never*
  run on this hardware; the request future fails immediately with
  :class:`AdmissionError` (same eager-failure philosophy as
  ``CholeskyConfig``'s validation).
* **queue** — a plan that fits alone but would oversubscribe the
  currently reserved memory stays queued; its session is skipped by the
  dispatch loop until another tenant releases (session close).
* **admit** — memory is reserved for the session until it is closed;
  the reservation covers the factored tile working set for every
  subsequent request of that session, so steady-state traffic never
  re-negotiates.

With no hardware model (``hw=None``) or an unknown capacity
(``mem_bytes == 0``) the controller admits everything — serving on the
host replay backend has no device budget to protect.
"""
from __future__ import annotations

import threading
from typing import Optional

from ..core.analytics import HardwareModel


class AdmissionError(RuntimeError):
    """Request refused by admission control (plan cannot fit)."""


def plan_device_slots(plan) -> int:
    """Worst per-device slot count a :class:`CholeskyPlan`'s schedule
    pins (cache table + panel region), read off the built streams once a
    plan (:meth:`CholeskyPlan.device_slots`)."""
    return plan.device_slots()


def plan_device_bytes(plan) -> int:
    """Per-device reservation for one in-flight plan: its slot count in
    ``tb x tb`` f64 tiles (the executor's device-buffer dtype ceiling).

    An f32 plan's slots take half that on the card; the port reserves the
    reference's f64 ceiling all the same, so that both packages admit and
    refuse the same plans.  On a card, the service's ``hw`` (a calibrated
    model, say) carries the card's real memory."""
    return plan_device_slots(plan) * plan.config.tb * plan.config.tb * 8


class AdmissionController:
    """Tracks per-session device-memory reservations against one
    :class:`HardwareModel`; see the module docstring for the policy."""

    def __init__(self, hw: Optional[HardwareModel] = None):
        self.hw = hw
        self._lock = threading.Lock()
        self._reserved: dict = {}      # session key -> bytes

    @property
    def unbounded(self) -> bool:
        return self.hw is None or self.hw.mem_bytes <= 0

    def reserved_bytes(self) -> int:
        with self._lock:
            return sum(self._reserved.values())

    def check_feasible(self, plan) -> None:
        """Raise :class:`AdmissionError` iff ``plan`` can never fit
        (its slot pin count exceeds the device's total slot capacity)."""
        if self.unbounded:
            return
        tb = plan.config.tb
        need = plan_device_slots(plan)
        cap = self.hw.max_cache_slots(tb)
        if need > cap:
            raise AdmissionError(
                f"plan needs {need} device slots of {tb}x{tb} f64 tiles "
                f"({plan_device_bytes(plan) / 1e9:.2f} GB) but "
                f"hw={self.hw.name!r} fits at most {cap} "
                f"(mem_bytes={self.hw.mem_bytes / 1e9:.1f} GB); shrink "
                f"tb/cache_slots or serve on larger hardware")

    def try_reserve(self, key: str, plan) -> bool:
        """Reserve ``plan``'s footprint for session ``key``; False means
        currently oversubscribed (caller keeps the session queued).
        Idempotent: a session already holding a reservation is admitted."""
        if self.unbounded:
            return True
        need = plan_device_bytes(plan)
        with self._lock:
            if key in self._reserved:
                return True
            if sum(self._reserved.values()) + need > self.hw.mem_bytes:
                return False
            self._reserved[key] = need
            return True

    def release(self, key: str) -> None:
        with self._lock:
            self._reserved.pop(key, None)
