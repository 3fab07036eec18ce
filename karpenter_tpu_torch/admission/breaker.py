"""Circuit breaker gating the TPU device path.

The device tier already degrades *inside* the scheduler (the hang guard
latches unhealthy and the warm host tiers serve — solver/guard.py), but
that protection is reactive per call: while the guard's generous timeout
is still counting down, or while the device flaps hang/recover, the
pipeline keeps feeding the device path and every queued request pays the
degraded latency.  The breaker sits in FRONT of dispatch and trips on the
*accumulated* health signals the scheduler and flight recorder already
emit — ``karpenter_solver_device_hangs_total``,
``karpenter_solver_degraded_solves_total``, the device-healthy gauge, and
flight-recorder dump reasons — so overload never piles behind a dying
device.

Classic three-state machine:

- **closed** — device path open; consecutive failure signals count up.
- **open** — every solve routes to the host FFD tier; after
  ``open_interval_s`` the breaker moves to half-open.
- **half-open** — up to ``half_open_probes`` solves ride the device path;
  one failure re-opens, a clean probe quota (or a clean
  ``recovery_window_s`` of polling) re-closes.

Injectable clock (KT002); all state lock-guarded (KT004); transitions are
observable (``karpenter_admission_breaker_state`` /
``_transitions_total``).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Optional

from ..metrics import (
    ADMISSION_BREAKER_STATE,
    ADMISSION_BREAKER_TRANSITIONS,
    SOLVER_DEGRADED_SOLVES,
    SOLVER_DEVICE_HANGS,
    SOLVER_DEVICE_HEALTHY,
    Registry,
    registry as default_registry,
)
from ..utils.clock import Clock

logger = logging.getLogger(__name__)

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 3,
        open_interval_s: float = 30.0,
        half_open_probes: int = 3,
        recovery_window_s: float = 15.0,
        clock: Optional[Clock] = None,
        registry: Optional[Registry] = None,
        on_transition: Optional[Callable[[str], None]] = None,
    ) -> None:
        self.failure_threshold = max(1, failure_threshold)
        self.open_interval_s = open_interval_s
        self.half_open_probes = max(1, half_open_probes)
        self.recovery_window_s = recovery_window_s
        self.clock = clock or Clock()
        self.registry = registry or default_registry
        self.on_transition = on_transition
        # RLock: _transition re-acquires under holding callers, keeping the
        # guarded-by discipline lexical (KT004) without suppressions
        self._lock = threading.RLock()
        self._state = CLOSED           # guarded-by: _lock
        self._failures = 0             # guarded-by: _lock
        self._probes = 0               # guarded-by: _lock  half-open budget used
        self._probe_ok = 0             # guarded-by: _lock  half-open successes
        self._changed_at = self.clock.now()  # guarded-by: _lock
        self._mark: Dict[str, float] = {}    # guarded-by: _lock  counter snapshot
        # zero-init every transition series + the state gauge (KT003)
        for to in (CLOSED, OPEN, HALF_OPEN):
            self.registry.counter(ADMISSION_BREAKER_TRANSITIONS).inc(
                {"to": to}, value=0.0)
        self.registry.gauge(ADMISSION_BREAKER_STATE).set(_STATE_GAUGE[CLOSED])

    # ---- state ----------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str) -> None:
        with self._lock:
            if self._state == to:
                return
            logger.warning("device-path circuit breaker %s -> %s",
                           self._state, to)
            self._state = to
            self._changed_at = self.clock.now()
            self._failures = 0
            self._probes = 0
            self._probe_ok = 0
        self.registry.counter(ADMISSION_BREAKER_TRANSITIONS).inc({"to": to})
        self.registry.gauge(ADMISSION_BREAKER_STATE).set(_STATE_GAUGE[to])
        if self.on_transition is not None:
            self.on_transition(to)

    # ---- gate -----------------------------------------------------------
    def allow(self) -> bool:
        """True when this solve may take the device path.  In half-open,
        allows up to ``half_open_probes`` probes; the open interval elapsing
        moves open -> half-open lazily here (no timer thread)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self.clock.now() - self._changed_at < self.open_interval_s:
                    return False
                self._transition(HALF_OPEN)
            # half-open: meter the probe budget
            if self._probes < self.half_open_probes:
                self._probes += 1
                return True
            return False

    # ---- signal feeds ---------------------------------------------------
    def record_failure(self, reason: str = "") -> None:
        """One device-health failure signal (hang-guard trip, degraded
        solve burst, anomaly dump).  Trips closed -> open at the threshold;
        any failure re-opens a half-open breaker."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._transition(OPEN)
                return
            if self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    self._transition(OPEN)

    def record_success(self) -> None:
        """One clean device-path outcome.  Closes a half-open breaker once
        the probe quota lands clean; resets the closed-state streak."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_ok += 1
                if self._probe_ok >= self.half_open_probes:
                    self._transition(CLOSED)
            elif self._state == CLOSED:
                self._failures = 0

    def poll(self) -> None:
        """Feed the breaker from the EXISTING health surface: deltas on the
        scheduler's hang/degraded counters (+ flight-recorder dump reasons
        — device_hang dumps increment the same hang counter) and the
        device-healthy gauge.  Called from the pipeline dispatcher loop;
        cheap (a few dict reads), so per-tick polling is fine."""
        hangs = self.registry.counter(SOLVER_DEVICE_HANGS).get()
        degraded = sum(
            self.registry.counter(SOLVER_DEGRADED_SOLVES).values.values())
        healthy = self.registry.gauge(SOLVER_DEVICE_HEALTHY)
        unhealthy = healthy.has() and healthy.get() == 0
        with self._lock:
            mark = self._mark
            d_hang = hangs - mark.get("hangs", hangs)
            d_degr = degraded - mark.get("degraded", degraded)
            self._mark = {"hangs": hangs, "degraded": degraded}
            now = self.clock.now()
            if d_hang > 0 or unhealthy:
                # a hang (or a latched-unhealthy device) is severe: open
                # immediately rather than waiting out the failure streak
                self._transition(OPEN)
                return
            if d_degr > 0:
                # degraded solves arrive in bursts (one per queued request);
                # count the BURST once per poll, not once per solve
                if self._state == HALF_OPEN:
                    self._transition(OPEN)
                    return
                if self._state == CLOSED:
                    self._failures += 1
                    if self._failures >= self.failure_threshold:
                        self._transition(OPEN)
                return
            # clean poll
            if (self._state == HALF_OPEN and self._probes > 0
                    and now - self._changed_at >= self.recovery_window_s):
                # probes flowed and nothing failed for a full window
                self._transition(CLOSED)
