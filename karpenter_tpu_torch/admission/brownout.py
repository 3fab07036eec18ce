"""Brownout: load-responsive degradation ladder.

Under overload the service must degrade solve *quality/latency* for low
priority classes instead of failing high ones — CvxCluster's tiered
solve-quality-vs-latency tradeoff, applied at the serving boundary.  The
driving signal is the admission queue-delay EWMA (how long admitted
requests wait before the dispatcher picks them up); as it climbs through
the rung thresholds the controller steps down a ladder of increasingly
lossy mitigations, and steps back up with hysteresis as the delay drains:

====  ==========================================================
rung  mitigation
====  ==========================================================
1     shrink the coalescer max-wait to 0 (stop holding batches
      open for stragglers; flush the moment the queue idles)
2     cap megabatch slots (bound one flush's latency footprint)
3     route ``best_effort`` to the host FFD ``reference`` solver
      (device capacity reserved for critical/batch)
4     shed ``best_effort`` at admission (RESOURCE_EXHAUSTED)
====  ==========================================================

Knobs: ``KT_BROWNOUT_MS`` — rung-1 threshold, milliseconds (default 2000;
rung *n* engages at ``2^(n-1)`` times it; 0 disables the ladder);
``KT_BROWNOUT_ALPHA`` — EWMA smoothing (default 0.2);
``KT_BROWNOUT_SLOT_CAP`` — the rung-2 slot cap (default 2).

Single-writer by contract: the pipeline dispatcher owns ``observe`` (like
``SlotCoalescer``); readers (statusz) see the gauge.  Clocked through the
injectable Clock (KT002).
"""

from __future__ import annotations

import logging
from typing import Optional

from ..metrics import (
    ADMISSION_BROWNOUT_LEVEL,
    Registry,
    registry as default_registry,
)
from ..utils.clock import Clock
from .policy import BEST_EFFORT, _env_float, rank

logger = logging.getLogger(__name__)

#: number of rungs on the ladder
MAX_LEVEL = 4

#: the idle-tick cadence the per-observation ``alpha`` was calibrated to
#: (the dispatcher's 100ms idle poll): :meth:`BrownoutController.idle`
#: decays by elapsed TIME at exactly the rate ``observe(0.0)`` decayed
#: per tick at this cadence, so real-time behavior is unchanged while a
#: stalled or FakeClock'd dispatcher no longer pins the ladder at its
#: last loaded rung
IDLE_TICK_REF_S = 0.1


class BrownoutController:
    def __init__(
        self,
        step_s: Optional[float] = None,
        alpha: Optional[float] = None,
        slot_cap: Optional[int] = None,
        registry: Optional[Registry] = None,
        clock: Optional[Clock] = None,
    ) -> None:
        if step_s is None:
            step_s = _env_float("KT_BROWNOUT_MS", 2000.0) / 1000.0
        if alpha is None:
            alpha = _env_float("KT_BROWNOUT_ALPHA", 0.2)
        if slot_cap is None:
            slot_cap = int(_env_float("KT_BROWNOUT_SLOT_CAP", 2))
        self.step_s = step_s
        self.alpha = min(1.0, max(0.01, alpha))
        self._slot_cap = max(1, slot_cap)
        self.registry = registry or default_registry
        self.clock = clock or Clock()
        self.ewma_s = 0.0
        self._level = 0
        #: last observation/decay stamp on the injected clock — the
        #: idle-decay path is TIME-based, not tick-counted
        self._last_at: Optional[float] = None
        self.registry.gauge(ADMISSION_BROWNOUT_LEVEL).set(0)

    @property
    def enabled(self) -> bool:
        return self.step_s > 0

    @property
    def level(self) -> int:
        return self._level

    def threshold(self, level: int) -> float:
        """Queue-delay EWMA at which ``level`` engages."""
        return self.step_s * (2 ** (level - 1))

    def observe(self, wait_s: float) -> int:
        """Fold one queue wait (or an idle tick's 0.0 — the decay path)
        into the EWMA and recompute the rung.  Engaging is immediate at
        the rung threshold; disengaging requires the EWMA to fall below
        HALF the rung's threshold (hysteresis, so the ladder doesn't
        flap at a boundary).  Returns the new level."""
        if not self.enabled:
            return 0
        self._last_at = self.clock.now()
        self.ewma_s += self.alpha * (max(0.0, wait_s) - self.ewma_s)
        return self._reeval()

    def idle(self, now: Optional[float] = None) -> int:
        """Idle-tick decay, by ELAPSED TIME on the injected clock.

        The old path folded a fixed-alpha 0.0 sample per tick, which
        tied the decay rate to the dispatcher's real-time poll cadence:
        a stalled dispatcher (wedged fence, debugger) or a FakeClock
        harness left the ladder stuck at its last loaded rung until the
        next request.  Here the EWMA decays by ``(1-alpha)`` per
        :data:`IDLE_TICK_REF_S` of elapsed clock time — identical to the
        old behavior at the dispatcher's nominal 10Hz idle cadence, and
        cadence-independent everywhere else.  Returns the new level."""
        if not self.enabled:
            return 0
        if now is None:
            now = self.clock.now()
        if self._last_at is None:
            self._last_at = now
            return self._level
        dt = max(0.0, now - self._last_at)
        self._last_at = now
        if dt > 0.0 and self.ewma_s > 0.0:
            self.ewma_s *= (1.0 - self.alpha) ** (dt / IDLE_TICK_REF_S)
        return self._reeval()

    def retune(self, step_s: Optional[float] = None,
               slot_cap: Optional[int] = None) -> None:
        """Live knob application (tuning registry): move the
        ladder's threshold scale and/or rung-2 slot cap, then requantize
        the rung against the UNCHANGED EWMA — the dispatcher calls this
        under its scheduler lock, so a mid-evaluation retune can never
        tear a decision."""
        changed = False
        if step_s is not None and step_s != self.step_s:
            self.step_s = step_s
            changed = True
        if slot_cap is not None:
            self._slot_cap = max(1, int(slot_cap))
        if changed and self.enabled:
            self._reeval()

    def _reeval(self) -> int:
        """Requantize the rung from the current EWMA: engage at the rung
        threshold, disengage below HALF of it (hysteresis)."""
        level = self._level
        while level < MAX_LEVEL and self.ewma_s >= self.threshold(level + 1):
            level += 1
        while level > 0 and self.ewma_s < self.threshold(level) / 2.0:
            level -= 1
        if level != self._level:
            logger.warning(
                "brownout %s: level %d -> %d (queue-delay EWMA %.0fms)",
                "escalating" if level > self._level else "recovering",
                self._level, level, self.ewma_s * 1000.0)
            self._level = level
            self.registry.gauge(ADMISSION_BROWNOUT_LEVEL).set(level)
        return self._level

    # ---- ladder effects (read by the pipeline dispatcher) ---------------
    def max_wait(self, base_s: float) -> float:
        """Rung 1+: stop holding partial batches open for stragglers."""
        return 0.0 if self._level >= 1 else base_s

    def slot_cap(self, base_slots: int) -> int:
        """Rung 2+: bound one megabatch flush's latency footprint."""
        if self._level >= 2:
            return max(1, min(base_slots, self._slot_cap))
        return base_slots

    def route_to_host(self, pclass: str) -> bool:
        """Rung 3+: low classes solve on the host FFD tier, reserving
        device capacity for critical/batch."""
        return self._level >= 3 and rank(pclass) >= rank(BEST_EFFORT)

    def shed(self, pclass: str) -> bool:
        """Rung 4: low classes are shed at admission."""
        return self._level >= MAX_LEVEL and rank(pclass) >= rank(BEST_EFFORT)
