"""Online feedback controller over the live knob registry: the port of the
reference package's ``tuning/controller.py``.

Rides the time-series sampler's clock (``Sampler.add_hook``): every
``KT_TUNE_INTERVAL_S`` it reads the windowed serving signals — per-class
SLO request throughput and burn rates, critical p99, occupancy/slot-fill
gauges — and hill-climbs ONE knob at a time over its bounded lattice.

The never-worse guardrails are structural, not advisory:

- **Burn freeze** — no knob moves while any class's SLO verdict is warn
  or breach; a probe in flight when a class goes warn is reverted, not
  judged.
- **Frozen-baseline probe** — each step records the objective over the
  window that PRECEDED it; after one full observation window the step is
  kept only if throughput held (within tolerance) at equal-or-better
  critical p99 (x ``P99_SLACK``).  Anything else reverts to the exact
  previous lattice value.
- **Hysteresis** — a reverted (knob, direction) pair sits out
  ``COOLDOWN_STEPS`` decisions before being proposed again, and the
  climb only continues in a direction that produced a STRICT improvement
  — flat results move the round-robin on, so the controller cannot
  oscillate on a plateau.

Every decision is a ``tune_step`` trace, a ``karpenter_tuning_*`` metric
increment, and an entry in the ring the ``/tunez`` view renders.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from typing import Optional, Tuple

from ..metrics import (
    SLO_LATENCY,
    SLO_REQUESTS,
    TUNING_KNOB_VALUE,
    TUNING_STEP_DURATION,
    TUNING_STEP_OUTCOMES,
    TUNING_STEPS,
    Registry,
    registry as default_registry,
)
from .knobs import SPECS, Knobs, global_knobs

logger = logging.getLogger(__name__)

#: knobs the controller hill-climbs by default (registry order = round-
#: robin order).  The rest stay registry-settable but are not auto-tuned:
#: inline_delta/hier_threshold gate code PATHS (flapping them churns
#: compile/warm state), brownout_slot_cap only matters inside a brownout.
# ktlint: allow[KT014] registry knob NAME, not a hand-rolled key tail
DEFAULT_TUNED = ("max_wait_ms", "max_slots", "brownout_ms", "relax_iters")

#: keep a step only if probe throughput >= baseline * (1 - TOLERANCE) —
#: absorbs sampling noise without letting a real regression through
TOLERANCE = 0.02
#: ...and critical p99 <= baseline * P99_SLACK (bound)
P99_SLACK = 1.05
#: continue climbing the same (knob, direction) only on a STRICT
#: improvement past this margin; flat windows advance the round-robin
HYSTERESIS = 0.05
#: decisions a reverted (knob, direction) sits out before re-proposal
COOLDOWN_STEPS = 4
#: SLO verdicts that freeze the controller (obs/slo.py VERDICTS)
_FREEZE_VERDICTS = ("warn", "breach")


def tune_enabled() -> bool:
    """KT_TUNE=1 arms the controller (default off: the registry alone
    changes no serving behavior)."""
    return os.environ.get("KT_TUNE", "0") == "1"


def tune_interval_s() -> float:
    try:
        return float(os.environ.get("KT_TUNE_INTERVAL_S", "30"))
    except ValueError:
        return 30.0


class _Probe:
    """One in-flight lattice step awaiting its observation window."""

    __slots__ = ("knob", "direction", "prev", "new",
                 "base_thr", "base_p99", "at")

    def __init__(self, knob: str, direction: int, prev, new,
                 base_thr: float, base_p99: Optional[float],
                 at: float) -> None:
        self.knob = knob
        self.direction = direction
        self.prev = prev
        self.new = new
        self.base_thr = base_thr
        self.base_p99 = base_p99
        self.at = at


class TuningController:
    """One instance per :class:`~..service.server.SolverService`.

    Single-writer by contract: decisions run on the sampler's tick
    thread (or a test's direct ``step()`` calls) — never concurrently.
    The KNOBS object handles cross-thread visibility; serving decision
    points snapshot it themselves.
    """

    def __init__(
        self,
        knobs: Optional[Knobs] = None,
        registry: Optional[Registry] = None,
        sampler=None,
        slo=None,
        tracer=None,
        interval_s: Optional[float] = None,
        window_s: Optional[float] = None,
        tuned: Tuple[str, ...] = DEFAULT_TUNED,
    ) -> None:
        self.knobs = knobs if knobs is not None else global_knobs()
        self.registry = registry or default_registry
        self.sampler = sampler
        self.slo = slo
        self.tracer = tracer
        self.interval_s = (tune_interval_s() if interval_s is None
                           else float(interval_s))
        # the observation window must span >= 2 sampler ticks or the
        # ring queries (increase/quantile) return None and every window
        # would be judged no_data
        tick = float(getattr(sampler, "interval_s", 1.0) or 1.0)
        self.window_s = (max(self.interval_s, 2.0 * tick + 1e-6)
                         if window_s is None else float(window_s))
        self.tuned = tuple(t for t in tuned if any(
            s.name == t for s in SPECS))
        self.decisions: deque = deque(maxlen=64)
        self._probe: Optional[_Probe] = None
        self._last_tick: Optional[float] = None
        self._i = 0                     # round-robin cursor over tuned
        self._dir = {}                  # knob -> last climb direction
        self._cooldown = {}             # (knob, direction) -> steps left
        self._n_steps = 0
        zero_init(self.registry)
        self._publish_values()

    # ---- sampler hook ---------------------------------------------------
    def on_tick(self, now: float) -> None:
        """Sampler hook: pace decisions to the tune interval on the
        sampler's own clock (FakeClock tests drive ``tick()``)."""
        if self._last_tick is None:
            self._last_tick = now
            return
        if now - self._last_tick < self.interval_s:
            return
        self._last_tick = now
        self.step(now)

    # ---- one decision ---------------------------------------------------
    def step(self, now: float) -> str:
        """Run one controller decision; returns the outcome label."""
        t0 = time.perf_counter()
        obs = self._observe()
        if self._probe is not None:
            knob, outcome, reason, detail = self._judge(obs, now)
        else:
            knob, outcome, reason, detail = self._propose(obs, now)
        self._n_steps += 1
        for key in list(self._cooldown):
            self._cooldown[key] -= 1
            if self._cooldown[key] <= 0:
                del self._cooldown[key]
        self.registry.counter(TUNING_STEPS).inc(
            {"knob": knob or "none", "outcome": outcome})
        self._publish_values()
        self.registry.histogram(TUNING_STEP_DURATION).observe(
            time.perf_counter() - t0)
        decision = {
            "t": now, "knob": knob, "outcome": outcome, "reason": reason,
            "version": self.knobs.version,
        }
        decision.update(detail)
        self.decisions.append(decision)
        if self.tracer is not None:
            with self.tracer.start("tune_step", knob=knob or "",
                                   outcome=outcome, reason=reason,
                                   **{k: v for k, v in detail.items()
                                      if v is not None}):
                pass
        if outcome in ("applied", "reverted"):
            logger.info("tune_step %s: %s %s (%s)",
                        outcome, knob, detail, reason)
        return outcome

    # ---- windowed objective ---------------------------------------------
    def _observe(self) -> Optional[Tuple[float, Optional[float]]]:
        """The objective over the trailing window: (served throughput
        across classes, critical p99 seconds or None when no critical
        traffic landed in the window).  None = no windowed data at all
        — the sampler is off, cold, or nothing was served."""
        if not self.sampler:
            return None
        total = None
        from ..metrics import SLO_CLASSES

        for cls in SLO_CLASSES:
            inc = self.sampler.increase(
                SLO_REQUESTS, labels={"class": cls, "outcome": "ok"},
                window_s=self.window_s)
            if inc is not None:
                total = inc if total is None else total + inc
        if total is None:
            return None
        p99 = self.sampler.quantile(
            SLO_LATENCY, 0.99, labels={"class": "critical"},
            window_s=self.window_s)
        return total / self.window_s, p99

    def _burn_frozen(self) -> bool:
        """The hard guardrail: True while ANY class's SLO verdict is
        warn or breach — the controller must never move (and must revert
        an in-flight probe) while an objective is burning."""
        if self.slo is None:
            return False
        try:
            doc = self.slo.evaluate()
        # ktlint: allow[KT005] a failing evaluation must freeze, not
        # crash, the sampler thread the hook runs on
        except Exception:  # noqa: BLE001
            logger.exception("tune: SLO evaluation failed; freezing")
            return True
        return any(c.get("verdict") in _FREEZE_VERDICTS
                   for c in doc.get("classes", {}).values())

    # ---- judge an in-flight probe ---------------------------------------
    def _judge(self, obs, now: float):
        probe, self._probe = self._probe, None
        detail = {"from": probe.prev, "to": probe.new,
                  "baseline_thr": probe.base_thr,
                  "baseline_p99": probe.base_p99}
        if self._burn_frozen():
            self._revert(probe)
            return probe.knob, "reverted", "burn", detail
        if obs is None:
            # no windowed data to confirm with — conservative revert
            self._revert(probe)
            return probe.knob, "reverted", "no_data", detail
        thr, p99 = obs
        detail.update({"thr": thr, "p99": p99})
        p99_ok = (p99 is None or probe.base_p99 is None
                  or p99 <= probe.base_p99 * P99_SLACK)
        if not p99_ok or thr < probe.base_thr * (1.0 - TOLERANCE):
            self._revert(probe)
            return (probe.knob, "reverted",
                    "p99" if not p99_ok else "throughput", detail)
        improved = thr > probe.base_thr * (1.0 + HYSTERESIS)
        if improved:
            # momentum: keep climbing this knob in this direction
            self._dir[probe.knob] = probe.direction
        else:
            self._advance()
        return probe.knob, "kept", "improved" if improved else "flat", detail

    def _revert(self, probe: _Probe) -> None:
        self.knobs.set(probe.knob, probe.prev)
        self._cooldown[(probe.knob, probe.direction)] = COOLDOWN_STEPS
        self._dir[probe.knob] = -probe.direction
        self._advance()

    def _advance(self) -> None:
        if self.tuned:
            self._i = (self._i + 1) % len(self.tuned)

    # ---- propose a new step ---------------------------------------------
    def _propose(self, obs, now: float):
        if not self.tuned:
            return None, "skipped", "nothing_tuned", {}
        if obs is None:
            return None, "skipped", "no_data", {}
        if self._burn_frozen():
            return None, "frozen", "burn", {}
        thr, p99 = obs
        for offset in range(len(self.tuned)):
            name = self.tuned[(self._i + offset) % len(self.tuned)]
            if self.knobs.frozen(name):
                continue
            direction = self._dir.get(name, 1)
            for d in (direction, -direction):
                if self._cooldown.get((name, d)):
                    continue
                cand = self.knobs.step(name, d)
                if cand is None:
                    continue
                prev = self.knobs.get(name)
                if not self.knobs.set(name, cand):
                    continue
                self._i = (self._i + offset) % len(self.tuned)
                self._dir[name] = d
                self._probe = _Probe(name, d, prev, cand, thr, p99, now)
                return name, "applied", "probe", {
                    "from": prev, "to": cand, "thr": thr, "p99": p99}
        return None, "skipped", "edge_or_cooldown", {"thr": thr, "p99": p99}

    # ---- metrics / views ------------------------------------------------
    def _publish_values(self) -> None:
        gauge = self.registry.gauge(TUNING_KNOB_VALUE)
        snap = self.knobs.snapshot()
        for s in SPECS:
            gauge.set(float(snap.get(s.name)), {"knob": s.name})

    def tunez(self) -> dict:
        """The /tunez document: knob table + the recent decision ring."""
        return {
            "enabled": True,
            "interval_s": self.interval_s,
            "window_s": self.window_s,
            "tuned": list(self.tuned),
            "steps": self._n_steps,
            "probe": (None if self._probe is None else {
                "knob": self._probe.knob, "from": self._probe.prev,
                "to": self._probe.new, "since": self._probe.at}),
            "knobs": self.knobs.describe(),
            "decisions": list(self.decisions),
        }


def zero_init(registry: Registry) -> None:
    """Register the full tuning series population at 0 (KT003): every
    knob x outcome counter series plus the 'none' knob the skip/freeze
    outcomes land on, the knob-value gauges, the duration histogram."""
    steps = registry.counter(TUNING_STEPS)
    for s in SPECS:
        for outcome in TUNING_STEP_OUTCOMES:
            if not steps.has({"knob": s.name, "outcome": outcome}):
                steps.inc({"knob": s.name, "outcome": outcome}, value=0.0)
    for outcome in TUNING_STEP_OUTCOMES:
        if not steps.has({"knob": "none", "outcome": outcome}):
            steps.inc({"knob": "none", "outcome": outcome}, value=0.0)
    registry.histogram(TUNING_STEP_DURATION)
    gauge = registry.gauge(TUNING_KNOB_VALUE)
    for s in SPECS:
        if not gauge.has({"knob": s.name}):
            gauge.set(0.0, {"knob": s.name})
