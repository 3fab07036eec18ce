"""Admission control & overload protection: the port of the reference
package's ``admission/``.

The front door of the solver service (docs/ADMISSION.md is the operator
guide).  Four mechanisms compose behind :class:`AdmissionControl`, which
``service/server.py``'s ``SolvePipeline`` drives:

- :mod:`.policy` — priority classes (``critical`` / ``batch`` /
  ``best_effort``), token-bucket rate limits, per-class queue-depth and
  concurrency quotas, and the typed shed errors the wire maps to
  ``RESOURCE_EXHAUSTED`` / ``DEADLINE_EXCEEDED``.
- :mod:`.queue` — the bounded, priority-ordered, deadline-aware queue
  that replaces the raw FIFO feeding the coalescer: higher classes fill
  megabatch slots first, expired requests are rejected *before*
  tensorize/dispatch, a full queue preempts strictly-lower classes.
- :mod:`.breaker` — a closed/open/half-open circuit breaker over the
  device path, fed by the existing health signals (hang-guard trips,
  degraded-solve counters, the device-healthy gauge).
- :mod:`.brownout` — the queue-delay-EWMA degradation ladder (shrink
  max-wait → cap slots → host-route ``best_effort`` → shed).

``KT_ADMISSION=0`` disables the subsystem entirely: the pipeline keeps
its raw FIFO verbatim and behavior is byte-identical to pre-admission.

Gang contract: a gang is ONE admission unit.
The queue admits/sheds whole REQUESTS — never individual pods — so a
request carrying a gang is judged whole by construction: a shed sheds
every member together (the typed ``SolveShedError`` covers the gang),
and no path here may admit or refuse a gang-tagged pod individually
(ktlint KT025 flags per-member ``gang_id`` access in this package; the
sanctioned entry points are ``karpenter_tpu_torch.gang``'s helpers, e.g.
``gang.admission_units`` for ticket accounting and
``gang.validate_batch`` at the service door).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from ..events import Event
from ..metrics import (
    ADMISSION_ADMITTED,
    ADMISSION_HOST_ROUTED,
    ADMISSION_QUEUE_DELAY,
    ADMISSION_QUEUE_DEPTH,
    ADMISSION_SHED,
    Registry,
    registry as default_registry,
)
from ..utils.clock import Clock
from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .brownout import MAX_LEVEL, BrownoutController
from .policy import (
    BATCH,
    BEST_EFFORT,
    CRITICAL,
    PRIORITY_CLASSES,
    AdmissionPolicy,
    ClassQuota,
    RateLimiter,
    SolveDeadlineError,
    SolveShedError,
    default_class,
    parse_class,
    rank,
)
from .queue import AdmissionQueue, AdmissionTicket

__all__ = [
    "AdmissionControl", "AdmissionPolicy", "AdmissionQueue",
    "AdmissionTicket", "BATCH", "BEST_EFFORT", "BrownoutController",
    "CLOSED", "CRITICAL", "CircuitBreaker", "ClassQuota", "HALF_OPEN",
    "MAX_LEVEL", "OPEN", "PRIORITY_CLASSES", "RateLimiter", "SHED_REASONS",
    "SolveDeadlineError", "SolveShedError", "admission_enabled",
    "default_class", "parse_class", "rank",
]

#: the bounded shed-reason vocabulary (KT003: every class x reason series
#: is zero-inited at AdmissionControl construction)
SHED_REASONS = ("queue_full", "rate_limited", "concurrency", "deadline",
                "preempted", "brownout")
#: host-route reason vocabulary
HOST_ROUTE_REASONS = ("breaker", "brownout")


def admission_enabled() -> bool:
    """KT_ADMISSION=0 turns the whole subsystem off (the pipeline keeps
    its raw-FIFO path, byte-identical)."""
    return os.environ.get("KT_ADMISSION", "1") != "0"


class AdmissionControl:
    """The pipeline-facing facade: one instance per ``SolvePipeline``.

    Owns the accounting contract ktlint KT009 audits: every rejection —
    shed at admit, preemption, deadline expiry at dispatch — increments
    ``karpenter_admission_shed_total{class,reason}`` at the site that
    constructs the typed error, and publishes a shed event into the
    flight recorder's ring when one is attached."""

    def __init__(
        self,
        policy: Optional[AdmissionPolicy] = None,
        registry: Optional[Registry] = None,
        clock: Optional[Clock] = None,
        flight=None,
        breaker: Optional[CircuitBreaker] = None,
        brownout: Optional[BrownoutController] = None,
        on_shed=None,
    ) -> None:
        self.policy = policy or AdmissionPolicy.from_env()
        self.registry = registry or default_registry
        self.clock = clock or Clock()
        self.flight = flight
        #: on_shed(ticket, exc): fail an already-queued ticket's future (a
        #: preemption happens on the PREEMPTING request's RPC thread, so
        #: the owner of the victim's future must be told)
        self.on_shed = on_shed
        depth_gauge = self.registry.gauge(ADMISSION_QUEUE_DEPTH)
        self.queue = AdmissionQueue(
            self.policy, clock=self.clock,
            on_depth=lambda c, d: depth_gauge.set(d, {"class": c}),
        )
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            clock=self.clock, registry=self.registry)
        self.brownout = brownout if brownout is not None else \
            BrownoutController(registry=self.registry, clock=self.clock)
        self.limiters: Dict[str, RateLimiter] = self.policy.limiters(
            clock=self.clock)
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}   # guarded-by: _lock
        # zero-init the full admission series population (KT003): every
        # class, every shed reason, every host-route reason, depth gauges
        admitted = self.registry.counter(ADMISSION_ADMITTED)
        shed = self.registry.counter(ADMISSION_SHED)
        routed = self.registry.counter(ADMISSION_HOST_ROUTED)
        for c in PRIORITY_CLASSES:
            admitted.inc({"class": c}, value=0.0)
            if not depth_gauge.has({"class": c}):
                depth_gauge.set(0, {"class": c})
            for reason in SHED_REASONS:
                shed.inc({"class": c, "reason": reason}, value=0.0)
            for reason in HOST_ROUTE_REASONS:
                routed.inc({"class": c, "reason": reason}, value=0.0)
        self.registry.histogram(ADMISSION_QUEUE_DELAY)

    # ---- shed accounting (the KT009 contract) ---------------------------
    def _count_shed(self, pclass: str, reason: str, message: str) -> None:
        self.registry.counter(ADMISSION_SHED).inc(
            {"class": pclass, "reason": reason})
        if self.flight is not None:
            self.flight.add_event(Event(
                kind="Solve", name=pclass, reason="AdmissionShed",
                message=f"[{reason}] {message}", event_type="Warning"))

    # ---- admit (RPC threads) --------------------------------------------
    def _admit_posture(self, pclass: str,
                       deadline_s: Optional[float]) -> Tuple[float,
                                                             Optional[float]]:
        """The class POSTURE shared by :meth:`admit` and
        :meth:`admit_inline` — expired-deadline shed, brownout-rung shed,
        and the atomic concurrency check-AND-reserve (two concurrent
        admits at quota-1 must not both pass; the slot is counted BEFORE
        the ticket can possibly be preempted/released, or a racing
        release() that decrements first would leak a slot forever).
        Raises the typed shed errors; on return the concurrency slot is
        RESERVED — every later rejection path must roll it back.
        Returns ``(now, effective_deadline_s)``."""
        if deadline_s is None:
            deadline_s = self.policy.default_deadline_s
        now = self.clock.now()
        if deadline_s is not None and deadline_s <= 0:
            msg = f"{pclass} solve arrived with an expired deadline"
            self._count_shed(pclass, "deadline", msg)
            raise SolveDeadlineError(msg, pclass=pclass, reason="deadline")
        if self.brownout.shed(pclass):
            msg = (f"{pclass} shed: brownout level "
                   f"{self.brownout.level} (queue-delay EWMA "
                   f"{self.brownout.ewma_s * 1000.0:.0f}ms)")
            self._count_shed(pclass, "brownout", msg)
            raise SolveShedError(msg, pclass=pclass, reason="brownout")
        quota = self.policy.quota(pclass)
        with self._lock:
            inflight = self._inflight.get(pclass, 0)
            over = (quota.max_concurrency > 0
                    and inflight >= quota.max_concurrency)
            if not over:
                self._inflight[pclass] = inflight + 1
        if over:
            msg = (f"{pclass} shed: {inflight} in flight >= concurrency "
                   f"quota {quota.max_concurrency}")
            self._count_shed(pclass, "concurrency", msg)
            raise SolveShedError(msg, pclass=pclass, reason="concurrency")
        return now, deadline_s

    def admit(self, item: object, pclass: str,
              deadline_s: Optional[float] = None) -> AdmissionTicket:
        """Admit one request into the bounded priority queue or raise the
        typed shed error.  ``deadline_s`` is the caller's remaining budget
        (gRPC deadline / explicit ``deadline_ms``); None falls back to the
        policy default (``KT_DEFAULT_DEADLINE_MS``)."""
        now, deadline_s = self._admit_posture(pclass, deadline_s)
        quota = self.policy.quota(pclass)
        deadline = None if deadline_s is None else now + deadline_s
        # the token bucket runs as put()'s LAST gate, inside the queue's
        # critical section after every capacity check: a request the queue
        # was going to reject anyway must not spend a token (a burst of
        # queue_full rejections would otherwise drain the bucket and shed
        # admittable traffic as rate_limited once the queue frees up)
        limiter = self.limiters[pclass]
        ticket, reason, preempted = self.queue.put(
            item, pclass, deadline,
            gate=lambda: None if limiter.allow() else "rate_limited")
        for victim in preempted:
            vmsg = (f"{victim.pclass} solve preempted from a full queue by "
                    f"an arriving {pclass} request")
            self._count_shed(victim.pclass, "preempted", vmsg)
            self.release(victim)
            if self.on_shed is not None:
                self.on_shed(victim, SolveShedError(
                    vmsg, pclass=victim.pclass, reason="preempted"))
        if reason is not None:
            # the reservation above was for a ticket that never existed
            with self._lock:
                self._inflight[pclass] = max(
                    0, self._inflight.get(pclass, 0) - 1)
            if reason == "rate_limited":
                msg = (f"{pclass} shed: class rate limit "
                       f"{quota.rate:g}/s exceeded")
            else:
                msg = (f"{pclass} shed: admission queue full "
                       f"(class depth {self.queue.depth(pclass)}, quota "
                       f"{quota.max_queue_depth or 'unbounded'}, total bound "
                       f"{self.policy.max_queue_total})")
            self._count_shed(pclass, reason, msg)
            raise SolveShedError(msg, pclass=pclass, reason=reason)
        self.registry.counter(ADMISSION_ADMITTED).inc({"class": pclass})
        return ticket

    def admit_inline(self, pclass: str,
                     deadline_s: Optional[float] = None) -> AdmissionTicket:
        """Admission for a request served INLINE on its own RPC thread —
        the delta fast path's idle-pipeline shortcut (service/server.py
        ``SolvePipeline._solve_inline``).  The class POSTURE applies
        exactly as at :meth:`admit`: expired deadlines shed, the brownout
        ladder's shed rung sheds (a best_effort delta under L4 is refused
        here like any other request), the concurrency quota reserves
        atomically, and the token bucket spends last — but the ticket
        never enters the queue (it dispatches the same instant), so
        queue-depth quotas and preemption don't apply.  Pair with
        :meth:`release` like any admitted ticket."""
        now, deadline_s = self._admit_posture(pclass, deadline_s)
        quota = self.policy.quota(pclass)
        if not self.limiters[pclass].allow():
            with self._lock:  # the reservation was for a refused ticket
                self._inflight[pclass] = max(
                    0, self._inflight.get(pclass, 0) - 1)
            msg = f"{pclass} shed: class rate limit {quota.rate:g}/s exceeded"
            self._count_shed(pclass, "rate_limited", msg)
            raise SolveShedError(msg, pclass=pclass, reason="rate_limited")
        self.registry.counter(ADMISSION_ADMITTED).inc({"class": pclass})
        return AdmissionTicket(
            item=None, pclass=pclass, enqueued_at=now,
            deadline=None if deadline_s is None else now + deadline_s)

    def release(self, ticket: AdmissionTicket) -> None:
        """The ticket's request resolved (result, failure, shed, or stop):
        return its concurrency-quota slot.  Idempotent — stop() and a slow
        finalizer can race to it."""
        with self._lock:
            if ticket.released:
                return
            ticket.released = True
            self._inflight[ticket.pclass] = max(
                0, self._inflight.get(ticket.pclass, 0) - 1)

    # ---- dispatch side (pipeline dispatcher thread) ---------------------
    def get(self, timeout: Optional[float] = None) -> Optional[AdmissionTicket]:
        return self.queue.get(timeout)

    def expire(self, ticket: AdmissionTicket) -> SolveDeadlineError:
        """The ticket's enqueue deadline passed before dispatch: count the
        shed and hand back the typed error to resolve its future with —
        BEFORE any tensorize or device dispatch happened for it."""
        waited = self.clock.now() - ticket.enqueued_at
        msg = (f"{ticket.pclass} solve deadline expired after "
               f"{waited * 1000.0:.0f}ms in the admission queue")
        self._count_shed(ticket.pclass, "deadline", msg)
        return SolveDeadlineError(msg, pclass=ticket.pclass, reason="deadline")

    def observe_dispatch(self, ticket: AdmissionTicket) -> float:
        """The dispatcher picked the ticket up: record its queue delay and
        feed the brownout EWMA.  Returns the wait, seconds."""
        wait = max(0.0, self.clock.now() - ticket.enqueued_at)
        self.registry.histogram(ADMISSION_QUEUE_DELAY).observe(wait)
        self.brownout.observe(wait)
        return wait

    def observe_idle(self) -> None:
        """Idle dispatcher tick: decay the brownout EWMA toward zero (by
        elapsed clock time — cadence-independent, so a stalled dispatcher
        or FakeClock harness still recovers) and poll the breaker's
        counter feeds."""
        self.brownout.idle(self.clock.now())
        self.breaker.poll()

    def route_host(self, pclass: str) -> Optional[str]:
        """Why this solve must take the host FFD tier instead of the
        device path: ``"breaker"`` (circuit not closed / probe budget
        spent), ``"brownout"`` (ladder rung 3+ for this class), or None
        (device path open)."""
        reason = None
        if not self.breaker.allow():
            reason = "breaker"
        elif self.brownout.route_to_host(pclass):
            reason = "brownout"
        if reason is not None:
            self.registry.counter(ADMISSION_HOST_ROUTED).inc(
                {"class": pclass, "reason": reason})
        return reason

    def drain(self) -> List[AdmissionTicket]:
        return self.queue.drain()

    # ---- introspection (statusz / overload demo) ------------------------
    def stats(self) -> dict:
        shed = self.registry.counter(ADMISSION_SHED)
        admitted = self.registry.counter(ADMISSION_ADMITTED)
        with self._lock:
            inflight = dict(self._inflight)
        return {
            "queued": {c: self.queue.depth(c) for c in PRIORITY_CLASSES},
            "inflight": inflight,
            "admitted": {c: admitted.get({"class": c})
                         for c in PRIORITY_CLASSES},
            "shed": {
                c: {r: shed.get({"class": c, "reason": r})
                    for r in SHED_REASONS
                    if shed.get({"class": c, "reason": r})}
                for c in PRIORITY_CLASSES
            },
            "breaker": self.breaker.state,
            "brownout_level": self.brownout.level,
            "queue_delay_ewma_ms": round(self.brownout.ewma_s * 1000.0, 1),
        }
