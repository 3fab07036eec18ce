"""Admission policy: priority classes, token buckets, per-class quotas.

The serving path (pipelining and megabatching) made the solver
fast but left it unprotected: every Solve RPC entered an unbounded FIFO
regardless of queue depth, device health, or caller deadline.  This module
is the *policy* half of the admission subsystem — who gets in, at what
rate, and how much of the queue each class may hold.  The reference layers
the same protections around its solver (pod priority/preemption ordering
into ``scheduling.Solve``, disruption budgets); "Priority Matters"
(PAPERS.md) shows priority-ordered admission is load-bearing for packing
quality under contention.

Three priority classes, mirroring Kubernetes PriorityClass semantics at
the RPC boundary:

- ``critical`` — the operator's provisioning reconcile loop: never shed
  while lower classes can absorb, fills megabatch slots first.
- ``batch`` — the backward-compatible default (an old client that sends
  no class gets exactly the pre-admission treatment: admitted while
  capacity exists).
- ``best_effort`` — consolidation what-ifs, speculative solves: first to
  brownout (host FFD tier), first to shed.

Everything clocks through the injectable
:class:`~karpenter_tpu_torch.utils.clock.Clock` so FakeClock tests are
deterministic (KT002)."""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..utils.clock import Clock

# ---------------------------------------------------------------------------
# priority classes
# ---------------------------------------------------------------------------

CRITICAL = "critical"
BATCH = "batch"
BEST_EFFORT = "best_effort"

#: rank order: LOWER ranks are more important (fill slots first, shed last)
PRIORITY_CLASSES: Tuple[str, ...] = (CRITICAL, BATCH, BEST_EFFORT)
_RANK: Dict[str, int] = {c: i for i, c in enumerate(PRIORITY_CLASSES)}

#: wire default when a request carries no class (KT_DEFAULT_PRIORITY_CLASS
#: overrides; must be a known class or it falls back to ``batch``)
DEFAULT_CLASS_ENV = "KT_DEFAULT_PRIORITY_CLASS"


def default_class() -> str:
    c = os.environ.get(DEFAULT_CLASS_ENV, BATCH)
    return c if c in _RANK else BATCH


def parse_class(name: str) -> str:
    """Normalize a wire/CLI priority-class string.  Empty (old clients,
    the backward-compatible proto default) and unknown names fold into
    :func:`default_class` so the metric label set stays bounded."""
    name = (name or "").strip().lower()
    return name if name in _RANK else default_class()


def rank(pclass: str) -> int:
    """0 = most important.  Unknown classes rank as the default class."""
    return _RANK.get(pclass, _RANK[default_class()])


# ---------------------------------------------------------------------------
# typed shed errors (the wire contract: RESOURCE_EXHAUSTED / DEADLINE_EXCEEDED)
# ---------------------------------------------------------------------------


class SolveShedError(RuntimeError):
    """The solver service refused this request under overload (rate limit,
    bounded-queue rejection, preemption by a higher class, or the brownout
    ladder's shed rung).  Maps to gRPC ``RESOURCE_EXHAUSTED``; clients must
    back off, NOT silently retry into the overloaded server."""

    def __init__(self, message: str, pclass: str = "", reason: str = "") -> None:
        super().__init__(message)
        self.pclass = pclass
        self.reason = reason


class SolveDeadlineError(SolveShedError):
    """The request's enqueue deadline expired before dispatch — rejected
    BEFORE tensorize/dispatch so timed-out work never burns a device round
    trip.  Maps to gRPC ``DEADLINE_EXCEEDED``."""


# ---------------------------------------------------------------------------
# token bucket
# ---------------------------------------------------------------------------


class RateLimiter:
    """Thread-safe token bucket: ``rate`` tokens/second refill up to
    ``burst``.  ``rate <= 0`` disables (always allows) — the default for
    every class, so admission-on changes nothing until an operator opts a
    class into a ceiling."""

    def __init__(self, rate: float = 0.0, burst: Optional[float] = None,
                 clock: Optional[Clock] = None) -> None:
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(1.0, rate))
        self.clock = clock or Clock()
        self._lock = threading.Lock()
        self._tokens = self.burst          # guarded-by: _lock
        self._last = self.clock.now()      # guarded-by: _lock

    def allow(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            now = self.clock.now()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


# ---------------------------------------------------------------------------
# per-class quotas + the policy bundle
# ---------------------------------------------------------------------------


@dataclass
class ClassQuota:
    """Bounds for one priority class.  ``0`` means unlimited — defaults are
    deliberately generous so switching admission ON is behavior-neutral
    until real overload (or explicit configuration) engages them."""

    max_queue_depth: int = 0      #: queued requests of this class
    max_concurrency: int = 0      #: admitted-but-unresolved requests
    rate: float = 0.0             #: token-bucket refill, requests/second
    burst: Optional[float] = None  #: token-bucket capacity (default: rate)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass
class AdmissionPolicy:
    """The policy bundle the service constructs per pipeline.

    Env knobs (each per-class knob also has a ``KT_ADMIT_<CLASS>_*``
    override, class upper-cased):

    - ``KT_ADMIT_QUEUE_TOTAL`` — total queued requests across classes
      (default 64; the bound that turns a traffic spike into early
      RESOURCE_EXHAUSTED instead of unbounded latency growth)
    - ``KT_ADMIT_QUEUE_DEPTH`` — per-class queue-depth quota (default 0 =
      bounded only by the total)
    - ``KT_ADMIT_CONCURRENCY`` — per-class in-flight quota (default 0)
    - ``KT_ADMIT_RATE`` / ``KT_ADMIT_BURST`` — per-class token bucket
      (default 0 = unlimited)
    - ``KT_DEFAULT_DEADLINE_MS`` — enqueue deadline applied when the RPC
      carries none (default 0 = no deadline)
    """

    quotas: Dict[str, ClassQuota] = field(default_factory=dict)
    max_queue_total: int = 64
    default_deadline_s: Optional[float] = None

    @classmethod
    def from_env(cls) -> "AdmissionPolicy":
        total = _env_int("KT_ADMIT_QUEUE_TOTAL", 64)
        depth = _env_int("KT_ADMIT_QUEUE_DEPTH", 0)
        conc = _env_int("KT_ADMIT_CONCURRENCY", 0)
        rate = _env_float("KT_ADMIT_RATE", 0.0)
        burst = _env_float("KT_ADMIT_BURST", 0.0) or None
        quotas = {}
        for c in PRIORITY_CLASSES:
            up = c.upper()
            quotas[c] = ClassQuota(
                max_queue_depth=_env_int(f"KT_ADMIT_{up}_QUEUE_DEPTH", depth),
                max_concurrency=_env_int(f"KT_ADMIT_{up}_CONCURRENCY", conc),
                rate=_env_float(f"KT_ADMIT_{up}_RATE", rate),
                burst=_env_float(f"KT_ADMIT_{up}_BURST", 0.0) or burst,
            )
        deadline_ms = _env_float("KT_DEFAULT_DEADLINE_MS", 0.0)
        return cls(
            quotas=quotas, max_queue_total=max(1, total),
            default_deadline_s=(deadline_ms / 1000.0) if deadline_ms > 0
            else None,
        )

    def quota(self, pclass: str) -> ClassQuota:
        return self.quotas.setdefault(pclass, ClassQuota())

    def limiters(self, clock: Optional[Clock] = None) -> Dict[str, RateLimiter]:
        return {
            c: RateLimiter(self.quota(c).rate, self.quota(c).burst,
                           clock=clock)
            for c in PRIORITY_CLASSES
        }
