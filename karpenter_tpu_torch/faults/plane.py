"""FaultPlane core: the KT_FAULTS schedule grammar, the site registry, and
the injection/recovery metric funnels.

Grammar (semicolon-separated)::

    KT_FAULTS="seed=42;device_hang@fence:at=3;rpc_unavailable@transport:p=0.25:n=2"

One token is either ``seed=N`` (the plane's deterministic RNG seed,
default 0) or a rule ``kind@site[:at=N][:every=M][:p=F][:n=K][:value=V]``:

- ``at=N``   — fire on exactly the Nth call of the site (1-based), once.
- ``every=M``— fire on every Mth call of the site.
- ``p=F``    — fire with probability F per call, drawn from the plane's
  ONE seeded RNG (a given (seed, schedule, call sequence) replays
  identically — the whole point of a *seeded* chaos plane).
- ``n=K``    — cap total firings of this rule at K (default: 1 for
  ``at=`` rules — they name one occurrence — unlimited otherwise).
- ``value=V``— kind parameter: seconds for ``slow_fence``/``slow_step``/
  ``clock_jump``, keep-fraction for ``snapshot_truncate``.

Kinds split into two behaviors:

- **raise kinds** — ``fire(site)`` raises at the choke point:
  ``device_hang`` (:class:`~karpenter_tpu_torch.solver.guard.DeviceHang`),
  ``dispatch_exc`` (:class:`InjectedFault`), ``rpc_unavailable`` /
  ``rpc_reset`` (:class:`InjectedRpcError`, a real ``grpc.RpcError``
  subclass carrying UNAVAILABLE so client-side handling is exercised
  verbatim).
- **effect kinds** — ``fire(site)`` returns an :class:`Effect` the call
  site enacts: ``slow_fence``/``slow_step`` (added latency),
  ``session_wipe`` (table clear), ``clock_jump`` (TTL-clock skew),
  ``snapshot_corrupt``/``snapshot_truncate`` (spool mangling via
  :meth:`FaultPlane.mangle`), ``breaker_trip`` (a synthetic failure fed to
  the circuit breaker), ``lease_steal`` (a contending sibling lease
  planted under an in-flight adoption — the exactly-one-owner adversary).

A misconfigured schedule raises ``ValueError`` at construction: chaos is
explicitly opted into, and a typo that silently no-ops would report a
green run that tested nothing.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..events import Event
from ..metrics import (
    FAULT_KINDS,
    FAULT_RECOVERY_OUTCOMES,
    FAULT_SITES,
    FAULTS_INJECTED,
    FAULTS_RECOVERED,
    Registry,
    registry as default_registry,
)
from ..utils.clock import Clock

#: kinds that raise at the choke point (everything else returns an Effect)
RAISE_KINDS = ("device_hang", "dispatch_exc", "rpc_unavailable", "rpc_reset")

#: which sites actually ENACT each kind (the reference's catalog).
#: Validated at parse time: ``slow_fence@dispatch`` would construct fine
#: and then silently never fire — exactly the green-run-that-tested-
#: nothing outcome the fail-loud contract below exists to prevent.
KIND_SITES = {
    "device_hang": ("fence",),
    "dispatch_exc": ("dispatch", "delta_step", "delta_commit", "adopt"),
    "slow_fence": ("fence",),
    "slow_step": ("delta_step",),
    "rpc_unavailable": ("transport",),
    "rpc_reset": ("transport",),
    "session_wipe": ("session_table",),
    "clock_jump": ("session_table",),
    "snapshot_corrupt": ("snapshot_write",),
    "snapshot_truncate": ("snapshot_write",),
    "breaker_trip": ("breaker",),
    "lease_steal": ("adopt",),
}

#: default ``value=`` per kind (seconds, or keep-fraction for truncate)
_DEFAULT_VALUES = {
    "slow_fence": 0.05,
    "slow_step": 0.05,
    "clock_jump": 3600.0,
    "snapshot_truncate": 0.5,
    # lease_steal@adopt: how long the injected contending lease is valid
    # for — the adoption under test must observe a sibling's UNEXPIRED
    # claim and refuse (the exactly-one-owner adversary)
    "lease_steal": 3600.0,
}


class InjectedFault(RuntimeError):
    """A plane-injected failure with no more specific production type
    (``dispatch_exc``).  Carries kind + site so recovery paths and tests
    can tell injected failures from organic ones."""

    def __init__(self, kind: str, site: str, occurrence: int) -> None:
        super().__init__(f"injected fault {kind}@{site} (call #{occurrence})")
        self.kind = kind
        self.site = site
        self.occurrence = occurrence


#: lazily-built ``grpc.RpcError`` subclass — built on first use so the
#: solver-side sites don't pull grpc into every import of this module
#: (the plane is threaded through TpuSolver too)
_rpc_error_cls = None


def _rpc_error_class():
    global _rpc_error_cls
    if _rpc_error_cls is None:
        import grpc

        class InjectedRpcError(grpc.RpcError):
            """A transport fault that IS a ``grpc.RpcError``: client code
            catching ``grpc.RpcError`` and switching on ``code()`` handles
            the injection through exactly its production path."""

            def __init__(self, kind: str, site: str,
                         occurrence: int) -> None:
                super().__init__(
                    f"injected {kind}@{site} (call #{occurrence})")
                self.kind = kind
                self.site = site
                self.occurrence = occurrence

            def code(self):
                return grpc.StatusCode.UNAVAILABLE

            def details(self) -> str:
                return str(self)

        _rpc_error_cls = InjectedRpcError
    return _rpc_error_cls


def __getattr__(name):  # PEP 562: `InjectedRpcError` resolves lazily
    if name == "InjectedRpcError":
        return _rpc_error_class()
    raise AttributeError(name)


@dataclass
class Effect:
    """An effect-kind firing the call site enacts (sleep, wipe, skew...)."""

    kind: str
    site: str
    value: float = 0.0
    occurrence: int = 0


@dataclass
class _Rule:
    kind: str
    site: str
    at: Optional[int] = None
    every: Optional[int] = None
    p: Optional[float] = None
    limit: Optional[int] = None
    value: Optional[float] = None
    fired: int = field(default=0)

    def matches(self, n: int, rng: random.Random) -> bool:
        if self.limit is not None and self.fired >= self.limit:
            return False
        if self.at is not None:
            return n == self.at
        if self.every is not None:
            return n % self.every == 0
        if self.p is not None:
            return rng.random() < self.p
        return True


def _parse(spec: str):
    seed = 0
    rules: List[_Rule] = []
    for token in (t.strip() for t in spec.split(";")):
        if not token:
            continue
        if token.startswith("seed="):
            seed = int(token[5:])
            continue
        head, _, opts = token.partition(":")
        kind, sep, site = head.partition("@")
        if not sep or kind not in FAULT_KINDS or site not in FAULT_SITES:
            raise ValueError(
                f"KT_FAULTS: bad rule {token!r} (want kind@site with kind "
                f"in {FAULT_KINDS} and site in {FAULT_SITES})")
        if site not in KIND_SITES[kind]:
            raise ValueError(
                f"KT_FAULTS: {kind!r} is not enacted at site {site!r} "
                f"(it fires at {KIND_SITES[kind]}) — a rule that can "
                "never fire would report a green chaos run that tested "
                "nothing")
        rule = _Rule(kind=kind, site=site)
        for opt in (o for o in opts.split(":") if o):
            key, eq, val = opt.partition("=")
            if not eq:
                raise ValueError(f"KT_FAULTS: bad option {opt!r} in {token!r}")
            if key == "at":
                rule.at = int(val)
            elif key == "every":
                rule.every = int(val)
            elif key == "p":
                rule.p = float(val)
            elif key == "n":
                rule.limit = int(val)
            elif key == "value":
                rule.value = float(val)
            else:
                raise ValueError(
                    f"KT_FAULTS: unknown option {key!r} in {token!r}")
        if rule.at is not None and rule.limit is None:
            rule.limit = 1
        rules.append(rule)
    return seed, rules


class NullPlane:
    """The production plane: falsy, every method a no-op.  Hot sites guard
    with ``if self._faults:`` so the disabled cost is one bool check."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def fire(self, site: str):
        return None

    def mangle(self, site: str, data: bytes) -> bytes:
        return data

    def sleep(self, effect) -> None:
        pass

    def stats(self) -> dict:
        return {}


NULL_PLANE = NullPlane()


class FaultPlane:
    """One parsed KT_FAULTS schedule with per-site occurrence counters.

    Components construct their own plane at init (``faults.plane()``), so
    a component's site counters are deterministic over ITS call sequence
    regardless of what other components do — the property that makes a
    seeded schedule replayable.  Thread-safe: the dispatcher, RPC threads,
    and the snapshot writer can all fire concurrently."""

    enabled = True

    def __init__(self, spec: str, registry: Optional[Registry] = None,
                 clock: Optional[Clock] = None, flight=None) -> None:
        self.registry = registry or default_registry
        self.clock = clock or Clock()
        self.flight = flight
        self.seed, self._rules = _parse(spec)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._count: Dict[str, int] = {}     # guarded-by: _lock
        # zero-init the (kind, site) series this schedule can produce, and
        # the recovery population for its sites (KT003: the first injected
        # fault of a chaos run must survive rate()/increase())
        inj = self.registry.counter(FAULTS_INJECTED)
        for rule in self._rules:
            if not inj.has({"kind": rule.kind, "site": rule.site}):
                inj.inc({"kind": rule.kind, "site": rule.site}, value=0.0)
        zero_init_recovery(self.registry)

    def __bool__(self) -> bool:
        return True

    def fire(self, site: str):
        """One choke-point call: bump the site counter, fire the first
        matching rule.  Raise kinds raise; effect kinds return an
        :class:`Effect`; no match returns None."""
        with self._lock:
            n = self._count[site] = self._count.get(site, 0) + 1
            hit = None
            for rule in self._rules:
                if rule.site == site and rule.matches(n, self._rng):
                    rule.fired += 1
                    hit = rule
                    break
        if hit is None:
            return None
        self.registry.counter(FAULTS_INJECTED).inc(
            {"kind": hit.kind, "site": site})
        if self.flight is not None:
            self.flight.add_event(Event(
                kind="Fault", name=site, reason="FaultInjected",
                message=f"{hit.kind}@{site} (call #{n})",
                event_type="Warning"))
        if hit.kind in RAISE_KINDS:
            if hit.kind == "device_hang":
                from ..solver.guard import DeviceHang

                raise DeviceHang(
                    f"injected device_hang@{site} (call #{n})")
            if hit.kind in ("rpc_unavailable", "rpc_reset"):
                raise _rpc_error_class()(hit.kind, site, n)
            raise InjectedFault(hit.kind, site, n)
        value = hit.value if hit.value is not None else _DEFAULT_VALUES.get(
            hit.kind, 0.0)
        return Effect(kind=hit.kind, site=site, value=value, occurrence=n)

    def mangle(self, site: str, data: bytes) -> bytes:
        """Spool-byte adversary: fire the site; enact snapshot_corrupt
        (deterministic byte flips) or snapshot_truncate (cut to the
        keep-fraction) on the way to disk.  Other effects pass through."""
        effect = self.fire(site)
        if effect is None or not data:
            return data
        if effect.kind == "snapshot_corrupt":
            buf = bytearray(data)
            with self._lock:
                for _ in range(max(1, len(buf) // 512)):
                    buf[self._rng.randrange(len(buf))] ^= 0xFF
            return bytes(buf)
        if effect.kind == "snapshot_truncate":
            keep = effect.value if 0.0 < effect.value < 1.0 else 0.5
            return data[:max(1, int(len(data) * keep))]
        return data

    def sleep(self, effect: Effect) -> None:
        """Enact a latency effect (slow_fence / slow_step) on the plane's
        injectable clock."""
        if effect.value > 0:
            self.clock.sleep(effect.value)

    def stats(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "site_calls": dict(self._count),
                "fired": {f"{r.kind}@{r.site}": r.fired for r in self._rules},
            }


def faults_enabled() -> bool:
    return bool(os.environ.get("KT_FAULTS", ""))


def plane(registry: Optional[Registry] = None,
          clock: Optional[Clock] = None, flight=None):
    """The component-construction entry: parse KT_FAULTS into a live
    plane, or hand back the shared zero-cost null plane (default)."""
    spec = os.environ.get("KT_FAULTS", "")
    if not spec:
        return NULL_PLANE
    return FaultPlane(spec, registry=registry, clock=clock, flight=flight)


def count_recovery(registry: Registry, site: str, outcome: str) -> None:
    """The recovery-outcome funnel: every recovering ``except`` on a
    faultable path reports what happened.  Counted for
    REAL faults too — the series is live in production even though the
    injection plane is the null one."""
    registry.counter(FAULTS_RECOVERED).inc(
        {"site": site, "outcome": outcome})


def zero_init_recovery(registry: Registry) -> None:
    """Register the full site x outcome recovery population at 0
    (KT003)."""
    rec = registry.counter(FAULTS_RECOVERED)
    for site in FAULT_SITES:
        for outcome in FAULT_RECOVERY_OUTCOMES:
            if not rec.has({"site": site, "outcome": outcome}):
                rec.inc({"site": site, "outcome": outcome}, value=0.0)


#: module RNG behind :func:`jitter` — seeded so chaos runs replay; reseeded
#: by tests that pin backoff sequences
_JITTER_RNG = random.Random(0x4B54)


def jitter() -> float:
    """Uniform [0, 1) from the faults facade — the ONE sanctioned
    randomness source for serving-path code (retry backoff jitter)."""
    return _JITTER_RNG.random()


__all__ = [
    "FAULT_KINDS", "FAULT_RECOVERY_OUTCOMES", "FAULT_SITES", "Effect",
    "FaultPlane", "InjectedFault", "InjectedRpcError", "NULL_PLANE",
    "NullPlane", "count_recovery", "faults_enabled", "jitter", "plane",
    "zero_init_recovery",
]
