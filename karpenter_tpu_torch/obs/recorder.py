"""Black-box flight recorder.

An aircraft-style recorder for the solve path: a bounded ring of the last N
finished traces plus recent events and counter deltas, held in memory at all
times and **dumped automatically on anomalies** — a hang-guard trip, a
degraded solve, a trace blowing its latency budget, a sanitizer error — so
the minutes *before* a production incident are explainable after the fact
without having had debug logging on.

Everything is bounded: the trace ring (``KT_FLIGHT_TRACES``), the event
ring (``KT_FLIGHT_EVENTS``), and the kept dumps.  Dumps are rate-limited
per reason (``min_dump_interval_s``) so a sustained outage produces one
dump per interval, not one per degraded solve.  When ``KT_FLIGHT_DIR`` is
set each dump is also written as JSON for post-mortem collection.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from collections import deque
from typing import Dict, List, Optional

from ..metrics import (
    FLIGHT_DUMPS,
    TRACE_RING_EVICTIONS,
    Registry,
    registry as default_registry,
)
from ..utils.clock import Clock
from .trace import replica_id

logger = logging.getLogger(__name__)

#: the anomaly vocabulary; unknown reasons are folded into "other" so the
#: `reason` label set stays bounded (and KT003-zero-initable)
ANOMALY_REASONS = ("device_hang", "degraded_solve", "budget_breach",
                   "sanitizer_error", "other")


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


class FlightRecorder:
    """Bounded ring of recent traces/events with anomaly-triggered dumps."""

    def __init__(
        self,
        capacity: Optional[int] = None,
        events_capacity: Optional[int] = None,
        clock: Optional[Clock] = None,
        registry: Optional[Registry] = None,
        dump_dir: Optional[str] = None,
        slow_trace_s: Optional[float] = None,
        dump_capacity: int = 8,
        min_dump_interval_s: float = 30.0,
    ) -> None:
        if capacity is None:
            capacity = int(os.environ.get("KT_FLIGHT_TRACES", "64"))
        if events_capacity is None:
            events_capacity = int(os.environ.get("KT_FLIGHT_EVENTS", "256"))
        if dump_dir is None:
            dump_dir = os.environ.get("KT_FLIGHT_DIR", "")
        if slow_trace_s is None:
            slow_trace_s = float(os.environ.get("KT_TRACE_SLOW_S", "30.0"))
        self.capacity = max(1, capacity)
        self.clock = clock or Clock()
        self.registry = registry or default_registry
        self.dump_dir = dump_dir
        #: which replica this recorder belongs to (ISSUE 15): stamped on
        #: every dump envelope AND its KT_FLIGHT_DIR file name, so a
        #: fleet sharing one dump volume never interleaves (or clobbers)
        #: two replicas' dumps, and offline correlation can join a dump
        #: to its /fleetz hop.  Captured at construction, like the
        #: session table's lease identity.
        self.replica = replica_id()
        self.slow_trace_s = slow_trace_s
        self.min_dump_interval_s = min_dump_interval_s
        self._lock = threading.Lock()
        self._traces: deque = deque(maxlen=self.capacity)   # guarded-by: _lock
        self._events: deque = deque(maxlen=max(1, events_capacity))  # guarded-by: _lock
        self._dumps: deque = deque(maxlen=max(1, dump_capacity))  # guarded-by: _lock
        self._last_dump_at: Dict[str, float] = {}           # guarded-by: _lock
        #: dump times inside the current interval — the GLOBAL storm cap:
        #: per-(reason, replica, session) keys stop distinct incidents
        #: suppressing each other, but a fleet-wide outage touching N
        #: sessions must still produce a bounded number of ring
        #: snapshots per interval, not N  # guarded-by: _lock
        self._recent_dumps: deque = deque()
        self.max_dumps_per_interval = 4
        self._n_dumped = 0                                  # guarded-by: _lock
        # zero-init every reason series + the eviction counter so the first
        # incident of each kind survives rate()/increase() (KT003)
        for reason in ANOMALY_REASONS:
            self.registry.counter(FLIGHT_DUMPS).inc(
                {"reason": reason}, value=0.0)
        self.registry.counter(TRACE_RING_EVICTIONS).inc(value=0.0)
        self._metrics_mark = self._counter_snapshot()

    # ---- intake ---------------------------------------------------------
    def add(self, trace) -> None:
        """Admit a finished trace (called by the tracer).  A trace past the
        latency budget triggers a ``budget_breach`` dump carrying it."""
        with self._lock:
            if len(self._traces) == self._traces.maxlen:
                self.registry.counter(TRACE_RING_EVICTIONS).inc()
            self._traces.append(trace)
        if self.slow_trace_s > 0 and trace.duration_s > self.slow_trace_s:
            self.anomaly(
                "budget_breach",
                detail=f"trace {trace.trace_id} ({trace.name}) ran "
                       f"{trace.duration_s:.3f}s > budget "
                       f"{self.slow_trace_s:.1f}s",
                trace=trace,
            )

    def add_event(self, event) -> None:
        """Event-recorder sink hook (``events.Recorder(sink=flight.add_event)``)."""
        with self._lock:
            self._events.append(event)

    # ---- introspection --------------------------------------------------
    def traces(self) -> list:
        with self._lock:
            return list(self._traces)

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def dumps(self) -> list:
        with self._lock:
            return list(self._dumps)

    def last_dump(self) -> Optional[dict]:
        with self._lock:
            return self._dumps[-1] if self._dumps else None

    def span_stats(self) -> Dict[str, dict]:
        """Per-span-name {n, p50_ms, p99_ms, max_ms} over the ring — the
        /tracez summary table."""
        durations: Dict[str, List[float]] = {}
        for tr in self.traces():
            for sp in tr.spans():
                if sp.done:
                    durations.setdefault(sp.name, []).append(
                        sp.duration_s * 1000.0)
        out: Dict[str, dict] = {}
        for name, vals in sorted(durations.items()):
            vals.sort()
            out[name] = {
                "n": len(vals),
                "p50_ms": round(_percentile(vals, 0.50), 3),
                "p99_ms": round(_percentile(vals, 0.99), 3),
                "max_ms": round(vals[-1], 3),
            }
        return out

    # ---- anomaly dumps --------------------------------------------------
    def anomaly(self, reason: str, detail: str = "", trace=None,
                session_id: str = "") -> Optional[dict]:
        """Record an anomaly: snapshot the ring (traces + events + counter
        deltas since the last dump) into a dump dict, count it, keep it,
        and write it to ``dump_dir`` when configured.  ``trace`` is the
        in-flight trace at the anomaly site (serialized mid-solve — open
        spans carry ``end: null``); ``session_id`` attributes the dump to
        a delta session when the site knows one.  Returns the dump, or
        None when rate-limited — the rate key is (reason, replica,
        session), so two replicas sharing a recorder (or two sessions'
        distinct incidents) never suppress each other's first dump,
        while a GLOBAL cap (``max_dumps_per_interval``) keeps a
        fleet-wide outage touching N sessions at a bounded number of
        ring snapshots per interval, not N."""
        label = reason if reason in ANOMALY_REASONS else "other"
        # a trace that crossed the wire knows its session even when the
        # anomaly site did not pass one
        if not session_id and trace is not None:
            root_attrs = getattr(getattr(trace, "root", None),
                                 "attrs", None) or {}
            session_id = str(root_attrs.get("session_id", "") or "")
        rate_key = f"{label}|{self.replica}|{session_id}"
        now = self.clock.now()
        with self._lock:
            # stale keys can never suppress again — pruning here bounds
            # the map at (dumps within one interval), not (sessions ever
            # seen by a long-lived server)
            stale = [k for k, t in self._last_dump_at.items()
                     if now - t >= self.min_dump_interval_s]
            for k in stale:
                del self._last_dump_at[k]
            while self._recent_dumps and \
                    now - self._recent_dumps[0] >= self.min_dump_interval_s:
                self._recent_dumps.popleft()
            if rate_key in self._last_dump_at:
                return None
            if len(self._recent_dumps) >= self.max_dumps_per_interval:
                return None
            self._last_dump_at[rate_key] = now
            self._recent_dumps.append(now)
            self._n_dumped += 1
            seq = self._n_dumped
            traces = [t.to_dict() for t in self._traces]
            events = [
                {"kind": e.kind, "name": e.name, "reason": e.reason,
                 "message": e.message, "type": e.event_type}
                for e in self._events
            ]
            mark = self._metrics_mark
        snap = self._counter_snapshot()
        deltas = self._deltas(mark, snap)
        dump = {
            "seq": seq,
            "reason": label,
            "detail": detail,
            "at": now,
            "replica_id": self.replica,
            "session_id": session_id,
            "trace": trace.to_dict() if trace is not None else None,
            "traces": traces,
            "events": events,
            "counter_deltas": deltas,
        }
        with self._lock:
            self._metrics_mark = snap
            self._dumps.append(dump)
        self.registry.counter(FLIGHT_DUMPS).inc({"reason": label})
        logger.warning("flight recorder dump #%d (%s): %s — %d trace(s), "
                       "%d event(s)", seq, label, detail or "-",
                       len(traces), len(events))
        path = self._write(dump)
        if path:
            dump["path"] = path
        return dump

    def _write(self, dump: dict) -> str:
        if not self.dump_dir:
            return ""
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            # replica-qualified name: two replicas sharing one dump
            # volume have independent seq counters, so an unqualified
            # name would silently overwrite the sibling's dump
            path = os.path.join(
                self.dump_dir,
                f"flight-{dump['replica_id']}-{dump['seq']:04d}-"
                f"{dump['reason']}.json")
            with open(path, "w") as f:
                json.dump(dump, f, indent=2, default=str)
            return path
        except OSError as err:
            logger.warning("flight recorder dump not written to %s: %s",
                           self.dump_dir, err)
            return ""

    # ---- counter deltas -------------------------------------------------
    def _counter_snapshot(self) -> Dict[str, Dict[tuple, float]]:
        # list() first: another thread first-using a counter family resizes
        # registry.counters mid-iteration (the registry is lock-free by
        # design; a snapshot taken during a solve burst must tolerate it)
        return {name: dict(c.values)
                for name, c in list(self.registry.counters.items())}

    @staticmethod
    def _deltas(mark, snap) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, series in snap.items():
            old = mark.get(name, {})
            for lkey, v in series.items():
                d = v - old.get(lkey, 0.0)
                if d:
                    lbl = ",".join(f'{k}="{val}"' for k, val in lkey)
                    out[f"{name}{{{lbl}}}" if lbl else name] = d
        return out
