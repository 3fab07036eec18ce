"""Observability HTTP surface: /tracez, /statusz, JSON trace export — the
port of the reference package's ``obs/export.py``.

``tracez``/``statusz`` build the JSON documents; :func:`serve` runs a tiny
HTTP server over them for the solver sidecar (the operator mounts the same
documents on its existing metrics server), and :func:`render_tracez` renders
a terminal snapshot for ``make obs-demo``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from ..metrics import (
    ADMISSION_ADMITTED,
    ADMISSION_BREAKER_STATE,
    ADMISSION_BROWNOUT_LEVEL,
    ADMISSION_QUEUE_DEPTH,
    ADMISSION_SHED,
    DELTA_EVICTIONS,
    DELTA_SESSIONS,
    FAULTS_INJECTED,
    FAULTS_RECOVERED,
    FLEET_ENDPOINTS,
    FLEET_FAILOVERS,
    FLIGHT_DUMPS,
    INFLIGHT_DEPTH,
    SESSION_ADOPTIONS,
    SESSION_LEASES,
    SNAPSHOT_RESTORE,
    SNAPSHOT_SESSIONS,
    SNAPSHOT_SKIPPED,
    SNAPSHOT_WRITES,
    REMOTE_DEGRADED,
    SOLVER_COLD_FALLBACKS,
    SOLVER_COMPILE_IN_PROGRESS,
    SOLVER_DEGRADED_SOLVES,
    SOLVER_DEVICE_HANGS,
    SOLVER_DEVICE_HEALTHY,
    TENSORIZE_CACHE_HITS,
    TENSORIZE_CACHE_MISSES,
    TRACE_TRACES,
    Registry,
)
from ..metrics import DELTA_RPC
from .recorder import ANOMALY_REASONS, FlightRecorder
from .trace import replica_id

_BREAKER_STATES = {0.0: "closed", 1.0: "half_open", 2.0: "open"}


def tracez(flight: FlightRecorder, limit: int = 50) -> dict:
    """Recent traces (newest first, full span trees) + per-span p50/p99."""
    traces = flight.traces()
    return {
        "count": len(traces),
        "spans": flight.span_stats(),
        "traces": [t.to_dict() for t in reversed(traces[-limit:])],
    }


def _series(metric, label: str) -> dict:
    """{label-value: sample} for a single-label metric family."""
    out = {}
    for lkey, v in metric.values.items():
        labels = dict(lkey)
        out[labels.get(label, "")] = v
    return out


def statusz(registry: Registry, flight: Optional[FlightRecorder] = None,
            extra: Optional[Callable[[], dict]] = None) -> dict:
    """One-page operational snapshot: backend health, cache hit rates,
    inflight depth, fallback counters, flight-recorder state.  ``extra``
    is the serving layer's provider hook (SolverService.statusz_extra:
    the per-session block + the service's replica identity) — merged
    last, so the serving layer can extend the document without obs/
    importing service/."""
    hits = _series(registry.counter(TENSORIZE_CACHE_HITS), "tier")
    n_hits = sum(hits.values())
    n_miss = registry.counter(TENSORIZE_CACHE_MISSES).get()
    total = n_hits + n_miss
    doc = {
        # which replica answered (fleet merges key on it); the flight
        # recorder's construction-time identity when one is attached,
        # else the process identity
        "replica_id": (flight.replica if flight is not None
                       else replica_id()),
        "device": {
            "healthy": registry.gauge(SOLVER_DEVICE_HEALTHY).get() == 1.0,
            "hangs": registry.counter(SOLVER_DEVICE_HANGS).get(),
            "compiles_in_progress":
                registry.gauge(SOLVER_COMPILE_IN_PROGRESS).get(),
        },
        "tensorize_cache": {
            "hits": hits,
            "misses": n_miss,
            "hit_rate": round(n_hits / total, 4) if total else None,
        },
        "inflight_depth": _series(registry.gauge(INFLIGHT_DEPTH), "backend"),
        "fallbacks": {
            "cold": _series(registry.counter(SOLVER_COLD_FALLBACKS), "backend"),
            "degraded": _series(
                registry.counter(SOLVER_DEGRADED_SOLVES), "backend"),
            "remote_degraded": registry.gauge(REMOTE_DEGRADED).get() == 1.0,
        },
        "traces_recorded": registry.counter(TRACE_TRACES).get(),
    }
    shed = registry.counter(ADMISSION_SHED)
    if shed.values or registry.gauge(ADMISSION_QUEUE_DEPTH).values:
        # admission control is live (docs/ADMISSION.md): the overload view
        sheds_by_class: dict = {}
        for lkey, v in shed.values.items():
            labels = dict(lkey)
            if v:
                sheds_by_class.setdefault(
                    labels.get("class", ""), {})[labels.get("reason", "")] = v
        doc["admission"] = {
            "queued": _series(registry.gauge(ADMISSION_QUEUE_DEPTH), "class"),
            "admitted": _series(registry.counter(ADMISSION_ADMITTED), "class"),
            "shed": sheds_by_class,
            "breaker": _BREAKER_STATES.get(
                registry.gauge(ADMISSION_BREAKER_STATE).get(), "closed"),
            "brownout_level": registry.gauge(ADMISSION_BROWNOUT_LEVEL).get(),
        }
    inj = registry.counter(FAULTS_INJECTED)
    fired = {f"{dict(lk).get('kind', '')}@{dict(lk).get('site', '')}": v
             for lk, v in inj.values.items() if v}
    if fired:
        # a chaos schedule is live (KT_FAULTS): the injection scoreboard
        # + the recovery-outcome partition (docs/RESILIENCE.md)
        doc["faults"] = {
            "injected": fired,
            "recovered": {
                f"{dict(lk).get('site', '')}:{dict(lk).get('outcome', '')}": v
                for lk, v in
                registry.counter(FAULTS_RECOVERED).values.items() if v},
        }
    writes = registry.counter(SNAPSHOT_WRITES)
    if writes.values:
        # session durability is wired (the table zero-inits the family):
        # spool write/restore outcomes + the last snapshot's size
        doc["session_snapshot"] = {
            "writes": _series(writes, "outcome"),
            "restore": _series(registry.counter(SNAPSHOT_RESTORE),
                               "outcome"),
            "skipped": _series(registry.counter(SNAPSHOT_SKIPPED),
                               "reason"),
            "last_sessions": registry.gauge(SNAPSHOT_SESSIONS).get(),
        }
    rpc = registry.counter(DELTA_RPC)
    if rpc.values:
        # delta serving is live (the table zero-inits the family): the
        # per-outcome partition — /fleetz sums these across replicas
        doc["delta_rpc"] = _series(rpc, "outcome")
    adoptions = registry.counter(SESSION_ADOPTIONS)
    endpoints = registry.gauge(FLEET_ENDPOINTS)
    if any(adoptions.values.values()) or endpoints.values \
            or registry.gauge(SESSION_LEASES).get():
        # the fleet dimension is live (docs/RESILIENCE.md):
        # server-side session ownership (owned/adopted/drained + lease
        # state) and, on a client-embedding process, the endpoint set
        doc["fleet"] = {
            "sessions_owned": registry.gauge(DELTA_SESSIONS).get(),
            "leases_owned": registry.gauge(SESSION_LEASES).get(),
            "adoptions": {k: v for k, v in
                          _series(adoptions, "outcome").items() if v},
            "sessions_drained": registry.counter(DELTA_EVICTIONS).get(
                {"reason": "drain"}),
            "lease_lost": registry.counter(DELTA_EVICTIONS).get(
                {"reason": "lease_lost"}),
        }
        if endpoints.values:
            doc["fleet"]["endpoints"] = _series(endpoints, "state")
            doc["fleet"]["failovers"] = _series(
                registry.counter(FLEET_FAILOVERS), "reason")
    if flight is not None:
        doc["flight_recorder"] = {
            "ring": len(flight.traces()),
            "capacity": flight.capacity,
            "events": len(flight.events()),
            "dumps": {
                r: flight.registry.counter(FLIGHT_DUMPS).get({"reason": r})
                for r in ANOMALY_REASONS
            },
            "last_dump": (
                {k: flight.last_dump()[k] for k in ("seq", "reason", "detail", "at")}
                if flight.last_dump() else None
            ),
        }
    if extra is not None:
        try:
            doc.update(extra() or {})
        # ktlint: allow[KT005] a failing provider must not take /statusz
        # down — the page is the thing an operator reads DURING incidents
        except Exception:  # noqa: BLE001
            doc["extra_error"] = "statusz extra provider raised"
    return doc


def render_tracez(flight: FlightRecorder, limit: int = 8) -> str:
    """Terminal snapshot of /tracez (``make obs-demo``)."""
    lines = ["== /tracez =="]
    stats = flight.span_stats()
    if stats:
        lines.append(f"{'span':<16} {'n':>5} {'p50_ms':>10} {'p99_ms':>10} "
                     f"{'max_ms':>10}")
        for name, s in stats.items():
            lines.append(f"{name:<16} {s['n']:>5} {s['p50_ms']:>10.3f} "
                         f"{s['p99_ms']:>10.3f} {s['max_ms']:>10.3f}")
    traces = flight.traces()
    lines.append(f"-- last {min(limit, len(traces))} of {len(traces)} "
                 "trace(s) --")

    def walk(d: dict, depth: int) -> None:
        dur = d.get("duration_ms")
        attrs = d.get("attrs") or {}
        a = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        lines.append(
            f"  {'  ' * depth}{d['name']:<{max(2, 18 - 2 * depth)}} "
            f"{'open' if dur is None else f'{dur:9.3f}ms'}"
            + (f"  [{a}]" if a else ""))
        for c in d.get("spans", ()):
            walk(c, depth + 1)

    for tr in reversed(traces[-limit:]):
        d = tr.to_dict()
        lines.append(f"{d['trace_id']}:")
        walk(d, 0)
    return "\n".join(lines)


def serve(registry: Registry, flight: FlightRecorder, port: int = 0,
          host: str = "127.0.0.1",
          extra: Optional[Callable[[], dict]] = None,
          peers: Optional[list] = None,
          sloz: Optional[Callable[[], dict]] = None,
          tunez: Optional[Callable[[], dict]] = None,
          ) -> "tuple[ThreadingHTTPServer, int]":
    """Start the sidecar observability server: /tracez, /statusz,
    /metrics, /fleetz, /sloz, /tunez.  ``extra`` extends /statusz (the
    serving layer's session block); ``peers`` are sibling obs base URLs
    for the /fleetz fan-out (default ``KT_OBS_PEERS``, comma-separated —
    include THIS replica's own URL so the merged view is whole);
    ``sloz`` is the serving layer's SLO-document provider
    (SolverService.sloz — the burn-rate evaluation) and ``tunez`` the
    self-tuning view provider (SolverService.tunez — live knob table +
    controller decision ring), each 404 when absent so old callers see
    exactly the pre-SLO/pre-tuning surface.  Returns (server,
    bound_port); ``server.shutdown()`` stops it."""
    from .fleet import zero_init as _fleet_zero_init

    _fleet_zero_init(registry)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # silence
            pass

        def do_GET(self):
            ctype = "application/json"
            if self.path.startswith("/tracez"):
                body = json.dumps(tracez(flight), default=str).encode()
                code = 200
            elif self.path.startswith("/statusz"):
                body = json.dumps(statusz(registry, flight, extra=extra),
                                  default=str).encode()
                code = 200
            elif self.path.startswith("/sloz"):
                if sloz is None:
                    body, code = b'{"error": "slo engine not wired"}', 404
                else:
                    body = json.dumps(sloz(), default=str).encode()
                    code = 200
            elif self.path.startswith("/tunez"):
                if tunez is None:
                    body, code = b'{"error": "tuning not wired"}', 404
                else:
                    body = json.dumps(tunez(), default=str).encode()
                    code = 200
            elif self.path.startswith("/fleetz"):
                from .fleet import env_peers, fleetz

                body = json.dumps(
                    fleetz(peers if peers is not None else env_peers(),
                           local=(registry, flight, extra, sloz)),
                    default=str).encode()
                code = 200
            elif self.path.startswith("/metrics"):
                body, ctype, code = registry.expose().encode(), "text/plain", 200
            else:
                body, code = b'{"error": "not found"}', 404
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    bound = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="obs-http").start()
    return server, bound
