"""Trace-replay harness — recorded or synthetic traffic through the real
gRPC stack: the port of the reference package's ``obs/replay.py``.

The self-tuning controller the roadmap wants cannot be bench-gated
against uniform load: the knobs it tunes (coalescer wait/slots, brownout
thresholds) only matter under traffic that looks like production —
bursts, diurnal swings, session churn.  This module closes that gap with
three pieces:

- **Capture** — a versioned JSONL format holding per-request SHAPES
  (arrival offset, priority class, pod-count, churn size, session
  membership), never payloads.  :func:`capture_from_traces` derives a
  capture from live trace trees (the flight recorder ring / a ``/tracez``
  document — the root attrs the tracer already stamps carry everything
  needed), :func:`synthesize` generates bursty / diurnal / uniform
  shapes from a seed.
- **Replay** — :class:`Replayer` drives a capture through a real solver
  endpoint over gRPC at a programmable ``speedup``: session records ride
  a real :class:`~karpenter_tpu_torch.service.client.DeltaSession` (chain
  order preserved by a per-session serial worker), classic solves a
  shared pool, and every request's scheduled-vs-actual send lag is
  observed into ``karpenter_replay_lag_seconds``.
- **Fidelity** — :func:`fidelity` compares the replayed inter-arrival
  distribution and class mix against the capture, so ``bench.py``'s
  ``measure_replay_fidelity`` can GATE that the harness reproduces the
  traffic it claims to (a replay that silently serializes into uniform
  load would bless knob settings against the wrong workload).

Wire-level tracing rides for free: the sessions the replayer drives are
ordinary ``DeltaSession``\\ s, so every replayed request propagates trace
context and the replayed fleet's ``/fleetz`` shows real journeys.
"""

from __future__ import annotations

import json
import math
import os
import queue
import random
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..metrics import (
    REPLAY_LAG,
    REPLAY_OUTCOMES,
    REPLAY_REQUESTS,
    Registry,
    registry as default_registry,
)
from ..utils.clock import Clock
from .recorder import _percentile

CAPTURE_KIND = "kt-replay-capture"
CAPTURE_VERSION = 1

#: request-shape record fields (the JSONL schema, docs/OBSERVABILITY.md):
#: t (arrival offset, seconds), kind (establish|delta|solve), class
#: (priority class, "" = server default), n_pods, churn, session
RECORD_FIELDS = ("t", "kind", "class", "n_pods", "churn", "session")


class ReplayCaptureError(Exception):
    """A capture file failed the envelope checks (wrong kind, version
    skew, malformed records) — typed so callers refuse loudly instead of
    replaying garbage traffic into a gate."""


# ---------------------------------------------------------------------------
# capture: record + synthesize + persist
# ---------------------------------------------------------------------------


def capture_from_traces(traces: Iterable[dict]) -> List[dict]:
    """Derive a capture from trace trees (``/tracez`` ``traces`` entries
    or ``FlightRecorder.traces()`` after ``to_dict()``): every root with
    an ``rpc`` attr is one request, its attrs carry the shape.  Offsets
    re-base to the first arrival."""
    rows = []
    for tr in traces:
        attrs = tr.get("attrs") or {}
        if "rpc" not in attrs:
            continue
        session = str(attrs.get("session_id", "") or "")
        delta = bool(attrs.get("delta", False))
        rows.append({
            "t": float(tr.get("start") or 0.0),
            "kind": ("delta" if delta
                     else "establish" if session else "solve"),
            "class": str(attrs.get("priority_class", "") or ""),
            "n_pods": int(attrs.get("n_pods", 0) or 0),
            "churn": int(attrs.get("n_pods", 0) or 0) if delta else 0,
            "session": session,
        })
    rows.sort(key=lambda r: r["t"])
    if rows:
        t0 = rows[0]["t"]
        for r in rows:
            r["t"] = round(r["t"] - t0, 6)
    return rows


#: the synthetic capture presets ``--synthesize --shape`` accepts
SHAPES = ("uniform", "bursty", "diurnal", "burst-train")


def synthesize(n: int = 120, shape: str = "bursty", seed: int = 7,
               mean_rate: float = 50.0, n_pods: int = 40, churn: int = 4,
               sessions: int = 4,
               class_mix: Optional[Dict[str, float]] = None,
               classic_frac: float = 0.25,
               period: Optional[float] = None,
               amplitude: Optional[float] = None) -> List[dict]:
    """Generate a synthetic capture: ``n`` requests whose inter-arrivals
    follow ``shape`` — 'uniform' (Poisson at ``mean_rate``/s), 'bursty'
    (Markov-modulated: ``amplitude``x bursts alternating with 1/4x
    lulls at random flip times, the flash-crowd adversary), 'diurnal'
    (sinusoidal rate over ``period``, the daily cycle compressed),
    'burst-train' (deterministic square wave: ``amplitude``x on-phase
    for 30% of each ``period``, 0.1x trough otherwise — the canonical
    tuning/SLO-judgment shape: every run of a seed sees the identical
    burst schedule).  ``period`` defaults to one cycle over the capture
    span; ``amplitude`` defaults to 8 (peak-rate multiplier).
    ``classic_frac`` of requests are sessionless solves; the rest
    spread over ``sessions`` delta sessions (first touch establishes).
    Deterministic per seed."""
    if shape not in SHAPES:
        raise ValueError(f"unknown shape {shape!r}")
    mix = class_mix or {"batch": 0.7, "critical": 0.2, "best_effort": 0.1}
    classes, weights = zip(*sorted(mix.items()))
    rng = random.Random(seed)
    t = 0.0
    established: set = set()
    rows: List[dict] = []
    # first pass flips immediately (t >= next_flip), so the capture
    # OPENS with a burst — the flash-crowd front the shape advertises
    burst = False
    next_flip = 0.0
    if period is None:
        period = max(1.0, n / mean_rate)  # one cycle over the capture span
    period = max(1e-3, float(period))
    amplitude = 8.0 if amplitude is None else max(1.0, float(amplitude))
    for i in range(n):
        if shape == "uniform":
            rate = mean_rate
        elif shape == "bursty":
            if t >= next_flip:
                burst = not burst
                next_flip = t + rng.uniform(0.05, 0.2) * period
            rate = mean_rate * (amplitude if burst else 0.25)
        elif shape == "burst-train":
            # deterministic square wave: on-phase the first 30% of each
            # period, trough the rest — the seeded regression shape
            # (same seed = the identical burst schedule every run)
            rate = mean_rate * (amplitude if (t % period) < 0.3 * period
                                else 0.1)
        else:  # diurnal
            rate = mean_rate * (
                0.25 + (amplitude / 8.0) * 0.75
                * (1.0 + math.sin(2 * math.pi * t / period)) / 2.0)
        t += rng.expovariate(max(rate, 1e-6))
        pclass = rng.choices(classes, weights=weights)[0]
        if rng.random() < classic_frac:
            rows.append({"t": round(t, 6), "kind": "solve",
                         "class": pclass, "n_pods": n_pods, "churn": 0,
                         "session": ""})
            continue
        sid = f"s{rng.randrange(sessions)}"
        kind = "delta" if sid in established else "establish"
        established.add(sid)
        rows.append({"t": round(t, 6), "kind": kind, "class": pclass,
                     "n_pods": n_pods if kind == "establish" else churn,
                     "churn": churn if kind == "delta" else 0,
                     "session": sid})
    return rows


def save_capture(path: str, records: List[dict], source: str = "synthetic",
                 meta: Optional[dict] = None) -> None:
    """Write the versioned JSONL capture: one header line (kind, version,
    source, count) then one record per line."""
    header = {"kind": CAPTURE_KIND, "version": CAPTURE_VERSION,
              "source": source, "count": len(records)}
    if meta:
        header["meta"] = meta
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for r in records:
            f.write(json.dumps({k: r.get(k) for k in RECORD_FIELDS}) + "\n")


def load_capture(path: str) -> Tuple[List[dict], dict]:
    """Read a capture; refuses (typed) anything that is not this format
    at this version — a silent best-effort parse of a wrong or newer
    file would replay the wrong traffic into a gate."""
    with open(path) as f:
        first = f.readline()
        try:
            header = json.loads(first)
        except json.JSONDecodeError as err:
            raise ReplayCaptureError(f"{path}: not a capture (bad header "
                                     f"JSON)") from err
        if header.get("kind") != CAPTURE_KIND:
            raise ReplayCaptureError(
                f"{path}: kind {header.get('kind')!r} is not "
                f"{CAPTURE_KIND!r}")
        if header.get("version") != CAPTURE_VERSION:
            raise ReplayCaptureError(
                f"{path}: capture version {header.get('version')!r} != "
                f"supported {CAPTURE_VERSION}")
        records = []
        for ln, line in enumerate(f, start=2):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as err:
                raise ReplayCaptureError(
                    f"{path}:{ln}: malformed record") from err
    records.sort(key=lambda r: float(r.get("t", 0.0)))
    return records, header


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


def default_pods_factory(n: int, tag: str):
    """Unconstrained churn pods (the bench's warm-start shape: a few
    deployment families, no topology) — replay captures carry SHAPES,
    so the payload is synthesized to match the pod count."""
    from ..models.pod import PodSpec

    out = []
    for i in range(n):
        g = i % 6
        out.append(PodSpec(
            name=f"{tag}-{i}", labels={"app": f"rp{g}"},
            requests={"cpu": 0.25 * (1 + g % 3),
                      "memory": (0.5 + g % 4) * 2**30},
            owner_key=f"rp{g}"))
    return out


class Replayer:
    """Drive a capture through a real solver endpoint at ``speedup``.

    One pacing loop sleeps each record to its scheduled send time
    (``t / speedup``) and hands it to its lane: session records go to a
    PER-SESSION serial worker (a ``DeltaSession`` is single-threaded by
    contract and chain order is the protocol), classic solves to a small
    shared pool.  The achieved send time is stamped when the request
    actually leaves — a session whose previous step is still in flight
    sends late and the fidelity report says so, it is never papered
    over.  Outcomes land in ``karpenter_replay_requests_total``; typed
    sheds count as 'shed', not errors — replayed traffic probing the
    server's admission posture is a result."""

    def __init__(self, target: str, provisioners=None, catalog=None,
                 registry: Optional[Registry] = None,
                 clock: Optional[Clock] = None,
                 pods_factory: Optional[Callable] = None,
                 timeout: float = 600.0, workers: int = 8,
                 session_pods: int = 40) -> None:
        self.target = target
        #: establishment size for sessions whose capture carries no
        #: establish record (a /tracez ring almost always starts
        #: MID-session): establishing from the delta record's churn-sized
        #: n_pods would replay a toy cluster and silently bless knobs
        #: against the wrong load, so implicit establishes use this (or
        #: the capture's own establish sizes when present) and are
        #: counted on the report as ``implicit_establishes``
        self.session_pods = max(1, session_pods)
        self.registry = registry or default_registry
        self.clock = clock or Clock()
        self.timeout = timeout
        self.workers = max(1, workers)
        self.pods_factory = pods_factory or default_pods_factory
        if provisioners is None:
            from ..models.provisioner import Provisioner

            provisioners = [Provisioner(name="default").with_defaults()]
        if catalog is None:
            from ..models.catalog import generate_catalog

            catalog = generate_catalog(full=False)
        self.provisioners = list(provisioners)
        self.catalog = list(catalog)
        req = self.registry.counter(REPLAY_REQUESTS)
        for outcome in REPLAY_OUTCOMES:
            if not req.has({"outcome": outcome}):
                req.inc({"outcome": outcome}, value=0.0)
        self.registry.histogram(REPLAY_LAG)
        self._lock = threading.Lock()
        #: [(virtual send offset, outcome, wall ms)]  # guarded-by: _lock
        self._sent: List[tuple] = []

    # ---- lanes ----------------------------------------------------------
    def _fire(self, record: dict, session, base: float,
              speedup: float, seq: int) -> None:
        sent_at = time.perf_counter() - base
        scheduled = float(record["t"]) / speedup
        self.registry.histogram(REPLAY_LAG).observe(
            max(0.0, sent_at - scheduled))
        t0 = time.perf_counter()
        outcome = "ok"
        try:
            kind = record.get("kind", "solve")
            tag = f"rp{seq}"
            if kind == "establish" or (kind == "delta"
                                       and not session.established):
                if kind == "establish":
                    n = int(record.get("n_pods", 0) or 1)
                else:
                    # mid-stream capture: the session's establish record
                    # predates the ring — establish at the SESSION size
                    # (capture-derived when possible), not the delta's
                    # churn size, and count the substitution honestly
                    n = self._session_sizes.get(
                        str(record.get("session", "") or ""),
                        self.session_pods)
                    with self._lock:
                        self._implicit_establishes += 1
                pods = self.pods_factory(n, tag)
                session.solve(pods, self.provisioners, self.catalog)
                session._live = [p.name for p in pods]
            elif kind == "delta":
                churn = max(1, int(record.get("churn", 0)
                                   or record.get("n_pods", 0) or 1))
                live = getattr(session, "_live", [])
                churn = min(churn, max(0, len(live) - 1)) or 1
                rm, session._live = live[:churn], live[churn:]
                add = self.pods_factory(churn, tag)
                session.solve_delta(added=add, removed=rm)
                session._live += [p.name for p in add]
            else:
                sched = self._classic(str(record.get("class", "") or ""))
                sched.solve(
                    self.pods_factory(int(record.get("n_pods", 0) or 1),
                                      tag),
                    self.provisioners, self.catalog)
        except Exception as err:  # ktlint: allow[KT005] every replayed
            # request's failure is a counted outcome, never a dead driver
            from ..admission import SolveDeadlineError, SolveShedError

            outcome = ("shed" if isinstance(
                err, (SolveShedError, SolveDeadlineError)) else "error")
        wall_ms = (time.perf_counter() - t0) * 1000.0
        self.registry.counter(REPLAY_REQUESTS).inc({"outcome": outcome})
        with self._lock:
            self._sent.append((sent_at * speedup, outcome, wall_ms,
                               str(record.get("class", "") or "")))

    def _classic(self, pclass: str = ""):
        # one shared availability-first facade PER PRIORITY CLASS for
        # sessionless solves (lazily built under the lock — pool workers
        # race the first classic record; a capture may hold none at
        # all).  Classes matter: the facade stamps its class on every
        # request it sends, and the replica's per-class SLO accounting
        # (obs/slo.py) judges the replayed capture class by class —
        # un-classed classic solves would all fold into the server
        # default.
        with self._lock:
            if not hasattr(self, "_classic_scheds"):
                self._classic_scheds = {}
            sched = self._classic_scheds.get(pclass)
            if sched is None:
                from ..service.client import RemoteScheduler

                sched = self._classic_scheds[pclass] = RemoteScheduler(
                    self.target, timeout=self.timeout, priority=pclass,
                    registry=self.registry)
            return sched

    def run(self, records: List[dict], speedup: float = 1.0) -> dict:
        """Replay; returns the report :func:`fidelity` consumes."""
        from concurrent.futures import ThreadPoolExecutor

        from ..service.client import DeltaSession

        speedup = max(1e-6, float(speedup))
        #: per-session establishment sizes the capture itself declares
        #: (read-only after this point; lane threads look them up)
        self._session_sizes = {
            str(r.get("session", "") or ""): int(r.get("n_pods", 0) or 1)
            for r in records
            if r.get("kind") == "establish" and r.get("session")}
        self._implicit_establishes = 0  # guarded-by: _lock
        sessions: Dict[str, DeltaSession] = {}
        lanes: Dict[str, "queue.Queue"] = {}
        threads: List[threading.Thread] = []
        pool = ThreadPoolExecutor(max_workers=self.workers,
                                  thread_name_prefix="replay")

        def lane_loop(q: "queue.Queue") -> None:
            while True:
                item = q.get()
                if item is None:
                    return
                self._fire(*item)

        base = time.perf_counter()
        try:
            for seq, record in enumerate(records):
                scheduled = float(record.get("t", 0.0)) / speedup
                wait = scheduled - (time.perf_counter() - base)
                if wait > 0:
                    self.clock.sleep(wait)
                sid = str(record.get("session", "") or "")
                if sid:
                    sess = sessions.get(sid)
                    if sess is None:
                        sess = sessions[sid] = DeltaSession(
                            self.target, timeout=self.timeout,
                            priority=str(record.get("class", "") or ""),
                            registry=self.registry)
                        lanes[sid] = queue.Queue()
                        th = threading.Thread(
                            target=lane_loop, args=(lanes[sid],),
                            name=f"replay-{sid}", daemon=True)
                        th.start()
                        threads.append(th)
                    lanes[sid].put((record, sess, base, speedup, seq))
                else:
                    pool.submit(self._fire, record, None, base, speedup,
                                seq)
            for q in lanes.values():
                q.put(None)
            for th in threads:
                th.join(timeout=self.timeout)
            pool.shutdown(wait=True)
        finally:
            for sess in sessions.values():
                try:
                    sess.close()
                except Exception:  # ktlint: allow[KT005] teardown
                    pass
            for sched in getattr(self, "_classic_scheds", {}).values():
                sched.close()
        with self._lock:
            sent = sorted(self._sent)
            implicit = self._implicit_establishes
        outcomes: Dict[str, int] = {}
        classes: Dict[str, int] = {}
        # per-class latency + outcome breakdown: the self-tuning bench
        # gate (bench.py measure_tuning) judges CRITICAL p99 and sheds
        # separately — aggregate wall_ms would let a tuned run trade
        # critical latency for batch throughput and still pass
        by_class: Dict[str, dict] = {}
        for _t, outcome, ms, pclass in sent:
            outcomes[outcome] = outcomes.get(outcome, 0) + 1
            if outcome != "error":
                classes[pclass] = classes.get(pclass, 0) + 1
            bc = by_class.setdefault(pclass, {"wall_ms": [], "outcomes": {}})
            if outcome == "ok":
                bc["wall_ms"].append(ms)
            bc["outcomes"][outcome] = bc["outcomes"].get(outcome, 0) + 1
        return {
            "achieved": [t for t, _o, _ms, _c in sent],
            "outcomes": outcomes,
            "classes": classes,
            "wall_ms": [ms for _t, _o, ms, _c in sent],
            "by_class": by_class,
            "implicit_establishes": implicit,
            "speedup": speedup,
            "n": len(sent),
        }


# ---------------------------------------------------------------------------
# fidelity
# ---------------------------------------------------------------------------


def _interarrivals(ts: List[float]) -> List[float]:
    return [b - a for a, b in zip(ts, ts[1:])]


def fidelity(records: List[dict], report: dict) -> dict:
    """How faithfully the replay reproduced the capture, in VIRTUAL time
    (achieved offsets are scaled back by the speedup, so the numbers
    compare to the capture directly): relative error of the
    inter-arrival p50/p90, the class mix, and the error count.  The
    bench gate (``measure_replay_fidelity``) fails on mix drift, errors,
    or p50 error past its tolerance."""
    planned_ts = sorted(float(r.get("t", 0.0)) for r in records)
    planned_ia = sorted(_interarrivals(planned_ts))
    achieved_ia = sorted(_interarrivals(sorted(report["achieved"])))

    def rel_err(q: float) -> Optional[float]:
        if not planned_ia or not achieved_ia:
            return None
        p = _percentile(planned_ia, q)
        a = _percentile(achieved_ia, q)
        return abs(a - p) / max(p, 1e-9)

    planned_mix: Dict[str, int] = {}
    for r in records:
        c = str(r.get("class", "") or "")
        planned_mix[c] = planned_mix.get(c, 0) + 1
    n_err = report["outcomes"].get("error", 0)
    # the achieved mix is tallied PER CLASS from what actually served
    # (errors excluded): a replay whose errors all landed on one class
    # — e.g. every 'critical' request failing — must not pass on
    # aggregate counts alone
    achieved_mix = dict(report.get("classes") or {})
    return {
        "interarrival_p50_err": rel_err(0.50),
        "interarrival_p90_err": rel_err(0.90),
        "class_mix": planned_mix,
        "class_mix_achieved": achieved_mix,
        "class_mix_match": (report["n"] == len(records)
                            and achieved_mix == planned_mix),
        "errors": n_err,
        "sheds": report["outcomes"].get("shed", 0),
        "implicit_establishes": report.get("implicit_establishes", 0),
        "n_planned": len(records),
        "n_sent": report["n"],
    }
