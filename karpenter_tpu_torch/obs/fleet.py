"""Fleet-wide observability aggregation — the ``/fleetz`` document: the
port of the reference package's ``obs/fleet.py``.

With delta sessions and a replica fleet a single request's life crosses
replicas and hosts:
session establishment on one replica, delta steps on a steal-adopting
sibling, megabatch slots forwarded to the owning host.  Each replica's
``/tracez`` + ``/statusz`` only shows its own hops; this module fans out
to every peer's obs endpoint and merges the answers into ONE view:

- **replicas** — per-replica load (inflight depth, owned sessions/leases,
  admission queue) keyed by the replica's self-reported ``replica_id``;
- **sessions** — the fleet-wide session-ownership map (who serves which
  chain, at which epoch, adopted from whom) with multi-owner conflicts
  surfaced rather than silently merged;
- **delta_rpc** — the per-outcome counters summed across replicas;
- **spans** — cross-replica span p50/p99, recomputed from the merged
  trace trees (exact percentiles cannot be merged from per-replica
  summaries, so the stats are honest over the rings' contents);
- **traces** — cross-replica trace TREES: hops are grouped by the
  wire-propagated trace id (replica-prefixed at the origin, adopted by
  every downstream hop — ``obs/trace.Tracer.start_remote``), and each
  hop is linked to the parent hop whose span its ``remote_parent``
  names, so a request that crossed three replicas renders as one tree.

Transport is injectable (``fetch=``) so tests pin the merge contract
without HTTP; the default fetch is a bounded-timeout urllib GET.  The
serving replica passes itself as ``local`` so its own documents come
from memory, not a loopback request into its own handler.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics as M
from .export import statusz, tracez
from .recorder import _percentile
from .slo import merge_sloz

#: sibling obs endpoints for the /fleetz fan-out, comma-separated base
#: URLs (include this replica's own URL on the OTHERS' lists; a replica
#: serves itself from memory)
PEERS_ENV = "KT_OBS_PEERS"
DEFAULT_TIMEOUT_S = 2.0


def env_peers() -> List[str]:
    raw = os.environ.get(PEERS_ENV, "")
    return [p.strip().rstrip("/") for p in raw.split(",") if p.strip()]


def zero_init(registry) -> None:
    """Zero-init the peer-fetch outcome family (KT003) — called by
    export.serve at sidecar startup, so the series exist before the
    first /fleetz request fans out."""
    c = registry.counter(M.FLEET_PEER_FETCH)
    for outcome in M.FLEET_PEER_FETCH_OUTCOMES:
        c.inc({"outcome": outcome}, 0.0)


def _boxed(fn, *args):
    """(result, None) or (None, err) — pool workers must hand any
    per-peer failure back as data, never let one peer fail the map."""
    try:
        return fn(*args), None
    # ktlint: allow[KT005] any per-peer failure (refused, timeout, bad
    # JSON) becomes an 'unreachable' row, never a failed /fleetz
    except Exception as err:  # noqa: BLE001
        return None, err


def _fetch_outcome(err) -> str:
    """Classify a per-peer fetch result for the accounting counter:
    a timeout means a PARTITIONED peer (it cost the full per-peer
    budget), anything else (refused / bad JSON / HTTP error) a dead or
    broken one."""
    if err is None:
        return "ok"
    if isinstance(err, TimeoutError):
        return "timeout"
    reason = getattr(err, "reason", None)
    if isinstance(reason, TimeoutError):
        return "timeout"
    if "timed out" in str(err).lower():
        return "timeout"
    return "error"


def _http_fetch(url: str, timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310
        return json.loads(resp.read().decode())


# ---------------------------------------------------------------------------
# cross-replica trace assembly
# ---------------------------------------------------------------------------


def _walk_spans(span: dict):
    yield span
    for child in span.get("spans", ()):  # tracez nests children as "spans"
        yield from _walk_spans(child)


def assemble_traces(hops_by_replica: Dict[str, List[dict]],
                    limit: int = 50) -> List[dict]:
    """Group every replica's trace dicts by trace id and link each hop to
    its parent hop: a hop whose root carries ``remote_parent`` attaches
    under the earliest OTHER hop containing a span with that span id
    (span ids are trace-local, so the earliest sender wins ties).  Hops
    are ordered by root start time — one shared request, so on a fleet
    with sane clocks the order is the journey order.  Returns merged
    traces (multi-hop first, then newest single-hop), each::

        {"trace_id": ..., "n_hops": N, "session_id": ...,
         "hops": [{"replica": ..., "parent_hop": i|-1, ...trace tree}]}
    """
    by_id: "Dict[str, List[dict]]" = {}
    for replica, traces in hops_by_replica.items():
        for tr in traces:
            tid = tr.get("trace_id", "")
            if not tid:
                continue
            hop = dict(tr)
            hop["replica"] = str(
                (tr.get("attrs") or {}).get("replica_id", "") or replica)
            by_id.setdefault(tid, []).append(hop)
    #: span names that actually SEND across the wire — when several hops
    #: contain a span with the referenced (trace-local) id, the one whose
    #: match is a send-site span is the true sender; plain earliest-other
    #: would mis-parent a 3-hop chain onto whichever hop happens to reuse
    #: the id first (every hop's root is "s1", and "s3" recurs freely)
    send_sites = ("remote", "forward")
    merged: List[dict] = []
    for tid, hops in by_id.items():
        hops.sort(key=lambda h: h.get("start") or 0.0)
        for i, hop in enumerate(hops):
            parent_span = str(
                (hop.get("attrs") or {}).get("remote_parent", "") or "")
            hop["parent_hop"] = -1
            if not parent_span:
                continue
            fallback = None
            for j, other in enumerate(hops):
                if other is hop:
                    continue
                match = next(
                    (sp for sp in _walk_spans(other)
                     if sp.get("span_id") == parent_span), None)
                if match is None:
                    continue
                if match.get("name") in send_sites:
                    hop["parent_hop"] = j
                    break
                if fallback is None:
                    fallback = j  # earliest other (the journey "s1" case)
            else:
                if fallback is not None:
                    hop["parent_hop"] = fallback
        session = ""
        for hop in hops:
            session = str(
                (hop.get("attrs") or {}).get("session_id", "") or "")
            if session:
                break
        merged.append({"trace_id": tid, "n_hops": len(hops),
                       "session_id": session, "hops": hops})
    # the interesting traces — the ones that actually crossed replicas —
    # first; within each group newest first
    merged.sort(key=lambda m: (-m["n_hops"],
                               -(m["hops"][0].get("start") or 0.0)))
    return merged[:limit]


def merged_span_stats(merged: List[dict]) -> Dict[str, dict]:
    """Cross-replica per-span {n, p50_ms, p99_ms, max_ms}, recomputed
    from the merged trees (percentiles cannot be combined from the
    per-replica summaries)."""
    durations: Dict[str, List[float]] = {}
    for m in merged:
        for hop in m["hops"]:
            for sp in _walk_spans(hop):
                d = sp.get("duration_ms")
                if d is not None:
                    durations.setdefault(sp.get("name", ""), []).append(
                        float(d))
    out: Dict[str, dict] = {}
    for name, vals in sorted(durations.items()):
        vals.sort()
        out[name] = {"n": len(vals),
                     "p50_ms": round(_percentile(vals, 0.50), 3),
                     "p99_ms": round(_percentile(vals, 0.99), 3),
                     "max_ms": round(vals[-1], 3)}
    return out


# ---------------------------------------------------------------------------
# the /fleetz document
# ---------------------------------------------------------------------------


def _load_of(status: dict) -> dict:
    """The per-replica load summary the fleet table shows."""
    fleet = status.get("fleet") or {}
    admission = status.get("admission") or {}
    return {
        "inflight": sum((status.get("inflight_depth") or {}).values()),
        "sessions_owned": fleet.get("sessions_owned", 0.0),
        "leases_owned": fleet.get("leases_owned", 0.0),
        "queued": sum((admission.get("queued") or {}).values()),
        "traces_recorded": status.get("traces_recorded", 0.0),
    }


def fleetz(peers: Optional[List[str]] = None,
           local: Optional[Tuple] = None,
           fetch: Optional[Callable[[str], dict]] = None,
           timeout: float = DEFAULT_TIMEOUT_S,
           trace_limit: int = 50) -> dict:
    """Fan out to every peer's ``/statusz`` + ``/tracez`` and merge.

    ``local`` is the serving replica's own ``(registry, flight, extra)``
    or ``(registry, flight, extra, sloz_fn)`` tuple — its documents are
    built in memory (never a loopback HTTP request into the very handler
    building this answer).  Peers whose ``replica_id`` matches an
    already-merged replica are skipped, so listing every replica (self
    included) in ``KT_OBS_PEERS`` uniformly across the fleet
    double-counts nothing.  Unreachable peers land in ``unreachable``
    (marked ``stale`` — their last-known numbers are simply absent from
    the merge) and are counted per outcome into
    ``karpenter_fleet_peer_fetch_total`` — a dead replica is exactly
    when the merged view matters most, so a fetch failure must never
    fail the document.  When any replica answers /sloz the merged doc
    carries a fleet-wide ``slo`` block (burn rates recomputed from
    summed numerators/denominators — obs/slo.merge_sloz)."""
    peers = list(peers or [])
    fetch = fetch or (lambda url: _http_fetch(url, timeout=timeout))
    replicas: Dict[str, dict] = {}
    hops: Dict[str, List[dict]] = {}
    sessions: Dict[str, dict] = {}
    conflicts: Dict[str, List[str]] = {}
    delta_total: Dict[str, float] = {}
    unreachable: List[dict] = []
    slo_docs: List[dict] = []
    local_registry = local[0] if local is not None else None

    def _count_fetch(outcome: str) -> None:
        if local_registry is not None:
            local_registry.counter(M.FLEET_PEER_FETCH).inc(
                {"outcome": outcome})

    def _admit(rid: str, source: str, status: dict, traces: dict,
               slo_doc: Optional[dict] = None) -> None:
        if rid in replicas:
            return  # self listed among the peers (the uniform config)
        if isinstance(slo_doc, dict) and slo_doc.get("classes"):
            slo_docs.append(slo_doc)
        replicas[rid] = {
            "source": source,
            "load": _load_of(status),
            "delta_rpc": status.get("delta_rpc") or {},
            "sessions": status.get("sessions") or {},
        }
        for outcome, v in (status.get("delta_rpc") or {}).items():
            delta_total[outcome] = delta_total.get(outcome, 0.0) + float(v)
        for sid, info in (status.get("sessions") or {}).items():
            have = sessions.get(sid)
            if have is None:
                sessions[sid] = {"owner": rid, **info}
                continue
            # two replicas reporting one session: the HIGHER epoch is the
            # live chain (a zombie incarnation on a killed-but-scrapable
            # replica is always behind — the lease protocol guarantees it
            # can never advance).  Equal epochs are a REAL single-owner
            # violation: surface, never silently merge.
            mine, theirs = int(info.get("epoch", 0) or 0), int(
                have.get("epoch", 0) or 0)
            if mine == theirs:
                conflicts.setdefault(sid, [have["owner"]]).append(rid)
            elif mine > theirs:
                sessions[sid] = {"owner": rid, **info}
        hops[rid] = list(traces.get("traces") or ())

    if local is not None:
        registry, flight, extra = local[:3]
        sloz_fn = local[3] if len(local) > 3 else None
        status = statusz(registry, flight, extra=extra)
        local_slo, _ = (_boxed(sloz_fn) if sloz_fn is not None
                        else (None, None))
        _admit(str(status.get("replica_id", "") or "local"), "local",
               status, tracez(flight) if flight is not None else {},
               slo_doc=local_slo)

    def _pull(peer: str):
        status, traces = fetch(f"{peer}/statusz"), fetch(f"{peer}/tracez")
        # /sloz separately boxed: a pre-SLO peer 404s here, and its
        # status + traces must still merge
        slo_doc, _slo_err = _boxed(fetch, f"{peer}/sloz")
        return status, traces, slo_doc

    if peers:
        # concurrent fan-out: the per-peer fetches are independent, and a
        # PARTITIONED peer (SYN dropped, not refused) costs a full
        # timeout — serially that stacks to peers x timeout on the very
        # request an operator makes while replicas are dying; in
        # parallel the whole document is bounded by ~one timeout
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
                max_workers=min(8, len(peers)),
                thread_name_prefix="fleetz") as pool:
            pulls = list(pool.map(
                lambda p: (p, _boxed(_pull, p)), peers))
        for peer, (result, err) in pulls:
            outcome = _fetch_outcome(err)
            _count_fetch(outcome)
            if err is not None:
                # stale: the peer stays visible as a row, just with no
                # fresh numbers in the merge — never silently dropped
                unreachable.append({"url": peer, "outcome": outcome,
                                    "stale": True,
                                    "error": str(err)[:200]})
                continue
            status, traces, slo_doc = result
            _admit(str(status.get("replica_id", "") or peer), peer,
                   status, traces, slo_doc=slo_doc)

    merged = assemble_traces(hops, limit=trace_limit)
    doc = {
        "replicas": replicas,
        "sessions": sessions,
        "session_conflicts": conflicts,
        "delta_rpc": delta_total,
        "spans": merged_span_stats(merged),
        "traces": merged,
        "unreachable": unreachable,
        # partial: at least one peer did not contribute — consumers
        # (the item-4 autoscaler) must treat sums as lower bounds
        "partial": bool(unreachable),
    }
    if slo_docs:
        doc["slo"] = merge_sloz(slo_docs)
    return doc


# ---------------------------------------------------------------------------
# terminal renderers (make obs-fleet-demo)
# ---------------------------------------------------------------------------


def render_fleetz(doc: dict, trace_limit: int = 4) -> str:
    lines = ["== /fleetz =="]
    lines.append(f"{'replica':<20} {'sessions':>8} {'leases':>7} "
                 f"{'inflight':>8} {'queued':>7} {'traces':>7}")
    for rid, rep in sorted(doc.get("replicas", {}).items()):
        load = rep.get("load", {})
        lines.append(
            f"{rid:<20} {len(rep.get('sessions') or {}):>8} "
            f"{load.get('leases_owned', 0):>7.0f} "
            f"{load.get('inflight', 0):>8.0f} "
            f"{load.get('queued', 0):>7.0f} "
            f"{load.get('traces_recorded', 0):>7.0f}")
    for row in doc.get("unreachable", ()):
        lines.append(f"{row['url']:<20} UNREACHABLE ({row['error']})")
    delta = doc.get("delta_rpc") or {}
    if delta:
        lines.append("-- delta rpc (fleet total) --")
        lines.append("  " + "  ".join(
            f"{k}={v:.0f}" for k, v in sorted(delta.items()) if v))
    slo = (doc.get("slo") or {}).get("classes") or {}
    if slo:
        lines.append("-- fleet slo --")
        for cls, info in slo.items():
            avail = info.get("availability") or {}
            life = avail.get("lifetime") or {}
            lines.append(
                f"  {cls:<12} verdict={info.get('verdict', '?'):<8} "
                f"requests={life.get('total', 0):.0f} "
                f"bad={life.get('bad', 0):.0f} "
                f"avail_budget={avail.get('budget_remaining', 1.0):+.3f}")
    sessions = doc.get("sessions") or {}
    if sessions:
        lines.append("-- session ownership --")
        for sid, info in sorted(sessions.items()):
            src = (f" (adopted_from={info['adopted_from']}"
                   f" via {info.get('adopt_how', '')})"
                   if info.get("adopted_from") else "")
            lines.append(
                f"  {sid[:16]:<16} owner={info['owner']} "
                f"epoch={info.get('epoch', '?')} "
                f"age={info.get('last_delta_age_s', '?')}s{src}")
    for sid, owners in (doc.get("session_conflicts") or {}).items():
        lines.append(f"  !! {sid[:16]} claimed by {owners}")
    stats = doc.get("spans") or {}
    if stats:
        lines.append("-- cross-replica spans --")
        lines.append(f"  {'span':<22} {'n':>5} {'p50_ms':>10} "
                     f"{'p99_ms':>10}")
        for name, s in stats.items():
            lines.append(f"  {name:<22} {s['n']:>5} {s['p50_ms']:>10.3f} "
                         f"{s['p99_ms']:>10.3f}")
    multi = [m for m in doc.get("traces", ()) if m["n_hops"] > 1]
    for m in multi[:trace_limit]:
        lines.append(render_journey(m))
    return "\n".join(lines)


def render_journey(merged: dict) -> str:
    """One cross-replica trace as a timeline: every hop offset against
    the journey's first hop, nested under the hop it remote-parents to,
    lifecycle/delta spans inlined — the 'session journey' view."""
    hops = merged["hops"]
    t0 = min((h.get("start") or 0.0) for h in hops) if hops else 0.0
    head = f"-- trace {merged['trace_id']} ({merged['n_hops']} hop(s)"
    if merged.get("session_id"):
        head += f", session {merged['session_id'][:16]}"
    lines = [head + ") --"]
    children: Dict[int, List[int]] = {}
    roots: List[int] = []
    for i, hop in enumerate(hops):
        parent = hop.get("parent_hop", -1)
        if parent < 0:
            roots.append(i)
        else:
            children.setdefault(parent, []).append(i)

    def emit(i: int, depth: int) -> None:
        hop = hops[i]
        attrs = hop.get("attrs") or {}
        off = ((hop.get("start") or 0.0) - t0) * 1000.0
        dur = hop.get("duration_ms")
        extras = " ".join(
            f"{k}={attrs[k]}" for k in ("epoch", "outcome", "mode")
            if k in attrs)
        lines.append(
            f"  {'  ' * depth}+{off:9.3f}ms {hop['replica']:<14} "
            f"{hop.get('name', ''):<10} "
            f"{'open' if dur is None else f'{dur:.3f}ms'}"
            + (f"  [{extras}]" if extras else ""))
        for sp in _walk_spans(hop):
            if sp is hop:
                continue
            if sp.get("name", "").startswith("session_") \
                    or sp.get("name") in ("delta", "forward", "remote"):
                sattrs = sp.get("attrs") or {}
                detail = " ".join(
                    f"{k}={sattrs[k]}"
                    for k in ("outcome", "epoch", "adopted_from", "owner",
                              "slot", "replica")
                    if k in sattrs and sattrs[k] != "")
                soff = ((sp.get("start") or 0.0) - t0) * 1000.0
                lines.append(
                    f"  {'  ' * depth}  +{soff:8.3f}ms   "
                    f"{sp.get('name', ''):<20}"
                    + (f"  [{detail}]" if detail else ""))
        for c in children.get(i, ()):
            emit(c, depth + 1)

    for r in roots:
        emit(r, 0)
    return "\n".join(lines)
