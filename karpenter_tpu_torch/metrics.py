"""Metrics registry of the port: counters, gauges and histograms keyed by
(name, labels), with the metric names the ported solver path records.

A copy of the reference package's ``metrics.Registry`` as far as the
solver path and the controllers use it (counters, gauges, histograms, and
``decorate(provider)``, which wraps every CloudProvider method in a
duration histogram; no text exposition);
the metric names are the reference's, so a scrape of either package reads
the same series.  :data:`INVENTORY` carries the help text of the names the
controllers, the cloud provider and the tracer record.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _lkey(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((labels or {}).items()))


class Counter:
    def __init__(self) -> None:
        self.values: Dict[tuple, float] = defaultdict(float)

    def inc(self, labels: Optional[Dict[str, str]] = None, value: float = 1.0) -> None:
        self.values[_lkey(labels)] += value

    def get(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self.values.get(_lkey(labels), 0.0)

    def has(self, labels: Optional[Dict[str, str]] = None) -> bool:
        """Whether the SAMPLE exists (get() returns 0.0 either way)."""
        return _lkey(labels) in self.values


class Gauge:
    def __init__(self) -> None:
        self.values: Dict[tuple, float] = {}

    def set(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        self.values[_lkey(labels)] = value

    def get(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self.values.get(_lkey(labels), 0.0)

    def has(self, labels: Optional[Dict[str, str]] = None) -> bool:
        """Whether the sample exists."""
        return _lkey(labels) in self.values


class Histogram:
    def __init__(self, buckets=_DEFAULT_BUCKETS) -> None:
        self.buckets = buckets
        self.counts: Dict[tuple, List[int]] = defaultdict(lambda: [0] * (len(buckets) + 1))
        self.sums: Dict[tuple, float] = defaultdict(float)
        self.totals: Dict[tuple, int] = defaultdict(int)

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        key = _lkey(labels)
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[key][i] += 1
                break
        else:
            self.counts[key][-1] += 1
        self.sums[key] += value
        self.totals[key] += 1

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        return self.totals.get(_lkey(labels), 0)


class Registry:
    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self.histograms.setdefault(name, Histogram())


# global default registry (schedulers accept an override)
registry = Registry()

SCHEDULING_DURATION = "karpenter_scheduling_duration_seconds"
SOLVER_BACKEND_DURATION = "karpenter_solver_backend_duration_seconds"
TENSORIZE_DURATION = "karpenter_solver_tensorize_duration_seconds"
TENSORIZE_CACHE_HITS = "karpenter_solver_tensorize_cache_hits_total"
TENSORIZE_CACHE_MISSES = "karpenter_solver_tensorize_cache_misses_total"
RELAX_TOTAL = "karpenter_solver_relax_total"
#: the relax rung's outcome labels: 'improved' (relax+round cost strictly
#: less and shipped), 'tied' (equal cost; the scan's plan ships),
#: 'fallback' (rounding/repair found no valid cheaper plan, or the rung
#: raised; the scan's plan ships), 'skipped' (enabled but did not run: no
#: eligible unconstrained groups, or a cold-served solve)
RELAX_OUTCOMES = ("improved", "tied", "fallback", "skipped")
RELAX_DURATION = "karpenter_solver_relax_duration_seconds"
RELAX_IMPROVEMENT = "karpenter_solver_relax_improvement_ratio"
CONSOLIDATION_SWEEPS = "karpenter_solver_consolidation_sweeps_total"
CONSOLIDATION_SWEEP_SLOTS = "karpenter_solver_consolidation_sweep_slots"
CONSOLIDATION_SWEEP_DURATION = (
    "karpenter_solver_consolidation_sweep_duration_seconds")
WARMSTART_SOLVES = "karpenter_solver_warmstart_solves_total"
WARMSTART_DURATION = "karpenter_solver_warmstart_duration_seconds"
WARMSTART_DISPLACED = "karpenter_solver_warmstart_displaced_pods"
HIER_SOLVES = "karpenter_solver_hier_solves_total"
#: routing outcomes for batches at/above KT_HIER_THRESHOLD: 'hierarchical'
#: (block decomposition served the batch) or 'fallback_structure' (one
#: reachability component — flat IS the right program).  The port compiles
#: nothing and catches no wave failure, so the reference's 'fallback_cold'
#: and 'fallback_degraded' outcomes do not exist here
HIER_PATHS = ("hierarchical", "fallback_structure")
HIER_BLOCKS = "karpenter_solver_hier_blocks"
HIER_PRICE_ITERATIONS = "karpenter_solver_hier_price_iterations"
HIER_REPAIR_PODS = "karpenter_solver_hier_repair_pods"
HIER_DURATION = "karpenter_solver_hier_duration_seconds"

# controllers, cloud provider and tracing (reference metrics.py:142-186)
CLOUDPROVIDER_DURATION = "karpenter_cloudprovider_duration_seconds"
NODES_CREATED = "karpenter_nodes_created_total"
NODES_TERMINATED = "karpenter_nodes_terminated_total"
DEPROVISIONING_ACTIONS = "karpenter_deprovisioning_actions_performed_total"
DEPROVISIONING_DURATION = "karpenter_deprovisioning_evaluation_duration_seconds"
PODS_STARTUP_DURATION = "karpenter_pods_startup_time_seconds"
PROVISIONER_USAGE = "karpenter_provisioner_usage"
PROVISIONER_LIMIT = "karpenter_provisioner_limit"
BATCH_SIZE = "karpenter_provisioner_batch_size"
TRACE_TRACES = "karpenter_trace_traces_total"
TRACE_SPAN_DURATION = "karpenter_trace_span_duration_seconds"
TRACE_RING_EVICTIONS = "karpenter_trace_ring_evictions_total"
FLIGHT_DUMPS = "karpenter_trace_flight_recorder_dumps_total"
TRACE_REMOTE_SPANS = "karpenter_trace_remote_spans_total"
#: how each server-side RPC trace rooted (KT003 zero-init source, shared by
#: Tracer construction): 'adopted' (the request carried a wire trace
#: context and this trace joined the remote parent's tree) vs 'local' (no
#: context on the wire — an old client, a direct call, or an unsampled
#: origin; the trace rooted locally)
TRACE_REMOTE_OUTCOMES = ("adopted", "local")

#: metric inventory of the names above: name -> (type, labels, help), the
#: reference's help text
INVENTORY = {
    CLOUDPROVIDER_DURATION: (
        "histogram", ("controller", "method"),
        "Duration of each CloudProvider method call (metrics decorator)."),
    NODES_CREATED: (
        "counter", ("provisioner",),
        "Nodes launched, by provisioner."),
    NODES_TERMINATED: (
        "counter", ("provisioner",),
        "Nodes terminated, by provisioner."),
    DEPROVISIONING_ACTIONS: (
        "counter", ("action",),
        "Deprovisioning actions performed (kind/mechanism)."),
    DEPROVISIONING_DURATION: (
        "histogram", (),
        "Deprovisioning evaluation pass duration, seconds."),
    PODS_STARTUP_DURATION: (
        "histogram", (),
        "Time from pod creation to bound-and-running, seconds."),
    PROVISIONER_USAGE: (
        "gauge", ("provisioner", "resource_type"),
        "Resource usage accounted against each provisioner's limits."),
    PROVISIONER_LIMIT: (
        "gauge", ("provisioner", "resource_type"),
        "Configured provisioner resource limits."),
    BATCH_SIZE: (
        "histogram", (),
        "Pending pods per provisioning batch window."),
    TRACE_TRACES: (
        "counter", (),
        "Per-solve traces recorded by the tracer (obs/trace.py); one per "
        "sampled solve/provision/deprovision pass.  KT_TRACE=0 disables "
        "sampling entirely, KT_TRACE_SAMPLE_EVERY=N keeps 1 in N."),
    TRACE_SPAN_DURATION: (
        "histogram", ("span",),
        "Duration of each named trace span (window / tensorize / dispatch "
        "/ fence / reseat / respond / ...), seconds — the per-phase "
        "attribution behind /tracez p50/p99."),
    TRACE_RING_EVICTIONS: (
        "counter", (),
        "Traces evicted from the flight recorder's bounded ring to admit "
        "newer ones (ring capacity: KT_FLIGHT_TRACES)."),
    FLIGHT_DUMPS: (
        "counter", ("reason",),
        "Flight-recorder dumps triggered by anomaly, by reason: "
        "device_hang (hang-guard trip), degraded_solve (warm-tier serve "
        "while the device tier is latched unhealthy), budget_breach (a "
        "trace exceeded KT_TRACE_SLOW_S), sanitizer_error (KT_SANITIZE "
        "lock-discipline violation).  Each dump's JSON envelope (and its "
        "KT_FLIGHT_DIR file name) carries the dumping replica_id and, "
        "when attributable, the session_id, so a fleet's dumps correlate "
        "offline."),
    TRACE_REMOTE_SPANS: (
        "counter", ("outcome",),
        "Server-side RPC traces by how they rooted (fleet-wide tracing, "
        "docs/OBSERVABILITY.md): 'adopted' — the request carried a wire "
        "trace context (trace_id + parent_span on SolveRequest) and this "
        "replica's trace joined the remote parent's tree, so the whole "
        "cross-replica request renders as ONE tree in /fleetz; 'local' — "
        "no context on the wire (old client, direct call, unsampled "
        "origin) and the trace rooted locally."),
}


def decorate(provider, reg: Optional[Registry] = None):
    """Wrap every public method of a CloudProvider in a duration histogram
    (core metrics.Decorate analog)."""
    reg = reg or registry
    hist = reg.histogram(CLOUDPROVIDER_DURATION)

    class Decorated:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            attr = getattr(self._inner, name)
            if not callable(attr) or name.startswith("_"):
                return attr

            def wrapped(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return attr(*args, **kw)
                finally:
                    hist.observe(
                        time.perf_counter() - t0,
                        {"controller": "cloudprovider", "method": name},
                    )

            return wrapped

    return Decorated(provider)
