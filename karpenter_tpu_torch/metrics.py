"""Metrics registry of the port: counters, gauges and histograms keyed by
(name, labels), with the metric names the ported solver path records.

A copy of the reference package's ``metrics.Registry`` as far as the
solver path uses it (counters, gauges, histograms; no text exposition, no
cloud-provider decorator);
the metric names are the reference's, so a scrape of either package reads
the same series.
"""

from __future__ import annotations

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
