"""Batch scheduler facade — routes pods to the device solve, the hierarchical
solve or the CPU oracle.

The port of the reference package's ``solver/scheduler.py``, reduced to the
synchronous provisioning solve: ``BatchScheduler.solve`` runs the first
wave, the preference-relaxation ladder, the OR-term waves, the residue
waves, the capped-node reseat epilogue and the convex-relaxation rung
(solver/relax.py).  ``_solve_once`` routes a wave
to the oracle (``auto`` batches of at most ``NATIVE_BATCH_LIMIT`` pods, or
any batch with a hard capacity-type spread), to the hierarchical solve
(greenfield batches at/above ``KT_HIER_THRESHOLD``), or to the flat device
solve.  Pods the device solve can't express are carved out and solved by
the oracle against the device result's node set.

Not in this port yet: the gang epilogue (a batch with gang pods raises
``NotImplementedError``), the megabatch collector, compile-behind and the
native C++ tier, the device hang guard, and the mesh.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..device import resolve_device
from ..gang import gang_enabled, has_gangs
from ..metrics import (
    SCHEDULING_DURATION,
    SOLVER_BACKEND_DURATION,
    TENSORIZE_CACHE_HITS,
    TENSORIZE_CACHE_MISSES,
    TENSORIZE_DURATION,
    Registry,
    registry as default_registry,
)
from ..models import labels as L
from ..models.instancetype import InstanceType
from ..models.pod import PodSpec
from ..models.provisioner import Provisioner
from ..models.tensorize import (
    TensorizeCache,
    batch_needs_oracle,
    device_inexpressible,
    tensorize,
)
from ..obs.trace import NULL_TRACE
from .reference import solve as oracle_solve
from .tpu import TpuSolver
from .types import SimNode, SolveResult

logger = logging.getLogger(__name__)

#: "auto" routes batches of at most this many pods to the CPU oracle
NATIVE_BATCH_LIMIT = 256
#: relaxation-ladder depth cap: at most this many retry waves per solve
MAX_RELAXATION_WAVES = 8
#: residue-convergence depth: still-infeasible pods re-solve against the
#: accumulated placed state until nothing more places (or this many waves)
MAX_RESIDUE_WAVES = 6


def _soft_spreads(pod: PodSpec):
    return [t for t in pod.topology_spread if not t.hard]


def _n_preferences(pod: PodSpec) -> int:
    """Relaxable preferences: preferred node-affinity terms + ScheduleAnyway
    topology spreads (both sit on the same relaxation ladder, like core's
    Preferences — scheduling.md:205-233 + :303-346 ScheduleAnyway)."""
    return len(pod.preferred_affinity_terms) + len(_soft_spreads(pod))


def _harden_preferences(pod: PodSpec, keep: Optional[int] = None) -> PodSpec:
    """Fold the first ``keep`` preferences (all when None) into the hard
    constraint set: preferred affinity terms join the required set,
    ScheduleAnyway spreads become DoNotSchedule.  The ladder drops soft
    spreads first (they sort after affinity terms), then affinity terms
    last-first.  Returns the pod unchanged when it has no preferences."""
    if not pod.preferred_affinity_terms and (
        not pod.topology_spread or all(t.hard for t in pod.topology_spread)
    ):
        return pod  # no preferences (the hot path at scale)

    from ..models.pod import TopologySpreadConstraint

    prefs_aff = pod.preferred_affinity_terms
    soft = _soft_spreads(pod)
    total = len(prefs_aff) + len(soft)
    k = total if keep is None else max(0, keep)
    kept_aff = prefs_aff[: min(k, len(prefs_aff))]
    kept_soft = soft[: max(0, k - len(prefs_aff))]

    out = copy.copy(pod)
    if kept_aff:
        out.required_affinity_terms = [
            list(term) + [r for pt in kept_aff for r in pt]
            for term in (pod.required_affinity_terms or [[]])
        ]
    out.preferred_affinity_terms = []
    out.topology_spread = [t for t in pod.topology_spread if t.hard] + [
        TopologySpreadConstraint(t.max_skew, t.topology_key, "DoNotSchedule",
                                 t.label_selector)
        for t in kept_soft
    ]
    out.__dict__.pop("_group_key", None)  # hardened copy needs its own key
    return out


def _adopt_placed(prev_existing: List[SimNode], sub: SolveResult):
    """Split a wave's placed snapshots back into (existing, prior+new nodes).

    ``sub`` solved against ``prev_existing + <prior new nodes>`` in that
    order and returned its placed copies in ``sub.existing_nodes``; the
    copies replace the prior references so the next wave sees every
    placement so far — capacity bookkeeping chains across waves without
    mutating the caller's node objects.  The ONLY place this split-index
    logic lives; both _merge and _solve_tpu's staging use it."""
    ne = len(prev_existing)
    placed = list(sub.existing_nodes)
    return placed[:ne], placed[ne:] + list(sub.nodes)


def _merge(result: SolveResult, sub: SolveResult) -> None:
    """Fold a retry wave's outcome into ``result`` (shared by the preference
    ladder and the OR-term ladder so their merge semantics cannot diverge)."""
    for name in list(result.infeasible):
        if name in sub.assignments:
            del result.infeasible[name]
    result.infeasible.update(sub.infeasible)
    result.assignments.update(sub.assignments)
    result.existing_nodes, result.nodes = _adopt_placed(result.existing_nodes, sub)
    result.solve_ms += sub.solve_ms
    result.tensorize_ms += sub.tensorize_ms
    result.served_cold = result.served_cold or sub.served_cold

def _budget_left(result: SolveResult, max_new_nodes: Optional[int]) -> Optional[int]:
    return (None if max_new_nodes is None
            else max(0, max_new_nodes - len(result.nodes)))


class BatchScheduler:
    """The provisioning solve's entry point.  ``backend`` is ``"auto"``
    (oracle for small batches, device otherwise), ``"tpu"`` (the device
    solve for every batch; the name is the reference's) or ``"oracle"``.
    ``device=None`` is the CUDA card and raises without one; only an
    explicit ``device="cpu"`` runs the device path on the host."""

    def __init__(
        self,
        backend: str = "auto",
        registry: Optional[Registry] = None,
        native_batch_limit: int = NATIVE_BATCH_LIMIT,
        device=None,
    ) -> None:
        if backend not in ("auto", "tpu", "oracle"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.registry = registry or default_registry
        self.native_batch_limit = native_batch_limit
        self.device = resolve_device(device)
        self._tpu = TpuSolver(device=self.device)
        # incremental host tensorize: group-level tensors built once per
        # batch shape, reused across solves (KT_TENSORIZE_CACHE=0 forces
        # the from-scratch path, and turns the relax rung off)
        self._tensorize_cache: Optional[TensorizeCache] = (
            TensorizeCache()
            if os.environ.get("KT_TENSORIZE_CACHE", "1") != "0" else None
        )
        for tier in ("identity", "shape"):
            self.registry.counter(TENSORIZE_CACHE_HITS).inc(
                {"tier": tier}, value=0.0)
        self.registry.counter(TENSORIZE_CACHE_MISSES).inc(value=0.0)
        from .hierarchy import zero_init_hier_metrics
        from .relax import zero_init_metrics as relax_zero_init
        from .warmstart import zero_init_metrics

        zero_init_metrics(self.registry)
        relax_zero_init(self.registry)
        zero_init_hier_metrics(self.registry)
        # hierarchical re-entrancy depth: repair solves issued from inside
        # solve_hierarchical must never route hierarchically themselves
        self._hier_depth = 0
        #: stage timings and counts of the last hierarchical solve
        #: (solve_hierarchical's ``stats``)
        self.hier_stats: dict = {}

    def solve(
        self,
        pods: Sequence[PodSpec],
        provisioners: Sequence[Provisioner],
        instance_types: Sequence[InstanceType],
        *,
        existing_nodes: Sequence[SimNode] = (),
        daemonsets: Sequence[PodSpec] = (),
        unavailable: Optional[Set[tuple]] = None,
        allow_new_nodes: bool = True,
        max_new_nodes: Optional[int] = None,
        trace=None,
        relax: Optional[bool] = None,
    ) -> SolveResult:
        """Solve with preference relaxation: pods carrying preferences are
        first solved with all preferences hardened; any that come back
        infeasible retry dropping one preference at a time, last first.
        Pods with OR'd required-affinity terms that stay infeasible under
        term[0] retry under each alternate term.  Still-infeasible pods
        then re-solve against the accumulated state (residue waves), and
        nearly-empty capped nodes are re-seated by the oracle when that is
        strictly cheaper.  Large device-tier batches then pass through the
        convex-relaxation rung, which ships min(scan, relax+round):
        ``relax=False`` skips it, ``None`` defers to ``KT_RELAX`` (default
        on).  A batch with gang pods raises ``NotImplementedError`` (the
        all-or-nothing epilogue is not ported yet)."""
        if gang_enabled() and has_gangs(pods):
            raise NotImplementedError(
                "gang scheduling is not ported to karpenter_tpu_torch yet")
        t0 = time.perf_counter()
        trace = trace or NULL_TRACE
        trace.annotate(backend=self.backend, n_pods=len(pods))
        try:
            hardened = [_harden_preferences(p) for p in pods]
            with trace.span("dispatch"):
                first = self._solve_once(
                    hardened, provisioners, instance_types,
                    list(existing_nodes), daemonsets, unavailable,
                    allow_new_nodes, max_new_nodes, trace=trace,
                )
            result = self._solve_wave(
                pods, provisioners, instance_types, list(existing_nodes),
                daemonsets, unavailable, allow_new_nodes, max_new_nodes,
                first=first, trace=trace,
            )
            with trace.span("reseat") as reseat_span:
                waves = 0
                # OR'd required-affinity terms beyond the first: the
                # solvers pack under term[0] only, so still-infeasible pods
                # retry under each alternate term in order
                max_terms = max(
                    (len(p.required_affinity_terms) for p in pods), default=0)
                for k in range(1, max_terms):
                    alts = []
                    for p in pods:
                        if p.name in result.infeasible and len(p.required_affinity_terms) > k:
                            q = copy.copy(p)
                            q.required_affinity_terms = [p.required_affinity_terms[k]]
                            q.__dict__.pop("_group_key", None)
                            alts.append(q)
                    if not alts:
                        break
                    waves += 1
                    _merge(result, self._solve_wave(
                        alts, provisioners, instance_types,
                        list(result.existing_nodes) + result.nodes, daemonsets,
                        unavailable, allow_new_nodes,
                        _budget_left(result, max_new_nodes), trace=trace,
                    ))

                # residue convergence: re-offer the still-infeasible pods
                # the state every prior wave produced, until a wave places
                # nothing new
                for _ in range(MAX_RESIDUE_WAVES):
                    retry = [p for p in pods if p.name in result.infeasible]
                    if not retry:
                        break
                    sub = self._solve_wave(
                        retry, provisioners, instance_types,
                        list(result.existing_nodes) + result.nodes, daemonsets,
                        unavailable, allow_new_nodes,
                        _budget_left(result, max_new_nodes), trace=trace,
                    )
                    if not sub.assignments:
                        break  # no progress: the residue is genuinely infeasible
                    waves += 1
                    _merge(result, sub)
                # ct-spread batches are already fully oracle-interleaved;
                # the reseat epilogue buys nothing there
                if not batch_needs_oracle(hardened):
                    self._reseat_capped(
                        result, provisioners, instance_types, daemonsets,
                        unavailable, n_pods=len(pods),
                        max_new_nodes=max_new_nodes,
                    )
                reseat_span.annotate(repair_waves=waves)
            # convex-relaxation refinement rung (solver/relax.py): re-pack
            # the large unconstrained groups globally and ship
            # min(scan, relax+round) — never worse by construction
            result = self._maybe_relax(
                result, hardened, provisioners, instance_types, daemonsets,
                unavailable, allow_new_nodes, max_new_nodes, relax, trace,
            )
            trace.annotate(
                n_nodes=len(result.nodes),
                n_infeasible=len(result.infeasible),
                cost=round(result.new_node_cost, 4),
                solve_ms=round(result.solve_ms, 3),
            )
            return result
        finally:
            self.registry.histogram(SCHEDULING_DURATION).observe(
                time.perf_counter() - t0)

    def _reseat_capped(
        self, result: SolveResult, provisioners, instance_types, daemonsets,
        unavailable, *, n_pods: int, max_new_nodes: Optional[int] = None,
    ) -> None:
        """Cost-decreasing epilogue for nearly-empty residue nodes: the scan
        solver places group-at-a-time, so a group tail (or a per-node-capped
        group — hostname anti-affinity, spread caps) can buy dedicated
        near-empty nodes where the oracle's pod-interleaved first-fit seats
        the same pods on other groups' open capacity, or serves them from a
        cheaper right-sized node (fuzz seed 5: 7 single-pod m5.large at
        +3.3%; kubelet seed 20: a zone-spread band-top orphan riding a
        2xlarge it shares with one hostname-spread pod, where re-solving
        seats the orphan on another zone's slack and downsizes the node).
        Take the new nodes holding at most two pods, re-solve exactly those
        pods with the oracle against everything else placed, and adopt the
        answer only when every pod still places AND it is strictly cheaper —
        quality can only improve by construction.  Device backends only —
        the oracle backend (and auto's oracle-served small batches) already
        interleave."""
        if (self.backend == "oracle" or self._route_small(n_pods)
                or not result.nodes):
            return

        def _capped(p: PodSpec) -> bool:
            # per-node CAPS: hostname anti-affinity and hard hostname spread
            # — the shapes whose reseat wins are structural (they build
            # single-pod fleets with backfillable slack)
            return any(
                t.anti and t.topology_key == L.HOSTNAME
                for t in p.affinity_terms
            ) or any(
                t.hard and t.topology_key == L.HOSTNAME
                for t in p.topology_spread
            )

        waste = [n for n in result.nodes if n.pods and len(n.pods) <= 2]
        # bounded epilogue: a batch whose pods are node-sized (1-2 per node
        # by design) would otherwise re-solve nearly everything through the
        # sequential oracle and erase the device speedup.  Trim to a 64-pod
        # re-solve budget, keeping capped fleets first (the structural wins)
        # then the most expensive residue — never skip wholesale
        if sum(len(n.pods) for n in waste) > 64:
            waste.sort(key=lambda n: (
                0 if all(_capped(p) for p in n.pods) else 1, -n.price, n.name))
            trimmed, tot = [], 0
            for n in waste:
                if tot + len(n.pods) > 64:
                    continue  # overfull node; later smaller ones may still fit
                trimmed.append(n)
                tot += len(n.pods)
            waste = trimmed
        if not waste:
            return
        waste_ids = {id(n) for n in waste}
        waste_pods = [p for n in waste for p in n.pods]
        keep = [n for n in result.nodes if id(n) not in waste_ids]
        others = list(result.existing_nodes) + keep
        # fast screen before paying a sequential oracle solve on EVERY batch
        # whose pod count isn't a multiple of node capacity (almost all):
        # a win requires either free room for a waste pod somewhere else
        # (resource-only — caps/zones may still block, the oracle decides)
        # or a waste node that isn't the cheapest catalog way to host its
        # own pods.  A routine right-sized tail node fails both and skips.
        if not self._reseat_plausible(waste, others, instance_types):
            return
        # honor the caller's new-node budget: the epilogue may only spend
        # what the waste nodes gave back (max_new_nodes=1 what-ifs must not
        # come back with 2 replacements)
        budget = (None if max_new_nodes is None
                  else max(0, max_new_nodes - len(keep)))
        re = oracle_solve(
            waste_pods, provisioners, instance_types,
            existing_nodes=others, daemonsets=daemonsets,
            unavailable=unavailable, allow_new_nodes=True,
            max_new_nodes=budget,
        )
        old_cost = sum(n.price for n in waste)
        if re.infeasible or re.new_node_cost >= old_cost - 1e-9:
            return
        if not self._reseat_in_band(waste_pods, re, instance_types):
            return
        placed = list(re.existing_nodes)  # snapshots of others, pods seated
        ne = len(result.existing_nodes)
        result.existing_nodes = placed[:ne]
        result.nodes = placed[ne:] + list(re.nodes)
        result.assignments.update(re.assignments)

    @staticmethod
    def _reseat_plausible(waste, others, instance_types) -> bool:
        """Cheap necessary condition for a reseat win: some waste pod has
        resource-level room on another placed node (absorption might be
        possible), or some waste node is priced above the cheapest catalog
        type that fits its pods (downsizing might be possible)."""
        for n in waste:
            for p in n.pods:
                req = dict(p.requests)
                req.setdefault(L.RESOURCE_PODS, 1.0)
                for o in others:
                    rem = o.remaining()
                    if all(rem.get(k, 0.0) >= v - 1e-9 for k, v in req.items()):
                        return True
        for n in waste:
            total: Dict[str, float] = {}
            for p in n.pods:
                for k, v in p.requests.items():
                    total[k] = total.get(k, 0.0) + v
            total[L.RESOURCE_PODS] = float(len(n.pods))
            for it in instance_types:
                if not all(it.allocatable.get(k, 0.0) >= v - 1e-9
                           for k, v in total.items()):
                    continue
                cheapest = min(
                    (o.price for o in it.offerings if o.available),
                    default=None,
                )
                if cheapest is not None and cheapest < n.price - 1e-9:
                    return True
        return False

    @staticmethod
    def _reseat_in_band(moved, re, instance_types) -> bool:
        """Global zone-spread check on a reseat adoption candidate.

        The oracle's incremental band check (`counts[z]+1-min <= skew`)
        assumes an IN-BAND starting state; removing the waste nodes can hand
        it a mid-band hole it then legally over-fills from (fuzz seed 17:
        removing four 2-pod zone-1b nodes left {11,1,8}; per-placement-legal
        refilling ended {11,7,10} — skew 4 over a 3 band).  Re-check every
        moved pod's hard zone spread GLOBALLY over its eligible zones and
        reject the adoption on any violation — the pre-reseat result was
        valid, so rejecting preserves validity."""
        # spec key mirrors the ground-truth validator: same selector + skew
        # but different node pins are DIFFERENT spread groups with different
        # eligible-zone sets — deduping on (selector, skew) alone would let
        # a zone-pinned pod (trivially in band over its one zone) mask an
        # unpinned group's violation.  Specs come from EVERY pod in the
        # adoption candidate whose selector matches a moved pod, not just
        # the moved pods' own constraints — a kept group's spread counts
        # the moved pod too (the oracle's observe() matches by selector,
        # regardless of which pod carries the constraint)
        nodes = list(re.existing_nodes) + list(re.nodes)
        moved_labels = [p.labels for p in moved]
        specs = {}
        for n in nodes:
            for q in n.pods:
                for tsc in q.topology_spread:
                    if not (tsc.hard and tsc.topology_key == L.ZONE):
                        continue
                    if not any(tsc.label_selector.matches(lb)
                               for lb in moved_labels):
                        continue
                    key = (tsc.label_selector, tsc.max_skew,
                           tuple(sorted(q.node_selector.items())),
                           tuple(q.volume_zone_requirements))
                    specs.setdefault(key, (tsc, q))
        if specs:
            all_zones: List[str] = []
            for it in instance_types:
                for o in it.offerings:
                    if o.zone not in all_zones:
                        all_zones.append(o.zone)
            for tsc, rep in specs.values():
                eligible = [
                    z for z in all_zones
                    if rep.node_selector.get(L.ZONE, z) == z
                    and all(r.value_set().contains(z)
                            for r in rep.volume_zone_requirements)
                ]
                if not eligible:
                    continue
                counts = {z: 0 for z in eligible}
                for n in nodes:
                    if n.zone in counts:
                        counts[n.zone] += sum(
                            1 for q in n.pods
                            if tsc.label_selector.matches(q.labels)
                        )
                if max(counts.values()) - min(counts.values()) > tsc.max_skew:
                    return False
        # hostname anti-affinity is enforced by the oracle only for the
        # INCOMING pod's own terms; a moved pod with no terms could land
        # beside a kept pod whose anti selector matches it.  Re-check every
        # node that received a moved pod bidirectionally (the validator's
        # rule: a pod's hostname-anti term may match at most one co-located
        # pod — itself)
        moved_names = {p.name for p in moved}
        for n in nodes:
            if not any(q.name in moved_names for q in n.pods):
                continue
            for q in n.pods:
                for term in q.affinity_terms:
                    if term.anti and term.topology_key == L.HOSTNAME:
                        matches = sum(
                            1 for r in n.pods
                            if term.label_selector.matches(r.labels)
                        )
                        if matches > 1:
                            return False
        # same bidirectional rule at zone scope: any pod in a zone that
        # received a moved pod may carry a zone anti-affinity term the
        # moved pod violates (at most one matching pod — itself — in the
        # zone)
        moved_zones = {n.zone for n in nodes
                       if any(q.name in moved_names for q in n.pods)}
        for z in moved_zones:
            zone_pods = [q for n in nodes if n.zone == z for q in n.pods]
            for q in zone_pods:
                for term in q.affinity_terms:
                    if term.anti and term.topology_key == L.ZONE:
                        matches = sum(
                            1 for r in zone_pods
                            if term.label_selector.matches(r.labels)
                        )
                        allowed = 1 if term.label_selector.matches(q.labels) else 0
                        if matches > allowed:
                            return False
        # kept pods' POSITIVE zone-affinity toward moved pods: a kept pod
        # whose only selector-matching zone-mate was a moved pod is orphaned
        # when the reseat moves that pod to another zone.  Conservative
        # global re-check (rejecting keeps the valid pre-reseat result):
        # every pod carrying a positive zone term whose selector matches any
        # moved pod must still have a matching pod in its own zone — itself
        # only when no matcher exists anywhere else (the mode-B seed shape).
        for n in nodes:
            for q in n.pods:
                for term in q.affinity_terms:
                    if term.anti or term.topology_key != L.ZONE:
                        continue
                    if not any(term.label_selector.matches(lb)
                               for lb in moved_labels):
                        continue  # the reseat moved nothing this term matches
                    if any(term.label_selector.matches(r.labels)
                           for nn in nodes if nn.zone == n.zone
                           for r in nn.pods if r.name != q.name):
                        continue
                    if term.label_selector.matches(q.labels) and not any(
                        term.label_selector.matches(r.labels)
                        for nn in nodes if nn.zone != n.zone
                        for r in nn.pods
                    ):
                        continue  # sole matcher anywhere: valid self-seed
                    return False
        # hard hostname spread on nodes that RECEIVED a moved pod: the
        # oracle enforces the incoming pod's own constraints only, so a
        # moved pod landing beside a kept spread-bearing pod can push that
        # node's matching count past the band (per-node cap is maxSkew —
        # an empty node keeps the global hostname minimum at 0)
        for n in nodes:
            if not any(q.name in moved_names for q in n.pods):
                continue
            for q in n.pods:
                for tsc in q.topology_spread:
                    if not (tsc.hard and tsc.topology_key == L.HOSTNAME):
                        continue
                    matches = sum(1 for r in n.pods
                                  if tsc.label_selector.matches(r.labels))
                    if matches > tsc.max_skew:
                        return False
        return True

    def _maybe_relax(
        self, result: SolveResult, hardened, provisioners, instance_types,
        daemonsets, unavailable, allow_new_nodes,
        max_new_nodes: Optional[int], relax: Optional[bool], trace,
    ) -> SolveResult:
        """Route a finished device-tier solve through the convex-relaxation
        rung (solver/relax.py) and ship min(scan, relax+round).

        ``relax`` is the caller's policy: False skips unconditionally,
        None defers to ``KT_RELAX`` (default on).  The rung refines only
        device-scan results — oracle-routed small / ct-spread batches and
        the oracle backend return untouched and uncounted (the outcome
        counter partitions rung evaluations, not solves) — and only
        unbudgeted provisioning solves: consolidation what-ifs
        (``max_new_nodes`` / ``allow_new_nodes``) are judged on
        feasibility at a fixed budget, not on node cost.  The program runs
        on the scheduler's device; the port compiles nothing, so the first
        solve of a shape runs the rung."""
        from . import relax as relax_mod

        if relax is False or not relax_mod.relax_enabled():
            return result
        if self.backend not in ("auto", "tpu"):
            return result  # the rung refines the device scan only
        if not allow_new_nodes or max_new_nodes is not None:
            return result
        tpu_pods = [p for p in hardened if not device_inexpressible(p)]
        if (not tpu_pods or len(tpu_pods) <= self.native_batch_limit
                or batch_needs_oracle(hardened)):
            # small batches are oracle-grade already (and under auto the
            # oracle served them — no scan to refine)
            return result
        if self._tensorize_cache is None:
            return result  # without cached tensorize the probe would pay
            # a full host build per solve — not the rung's trade
        if result.served_cold:
            relax_mod.record_outcome(self.registry, "skipped")
            return result
        try:
            # identity-tier hit: these are the same pod objects the solve
            # wave tensorized moments ago
            st, _tsec = self._tensorize(
                tpu_pods, provisioners, instance_types, daemonsets,
                unavailable, trace=trace)

            def _repair(stranded, seeds):
                # integrality repair: the scan, seeded from the rounded
                # fleet as existing-node state; never re-enters the rung
                return self.solve(
                    stranded, provisioners, instance_types,
                    existing_nodes=seeds, daemonsets=daemonsets,
                    unavailable=unavailable, allow_new_nodes=True,
                    relax=False, trace=trace)

            result, _outcome = relax_mod.refine(
                result, st, registry=self.registry, trace=trace,
                repair_solve=_repair, device=self.device)
            return result
        # the rung is an optimization layer — any routing failure ships
        # the proven scan solution as a fallback
        except Exception:
            logger.warning("relax rung routing failed; scan solution ships",
                           exc_info=True)
            relax_mod.record_outcome(self.registry, "fallback")
            return result

    def _solve_wave(
        self, pods, provisioners, instance_types, existing_nodes, daemonsets,
        unavailable, allow_new_nodes, max_new_nodes, first=None,
        trace=None,
    ) -> SolveResult:
        """One pod wave with the preference-relaxation ladder applied.
        ``first`` short-circuits the all-preferences-hardened opening solve
        when the caller already ran it."""
        result = first if first is not None else self._solve_once(
            [_harden_preferences(p) for p in pods], provisioners,
            instance_types, existing_nodes, daemonsets, unavailable,
            allow_new_nodes, max_new_nodes, trace=trace,
        )
        max_pref = min(
            max((_n_preferences(p) for p in pods), default=0),
            MAX_RELAXATION_WAVES,
        )
        for keep in range(max_pref - 1, -1, -1):
            retry = [p for p in pods if p.name in result.infeasible
                     and _n_preferences(p) > keep]
            if not retry:
                continue
            _merge(result, self._solve_once(
                [_harden_preferences(p, keep) for p in retry],
                provisioners, instance_types,
                list(result.existing_nodes) + result.nodes, daemonsets,
                unavailable, allow_new_nodes,
                _budget_left(result, max_new_nodes), trace=trace,
            ))
        return result

    def _solve_once(
        self, pods, provisioners, instance_types, existing_nodes, daemonsets,
        unavailable, allow_new_nodes, max_new_nodes, trace=None,
    ) -> SolveResult:
        # a hard capacity-type spread couples the whole batch to the
        # sequential engine (batch_needs_oracle) — every backend
        if (self.backend == "oracle" or self._route_small(len(pods))
                or batch_needs_oracle(pods)):
            t0 = time.perf_counter()
            try:
                return oracle_solve(
                    pods, provisioners, instance_types,
                    existing_nodes=existing_nodes, daemonsets=daemonsets,
                    unavailable=unavailable, allow_new_nodes=allow_new_nodes,
                    max_new_nodes=max_new_nodes,
                )
            finally:
                self.registry.histogram(SOLVER_BACKEND_DURATION).observe(
                    time.perf_counter() - t0, {"backend": "oracle"}
                )
        if self._route_hier(pods, existing_nodes, allow_new_nodes,
                            max_new_nodes):
            from .hierarchy import solve_hierarchical

            self.hier_stats = {}
            result = solve_hierarchical(
                self, pods, provisioners, instance_types,
                daemonsets=daemonsets, unavailable=unavailable, trace=trace,
                stats=self.hier_stats,
            )
            if result is not None:
                return result
            # None = one coupled component: flat is the right program
        return self._solve_tpu(
            pods, provisioners, instance_types, existing_nodes, daemonsets,
            unavailable, allow_new_nodes, max_new_nodes, trace=trace,
        )

    def _route_small(self, n_pods: int) -> bool:
        """auto-policy: batches of at most ``native_batch_limit`` pods are
        served by the sequential CPU oracle (exact-parity FFD at ms
        latency for any constraint shape)."""
        return self.backend == "auto" and n_pods <= self.native_batch_limit

    def _route_hier(self, pods, existing_nodes, allow_new_nodes,
                    max_new_nodes) -> bool:
        """Hierarchical routing gate: block decomposition at/above
        ``KT_HIER_THRESHOLD`` pods — greenfield batches only (no existing
        nodes, unbounded budget), with no device-inexpressible pods, and
        never from inside a hierarchical repair."""
        from .hierarchy import hier_threshold

        thr = hier_threshold()
        return (
            thr > 0
            and not self._hier_depth
            and self.backend in ("auto", "tpu")
            and len(pods) >= thr
            and not existing_nodes
            and allow_new_nodes
            and max_new_nodes is None
            and not any(device_inexpressible(p) for p in pods)
        )

    def _tensorize(self, pods, provisioners, instance_types, daemonsets,
                   unavailable, trace=NULL_TRACE) -> Tuple["object", float]:
        """Host tensorize through the incremental cache (steady state: a
        lookup plus a counts vector — models/tensorize.TensorizeCache).
        Returns (tensors, seconds spent)."""
        t0 = time.perf_counter()
        with trace.span("tensorize") as span:
            if self._tensorize_cache is not None:
                st, tier = self._tensorize_cache.tensorize(
                    pods, provisioners, instance_types,
                    daemonsets=daemonsets, unavailable=unavailable)
            else:
                st = tensorize(pods, provisioners, instance_types,
                               daemonsets=daemonsets, unavailable=unavailable)
                tier = "off"
            span.annotate(tier=tier)
        dt = time.perf_counter() - t0
        self.registry.histogram(TENSORIZE_DURATION).observe(dt)
        if tier in ("identity", "shape"):
            self.registry.counter(TENSORIZE_CACHE_HITS).inc({"tier": tier})
        elif tier == "miss":
            self.registry.counter(TENSORIZE_CACHE_MISSES).inc()
        return st, dt

    def _solve_tpu(
        self, pods, provisioners, instance_types, existing_nodes, daemonsets,
        unavailable, allow_new_nodes, max_new_nodes, trace=None,
    ) -> SolveResult:
        """Device-tier wave with the oracle carve-out for pods the device
        solve can't express."""
        trace = trace or NULL_TRACE
        tpu_pods = [p for p in pods if not device_inexpressible(p)]
        cpu_pods = [p for p in pods if device_inexpressible(p)]

        # positive affinity couples the two batches: whichever side's
        # affinity selectors match the other side's pods must solve SECOND
        def _refers(src, dst):
            sels = [t.label_selector for p in src for t in p.affinity_terms
                    if not t.anti]
            return any(s.matches(q.labels) for s in sels for q in dst)

        cpu_first = bool(cpu_pods and tpu_pods
                         and _refers(tpu_pods, cpu_pods)
                         and not _refers(cpu_pods, tpu_pods))

        # placed-snapshot chaining: each stage solves against the previous
        # stage's PLACED existing snapshots (+ placed prior new nodes)
        cur_existing: List[SimNode] = list(existing_nodes)
        nodes: List[SimNode] = []
        assignments: Dict[str, str] = {}
        infeasible: Dict[str, str] = {}
        solve_ms = 0.0
        tensorize_ms = 0.0

        def chain(res: SolveResult) -> None:
            nonlocal cur_existing, nodes
            cur_existing, nodes = _adopt_placed(cur_existing, res)

        if cpu_first:
            res0 = oracle_solve(
                cpu_pods, provisioners, instance_types,
                existing_nodes=cur_existing, daemonsets=daemonsets,
                unavailable=unavailable, allow_new_nodes=allow_new_nodes,
                max_new_nodes=max_new_nodes,
            )
            chain(res0)
            assignments.update(res0.assignments)
            infeasible.update(res0.infeasible)
            solve_ms += res0.solve_ms
            cpu_pods = []
            if max_new_nodes is not None:
                max_new_nodes = max(0, max_new_nodes - len(res0.nodes))

        if tpu_pods:
            st, tsec = self._tensorize(
                tpu_pods, provisioners, instance_types, daemonsets,
                unavailable, trace=trace)
            tensorize_ms += tsec * 1000.0
            t0 = time.perf_counter()
            new_budget = len(tpu_pods) if max_new_nodes is None else max_new_nodes
            all_existing = list(cur_existing) + nodes
            max_slots = len(all_existing) + new_budget
            res = self._tpu.solve(
                st, existing_nodes=all_existing, max_nodes=max_slots,
                trace=trace,
            ).result
            trace.annotate(backend_used="tpu")
            self.registry.histogram(SOLVER_BACKEND_DURATION).observe(
                time.perf_counter() - t0, {"backend": "tpu"})
            if not allow_new_nodes and res.nodes:
                # consolidation what-if with no new nodes allowed: pods that
                # needed new nodes are infeasible
                for n in res.nodes:
                    for p in n.pods:
                        infeasible[p.name] = "needs a new node (disallowed)"
                res.nodes = []
                for p in list(res.assignments):
                    if p in infeasible:
                        del res.assignments[p]
            chain(res)
            assignments.update(res.assignments)
            infeasible.update(res.infeasible)
            solve_ms += res.solve_ms

        if cpu_pods:
            t0c = time.perf_counter()
            res2 = oracle_solve(
                cpu_pods, provisioners, instance_types,
                existing_nodes=list(cur_existing) + nodes,
                daemonsets=daemonsets, unavailable=unavailable,
                allow_new_nodes=allow_new_nodes,
                max_new_nodes=None if max_new_nodes is None else max(0, max_new_nodes - len(nodes)),
            )
            self.registry.histogram(SOLVER_BACKEND_DURATION).observe(
                time.perf_counter() - t0c, {"backend": "oracle"}
            )
            chain(res2)
            assignments.update(res2.assignments)
            infeasible.update(res2.infeasible)
            solve_ms += res2.solve_ms
        return SolveResult(
            nodes=nodes,
            assignments=assignments,
            infeasible=infeasible,
            existing_nodes=cur_existing,
            solve_ms=solve_ms,
            tensorize_ms=tensorize_ms,
        )
