"""CPU reference solver — faithful sequential first-fit-decreasing bin-packer.

This is the correctness oracle and cost baseline (BASELINE.md: "implement a
faithful Go-/CPU-reference FFD ... inside our repo").  Semantics follow
upstream karpenter designs/bin-packing.md:28-43 (FFD: sort decreasing, first-fit
onto open nodes, new node chosen to pack maximal pods cheaply) and
website/content/en/preview/concepts/scheduling.md (requirements layering,
taints, topology spread skew checks, pod (anti-)affinity).

The TPU solver (solver/tpu.py) must match this oracle's node cost within 1.02x
on the BASELINE.json configs; both share the FFD ordering key and the
new-node scoring policy:

    score(pod, candidate, offering) = price / min(pods_per_node, remaining_in_group)

i.e. "cheapest $/pod for the pods we still have to place", reproducing
bin-packing.md step 3's "maximal number of pods at lowest cost" selection.

Implementation note: pods are placed strictly one at a time (exact sequential
semantics — each placement updates topology-spread counts before the next),
but identical pods are processed as a contiguous *group run* with per-zone
node heaps so the whole solve is O(G*N + P*Z*log N) instead of O(P*N); at
50k pods this is the difference between milliseconds and minutes, and it is
what the Go scheduler's in-flight node list achieves with incremental state.
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from ..models import labels as L
from ..models.instancetype import InstanceType
from ..models.pod import PodSpec
from ..models.provisioner import Provisioner
from ..models.requirements import IN, Requirements
from ..models.resources import ResourceList, add, fits
from ..models.tensorize import PodGroup, build_candidates, group_pods
from .types import SimNode, SolveResult


class _TopologyState:
    """Counts of selector-matching pods per zone / node / capacity-type /
    total (the reference's three topology domains, scheduling.md:303-346)."""

    def __init__(self) -> None:
        self.zone: Dict[tuple, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self.node: Dict[tuple, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self.ct: Dict[tuple, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self.total: Dict[tuple, int] = defaultdict(int)

    def observe(self, pod: PodSpec, zone: str, node_name: str, selectors,
                ct: str = "") -> None:
        for key, sel in selectors.items():
            if sel.matches(pod.labels):
                self.zone[key][zone] += 1
                self.node[key][node_name] += 1
                if ct:
                    self.ct[key][ct] += 1
                self.total[key] += 1


def _selector_table(pods: Sequence[PodSpec]) -> Dict[tuple, object]:
    out: Dict[tuple, object] = {}
    for p in pods:
        for tsc in p.topology_spread:
            if tsc.hard:
                out[(tsc.label_selector, tsc.topology_key, "spread")] = tsc.label_selector
        for t in p.affinity_terms:
            kind = "anti" if t.anti else "affinity"
            out[(t.label_selector, t.topology_key, kind)] = t.label_selector
    return out


class _Solver:
    def __init__(
        self,
        pods: Sequence[PodSpec],
        provisioners: Sequence[Provisioner],
        instance_types: Sequence[InstanceType],
        existing_nodes: Sequence[SimNode],
        daemonsets: Sequence[PodSpec],
        unavailable: Set[tuple],
        allow_new_nodes: bool,
        max_new_nodes: Optional[int],
    ) -> None:
        self.groups = group_pods(pods)
        self.pairs = build_candidates(provisioners, instance_types)
        self.daemonsets = daemonsets
        self.unavailable = unavailable
        self.allow_new_nodes = allow_new_nodes
        self.max_new_nodes = max_new_nodes
        self.selectors = _selector_table(
            list(pods) + [p for n in existing_nodes for p in n.pods]
        )
        self.topo = _TopologyState()
        self.nodes: List[SimNode] = list(existing_nodes)  # creation order
        self.new_nodes: List[SimNode] = []
        self.assignments: Dict[str, str] = {}
        self.infeasible: Dict[str, str] = {}
        self.prov_usage: Dict[str, ResourceList] = defaultdict(dict)
        self._label_ok_cache: Dict[tuple, bool] = {}
        self._ds_cache: Dict[Tuple[str, str], ResourceList] = {}
        # per-node caches keyed by identity (nodes are this solve's private
        # snapshots): label signature never changes mid-solve; remaining()
        # changes only on _bind, which invalidates.  The heap build calls
        # _group_cap for every (group, node) pair — at 2k existing nodes the
        # uncached remaining()/sig-sort work dominated consolidation
        # what-ifs (O(G*N) * O(pods_per_node))
        self._sig_cache: Dict[int, tuple] = {}
        self._rem_cache: Dict[int, ResourceList] = {}
        # label keys any group's requirements reference: _node_sig keeps only
        # these, so a per-node hostname label doesn't split an otherwise
        # uniform fleet into N signatures and defeat _label_ok_cache (the
        # heap build asks _label_taint_ok for every (group, node) pair —
        # O(G*N) requirement-algebra walks at consolidation-what-if scale
        # without the collapse)
        self._relevant_keys: Set[str] = set()
        for g in self.groups:
            self._relevant_keys.update(g.requirements)

        self.all_zones: List[str] = []
        for _, _, it, _ in self.pairs:
            for o in it.offerings:
                if o.zone not in self.all_zones:
                    self.all_zones.append(o.zone)

        # limits bind on raw machine CAPACITY (the validator and creation-time
        # checks both use it.capacity); counting existing nodes at allocatable
        # under-counts their usage by the reserved overhead and lets the last
        # new node overshoot the limit (fuzz seed 23)
        raw_cap = {it.name: it.capacity for _, _, it, _ in self.pairs}
        for n in existing_nodes:
            cap = raw_cap.get(n.instance_type, n.allocatable)
            self.prov_usage[n.provisioner] = add(
                self.prov_usage[n.provisioner],
                {L.RESOURCE_CPU: cap.get(L.RESOURCE_CPU, 0.0),
                 L.RESOURCE_MEMORY: cap.get(L.RESOURCE_MEMORY, 0.0)},
            )
            for p in n.pods:
                self.topo.observe(p, n.zone, n.name, self.selectors,
                                  ct=n.capacity_type)

    # ---- per-(group,node-shape) caches --------------------------------
    def _node_sig(self, node: SimNode) -> tuple:
        sig = self._sig_cache.get(id(node))
        if sig is None:
            sig = (
                node.instance_type, node.provisioner, node.capacity_type,
                tuple(sorted((k, v) for k, v in node.labels.items()
                             if k in self._relevant_keys)),
                tuple(node.taints),
            )
            self._sig_cache[id(node)] = sig
        return sig

    def _remaining(self, node: SimNode) -> ResourceList:
        rem = self._rem_cache.get(id(node))
        if rem is None:
            rem = node.remaining()
            self._rem_cache[id(node)] = rem
        return rem

    def _label_taint_ok(self, g: PodGroup, node: SimNode) -> bool:
        key = (id(g), self._node_sig(node))
        got = self._label_ok_cache.get(key)
        if got is None:
            rep = g.pods[0]
            got = not any(t.blocks(rep.tolerations) for t in node.taints) and (
                g.requirements.compatible(node.labels) is None
            )
            self._label_ok_cache[key] = got
        return got

    def _daemon_overhead(self, prov: Provisioner, it: InstanceType) -> ResourceList:
        key = (prov.name, it.name)
        got = self._ds_cache.get(key)
        if got is None:
            total: ResourceList = {}
            labels = {**it.labels(), **prov.labels}
            for d in self.daemonsets:
                if any(t.blocks(d.tolerations) for t in prov.taints):
                    continue
                if any(r.compatible(labels) is not None for r in d.scheduling_requirements()):
                    continue
                total = add(total, d.requests)
                total[L.RESOURCE_PODS] = total.get(L.RESOURCE_PODS, 0.0) + 1.0
            self._ds_cache[key] = got = total
        return got

    # ---- topology checks -----------------------------------------------
    def _zone_allowed(self, g: PodGroup, zone: str, eligible: Sequence[str]) -> bool:
        rep = g.pods[0]
        for tsc in rep.topology_spread:
            if not tsc.hard or tsc.topology_key != L.ZONE:
                continue
            key = (tsc.label_selector, L.ZONE, "spread")
            counts = self.topo.zone[key]
            min_count = min((counts.get(z, 0) for z in eligible), default=0)
            if counts.get(zone, 0) + 1 - min_count > tsc.max_skew:
                return False
        for term in rep.affinity_terms:
            if term.topology_key != L.ZONE:
                continue
            key = (term.label_selector, L.ZONE, "anti" if term.anti else "affinity")
            if term.anti:
                if self.topo.zone[key].get(zone, 0) > 0:
                    return False
            else:
                if self.topo.total[key] > 0:
                    if self.topo.zone[key].get(zone, 0) == 0:
                        return False
                elif not term.matches_pod(rep):
                    return False
        return True

    def _ct_allowed(self, g: PodGroup, ct: str, eligible: Sequence[str]) -> bool:
        """Hard capacity-type topology spread (scheduling.md:303-346 — the
        third supported topologyKey; the canonical use is spreading replicas
        across spot/on-demand to bound the interruption blast radius)."""
        rep = g.pods[0]
        for tsc in rep.topology_spread:
            if not tsc.hard or tsc.topology_key != L.CAPACITY_TYPE:
                continue
            key = (tsc.label_selector, L.CAPACITY_TYPE, "spread")
            counts = self.topo.ct[key]
            min_count = min((counts.get(c, 0) for c in eligible), default=0)
            if counts.get(ct, 0) + 1 - min_count > tsc.max_skew:
                return False
        return True

    def _eligible_cts(self, g: PodGroup, eligible_zones: Sequence[str]) -> List[str]:
        """Capacity-type domains this group could actually use: the cts some
        tolerable (provisioner, type, offering) admits under the merged and
        pod-level requirements, IN A ZONE the group may use (k8s semantics
        judge skew over nodeAffinity-filtered domains — a ct offered only in
        a zone the pod's selector or volume pin excludes is not a domain the
        spread can level against).  Skew is judged over reachable domains
        (the reference computes domains from the provisioners' requirement
        union, not a global constant set — a spot-only cluster must not
        strand an on-demand count at zero forever)."""
        rep = g.pods[0]
        pod_ct = g.requirements.get(L.CAPACITY_TYPE)
        zone_ok = set(eligible_zones)
        out: List[str] = []
        for _, prov, it, merged in self.pairs:
            if not prov.tolerates(rep):
                continue
            if g.requirements.intersects(merged) is not None:
                continue
            merged_ct = merged.get(L.CAPACITY_TYPE)
            merged_zone = merged.get(L.ZONE)
            for o in it.offerings:
                if (o.capacity_type not in out and o.available
                        and o.zone in zone_ok
                        and merged_zone.contains(o.zone)
                        and (it.name, o.zone, o.capacity_type) not in self.unavailable
                        and merged_ct.contains(o.capacity_type)
                        and pod_ct.contains(o.capacity_type)):
                    out.append(o.capacity_type)
        return sorted(out)

    def _host_cap(self, g: PodGroup, node: SimNode) -> float:
        """Max additional pods of g on this node from hostname-scoped rules
        (inf = unbounded)."""
        rep = g.pods[0]
        cap = float("inf")
        for tsc in rep.topology_spread:
            if not tsc.hard or tsc.topology_key != L.HOSTNAME:
                continue
            key = (tsc.label_selector, L.HOSTNAME, "spread")
            cap = min(cap, tsc.max_skew - self.topo.node[key].get(node.name, 0))
        for term in rep.affinity_terms:
            if term.topology_key != L.HOSTNAME:
                continue
            key = (term.label_selector, L.HOSTNAME, "anti" if term.anti else "affinity")
            have = self.topo.node[key].get(node.name, 0)
            if term.anti:
                if have > 0:
                    return 0.0
                # a self-matching group may put exactly one pod here
                if term.matches_pod(rep):
                    cap = min(cap, 1.0)
            else:
                if self.topo.total[key] > 0 and have == 0:
                    return 0.0
                if self.topo.total[key] == 0 and not term.matches_pod(rep):
                    return 0.0
        return cap

    def _new_node_host_cap(self, g: PodGroup) -> float:
        """Cap for pods of g on a brand-new empty node (hostname-scoped rules)."""
        rep = g.pods[0]
        cap = float("inf")
        for tsc in rep.topology_spread:
            if tsc.hard and tsc.topology_key == L.HOSTNAME:
                cap = min(cap, float(tsc.max_skew))
        for term in rep.affinity_terms:
            if term.topology_key != L.HOSTNAME:
                continue
            key = (term.label_selector, L.HOSTNAME, "anti" if term.anti else "affinity")
            if term.anti:
                if term.matches_pod(rep):
                    cap = min(cap, 1.0)
            else:
                # positive affinity: an empty node has no matching pods, so it
                # only works when the group seeds its own affinity domain
                if self.topo.total[key] > 0 or not term.matches_pod(rep):
                    return 0.0
        return cap

    # ---- main loop ------------------------------------------------------
    def run(self) -> None:
        for g in self.groups:
            self._place_group(g)

    def _group_cap(self, g: PodGroup, node: SimNode, req: ResourceList) -> int:
        """How many pods of g this node can take right now."""
        if not self._label_taint_ok(g, node):
            return 0
        rem = self._remaining(node)
        cap = float("inf")
        for k, v in req.items():
            if v > 0:
                cap = min(cap, rem.get(k, 0.0) // v)
        cap = min(cap, self._host_cap(g, node))
        return max(0, int(cap))

    def _place_group(self, g: PodGroup) -> None:
        rep = g.pods[0]
        req = dict(g.requests)
        req.setdefault(L.RESOURCE_PODS, 1.0)
        pod_reqs = g.requirements
        zone_req = pod_reqs.get(L.ZONE)
        eligible = [z for z in self.all_zones if zone_req.contains(z)]
        has_zone_rules = any(
            (t.hard and t.topology_key == L.ZONE) for t in rep.topology_spread
        ) or any(t.topology_key == L.ZONE for t in rep.affinity_terms)

        unsupported = [t.topology_key for t in rep.topology_spread
                       if t.hard and t.topology_key not in
                       (L.ZONE, L.HOSTNAME, L.CAPACITY_TYPE)]
        unsupported += [t.topology_key for t in rep.affinity_terms
                        if t.topology_key not in (L.ZONE, L.HOSTNAME)]
        if unsupported:
            # the reference supports exactly three spread topologyKeys
            # (scheduling.md:339-343) and zone/hostname (anti-)affinity —
            # silently dropping a required constraint is never acceptable
            # (a dropped anti-affinity co-locates the replicas it separates)
            for pod in g.pods:
                self.infeasible[pod.name] = (
                    f"unsupported topology key {unsupported[0]!r}")
            return

        if any(t.hard and t.topology_key == L.CAPACITY_TYPE
               for t in rep.topology_spread):
            # rare path: capacity-type spread constrains the (zone, ct)
            # domain per placement, which the per-zone heaps can't express —
            # place this group with a direct first-fit scan instead (exact
            # semantics; O(P*N) only for ct-spread groups)
            self._place_group_ct(g, req, pod_reqs, eligible, has_zone_rules)
            return

        # per-zone heaps of (creation_index, capacity_left) for open nodes
        heaps: Dict[str, list] = defaultdict(list)
        for idx, node in enumerate(self.nodes):
            cap = self._group_cap(g, node, req)
            if cap > 0:
                heapq.heappush(heaps[node.zone], [idx, cap, node])

        best_new: Dict[str, Optional[tuple]] = {}  # zone -> (score..) or None

        placed = 0
        for pod in g.pods:
            zones = [z for z in eligible if self._zone_allowed(g, z, eligible)] \
                if has_zone_rules else eligible
            # earliest-created compatible node across allowed zones (first-fit)
            chosen = None
            for z in zones:
                h = heaps.get(z)
                if h and (chosen is None or h[0][0] < chosen[0]):
                    chosen = h[0]
            if chosen is not None:
                node = chosen[2]
                self._bind(pod, node)
                chosen[1] -= 1
                if chosen[1] <= 0:
                    heapq.heappop(heaps[node.zone])
                placed += 1
                continue

            # no open node: create one
            if not self.allow_new_nodes:
                self.infeasible[pod.name] = "no existing node fits and new nodes disallowed"
                continue
            if self._new_node_host_cap(g) < 1:
                self.infeasible[pod.name] = "hostname-scoped affinity forbids a new node"
                continue
            if self.max_new_nodes is not None and len(self.new_nodes) >= self.max_new_nodes:
                self.infeasible[pod.name] = "new-node budget exhausted"
                continue
            node = self._create_node(g, req, pod_reqs, zones, g.count - placed, best_new)
            if node is None:
                self.infeasible[pod.name] = "no feasible (provisioner, instance type, offering)"
                continue
            cap = self._group_cap(g, node, req)
            self._bind(pod, node)
            placed += 1
            if cap - 1 > 0:
                heapq.heappush(heaps[node.zone], [len(self.nodes) - 1, cap - 1, node])

    def _place_group_ct(
        self, g: PodGroup, req: ResourceList, pod_reqs: Requirements,
        eligible: Sequence[str], has_zone_rules: bool,
    ) -> None:
        """Sequential placement for groups carrying a hard capacity-type
        spread: every placement re-derives the allowed (zone, ct) domains,
        first-fits the earliest-created compatible node, else creates a node
        restricted to the allowed cts.  No heaps/caches — exactness over
        speed on this rare constraint shape."""
        eligible_cts = self._eligible_cts(g, eligible)
        placed = 0
        for pod in g.pods:
            zones = ([z for z in eligible if self._zone_allowed(g, z, eligible)]
                     if has_zone_rules else list(eligible))
            cts = [c for c in eligible_cts
                   if self._ct_allowed(g, c, eligible_cts)]
            if not cts:
                self.infeasible[pod.name] = (
                    "capacity-type spread skew exhausted in every domain")
                continue
            chosen = None
            for idx, node in enumerate(self.nodes):
                if node.zone not in zones or node.capacity_type not in cts:
                    continue
                if self._group_cap(g, node, req) > 0:
                    chosen = node
                    break
            if chosen is not None:
                self._bind(pod, chosen)
                placed += 1
                continue
            if not self.allow_new_nodes:
                self.infeasible[pod.name] = (
                    "no existing node fits and new nodes disallowed")
                continue
            if self._new_node_host_cap(g) < 1:
                self.infeasible[pod.name] = (
                    "hostname-scoped affinity forbids a new node")
                continue
            if (self.max_new_nodes is not None
                    and len(self.new_nodes) >= self.max_new_nodes):
                self.infeasible[pod.name] = "new-node budget exhausted"
                continue
            # fresh best_new per pod: the allowed-ct set changes per
            # placement, so the per-zone score cache must not carry over
            node = self._create_node(g, req, pod_reqs, zones,
                                     g.count - placed, {}, allowed_cts=cts)
            if node is None:
                self.infeasible[pod.name] = (
                    "no feasible (provisioner, instance type, offering)")
                continue
            self._bind(pod, node)
            placed += 1

    def _bind(self, pod: PodSpec, node: SimNode) -> None:
        node.pods.append(pod)
        self._rem_cache.pop(id(node), None)  # remaining() changed
        self.assignments[pod.name] = node.name
        self.topo.observe(pod, node.zone, node.name, self.selectors,
                          ct=node.capacity_type)

    def _create_node(
        self,
        g: PodGroup,
        req: ResourceList,
        pod_reqs: Requirements,
        allowed_zones: Sequence[str],
        remaining: int,
        best_new: Dict[str, Optional[tuple]],
        allowed_cts: Optional[Sequence[str]] = None,
    ) -> Optional[SimNode]:
        """Pick min-score (candidate, offering) over allowed zones, create node."""
        best = None
        for z in allowed_zones:
            if z not in best_new:
                best_new[z] = self._best_in_zone(g, req, pod_reqs, z, remaining,
                                                 allowed_cts=allowed_cts)
            b = best_new[z]
            if b is not None and (best is None or b[0] < best[0]):
                best = b
        if best is None:
            return None
        _, prov, it, merged, o, eff_alloc = best

        # provisioner limits re-check at creation time (usage moved since scoring)
        if prov.limits:
            usage = self.prov_usage[prov.name]
            if any(
                usage.get(rk, 0.0) + it.capacity.get(rk, 0.0) > prov.limits[rk] + 1e-9
                for rk in prov.limits
            ):
                # invalidate zone caches that chose this provisioner and retry once
                for z in list(best_new):
                    if best_new[z] is not None and best_new[z][1] is prov:
                        best_new[z] = self._best_in_zone(
                            g, req, pod_reqs, z, remaining,
                            allowed_cts=allowed_cts)
                return self._create_node(g, req, pod_reqs, allowed_zones,
                                         remaining, best_new,
                                         allowed_cts=allowed_cts)

        labels = {**it.labels(), **prov.labels}
        for r in merged.to_list() + pod_reqs.to_list():
            if r.operator == IN and len(r.values) == 1 and r.key not in labels:
                labels[r.key] = r.values[0]
        node = SimNode(
            instance_type=it.name,
            provisioner=prov.name,
            zone=o.zone,
            capacity_type=o.capacity_type,
            price=o.price,
            allocatable=eff_alloc,
            labels=labels,
            taints=list(prov.taints),
        )
        node.labels[L.ZONE] = o.zone
        node.labels[L.CAPACITY_TYPE] = o.capacity_type
        node.labels[L.PROVISIONER_NAME] = prov.name
        node.labels[L.INSTANCE_TYPE] = it.name
        node.labels[L.HOSTNAME] = node.name
        self.nodes.append(node)
        self.new_nodes.append(node)
        self.prov_usage[prov.name] = add(
            self.prov_usage[prov.name],
            {L.RESOURCE_CPU: it.capacity.get(L.RESOURCE_CPU, 0.0),
             L.RESOURCE_MEMORY: it.capacity.get(L.RESOURCE_MEMORY, 0.0)},
        )
        return node

    def _best_in_zone(
        self, g: PodGroup, req: ResourceList, pod_reqs: Requirements,
        zone: str, remaining: int,
        allowed_cts: Optional[Sequence[str]] = None,
    ) -> Optional[tuple]:
        rep = g.pods[0]
        pod_ct = pod_reqs.get(L.CAPACITY_TYPE)
        best = None
        for ci, (pi, prov, it, merged) in enumerate(self.pairs):
            if not prov.tolerates(rep):
                continue
            if pod_reqs.intersects(merged) is not None:
                continue
            overhead = self._daemon_overhead(prov, it)
            eff_alloc = {k: v - overhead.get(k, 0.0) for k, v in it.allocatable.items()}
            if not fits(req, eff_alloc):
                continue
            if prov.limits:
                usage = self.prov_usage[prov.name]
                if any(
                    usage.get(rk, 0.0) + it.capacity.get(rk, 0.0) > prov.limits[rk] + 1e-9
                    for rk in prov.limits
                ):
                    continue
            ppn = _pods_per_node(req, eff_alloc)
            if ppn < 1:
                continue
            denom = max(1, min(ppn, remaining))
            merged_zone = merged.get(L.ZONE)
            merged_ct = merged.get(L.CAPACITY_TYPE)
            for oi, o in enumerate(it.offerings):
                if o.zone != zone:
                    continue
                if not o.available or (it.name, o.zone, o.capacity_type) in self.unavailable:
                    continue
                if not merged_zone.contains(o.zone):
                    continue
                if not (merged_ct.contains(o.capacity_type) and pod_ct.contains(o.capacity_type)):
                    continue
                if allowed_cts is not None and o.capacity_type not in allowed_cts:
                    continue  # capacity-type spread skew forbids this ct now
                score = (o.price / denom, o.price, ci, oi)
                if best is None or score < best[0]:
                    best = (score, prov, it, merged, o, eff_alloc)
        return best


def _pods_per_node(req: ResourceList, alloc: ResourceList) -> int:
    ppn = float("inf")
    for k, v in req.items():
        if v <= 0:
            continue
        ppn = min(ppn, alloc.get(k, 0.0) // v)
    return int(ppn) if ppn != float("inf") else 0


def solve(
    pods: Sequence[PodSpec],
    provisioners: Sequence[Provisioner],
    instance_types: Sequence[InstanceType],
    *,
    existing_nodes: Sequence[SimNode] = (),
    daemonsets: Sequence[PodSpec] = (),
    unavailable: Optional[Set[tuple]] = None,
    allow_new_nodes: bool = True,
    max_new_nodes: Optional[int] = None,
) -> SolveResult:
    """Run the sequential FFD pack.  ``existing_nodes`` are tried first-fit
    before any new node is proposed (provisioning hot path SURVEY §3.2 step 3;
    the consolidation what-if reuses this with ``allow_new_nodes``/
    ``max_new_nodes`` — §3.3)."""
    t0 = time.perf_counter()
    # snapshots: simulated placements must not leak into the caller's nodes
    existing = [n.snapshot() for n in existing_nodes]
    s = _Solver(
        pods, provisioners, instance_types, existing, list(daemonsets),
        unavailable or set(), allow_new_nodes, max_new_nodes,
    )
    s.run()
    return SolveResult(
        nodes=s.new_nodes,
        assignments=s.assignments,
        infeasible=s.infeasible,
        existing_nodes=existing,
        solve_ms=(time.perf_counter() - t0) * 1000.0,
    )
