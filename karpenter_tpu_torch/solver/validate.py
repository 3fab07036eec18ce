"""Ground-truth validity of a ``SolveResult``, independent of any solver.

A copy of the reference repository's test-side validator
(``validate_solution`` in its differential fuzz suite), so that the port's
own code — the bench's relax probe — can check a plan without importing
the reference.  It is not a comparison with the oracle but the rules
themselves: resource fit (pod density included), provisioner limits on new
capacity, taints and node selectors, hard zone-spread skew over the
eligible zones, hostname anti-affinity, and hard capacity-type spread over
the capacity types reachable through tolerable provisioners.  A batched
solver may legitimately seat MORE pods than the sequential oracle;
"better" must still be "valid".

Only pods of the checked batch are judged: filler pods already on
existing nodes count toward capacity but are not themselves validated.
The validator does not ask whether every pod of the batch is accounted
for; :func:`unaccounted_pods` does.
"""

from __future__ import annotations

from typing import List, Sequence

from ..models import labels as L

DEFAULT_ZONES = ("zone-1a", "zone-1b", "zone-1c")


def validate_solution(pods, provs, res, catalog=(),
                      all_zones: Sequence[str] = DEFAULT_ZONES,
                      unavailable=()) -> List[str]:
    """Every rule ``res`` breaks for ``pods`` under ``provs`` and
    ``catalog``, as one message each; ``[]`` when the plan is valid."""
    errs: List[str] = []
    nodes = list(res.existing_nodes) + list(res.nodes)
    by_name = {p.name: p for p in pods}
    # limits are enforced against RAW instance capacity, not allocatable
    # (tensorize's candidate capacity / the oracle's it.capacity)
    raw_cap = {it.name: it.capacity for it in catalog}

    def node_cap(n, rname):
        return raw_cap.get(n.instance_type, n.allocatable).get(rname, 0.0)

    # resource fit (incl. pod density)
    for node in nodes:
        for k, v in node.used().items():
            if v > node.allocatable.get(k, 0.0) + 1e-6:
                errs.append(f"{node.name} overcommitted on {k}: {v}")

    # provisioner limits: NEW capacity must fit the headroom left by the
    # existing fleet (pre-existing over-limit nodes are legal — limits can
    # be lowered after creation — the solver must just not add capacity)
    for prov in provs:
        for rname, lim in prov.limits.items():
            pre = sum(node_cap(n, rname) for n in res.existing_nodes
                      if n.provisioner == prov.name)
            new = sum(node_cap(n, rname) for n in res.nodes
                      if n.provisioner == prov.name)
            if new > max(0.0, lim - pre) + 1e-6:
                errs.append(
                    f"{prov.name} new {rname} {new} over headroom {lim}-{pre}")

    # taints / node selectors for every placement of a checked pod
    for node in nodes:
        eff = {  # solver-built nodes carry zone/ct/type as fields, not labels
            **node.labels,
            L.ZONE: node.zone,
            L.CAPACITY_TYPE: node.capacity_type,
            L.INSTANCE_TYPE: node.instance_type,
            L.HOSTNAME: node.name,
        }
        for p in node.pods:
            if p.name not in by_name:
                continue  # filler pod
            for t in node.taints:
                if t.blocks(p.tolerations):
                    errs.append(
                        f"{p.name} on {node.name}: intolerable taint {t.key}")
            for k, v in p.node_selector.items():
                if eff.get(k) != v:
                    errs.append(
                        f"{p.name} on {node.name}: selector {k}={v} unmet")

    # hard zone spread: skew over ALL eligible zones (capacity-stuck included)
    groups: dict = {}
    for node in nodes:
        for p in node.pods:
            if p.name not in by_name:
                continue
            for tsc in p.topology_spread:
                if (tsc.when_unsatisfiable != "DoNotSchedule"
                        or tsc.topology_key != L.ZONE):
                    continue
                key = (tsc.label_selector, tsc.max_skew,
                       tuple(sorted(p.node_selector.items())),
                       tuple(p.volume_zone_requirements))
                groups.setdefault(key, {}).setdefault(node.zone, 0)
                groups[key][node.zone] += 1
    for (_sel, skew, node_sel, vol_reqs), counts in groups.items():
        # eligibility narrows by node_selector AND volume pins: skew is
        # judged over the zones the pod could actually use
        eligible = [z for z in all_zones
                    if dict(node_sel).get(L.ZONE, z) == z
                    and all(r.value_set().contains(z) for r in vol_reqs)]
        lo = min(counts.get(z, 0) for z in eligible)
        hi = max(counts.get(z, 0) for z in eligible)
        if hi - lo > skew:
            errs.append(
                f"zone spread violated: {dict(counts)} skew {hi - lo} > {skew}")

    # hostname anti-affinity: at most one matching pod per node
    for node in nodes:
        for p in node.pods:
            if p.name not in by_name:
                continue
            for term in p.affinity_terms:
                if term.anti and term.topology_key == L.HOSTNAME:
                    matches = sum(1 for q in node.pods
                                  if term.label_selector.matches(q.labels))
                    if matches > 1:
                        errs.append(
                            f"{node.name}: {matches} anti-affine pods "
                            "co-located")

    # hard capacity-type spread: skew over the capacity types REACHABLE
    # through tolerable provisioners (the oracle's eligible set)
    ct_groups: dict = {}
    for node in nodes:
        for p in node.pods:
            if p.name not in by_name:
                continue
            for tsc in p.topology_spread:
                if (tsc.when_unsatisfiable != "DoNotSchedule"
                        or tsc.topology_key != L.CAPACITY_TYPE):
                    continue
                key = (tsc.label_selector, tsc.max_skew, p.owner_key)
                info = ct_groups.setdefault(key, {"pod": p, "counts": {}})
                info["counts"][node.capacity_type] = (
                    info["counts"].get(node.capacity_type, 0) + 1)
    for (_sel, skew, _owner), info in ct_groups.items():
        rep = info["pod"]
        eligible = set()
        for prov in provs:
            if not prov.tolerates(rep):
                continue
            ctr = next((r for r in prov.requirements
                        if r.key == L.CAPACITY_TYPE), None)
            for it in catalog:
                for o in it.offerings:
                    if not o.available:
                        continue
                    if (it.name, o.zone, o.capacity_type) in unavailable:
                        continue  # ICE'd: the solver excludes it too
                    if ctr is not None and not ctr.value_set().contains(
                            o.capacity_type):
                        continue
                    eligible.add(o.capacity_type)
        if not eligible:
            continue
        counts = info["counts"]
        lo = min(counts.get(c, 0) for c in eligible)
        hi = max(counts.get(c, 0) for c in eligible)
        if hi - lo > skew:
            errs.append(
                f"capacity-type spread violated: {counts} skew {hi - lo} "
                f"> {skew}")
    return errs


def unaccounted_pods(pods, res) -> List[str]:
    """Names of the pods of the batch that ``res`` neither assigns nor
    lists as infeasible: pods a solver lost."""
    return [p.name for p in pods
            if p.name not in res.assignments and p.name not in res.infeasible]
