"""The plain reference: a first-fit-decreasing planner and a plan checker
over the benchmark's own records.

It imports numpy and the benchmark's catalog records only: nothing of the
program, and nothing the program made.  Both take a pending set as the
benchmark generates it (``workload.pending_set``) and the catalog's
records (``catalog.generate``).

``ffd`` is Karpenter's scheduling loop written plainly: deployments in
decreasing order of (cpu, memory); each pod goes to the first in-flight
node of its zone that some still-possible instance type can hold, else a
new node opens with every allowed type possible; a node's type set
narrows to the types that hold what it carries, and it launches as the
cheapest of them.  A hard zone spread deals each deployment's pods over
the zones so that no zone holds more than ``max_skew`` more than another.

``check`` judges a plan against the guarantees the configuration states:
every pod of the set seated exactly once and no pod that is not in it,
each node an allowed instance type bought as an offering that exists at
its catalog price, no node holding more than its allocatable cpu, memory
or pod slots, every hard zone spread within its skew.  It returns the
count of each kind of fault.
"""

from __future__ import annotations

import numpy as np

RESOURCES = ("cpu", "memory", "pods")
#: relative slack of a capacity comparison: float64 sums of exact
#: requests against an allocatable computed in float64
CAPACITY_RTOL = 1e-9
#: relative slack of a node's stated price against the catalog's
PRICE_RTOL = 1e-6

FAULT_KINDS = ("unseated", "duplicate", "foreign", "assignment",
               "unknown_type", "disallowed_type", "bad_offering",
               "price", "overcommit", "skew")


class Candidates:
    """The instance types a provisioner admits, as arrays: allocatable
    ``alloc[T, R]`` and the price of the allowed capacity type per zone
    ``price[T, Z]`` (inf where there is no such offering)."""

    def __init__(self, records, provisioner: dict, zones) -> None:
        from .catalog import allowed

        self.zones = list(zones)
        cts = set(provisioner["capacity_types"])
        self.records = [r for r in records if allowed(r, provisioner)]
        self.names = [r["name"] for r in self.records]
        self.alloc = np.array([[r["allocatable"].get(k, 0.0)
                                for k in RESOURCES] for r in self.records])
        self.price = np.full((len(self.records), len(self.zones)), np.inf)
        self.offer = {}
        for t, r in enumerate(self.records):
            for zone, ct, p in r["offerings"]:
                if ct in cts and zone in self.zones:
                    z = self.zones.index(zone)
                    self.price[t, z] = min(self.price[t, z], p)
                    self.offer[(r["name"], zone, ct)] = p
        self.index = {n: t for t, n in enumerate(self.names)}
        self.all_names = {r["name"] for r in records}


def ffd(pending: dict, cand: Candidates, spread: bool = True):
    """Plan ``pending`` (``deployments``: name, cpu, memory bytes,
    replicas, max_skew) first fit decreasing.  ``spread=False`` drops the
    zone spread.  Returns ``(cost $/hr, nodes)`` with each node
    ``(type, zone, [(deployment index, pods)])``."""
    deps = pending["deployments"]
    Z = len(cand.zones)
    order = sorted(range(len(deps)),
                   key=lambda d: (-deps[d]["cpu"], -deps[d]["memory"]))
    zone_of, used, masks, loads = [], [], [], []
    for d in order:
        dep = deps[d]
        req = np.array([dep["cpu"], dep["memory"], 1.0])
        fits_empty = np.floor(cand.alloc / req * (1 + CAPACITY_RTOL)).min(1)
        n = dep["replicas"]
        if spread:
            quota = [n // Z + (1 if z < n % Z else 0) for z in range(Z)]
        else:
            quota = [n] + [0] * (Z - 1)
        for z in range(Z):
            k = quota[z]
            idx = [i for i, zz in enumerate(zone_of) if zz == z]
            if idx and k:
                u = np.array([used[i] for i in idx])
                m = np.array([masks[i] for i in idx])
                room = (cand.alloc[None, :, :] * (1 + CAPACITY_RTOL)
                        - u[:, None, :])
                cnt = np.floor(room / req).min(2)
                cnt = np.where(m & (cnt > 0), cnt, 0).max(1)
                before = np.concatenate([[0], np.cumsum(cnt)[:-1]])
                take = np.clip(k - before, 0, cnt).astype(int)
                for j, i in enumerate(idx):
                    if take[j]:
                        _add(i, d, int(take[j]), req, cand, used, masks,
                             loads)
                k -= int(take.sum())
            best = int(fits_empty.max())
            if k and best < 1:
                raise ValueError(f"no allowed type holds one pod of "
                                 f"{dep['name']}")
            while k:
                take = min(k, best)
                zone_of.append(z)
                used.append(np.zeros(len(RESOURCES)))
                masks.append(np.isfinite(cand.price[:, z]))
                loads.append([])
                _add(len(zone_of) - 1, d, take, req, cand, used, masks,
                     loads)
                k -= take
    nodes, cost = [], 0.0
    for i, z in enumerate(zone_of):
        p = np.where(masks[i], cand.price[:, z], np.inf)
        t = int(np.argmin(p))
        cost += float(p[t])
        nodes.append((cand.names[t], cand.zones[z], loads[i]))
    return cost, nodes


def _add(i, d, k, req, cand, used, masks, loads) -> None:
    used[i] = used[i] + k * req
    masks[i] = masks[i] & np.all(
        cand.alloc * (1 + CAPACITY_RTOL) >= used[i], axis=1)
    loads[i].append((d, k))


def check(pending: dict, plan: dict, cand: Candidates) -> dict:
    """Count the faults of ``plan`` for ``pending``.  ``plan`` holds
    ``nodes``: ``(type, zone, capacity type, stated price, pod indices)``
    with each pod by its index in the set (-1 for a pod not in it),
    ``infeasible``: indices the program left unplaced, and ``assigned``:
    ``{pod index: node position}`` as the program reported it."""
    deps = pending["deployments"]
    dep_of = np.repeat(np.arange(len(deps)),
                       [d["replicas"] for d in deps])
    n_pods = len(dep_of)
    req = np.array([[d["cpu"], d["memory"], 1.0] for d in deps])
    seen = np.zeros(n_pods, dtype=np.int64)
    per_zone = np.zeros((len(deps), len(cand.zones)), dtype=np.int64)
    faults = dict.fromkeys(FAULT_KINDS, 0)
    node_of = {}
    for pos, (itype, zone, ct, price, pods) in enumerate(plan["nodes"]):
        pods = np.asarray(pods, dtype=np.int64)
        faults["foreign"] += int((pods < 0).sum())
        pods = pods[pods >= 0]
        np.add.at(seen, pods, 1)
        for p in pods.tolist():
            node_of[p] = pos
        if zone in cand.zones:
            np.add.at(per_zone, (dep_of[pods], cand.zones.index(zone)), 1)
        if itype not in cand.all_names:
            faults["unknown_type"] += 1
            continue
        if itype not in cand.index:
            faults["disallowed_type"] += 1
            continue
        offered = cand.offer.get((itype, zone, ct))
        if offered is None:
            faults["bad_offering"] += 1
            continue
        if abs(price - offered) > PRICE_RTOL * offered:
            faults["price"] += 1
        load = req[dep_of[pods]].sum(0) if len(pods) else np.zeros(3)
        alloc = cand.alloc[cand.index[itype]]
        if np.any(load > alloc * (1 + CAPACITY_RTOL)):
            faults["overcommit"] += 1
    faults["unseated"] = int((seen == 0).sum())
    faults["duplicate"] = int((seen > 1).sum())
    for p, pos in plan["assigned"].items():
        if node_of.get(p) != pos:
            faults["assignment"] += 1
    faults["assignment"] += sum(1 for p in node_of
                                if p not in plan["assigned"])
    for d, dep in enumerate(deps):
        if dep.get("max_skew") is not None:
            skew = int(per_zone[d].max() - per_zone[d].min())
            faults["skew"] += max(0, skew - dep["max_skew"])
    return faults


def plan_cost(plan: dict, cand: Candidates) -> float:
    """The plan's $/hr at the catalog's prices (a node bought as an
    offering that does not exist counts at its stated price)."""
    total = 0.0
    for itype, zone, ct, price, _pods in plan["nodes"]:
        total += cand.offer.get((itype, zone, ct), price)
    return total
