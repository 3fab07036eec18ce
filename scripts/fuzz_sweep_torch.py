#!/usr/bin/env python
"""Per-seed fuzz sweep of the PyTorch/CUDA port: the distribution behind the
ceilings, the warm-start chains, the relax rung, the hierarchical
decomposition, the gang contract and the controller battletest.

The port of ``scripts/fuzz_sweep.py`` over ``karpenter_tpu_torch``, with the
reference's command line word for word plus ``--device``::

    python scripts/fuzz_sweep_torch.py [plain,existing,kubelet] [n_seeds] [--cached]
    python scripts/fuzz_sweep_torch.py --delta [n_seeds] [chain_len]
    python scripts/fuzz_sweep_torch.py --delta-wire [n_seeds] [chain_len]
    python scripts/fuzz_sweep_torch.py --relax [n_seeds]
    python scripts/fuzz_sweep_torch.py --hier [n_seeds]
    python scripts/fuzz_sweep_torch.py --gang [n_seeds]
    ... --device cpu      # the host; the default is the CUDA card,
                          # raising without one

The suites solve seeded random scenarios (``random_scenario``: requests,
selectors, zone / hostname / capacity-type spreads, anti-affinity, taints,
weighted and limited provisioners, ICE'd offerings, volume zone pins; with
``existing`` pre-filled nodes, with ``kubelet`` density and reservation
overrides) through ``BatchScheduler(backend="tpu")`` and print the per-pod
cost ratio against the port's oracle (``solver/reference.py``) per seed,
flagging a plan the validator refuses or one that seats fewer pods than
the floor.  ``--cached`` solves every scenario twice through one scheduler
(the tensorize cache's identity tier) and flags a moved answer.

``--delta`` perturbs a solved scenario ``chain_len`` times (add / remove /
ICE / reclaim / mixed) through ``BatchScheduler.solve_delta`` and holds
every step to the validator, to 1.06x the per-pod cost of a from-scratch
re-solve and to its floor.  ``--delta-wire`` drives the same churn through
a real gRPC ``DeltaSession`` against an in-process ``SolverService``: the
client's merged view must equal the server's live chain at every step.
``--relax`` refines scan results with the relax rung: never costlier,
the same pods seated, valid.  ``--hier`` holds the hierarchical
decomposition to flat's placement on block-disjoint batches, never splits
a coupling component under block pressure, and leaves no pod unseated
that flat seats.  ``--gang`` promotes deployments to gangs (some doomed,
some short-rostered): every gang places whole or retracts whole with a
typed reason, and the gang-free pods keep the plain ceiling.

Every ``run_*`` takes ``device=`` and returns one record per seed (the
problems found, per-step modes, costs and ``n_scheduled``, the results
and, for the chains, each step's inputs and the node-name counter it
started from), so that a caller can replay the same seed elsewhere:
``replay=`` takes another run's records and re-drives their inputs from
their counter states.  ``run_battle`` is the controller churn of the
reference's battletest over a package namespace (:func:`port_package`).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import random
import statistics
import sys
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PARITY = 1.02
#: per-seed ceiling of the plain suite's per-pod cost ratio
FUZZ_PARITY = 1.02
#: per-seed ceiling of the existing-node suite
FUZZ_PARITY_EXISTING = 1.02
#: per-seed ceiling of the kubelet-override suite
FUZZ_PARITY_KUBELET = 1.02
#: mean per suite: observed means sit far below the per-seed ceilings, so
#: a systematic drift fails here before every seed trips its ceiling
FUZZ_MEAN = 0.90
#: per-step ceiling of the delta chains against a from-scratch re-solve:
#: a 1-pod removal can strand half a node of a 20-pod scenario
DELTA_FUZZ_COST_CEILING = 1.06

#: seeds whose problems the reference's own sweep shows the same way, by
#: mode -> {seed: ROADMAP Queue C entry}.  They run and print as any seed;
#: the exit code treats them as a strict expected failure: their problems
#: do not fail the run, and such a seed showing none does.
KNOWN_FAULTS = {"delta": {8: "C10"}, "delta-wire": {8: "C10"}}

CEILINGS = {"plain": FUZZ_PARITY, "existing": FUZZ_PARITY_EXISTING,
            "kubelet": FUZZ_PARITY_KUBELET}
ZONES = ["zone-1a", "zone-1b", "zone-1c"]


def _device(device):
    """The runners' torch device: ``None`` is the card (raising without
    one), anything else as given."""
    from karpenter_tpu_torch.device import resolve_device

    return resolve_device(device)


def small_catalog():
    from karpenter_tpu_torch.models.catalog import generate_catalog

    return generate_catalog(full=False)


def names_from(start: int) -> None:
    """Restart the node-name counter at ``start``.  Names order the
    coalescing candidates and key the renames, so two solves compare node
    for node only from one counter state; a start at or below an existing
    node's index mints colliding names (ROADMAP C9)."""
    from karpenter_tpu_torch.solver import types

    with types._node_lock:
        types._node_next = start


def names_at() -> int:
    from karpenter_tpu_torch.solver import types

    with types._node_lock:
        return types._node_next


def plan(result) -> list:
    """Node-name-independent node plan."""
    return sorted(
        (n.instance_type, n.zone, n.capacity_type, round(n.price, 6),
         tuple(sorted(p.name for p in n.pods)))
        for n in result.nodes)


def placements_tie(a, b) -> bool:
    """Two plans that seat the same pods, leave the same pods infeasible and
    cost the same at float32."""
    return (set(a.assignments) == set(b.assignments)
            and set(a.infeasible) == set(b.infeasible)
            and np.float32(sum(n.price for n in a.nodes)).tobytes()
            == np.float32(sum(n.price for n in b.nodes)).tobytes())


def same_plan(a, b) -> bool:
    return plan(a) == plan(b) or placements_tie(a, b)


# ---------------------------------------------------------------------------
# the generators (the reference suite's, over the port's models)
# ---------------------------------------------------------------------------


def random_scenario(seed: int, catalog):
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.instancetype import GIB
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodAffinityTerm,
        PodSpec,
        Taint,
        Toleration,
        TopologySpreadConstraint,
    )
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.models.requirements import IN, Requirement

    rng = np.random.default_rng(seed)
    zones = ZONES

    # -- provisioners: 1-3, weighted; maybe a taint, maybe a cpu limit -----
    provs = []
    n_prov = int(rng.integers(1, 4))
    for i in range(n_prov):
        kw = {}
        if rng.random() < 0.3:
            kw["taints"] = [Taint(key="team", effect=L.EFFECT_NO_SCHEDULE,
                                  value="a")]
        if rng.random() < 0.3:
            kw["limits"] = {"cpu": float(rng.integers(16, 128))}
        if rng.random() < 0.4:
            ct = (L.CAPACITY_TYPE_SPOT if rng.random() < 0.5
                  else L.CAPACITY_TYPE_ON_DEMAND)
            kw["requirements"] = [Requirement(L.CAPACITY_TYPE, IN, [ct])]
        provs.append(Provisioner(name=f"prov{i}",
                                 weight=int(rng.integers(1, 11)),
                                 **kw).with_defaults())

    # -- pods: up to 8 deployment-like groups, constraint mix -------------
    pods = []
    n_dep = int(rng.integers(1, 9))
    for d in range(n_dep):
        n = int(rng.integers(3, 40))
        cpu = float(rng.choice([0.25, 0.5, 1.0, 2.0, 3.5]))
        mem = float(rng.choice([0.5, 1.0, 2.0, 6.0])) * GIB
        labels = {"app": f"d{d}"}
        sel = LabelSelector.of(labels)
        kw = {}
        r = rng.random()
        if r < 0.25:
            kw["topology_spread"] = [TopologySpreadConstraint(
                int(rng.integers(1, 4)), L.ZONE, "DoNotSchedule", sel)]
        elif r < 0.45:
            kw["affinity_terms"] = [PodAffinityTerm(sel, L.HOSTNAME,
                                                    anti=True)]
        elif r < 0.55:
            kw["topology_spread"] = [TopologySpreadConstraint(
                int(rng.integers(1, 3)), L.HOSTNAME, "DoNotSchedule", sel)]
        elif r < 0.63:
            kw["affinity_terms"] = [PodAffinityTerm(sel, L.ZONE)]
        elif r < 0.70 and d > 0:
            kw["affinity_terms"] = [PodAffinityTerm(
                LabelSelector.of({"app": f"d{int(rng.integers(0, d))}"}),
                L.ZONE if rng.random() < 0.5 else L.HOSTNAME)]
        if rng.random() < 0.25:
            kw["node_selector"] = {L.ZONE: str(rng.choice(zones))}
        if rng.random() < 0.2:
            kw["tolerations"] = [Toleration(key="team", operator="Equal",
                                            value="a",
                                            effect=L.EFFECT_NO_SCHEDULE)]
        for i in range(n):
            pods.append(PodSpec(name=f"d{d}-{i}", labels=dict(labels),
                                requests={"cpu": cpu, "memory": mem},
                                owner_key=f"d{d}", **kw))

    # -- ICE'd offerings ----------------------------------------------------
    unavailable = set()
    if rng.random() < 0.4:
        for _ in range(int(rng.integers(1, 6))):
            it = catalog[int(rng.integers(0, len(catalog)))]
            o = it.offerings[int(rng.integers(0, len(it.offerings)))]
            unavailable.add((it.name, o.zone, o.capacity_type))

    # -- volume topology pins: a bound PV (1 zone) or a
    # WaitForFirstConsumer class (2 zones), on its own rng stream
    vrng = np.random.default_rng(seed + 55_000)
    for d in range(n_dep):
        if vrng.random() < 0.15:
            nz = 1 if vrng.random() < 0.6 else 2
            vz = sorted(vrng.choice(zones, size=nz, replace=False).tolist())
            req = Requirement(L.ZONE, IN, vz)
            for pod in pods:
                if pod.owner_key == f"d{d}":
                    pod.volume_zone_requirements = [req]

    # -- capacity-type spread across spot / on-demand, on its own stream
    crng = np.random.default_rng(seed + 99_000)
    for d in range(n_dep):
        if crng.random() < 0.12:
            sel = LabelSelector.of({"app": f"d{d}"})
            for pod in pods:
                if pod.owner_key == f"d{d}":
                    pod.topology_spread = list(pod.topology_spread) + [
                        TopologySpreadConstraint(
                            1, L.CAPACITY_TYPE, "DoNotSchedule", sel)
                    ]

    return pods, provs, unavailable


def with_random_kubelet(seed: int, provs):
    """Layer kubeletConfiguration overrides onto ``provs``: density caps
    (maxPods / podsPerCore) and reservation overrides, on their own rng
    stream."""
    from karpenter_tpu_torch.models.provisioner import KubeletConfiguration

    krng = np.random.default_rng(seed + 77_000)
    out = list(provs)
    for i, p in enumerate(out):
        if krng.random() < 0.35:
            kc = {}
            r = krng.random()
            if r < 0.4:
                kc["max_pods"] = int(krng.integers(8, 40))
            elif r < 0.7:
                kc["pods_per_core"] = int(krng.integers(1, 6))
            else:
                kc["kube_reserved"] = {
                    "cpu": float(krng.choice([0.5, 1.0, 2.0]))}
            out[i] = dataclasses.replace(p,
                                         kubelet=KubeletConfiguration(**kc))
    return out


def random_existing_nodes(seed: int, catalog, provs):
    """Existing cluster state: partially filled nodes of random types, some
    pre-placed filler pods consuming capacity.  The nodes take their names
    from the node-name counter."""
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.solver.types import SimNode

    rng = np.random.default_rng(seed + 10_000)
    nodes = []
    for i in range(int(rng.integers(1, 8))):
        it = catalog[int(rng.integers(0, len(catalog)))]
        zone = str(rng.choice(ZONES))
        prov = provs[int(rng.integers(0, len(provs)))]
        node = SimNode(
            instance_type=it.name,
            provisioner=prov.name,
            zone=zone,
            capacity_type=L.CAPACITY_TYPE_ON_DEMAND,
            price=it.offerings[0].price,
            allocatable=dict(it.allocatable),
            labels={**it.labels(), L.ZONE: zone,
                    L.CAPACITY_TYPE: L.CAPACITY_TYPE_ON_DEMAND,
                    L.PROVISIONER_NAME: prov.name},
            existing=True,
        )
        node.labels[L.HOSTNAME] = node.name
        # fill 0-70% of cpu with filler pods (never past cpu OR pod-density
        # capacity)
        cpu_cap = node.allocatable.get("cpu", 0.0)
        pods_cap = node.allocatable.get(L.RESOURCE_PODS, 110.0)
        target = cpu_cap * float(rng.random() * 0.7)
        used, j, size = 0.0, 0, 0.25
        while used < target and used + size <= cpu_cap and j + 1 <= pods_cap:
            node.pods.append(PodSpec(name=f"filler-{i}-{j}",
                                     requests={"cpu": size},
                                     owner_key=f"filler-{i}"))
            used += size
            j += 1
        nodes.append(node)
    return nodes


def suite_scenario(suite: str, seed: int, catalog):
    """``(pods, provisioners, unavailable, existing nodes)`` of one seed of
    a suite, or ``None`` where the kubelet suite drew no override."""
    pods, provs, unavailable = random_scenario(seed, catalog)
    existing = []
    if suite == "kubelet":
        provs = with_random_kubelet(seed, provs)
        if all(p.kubelet is None for p in provs):
            return None
    if suite == "existing":
        existing = random_existing_nodes(seed, catalog, provs)
    return pods, provs, unavailable, existing


def _isolate_labels(pods, tag: str):
    """Rewrite the pods' app-label namespace (labels and their own spread /
    affinity selectors, consistently) so that pods drawn from two scenarios
    cannot share a label."""
    from karpenter_tpu_torch.models.pod import LabelSelector

    def remap_sel(sel):
        return LabelSelector(
            match_labels=tuple((k, f"{tag}-{v}") for k, v in sel.match_labels),
            match_expressions=sel.match_expressions,
        )

    out = []
    for i, p in enumerate(pods):
        out.append(dataclasses.replace(
            p,
            name=f"{tag}-{i}",
            labels={k: f"{tag}-{v}" for k, v in p.labels.items()},
            topology_spread=[
                dataclasses.replace(t, label_selector=remap_sel(t.label_selector))
                for t in p.topology_spread
            ],
            affinity_terms=[
                dataclasses.replace(t, label_selector=remap_sel(t.label_selector))
                for t in p.affinity_terms
            ],
        ))
    return out


def _relax_mix(seed: int):
    """Seed-varied unconstrained complementary-resource block appended to
    each relax scenario, so that the rung has eligible mass."""
    from karpenter_tpu_torch.models.instancetype import GIB
    from karpenter_tpu_torch.models.pod import PodSpec

    pods = []
    for d in range(6):
        kind = (d + seed) % 3
        if kind == 0:
            cpu, mem = 1.0 + (d % 3) * 0.5, 0.25 * GIB
        elif kind == 1:
            cpu, mem = 0.1 + 0.05 * d, (4.0 + 2 * (d % 2)) * GIB
        else:
            cpu, mem = 0.5 * (1 + d % 2), 2.0 * GIB
        for i in range(12 + (seed * 7 + d * 3) % 30):
            pods.append(PodSpec(
                name=f"rxf{seed}-{d}-{i}", labels={"app": f"rxfz{seed}{d}"},
                requests={"cpu": cpu, "memory": mem},
                owner_key=f"rxf{seed}-{d}",
            ))
    return pods


def _hier_fuzz_scenario(seed: int, disjoint: bool):
    """Seed-varied zone-spread deployment blocks, each its own coupling
    component; ``disjoint`` also pins every deployment to its own zone."""
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.catalog import DEFAULT_ZONES
    from karpenter_tpu_torch.models.instancetype import GIB
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )

    rng = random.Random(77_000 + seed)
    nd = len(DEFAULT_ZONES) if disjoint else rng.randint(2, 5)
    pods = []
    for d in range(nd):
        sel = LabelSelector.of({"app": f"fz{seed}-{d}"})
        node_sel = ({L.ZONE: DEFAULT_ZONES[d % len(DEFAULT_ZONES)]}
                    if disjoint else {})
        cpu = 0.25 * rng.randint(1, 8)
        mem = GIB * (0.5 + rng.randint(0, 5))
        for i in range(rng.randint(20, 120)):
            pods.append(PodSpec(
                name=f"fz{seed}-{d}-{i}", labels={"app": f"fz{seed}-{d}"},
                requests={"cpu": cpu, "memory": mem},
                node_selector=dict(node_sel),
                topology_spread=[TopologySpreadConstraint(
                    1, L.ZONE, "DoNotSchedule", sel)],
                owner_key=f"fz{seed}-{d}"))
    return pods


def _gangify(seed: int, pods):
    """Randomly promote whole deployments to gangs: about half the groups,
    one gang in four doomed by a member pinned to a zone no offering
    serves, one in five submitted with an incomplete roster.  Returns
    ``(pods, gangs: {gid: [names]}, doomed: {gid})``."""
    from karpenter_tpu_torch.models import labels as L

    rng = random.Random(88_000 + seed)
    groups = {}
    for p in pods:
        groups.setdefault(p.owner_key or p.name, []).append(p)
    out, gangs, doomed = [], {}, set()
    for gi, (owner, members) in enumerate(sorted(groups.items())):
        if len(members) < 2 or rng.random() < 0.5:
            out.extend(members)
            continue
        gid = f"fzg{seed}-{gi}"
        size = len(members)
        kind = rng.random()
        if kind < 0.20:
            size = len(members) + rng.randint(1, 3)
            doomed.add(gid)
        marked = [dataclasses.replace(p, gang_id=gid, gang_size=size)
                  for p in members]
        if 0.20 <= kind < 0.40:
            j = rng.randrange(len(marked))
            marked[j] = dataclasses.replace(
                marked[j],
                node_selector={**marked[j].node_selector,
                               L.ZONE: "zone-none"})
            doomed.add(gid)
        gangs[gid] = [p.name for p in marked]
        out.extend(marked)
    return out, gangs, doomed


# ---------------------------------------------------------------------------
# the suites
# ---------------------------------------------------------------------------


def per_pod_ratio(got, oracle):
    """``got``'s cost per scheduled pod over the oracle's, or ``None`` where
    either bought nothing or seated nothing."""
    if oracle.new_node_cost > 0 and got.n_scheduled and oracle.n_scheduled:
        return (got.new_node_cost / got.n_scheduled) / (
            oracle.new_node_cost / oracle.n_scheduled)
    return None


def run_suite(suite: str, n_seeds: int, device=None, cached: bool = False,
              seeds=None, catalog=None, reset_names: bool = False,
              verbose: bool = True) -> dict:
    """One suite's sweep.  Returns ``{"suite", "n", "mean", "worst",
    "invalid", "cache", "records"}``; a record per seed holds the per-pod
    ratio against the port's oracle, its ceiling, the problems (the
    validator, the floor, a moved cached answer), the result, the counter
    state the solve started from and its host wall.  ``reset_names`` names each seed's
    existing nodes from 0 and starts its solves at 1000, so that two runs
    of a seed compare node for node."""
    from karpenter_tpu_torch.solver import reference
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.solver.validate import validate_solution

    dev = _device(device)
    catalog = catalog if catalog is not None else small_catalog()
    sched = BatchScheduler(backend="tpu", device=dev) if cached else None
    records = []
    for seed in (range(n_seeds) if seeds is None else seeds):
        if reset_names:
            names_from(0)
        scen = suite_scenario(suite, seed, catalog)
        if scen is None:
            records.append(dict(seed=seed, skipped="no kubelet override"))
            continue
        pods, provs, unavailable, existing = scen
        kw = {"existing_nodes": existing} if suite == "existing" else {}
        oracle = reference.solve(pods, provs, catalog,
                                 unavailable=unavailable, **kw)
        solver = sched or BatchScheduler(backend="tpu", device=dev)
        if reset_names:
            names_from(1000)
        start = names_at()
        t0 = time.perf_counter()
        got = solver.solve(pods, provs, catalog, unavailable=unavailable,
                           **kw)
        wall_ms = (time.perf_counter() - t0) * 1e3
        problems = []
        if cached:
            # second pass: same pod objects through the same scheduler —
            # identity-tier tensorize cache; the answer must not move
            if reset_names:
                names_from(1000)
            again = solver.solve(pods, provs, catalog,
                                 unavailable=unavailable, **kw)
            if (again.n_scheduled != got.n_scheduled
                    or abs(again.new_node_cost - got.new_node_cost) > 1e-6):
                problems.append(
                    f"cached re-solve diverged: {again.n_scheduled} pods "
                    f"${again.new_node_cost:.3f} vs {got.n_scheduled} "
                    f"${got.new_node_cost:.3f}")
        errs = validate_solution(pods, provs, got, catalog)
        if errs:
            problems = errs[:2] + problems
        ratio = per_pod_ratio(got, oracle)
        floor = oracle.n_scheduled - max(
            2, oracle.n_scheduled // (4 if suite == "existing" else 10))
        if got.n_scheduled < floor:
            problems.append(f"scheduled {got.n_scheduled} < floor {floor}")
        records.append(dict(
            seed=seed, ratio=ratio, ceiling=CEILINGS[suite],
            problems=problems, n_scheduled=got.n_scheduled,
            cost=got.new_node_cost, result=got, names_at=start,
            wall_ms=wall_ms))
    ratios = {r["seed"]: round(r["ratio"], 4) for r in records
              if r.get("ratio") is not None}
    vals = list(ratios.values())
    mean = sum(vals) / max(len(vals), 1)
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:5]
    invalid = {r["seed"]: r["problems"] for r in records if r.get("problems")}
    cache = None
    extra = ""
    if cached and sched is not None and sched._tensorize_cache is not None:
        c = sched._tensorize_cache
        cache = (c.hits, c.misses)
        extra = f" cache_hits={c.hits} misses={c.misses}"
    if verbose:
        print(f"{suite}: n={len(vals)} mean={mean:.4f} worst={worst}{extra}")
        if invalid:
            print(f"  INVALID: {invalid}")
    return dict(suite=suite, n=len(vals), mean=mean, worst=worst,
                invalid=invalid, cache=cache, records=records,
                device=str(dev))


# ---------------------------------------------------------------------------
# warm-start chains
# ---------------------------------------------------------------------------


def _draw_added(rng, seed, step, extra_seed, n_cur, catalog, prefix):
    fresh = random_scenario(extra_seed, catalog)[0]
    take = rng.randint(1, max(2, n_cur // 25))
    return _isolate_labels(fresh[:take], f"{prefix}{seed}c{step}")


def _cost_check(tag, cur, full, problems):
    """One chain step's per-pod cost against its from-scratch re-solve
    ``full``, held to the delta ceiling."""
    r = per_pod_ratio(cur, full)
    if r is not None and r > DELTA_FUZZ_COST_CEILING + 1e-9:
        problems.append(f"{tag}: cost ratio {r:.4f}")


def run_delta_chains(n_seeds: int, chain_len: int, device=None, seeds=None,
                     replay=None, catalog=None, verbose: bool = True) -> list:
    """Warm-start parity chains through ``BatchScheduler.solve_delta``; one
    record per seed: ``problems``, ``modes``, ``base`` and ``steps`` (each
    step's inputs — kind, added pods, removed names, iced offerings or
    reclaimed node, the unavailable set — the counter it started from, the
    delta result — a copy: a chain's next step may update it in place — and
    the from-scratch re-solve).  ``replay`` re-drives
    another run's records: their seeds, inputs and counter states."""
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.solver.validate import validate_solution

    dev = _device(device)
    catalog = catalog if catalog is not None else small_catalog()
    plan_seeds = ([r["seed"] for r in replay] if replay is not None
                  else list(range(n_seeds) if seeds is None else seeds))
    records = []
    for idx, seed in enumerate(plan_seeds):
        old = replay[idx] if replay is not None else None
        rng = random.Random(10_000 + seed)
        pods, provs, unavailable = random_scenario(seed, catalog)
        sched = BatchScheduler(backend="tpu", device=dev)
        if old is not None:
            names_from(old["base"]["names_at"])
        base_at = names_at()
        cur = sched.solve(pods, provs, catalog, unavailable=unavailable)
        base = dict(names_at=base_at, result=copy.deepcopy(cur), cost=cur.new_node_cost,
                    n_scheduled=cur.n_scheduled)
        # never-schedulable pods leave the tracked problem: the chain has
        # no PodSpec objects for them (callers re-offer what they want
        # retried)
        if cur.infeasible:
            doomed0 = set(cur.infeasible)
            pods = [p for p in pods if p.name not in doomed0]
        cur_pods = list(pods)
        unavail = set(unavailable or ())
        problems, modes, steps = [], [], []
        extra_seed = 500 + seed
        for step in range(chain_len):
            if old is not None:
                inp = old["steps"][step]
                kind, added = inp["kind"], list(inp["added"])
                removed, iced = list(inp["removed"]), list(inp["iced"])
            else:
                kind = rng.choice(("add", "remove", "ice", "reclaim",
                                   "mixed"))
                added, removed, iced = [], [], []
                if kind in ("add", "mixed"):
                    added = _draw_added(rng, seed, step, extra_seed,
                                        len(cur_pods), catalog, "d")
                    extra_seed += 1
                if kind in ("remove", "mixed") and cur.assignments:
                    k = rng.randint(1, max(1, len(cur_pods) // 25))
                    removed = rng.sample(sorted(cur.assignments),
                                         min(k, len(cur.assignments)))
                if kind == "ice":
                    it = rng.choice(list(catalog))
                    off = rng.choice(it.offerings)
                    iced = [(it.name, off.zone, off.capacity_type)]
                if kind == "reclaim":
                    names = [n.name for n in cur.nodes] or [
                        n.name for n in cur.existing_nodes]
                    if names:
                        iced = [rng.choice(names)]
            if kind == "ice":
                unavail.add(iced[0])
            if old is not None:
                names_from(inp["names_at"])
            start = names_at()
            out = sched.solve_delta(
                cur, added=added, removed=removed, iced=iced,
                provisioners=provs, instance_types=catalog,
                unavailable=unavail,
            )
            cur = out.result
            modes.append(out.mode)
            doomed = set(removed)
            cur_pods = [p for p in cur_pods if p.name not in doomed] + list(
                added)
            # (a) placement validity of the incremental state
            errs = validate_solution(cur_pods, provs, cur, catalog)
            if errs:
                problems.append(f"step {step} ({out.mode}): {errs[:2]}")
            # (b) cost parity vs a from-scratch re-solve
            if old is not None:
                names_from(inp["full_names_at"])
            full_at = names_at()
            full = BatchScheduler(backend="tpu", device=dev).solve(
                cur_pods, provs, catalog, unavailable=unavail or None)
            _cost_check(f"step {step} ({out.mode})", cur, full, problems)
            if cur.n_scheduled < full.n_scheduled - max(
                    2, full.n_scheduled // 10):
                problems.append(
                    f"step {step} ({out.mode}): scheduled "
                    f"{cur.n_scheduled} < full {full.n_scheduled}")
            steps.append(dict(
                kind=kind, added=added, removed=removed, iced=iced,
                unavailable=set(unavail), names_at=start,
                full_names_at=full_at, mode=out.mode,
                result=copy.deepcopy(cur),
                cost=cur.new_node_cost, n_scheduled=cur.n_scheduled,
                full=full))
        if verbose:
            tag = "OK " if not problems else "FAIL"
            print(f"delta seed {seed}: {tag} modes={modes}"
                  + (f" {problems}" if problems else ""))
        records.append(dict(seed=seed, problems=problems, modes=modes,
                            base=base, steps=steps, provisioners=provs,
                            device=str(dev)))
    return records


def run_delta_wire_chains(n_seeds: int, chain_len: int, device=None,
                          seeds=None, replay=None, catalog=None,
                          verbose: bool = True) -> list:
    """Random churn chains through a real gRPC ``DeltaSession`` against an
    in-process ``SolverService`` over ``BatchScheduler(backend="tpu")`` on
    ``device``.  Per step: the client's view equals the server's live
    chain, the validator passes, the cost ceiling holds.  One record per
    seed, as :func:`run_delta_chains`'s (``modes`` are the server's
    epochs)."""
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.service.client import DeltaSession
    from karpenter_tpu_torch.service.server import SolverService, make_server
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.solver.validate import validate_solution
    from scripts.chaos_drive_torch import _close_service

    dev = _device(device)
    catalog = catalog if catalog is not None else small_catalog()
    plan_seeds = ([r["seed"] for r in replay] if replay is not None
                  else list(range(n_seeds) if seeds is None else seeds))
    reg = Registry()
    service = SolverService(
        BatchScheduler(backend="tpu", registry=reg, device=dev),
        registry=reg)
    srv, port = make_server(service, port=0)
    records = []
    try:
        for idx, seed in enumerate(plan_seeds):
            old = replay[idx] if replay is not None else None
            rng = random.Random(30_000 + seed)
            pods, provs, unavailable = random_scenario(seed, catalog)
            sess = DeltaSession(f"127.0.0.1:{port}", timeout=120.0)
            if old is not None:
                names_from(old["base"]["names_at"])
            base_at = names_at()
            cur = sess.solve(pods, provs, catalog, unavailable=unavailable)
            base = dict(names_at=base_at, result=copy.deepcopy(cur),
                        cost=cur.new_node_cost, n_scheduled=cur.n_scheduled)
            if cur.infeasible:
                doomed0 = set(cur.infeasible)
                pods = [p for p in pods if p.name not in doomed0]
            cur_pods = {p.name: p for p in pods}
            problems, modes, steps = [], [], []
            extra_seed = 900 + seed
            for step in range(chain_len):
                if old is not None:
                    inp = old["steps"][step]
                    kind, added = inp["kind"], list(inp["added"])
                    removed, iced = list(inp["removed"]), list(inp["iced"])
                else:
                    kind = rng.choice(("add", "remove", "reclaim", "mixed"))
                    added, removed, iced = [], [], []
                    if kind in ("add", "mixed"):
                        added = _draw_added(rng, seed, step, extra_seed,
                                            len(cur_pods), catalog, "w")
                        extra_seed += 1
                    if kind in ("remove", "mixed") and cur.assignments:
                        k = rng.randint(1, max(1, len(cur_pods) // 25))
                        removed = rng.sample(sorted(cur.assignments),
                                             min(k, len(cur.assignments)))
                    if kind == "reclaim":
                        names = [n.name for n in cur.nodes]
                        if names:
                            iced = [rng.choice(names)]
                if old is not None:
                    names_from(inp["names_at"])
                start = names_at()
                cur = sess.solve_delta(added=added, removed=removed,
                                       iced=iced)
                for n in set(removed):
                    cur_pods.pop(n, None)
                for p in added:
                    cur_pods[p.name] = p
                # (a) wire losslessness: client view == server chain
                pipe = list(service._pipelines.values())[0]
                entry = pipe._delta_tab.get(sess.session_id)
                if entry is None:
                    problems.append(f"step {step}: session lost")
                    break
                modes.append(entry.epoch)
                if entry.prev.assignments != cur.assignments or \
                        entry.prev.infeasible != cur.infeasible or \
                        {n.name: sorted(p.name for p in n.pods)
                         for n in entry.prev.nodes} != \
                        {n.name: sorted(p.name for p in n.pods)
                         for n in cur.nodes}:
                    problems.append(f"step {step}: client diverged from "
                                    "server chain")
                # (b) ground-truth validity of the merged view
                errs = validate_solution(list(cur_pods.values()), provs,
                                         cur, catalog)
                if errs:
                    problems.append(f"step {step}: {errs[:2]}")
                # (c) cost ceiling vs from-scratch
                if old is not None:
                    names_from(inp["full_names_at"])
                full_at = names_at()
                unavail = set(sess._unavailable)
                full = BatchScheduler(backend="tpu", device=dev).solve(
                    list(cur_pods.values()), provs, catalog,
                    unavailable=unavail or None)
                _cost_check(f"step {step}", cur, full, problems)
                steps.append(dict(
                    kind=kind, added=added, removed=removed, iced=iced,
                    unavailable=unavail, names_at=start,
                    full_names_at=full_at, mode=entry.epoch,
                    result=copy.deepcopy(cur),
                    cost=cur.new_node_cost, n_scheduled=cur.n_scheduled,
                    full=full))
            if verbose:
                tag = "OK " if not problems else "FAIL"
                print(f"delta-wire seed {seed}: {tag} epochs={modes}"
                      + (f" {problems}" if problems else ""))
            records.append(dict(seed=seed, problems=problems, modes=modes,
                                base=base, steps=steps, provisioners=provs,
                                device=str(dev)))
            sess.close()
    finally:
        srv.stop(grace=None)
        _close_service(service)
    return records


# ---------------------------------------------------------------------------
# the relax rung, the hierarchical decomposition, gangs
# ---------------------------------------------------------------------------


def relax_scenario(seed: int, catalog):
    """``(pods, provisioners, unavailable)`` of one relax seed (preferences
    hardened as the scheduler does, the mix block appended), or ``None``
    where the batch is one the device scan does not serve."""
    from karpenter_tpu_torch.models.tensorize import (
        batch_needs_oracle,
        device_inexpressible,
    )
    from karpenter_tpu_torch.solver.scheduler import _harden_preferences

    base, provs, unavailable = random_scenario(seed, catalog)
    pods = [_harden_preferences(p) for p in base] + _relax_mix(seed)
    if batch_needs_oracle(pods) or any(device_inexpressible(p)
                                       for p in pods):
        return None
    return pods, provs, unavailable


def run_relax_seeds(n_seeds: int, device=None, seeds=None, catalog=None,
                    verbose: bool = True) -> list:
    """Random scenarios plus an unconstrained mix block straight through
    the relax rung on ``device``: never costlier than the scan, valid, the
    same pods seated.  One record per seed (``skipped`` for oracle-routed
    batches): outcome, scan and shipped results and costs, problems."""
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.solver import relax
    from karpenter_tpu_torch.solver.tpu import TpuSolver
    from karpenter_tpu_torch.solver.validate import validate_solution

    dev = _device(device)
    catalog = catalog if catalog is not None else small_catalog()
    solver = TpuSolver(device=dev)
    outcomes, records = {}, []
    all_seeds = list(range(n_seeds) if seeds is None else seeds)
    for seed in all_seeds:
        scen = relax_scenario(seed, catalog)
        if scen is None:
            if verbose:
                print(f"relax seed {seed}: SKIP (oracle-routed batch)")
            records.append(dict(seed=seed, skipped="oracle-routed batch",
                                problems=[]))
            continue
        pods, provs, unavailable = scen
        st = tensorize(pods, provs, catalog, unavailable=unavailable)
        start = names_at()
        scan = solver.solve(st, track_assignments=True).result
        scan_cost = scan.new_node_cost
        scan_scheduled = set(scan.assignments)
        scan_copy = copy.deepcopy(scan)  # an improving rung reuses it
        shipped, outcome = relax.refine(scan, st, registry=Registry(),
                                        device=dev)
        outcomes[outcome] = outcomes.get(outcome, 0) + 1
        problems = []
        if shipped.new_node_cost > scan_cost + 1e-9:
            problems.append(
                f"shipped ${shipped.new_node_cost:.4f} > scan "
                f"${scan_cost:.4f} — never-worse violated")
        if set(shipped.assignments) != scan_scheduled:
            problems.append("schedulable-pod set changed")
        errs = validate_solution(pods, provs, shipped, catalog,
                                 unavailable=unavailable or ())
        if errs:
            problems.append(f"validator: {errs[:2]}")
        if verbose:
            tag = "OK " if not problems else "FAIL"
            print(f"relax seed {seed}: {tag} {outcome}"
                  + (f" {problems}" if problems else ""))
        records.append(dict(seed=seed, outcome=outcome, problems=problems,
                            scan=scan_copy, shipped=shipped,
                            scan_cost=scan_cost,
                            cost=shipped.new_node_cost,
                            n_scheduled=shipped.n_scheduled, names_at=start,
                            device=str(dev)))
    if verbose:
        print(f"relax outcomes over {len(all_seeds)} seeds: {outcomes}")
    return records


def run_hier_seeds(n_seeds: int, device=None, seeds=None, catalog=None,
                   verbose: bool = True) -> list:
    """Hierarchical-decomposition fuzz on ``device``.  Per seed: (a) on a
    block-disjoint batch the hierarchical plan is flat's (or a float32
    cost tie); (b) the partition never splits a coupling component under
    block pressure; (c) on an overlapping batch no pod flat seats is left
    unseated.  One record per seed with the four results and the counter
    state each solve started from."""
    from bench_torch import _placement_canon
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.solver import hierarchy as H
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    dev = _device(device)
    catalog = catalog if catalog is not None else small_catalog()
    provs = [Provisioner(name="default").with_defaults()]
    sched = BatchScheduler(backend="tpu", device=dev)
    records = []
    for seed in (range(n_seeds) if seeds is None else seeds):
        problems, at = [], {}
        # (a) block-disjoint: hier ships flat's exact placement (relax off
        # on the flat side: block waves skip that rung by design)
        dpods = _hier_fuzz_scenario(seed, disjoint=True)
        at["dflat"] = names_at()
        dflat = sched.solve(dpods, provs, catalog, relax=False)
        at["dhier"] = names_at()
        dhier = H.solve_hierarchical(sched, dpods, provs, catalog)
        if dhier is None:
            problems.append("disjoint: hierarchical path fell back")
        elif _placement_canon(dflat) != _placement_canon(dhier):
            if not placements_tie(dflat, dhier):
                diff = sum(1 for pn, v in _placement_canon(dflat).items()
                           if _placement_canon(dhier).get(pn) != v)
                problems.append(f"disjoint: {diff} pod placement(s) "
                                "diverged from flat beyond an f32 cost tie")
        # (b) never split a reachability component under block pressure
        cpods, cprovs, unav = random_scenario(seed, catalog)
        st = tensorize(cpods, cprovs, catalog, unavailable=unav)
        comps = H.coupling_components(st)
        partitions = {}
        for max_blocks in (2, 3):
            masks = H.partition_blocks(st, comps, max_blocks)
            partitions[max_blocks] = [np.flatnonzero(m).tolist()
                                      for m in masks]
            for ci, comp in enumerate(comps):
                owners = {bi for bi, m in enumerate(masks)
                          if bool(np.any(m[comp]))}
                whole = any(bool(np.all(m[comp])) for m in masks)
                if len(owners) != 1 or not whole:
                    problems.append(
                        f"component {ci} split across blocks {owners} "
                        f"at max_blocks={max_blocks}")
        # (c) repair completeness on an overlapping scenario
        opods = _hier_fuzz_scenario(seed, disjoint=False)
        at["oflat"] = names_at()
        oflat = sched.solve(opods, provs, catalog, relax=False)
        at["ohier"] = names_at()
        ohier = H.solve_hierarchical(sched, opods, provs, catalog)
        if ohier is None:
            problems.append("overlap: hierarchical path fell back")
        else:
            lost = sorted(set(oflat.assignments) - set(ohier.assignments))
            if lost:
                problems.append(
                    f"overlap: {len(lost)} pod(s) flat seats are unseated "
                    f"hierarchically (e.g. {lost[:3]})")
        if verbose:
            tag = "OK " if not problems else "FAIL"
            print(f"hier seed {seed}: {tag}"
                  + (f" {problems}" if problems else ""))
        records.append(dict(
            seed=seed, problems=problems, names_at=at,
            results=dict(dflat=dflat, dhier=dhier, oflat=oflat, ohier=ohier),
            components=[list(map(int, c)) for c in comps],
            partitions=partitions, device=str(dev)))
    return records


def run_gang_seeds(n_seeds: int, device=None, seeds=None, catalog=None,
                   verbose: bool = True) -> list:
    """All-or-nothing gang fuzz on ``device``.  Per seed: no partial gang,
    typed retraction reasons, ground-truth validity, and the gang-free
    subset within the plain ceiling of the port's oracle.  One record per
    seed: the gangs, the gang result, the singleton subset's oracle and
    device results."""
    from karpenter_tpu_torch.solver import reference
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.solver.validate import validate_solution

    dev = _device(device)
    catalog = catalog if catalog is not None else small_catalog()
    placed_total = retracted_total = 0
    records = []
    all_seeds = list(range(n_seeds) if seeds is None else seeds)
    for seed in all_seeds:
        problems = []
        base, provs, unavailable = random_scenario(seed, catalog)
        pods, gangs, doomed = _gangify(seed, base)
        at = {"gang": names_at()}
        res = BatchScheduler(backend="tpu", device=dev).solve(
            pods, provs, catalog, unavailable=unavailable)
        # (a) the contract: every gang fully places or fully retracts
        for gid, names in gangs.items():
            placed = [n for n in names if n in res.assignments]
            if placed and len(placed) != len(names):
                problems.append(
                    f"gang {gid} PARTIAL: {len(placed)}/{len(names)} placed")
                continue
            if not placed:
                retracted_total += 1
                untyped = [n for n in names if n not in res.infeasible]
                if untyped:
                    problems.append(
                        f"gang {gid} retracted but {untyped[:3]} carry no "
                        "infeasible reason")
                elif not any(
                        str(res.infeasible[n]).startswith("GangUnplaced")
                        for n in names):
                    problems.append(
                        f"gang {gid} retracted without a typed "
                        f"GangUnplaced reason: {res.infeasible[names[0]]}")
            else:
                placed_total += 1
                if gid in doomed:
                    problems.append(
                        f"gang {gid} placed despite an engineered dooming")
        # (b) ground-truth validity of whatever shipped
        errs = validate_solution(pods, provs, res, catalog)
        if errs:
            problems.append(f"validator: {errs[:2]}")
        # (c) the gang path must not tax ungrouped pods
        singles = [p for p in pods if not p.gang_id]
        oracle = got = None
        if singles:
            oracle = reference.solve(singles, provs, catalog,
                                     unavailable=unavailable)
            at["singles"] = names_at()
            got = BatchScheduler(backend="tpu", device=dev).solve(
                singles, provs, catalog, unavailable=unavailable)
            r = per_pod_ratio(got, oracle)
            if r is not None and r > FUZZ_PARITY + 1e-9:
                problems.append(f"singleton cost ratio {r:.4f}")
        if verbose:
            tag = "OK " if not problems else "FAIL"
            print(f"gang seed {seed}: {tag} gangs={len(gangs)} "
                  f"doomed={len(doomed)}"
                  + (f" {problems}" if problems else ""))
        records.append(dict(
            seed=seed, problems=problems, gangs=gangs, doomed=doomed,
            result=res,
            cost=res.new_node_cost, n_scheduled=res.n_scheduled,
            singles=got, singles_oracle=oracle, names_at=at,
            device=str(dev)))
    if verbose:
        print(f"gang sweep: {placed_total} placed, {retracted_total} "
              f"retracted over {len(all_seeds)} seeds")
    return records


# ---------------------------------------------------------------------------
# the battletest's controller churn
# ---------------------------------------------------------------------------

BATTLE_CPU_LIMIT = 64.0


def port_package() -> SimpleNamespace:
    """The port's modules the churn drives, under the aliases the churn
    reads (a caller may pass another package's modules by the same
    aliases)."""
    from karpenter_tpu_torch import events, metrics
    from karpenter_tpu_torch.cloud import fake, templates
    from karpenter_tpu_torch.controllers import (
        deprovisioning,
        provisioning,
        termination,
    )
    from karpenter_tpu_torch.controllers import state as state_mod
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models import machine, pod, provisioner
    from karpenter_tpu_torch.solver import scheduler, types
    from karpenter_tpu_torch.utils import clock

    return SimpleNamespace(
        root="karpenter_tpu_torch", events=events, metrics=metrics,
        fake=fake, templates=templates, deprovisioning=deprovisioning,
        provisioning=provisioning, termination=termination,
        state_mod=state_mod, L=L, machine=machine, pod=pod,
        provisioner=provisioner, scheduler=scheduler, types=types,
        clock=clock)


def check_invariants(state, cloud, cpu_limit: float = BATTLE_CPU_LIMIT):
    """The battletest's invariants over one cluster; the broken ones, one
    message each."""
    errs = []
    # every binding points at a live pod and a live node, and the node's
    # pod list agrees
    for pod_name, node_name in state.bindings.items():
        if pod_name not in state.pods:
            errs.append(f"binding for deleted pod {pod_name}")
        if node_name not in state.nodes:
            errs.append(f"binding to deleted node {node_name}")
            continue
        ns = state.nodes[node_name]
        if not any(p.name == pod_name for p in ns.node.pods):
            errs.append(f"{pod_name} bound to {node_name} but absent from "
                        "its pod list")
    # node pod lists never reference unbound or deleted pods
    for name, ns in state.nodes.items():
        for p in ns.node.pods:
            if not p.is_daemon and state.bindings.get(p.name) != name:
                errs.append(f"{p.name} on {name} without a matching binding")
    # provisioner limits hold
    total_cpu = sum(ns.node.allocatable.get("cpu", 0.0)
                    for ns in state.nodes.values())
    if total_cpu > cpu_limit + 1e-6:
        errs.append(f"cpu limit breached: {total_cpu}")
    # every node's machine is live in the cloud unless mid-termination
    for name, ns in state.nodes.items():
        if ns.machine is None or ns.marked_for_deletion:
            continue
        inst = cloud.instances.get(ns.machine.provider_id)
        if inst is None or inst.terminated:
            errs.append(f"{name} backed by terminated/unknown instance")
    return errs


def run_battle(seed: int, catalog=None, steps: int = 120, drain: int = 80,
               k=None, backend: str = "oracle", device=None,
               make_scheduler=None, trace: bool = False) -> dict:
    """One seed of the randomized controller churn: pod adds and deletes,
    ICE injections and clears, image publications and clock jumps, each
    followed by provisioning, deprovisioning and termination reconciles
    under random delays, the invariants checked after every step; then
    every pod deleted and the cluster drained.  ``k`` is the package
    (default :func:`port_package`); the scheduler is
    ``BatchScheduler(backend=backend, device=device)`` unless
    ``make_scheduler(registry)`` builds it.  Returns the problems, whether
    every node was reaped and, with ``trace``, one snapshot per step
    (nodes by name, type, zone and capacity type; bindings; the events
    published in the step)."""
    k = k if k is not None else port_package()
    catalog = catalog if catalog is not None else small_catalog()
    rng = random.Random(seed)
    clock = k.clock.FakeClock()
    state = k.state_mod.ClusterState(clock=clock)
    cloud = k.fake.FakeCloudProvider(catalog, clock=clock)
    published = []
    recorder = k.events.Recorder(
        sink=lambda e: published.append((e.kind, e.reason)))
    registry = k.metrics.Registry()
    if make_scheduler is not None:
        sched = make_scheduler(registry)
    else:
        sched = k.scheduler.BatchScheduler(backend=backend,
                                           registry=registry, device=device)
    prov_ctrl = k.provisioning.ProvisioningController(
        state, cloud, scheduler=sched, recorder=recorder, registry=registry,
        clock=clock)
    term = k.termination.TerminationController(
        state, cloud, recorder=recorder, registry=registry, clock=clock)
    deprov = k.deprovisioning.DeprovisioningController(
        state, cloud, term, provisioning=prov_ctrl, scheduler=sched,
        recorder=recorder, registry=registry, clock=clock,
        drift_enabled=True)
    state.apply_provisioner(k.provisioner.Provisioner(
        name="default", consolidation_enabled=True,
        limits={"cpu": BATTLE_CPU_LIMIT}))

    pod_seq = 0
    live_pods = []

    def add_pods():
        nonlocal pod_seq
        for _ in range(rng.randint(1, 8)):
            p = k.pod.PodSpec(
                name=f"p{pod_seq}",
                requests={"cpu": rng.choice([0.25, 0.5, 1.0, 2.0])},
                owner_key=f"d{rng.randint(0, 3)}",
            )
            pod_seq += 1
            live_pods.append(p.name)
            state.add_pod(p)

    def del_pods():
        for _ in range(rng.randint(1, 6)):
            if not live_pods:
                return
            state.delete_pod(live_pods.pop(rng.randrange(len(live_pods))))

    def inject_ice():
        it = rng.choice(cloud.instance_types)
        for o in it.offerings[: rng.randint(1, 3)]:
            cloud.inject_ice(it.name, o.zone, o.capacity_type)

    def clear_ice():
        cloud.clear_ice()

    def publish_image():
        cloud.publish_image(k.templates.Image(
            f"img-standard-amd64-s{seed}-{rng.randint(0, 99999)}",
            k.L.ARCH_AMD64, created_at=clock.now() + 1000.0,
            family="standard",
        ))

    def time_jump():
        clock.advance(rng.choice([30.0, 120.0, 400.0]))

    def snapshot(label):
        snap = dict(
            step=label,
            nodes=sorted((ns.node.name, ns.node.instance_type, ns.node.zone,
                          ns.node.capacity_type)
                         for ns in state.nodes.values()),
            bindings=dict(sorted(state.bindings.items())),
            events=list(published))
        published.clear()
        return snap

    events = [add_pods, add_pods, del_pods, inject_ice, clear_ice,
              publish_image, time_jump]
    problems, snaps = [], []
    max_nodes = 0
    t0 = time.perf_counter()
    for step in range(steps):
        rng.choice(events)()
        prov_ctrl.reconcile()
        clock.advance(rng.uniform(0.1, 3.0))  # random delays (battletest)
        prov_ctrl.reconcile()
        deprov.reconcile()
        term.reconcile()
        problems += [f"step {step}: {e}"
                     for e in check_invariants(state, cloud)]
        max_nodes = max(max_nodes, len(state.nodes))
        if trace:
            snaps.append(snapshot(step))

    # drain to quiescence: no pods -> the cluster empties out
    for name in list(state.pods):
        state.delete_pod(name)
    ticks = 0
    for ticks in range(1, drain + 1):
        clock.advance(30.0)
        prov_ctrl.reconcile()
        deprov.reconcile()
        term.reconcile()
        problems += [f"drain {ticks}: {e}"
                     for e in check_invariants(state, cloud)]
        if trace:
            snaps.append(snapshot(f"drain {ticks}"))
        if not state.nodes:
            break
    if state.nodes:
        problems.append(f"seed {seed}: {len(state.nodes)} nodes never reaped")
    stop = getattr(sched, "stop_warms", None)
    if stop is not None:
        stop()
    return dict(seed=seed, steps=steps, problems=problems,
                reaped=not state.nodes, nodes_left=len(state.nodes),
                max_nodes=max_nodes, pods_added=pod_seq, drain_ticks=ticks,
                wall_s=time.perf_counter() - t0,
                device=str(getattr(sched, "device", "")), snapshots=snaps)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def summary(records) -> dict:
    """Seeds run, skipped and failing, over one mode's records."""
    ran = [r for r in records if not r.get("skipped")]
    return dict(seeds=len(ran), skipped=len(records) - len(ran),
                failing=[r["seed"] for r in ran if r["problems"]])


def walls(records) -> dict:
    ms = [r["wall_ms"] for r in records if "wall_ms" in r]
    if not ms:
        return {}
    return dict(p50_ms=statistics.median(ms), max_ms=max(ms))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        usage="%(prog)s [suites] [n_seeds] [--cached] | --delta|--delta-wire"
              " [n_seeds] [chain_len] | --relax|--hier|--gang [n_seeds]"
              " [--device DEVICE]")
    ap.add_argument("args", nargs="*")
    ap.add_argument("--cached", action="store_true")
    for flag in ("--delta", "--delta-wire", "--relax", "--hier", "--gang"):
        ap.add_argument(flag, action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device the solves run on (default the CUDA "
                         "card, raising without one; 'cpu' runs on the "
                         "host)")
    a = ap.parse_args(argv)
    argv = a.args
    dev = _device(a.device)

    def failing(mode, records):
        known = KNOWN_FAULTS.get(mode, {})
        bad = set(summary(records)["failing"])
        ran = {r["seed"] for r in records if not r.get("skipped")}
        for seed in sorted(bad & set(known)):
            print(f"{mode} seed {seed}: known fault, ROADMAP {known[seed]}",
                  file=sys.stderr)
        passing_known = sorted((ran & set(known)) - bad)
        if passing_known:
            print(f"{mode}: known-fault seeds {passing_known} showed no "
                  "problem", file=sys.stderr)
        return 1 if (bad - set(known)) or passing_known else 0

    if a.relax:
        n_seeds = int(argv[0]) if len(argv) > 0 else 25
        return failing("relax", run_relax_seeds(n_seeds, device=dev))
    if a.hier:
        n_seeds = int(argv[0]) if len(argv) > 0 else 12
        return failing("hier", run_hier_seeds(n_seeds, device=dev))
    if a.gang:
        n_seeds = int(argv[0]) if len(argv) > 0 else 20
        return failing("gang", run_gang_seeds(n_seeds, device=dev))
    if a.delta_wire:
        n_seeds = int(argv[0]) if len(argv) > 0 else 10
        chain_len = int(argv[1]) if len(argv) > 1 else 4
        return failing("delta-wire", run_delta_wire_chains(
            n_seeds, chain_len, device=dev))
    if a.delta:
        n_seeds = int(argv[0]) if len(argv) > 0 else 12
        chain_len = int(argv[1]) if len(argv) > 1 else 4
        return failing("delta", run_delta_chains(n_seeds, chain_len,
                                                 device=dev))
    suites = (argv[0].split(",") if len(argv) > 0
              else ["plain", "existing", "kubelet"])
    n_seeds = int(argv[1]) if len(argv) > 1 else 40
    rc = 0
    for suite in suites:
        out = run_suite(suite, n_seeds, device=dev, cached=a.cached)
        rc |= 1 if out["invalid"] else 0
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
