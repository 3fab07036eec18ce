"""The port's flat device solve against the reference package, on the CPU.

Every scenario is ONE plain description (lists of dicts, some drawn from a
numpy seed) built twice: once with the reference package's models, once
with the port's.  Results are compared through name-independent
fingerprints (node plans, assigned / infeasible pod sets), never by object
equality — the two packages have their own model classes and node-name
counters.

Two comparisons per scenario:

- ``BatchScheduler(backend="tpu").solve(..., relax=False)`` of each
  package (first wave, ladders, residue waves, reseat epilogue);
- the raw flat solve on the SAME tensorized state: the reference's
  ``SolveTensors`` arrays are carried into the port with
  ``tensors_from_reference`` (and the port's own tensorize must produce
  the same arrays).

Tolerance: equal node plans, or ``placements_tie`` (same pods seated, same
infeasible set, f32 total cost bitwise equal) — the tolerance the
reference's own tests accept between two compiled graphs.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import karpenter_tpu.models.catalog as ref_catalog
import karpenter_tpu.models.labels as ref_labels
import karpenter_tpu.models.pod as ref_pod
import karpenter_tpu.models.provisioner as ref_prov
import karpenter_tpu.models.requirements as ref_req
import karpenter_tpu.models.tensorize as ref_tensorize
import karpenter_tpu.solver.scheduler as ref_scheduler
import karpenter_tpu.solver.tpu as ref_tpu
import karpenter_tpu.solver.types as ref_types
import karpenter_tpu_torch.models.catalog as t_catalog
import karpenter_tpu_torch.models.labels as t_labels
import karpenter_tpu_torch.models.pod as t_pod
import karpenter_tpu_torch.models.provisioner as t_prov
import karpenter_tpu_torch.models.requirements as t_req
import karpenter_tpu_torch.models.tensorize as t_tensorize
import karpenter_tpu_torch.solver.scheduler as t_scheduler
import karpenter_tpu_torch.solver.tpu as t_tpu
import karpenter_tpu_torch.solver.types as t_types

torch.set_num_threads(1)

GIB = 1024.0 ** 3

REF = types.SimpleNamespace(
    pod=ref_pod, prov=ref_prov, req=ref_req, L=ref_labels,
    catalog=ref_catalog, types=ref_types, tensorize=ref_tensorize)
PORT = types.SimpleNamespace(
    pod=t_pod, prov=t_prov, req=t_req, L=t_labels,
    catalog=t_catalog, types=t_types, tensorize=t_tensorize)


# ---------------------------------------------------------------------------
# one description, two builds
# ---------------------------------------------------------------------------


def build_pods(ns, descs):
    out = []
    for d in descs:
        kw = dict(name=d["name"], requests=dict(d["requests"]),
                  labels=dict(d.get("labels", {})),
                  owner_key=d.get("owner_key", ""),
                  node_selector=dict(d.get("node_selector", {})))
        if "spread" in d:
            kw["topology_spread"] = [
                ns.pod.TopologySpreadConstraint(
                    skew, key, when, ns.pod.LabelSelector.of(sel))
                for skew, key, when, sel in d["spread"]]
        terms = [ns.pod.PodAffinityTerm(ns.pod.LabelSelector.of(sel), key,
                                        anti=True)
                 for sel, key in d.get("anti", [])]
        terms += [ns.pod.PodAffinityTerm(ns.pod.LabelSelector.of(sel), key)
                  for sel, key in d.get("affinity", [])]
        if terms:
            kw["affinity_terms"] = terms
        if "tolerations" in d:
            kw["tolerations"] = [ns.pod.Toleration(**t)
                                 for t in d["tolerations"]]
        out.append(ns.pod.PodSpec(**kw))
    return out


def build_provs(ns, descs):
    out = []
    for d in descs:
        kw = dict(name=d["name"])
        for k in ("weight", "limits", "labels"):
            if k in d:
                kw[k] = d[k]
        if "taints" in d:
            kw["taints"] = [ns.pod.Taint(*t) for t in d["taints"]]
        if "requirements" in d:
            kw["requirements"] = [ns.req.Requirement(k, ns.req.IN, list(v))
                                  for k, v in d["requirements"]]
        out.append(ns.prov.Provisioner(**kw).with_defaults())
    return out


def build_existing(ns, descs, catalog):
    out = []
    for d in descs:
        it = next(t for t in catalog if t.name == d["type"])
        price = next(o.price for o in it.offerings
                     if o.zone == d["zone"] and o.capacity_type == "on-demand")
        out.append(ns.types.SimNode(
            instance_type=it.name, provisioner="default", zone=d["zone"],
            capacity_type="on-demand", price=price,
            allocatable=dict(it.allocatable),
            labels={**it.labels(), ns.L.ZONE: d["zone"],
                    ns.L.CAPACITY_TYPE: "on-demand",
                    ns.L.PROVISIONER_NAME: "default"},
            existing=True, name=d["name"]))
    return out


def build(ns, sc, catalogs):
    catalog = catalogs[sc.get("catalog", "small")]
    unavailable = None
    if sc.get("ice_type"):
        unavailable = {(sc["ice_type"], z, "on-demand")
                       for z in ("zone-1a", "zone-1b", "zone-1c")}
    return dict(
        pods=build_pods(ns, sc["pods"]),
        provisioners=build_provs(ns, sc.get("provs", [{"name": "default"}])),
        instance_types=catalog,
        existing_nodes=build_existing(ns, sc.get("existing", []), catalog),
        daemonsets=build_pods(ns, sc.get("daemonsets", [])),
        unavailable=unavailable,
        max_new_nodes=sc.get("max_new_nodes"),
    )


def plan(result):
    """Node-plan fingerprint, independent of the node-name counter."""
    return sorted(
        (n.instance_type, n.zone, n.capacity_type, round(n.price, 6),
         tuple(sorted(p.name for p in n.pods)))
        for n in result.nodes)


def placements_tie(a, b):
    return (set(a.assignments) == set(b.assignments)
            and set(a.infeasible) == set(b.infeasible)
            and np.float32(sum(n.price for n in a.nodes)).tobytes()
            == np.float32(sum(n.price for n in b.nodes)).tobytes())


def assert_same(ref_res, port_res):
    assert set(ref_res.infeasible) == set(port_res.infeasible)
    assert set(ref_res.assignments) == set(port_res.assignments)
    assert plan(ref_res) == plan(port_res) or placements_tie(ref_res, port_res)


# ---------------------------------------------------------------------------
# scenarios (the reference's parity fixtures, as plain descriptions)
# ---------------------------------------------------------------------------


def _pods(prefix, n, requests, **extra):
    return [dict(name=f"{prefix}{i}", requests=requests, **extra)
            for i in range(n)]


def _spread(app, n, cpu, skew=1):
    sel = {"app": app}
    return _pods(app, n, {"cpu": cpu}, labels=sel, owner_key=app,
                 spread=[(skew, "topology.kubernetes.io/zone",
                          "DoNotSchedule", sel)])


def _random_scenario(seed):
    """Three deployments with seeded sizes/requests; one zone-spread, one
    hostname-anti, one plain — the constraint mix the step branches on."""
    rng = np.random.default_rng(seed)
    pods = []
    for d, kind in enumerate(("spread", "anti", "plain")):
        n = int(rng.integers(3, 25))
        cpu = float(rng.choice([0.25, 0.5, 1.0, 2.0, 3.0]))
        mem = float(rng.choice([0.5, 1.0, 4.0])) * GIB
        app = f"r{seed}d{d}"
        sel = {"app": app}
        extra = dict(labels=sel, owner_key=app)
        if kind == "spread":
            extra["spread"] = [(int(rng.integers(1, 3)),
                                "topology.kubernetes.io/zone",
                                "DoNotSchedule", sel)]
        elif kind == "anti":
            n = min(n, 6)
            extra["anti"] = [(sel, "kubernetes.io/hostname")]
        pods += _pods(app, n, {"cpu": cpu, "memory": mem}, **extra)
    return dict(pods=pods)


SCENARIOS = {
    "single_group": dict(pods=_pods("p", 50, {"cpu": 1.0})),
    "two_resource_groups": dict(
        pods=_pods("a", 30, {"cpu": 1.0}, owner_key="a")
        + _pods("b", 30, {"cpu": 0.5, "memory": 6 * GIB}, owner_key="b")),
    "backfill_small_into_big": dict(
        pods=_pods("big", 2, {"cpu": 14.0}) + _pods("s", 20, {"cpu": 0.25})),
    "infeasible_pod_counted": dict(
        pods=[dict(name="giant", requests={"cpu": 1000.0}),
              dict(name="ok", requests={"cpu": 1.0})]),
    "full_catalog": dict(
        catalog="full", pods=_pods("p", 100, {"cpu": 2.0, "memory": 4 * GIB})),
    "zone_selector": dict(pods=_pods(
        "p", 10, {"cpu": 1.0},
        node_selector={"topology.kubernetes.io/zone": "zone-1b"})),
    "zone_spread": dict(pods=_spread("web", 30, 1.0)),
    "hostname_anti_affinity": dict(pods=_pods(
        "db", 5, {"cpu": 0.5}, labels={"app": "db"},
        anti=[({"app": "db"}, "kubernetes.io/hostname")])),
    "taints_and_tolerations": dict(
        provs=[dict(name="team-a", taints=[("team", "NoSchedule", "a")]),
               dict(name="open")],
        pods=_pods("t", 5, {"cpu": 1.0}, tolerations=[
            dict(key="team", operator="Equal", value="a")])
        + _pods("u", 5, {"cpu": 1.0})),
    "spot_and_weights": dict(
        provs=[dict(name="spot", weight=10, requirements=[
                   ("karpenter.sh/capacity-type", ["spot"])]),
               dict(name="od", weight=1)],
        pods=_pods("p", 20, {"cpu": 1.0})),
    "unavailable_offerings": dict(ice_type="m5.large",
                                  pods=_pods("p", 10, {"cpu": 1.0})),
    "daemonset_overhead": dict(
        daemonsets=[dict(name="agent",
                         requests={"cpu": 0.5, "memory": 0.5 * GIB})],
        pods=_pods("p", 10, {"cpu": 1.5})),
    "provisioner_limits": dict(
        provs=[dict(name="capped", limits={"cpu": 8.0})],
        pods=_pods("p", 10, {"cpu": 3.0})),
    "limit_fallback_to_next_provisioner": dict(
        provs=[dict(name="capped", weight=10, limits={"cpu": 8.0}),
               dict(name="fallback", weight=5)],
        pods=_pods("p", 10, {"cpu": 3.0})),
    "existing_filled_first": dict(
        existing=[dict(name="ex-0", type="m5.4xlarge", zone="zone-1a")],
        pods=_pods("p", 5, {"cpu": 1.0})),
    "existing_overflow_to_new_nodes": dict(
        existing=[dict(name="ex-0", type="m5.4xlarge", zone="zone-1a")],
        pods=_pods("p", 12, {"cpu": 2.0})),
    "node_budget_truncates": dict(
        max_new_nodes=2, pods=_pods("p", 10, {"cpu": 3.0})),
    "node_budget_below_existing": dict(
        max_new_nodes=0,
        existing=[dict(name=f"ex-{i}", type="m5.4xlarge", zone="zone-1a")
                  for i in range(3)],
        pods=_pods("p", 5, {"cpu": 1.0})),
    "zone_self_affinity_seeds_one_zone": dict(pods=_pods(
        "w", 20, {"cpu": 1.0}, labels={"app": "web"}, owner_key="web",
        affinity=[({"app": "web"}, "topology.kubernetes.io/zone")])),
    "zone_affinity_follows_other_service": dict(
        pods=_pods("a", 4, {"cpu": 4.0}, labels={"app": "a"}, owner_key="a",
                   node_selector={"topology.kubernetes.io/zone": "zone-1b"})
        + _pods("b", 8, {"cpu": 0.5}, labels={"app": "b"}, owner_key="b",
                affinity=[({"app": "a"}, "topology.kubernetes.io/zone")])),
    "hostname_self_affinity_one_node": dict(pods=_pods(
        "p", 6, {"cpu": 0.5}, labels={"app": "pack"}, owner_key="pack",
        affinity=[({"app": "pack"}, "kubernetes.io/hostname")])),
    "hostname_self_affinity_overflow_infeasible": dict(pods=_pods(
        "p", 10, {"cpu": 6.0}, labels={"app": "big"}, owner_key="big",
        affinity=[({"app": "big"}, "kubernetes.io/hostname")])),
    "hostname_affinity_to_other_service": dict(
        pods=_pods("a", 3, {"cpu": 4.0}, labels={"app": "a"}, owner_key="a")
        + _pods("b", 6, {"cpu": 0.25}, labels={"app": "b"}, owner_key="b",
                affinity=[({"app": "a"}, "kubernetes.io/hostname")])),
    "unmatchable_affinity_infeasible": dict(pods=[dict(
        name="p", labels={"app": "solo"}, requests={"cpu": 0.5},
        affinity=[({"app": "ghost"}, "topology.kubernetes.io/zone")])]),
    "random_seed_1": _random_scenario(1),
    "random_seed_2": _random_scenario(2),
}


@pytest.fixture(scope="module")
def catalogs():
    return {
        "ref": {"small": ref_catalog.generate_catalog(full=False),
                "full": ref_catalog.generate_catalog(full=True)},
        "port": {"small": t_catalog.generate_catalog(full=False),
                 "full": t_catalog.generate_catalog(full=True)},
    }


@pytest.fixture(scope="module")
def schedulers():
    return (ref_scheduler.BatchScheduler(backend="tpu", compile_behind=False),
            t_scheduler.BatchScheduler(backend="tpu", device="cpu"))


def _solve(sched, kw):
    return sched.solve(
        kw["pods"], kw["provisioners"], kw["instance_types"],
        existing_nodes=kw["existing_nodes"], daemonsets=kw["daemonsets"],
        unavailable=kw["unavailable"], max_new_nodes=kw["max_new_nodes"],
        relax=False)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_solve_matches_reference(name, catalogs, schedulers):
    sc = SCENARIOS[name]
    ref_kw = build(REF, sc, catalogs["ref"])
    port_kw = build(PORT, sc, catalogs["port"])
    ref_res = _solve(schedulers[0], ref_kw)
    port_res = _solve(schedulers[1], port_kw)
    assert_same(ref_res, port_res)
    if sc.get("max_new_nodes") is not None:
        assert len(port_res.nodes) <= sc["max_new_nodes"]


def _array_fields(st):
    return {f.name: getattr(st, f.name) for f in dataclasses.fields(st)
            if isinstance(getattr(st, f.name), np.ndarray)}


@pytest.mark.parametrize("name", [
    "two_resource_groups", "zone_spread", "hostname_anti_affinity",
    "zone_self_affinity_seeds_one_zone", "hostname_affinity_to_other_service",
    "provisioner_limits", "existing_overflow_to_new_nodes",
    "node_budget_truncates", "random_seed_1",
])
def test_flat_solve_on_carried_tensors(name, catalogs):
    sc = SCENARIOS[name]
    ref_kw = build(REF, sc, catalogs["ref"])
    port_kw = build(PORT, sc, catalogs["port"])
    tz = dict(daemonsets=ref_kw["daemonsets"],
              unavailable=ref_kw["unavailable"])
    st_ref = ref_tensorize.tensorize(
        ref_kw["pods"], ref_kw["provisioners"], ref_kw["instance_types"], **tz)
    st_own = t_tensorize.tensorize(
        port_kw["pods"], port_kw["provisioners"], port_kw["instance_types"],
        daemonsets=port_kw["daemonsets"], unavailable=port_kw["unavailable"])
    # the port's own tensorize builds the reference's arrays byte for byte
    fields = _array_fields(st_ref)
    for k, v in fields.items():
        mine = getattr(st_own, k)
        assert mine.dtype == v.dtype and mine.tobytes() == v.tobytes(), k
    st = t_tpu.tensors_from_reference(fields, like=st_own)
    NE = len(ref_kw["existing_nodes"])
    budget = (None if sc.get("max_new_nodes") is None
              else NE + sc["max_new_nodes"])
    ref_out = ref_tpu.solve_tensors(
        st_ref, existing_nodes=ref_kw["existing_nodes"], max_nodes=budget)
    port_out = t_tpu.TpuSolver(device="cpu").solve(
        st, existing_nodes=port_kw["existing_nodes"], max_nodes=budget)
    assert port_out.n_used == ref_out.n_used
    assert_same(ref_out.result, port_out.result)
    np.testing.assert_array_equal(port_out.takes, np.asarray(ref_out.takes))


def test_carried_tensors_refuse_a_shape_mismatch(catalogs):
    sc = SCENARIOS["single_group"]
    port_kw = build(PORT, sc, catalogs["port"])
    st_own = t_tensorize.tensorize(port_kw["pods"], port_kw["provisioners"],
                                   port_kw["instance_types"])
    with pytest.raises(ValueError):
        t_tpu.tensors_from_reference(
            {"counts": np.zeros(st_own.G + 1, dtype=np.int32)}, like=st_own)


def test_slot_exhaustion_retries_at_full_budget(catalogs):
    # hostname anti-affinity at 3000 pods: one node per pod, far past the
    # optimistic NR estimate — the port must detect exhaustion and re-solve
    # at the full budget, like the reference
    sel = {"app": "ha"}
    sc = dict(pods=_pods("ha", 2100, {"cpu": 0.1}, labels=sel, owner_key="ha",
                         anti=[(sel, "kubernetes.io/hostname")]))
    port_kw = build(PORT, sc, catalogs["port"])
    st = t_tensorize.tensorize(port_kw["pods"], port_kw["provisioners"],
                               port_kw["instance_types"])
    solver = t_tpu.TpuSolver(device="cpu")
    est = t_tpu.solve_dims(st, NE=0, node_budget=2100)
    full = t_tpu.solve_dims(st, NE=0, node_budget=2100, full_nr=True)
    assert est["NR"] < full["NR"]
    with pytest.raises(t_tpu.SlotsExhausted):
        solver.solve(st, raise_on_exhaust=True)
    out = t_tpu.TpuSolver(device="cpu").solve(st)
    assert len(out.result.nodes) == 2100 and not out.result.infeasible


@pytest.mark.parametrize("n_warm,n_spread", [(254, 2), (1000, 2), (1000, 5),
                                             (1000, 8), (1000, 14), (253, 2),
                                             (1000, 7)])
def test_spread_remainder_behind_an_open_row_matches_oracle(n_warm, n_spread):
    """ROADMAP Queue C2: a zone-spread group of n = 2 (mod 3) pods behind
    >= 254 unconstrained warm pods.  An open row in one zone left the band
    fill's integer remainder on that row's zone (a fractional band headroom
    took the unit), so the reference's scan leaves one pod unplaced where
    the oracle seats every pod.  The port's scan seats them all, as the
    oracle does, within the spread's skew."""
    import bench_torch as bt
    import chip_smoke as cs
    from karpenter_tpu_torch.solver import reference as t_reference

    catalog = t_catalog.generate_catalog(full=False)
    pods = (bt._warmstart_pods(n_warm, "cs")
            + cs.spread_deployment("sp0", n_spread))
    provs = [cs.provisioner()]
    oracle = t_reference.solve(pods, provs, catalog)
    st = t_tensorize.tensorize(pods, provs, catalog)
    scan = t_tpu.TpuSolver(device="cpu").solve(st).result
    assert scan.infeasible == oracle.infeasible == {}
    per_zone = {}
    for n in scan.nodes:
        per_zone[n.zone] = per_zone.get(n.zone, 0) + sum(
            1 for p in n.pods if p.name.startswith("sp0-"))
    zones = {o.zone for it in catalog for o in it.offerings}
    counts = [per_zone.get(z, 0) for z in zones]
    assert sum(counts) == n_spread and max(counts) - min(counts) <= 1
