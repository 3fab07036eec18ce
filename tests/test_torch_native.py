"""The port's native C++ tier (``solver/native.py`` over the repository's
``native/ffd.cpp``) against the reference package, on the CPU.

Every case of the reference's ``tests/test_native.py`` is here, each ONE
function written against a package namespace ``k`` and run over
``karpenter_tpu`` and over ``karpenter_tpu_torch`` (``device="cpu"``),
each from reset node-name counters.  The two packages compile the same
source each into a library of its own.  The reference test's assertions
hold on both runs, and the observations must be equal: ``assignments``
(node names included), ``infeasible``, node plans, the routing decisions,
and ``existing_compat``'s memo, which must also equal the naive
per-(group, node) loop.  Tolerance: none — bools, ints, names and prices
to 1e-6 equal.  The latency case's own bound (under 250 ms a solve) is the
reference's.
"""

import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"
GIB = 2.0 ** 30

MODULES = {
    "L": "models.labels",
    "catalog": "models.catalog",
    "metrics": "metrics",
    "pod": "models.pod",
    "provisioner": "models.provisioner",
    "req": "models.requirements",
    "tensorize": "models.tensorize",
    "native": "solver.native",
    "reference": "solver.reference",
    "scheduler": "solver.scheduler",
    "types": "solver.types",
}

_PACKAGES: dict = {}
_CATALOGS: dict = {}


def package(root: str) -> SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = SimpleNamespace(root=root, **{
            alias: importlib.import_module(f"{root}.{path}")
            for alias, path in MODULES.items()})
    return _PACKAGES[root]


def catalog(k, full=False):
    key = (k.root, full)
    if key not in _CATALOGS:
        _CATALOGS[key] = k.catalog.generate_catalog(full=full)
    return _CATALOGS[key]


def run_both(scenario, *args):
    seen = []
    for root in (REFERENCE, PORT):
        k = package(root)
        with k.types._node_lock:
            k.types._node_next = 0
        seen.append(scenario(k, *args))
    assert seen[1] == seen[0]
    return seen[1]


def scheduler(k, backend, **kw):
    if k.root == REFERENCE:
        return k.scheduler.BatchScheduler(backend=backend,
                                          compile_behind=False, **kw)
    return k.scheduler.BatchScheduler(backend=backend, device="cpu", **kw)


def default_prov(k, **kw):
    return k.provisioner.Provisioner(name=kw.pop("name", "default"),
                                     **kw).with_defaults()


def observe(res) -> dict:
    return dict(
        nodes=sorted(
            (n.name, n.instance_type, n.zone, n.capacity_type,
             round(n.price, 6), tuple(sorted(p.name for p in n.pods)))
            for n in res.nodes),
        existing=[(n.name, sorted(p.name for p in n.pods))
                  for n in res.existing_nodes],
        assignments=dict(sorted(res.assignments.items())),
        infeasible=dict(sorted(res.infeasible.items())),
    )


def check(k, pods, provs, cat, existing=()):
    """The reference's parity check against its own oracle."""
    oracle = k.reference.solve(pods, provs, cat,
                               existing_nodes=list(existing))
    st = k.tensorize.tensorize(pods, provs, cat)
    got = k.native.solve_tensors_native(st, existing_nodes=list(existing))
    assert len(got.infeasible) == len(oracle.infeasible)
    assert got.n_scheduled == oracle.n_scheduled
    if oracle.new_node_cost:
        assert got.new_node_cost / oracle.new_node_cost <= 1.02 + 1e-9
    return got


def m5_4x(k, zone, name=None, taints=(), extra=None):
    L = k.L
    it = next(t for t in catalog(k) if t.name == "m5.4xlarge")
    kw = {} if name is None else {"name": name}
    return k.types.SimNode(
        instance_type="m5.4xlarge", provisioner="default", zone=zone,
        capacity_type="on-demand", price=0.768,
        allocatable=dict(it.allocatable),
        labels={**it.labels(), L.ZONE: zone, L.CAPACITY_TYPE: "on-demand",
                L.PROVISIONER_NAME: "default", **(extra or {})},
        taints=list(taints), existing=True, **kw)


# ---------------------------------------------------------------------------
# parity with the oracle (TestNativeParity)
# ---------------------------------------------------------------------------


def _version(k):
    assert k.native.available()
    v = k.native.version()
    assert "karpenter-tpu-native" in v
    return v


def _single_group(k):
    pods = [k.pod.PodSpec(name=f"p{i}", requests={"cpu": 1.0})
            for i in range(50)]
    got = check(k, pods, [default_prov(k)], catalog(k))
    assert got.infeasible == {}
    return observe(got)


def _mixed_groups(k):
    P = k.pod.PodSpec
    pods = [P(name=f"a{i}", requests={"cpu": 1.0}, owner_key="a")
            for i in range(30)]
    pods += [P(name=f"b{i}", requests={"cpu": 0.5, "memory": 6 * GIB},
               owner_key="b") for i in range(30)]
    pods += [P(name=f"c{i}", requests={"cpu": 14.0}, owner_key="c")
             for i in range(2)]
    return observe(check(k, pods, [default_prov(k)], catalog(k)))


def _full_catalog(k):
    pods = [k.pod.PodSpec(name=f"p{i}",
                          requests={"cpu": 2.0, "memory": 4 * GIB})
            for i in range(100)]
    return observe(check(k, pods, [default_prov(k)], catalog(k, full=True)))


def _weighted_provisioners(k):
    L = k.L
    spot = k.provisioner.Provisioner(
        name="spot", weight=10,
        requirements=[k.req.Requirement(L.CAPACITY_TYPE, k.req.IN,
                                        [L.CAPACITY_TYPE_SPOT])],
    ).with_defaults()
    od = default_prov(k, name="od", weight=1)
    pods = [k.pod.PodSpec(name=f"p{i}", requests={"cpu": 1.0})
            for i in range(20)]
    got = check(k, pods, [spot, od], catalog(k))
    assert all(n.capacity_type == L.CAPACITY_TYPE_SPOT for n in got.nodes)
    return observe(got)


def _existing_nodes_first(k):
    existing = [m5_4x(k, "zone-1a", name="ex-0")]
    pods = [k.pod.PodSpec(name=f"p{i}", requests={"cpu": 1.0})
            for i in range(5)]
    got = check(k, pods, [default_prov(k)], catalog(k), existing=existing)
    assert got.nodes == []
    return observe(got)


def _infeasible(k):
    pods = [k.pod.PodSpec(name="giant", requests={"cpu": 9999.0}),
            k.pod.PodSpec(name="ok", requests={"cpu": 1.0})]
    got = check(k, pods, [default_prov(k)], catalog(k))
    assert "giant" in got.infeasible
    return observe(got)


def _zone_spread(k):
    L = k.L
    sel = k.pod.LabelSelector.of({"app": "web"})
    pods = [k.pod.PodSpec(
        name=f"p{i}", labels={"app": "web"}, requests={"cpu": 1.0},
        topology_spread=[k.pod.TopologySpreadConstraint(
            1, L.ZONE, "DoNotSchedule", sel)],
        owner_key="web") for i in range(12)]
    got = check(k, pods, [default_prov(k)], catalog(k))
    per_zone = {}
    for n in got.nodes:
        per_zone[n.zone] = per_zone.get(n.zone, 0) + len(n.pods)
    assert max(per_zone.values()) - min(per_zone.values()) <= 1
    return observe(got)


def _hostname_anti_affinity(k):
    L = k.L
    sel = k.pod.LabelSelector.of({"app": "solo"})
    pods = [k.pod.PodSpec(
        name=f"p{i}", labels={"app": "solo"}, requests={"cpu": 0.5},
        affinity_terms=[k.pod.PodAffinityTerm(sel, L.HOSTNAME, anti=True)],
        owner_key="solo") for i in range(6)]
    got = check(k, pods, [default_prov(k)], catalog(k))
    assert len(got.nodes) == 6
    assert all(len(n.pods) == 1 for n in got.nodes)
    return observe(got)


def _existing_topology_state(k):
    L = k.L
    sel = k.pod.LabelSelector.of({"app": "web"})
    n1 = m5_4x(k, "zone-1a", name="ex-0")
    for i in range(2):
        n1.pods.append(k.pod.PodSpec(name=f"old{i}", labels={"app": "web"},
                                     requests={"cpu": 1.0}, owner_key="web"))
    spread = [k.pod.TopologySpreadConstraint(1, L.ZONE, "DoNotSchedule",
                                             sel)]
    pods = [k.pod.PodSpec(name=f"new{i}", labels={"app": "web"},
                          requests={"cpu": 1.0},
                          topology_spread=list(spread), owner_key="web")
            for i in range(2)]
    got = check(k, pods, [default_prov(k)], catalog(k), existing=[n1])
    assert all(n.zone != "zone-1a" for n in got.nodes)
    return observe(got)


PARITY = {
    "version": _version,
    "single_group": _single_group,
    "mixed_groups": _mixed_groups,
    "full_catalog": _full_catalog,
    "weighted_provisioners": _weighted_provisioners,
    "existing_nodes_first": _existing_nodes_first,
    "infeasible": _infeasible,
    "zone_spread": _zone_spread,
    "hostname_anti_affinity": _hostname_anti_affinity,
    "existing_topology_state": _existing_topology_state,
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_native_parity_matches_reference(case):
    run_both(PARITY[case])


# ---------------------------------------------------------------------------
# routing (TestRouting)
# ---------------------------------------------------------------------------


def _tensors(k, n):
    pods = [k.pod.PodSpec(name=f"p{i}", requests={"cpu": 1.0})
            for i in range(n)]
    return k.tensorize.tensorize(pods, [default_prov(k)], catalog(k))


def _auto_routes_small_to_oracle(k):
    sched = scheduler(k, "auto")
    assert sched._route_small(10)
    assert not sched._route_native(_tensors(k, 10), 10)
    return sched._route_small(10), sched._route_small(257)


def _auto_small_batch_matches_oracle_exactly(k):
    reg = k.metrics.Registry()
    sched = scheduler(k, "auto", registry=reg)
    pods = [k.pod.PodSpec(name=f"p{i}", requests={"cpu": 1.0},
                          owner_key="u") for i in range(60)]
    got = sched.solve(pods, [default_prov(k)], catalog(k))
    oracle = k.reference.solve(pods, [default_prov(k)], catalog(k))
    assert len(got.nodes) == len(oracle.nodes)
    assert abs(got.new_node_cost - oracle.new_node_cost) < 1e-9
    h = reg.histogram(k.metrics.SOLVER_BACKEND_DURATION)
    assert h.count({"backend": "oracle"}) >= 1
    assert h.count({"backend": "tpu"}) == 0
    return observe(got), h.count({"backend": "oracle"})


def _auto_routes_big_to_device(k):
    sched = scheduler(k, "auto", native_batch_limit=64)
    assert not sched._route_small(100)
    assert not sched._route_native(_tensors(k, 100), 100)
    return sched._route_small(100)


def _forced_native_backend_routes_native(k):
    sched = scheduler(k, "native")
    assert sched._route_native(_tensors(k, 10), 10)
    return sched._route_small(10), sched._route_native(_tensors(k, 10), 10)


def _native_backend_end_to_end(k):
    reg = k.metrics.Registry()
    sched = scheduler(k, "native", registry=reg)
    pods = [k.pod.PodSpec(name=f"p{i}", requests={"cpu": 1.0},
                          owner_key="d") for i in range(300)]
    res = sched.solve(pods, [default_prov(k)], catalog(k))
    assert res.infeasible == {}
    assert res.n_scheduled == 300
    h = reg.histogram(k.metrics.SOLVER_BACKEND_DURATION)
    assert h.count({"backend": "native"}) == 1
    return observe(res), h.count({"backend": "tpu"})


def _existing_compat_memo_matches_naive(k):
    L, P, req = k.L, k.pod, k.req
    existing = (
        [m5_4x(k, "zone-1a", name=f"ex-{i}") for i in range(3)]
        + [m5_4x(k, "zone-1b", name=f"ex-{i + 3}",
                 taints=[P.Taint(key="dedicated", effect=L.EFFECT_NO_SCHEDULE,
                                 value="svc")]) for i in range(3)]
        + [m5_4x(k, "zone-1a", name="ex-7", extra={"tier": "gold"})]
    )
    for n in existing:
        n.labels[L.HOSTNAME] = n.name  # unique per node
    pods = (
        [P.PodSpec(name=f"plain{i}", requests={"cpu": 0.5},
                   owner_key=f"o{i}") for i in range(4)]
        + [P.PodSpec(name="tol", requests={"cpu": 0.5},
                     tolerations=[P.Toleration(
                         key="dedicated", operator="Equal", value="svc",
                         effect=L.EFFECT_NO_SCHEDULE)])]
        + [P.PodSpec(name="sel", requests={"cpu": 0.5},
                     node_selector={"tier": "gold"})]
        + [P.PodSpec(name="notin", requests={"cpu": 0.5},
                     required_affinity_terms=[[
                         req.Requirement("tier", req.NOT_IN, ["gold"])]])]
        + [P.PodSpec(name="exists-notin", requests={"cpu": 0.5},
                     required_affinity_terms=[[
                         req.Requirement("tier", req.EXISTS),
                         req.Requirement("tier", req.NOT_IN, ["gold"])]])]
    )
    st = k.tensorize.tensorize(pods, [default_prov(k)], catalog(k))
    got = k.native.existing_compat(st, existing)
    naive = np.zeros_like(got)
    for gi, g in enumerate(st.groups):
        rep = g.pods[0]
        for ni, n in enumerate(existing):
            naive[gi, ni] = (
                not any(t.blocks(rep.tolerations) for t in n.taints)
                and g.requirements.compatible(n.labels) is None)
    assert np.array_equal(got, naive)
    return got.tolist()


def _native_latency_microseconds(k):
    sched = scheduler(k, "native")
    pods = [k.pod.PodSpec(name=f"p{i}", requests={"cpu": 1.0})
            for i in range(10)]
    sched.solve(pods, [default_prov(k)], catalog(k))  # warm caches
    t0 = time.perf_counter()
    res = sched.solve(pods, [default_prov(k)], catalog(k))
    dt = (time.perf_counter() - t0) * 1000
    assert res.n_scheduled == 10
    assert dt < 250  # whole pipeline incl. tensorize
    return res.n_scheduled


ROUTING = {
    "auto_routes_small_to_oracle": _auto_routes_small_to_oracle,
    "auto_small_batch_matches_oracle_exactly":
        _auto_small_batch_matches_oracle_exactly,
    "auto_routes_big_to_device": _auto_routes_big_to_device,
    "forced_native_backend_routes_native":
        _forced_native_backend_routes_native,
    "native_backend_end_to_end": _native_backend_end_to_end,
    "existing_compat_memo_matches_naive": _existing_compat_memo_matches_naive,
    "native_latency_microseconds": _native_latency_microseconds,
}


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_native_routing_matches_reference(case):
    run_both(ROUTING[case])


def test_port_builds_into_its_own_build_dir():
    """The port compiles the repository's ffd.cpp into
    ``karpenter_tpu_torch/_build/``, never next to the reference."""
    t_native = package(PORT).native
    assert t_native.available()
    so = t_native._so_path()
    assert so.exists() and so.parent.name == "_build"
    assert so.parent.parent.name == "karpenter_tpu_torch"
    assert t_native._SRC.name == "ffd.cpp"
    assert t_native._SRC.parent.name == "native"
