"""The port's differential fuzz against its own oracle and the reference
package, on the CPU.

Every test of the reference's ``tests/test_fuzz_parity.py`` is here over
the port: existing-node parity with no overcommit and the caller's nodes
untouched, cost and feasibility parity, the kubelet overrides with the
independent density check, the suite means, the native tier, node count
on the spread mix, the five-provisioner limit cascade and determinism.
Each keeps the reference's gates against the port's oracle
(``karpenter_tpu_torch.solver.reference.solve``): the floors, the per-seed
ceilings, the 0.90 mean and the validator (the port's own
``solver/validate.py``).  Each is also held to the reference package on
the same seed: the scenario is built once with the reference's generator
and converted with ``to_port``; both packages' node-name counters are set
to one value before each solve; the reference's scheduler compiles
inline (``compile_behind=False``).  Then both seat the same number of
pods, leave the same pods infeasible, buy new nodes at the same cost to
1e-6 and give the same node plan or ``placements_tie``.

Also: the port's generators (``scripts/fuzz_sweep_torch.py``) give exactly
``to_port`` of the reference's scenarios for seeds 0-39, and ROADMAP C9 —
new nodes whose names collide with the caller's existing nodes move the
plan, in both packages alike — and ROADMAP C11: a hierarchical plan whose
price loop re-solved blocks keeps the dual-adjusted prices on their
nodes, in both packages alike.

Seeds come from ``KT_FUZZ_SEEDS`` (default 10), as in the reference.
"""

import dataclasses
import os
import sys

import pytest
import torch

from karpenter_tpu.models.catalog import generate_catalog as ref_catalog
from karpenter_tpu.models.tensorize import tensorize as ref_tensorize
from karpenter_tpu.solver import types as ref_types
from karpenter_tpu.solver.scheduler import BatchScheduler as RefScheduler
from karpenter_tpu.solver.tpu import solve_tensors as ref_solve_tensors
from karpenter_tpu_torch.models import labels as L
from karpenter_tpu_torch.models.catalog import generate_catalog
from karpenter_tpu_torch.models.instancetype import GIB, kubelet_pod_density
from karpenter_tpu_torch.models.pod import PodSpec
from karpenter_tpu_torch.models.provisioner import Provisioner
from karpenter_tpu_torch.models.requirements import IN, Requirement
from karpenter_tpu_torch.models.tensorize import tensorize
from karpenter_tpu_torch.solver import native, reference
from karpenter_tpu_torch.solver import types as port_types
from karpenter_tpu_torch.solver.scheduler import BatchScheduler
from karpenter_tpu_torch.solver.tpu import solve_tensors
from karpenter_tpu_torch.solver.validate import validate_solution
from scripts import fuzz_sweep_torch as fz

sys.path.insert(0, os.path.dirname(__file__))
import test_fuzz_parity as ref_fuzz  # noqa: E402
from test_torch_relax import to_port  # noqa: E402

torch.set_num_threads(1)

SEEDS = range(int(os.environ.get("KT_FUZZ_SEEDS", "10")))
_RATIOS: dict = {}  # suite -> [per-pod cost ratios], gated at the end


@pytest.fixture(scope="module")
def catalogs():
    return ref_catalog(full=False), generate_catalog(full=False)


def names_from(start: int) -> None:
    """Set both packages' node-name counters to ``start``."""
    for mod in (ref_types, port_types):
        with mod._node_lock:
            mod._node_next = start


def ref_scenario(suite, seed, rcat):
    """``(pods, provisioners, unavailable, existing)`` of one seed built by
    the reference's generators from counter 0, or ``None`` where the
    kubelet suite drew no override."""
    names_from(0)
    pods, provs, unavailable = ref_fuzz.random_scenario(seed, rcat)
    existing = []
    if suite == "kubelet":
        provs = ref_fuzz.with_random_kubelet(seed, provs)
        if all(p.kubelet is None for p in provs):
            return None
    if suite == "existing":
        existing = ref_fuzz.random_existing_nodes(seed, rcat, provs)
    return pods, provs, unavailable, existing


def assert_same_solve(got, ref, seed):
    """The port's result against the reference's on one seed."""
    assert got.n_scheduled == ref.n_scheduled, (
        f"seed {seed}: scheduled port={got.n_scheduled} "
        f"reference={ref.n_scheduled}")
    assert set(got.infeasible) == set(ref.infeasible), f"seed {seed}"
    assert abs(got.new_node_cost - ref.new_node_cost) <= 1e-6, (
        f"seed {seed}: port ${got.new_node_cost} reference "
        f"${ref.new_node_cost}")
    assert fz.same_plan(got, ref), f"seed {seed}: node plans differ"


def solve_both(suite, seed, catalogs, backend="tpu"):
    """One seed of a suite through both packages' schedulers from counter
    1000, held equal.  Returns the port's scenario, the port's oracle and
    the port's result, or ``None`` for a kubelet seed without overrides.
    Neither package nor the oracle may touch the caller's nodes."""
    rcat, pcat = catalogs
    scen = ref_scenario(suite, seed, rcat)
    if scen is None:
        return None
    pods, provs, unavailable, existing = scen
    ppods, pprovs, punav, pexisting = to_port(scen)
    kw = {"existing_nodes": existing} if suite == "existing" else {}
    pkw = {"existing_nodes": pexisting} if suite == "existing" else {}
    before = [(n.name, len(n.pods)) for n in existing + pexisting]
    oracle = reference.solve(ppods, pprovs, pcat, unavailable=punav, **pkw)
    names_from(1000)
    ref = RefScheduler(backend=backend, compile_behind=False).solve(
        pods, provs, rcat, unavailable=unavailable, **kw)
    names_from(1000)
    got = BatchScheduler(backend=backend, device="cpu").solve(
        ppods, pprovs, pcat, unavailable=punav, **pkw)
    assert_same_solve(got, ref, seed)
    assert [(n.name, len(n.pods)) for n in existing + pexisting] == before
    return (ppods, pprovs, punav, pexisting), oracle, got


def content(obj):
    """A model object's fields, recursively, without the pods' process-wide
    ``uid``: what two packages' generators must agree on."""
    if isinstance(obj, (list, tuple)):
        return [content(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(map(repr, obj))
    if isinstance(obj, dict):
        return {k: content(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, {
            f.name: content(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name != "uid"})
    return obj


def _gate_cost(seed, suite, oracle, got, ceiling):
    """The reference's per-pod cost-ratio gate, against the port's
    oracle."""
    if oracle.new_node_cost <= 0:
        if got.n_scheduled <= oracle.n_scheduled:
            assert got.new_node_cost == 0, (
                f"seed {seed}: device launched {len(got.nodes)} "
                "unnecessary nodes")
        return
    if got.n_scheduled == 0 or oracle.n_scheduled == 0:
        return
    ratio = fz.per_pod_ratio(got, oracle)
    _RATIOS.setdefault(suite, []).append(ratio)
    assert ratio <= ceiling + 1e-9, (
        f"seed {seed}: per-pod cost ratio {ratio:.4f} "
        f"(port ${got.new_node_cost:.3f}/{got.n_scheduled} vs "
        f"oracle ${oracle.new_node_cost:.3f}/{oracle.n_scheduled})")


# ---------------------------------------------------------------------------
# the generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(40))
def test_generators_match_the_reference(seed, catalogs):
    """Pods, provisioners, ICE'd offerings, existing nodes (names, fillers)
    and kubelet configurations of the port's generators equal the
    reference's, converted."""
    rcat, pcat = catalogs
    names_from(0)
    pods, provs, unavailable = ref_fuzz.random_scenario(seed, rcat)
    existing = ref_fuzz.random_existing_nodes(seed, rcat, provs)
    kubelet = ref_fuzz.with_random_kubelet(seed, provs)
    names_from(0)
    ppods, pprovs, punav = fz.random_scenario(seed, pcat)
    pexisting = fz.random_existing_nodes(seed, pcat, pprovs)
    pkubelet = fz.with_random_kubelet(seed, pprovs)
    assert content(ppods) == content(pods)
    assert content(pprovs) == content(provs)
    assert punav == unavailable
    assert content(pexisting) == content(existing)
    assert [n.name for n in pexisting] == [n.name for n in existing]
    assert content(pkubelet) == content(kubelet)


# ---------------------------------------------------------------------------
# the reference's suites
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_existing_node_parity_and_no_overcommit(seed, catalogs):
    """Against pre-populated cluster state: the port's oracle gates, no
    node overcommitted, the caller's node objects untouched."""
    _rcat, pcat = catalogs
    (pods, provs, unavailable, _), oracle, got = solve_both(
        "existing", seed, catalogs)
    floor = oracle.n_scheduled - max(2, oracle.n_scheduled // 4)
    assert got.n_scheduled >= floor, (
        f"seed {seed}: scheduled port={got.n_scheduled} "
        f"oracle={oracle.n_scheduled}")
    errs = validate_solution(pods, provs, got, pcat, unavailable=unavailable)
    assert not errs, f"seed {seed}: invalid solution: {errs[:4]}"
    _gate_cost(seed, "existing", oracle, got, fz.FUZZ_PARITY_EXISTING)
    for res in (oracle, got):
        for node in list(res.existing_nodes) + list(res.nodes):
            for k, v in node.used().items():
                assert v <= node.allocatable.get(k, 0.0) + 1e-6, (
                    f"seed {seed}: {node.name} overcommitted on {k}: "
                    f"{v} > {node.allocatable.get(k)}")


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_cost_and_feasibility_parity(seed, catalogs):
    _rcat, pcat = catalogs
    (pods, provs, unavailable, _), oracle, got = solve_both(
        "plain", seed, catalogs)
    floor = oracle.n_scheduled - max(2, oracle.n_scheduled // 10)
    assert got.n_scheduled >= floor, (
        f"seed {seed}: scheduled port={got.n_scheduled} "
        f"oracle={oracle.n_scheduled}")
    errs = validate_solution(pods, provs, got, pcat, unavailable=unavailable)
    assert not errs, f"seed {seed}: invalid solution: {errs[:4]}"
    _gate_cost(seed, "plain", oracle, got, fz.FUZZ_PARITY)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_kubelet_overrides_parity(seed, catalogs):
    """Per-provisioner maxPods / podsPerCore / kube-reserved overrides:
    gates, parity, and every node's pod count under the density cap
    derived from the raw catalog and the provisioner's configuration."""
    _rcat, pcat = catalogs
    both = solve_both("kubelet", seed, catalogs)
    if both is None:
        pytest.skip("no kubelet override drawn for this seed")
    (pods, provs, unavailable, _), oracle, got = both
    floor = oracle.n_scheduled - max(2, oracle.n_scheduled // 10)
    assert got.n_scheduled >= floor
    errs = validate_solution(pods, provs, got, pcat, unavailable=unavailable)
    assert not errs, f"seed {seed}: invalid solution: {errs[:4]}"
    by_prov = {p.name: p for p in provs}
    by_type = {it.name: it for it in pcat}
    for res in (oracle, got):
        for node in res.nodes:
            kc = by_prov[node.provisioner].kubelet
            if kc is None or not (kc.max_pods or kc.pods_per_core):
                continue
            it = by_type[node.instance_type]
            cap = kubelet_pod_density(
                it.capacity.get(L.RESOURCE_PODS, 110.0),
                it.capacity.get("cpu", 0.0), kc)
            assert len(node.pods) <= cap + 1e-9, (
                f"seed {seed}: {node.name} ({node.instance_type}) packs "
                f"{len(node.pods)} pods over kubelet density cap {cap}")
    _gate_cost(seed, "kubelet", oracle, got, fz.FUZZ_PARITY_KUBELET)


def test_zz_fuzz_cost_mean():
    """The mean per-pod ratio per suite (5 samples or more) stays inside
    the 0.90 band."""
    gated = False
    for suite, ratios in _RATIOS.items():
        if len(ratios) < 5:
            continue
        gated = True
        mean = sum(ratios) / len(ratios)
        assert mean <= fz.FUZZ_MEAN + 1e-9, (
            f"{suite}: mean per-pod cost ratio {mean:.4f} over "
            f"{len(ratios)} seeds (max {max(ratios):.4f})")
    if not gated:
        pytest.skip("not enough ratio samples in this selection")


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_native_parity(seed, catalogs):
    """``backend="native"`` against the port's oracle (never fewer pods,
    the 1.02 per-pod ceiling, valid) and the reference's native tier.
    Positive pod affinity routes away from the native tier: skipped."""
    _rcat, pcat = catalogs
    if not native.available():
        pytest.skip("native lib unavailable")
    pods, provs, unavailable = fz.random_scenario(seed, pcat)
    if native.has_topology(tensorize(pods, provs, pcat,
                                     unavailable=unavailable)):
        pytest.skip("positive pod-affinity routes away from the native tier")
    (pods, provs, unavailable, _), oracle, got = solve_both(
        "plain", seed, catalogs, backend="native")
    assert got.n_scheduled >= oracle.n_scheduled, (
        f"seed {seed}: scheduled native={got.n_scheduled} "
        f"oracle={oracle.n_scheduled}")
    ratio = fz.per_pod_ratio(got, oracle)
    assert ratio is None or ratio <= fz.PARITY + 1e-9, (
        f"seed {seed}: per-pod cost ratio {ratio:.4f}")
    errs = validate_solution(pods, provs, got, pcat, unavailable=unavailable)
    assert not errs, f"seed {seed}: invalid native solution: {errs[:4]}"


def spread_mix(pkg_pod):
    """The reference's 8 x 250 zone-spread mix over one package's pod
    models."""
    pods = []
    for d in range(8):
        sel = pkg_pod.LabelSelector.of({"app": f"d{d}"})
        for i in range(250):
            pods.append(pkg_pod.PodSpec(
                name=f"d{d}-{i}", labels={"app": f"d{d}"},
                requests={"cpu": 0.25 * (1 + d % 8),
                          "memory": (0.5 + d % 6) * GIB},
                topology_spread=[pkg_pod.TopologySpreadConstraint(
                    1, L.ZONE, "DoNotSchedule", sel)],
                owner_key=f"d{d}",
            ))
    return pods


def test_node_count_parity_on_spread_mix(catalogs):
    """At equal $/pod the solver prefers fewer, larger nodes: within 1.02
    of the oracle's cost and 1.15x its node count, and the reference's
    plan."""
    import karpenter_tpu.models.pod as ref_pod
    import karpenter_tpu.models.provisioner as ref_prov
    import karpenter_tpu_torch.models.pod as port_pod

    rcat, pcat = catalogs
    pods = spread_mix(port_pod)
    provs = [Provisioner(name="default").with_defaults()]
    oracle = reference.solve(pods, provs, pcat)
    names_from(1000)
    got = solve_tensors(tensorize(pods, provs, pcat), device="cpu").result
    names_from(1000)
    ref = ref_solve_tensors(ref_tensorize(
        spread_mix(ref_pod),
        [ref_prov.Provisioner(name="default").with_defaults()],
        rcat)).result
    assert_same_solve(got, ref, "spread-mix")
    assert not got.infeasible and not oracle.infeasible
    ratio = got.new_node_cost / oracle.new_node_cost
    assert ratio <= fz.PARITY + 1e-9, f"cost ratio {ratio:.4f}"
    assert len(got.nodes) <= 1.15 * len(oracle.nodes), (
        f"node count {len(got.nodes)} vs FFD {len(oracle.nodes)}")


def test_limit_cascade_five_provisioners(catalogs):
    """A group cascading through five limit-capped provisioners places
    exactly what the oracle places (the residue-convergence waves), as the
    reference does."""
    from karpenter_tpu.models import labels as RL
    from karpenter_tpu.models.pod import PodSpec as RefPod
    from karpenter_tpu.models.provisioner import Provisioner as RefProv
    from karpenter_tpu.models.requirements import IN as RIN
    from karpenter_tpu.models.requirements import Requirement as RefReq

    rcat, pcat = catalogs
    rprovs = [
        RefProv(name=f"capped{i}", weight=10 - i, limits={"cpu": 8.0},
                requirements=[RefReq(RL.INSTANCE_TYPE, RIN, ["c5.2xlarge"])],
                ).with_defaults()
        for i in range(5)
    ]
    rpods = [RefPod(name=f"p{i}", requests={"cpu": 1.0}, owner_key="d")
             for i in range(38)]
    provs = [
        Provisioner(name=f"capped{i}", weight=10 - i, limits={"cpu": 8.0},
                    requirements=[Requirement(L.INSTANCE_TYPE, IN,
                                              ["c5.2xlarge"])],
                    ).with_defaults()
        for i in range(5)
    ]
    pods = [PodSpec(name=f"p{i}", requests={"cpu": 1.0}, owner_key="d")
            for i in range(38)]
    assert content(rprovs) == content(provs)
    assert content(rpods) == content(pods)
    oracle = reference.solve(pods, provs, pcat)
    names_from(1000)
    got = BatchScheduler(backend="tpu", device="cpu").solve(pods, provs, pcat)
    names_from(1000)
    ref = RefScheduler(backend="tpu", compile_behind=False).solve(
        rpods, rprovs, rcat)
    assert_same_solve(got, ref, "cascade")
    assert got.n_scheduled == oracle.n_scheduled, (
        f"scheduled port={got.n_scheduled} oracle={oracle.n_scheduled} "
        f"(port infeasible={len(got.infeasible)})")
    assert len(got.nodes) == len(oracle.nodes) == 5
    assert {n.provisioner for n in got.nodes} == {f"capped{i}"
                                                  for i in range(5)}
    assert abs(got.new_node_cost - oracle.new_node_cost) < 1e-6
    errs = validate_solution(pods, provs, got, pcat)
    assert not errs, f"invalid cascade solution: {errs[:4]}"


def test_fuzz_determinism(catalogs):
    """The same tensors solved twice give the identical packing, which is
    the reference's packing of the same scenario."""
    rcat, pcat = catalogs
    pods, provs, unavailable, _ = ref_scenario("plain", 3, rcat)
    st = tensorize(*to_port((pods, provs)), pcat,
                   unavailable=to_port(unavailable))
    names_from(1000)
    a = solve_tensors(st, device="cpu")
    b = solve_tensors(st, device="cpu")
    names_from(1000)
    ref = ref_solve_tensors(ref_tensorize(pods, provs, rcat,
                                          unavailable=unavailable))

    def canonical(res):
        # node names come from a global counter: packing shape, not ids
        idx = {n.name: i for i, n in enumerate(res.nodes)}
        return (
            {p: idx[n] for p, n in res.assignments.items()},
            [(n.instance_type, n.zone, n.capacity_type) for n in res.nodes],
        )

    assert canonical(a.result) == canonical(b.result)
    assert_same_solve(a.result, ref.result, 3)
    assert abs(a.result.new_node_cost - b.result.new_node_cost) < 1e-9


# ---------------------------------------------------------------------------
# ROADMAP C9: minted names colliding with the caller's existing nodes
# ---------------------------------------------------------------------------

#: (seed, counter start the existing nodes are named from, the solve
#: starts: colliding first, clear last)
C9_CASES = [(2, 8, (0, 7, 1000)), (13, 0, (0, 1000))]


@pytest.mark.parametrize("seed,named_from,starts", C9_CASES)
def test_c9_plan_cost_moves_with_name_collisions(seed, named_from, starts,
                                                 catalogs):
    """Existing-node seeds 2 and 13: a solve whose node-name counter
    starts at or below the existing nodes' indices mints names equal to
    theirs, and the plan's cost moves ($16.92 clear against $19.944 /
    $17.928 colliding for seed 2, $23.5869 against $25.0233 for seed 13).
    Both packages give the same cost from every start: the reference is at
    fault and the port follows it."""
    rcat, pcat = catalogs
    names_from(named_from)
    pods, provs, unavailable = ref_fuzz.random_scenario(seed, rcat)
    existing = ref_fuzz.random_existing_nodes(seed, rcat, provs)
    taken = {n.name for n in existing}
    port_scen = to_port((pods, provs, unavailable, existing))
    costs, collided = {}, {}
    for start in starts:
        names_from(start)
        ref = RefScheduler(backend="tpu", compile_behind=False).solve(
            pods, provs, rcat, unavailable=unavailable,
            existing_nodes=existing)
        minted = {f"node-{i}" for i in range(start, ref_types._node_next)}
        names_from(start)
        got = BatchScheduler(backend="tpu", device="cpu").solve(
            port_scen[0], port_scen[1], pcat, unavailable=port_scen[2],
            existing_nodes=port_scen[3])
        assert abs(got.new_node_cost - ref.new_node_cost) <= 1e-6, start
        assert fz.same_plan(got, ref), start
        costs[start] = got.new_node_cost
        collided[start] = bool(minted & taken)
    assert len({round(c, 6) for c in costs.values()}) >= 2, costs
    assert collided[starts[0]] and not collided[starts[-1]], collided
    assert costs[starts[0]] > costs[starts[-1]], costs


# ---------------------------------------------------------------------------
# ROADMAP C11: the price loop's re-solved nodes keep dual-adjusted prices
# ---------------------------------------------------------------------------


def _ref_spread_deployments(nd: int, per: int):
    """``chip_smoke.deployments`` over the reference's models: ``nd``
    zone-spread deployments of ``per`` pods, one coupling component each."""
    from karpenter_tpu.models.instancetype import GIB as REF_GIB
    from karpenter_tpu.models.pod import LabelSelector as RefSelector
    from karpenter_tpu.models.pod import PodSpec as RefPod
    from karpenter_tpu.models.pod import TopologySpreadConstraint as RefTSC

    pods = []
    for d in range(nd):
        sel = RefSelector.of({"app": f"h{d}"})
        pods += [RefPod(name=f"h{d}-{i}", labels={"app": f"h{d}"},
                        requests={"cpu": 0.25 * (1 + d % 8),
                                  "memory": (0.5 + (d % 6)) * REF_GIB},
                        topology_spread=[RefTSC(1, L.ZONE, "DoNotSchedule",
                                                sel)],
                        owner_key=f"h{d}")
                 for i in range(per)]
    return pods


def to_reference_provisioner(prov):
    """The reference's copy of a port provisioner with its limits."""
    from karpenter_tpu.models.provisioner import Provisioner as RefProv

    out = RefProv(name=prov.name).with_defaults()
    out.limits = dict(prov.limits)
    return out


def test_c11_price_loop_nodes_keep_adjusted_prices(monkeypatch):
    """4 zone-spread deployments x 1,000 pods, routed hierarchically, under
    a cpu limit at their unconstrained buy: the price loop re-solves the
    contending blocks at dual-adjusted candidate prices, and the merged
    plan keeps those prices on its nodes, so ``new_node_cost`` ($111.24)
    is not what the nodes cost at the catalog's prices ($106.96), and an
    operator launching the plan pays less than the plan says.  Both
    packages give the same plan from the same counters: the reference is
    at fault and the port follows it."""
    monkeypatch.setenv("KT_HIER_THRESHOLD", "4000")
    rcat, pcat = ref_catalog(full=True), generate_catalog(full=True)
    rpods = _ref_spread_deployments(4, 1000)
    pods = to_port(rpods)
    names_from(1000)
    sched = BatchScheduler(backend="tpu", device="cpu")
    free = sched.solve(pods, [Provisioner(name="default").with_defaults()],
                       pcat)
    st = tensorize(pods, [Provisioner(name="default").with_defaults()],
                   pcat)
    limit = round(sum(float(st.capacity_row(n.instance_type,
                                            n.allocatable)[0])
                      for n in free.nodes), 1)
    prov = Provisioner(name="default").with_defaults()
    prov.limits = {"cpu": limit}
    names_from(1000)
    sched = BatchScheduler(backend="tpu", device="cpu")
    got = sched.solve(pods, [prov], pcat)
    assert sched.hier_stats["price_iters"] >= 1
    names_from(1000)
    ref = RefScheduler(backend="tpu", compile_behind=False).solve(
        rpods, [to_reference_provisioner(prov)], rcat)
    assert abs(got.new_node_cost - ref.new_node_cost) <= 1e-6
    assert fz.same_plan(got, ref)
    for res, cat in ((got, pcat), (ref, rcat)):
        price = {(it.name, o.zone, o.capacity_type): o.price
                 for it in cat for o in it.offerings}
        listed = [price[(n.instance_type, n.zone, n.capacity_type)]
                  for n in res.nodes]
        off = sum(abs(n.price - p) > 1e-6 * p
                  for n, p in zip(res.nodes, listed))
        assert off > 0
        assert sum(listed) < res.new_node_cost - 1.0
