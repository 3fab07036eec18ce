"""Gang scheduling of the port against the reference package, on the CPU.

Every case of the reference's ``tests/test_gang.py`` is here, each ONE
function written against a package namespace ``k`` and run twice, once
over ``karpenter_tpu`` and once over ``karpenter_tpu_torch`` (``device=
"cpu"``), each from reset node-name counters.  The reference test's own
assertions hold on both runs, and what each run observed must be equal:
``assignments`` (node names included), ``infeasible`` (reason strings
character for character), node plans and the gang metric values.
Tolerance: none — bools, ints, names and reason strings equal.

The reference's over-the-wire delta cases run in process through
``BatchScheduler.solve_delta`` (the service is not ported yet); its wire
cases check what the codec relies on: an ungrouped pod validates clean and
the gang fields survive the copies the solver makes.  The atomicity cases
also run on the device backend (``backend="tpu"``: the port's group loop
on the CPU, the reference compiling inline), and a gang-bearing batch goes
through the hierarchical solve under a lowered ``KT_HIER_THRESHOLD`` with
a binding provisioner limit.
"""

import copy
import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"
GIB = 2.0 ** 30

MODULES = {
    "gang": "gang",
    "metrics": "metrics",
    "L": "models.labels",
    "catalog": "models.catalog",
    "pod": "models.pod",
    "provisioner": "models.provisioner",
    "tensorize": "models.tensorize",
    "scheduler": "solver.scheduler",
    "hierarchy": "solver.hierarchy",
    "consolidation": "solver.consolidation",
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


def small_catalog(k):
    if k.root not in _CATALOGS:
        _CATALOGS[k.root] = k.catalog.generate_catalog(full=False)
    return _CATALOGS[k.root]


def reset_names(k) -> None:
    with k.types._node_lock:
        k.types._node_next = 0


def run_both(scenario, *args, **kw):
    """``scenario(k, ...)`` over the reference, then over the port; the two
    observations must be equal."""
    seen = []
    for root in (REFERENCE, PORT):
        k = package(root)
        reset_names(k)
        seen.append(scenario(k, *args, **kw))
    assert seen[1] == seen[0]
    return seen[1]


def scheduler(k, backend="oracle", registry=None):
    if k.root == REFERENCE:
        return k.scheduler.BatchScheduler(backend=backend, registry=registry,
                                          compile_behind=False)
    return k.scheduler.BatchScheduler(backend=backend, registry=registry,
                                      device="cpu")


def default_prov(k):
    return k.provisioner.Provisioner(name="default").with_defaults()


def member(k, gid, i, size, cpu=0.5, sel=None, labels=None):
    return k.pod.PodSpec(
        name=f"{gid}-m{i}", labels=dict(labels or {"app": gid}),
        requests={"cpu": cpu, "memory": 0.5 * GIB},
        node_selector=dict(sel or {}), owner_key=gid,
        gang_id=gid, gang_size=size)


def singles(k, tag, n, cpu=0.5):
    return [k.pod.PodSpec(name=f"{tag}-{i}", labels={"app": tag},
                          requests={"cpu": cpu, "memory": 0.5 * GIB},
                          owner_key=tag)
            for i in range(n)]


def existing_node(k, name, itype, cpu, mem_gib, price):
    L = k.L
    node = k.types.SimNode(
        instance_type=itype, provisioner="default", zone="zone-1a",
        capacity_type="on-demand", price=price,
        allocatable={L.RESOURCE_CPU: cpu, L.RESOURCE_MEMORY: mem_gib * GIB,
                     L.RESOURCE_PODS: 110.0},
        existing=True, name=name)
    node.stamp_labels()
    return node


def gang_outcome(res, members):
    placed = [p for p in members if p.name in res.assignments]
    if len(placed) == len(members):
        return "placed"
    assert not placed, (
        f"PARTIAL gang: {len(placed)}/{len(members)} seated — "
        "the all-or-nothing contract is broken")
    return "retracted"


def observe(res) -> dict:
    """Everything a solve decided, name for name."""
    return dict(
        nodes=sorted(
            (n.name, n.instance_type, n.zone, n.capacity_type,
             round(n.price, 6), tuple(sorted(p.name for p in n.pods)))
            for n in res.nodes),
        existing=[(n.name, sorted(p.name for p in n.pods))
                  for n in res.existing_nodes],
        assignments=dict(sorted(res.assignments.items())),
        infeasible=dict(sorted((p, str(r))
                               for p, r in res.infeasible.items())),
    )


def gang_metrics(k, reg) -> dict:
    m = k.metrics
    return dict(
        gangs=dict(reg.counter(m.GANG_GANGS).values),
        zones=(dict(reg.histogram(m.GANG_SPREAD_ZONES).totals),
               dict(reg.histogram(m.GANG_SPREAD_ZONES).sums)),
        classes=(dict(reg.histogram(m.GANG_SPREAD_CLASSES).totals),
                 dict(reg.histogram(m.GANG_SPREAD_CLASSES).sums)),
        duration_n=dict(reg.histogram(m.GANG_DURATION).totals),
    )


def solve(k, pods, backend="oracle", **kw):
    reg = k.metrics.Registry()
    res = scheduler(k, backend, reg).solve(
        pods, [default_prov(k)], small_catalog(k), **kw)
    return res, reg


# ---------------------------------------------------------------------------
# atomicity (TestAtomicity) — oracle and device backends
# ---------------------------------------------------------------------------


def _feasible_gang_places_whole(k, backend):
    pods = [member(k, "ga", i, 4) for i in range(4)] + singles(k, "s", 6)
    res, reg = solve(k, pods, backend)
    assert gang_outcome(res, pods[:4]) == "placed"
    assert all(f"s-{i}" in res.assignments for i in range(6))
    return observe(res), gang_metrics(k, reg)


def _unsatisfiable_member_retracts_every_seat(k, backend):
    doomed = [member(k, "gx", i, 5) for i in range(5)]
    doomed[2] = dataclasses.replace(
        doomed[2], node_selector={k.L.ZONE: "zone-none"})
    pods = doomed + singles(k, "s", 6)
    res, reg = solve(k, pods, backend)
    assert gang_outcome(res, doomed) == "retracted"
    for p in doomed:
        assert str(res.infeasible[p.name]).startswith("GangUnplaced")
    assert all(f"s-{i}" in res.assignments for i in range(6))
    return observe(res), gang_metrics(k, reg)


def _incomplete_roster_waits_whole(k, backend):
    early = [member(k, "gw", i, 8) for i in range(3)]
    res, reg = solve(k, early + singles(k, "s", 4), backend)
    assert gang_outcome(res, early) == "retracted"
    assert "could seat only" in str(res.infeasible["gw-m0"])
    return observe(res), gang_metrics(k, reg)


def _preseated_comembers_complete_the_roster(k, backend):
    node = existing_node(k, "gex0", "m5.xlarge", 4.0, 14.8, 0.192)
    for i in (0, 1):
        node.pods.append(member(k, "gp", i, 4))
    late = [member(k, "gp", i, 4) for i in (2, 3)]
    res, reg = solve(k, late, backend, existing_nodes=[node])
    assert gang_outcome(res, late) == "placed"
    return observe(res), gang_metrics(k, reg)


def _preseated_majority_never_masks_an_unplaced_member(k, backend):
    node = existing_node(k, "gex1", "m5.2xlarge", 8.0, 29.6, 0.384)
    for i in (0, 1, 2):
        node.pods.append(member(k, "gm", i, 4))
    last = dataclasses.replace(
        member(k, "gm", 3, 4), node_selector={k.L.ZONE: "zone-none"})
    res, reg = solve(k, [last], backend, existing_nodes=[node])
    assert last.name not in res.assignments
    assert str(res.infeasible[last.name]).startswith("GangUnplaced")
    return observe(res), gang_metrics(k, reg)


ATOMICITY = {
    "feasible_gang_places_whole": _feasible_gang_places_whole,
    "unsatisfiable_member_retracts_every_seat":
        _unsatisfiable_member_retracts_every_seat,
    "incomplete_roster_waits_whole": _incomplete_roster_waits_whole,
    "preseated_comembers_complete_the_roster":
        _preseated_comembers_complete_the_roster,
    "preseated_majority_never_masks_an_unplaced_member":
        _preseated_majority_never_masks_an_unplaced_member,
}


@pytest.mark.parametrize("case", sorted(ATOMICITY))
def test_atomicity_matches_reference(case):
    run_both(ATOMICITY[case], "oracle")


@pytest.mark.parametrize("case", sorted(ATOMICITY))
def test_atomicity_on_device_backend_matches_reference(case):
    run_both(ATOMICITY[case], "tpu")


# ---------------------------------------------------------------------------
# the kill switch (TestKillSwitch)
# ---------------------------------------------------------------------------


def _gang_free_batches_are_byte_identical(k, monkeypatch):
    pods = singles(k, "kf", 20) + singles(k, "kg", 10, cpu=1.0)
    monkeypatch.delenv("KT_GANG", raising=False)
    on, _ = solve(k, pods)
    monkeypatch.setenv("KT_GANG", "0")
    off, _ = solve(k, pods)
    monkeypatch.delenv("KT_GANG")

    def canon(res):
        by_node = {n.name: (n.instance_type, n.zone, n.capacity_type,
                            tuple(sorted(p.name for p in n.pods)))
                   for n in res.nodes}
        return {pn: by_node.get(nn) for pn, nn in res.assignments.items()}

    assert canon(on) == canon(off)
    assert on.infeasible == off.infeasible
    return observe(on), canon(off)


def _kill_switch_restores_per_pod_behavior(k, monkeypatch):
    monkeypatch.setenv("KT_GANG", "0")
    doomed = [member(k, "gz", i, 4) for i in range(4)]
    doomed[0] = dataclasses.replace(
        doomed[0], node_selector={k.L.ZONE: "zone-none"})
    res, reg = solve(k, doomed)
    monkeypatch.delenv("KT_GANG")
    assert all(p.name in res.assignments for p in doomed[1:])
    assert "gz-m0" in res.infeasible
    assert not str(res.infeasible["gz-m0"]).startswith("GangUnplaced")
    return observe(res), gang_metrics(k, reg)


KILL_SWITCH = {
    "gang_free_batches_are_byte_identical":
        _gang_free_batches_are_byte_identical,
    "kill_switch_restores_per_pod_behavior":
        _kill_switch_restores_per_pod_behavior,
}


@pytest.mark.parametrize("case", sorted(KILL_SWITCH))
def test_kill_switch_matches_reference(case, monkeypatch):
    run_both(KILL_SWITCH[case], monkeypatch)


# ---------------------------------------------------------------------------
# validation (TestValidation): the same typed errors, the same messages
# ---------------------------------------------------------------------------


def _refusal(k, pods):
    with pytest.raises(k.gang.GangValidationError) as exc:
        k.gang.validate_batch(pods)
    assert isinstance(exc.value, ValueError)
    return str(exc.value)


def _disagreeing_sizes_refused(k):
    return _refusal(k, [member(k, "gv", 0, 4), dataclasses.replace(
        member(k, "gv", 1, 4), gang_size=5)])


def _oversubscribed_roster_refused(k):
    return _refusal(k, [member(k, "gv", i, 2) for i in range(3)])


def _nonpositive_size_refused(k):
    return _refusal(k, [dataclasses.replace(member(k, "gv", 0, 1),
                                            gang_size=-2)])


def _admission_units_count_each_gang_once(k):
    pods = (singles(k, "u", 4) + [member(k, "ga", i, 3) for i in range(3)]
            + [member(k, "gb", i, 2) for i in range(2)])
    units = k.gang.admission_units(pods)
    assert units == 4 + 1 + 1
    members = k.gang.gang_members(pods)
    return units, {g: [p.name for p in ms] for g, ms in members.items()}, \
        [k.gang.declared_size(ms) for ms in members.values()]


VALIDATION = {
    "disagreeing_sizes_refused": _disagreeing_sizes_refused,
    "oversubscribed_roster_refused": _oversubscribed_roster_refused,
    "nonpositive_size_refused": _nonpositive_size_refused,
    "admission_units_count_each_gang_once":
        _admission_units_count_each_gang_once,
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_matches_reference(case):
    run_both(VALIDATION[case])


# ---------------------------------------------------------------------------
# metrics (TestMetricsZeroInit)
# ---------------------------------------------------------------------------


def _outcome_series_born_at_zero(k):
    reg = k.metrics.Registry()
    scheduler(k, "auto", reg)
    c = reg.counter(k.metrics.GANG_GANGS)
    for outcome in k.metrics.GANG_OUTCOMES:
        assert c.has({"outcome": outcome})
        assert c.get({"outcome": outcome}) == 0.0
    return sorted(reg.histograms), gang_metrics(k, reg)


def _reconstruction_does_not_clobber(k):
    reg = k.metrics.Registry()
    sched = scheduler(k, "oracle", reg)
    sched.solve([member(k, "gc", i, 9) for i in range(2)],
                [default_prov(k)], small_catalog(k))
    before = reg.counter(k.metrics.GANG_GANGS).get({"outcome": "retracted"})
    assert before >= 1.0
    scheduler(k, "oracle", reg)
    assert reg.counter(k.metrics.GANG_GANGS).get(
        {"outcome": "retracted"}) == before
    return gang_metrics(k, reg)


def _retraction_observes_duration(k):
    reg = k.metrics.Registry()
    sched = scheduler(k, "oracle", reg)
    res = sched.solve([member(k, "gd", i, 9) for i in range(2)],
                      [default_prov(k)], small_catalog(k))
    assert sum(reg.histogram(k.metrics.GANG_DURATION).totals.values()) >= 1
    return observe(res), gang_metrics(k, reg)


METRICS = {
    "outcome_series_born_at_zero": _outcome_series_born_at_zero,
    "reconstruction_does_not_clobber": _reconstruction_does_not_clobber,
    "retraction_observes_duration": _retraction_observes_duration,
}


@pytest.mark.parametrize("case", sorted(METRICS))
def test_metrics_match_reference(case):
    run_both(METRICS[case])


# ---------------------------------------------------------------------------
# the hierarchy partition never splits a gang (TestHierarchyNeverSplit)
# ---------------------------------------------------------------------------


def _gang_components(k, pods):
    st = k.tensorize.tensorize(pods, [default_prov(k)], small_catalog(k))
    g_gang = np.asarray(st.g_gang)
    tagged = [gi for gi in range(len(st.groups)) if g_gang[gi] >= 0]
    comps = k.hierarchy.coupling_components(st)
    owner = {gi: ci for ci, comp in enumerate(comps) for gi in comp}
    return tagged, {owner[gi] for gi in tagged}, [list(c) for c in comps]


def _gang_members_share_one_coupling_component(k, monkeypatch):
    monkeypatch.delenv("KT_GANG", raising=False)
    a = [member(k, "gh", i, 6, cpu=0.5, labels={"app": "gh-a"})
         for i in range(3)]
    b = [member(k, "gh", i + 3, 6, cpu=1.5, labels={"app": "gh-b"})
         for i in range(3)]
    tagged, owners, comps = _gang_components(k, a + b + singles(k, "hs", 4))
    assert len(tagged) >= 2, "expected the gang to span >=2 groups"
    assert len(owners) == 1, "gang groups split across coupling components"
    return tagged, comps


def _kill_switch_drops_the_coupling(k, monkeypatch):
    monkeypatch.setenv("KT_GANG", "0")
    a = [member(k, "gh", i, 6, cpu=0.5, labels={"app": "gh-a"})
         for i in range(3)]
    b = [member(k, "gh", i + 3, 6, cpu=1.5, labels={"app": "gh-b"})
         for i in range(3)]
    tagged, owners, comps = _gang_components(k, a + b)
    monkeypatch.delenv("KT_GANG")
    assert len(owners) == 2
    return tagged, comps


HIERARCHY = {
    "gang_members_share_one_coupling_component":
        _gang_members_share_one_coupling_component,
    "kill_switch_drops_the_coupling": _kill_switch_drops_the_coupling,
}


@pytest.mark.parametrize("case", sorted(HIERARCHY))
def test_hierarchy_partition_matches_reference(case, monkeypatch):
    run_both(HIERARCHY[case], monkeypatch)


# ---------------------------------------------------------------------------
# consolidation what-ifs re-seat a whole gang (TestConsolidationWholeGang)
# ---------------------------------------------------------------------------


def _cluster(k):
    nodes = [existing_node(k, f"cw{i}", "m5.xlarge", 4.0, 14.8, 0.192)
             for i in range(3)]
    for i in range(3):
        nodes[0].pods.append(member(k, "gc", i, 3))
    for i in (1, 2):
        for j in range(2):
            nodes[i].pods.append(k.pod.PodSpec(
                name=f"cw{i}-p{j}", labels={"app": "cs"},
                requests={"cpu": 0.5, "memory": 0.5 * GIB},
                owner_key="cs"))
    return nodes


def _sweep(k, candidates, registry=None):
    return k.consolidation.sweep_what_ifs(
        scheduler(k, "oracle", registry), _cluster(k), candidates,
        provisioners=[default_prov(k)], instance_types=small_catalog(k),
        registry=registry)


def _gang_what_if_reseats_whole_or_fails(k):
    out = _sweep(k, [[0], [1]], k.metrics.Registry())
    gang_res = out.results[0]
    assert not isinstance(gang_res, Exception)
    names = {f"gc-m{i}" for i in range(3)}
    seated = names & set(gang_res.assignments)
    assert seated in (names, set())
    if not seated:
        assert all(str(gang_res.infeasible[n]).startswith("GangUnplaced")
                   for n in names)
    return [observe(r) for r in out.results]


def _parity_with_direct_solve(k):
    out = _sweep(k, [[0]])
    direct = scheduler(k, "oracle").solve(
        [dataclasses.replace(p) for p in _cluster(k)[0].pods],
        [default_prov(k)], small_catalog(k),
        existing_nodes=[n for n in _cluster(k) if n.name != "cw0"],
        allow_new_nodes=True, max_new_nodes=1)
    assert set(out.results[0].assignments) == set(direct.assignments)
    return observe(out.results[0]), sorted(direct.assignments)


CONSOLIDATION = {
    "gang_what_if_reseats_whole_or_fails":
        _gang_what_if_reseats_whole_or_fails,
    "parity_with_direct_solve": _parity_with_direct_solve,
}


@pytest.mark.parametrize("case", sorted(CONSOLIDATION))
def test_consolidation_matches_reference(case):
    run_both(CONSOLIDATION[case])


# ---------------------------------------------------------------------------
# delta chains (TestDeltaOverWire, in process): atomic add, whole
# retraction on a member removal, and the two gang hooks of solve_delta
# ---------------------------------------------------------------------------


def _delta_env(k, base):
    sched = scheduler(k, "oracle", k.metrics.Registry())
    provs, cat = [default_prov(k)], small_catalog(k)
    prev = sched.solve(base, provs, cat)

    def delta(prev, **kw):
        return sched.solve_delta(prev, provisioners=provs,
                                 instance_types=cat, **kw)

    return prev, delta


def _delta_obs(out) -> dict:
    return dict(mode=out.mode, displaced=out.displaced, removed=out.removed,
                **observe(out.result))


def _gang_add_places_atomically(k):
    prev, delta = _delta_env(k, singles(k, "b", 12))
    add = [member(k, "gw", i, 3) for i in range(3)]
    out = delta(prev, added=add)
    assert all(p.name in out.result.assignments for p in add)
    return _delta_obs(out)


def _doomed_gang_add_retracts_whole(k):
    base = singles(k, "b", 12)
    prev, delta = _delta_env(k, base)
    add = [member(k, "gd", i, 4) for i in range(4)]
    add[1] = dataclasses.replace(
        add[1], node_selector={k.L.ZONE: "zone-none"})
    out = delta(prev, added=add)
    res = out.result
    assert not any(p.name in res.assignments for p in add)
    for p in add:
        assert str(res.infeasible[p.name]).startswith("GangUnplaced")
    assert all(p.name in res.assignments for p in base)
    return _delta_obs(out)


def _member_removal_retracts_every_comember(k):
    g = [member(k, "gr", i, 3) for i in range(3)]
    prev, delta = _delta_env(k, singles(k, "b", 10) + g)
    out = delta(prev, removed=["gr-m0"])
    res = out.result
    assert not any(p.name in res.assignments for p in g)
    for name in ("gr-m1", "gr-m2"):
        assert str(res.infeasible[name]).startswith("GangUnplaced")
    assert all(f"b-{i}" in res.assignments for i in range(10))
    return _delta_obs(out)


def _malformed_gang_refused(k):
    """The service door's check (validate_batch) refuses a raw request
    whose members disagree on the size — before any solve."""
    return _refusal(k, [member(k, "gb", 0, 4), dataclasses.replace(
        member(k, "gb", 1, 4), gang_size=6)])


def _gang_hooks_on_a_delta_chain(k):
    """``expand_gang_removals`` and ``delta_needs_full`` on one chain: a
    removal expands to the seated comembers with the typed reason, a
    doomed gang add asks for the full solve, a seated one does not."""
    g = [member(k, "ge", i, 3) for i in range(3)]
    prev, delta = _delta_env(k, singles(k, "b", 8) + g)
    expanded, reasons = k.gang.expand_gang_removals(prev, ["ge-m1", "b-0"])
    untouched = k.gang.expand_gang_removals(prev, ["b-1"])
    ok_add = [member(k, "gf", i, 2) for i in range(2)]
    out = delta(prev, added=ok_add)
    needs_ok = k.gang.delta_needs_full(out.result, ok_add)
    bad_add = [member(k, "gq", i, 2) for i in range(2)]
    bad_add[0] = dataclasses.replace(
        bad_add[0], node_selector={k.L.ZONE: "zone-none"})
    needs_bad = k.gang.delta_needs_full(
        delta(out.result, added=bad_add).result, bad_add)
    assert sorted(expanded) == ["b-0", "ge-m0", "ge-m1", "ge-m2"]
    assert set(reasons) == {"ge-m0", "ge-m2"}
    assert all(k.gang.is_gang_reason(r) for r in reasons.values())
    assert untouched == (["b-1"], {})
    assert not needs_ok and needs_bad
    return expanded, reasons, _delta_obs(out)


DELTA = {
    "gang_add_places_atomically": _gang_add_places_atomically,
    "doomed_gang_add_retracts_whole": _doomed_gang_add_retracts_whole,
    "member_removal_retracts_every_comember":
        _member_removal_retracts_every_comember,
    "malformed_gang_refused": _malformed_gang_refused,
    "gang_hooks_on_a_delta_chain": _gang_hooks_on_a_delta_chain,
}


@pytest.mark.parametrize("case", sorted(DELTA))
def test_delta_matches_reference(case):
    run_both(DELTA[case])


# ---------------------------------------------------------------------------
# what the wire relies on (TestWireCompat)
# ---------------------------------------------------------------------------


def _ungrouped_pod_validates_clean(k):
    p = k.pod.PodSpec(name="old", requests={"cpu": 0.5})
    assert p.gang_id == "" and p.gang_size == 0
    k.gang.validate_batch([p])
    return k.gang.gang_of(p), k.gang.has_gangs([p]), \
        k.gang.admission_units([p])


def _gang_fields_survive_copies(k):
    p = member(k, "grt", 0, 7)
    copies = [copy.copy(p), dataclasses.replace(p), copy.deepcopy(p)]
    return [(q.gang_id, q.gang_size, k.gang.gang_of(q),
             k.gang.gang_fixed(q)) for q in copies]


WIRE = {
    "ungrouped_pod_validates_clean": _ungrouped_pod_validates_clean,
    "gang_fields_survive_copies": _gang_fields_survive_copies,
}


@pytest.mark.parametrize("case", sorted(WIRE))
def test_wire_fields_match_reference(case):
    run_both(WIRE[case])


# ---------------------------------------------------------------------------
# a gang-bearing hierarchical batch with a binding limit
# ---------------------------------------------------------------------------


def _gang_hier_limited(k, monkeypatch):
    """8 zone-spread deployments of 60 pods plus 4 gangs (one doomed by a
    pinned member, one short roster) over the threshold, under a
    provisioner cpu limit of 90% of the unconstrained buy."""
    monkeypatch.setenv("KT_HIER_THRESHOLD", "400")
    monkeypatch.setenv("KT_RELAX", "0")
    L = k.L
    pods = []
    for d in range(8):
        sel = k.pod.LabelSelector.of({"app": f"web{d}"})
        for i in range(60):
            pods.append(k.pod.PodSpec(
                name=f"web{d}-{i}", labels={"app": f"web{d}"},
                requests={"cpu": 0.25 * (1 + d % 4),
                          "memory": (0.5 + d % 3) * GIB},
                topology_spread=[k.pod.TopologySpreadConstraint(
                    1, L.ZONE, "DoNotSchedule", sel)],
                owner_key=f"web{d}"))
    for g in range(2):
        pods += [member(k, f"train{g}", i, 8, cpu=1.0) for i in range(8)]
    doomed = [member(k, "doomed", i, 8, cpu=1.0) for i in range(8)]
    doomed[3] = dataclasses.replace(
        doomed[3], node_selector={L.ZONE: "zone-none"})
    pods += doomed + [member(k, "short", i, 8, cpu=1.0) for i in range(6)]
    cat = k.catalog.generate_catalog(full=True)
    free = scheduler(k, "tpu").solve(pods, [default_prov(k)], cat)
    buy = sum(n.allocatable.get(L.RESOURCE_CPU, 0.0) for n in free.nodes)
    limited = k.provisioner.Provisioner(
        name="default", limits={L.RESOURCE_CPU: 0.9 * buy}).with_defaults()
    reg = k.metrics.Registry()
    res = scheduler(k, "tpu", reg).solve(pods, [limited], cat)
    assert reg.counter(k.metrics.HIER_SOLVES).get(
        {"path": "hierarchical"}) == 1.0
    used = sum(n.allocatable.get(L.RESOURCE_CPU, 0.0) for n in res.nodes)
    assert used <= 0.9 * buy + 1e-6
    for gid in ("train0", "train1", "doomed", "short"):
        ms = [p for p in pods if p.gang_id == gid]
        if gang_outcome(res, ms) == "retracted":
            assert all(k.gang.is_gang_reason(res.infeasible[p.name])
                       for p in ms)
    assert gang_outcome(res, doomed) == "retracted"
    assert all(p.name in res.assignments or p.name in res.infeasible
               for p in pods)
    monkeypatch.delenv("KT_HIER_THRESHOLD")
    monkeypatch.delenv("KT_RELAX")
    return round(buy, 6), observe(res), gang_metrics(k, reg)


def test_gang_hierarchical_batch_with_binding_limit_matches_reference(
        monkeypatch):
    run_both(_gang_hier_limited, monkeypatch)
