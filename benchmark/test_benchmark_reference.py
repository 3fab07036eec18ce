"""The yardstick on the host: the catalog's records, the pending sets from
a seed, the reference planner, the plan check and the control.

    python -m pytest benchmark -q
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

from benchmark import catalog, control, harness, reference, roofline, workload


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def _small(c: dict, deployments: int = 4, replicas: int = 30) -> dict:
    c = copy.deepcopy(c)
    p = c["config"]["pending"]
    p["deployments"], p["replicas"] = deployments, replicas
    p["cpu"], p["memory_gib"] = p["cpu"][:deployments], \
        p["memory_gib"][:deployments]
    return c


@pytest.fixture(scope="module")
def cand(man):
    cfg = harness.cell(man, "zonespread-50k.burst")["config"]
    return reference.Candidates(catalog.generate(full=True),
                                cfg["provisioner"], catalog.ZONES)


def test_catalog_records_match_the_generated_catalog():
    """The frozen records are the catalog the deployments name: every
    type's capacity, allocatable and offerings as the program's own
    generator gives them."""
    from karpenter_tpu_torch.models.catalog import generate_catalog

    for full in (True, False):
        ours = {r["name"]: r for r in catalog.generate(full=full)}
        theirs = {it.name: it for it in generate_catalog(full=full)}
        assert ours.keys() == theirs.keys()
        for name, it in theirs.items():
            r = ours[name]
            assert r["capacity"] == pytest.approx(it.capacity, rel=1e-12)
            assert r["allocatable"] == pytest.approx(it.allocatable,
                                                     rel=1e-12)
            assert r["offerings"] == [(o.zone, o.capacity_type, o.price)
                                      for o in it.offerings]


@pytest.mark.parametrize("name", ["zonespread-50k.burst"])
def test_pending_sets_are_deterministic_from_the_seed(man, name):
    c = harness.cell(man, name)
    seed = 2 ** 33 + 5
    a = workload.pending_sets(c["config"], c["traffic"], seed)
    b = workload.pending_sets(c["config"], c["traffic"], seed)
    other = workload.pending_sets(c["config"], c["traffic"], seed + 1)
    assert a == b
    assert a != other
    assert len(a) == c["traffic"]["sets"]

    def work(sets):
        return sorted(sorted((d["cpu"], d["memory"], d["replicas"])
                             for d in s["deployments"]) for s in sets)
    # another seed: the same work in another order
    assert work(a) == work(other)
    spec = c["config"]["pending"]
    assert all(sum(d["replicas"] for d in s["deployments"])
               == spec["deployments"] * spec["replicas"] for s in a)


def _sets(man, name="zonespread-50k.burst", seed=7, **kw):
    c = _small(harness.cell(man, name), **kw)
    return c, workload.pending_sets(c["config"], c["traffic"], seed)


def test_reference_plans_pass_the_check(man, cand):
    _c, sets = _sets(man)
    for pending in sets:
        cost, nodes = reference.ffd(pending, cand)
        plan = control.plain(pending, nodes, cand)
        assert reference.check(pending, plan, cand) == dict.fromkeys(
            reference.FAULT_KINDS, 0)
        assert cost == pytest.approx(reference.plan_cost(plan, cand))
        assert cost > 0


def test_reference_is_first_fit_decreasing(man, cand):
    """A single deployment that a large type holds whole: one node per
    zone, each the cheapest type that holds its third."""
    pending = {"deployments": [{"name": "a", "cpu": 1.0, "memory": 2 ** 30,
                                "replicas": 9, "max_skew": 1}]}
    cost, nodes = reference.ffd(pending, cand)
    assert len(nodes) == 3
    assert sorted(z for _t, z, _l in nodes) == list(catalog.ZONES)
    assert all(loads == [(0, 3)] for _t, _z, loads in nodes)
    held = np.array([3.0, 3 * 2.0 ** 30, 3])
    fits = np.all(cand.alloc * (1 + reference.CAPACITY_RTOL) >= held, 1)
    assert cost == pytest.approx(3 * cand.price[fits, 0].min())


@pytest.fixture
def good(man, cand):
    _c, sets = _sets(man)
    pending = sets[0]
    _cost, nodes = reference.ffd(pending, cand)
    return pending, control.plain(pending, nodes, cand)


def _faults(pending, plan, cand):
    return {k: v for k, v in reference.check(pending, plan, cand).items()
            if v}


def test_check_rejects_a_pod_left_out(good, cand):
    pending, plan = good
    node = plan["nodes"][0]
    dropped = node[4][0]
    plan["nodes"][0] = node[:4] + (node[4][1:],)
    del plan["assigned"][dropped]
    assert _faults(pending, plan, cand) == {"unseated": 1}


def test_check_rejects_an_overcommitted_node(good, cand):
    pending, plan = good
    itype, zone, ct, _p, pods = plan["nodes"][0]
    plan["nodes"][0] = ("c5.large", zone, ct,
                        cand.offer[("c5.large", zone, ct)], pods)
    assert "overcommit" in _faults(pending, plan, cand)


def test_check_rejects_a_broken_spread(good, cand):
    pending, plan = good
    # every node of the first zone moved to the second
    plan["nodes"] = [(t, catalog.ZONES[1] if z == catalog.ZONES[0] else z,
                      ct, p, pods) for t, z, ct, p, pods in plan["nodes"]]
    assert "skew" in _faults(pending, plan, cand)


def test_check_rejects_foreign_duplicate_and_mispriced(good, cand):
    pending, plan = good
    t, z, ct, p, pods = plan["nodes"][0]
    plan["nodes"][0] = (t, z, ct, p * 0.5, pods + [-1, pods[0]])
    got = _faults(pending, plan, cand)
    assert got["foreign"] == 1 and got["duplicate"] == 1
    assert got["price"] == 1


def test_check_rejects_a_type_the_provisioner_forbids(good, cand):
    pending, plan = good
    t, z, ct, p, pods = plan["nodes"][0]
    plan["nodes"][0] = ("m6g.16xlarge", z, ct, p, pods)  # arm64
    assert _faults(pending, plan, cand) == {"disallowed_type": 1}
    plan["nodes"][0] = (t, z, "spot", p, pods)
    assert _faults(pending, plan, cand) == {"bad_offering": 1}


@pytest.mark.parametrize("name", ["zonespread-50k.burst"])
def test_the_control_fails_the_check(man, name):
    """The reference without the zone spread reads thousands of skew
    faults where the reference reads none: the comparison can fail."""
    c = _small(harness.cell(man, name), deployments=6, replicas=40)
    c["traffic"] = dict(c["traffic"], sets=3)
    got = control.readings(c, 2 ** 31 + 11)
    assert got["reference"] == 0
    assert got["control"] >= 3 * 6 * 25
    assert set(got["kinds"]) == {"skew"}


def test_roofline_counts_the_loop_once(man):
    _c, sets = _sets(man)
    nbytes, ops = roofline.loop_work(sets[0], 300, 3, 50)
    G, R = 4, 3
    assert nbytes == 4 * (G * R + G + 300 * R + 300 + G * 3 + 50 * (R + 2)
                          + G * 50)
    assert ops == G * 300 * R + 120 * R
    t, bound = roofline.least_seconds(nbytes, ops, "NVIDIA H100 80GB HBM3")
    assert bound == "bytes" and t == pytest.approx(nbytes / 3.35e12)
