"""The port's hierarchical solve — the slice as a whole — against the
reference package, on the CPU.

One plain description of a batch of zone-spread deployments is built with
each package's models.  Three runs, each compared across packages:

- the selector-disjoint run (``deployments(4, 12)``): block waves with no
  binding limit, which must also match the port's own flat solve;
- the contended-limit run: a provisioner ``limits.cpu`` at 99% of the
  unconstrained buy, which drives at least one price iteration through the
  packed-score function and then the exact limit repair;
- ``BatchScheduler.solve`` with ``KT_HIER_THRESHOLD`` at the batch size,
  which must route hierarchically in both packages.

Tolerance: equal node plans, or ``placements_tie`` (same pods seated, same
infeasible set, f32 total cost bitwise equal) — what the reference's own
hierarchical tests accept between its compiled graphs.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.metrics import HIER_SOLVES as REF_HIER_SOLVES
from karpenter_tpu.models import catalog as ref_catalog
from karpenter_tpu.models import pod as ref_pod
from karpenter_tpu.models import provisioner as ref_prov
from karpenter_tpu.models.tensorize import tensorize as ref_tensorize
from karpenter_tpu.solver import hierarchy as ref_hier
from karpenter_tpu.solver.scheduler import BatchScheduler as RefScheduler
from karpenter_tpu_torch.metrics import HIER_SOLVES
from karpenter_tpu_torch.models import catalog as t_catalog
from karpenter_tpu_torch.models import pod as t_pod
from karpenter_tpu_torch.models import provisioner as t_prov
from karpenter_tpu_torch.models.tensorize import tensorize as t_tensorize
from karpenter_tpu_torch.solver import hierarchy as hier
from karpenter_tpu_torch.solver.scheduler import BatchScheduler

torch.set_num_threads(1)

GIB = 1024.0 ** 3
ZONE = "topology.kubernetes.io/zone"


def deployment_descs(nd, per, tag="hd"):
    """``nd`` deployments x ``per`` pods, each zone-spread against its own
    app selector (the reference test's ``deployments`` helper)."""
    return [
        dict(name=f"{tag}{d}-{i}", app=f"{tag}{d}",
             requests={"cpu": 0.25 * (1 + d % 4),
                       "memory": (0.5 + (d % 3)) * GIB})
        for d in range(nd) for i in range(per)
    ]


def build_pods(pod_mod, descs):
    return [
        pod_mod.PodSpec(
            name=d["name"], labels={"app": d["app"]},
            requests=dict(d["requests"]), owner_key=d["app"],
            topology_spread=[pod_mod.TopologySpreadConstraint(
                1, ZONE, "DoNotSchedule",
                pod_mod.LabelSelector.of({"app": d["app"]}))])
        for d in descs
    ]


def provisioner(prov_mod, cpu_limit=None):
    p = prov_mod.Provisioner(name="default").with_defaults()
    if cpu_limit is not None:
        p.limits = {"cpu": cpu_limit}
    return p


def plan(result):
    return sorted(
        (n.instance_type, n.zone, n.capacity_type, round(n.price, 6),
         tuple(sorted(p.name for p in n.pods)))
        for n in result.nodes)


def placements_tie(a, b):
    return (set(a.assignments) == set(b.assignments)
            and set(a.infeasible) == set(b.infeasible)
            and np.float32(sum(n.price for n in a.nodes)).tobytes()
            == np.float32(sum(n.price for n in b.nodes)).tobytes())


def assert_same(a, b):
    assert set(a.assignments) == set(b.assignments)
    assert set(a.infeasible) == set(b.infeasible)
    assert plan(a) == plan(b) or placements_tie(a, b)


def cpu_bought(st, nodes):
    return sum(float(st.capacity_row(n.instance_type, n.allocatable)[0])
               for n in nodes)


@pytest.fixture(scope="module")
def env():
    descs = deployment_descs(4, 12, tag="he")
    return dict(
        descs=descs,
        ref_cat=ref_catalog.generate_catalog(full=False),
        cat=t_catalog.generate_catalog(full=False),
        ref_pods=build_pods(ref_pod, descs),
        pods=build_pods(t_pod, descs),
        ref_sched=RefScheduler(backend="tpu", compile_behind=False),
        sched=BatchScheduler(backend="tpu", device="cpu"),
    )


@pytest.fixture(scope="module")
def disjoint(env):
    ref_stats, stats = {}, {}
    ref_res = ref_hier.solve_hierarchical(
        env["ref_sched"], env["ref_pods"], [provisioner(ref_prov)],
        env["ref_cat"], stats=ref_stats)
    res = hier.solve_hierarchical(
        env["sched"], env["pods"], [provisioner(t_prov)], env["cat"],
        stats=stats)
    flat = env["sched"].solve(env["pods"], [provisioner(t_prov)], env["cat"])
    return ref_res, ref_stats, res, stats, flat


@pytest.fixture(scope="module")
def contended(env, disjoint):
    ref_free, res_free = disjoint[0], disjoint[2]
    st_ref = ref_tensorize(env["ref_pods"], [provisioner(ref_prov)],
                           env["ref_cat"])
    st = t_tensorize(env["pods"], [provisioner(t_prov)], env["cat"])
    bought_ref = cpu_bought(st_ref, ref_free.nodes)
    bought = cpu_bought(st, res_free.nodes)
    limit = round(bought * 0.99, 1)
    calls = []
    real = hier.price_step_scores

    def counting(*args, **kw):
        calls.append(tuple(tuple(t.shape) for t in args))
        return real(*args, **kw)

    ref_stats, stats = {}, {}
    ref_res = ref_hier.solve_hierarchical(
        env["ref_sched"], env["ref_pods"], [provisioner(ref_prov, limit)],
        env["ref_cat"], stats=ref_stats)
    hier.price_step_scores = counting
    try:
        res = hier.solve_hierarchical(
            env["sched"], env["pods"], [provisioner(t_prov, limit)],
            env["cat"], stats=stats)
    finally:
        hier.price_step_scores = real
    return dict(limit=limit, bought=bought, bought_ref=bought_ref, st=st,
                ref_res=ref_res, ref_stats=ref_stats, res=res, stats=stats,
                calls=calls)


def test_components_and_blocks_match_reference(env):
    prov_r, prov_t = [provisioner(ref_prov)], [provisioner(t_prov)]
    st_ref = ref_tensorize(env["ref_pods"], prov_r, env["ref_cat"])
    st = t_tensorize(env["pods"], prov_t, env["cat"])
    comps = hier.coupling_components(st)
    assert comps == ref_hier.coupling_components(st_ref)
    assert len(comps) == 4
    for max_blocks in (2, 3, 32):
        masks = hier.partition_blocks(st, comps, max_blocks)
        ref_masks = ref_hier.partition_blocks(st_ref, comps, max_blocks)
        assert [m.tolist() for m in masks] == [m.tolist() for m in ref_masks]
        assert hier.block_budgets(st, masks) == ref_hier.block_budgets(
            st_ref, ref_masks)


def test_price_adjusted_matches_reference(env):
    st = t_tensorize(env["pods"], [provisioner(t_prov)], env["cat"])
    lam = np.array([0.37])
    got = hier.price_adjusted(st.cand_price, st.cand_prov, lam)
    want = ref_hier.price_adjusted(st.cand_price, st.cand_prov, lam)
    assert got.tobytes() == want.tobytes()


def test_disjoint_run_matches_reference(disjoint):
    ref_res, ref_stats, res, stats, _flat = disjoint
    assert res is not None and ref_res is not None
    assert_same(ref_res, res)
    for k in ("blocks", "components", "waves", "price_iters", "dispatches",
              "repair_pods", "tail_repack_pods"):
        assert stats[k] == ref_stats[k], k


def test_disjoint_run_matches_flat(disjoint):
    _, _, res, stats, flat = disjoint
    assert stats["price_iters"] == 0 and stats["waves"] == 1
    assert stats["dispatches"] == stats["waves"]
    assert_same(flat, res)


def test_contended_limit_takes_price_iterations(contended):
    stats, ref_stats = contended["stats"], contended["ref_stats"]
    assert contended["bought"] == contended["bought_ref"]
    assert stats["price_iters"] >= 1
    assert stats["price_iters"] == ref_stats["price_iters"]
    assert stats["dispatches"] == stats["waves"] == ref_stats["waves"]
    # every price iteration scored the groups through the fused packed step
    assert len(contended["calls"]) == stats["price_iters"]
    st = contended["st"]
    D, P = st.cand_price.shape[1], len(st.prov_names)
    assert all(c == ((st.G, st.C), (st.C, D), (st.C,), (P,))
               for c in contended["calls"])


def test_contended_limit_matches_reference(contended):
    assert_same(contended["ref_res"], contended["res"])
    assert contended["stats"]["repair_pods"] == \
        contended["ref_stats"]["repair_pods"]


def test_contended_limit_is_enforced_exactly(env, contended):
    res, st = contended["res"], contended["st"]
    assert cpu_bought(st, res.nodes) <= contended["limit"] * (1.0 + 1e-6)
    assert (set(res.assignments) | set(res.infeasible)
            == {p.name for p in env["pods"]})


def test_threshold_routes_both_schedulers(env, monkeypatch):
    monkeypatch.setenv("KT_HIER_THRESHOLD", str(len(env["pods"])))
    ref_before = env["ref_sched"].registry.counter(REF_HIER_SOLVES).get(
        {"path": "hierarchical"})
    before = env["sched"].registry.counter(HIER_SOLVES).get(
        {"path": "hierarchical"})
    ref_res = env["ref_sched"].solve(env["ref_pods"], [provisioner(ref_prov)],
                                     env["ref_cat"], relax=False)
    res = env["sched"].solve(env["pods"], [provisioner(t_prov)], env["cat"])
    assert env["ref_sched"].registry.counter(REF_HIER_SOLVES).get(
        {"path": "hierarchical"}) == ref_before + 1.0
    assert env["sched"].registry.counter(HIER_SOLVES).get(
        {"path": "hierarchical"}) == before + 1.0
    assert_same(ref_res, res)
    # below the threshold: flat, no new hierarchical sample
    monkeypatch.setenv("KT_HIER_THRESHOLD", str(len(env["pods"]) + 1))
    env["sched"].solve(env["pods"], [provisioner(t_prov)], env["cat"])
    assert env["sched"].registry.counter(HIER_SOLVES).get(
        {"path": "hierarchical"}) == before + 1.0


def test_single_component_falls_back_to_flat(env):
    from karpenter_tpu_torch.metrics import Registry

    pods = [
        t_pod.PodSpec(
            name=f"hc{i}", labels={"tier": "web"}, requests={"cpu": 0.5},
            owner_key=f"hc{i % 3}",
            topology_spread=[t_pod.TopologySpreadConstraint(
                1, ZONE, "DoNotSchedule",
                t_pod.LabelSelector.of({"tier": "web"}))])
        for i in range(18)
    ]
    reg = Registry()
    out = hier.solve_hierarchical(env["sched"], pods, [provisioner(t_prov)],
                                  env["cat"], registry=reg)
    assert out is None
    assert reg.counter(HIER_SOLVES).get({"path": "fallback_structure"}) == 1.0


def test_threshold_knob_parses_and_defends(monkeypatch):
    monkeypatch.setenv("KT_HIER_THRESHOLD", "250000")
    assert hier.hier_threshold() == 250_000
    monkeypatch.setenv("KT_HIER_THRESHOLD", "not-a-number")
    assert hier.hier_threshold() == hier.DEFAULT_HIER_THRESHOLD
    monkeypatch.setenv("KT_HIER_PRICE_ITERS", "-3")
    assert hier.hier_price_iters() == 0


def test_block_extract_reports_its_member_pods_only(env):
    """A block wave's extract reports its member groups' pods alone: the
    plan of the extract that reads every group, without the other
    blocks' pods that one marks infeasible."""
    st = t_tensorize(env["pods"], [provisioner(t_prov)], env["cat"])
    masks = hier.partition_blocks(st, hier.coupling_components(st), 2)
    budgets = hier.block_budgets(st, masks)
    solver = env["sched"]._tpu
    entries, _ = hier.build_block_entries(
        solver, st, masks, budgets, hier.hier_dims(st, max(budgets)))
    outs = solver.solve_many_prepared(entries)
    for e in entries:
        e["r"].pop("groups")
    every = solver.solve_many_prepared(entries)
    for mask, out, all_groups in zip(masks, outs, every):
        mine, full = out.result, all_groups.result
        members = {p.name for gi in np.nonzero(mask)[0]
                   for p in st.groups[gi].pods}
        assert set(mine.assignments) | set(mine.infeasible) == members
        assert plan(mine) == plan(full)
        assert set(mine.assignments) == set(full.assignments)
        assert mine.infeasible == {n: why for n, why in full.infeasible.items()
                                   if n in members}
        assert set(full.infeasible) - members
