"""Warm-start delta solving and the warm API of the port against the reference
package, on the CPU.

Every scenario of ``tests/test_warmstart.py`` is ONE function over a
package namespace ``k`` (the same module aliases for ``karpenter_tpu`` and
``karpenter_tpu_torch``), run once per package from reset node-name
counters: ``TpuSolver.solve_delta`` scenarios on the reference's
``TpuSolver()`` (compiling inline) and the port's ``TpuSolver(device=
"cpu")``, ``BatchScheduler.solve_delta`` scenarios on the backend the
reference test uses (and, for the scenarios whose displaced subproblem
takes the scan tier, on the device backend too).  The reference test's own
assertions run on both packages; then the two runs must agree exactly:
every step's mode, displaced / removed / total counts, created and pruned
node names, node plans, assignments (node names included) and infeasible
reasons, and the warm-start metric counts.

Also here: the warm-API contract cases of ``tests/test_coldstart.py`` that
do not involve the native tier's cold-start serve (the port serves every
shape on the device), and a gang pod in ``added`` and in ``submit`` solved
as the reference solves it.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import karpenter_tpu.metrics as ref_metrics
import karpenter_tpu.models.catalog as ref_catalog
import karpenter_tpu.models.labels as ref_labels
import karpenter_tpu.models.pod as ref_pod
import karpenter_tpu.models.provisioner as ref_prov
import karpenter_tpu.models.tensorize as ref_tensorize
import karpenter_tpu.solver.scheduler as ref_scheduler
import karpenter_tpu.solver.tpu as ref_tpu
import karpenter_tpu.solver.types as ref_types
import karpenter_tpu.solver.warmstart as ref_warmstart
import karpenter_tpu_torch.metrics as t_metrics
import karpenter_tpu_torch.models.catalog as t_catalog
import karpenter_tpu_torch.models.labels as t_labels
import karpenter_tpu_torch.models.pod as t_pod
import karpenter_tpu_torch.models.provisioner as t_prov
import karpenter_tpu_torch.models.tensorize as t_tensorize
import karpenter_tpu_torch.solver.scheduler as t_scheduler
import karpenter_tpu_torch.solver.tpu as t_tpu
import karpenter_tpu_torch.solver.types as t_types
import karpenter_tpu_torch.solver.warmstart as t_warmstart
from karpenter_tpu_torch.utils.clock import FakeClock

torch.set_num_threads(1)

GIB = 2.0 ** 30

REF = types.SimpleNamespace(
    name="ref", pod=ref_pod, prov=ref_prov, L=ref_labels, types=ref_types,
    tensorize=ref_tensorize, tpu=ref_tpu, scheduler=ref_scheduler,
    metrics=ref_metrics, catalog=ref_catalog, warmstart=ref_warmstart)
PORT = types.SimpleNamespace(
    name="port", pod=t_pod, prov=t_prov, L=t_labels, types=t_types,
    tensorize=t_tensorize, tpu=t_tpu, scheduler=t_scheduler,
    metrics=t_metrics, catalog=t_catalog, warmstart=t_warmstart)


def reset_names(k) -> None:
    with k.types._node_lock:
        k.types._node_next = 0


@pytest.fixture(scope="module")
def catalogs():
    return {"ref": ref_catalog.generate_catalog(full=False),
            "port": t_catalog.generate_catalog(full=False)}


def mk_pods(k, n, tag="d", groups=4, cpu=0.5):
    out = []
    for i in range(n):
        g = i % groups
        out.append(k.pod.PodSpec(
            name=f"{tag}-{i}", labels={"app": f"{tag}{g}"},
            requests={"cpu": cpu * (1 + g % 2), "memory": 1.0 * GIB},
            owner_key=f"{tag}{g}",
        ))
    return out


def plan(result):
    return sorted(
        (n.instance_type, n.zone, n.capacity_type, round(n.price, 6),
         tuple(sorted(p.name for p in n.pods)))
        for n in result.nodes)


def observe(out) -> dict:
    """Everything a delta step decided, name-for-name."""
    r = out.result
    return dict(
        mode=out.mode, displaced=out.displaced, removed=out.removed,
        total_pods=out.total_pods, created=list(out.created_nodes),
        pruned=list(out.pruned_nodes), plan=plan(r),
        nodes=sorted(n.name for n in r.nodes),
        existing=[(n.name, sorted(p.name for p in n.pods))
                  for n in r.existing_nodes],
        assignments=dict(r.assignments), infeasible=dict(r.infeasible),
    )


def metric_counts(k, reg) -> dict:
    c = reg.counter(k.metrics.WARMSTART_SOLVES)
    h = reg.histogram(k.metrics.WARMSTART_DISPLACED)
    return dict(solves=dict(c.values), displaced_n=dict(h.totals),
                displaced_sum=dict(h.sums))


class Ctx:
    """One package's scenario context: its catalog, default provisioner,
    a metrics registry, and (``solved``) a 120-pod base solved on that
    package's ``TpuSolver`` through a ``TensorizeCache``."""

    def __init__(self, k, catalog, solved: bool) -> None:
        self.k = k
        self.catalog = catalog
        self.prov = k.prov.Provisioner(name="default").with_defaults()
        self.reg = k.metrics.Registry()
        if solved:
            self.solver = (k.tpu.TpuSolver() if k is REF
                           else k.tpu.TpuSolver(device="cpu"))
            self.cache = k.tensorize.TensorizeCache()
            self.pods = mk_pods(k, 120)
            st, _ = self.cache.tensorize(self.pods, [self.prov], catalog)
            self.prev = self.solver.solve(st).result
            assert not self.prev.infeasible

    def delta(self, prev=None, **kw):
        kw.setdefault("provisioners", [self.prov])
        kw.setdefault("instance_types", self.catalog)
        kw.setdefault("tensorize_cache", self.cache)
        kw.setdefault("registry", self.reg)
        kw.setdefault("max_delta_frac", 0.5)
        return self.solver.solve_delta(prev or self.prev, **kw)

    def scheduler(self, backend):
        if self.k is REF:
            return ref_scheduler.BatchScheduler(
                backend=backend, registry=self.reg, compile_behind=False)
        return t_scheduler.BatchScheduler(backend=backend, registry=self.reg,
                                          device="cpu")


def run_both(catalogs, scenario, solved=False, **kw):
    """Run ``scenario(k, ctx, **kw)`` for both packages from reset name
    counters and require the same observations and metric counts."""
    got = {}
    for k in (REF, PORT):
        reset_names(k)
        ctx = Ctx(k, catalogs[k.name], solved)
        obs = scenario(k, ctx, **kw)
        got[k.name] = (obs, metric_counts(k, ctx.reg))
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    return got["port"][0]


# ---------------------------------------------------------------------------
# TestTiers (TpuSolver.solve_delta)
# ---------------------------------------------------------------------------


def s_empty_delta_is_a_noop(k, c):
    before = dict(c.prev.assignments)
    out = c.delta()
    assert out.mode == "noop"
    assert out.displaced == 0 and out.removed == 0
    assert out.result.assignments == before
    assert out.solve_ms < 50  # pure bookkeeping, no device dispatch
    return [observe(out)]


def s_disjoint_add_keeps_untouched_assignments(k, c):
    before = dict(c.prev.assignments)
    add = mk_pods(k, 4, "x")
    out = c.delta(added=add)
    assert out.mode in ("host", "scan")
    for name, node in before.items():
        assert out.result.assignments[name] == node
    for p in add:
        assert p.name in out.result.assignments
    assert not out.result.infeasible
    return [observe(out)]


def s_removal_is_pure_bookkeeping(k, c):
    rm = [p.name for p in c.pods[:6]]
    out = c.delta(removed=rm)
    assert out.mode == "noop"
    for name in rm:
        assert name not in out.result.assignments
    assert out.total_pods == 120 - 6
    seated = {p.name for n in out.result.existing_nodes + out.result.nodes
              for p in n.pods}
    assert not seated & set(rm)
    return [observe(out)]


def s_removal_prunes_emptied_proposal_nodes(k, c):
    node = c.prev.nodes[0]
    out = c.delta(removed=[p.name for p in node.pods])
    assert node.name not in {n.name for n in out.result.nodes}
    return [observe(out)]


def s_threshold_exceeded_falls_back_to_full(k, c):
    out = c.delta(added=mk_pods(k, 80, "big"), max_delta_frac=0.05)
    assert out.mode == "full"
    assert out.fell_back
    assert not out.result.infeasible
    return [observe(out)]


def s_chain_carries_meta(k, c):
    o1 = c.delta(added=mk_pods(k, 3, "a"))
    o2 = c.delta(prev=o1.result, added=mk_pods(k, 3, "b"))
    assert o2.mode in ("host", "scan")
    assert o2.total_pods == 126
    obs = [observe(o1), observe(o2)]
    o3 = c.delta(prev=o2.result, added=mk_pods(k, 80, "c"),
                 max_delta_frac=0.05)
    assert getattr(o3.result, "_warmstart_meta", None) is None
    return obs + [observe(o3)]


# ---------------------------------------------------------------------------
# TestGuards (BatchScheduler.solve_delta)
# ---------------------------------------------------------------------------


def s_spread_matched_removal_falls_back(k, c, backend="oracle"):
    sel = k.pod.LabelSelector.of({"app": "s"})
    pods = [k.pod.PodSpec(
        name=f"s-{i}", labels={"app": "s"}, requests={"cpu": 0.5},
        topology_spread=[k.pod.TopologySpreadConstraint(
            1, k.L.ZONE, "DoNotSchedule", sel)],
        owner_key="s") for i in range(12)]
    sched = c.scheduler(backend)
    prev = sched.solve(pods, [c.prov], c.catalog)
    assert not prev.infeasible
    out = sched.solve_delta(prev, removed=["s-0"], provisioners=[c.prov],
                            instance_types=c.catalog, max_delta_frac=0.9)
    assert out.mode == "full"
    assert not out.result.infeasible
    return [observe(out)]


def s_foreign_selector_coupling_falls_back(k, c, backend="oracle"):
    sel = k.pod.LabelSelector.of({"team": "x"})
    spread = [k.pod.PodSpec(
        name=f"sp-{i}", labels={"team": "x", "role": "spread"},
        requests={"cpu": 0.25},
        topology_spread=[k.pod.TopologySpreadConstraint(
            1, k.L.ZONE, "DoNotSchedule", sel)],
        owner_key="sp") for i in range(6)]
    sched = c.scheduler(backend)
    prev = sched.solve(spread + mk_pods(k, 30, "p"), [c.prov], c.catalog)
    assert not prev.infeasible
    intruder = k.pod.PodSpec(name="intruder", labels={"team": "x"},
                             requests={"cpu": 0.25}, owner_key="other")
    out = sched.solve_delta(prev, added=[intruder], provisioners=[c.prov],
                            instance_types=c.catalog, max_delta_frac=0.9)
    assert out.mode == "full"
    assert "intruder" in out.result.assignments
    return [observe(out)]


def s_own_constraint_add_takes_scan_not_host(k, c, backend="oracle"):
    sched = c.scheduler(backend)
    prev = sched.solve(mk_pods(k, 40, "p"), [c.prov], c.catalog)
    sel = k.pod.LabelSelector.of({"app": "z"})
    zpod = k.pod.PodSpec(
        name="z-0", labels={"app": "z"}, requests={"cpu": 0.25},
        topology_spread=[k.pod.TopologySpreadConstraint(
            1, k.L.ZONE, "DoNotSchedule", sel)],
        owner_key="z")
    out = sched.solve_delta(prev, added=[zpod], provisioners=[c.prov],
                            instance_types=c.catalog, max_delta_frac=0.9)
    assert out.mode == "scan"
    assert "z-0" in out.result.assignments
    return [observe(out)]


# ---------------------------------------------------------------------------
# TestIced
# ---------------------------------------------------------------------------


def s_per_call_unavailable_accumulates(k, c):
    o1 = c.delta(added=mk_pods(k, 2, "a"))
    assert getattr(o1.result, "_warmstart_meta", None) is not None
    offering = ("m5.xlarge", "zone-1a", "spot")
    o2 = c.delta(prev=o1.result, added=mk_pods(k, 2, "b"),
                 unavailable={offering})
    assert offering in o2.result._warmstart_meta.unavailable
    return [observe(o1), observe(o2),
            sorted(o2.result._warmstart_meta.unavailable)]


def s_iced_offering_is_remembered(k, c):
    o1 = c.delta(iced=[("m5.large", "zone-1a", "on-demand")])
    assert o1.mode == "noop"
    meta = o1.result._warmstart_meta
    assert ("m5.large", "zone-1a", "on-demand") in meta.unavailable
    return [observe(o1), sorted(meta.unavailable)]


def s_reclaimed_node_displaces_its_pods(k, c):
    node = c.prev.nodes[0]
    seated = [p.name for p in node.pods]
    out = c.delta(iced=[node.name])
    assert out.mode in ("host", "scan", "full")
    assert node.name not in {n.name for n in out.result.nodes}
    for name in seated:
        assert out.result.assignments[name] != node.name
    return [observe(out)]


def s_unplaced_pods_reoffered_after_removal(k, c, backend="oracle"):
    prov = k.prov.Provisioner(name="default",
                              limits={"cpu": 2.0}).with_defaults()
    sched = c.scheduler(backend)
    pods = [k.pod.PodSpec(name=f"p-{i}", requests={"cpu": 0.6},
                          owner_key="p") for i in range(3)]
    prev = sched.solve(pods, [prov], c.catalog)
    assert not prev.infeasible
    big = k.pod.PodSpec(name="later", requests={"cpu": 0.6},
                        owner_key="later")
    o1 = sched.solve_delta(prev, added=[big], provisioners=[prov],
                           instance_types=c.catalog, max_delta_frac=0.9)
    assert "later" in o1.result.infeasible
    obs = [observe(o1)]
    o2 = sched.solve_delta(o1.result, removed=["p-0", "p-1"],
                           provisioners=[prov], instance_types=c.catalog,
                           max_delta_frac=0.9)
    assert "later" in o2.result.assignments
    assert "later" not in o2.result.infeasible
    return obs + [observe(o2)]


# ---------------------------------------------------------------------------
# TestMetrics
# ---------------------------------------------------------------------------


def s_modes_counted_and_zero_inited(k, c):
    out = c.delta()
    counter = c.reg.counter(k.metrics.WARMSTART_SOLVES)
    for mode in k.warmstart.DELTA_MODES:
        assert counter.has({"mode": mode})
    assert counter.get({"mode": "noop"}) == 1.0
    return [observe(out)]


# ---------------------------------------------------------------------------
# TestReviewRegressions
# ---------------------------------------------------------------------------


def s_unplaced_pod_survives_full_fallback(k, c, backend="oracle"):
    prov = k.prov.Provisioner(name="default",
                              limits={"cpu": 2.0}).with_defaults()
    sched = c.scheduler(backend)
    pods = [k.pod.PodSpec(name=f"p-{i}", requests={"cpu": 0.6},
                          owner_key="p") for i in range(3)]
    prev = sched.solve(pods, [prov], c.catalog)
    assert not prev.infeasible
    stuck = k.pod.PodSpec(name="stuck", requests={"cpu": 0.6},
                          owner_key="s")
    o1 = sched.solve_delta(prev, added=[stuck], provisioners=[prov],
                           instance_types=c.catalog, max_delta_frac=0.9)
    assert "stuck" in o1.result.infeasible
    obs = [observe(o1)]
    flood = [k.pod.PodSpec(name=f"f-{i}", requests={"cpu": 0.1},
                           owner_key="f") for i in range(10)]
    o2 = sched.solve_delta(o1.result, added=flood, provisioners=[prov],
                           instance_types=c.catalog, max_delta_frac=0.05)
    assert o2.mode == "full"
    assert "stuck" in set(o2.result.assignments) | set(o2.result.infeasible)
    return obs + [observe(o2)]


def s_reclaim_does_not_displace_daemon_pods(k, c):
    node = c.prev.nodes[0]
    node.pods.append(k.pod.PodSpec(name="ds-pod", requests={"cpu": 0.1},
                                   is_daemon=True))
    out = c.delta(iced=[node.name])
    assert "ds-pod" not in out.result.assignments
    seated = {p.name for n in (out.result.existing_nodes + out.result.nodes)
              for p in n.pods}
    assert "ds-pod" not in seated
    return [observe(out)]


def _residual_rows(meta) -> list:
    rows = []
    for i, n in enumerate(meta.nodes):
        rem = n.remaining()
        expect = [rem.get(r, 0.0) for r in meta.res_names]
        assert np.allclose(meta.residual[i], expect), n.name
        rows.append(np.asarray(meta.residual[i]).tolist())
    return rows


def s_scan_adopted_node_residual_not_double_subtracted(k, c):
    out = c.delta(added=mk_pods(k, 12, "big", cpu=3.0))
    assert out.mode == "scan"
    assert not out.result.infeasible
    meta = out.result._warmstart_meta
    prev_names = {n.name for n in c.prev.existing_nodes}
    adopted = [n for n in meta.nodes if n.name not in prev_names
               and any(p.name.startswith("big-") for p in n.pods)]
    assert adopted, "scenario did not buy a new node"
    assert any(sum(p.name.startswith("big-") for p in n.pods) >= 2
               for n in adopted)
    return [observe(out), _residual_rows(meta)]


def s_scan_soft_constraint_pods_not_double_seated(k, c, backend="oracle"):
    sched = c.scheduler(backend)
    base = [k.pod.PodSpec(name=f"d-{i}",
                          requests={"cpu": 0.5, "memory": 1.0 * GIB},
                          owner_key="d") for i in range(40)]
    prev = sched.solve(base, [c.prov], c.catalog)
    assert not prev.infeasible
    sel = k.pod.LabelSelector.of({"app": "soft"})
    soft = [k.pod.PodSpec(
        name=f"s-{i}", labels={"app": "soft"},
        requests={"cpu": 3.0, "memory": 1.0 * GIB}, owner_key="soft",
        topology_spread=[k.pod.TopologySpreadConstraint(
            1, k.L.ZONE, "ScheduleAnyway", sel)]) for i in range(10)]
    out = sched.solve_delta(prev, added=soft, provisioners=[c.prov],
                            instance_types=c.catalog, max_delta_frac=0.9)
    assert out.mode == "scan"
    assert not out.result.infeasible
    meta = out.result._warmstart_meta
    for n in meta.nodes:
        names = [p.name for p in n.pods]
        assert len(names) == len(set(names)), (n.name, names)
    return [observe(out), _residual_rows(meta)]


def s_reoffered_unplaced_pod_not_double_seated(k, c, backend="oracle"):
    prov = k.prov.Provisioner(name="default",
                              limits={"cpu": 2.0}).with_defaults()
    sched = c.scheduler(backend)
    pods = [k.pod.PodSpec(name=f"p-{i}", requests={"cpu": 0.6},
                          owner_key="p") for i in range(3)]
    prev = sched.solve(pods, [prov], c.catalog)
    assert not prev.infeasible
    stuck = k.pod.PodSpec(name="stuck", requests={"cpu": 0.6}, owner_key="s")
    o1 = sched.solve_delta(prev, added=[stuck], provisioners=[prov],
                           instance_types=c.catalog, max_delta_frac=0.9)
    assert "stuck" in o1.result.infeasible
    obs = [observe(o1)]
    o2 = sched.solve_delta(o1.result, added=[stuck], removed=["p-0"],
                           provisioners=[prov], instance_types=c.catalog,
                           max_delta_frac=0.9)
    assert "stuck" in o2.result.assignments
    seatings = [p.name for n in (o2.result.existing_nodes + o2.result.nodes)
                for p in n.pods].count("stuck")
    assert seatings == 1
    assert o2.total_pods == 3
    meta = o2.result._warmstart_meta
    if meta is not None:
        assert "stuck" not in meta.unplaced
    return obs + [observe(o2)]


def s_preseated_pod_removal_is_booked(k, c, backend="oracle"):
    sched = c.scheduler(backend)
    pre = k.pod.PodSpec(name="pre-0", requests={"cpu": 15.0},
                        owner_key="pre")
    node = k.types.SimNode(
        instance_type="m5.4xlarge", provisioner="default",
        zone="zone-1a", capacity_type="on-demand", price=0.768,
        allocatable={k.L.RESOURCE_CPU: 16.0,
                     k.L.RESOURCE_MEMORY: 64 * GIB,
                     k.L.RESOURCE_PODS: 110.0},
        existing=True, name="ex-0",
    )
    node.stamp_labels()
    node.pods.append(pre)
    w = k.pod.PodSpec(name="w-0", requests={"cpu": 0.5}, owner_key="w")
    prev = sched.solve([w], [c.prov], c.catalog, existing_nodes=[node])
    assert not prev.infeasible
    o1 = sched.solve_delta(prev, removed=["pre-0"], provisioners=[c.prov],
                           instance_types=c.catalog, max_delta_frac=0.9)
    assert o1.removed == 1
    seated = [p.name for n in (o1.result.existing_nodes + o1.result.nodes)
              for p in n.pods]
    assert "pre-0" not in seated
    obs = [observe(o1)]
    big = k.pod.PodSpec(name="big-0", requests={"cpu": 15.0},
                        owner_key="big")
    o2 = sched.solve_delta(o1.result, added=[big], provisioners=[c.prov],
                           instance_types=c.catalog, max_delta_frac=0.9)
    assert not o2.result.infeasible
    assert o2.result.assignments.get("big-0") == "ex-0"
    return obs + [observe(o2)]


def s_sel_terms_dedup_one_entry_per_selector_group(k, c, backend="oracle"):
    sched = c.scheduler(backend)
    sel = k.pod.LabelSelector.of({"app": "spread"})
    pods = [k.pod.PodSpec(
        name=f"sp-{i}", labels={"app": "spread"}, requests={"cpu": 0.1},
        owner_key="spread",
        topology_spread=[k.pod.TopologySpreadConstraint(
            50, k.L.ZONE, "DoNotSchedule", sel)]) for i in range(40)]
    prev = sched.solve(pods, [c.prov], c.catalog)
    out = sched.solve_delta(prev, added=mk_pods(k, 2, "x"),
                            provisioners=[c.prov], instance_types=c.catalog,
                            max_delta_frac=0.9)
    meta = out.result._warmstart_meta
    assert meta is not None
    assert len(meta.sel_terms) == 1
    return [observe(out)]


#: TpuSolver.solve_delta scenarios (the reference's ``solved`` fixture)
SOLVER_SCENARIOS = {
    "empty_delta_is_a_noop": s_empty_delta_is_a_noop,
    "disjoint_add_keeps_untouched_assignments":
        s_disjoint_add_keeps_untouched_assignments,
    "removal_is_pure_bookkeeping": s_removal_is_pure_bookkeeping,
    "removal_prunes_emptied_proposal_nodes":
        s_removal_prunes_emptied_proposal_nodes,
    "threshold_exceeded_falls_back_to_full":
        s_threshold_exceeded_falls_back_to_full,
    "chain_carries_meta": s_chain_carries_meta,
    "per_call_unavailable_accumulates": s_per_call_unavailable_accumulates,
    "iced_offering_is_remembered": s_iced_offering_is_remembered,
    "reclaimed_node_displaces_its_pods": s_reclaimed_node_displaces_its_pods,
    "modes_counted_and_zero_inited": s_modes_counted_and_zero_inited,
    "reclaim_does_not_displace_daemon_pods":
        s_reclaim_does_not_displace_daemon_pods,
    "scan_adopted_node_residual_not_double_subtracted":
        s_scan_adopted_node_residual_not_double_subtracted,
}

#: BatchScheduler.solve_delta scenarios, with the backend the reference
#: test uses; the ones whose displaced subproblem takes the scan tier also
#: run on the device backend
SCHEDULER_SCENARIOS = {
    ("spread_matched_removal_falls_back", "oracle"):
        s_spread_matched_removal_falls_back,
    ("foreign_selector_coupling_falls_back", "oracle"):
        s_foreign_selector_coupling_falls_back,
    ("own_constraint_add_takes_scan_not_host", "oracle"):
        s_own_constraint_add_takes_scan_not_host,
    ("own_constraint_add_takes_scan_not_host", "tpu"):
        s_own_constraint_add_takes_scan_not_host,
    ("unplaced_pods_reoffered_after_removal", "oracle"):
        s_unplaced_pods_reoffered_after_removal,
    ("unplaced_pod_survives_full_fallback", "oracle"):
        s_unplaced_pod_survives_full_fallback,
    ("scan_soft_constraint_pods_not_double_seated", "oracle"):
        s_scan_soft_constraint_pods_not_double_seated,
    ("scan_soft_constraint_pods_not_double_seated", "tpu"):
        s_scan_soft_constraint_pods_not_double_seated,
    ("reoffered_unplaced_pod_not_double_seated", "oracle"):
        s_reoffered_unplaced_pod_not_double_seated,
    ("preseated_pod_removal_is_booked", "oracle"):
        s_preseated_pod_removal_is_booked,
    ("preseated_pod_removal_is_booked", "tpu"):
        s_preseated_pod_removal_is_booked,
    ("sel_terms_dedup_one_entry_per_selector_group", "oracle"):
        s_sel_terms_dedup_one_entry_per_selector_group,
}


@pytest.mark.parametrize("name", sorted(SOLVER_SCENARIOS))
def test_solver_delta_matches_reference(catalogs, name):
    run_both(catalogs, SOLVER_SCENARIOS[name], solved=True)


@pytest.mark.parametrize("name,backend", sorted(SCHEDULER_SCENARIOS))
def test_scheduler_delta_matches_reference(catalogs, name, backend):
    run_both(catalogs, SCHEDULER_SCENARIOS[(name, backend)], backend=backend)


def s_gang_pod_in_added(k, c):
    """A gang pod in ``added`` (and in ``submit``) is no longer refused:
    the one-member gang places atomically through the delta step and
    through the async entry, as in the reference."""
    sched = c.scheduler("oracle")
    prev = sched.solve(mk_pods(k, 8, "p"), [c.prov], c.catalog)
    member = k.pod.PodSpec(name="g-0", requests={"cpu": 0.5},
                           owner_key="g")
    member.gang_id = "train"
    out = sched.solve_delta(prev, added=[member], provisioners=[c.prov],
                            instance_types=c.catalog)
    assert "g-0" in out.result.assignments
    res = sched.submit([member], [c.prov], c.catalog).result()
    assert "g-0" in res.assignments
    return [observe(out), plan(res), dict(res.assignments)]


def test_gang_pod_in_added_is_refused(catalogs):
    run_both(catalogs, s_gang_pod_in_added)


# ---------------------------------------------------------------------------
# the warm API (tests/test_coldstart.py, the cases without the native tier)
# ---------------------------------------------------------------------------


def _wait_warm(sched, timeout: float = 120.0) -> None:
    t0 = time.time()
    while not sched._tpu.warm_idle():
        if time.time() - t0 > timeout:
            raise AssertionError("background warm did not finish in time")
        time.sleep(0.02)


def _ref_profile_sigs(catalogs, profiles, existing=()):
    """The reference's signatures of the same warm profiles (key math only,
    nothing compiles)."""
    sched = ref_scheduler.BatchScheduler(backend="auto")
    prov = ref_prov.Provisioner(name="default").with_defaults()
    return [sched._tpu.signature(st, existing_nodes=existing)
            for st in sched._profile_tensors([prov], catalogs["ref"], (),
                                             profiles)]


def test_warm_queue_drains_beyond_concurrency_cap(catalogs, monkeypatch):
    monkeypatch.setattr(t_tpu.TpuSolver, "MAX_CONCURRENT_WARMS", 1)
    reg = t_metrics.Registry()
    sched = t_scheduler.BatchScheduler(backend="auto", registry=reg,
                                       device="cpu")
    prov = t_prov.Provisioner(name="default").with_defaults()
    profiles = ((2, 4, False), (40, 80, False))
    accepted = sched.warm_startup([prov], catalogs["port"], profiles=profiles)
    assert accepted == 2  # distinct G rungs: one runs, one queues
    _wait_warm(sched)
    assert sched._tpu._ready == set(_ref_profile_sigs(catalogs, profiles))
    assert reg.histogram(t_metrics.SOLVER_COMPILE_DURATION).count() == 2
    assert reg.gauge(t_metrics.SOLVER_COMPILE_IN_PROGRESS).get() == 0


def test_stop_warms_drops_queue(catalogs, monkeypatch):
    monkeypatch.setattr(t_tpu.TpuSolver, "MAX_CONCURRENT_WARMS", 1)
    sched = t_scheduler.BatchScheduler(backend="auto",
                                       registry=t_metrics.Registry(),
                                       device="cpu")
    prov = t_prov.Provisioner(name="default").with_defaults()
    gate = threading.Event()
    real_solve = sched._tpu.solve

    def held_solve(*a, **kw):  # keep the first warm in flight
        gate.wait(timeout=60.0)
        return real_solve(*a, **kw)

    sched._tpu.solve = held_solve
    accepted = sched.warm_startup([prov], catalogs["port"],
                                  profiles=((2, 4, False), (40, 80, False)))
    assert accepted == 2
    sched.stop_warms()
    gate.set()
    _wait_warm(sched)
    assert len(sched._tpu._ready) <= 1  # the queued warm never ran
    assert not sched._tpu._queued
    # a stopped solver admits no new warm
    st = sched._profile_tensors([prov], catalogs["port"], (),
                                ((4, 8, True),))[0]
    assert not sched._tpu.warm_async(st)


def test_failed_warm_backs_off(catalogs):
    """A signature whose warm fails is not retried within the backoff, and
    failures stay out of the duration histogram."""
    reg = t_metrics.Registry()
    sched = t_scheduler.BatchScheduler(backend="auto", registry=reg,
                                       device="cpu")
    clock = FakeClock()
    sched._tpu._clock = clock

    def boom(*a, **k):
        raise RuntimeError("simulated warm failure")

    real_solve = sched._tpu.solve
    sched._tpu.solve = boom
    prov = t_prov.Provisioner(name="default").with_defaults()
    pods = [t_pod.PodSpec(name=f"p{i}", requests={"cpu": 1.0})
            for i in range(300)]
    st = t_tensorize.tensorize(pods, [prov], catalogs["port"])
    assert sched._tpu.warm_async(st, on_done=sched._warm_done)
    _wait_warm(sched)
    assert reg.histogram(t_metrics.SOLVER_COMPILE_DURATION).count() == 0
    assert not sched._tpu.warm_async(st)  # inside the backoff window
    assert sched._tpu._failed_until
    assert sched._tpu.warm_pending(sched._tpu.signature(st))
    sched._tpu.solve = real_solve
    clock.advance(t_tpu.TpuSolver.WARM_FAILURE_BACKOFF + 1.0)
    assert sched._tpu.warm_async(st, on_done=sched._warm_done)
    _wait_warm(sched)
    assert sched._tpu.ready(sched._tpu.signature(st))
    assert reg.histogram(t_metrics.SOLVER_COMPILE_DURATION).count() == 1


def test_warm_startup_uses_cluster_size(catalogs):
    """The warmed signatures reflect the live cluster's NE/NR rungs: the
    provisioning and the consolidation shape land on distinct NR rungs and
    the cluster-sized NE_pad rung."""
    def nodes(k):
        return [k.types.SimNode(
            instance_type="c5.2xlarge", provisioner="default",
            zone="zone-1a", capacity_type="on-demand", price=0.34,
            allocatable={"cpu": 8.0, "pods": 58.0}, existing=True)
            for _ in range(120)]

    sched = t_scheduler.BatchScheduler(backend="auto",
                                       registry=t_metrics.Registry(),
                                       device="cpu")
    prov = t_prov.Provisioner(name="default").with_defaults()
    existing = nodes(PORT)
    profiles = ((2, 400, False),)
    accepted = sched.warm_startup([prov], catalogs["port"],
                                  existing_nodes=existing, profiles=profiles)
    assert accepted == 2
    _wait_warm(sched)
    ne_pads = {dict(sig)["NE_pad"] for sig in sched._tpu._ready}
    assert t_tpu._rung(120, 16, 64) in ne_pads
    # the reference warms the same two signatures
    ref = ref_scheduler.BatchScheduler(backend="auto")
    ref_prov_ = ref_prov.Provisioner(name="default").with_defaults()
    ref_existing = nodes(REF)
    st, = ref._profile_tensors([ref_prov_], catalogs["ref"], (), profiles)
    want = {ref._tpu.signature(st, existing_nodes=ref_existing),
            ref._tpu.signature(st, existing_nodes=ref_existing,
                               max_nodes=len(ref_existing) + 1)}
    assert sched._tpu._ready == want


def test_raise_on_exhaust_contract(catalogs):
    """raise_on_exhaust surfaces SlotsExhausted when the estimate runs dry
    and the full-budget signature has not run; without the flag the solver
    retries inline and places every pod, after which the family resolves
    to the full signature — the reference's key."""
    def batch(k):
        sel = k.pod.LabelSelector.of({"app": "x"})
        return [k.pod.PodSpec(
            name=f"p{i}", labels={"app": "x"}, requests={"cpu": 0.05},
            affinity_terms=[k.pod.PodAffinityTerm(sel, k.L.HOSTNAME,
                                                  anti=True)],
            owner_key="x") for i in range(3000)]

    prov = t_prov.Provisioner(name="default").with_defaults()
    st = t_tensorize.tensorize(batch(PORT), [prov], catalogs["port"])
    solver = t_tpu.TpuSolver(device="cpu")
    with pytest.raises(t_tpu.SlotsExhausted) as exc:
        solver.solve(st, raise_on_exhaust=True)
    assert solver._nr_exhausted
    out = solver.solve(st)
    assert out.result.infeasible == {}
    assert len(out.result.nodes) == 3000
    # the family now resolves to the full signature, which has run: no
    # raise even under the flag
    assert solver.signature(st) == exc.value.full_sig
    assert solver.ready(exc.value.full_sig)
    solver.solve(st, raise_on_exhaust=True)
    ref_st = ref_tensorize.tensorize(
        batch(REF), [ref_prov.Provisioner(name="default").with_defaults()],
        catalogs["ref"])
    ref_full = ref_tpu.solve_dims(
        ref_st, NE=0, node_budget=ref_tpu._node_budget(ref_st, 0, None),
        full_nr=True)
    assert exc.value.full_sig == ref_tpu._dims_key(ref_full)


def test_unplaced_pods_survive_two_full_fallbacks(catalogs):
    """A fault of the reference, fixed in the port (ROADMAP Queue C): a
    full fallback's result carries only the NAMES of the pods it left
    unplaced, the reference's rebuilt chain loses their objects, and its
    next full re-solve drops them from the result altogether (here 10 of
    23 pods).  The port retains them across the rebuild; both full steps
    otherwise take the reference's mode and first result."""
    def chain(k):
        reset_names(k)
        c = Ctx(k, catalogs[k.name], solved=False)
        prov = k.prov.Provisioner(name="default",
                                  limits={"cpu": 2.0}).with_defaults()
        sched = c.scheduler("oracle")
        pods = [k.pod.PodSpec(name=f"p-{i}", requests={"cpu": 0.6},
                              owner_key="p") for i in range(3)]
        prev = sched.solve(pods, [prov], c.catalog)
        outs = []
        for tag in ("f", "g"):
            flood = [k.pod.PodSpec(name=f"{tag}-{i}", requests={"cpu": 0.6},
                                   owner_key=tag) for i in range(10)]
            out = sched.solve_delta(prev, added=flood, provisioners=[prov],
                                    instance_types=c.catalog,
                                    max_delta_frac=0.05)
            outs.append(out)
            prev = out.result
        return outs

    port, ref = chain(PORT), chain(REF)
    assert [o.mode for o in port] == [o.mode for o in ref] == ["full", "full"]
    assert observe(port[0]) == observe(ref[0])
    tracked = set(port[1].result.assignments) | set(port[1].result.infeasible)
    assert len(tracked) == 23
    assert len(set(ref[1].result.assignments)
               | set(ref[1].result.infeasible)) == 13


def _web_spread(sel_labels, name, owner, cpu=0.5):
    sel = t_pod.LabelSelector.of(sel_labels)
    return t_pod.PodSpec(
        name=name, labels={"app": owner}, owner_key=owner,
        requests={"cpu": cpu, "memory": 1.0 * GIB},
        topology_spread=[t_pod.TopologySpreadConstraint(
            1, t_labels.ZONE, "DoNotSchedule", sel)])


def test_existing_node_selector_counts_are_per_pod_counts(catalogs):
    """The existing-node selector counts (``selcnt``, the zone counters
    and the totals) count every matching pod, whether its label dict is
    shared, an equal copy, the same labels in another order, or another
    set; ``_host_arrays`` matches each distinct label set once."""
    catalog = catalogs["port"]
    prov = t_prov.Provisioner(name="default").with_defaults()
    pending = ([_web_spread({"app": "web"}, f"w-{i}", "web")
                for i in range(4)]
               + [_web_spread({"tier": "a"}, f"t-{i}", "tier")
                  for i in range(4)])
    st, _ = t_tensorize.TensorizeCache().tensorize(pending, [prov], catalog)
    assert len(st.selector_defs) == 2
    shared = {"app": "web", "tier": "a"}
    groups = [
        [shared] * 3 + [dict(shared)] * 2
        + [{"tier": "a", "app": "web"}, {"app": "db"}],
        [{"app": "web", "tier": "b"}, {}, shared],
        [],
    ]
    it = catalog[0]
    nodes = []
    for ni, labels in enumerate(groups):
        nodes.append(t_types.SimNode(
            instance_type=it.name, provisioner="default",
            zone=st.zone_names[ni % len(st.zone_names)],
            capacity_type="on-demand", price=1.0,
            allocatable={"cpu": 64.0, "memory": 256.0 * GIB, "pods": 110.0},
            pods=[t_pod.PodSpec(name=f"e{ni}-{j}", labels=lab,
                                requests={"cpu": 0.1})
                  for j, lab in enumerate(labels)],
            existing=True))
    solver = t_tpu.TpuSolver(device="cpu")
    _c, _f, init, _d = solver._host_arrays(
        st, nodes, node_budget=8, track_assignments=False, full_nr=False)
    selcnt, zc, tot = init[5], init[8], init[9]
    zone_index = {z: i for i, z in enumerate(st.zone_names)}
    want_zc = np.zeros_like(zc)
    for si, (sel, _topo, _kind) in enumerate(st.selector_defs):
        for ni, n in enumerate(nodes):
            want = sum(1 for p in n.pods if sel.matches(p.labels))
            assert selcnt[ni, si] == want
            want_zc[si, zone_index[n.zone]] += want
    assert (zc == want_zc).all()
    assert (tot == want_zc.sum(axis=1)).all()
    assert selcnt[:3].sum() == 6 + 2 + 6 + 1


def test_build_meta_builds_each_owners_group_key_once(monkeypatch):
    """``build_meta`` indexes every seated spread pod's (selector, group
    key) pair, building a key only where a pod's spec differs from the
    last of its owner: 4 keys for 8 pods here, the same pairs as every
    pod's own key gives."""
    spread_w = _web_spread({"app": "w"}, "w-0", "w")
    spread_v = _web_spread({"app": "v"}, "v-0", "v")

    def like(p, name, **kw):
        d = dict(p.__dict__, name=name, labels=dict(p.labels),
                 requests=dict(kw.pop("requests", p.requests)), **kw)
        d.pop("_group_key", None)
        q = object.__new__(t_pod.PodSpec)
        q.__dict__ = d
        return q

    order = [like(spread_w, "w-1"), like(spread_w, "w-2"),
             like(spread_v, "v-1"), like(spread_w, "w-3"),
             like(spread_v, "v-2"),
             like(spread_w, "w-4", requests={"cpu": 1.5, "memory": GIB}),
             like(spread_w, "w-5"), like(spread_v, "v-3")]
    want = {(t.label_selector, p._compute_group_key())
            for p in order for t in p.topology_spread}
    assert len(want) == 3
    built = []
    compute = t_pod.PodSpec._compute_group_key
    monkeypatch.setattr(t_pod.PodSpec, "_compute_group_key",
                        lambda self: built.append(self.name) or compute(self))
    nodes = [t_types.SimNode(instance_type="m", provisioner="default",
                             zone="z", capacity_type="on-demand", price=1.0,
                             allocatable={"cpu": 64.0}, pods=order[i:i + 3])
             for i in range(0, len(order), 3)]
    prev = t_types.SolveResult(
        nodes=nodes, assignments={p.name: n.name for n in nodes
                                  for p in n.pods},
        infeasible={}, existing_nodes=[])
    meta = t_warmstart.build_meta(prev)
    assert meta.sel_terms == want
    assert built == ["w-1", "v-1", "w-4", "w-5"]
    assert meta.total_pods == 8 and not meta.preseated
