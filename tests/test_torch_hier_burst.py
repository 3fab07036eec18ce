"""The benchmark's ``zonespread-100k`` configuration at a host size, held to
the benchmark's plain reference (``benchmark/reference.py``: a numpy
first-fit-decreasing and the check of the configuration's guarantees; it
imports nothing of the program).

The configuration's pending sets are built through ``benchmark.workload``
and ``benchmark.inputs`` and cut to 8 deployments of 250 pods (2,000 pods),
the threshold lowered to 2,000 for these tests only (``KT_HIER_THRESHOLD``)
so that ``BatchScheduler(backend="auto")`` takes the hierarchical route as
it does at 100,000 pods by default.  Each plan:

- was routed hierarchically (one ``karpenter_solver_hier_solves_total``
  ``{path="hierarchical"}`` a solve, no fallback);
- breaks none of the guarantees (``reference.check`` counts 0 faults of
  every kind);
- costs at most 1.02x the reference FFD plan's $/hr.  Tolerance 1.02: the
  mission's ceiling on a solve's cost against first-fit-decreasing
  (BASELINE.json's north star), which the blocks' separate plans and the
  tail repack have to meet together;
- is node for node the plan of the same set solved without a trace.

Then the harness runs the cell itself on the host at that size, traced
and untraced: ``correct``, and with the trace every per-layer metric of
the hierarchical solve non-null.
"""

from __future__ import annotations

import copy
import time

import pytest
import torch

from benchmark import catalog, harness, inputs, reference, workload
from benchmark.tracing import ReqTrace
from karpenter_tpu_torch.metrics import HIER_SOLVES, Registry
from karpenter_tpu_torch.solver.scheduler import BatchScheduler

torch.set_num_threads(1)

CELL = "zonespread-100k.burst"
#: the host size: deployments x replicas, and the threshold that routes it
DEPLOYMENTS, REPLICAS = 8, 250
THRESHOLD = DEPLOYMENTS * REPLICAS
#: the mission's cost ceiling against FFD (BASELINE.json's north star)
COST_CEILING = 1.02
HIER_METRICS = ("hier.ms_per_solve", "hier.wave_ms_per_solve",
                "hier.tail_ms_per_solve", "hier.repair_ms_per_solve",
                "hier.host_ms_per_solve", "hier.repair_pods_per_solve")
SEEDS = (2 ** 33 + 7, 2 ** 31 + 1234567)


@pytest.fixture
def hier_at_host_size(monkeypatch):
    monkeypatch.setenv("KT_HIER_THRESHOLD", str(THRESHOLD))


def host_cell() -> dict:
    """The cell cut to the host size: the first 8 deployments' shapes."""
    c = copy.deepcopy(harness.cell(harness.manifest(), CELL))
    p = c["config"]["pending"]
    p["deployments"], p["replicas"] = DEPLOYMENTS, REPLICAS
    p["cpu"], p["memory_gib"] = p["cpu"][:DEPLOYMENTS], \
        p["memory_gib"][:DEPLOYMENTS]
    return c


@pytest.fixture(scope="module")
def problem():
    c = host_cell()
    config = c["config"]
    records = catalog.generate(full=config["catalog"]["full"])
    return dict(
        cell=c,
        candidates=reference.Candidates(records, config["provisioner"],
                                        catalog.ZONES),
        instance_types=inputs.instance_types(records),
        provisioner=inputs.provisioner(config["provisioner"]))


def node_plan(plan: dict) -> list:
    """A plain plan's nodes without their names: (type, zone, capacity
    type, price, sorted pod indices), sorted."""
    return sorted((t, z, ct, p, tuple(sorted(pods)))
                  for t, z, ct, p, pods in plan["nodes"])


def test_the_configuration_is_slice_ones_batch():
    c = harness.cell(harness.manifest(), CELL)
    p = c["config"]["pending"]
    assert c["chips"] == 1 and c["config"]["reduced"] == []
    assert p["deployments"] * p["replicas"] == 100_000
    assert p["cpu"] == [0.25 * (1 + d % 8) for d in range(40)]
    assert p["memory_gib"] == [0.5 + d % 6 for d in range(40)]
    assert {m["name"] for m in c["per_layer"]} == set(HIER_METRICS) | {
        "scan.graph_replay_share"}
    assert {m["name"] for m in c["end_to_end"]} == {
        "pods_per_s", "cost_vs_ffd", "setup_s"}
    # the default threshold routes the full batch hierarchically
    from karpenter_tpu_torch.solver.hierarchy import DEFAULT_HIER_THRESHOLD

    assert p["deployments"] * p["replicas"] >= DEFAULT_HIER_THRESHOLD


@pytest.mark.parametrize("seed", SEEDS)
def test_hierarchical_plans_keep_the_guarantees(problem, hier_at_host_size,
                                                seed):
    c = problem["cell"]
    traffic = dict(c["traffic"], sets=2)
    sets = workload.pending_sets(c["config"], traffic, seed)
    reg = Registry()
    sched = BatchScheduler(backend="auto", registry=reg, device="cpu")
    try:
        for s, pending in enumerate(sets):
            tmpl = inputs.templates(pending)
            index = inputs.index_of(tmpl)
            plans = []
            for k, trace in enumerate((None, ReqTrace())):
                tag = f"{s}x{k}"
                res = sched.solve(inputs.fresh(tmpl, tag),
                                  [problem["provisioner"]],
                                  problem["instance_types"], trace=trace)
                plans.append(inputs.plain_plan(res, index, tag))
            assert reg.counter(HIER_SOLVES).get(
                {"path": "hierarchical"}) == 2 * (s + 1)
            for path in ("fallback_structure", "fallback_degraded"):
                assert reg.counter(HIER_SOLVES).get({"path": path}) == 0
            cands = problem["candidates"]
            ffd_cost, _ffd_nodes = reference.ffd(pending, cands)
            for plan in plans:
                faults = reference.check(pending, plan, cands)
                assert faults == dict.fromkeys(reference.FAULT_KINDS, 0)
                assert (reference.plan_cost(plan, cands)
                        <= COST_CEILING * ffd_cost)
            # node for node the same with a trace as without one
            assert node_plan(plans[1]) == node_plan(plans[0])
            assert plans[1]["infeasible"] == plans[0]["infeasible"] == []
    finally:
        sched.stop_warms()


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_on_the_host(hier_at_host_size, trace):
    c = host_cell()
    c["traffic"].update(sets=1, offers=4)
    out = harness.run_cell(c, 2 ** 33 + 11, 1.0, trace, torch.device("cpu"),
                           time.perf_counter())
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["compared"] == {"plan_faults": {"value": 0, "limit": 0}}
    got = out["metrics"]
    if trace:
        assert set(got) == set(HIER_METRICS)
        assert all(got[m]["value"] is not None for m in HIER_METRICS)
        assert got["hier.wave_ms_per_solve"]["value"] > 0
        assert got["hier.tail_ms_per_solve"]["value"] > 0
        assert got["hier.repair_pods_per_solve"]["value"] == 0.0
        # the hierarchical wall holds its waves and its tail repack
        assert got["hier.ms_per_solve"]["value"] >= (
            got["hier.wave_ms_per_solve"]["value"]
            + got["hier.tail_ms_per_solve"]["value"])
    else:
        assert set(got) == {"pods_per_s", "cost_vs_ffd", "setup_s"}
        assert got["cost_vs_ffd"]["value"] <= COST_CEILING
