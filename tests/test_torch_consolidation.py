"""The port's consolidation screen and what-if sweep against the reference
package, on the CPU.

- The deletability screen: every case of the reference's
  ``tests/test_consolidation_batch.py`` screen suite (headroom, full
  cluster, empty node, taints, zone selectors, pmax overflow, subset
  pairs, compat), built once with the reference's models and converted
  to the port's: ``deletable`` vectors equal to the reference's and to
  the expected answer.  A 1,000-node version of the config-4 fleet (the
  5,000-node one runs on the card, ``chip_smoke.py``).
- ``compat_matrix`` against the reference's on its class-memo fixture
  (random scenarios with taints, selectors and heterogeneous labels).
- The sweep: decisions against the reference's sweep (after its program
  has compiled behind) and against the port's own serial what-if loop on
  the reference's mixed-feasibility cluster; the empty candidate, a boxed
  per-candidate exception, ``stop_on``, a failed dispatch, and the
  serial path of the oracle backend.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

import karpenter_tpu.solver.consolidation as ref_cons
from karpenter_tpu.metrics import Registry as RefRegistry
from karpenter_tpu.models import labels as RL
from karpenter_tpu.models.catalog import generate_catalog as ref_catalog
from karpenter_tpu.models.pod import PodSpec, Taint
from karpenter_tpu.models.provisioner import Provisioner as RefProv
from karpenter_tpu.solver.scheduler import BatchScheduler as RefScheduler
from karpenter_tpu.solver.types import SimNode
from karpenter_tpu_torch.metrics import (
    CONSOLIDATION_SWEEP_SLOTS,
    CONSOLIDATION_SWEEPS,
    Registry,
)
from karpenter_tpu_torch.models.catalog import generate_catalog
from karpenter_tpu_torch.models.provisioner import Provisioner
from karpenter_tpu_torch.solver import consolidation as cons
from karpenter_tpu_torch.solver.scheduler import BatchScheduler

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_relax import to_port  # noqa: E402

torch.set_num_threads(1)


def mk_node(name, cpu_alloc, pods_cpu, zone="zone-1a", taints=(), labels=None):
    node = SimNode(
        instance_type="m5.xlarge", provisioner="default", zone=zone,
        capacity_type="on-demand", price=0.192,
        allocatable={RL.RESOURCE_CPU: cpu_alloc,
                     RL.RESOURCE_MEMORY: 64 * 2**30, RL.RESOURCE_PODS: 50.0},
        labels=labels or {RL.ZONE: zone}, taints=list(taints), name=name)
    for i, c in enumerate(pods_cpu):
        node.pods.append(PodSpec(name=f"{name}-p{i}",
                                 requests={RL.RESOURCE_CPU: c}))
    return node


def _pinned_pair():
    a = mk_node("a", 8.0, [], zone="zone-1a")
    b = mk_node("b", 8.0, [], zone="zone-1b")
    b.pods.append(PodSpec(name="pinned", requests={RL.RESOURCE_CPU: 1.0},
                          node_selector={RL.ZONE: "zone-1b"}))
    return [a, b]


def _tainted(n=2):
    nodes = [mk_node("a", 8.0, [1.0]),
             mk_node("b", 8.0, [1.0],
                     taints=[Taint("team", RL.EFFECT_NO_SCHEDULE, "x")])]
    if n == 3:
        nodes.append(mk_node("c", 8.0, [1.0]))
    return nodes


def _four():
    return [mk_node("a", 4.0, [1.0]), mk_node("b", 4.0, [1.0]),
            mk_node("c", 8.0, [2.0]), mk_node("d", 4.0, [3.5])]


#: (nodes, subsets or None for the single-node screen, compat?, kwargs,
#: expected deletable)
SCREEN_CASES = {
    "obviously_deletable": (
        lambda: [mk_node("a", 4.0, [1.0]), mk_node("b", 4.0, [1.0])],
        None, False, {}, [True, True]),
    "full_cluster": (
        lambda: [mk_node("a", 4.0, [2.0, 1.9]), mk_node("b", 4.0, [2.0, 1.9])],
        None, False, {}, [False, False]),
    "empty_node_always_deletable": (
        lambda: [mk_node("a", 4.0, [3.9]), mk_node("b", 2.0, [])],
        None, False, {}, [False, True]),
    "taints_block": (_tainted, None, True, {}, [False, True]),
    "zone_selector": (_pinned_pair, None, True, {}, [True, False]),
    "pmax_overflow": (
        lambda: [mk_node("a", 48.0, [0.1] * 70), mk_node("b", 48.0, [])],
        None, False, {"pmax": 64}, [False, True]),
    "subset_pairs": (_four, [[0, 1], [0, 1, 3], [2, 3], [0, 1, 2]], False,
                     {}, [True, True, False, False]),
    "subset_compat": (lambda: _tainted(3), [[0, 2], [0]], True, {},
                      [False, True]),
    "subset_overflow": (
        lambda: [mk_node("a", 48.0, [0.1] * 60), mk_node("b", 48.0, [0.1] * 60),
                 mk_node("c", 48.0, [])],
        [[0, 1]], False, {"pmax_total": 100}, [False]),
}


@pytest.mark.parametrize("name", sorted(SCREEN_CASES))
def test_screen_matches_reference(name):
    build, subsets, with_compat, kw, want = SCREEN_CASES[name]
    ref_nodes = build()
    nodes = to_port(ref_nodes)
    if with_compat:
        cm_ref = ref_cons.compat_matrix(ref_nodes)
        cm = cons.compat_matrix(nodes)
        assert (cm == cm_ref).all()
    else:
        cm_ref = cm = None
    before = cons.SCREEN_PROGRAM.get("cpu")
    if subsets is None:
        ref = ref_cons.screen_delete_candidates(ref_nodes, cm_ref, **kw)
        got = cons.screen_delete_candidates(nodes, cm, device="cpu", **kw)
        assert got.n_candidates == len(nodes)
    else:
        ref = ref_cons.screen_subset_deletes(ref_nodes, subsets, cm_ref, **kw)
        got = cons.screen_subset_deletes(nodes, subsets, cm, device="cpu",
                                         **kw)
        assert got.n_subsets == len(subsets)
    assert cons.SCREEN_PROGRAM.get("cpu") == before + 1
    assert got.deletable.tolist() == ref.deletable.tolist() == want


def test_compat_blocks_taints_and_selectors():
    cm = cons.compat_matrix(to_port(_tainted()))
    assert not cm[0, 1] and cm[1, 0]
    assert not cons.compat_matrix(to_port(_pinned_pair()))[1, 0]


def _config4_fleet(n):
    rng = np.random.RandomState(7)
    nodes = []
    for i in range(n):
        pods = [float(c) for c in rng.choice([0.5, 1.0, 2.0],
                                             size=rng.randint(1, 5))]
        nodes.append(mk_node(f"n{i}", 16.0, pods))
    return nodes


def test_config4_fleet_1000_nodes():
    ref_nodes = _config4_fleet(1000)
    ref = ref_cons.screen_delete_candidates(ref_nodes, pmax=8)
    got = cons.screen_delete_candidates(to_port(ref_nodes), pmax=8,
                                        measure=True, device="cpu")
    assert got.deletable.tolist() == ref.deletable.tolist()
    assert got.deletable.mean() > 0.5
    assert got.eval_ms > 0 and got.compile_ms > 0


def test_screen_tight_fleet_matches_reference():
    """A fleet where first-fit order decides: nodes near full, pods of
    mixed sizes, a random compat — some candidates deletable, some not."""
    rng = np.random.default_rng(11)
    ref_nodes = []
    for i in range(60):
        cap = float(rng.choice([4.0, 8.0]))
        fill = cap * float(rng.uniform(0.8, 1.0))
        pods = []
        while True:
            c = float(rng.choice([0.5, 1.0, 1.5, 2.0]))
            if sum(pods) + c > fill:
                break
            pods.append(c)
        ref_nodes.append(mk_node(f"t{i}", cap, pods))
    compat = rng.random((60, 60)) < 0.05
    subsets = [sorted(rng.choice(60, size=int(rng.integers(1, 4)),
                                 replace=False).tolist()) for _ in range(40)]
    ref = ref_cons.screen_subset_deletes(ref_nodes, subsets, compat)
    got = cons.screen_subset_deletes(to_port(ref_nodes), subsets, compat,
                                     device="cpu")
    assert got.deletable.tolist() == ref.deletable.tolist()
    assert 0 < got.deletable.sum() < len(subsets)
    single_ref = ref_cons.screen_delete_candidates(ref_nodes, compat, pmax=8)
    single = cons.screen_delete_candidates(to_port(ref_nodes), compat, pmax=8,
                                           device="cpu")
    assert single.deletable.tolist() == single_ref.deletable.tolist()


def test_screen_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes = to_port([mk_node("a", 4.0, [1.0]), mk_node("b", 4.0, [1.0])])
    with pytest.raises(RuntimeError, match="CUDA"):
        cons.screen_delete_candidates(nodes)


def test_compat_matrix_matches_reference_on_the_memo_fixture():
    from test_fuzz_parity import random_existing_nodes, random_scenario

    small = ref_catalog(full=False)
    for seed in (2, 5, 11):
        pods, provs, _un = random_scenario(seed, small)
        nodes = random_existing_nodes(seed, small, provs)
        for i, node in enumerate(nodes):
            for p in pods[i * 3:(i * 3) + 3]:
                node.pods.append(p)
        port_nodes = to_port(nodes)
        want = ref_cons.compat_matrix(nodes)
        assert (cons.compat_matrix(port_nodes) == want).all(), seed
        srcs = list(range(0, len(nodes), 2))
        assert (cons.compat_matrix(port_nodes, sources=srcs)
                == ref_cons.compat_matrix(nodes, sources=srcs)).all(), seed


# ---------------------------------------------------------------------------
# the what-if sweep
# ---------------------------------------------------------------------------


def _sweep_cluster(n_nodes, npods, cpu_alloc=8.0, pod_cpu=0.5):
    nodes = []
    for i in range(n_nodes):
        node = mk_node(f"c{i}", cpu_alloc, [])
        for j in range(npods):
            node.pods.append(PodSpec(
                name=f"c{i}-p{j}", requests={RL.RESOURCE_CPU: pod_cpu},
                owner_key=f"g{j % 3}"))
        nodes.append(node)
    return nodes


def _mixed_cluster():
    """6 lightly-loaded nodes (absorbable) + 2 nearly-full ones whose pods
    select a label nothing carries: genuinely unmovable."""
    nodes = _sweep_cluster(6, 3)
    for i in range(2):
        node = mk_node(f"full{i}", 8.0, [])
        for j in range(12):
            node.pods.append(PodSpec(
                name=f"full{i}-p{j}", requests={RL.RESOURCE_CPU: 0.6},
                owner_key="heavy", node_selector={"team": "gpu"}))
        nodes.append(node)
    return nodes


def _decision(res):
    return (not res.infeasible, len(res.nodes), round(res.new_node_cost, 9))


@pytest.fixture(scope="module")
def small_catalogs():
    return ref_catalog(full=False), generate_catalog(full=False)


def _port_sweep(nodes, cands, catalog, **kw):
    reg = kw.pop("registry", None) or Registry()
    sched = kw.pop("sched", None) or BatchScheduler(
        backend="tpu", device="cpu", registry=reg)
    prov = Provisioner(name="default").with_defaults()
    return sched, sweep_what_ifs(sched, nodes, cands, prov, catalog, reg,
                                 **kw)


def sweep_what_ifs(sched, nodes, cands, prov, catalog, reg, **kw):
    return cons.sweep_what_ifs(sched, nodes, cands, provisioners=[prov],
                               instance_types=catalog, registry=reg, **kw)


def _serial(sched, nodes, catalog):
    prov = Provisioner(name="default").with_defaults()
    out = []
    for k in range(len(nodes)):
        others = [n for j, n in enumerate(nodes) if j != k]
        out.append(sched.solve(
            [p for p in nodes[k].pods if not p.is_daemon], [prov], catalog,
            existing_nodes=others, allow_new_nodes=True, max_new_nodes=1))
    return out


def test_sweep_decisions_match_reference_and_serial(small_catalogs):
    rcat, pcat = small_catalogs
    ref_nodes = _mixed_cluster()
    cands = [[i] for i in range(len(ref_nodes))]
    ref_reg = RefRegistry()
    ref_sched = RefScheduler(backend="tpu", registry=ref_reg)
    prov = RefProv(name="default").with_defaults()
    first = ref_cons.sweep_what_ifs(ref_sched, ref_nodes, cands,
                                    provisioners=[prov], instance_types=rcat,
                                    registry=ref_reg)
    assert first.n_serial == len(cands)  # the reference's cold pass
    t0 = time.time()
    while not ref_sched._tpu.warm_idle() and time.time() - t0 < 300:
        time.sleep(0.05)
    ref = ref_cons.sweep_what_ifs(ref_sched, ref_nodes, cands,
                                  provisioners=[prov], instance_types=rcat,
                                  registry=ref_reg)
    assert ref.n_batched > 0

    nodes = to_port(ref_nodes)
    reg = Registry()
    sched, sweep = _port_sweep(nodes, cands, pcat, registry=reg)
    # the port dispatches on its first sweep: every clean slot batched
    assert sweep.n_batched == ref.n_batched == 6
    assert sweep.n_serial == 2 and sweep.path == "mixed"
    assert sweep.dispatches >= 1
    assert reg.counter(CONSOLIDATION_SWEEPS).get({"path": "mixed"}) == 1
    assert reg.histogram(CONSOLIDATION_SWEEP_SLOTS).count() \
        == sweep.dispatches
    serial = _serial(sched, nodes, pcat)
    assert any(r.infeasible for r in serial)
    for k, (a, b, c) in enumerate(zip(sweep.results, serial, ref.results)):
        assert not isinstance(a, BaseException), (k, a)
        assert _decision(a) == _decision(b) == _decision(c), k

    # stop_on rides the batched results: candidate 0 confirms clean in the
    # dispatch, so the unmovable candidates are never solved serially
    _s, gated = _port_sweep(
        nodes, cands, pcat, stop_on=lambda k, r: not isinstance(
            r, BaseException) and not r.infeasible and not r.nodes)
    assert gated.n_serial == 0
    assert _decision(gated.results[0]) == _decision(serial[0])
    assert any(r is None for r in gated.results)


def test_sweep_empty_candidate_is_trivially_deletable(small_catalogs):
    nodes = to_port(_sweep_cluster(3, 2) + [mk_node("empty", 8.0, [])])
    _s, sweep = _port_sweep(nodes, [[3]], small_catalogs[1])
    res = sweep.results[0]
    assert not res.infeasible and not res.nodes
    assert sweep.path == "batched" and sweep.dispatches == 0


def test_sweep_boxes_a_candidates_exception(small_catalogs, monkeypatch):
    """One poisoned serial what-if is returned in its slot; batchmates
    keep their answers."""
    pcat = small_catalogs[1]
    nodes = to_port(_mixed_cluster())
    sched = BatchScheduler(backend="tpu", device="cpu", registry=Registry())
    real_solve = sched.solve

    def poisoned(pods, *a, **kw):
        if any(p.name.startswith("full0-") for p in pods):
            raise RuntimeError("injected what-if failure")
        return real_solve(pods, *a, **kw)

    monkeypatch.setattr(sched, "solve", poisoned)
    _s, sweep = _port_sweep(nodes, [[i] for i in range(len(nodes))], pcat,
                            sched=sched)
    assert isinstance(sweep.results[6], RuntimeError)
    assert not isinstance(sweep.results[7], BaseException)
    assert all(_decision(r) == (True, 0, 0.0) for r in sweep.results[:6])


def test_failed_dispatch_serves_the_chunk_serially(small_catalogs,
                                                   monkeypatch):
    pcat = small_catalogs[1]
    nodes = to_port(_sweep_cluster(4, 2))
    sched = BatchScheduler(backend="tpu", device="cpu", registry=Registry())

    def broken(entries):
        raise RuntimeError("injected dispatch fault")

    monkeypatch.setattr(sched._tpu, "solve_many_prepared", broken)
    _s, sweep = _port_sweep(nodes, [[0], [1]], pcat, sched=sched)
    assert sweep.path == "serial" and sweep.dispatches == 0
    assert all(_decision(r) == (True, 0, 0.0) for r in sweep.results)


def test_sweep_serial_on_the_oracle_backend(small_catalogs):
    nodes = to_port(_sweep_cluster(5, 2))
    reg = Registry()
    sched = BatchScheduler(backend="oracle", device="cpu", registry=reg)
    _s, sweep = _port_sweep(nodes, [[0], [1]], small_catalogs[1],
                            sched=sched, registry=reg)
    assert sweep.path == "serial" and sweep.dispatches == 0
    assert all(not isinstance(r, BaseException) for r in sweep.results)


def test_sweep_entries_run_through_solve_many_prepared(small_catalogs):
    """``build_sweep_entries``' entries carry exactly what the port's
    ``solve_many_prepared`` reads, and one chunk is one dispatch."""
    pcat = small_catalogs[1]
    nodes = to_port(_sweep_cluster(20, 4))
    sched = BatchScheduler(backend="tpu", device="cpu", registry=Registry())
    calls = []
    real = sched._tpu.solve_many_prepared

    def spy(entries):
        calls.append(len(entries))
        for e in entries:
            assert {"r", "np_consts", "feas", "np_init", "dims",
                    "NE"} <= set(e)
        return real(entries)

    sched._tpu.solve_many_prepared = spy
    cands = [[i] for i in range(20)]
    _s, sweep = _port_sweep(nodes, cands, pcat, sched=sched)
    assert calls == [cons.SWEEP_MAX_SLOTS, 20 - cons.SWEEP_MAX_SLOTS]
    assert sweep.dispatches == 2 and sweep.path == "batched"
    serial = _serial(sched, nodes, pcat)
    assert [_decision(r) for r in sweep.results] \
        == [_decision(r) for r in serial]
