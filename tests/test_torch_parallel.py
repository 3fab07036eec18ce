"""The port's device mesh against the reference package's, on the CPU:
``karpenter_tpu_torch.parallel.mesh`` (layout, shardings) and the meshed
solve paths of ``solver/tpu.py`` and ``solver/scheduler.py``.

The reference runs on conftest's 8 virtual CPU devices (``make_mesh(n)``);
the port on ``make_mesh(devices=["cpu"] * n)``.  Both packages get inputs
built from one description (the toy and tenant scenarios below, each the
reference's own, rebuilt from either package's models), and both
packages' node-name counters are reset before each compared solve
(coalescing orders candidates by ``(size, name)``).

Tolerance: mesh shapes, padded dims, signatures and key tuples equal;
node multisets equal and costs within 1e-6 (the reference's own
``test_sharded_matches_unsharded`` tolerance); megabatch plans, assignment
sets and infeasible maps equal.
"""

import logging

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import karpenter_tpu.models.tensorize as ref_tensorize
import karpenter_tpu.parallel.mesh as ref_mesh
import karpenter_tpu.solver.tpu as ref_tpu
import karpenter_tpu.solver.types as ref_types
import karpenter_tpu_torch.metrics as t_metrics
import karpenter_tpu_torch.models.labels as t_labels
import karpenter_tpu_torch.parallel.distributed as t_dist
import karpenter_tpu_torch.parallel.mesh as t_mesh
import karpenter_tpu_torch.solver.scheduler as t_scheduler
import karpenter_tpu_torch.solver.tpu as t_tpu
import karpenter_tpu_torch.solver.types as t_types
from karpenter_tpu_torch.models.tensorize import tensorize as t_tensorize
from scripts import dryrun_multihost_torch as dryrun

torch.set_num_threads(1)


def reset_names() -> None:
    for mod in (ref_types, t_types):
        with mod._node_lock:
            mod._node_next = 0


def port_mesh(n: int):
    return t_mesh.make_mesh(devices=["cpu"] * n)


def node_multiset(res) -> list:
    return sorted((n.instance_type, n.zone, n.capacity_type)
                  for n in res.nodes)


def plan(res) -> list:
    return sorted(
        (n.instance_type, n.zone, n.capacity_type, round(n.price, 6),
         tuple(sorted(p.name for p in n.pods)))
        for n in res.nodes)


def tenant_tensors(pkg: str, n_slots: int, n_pods: int = 48):
    """The reference multi-host dryrun's tenants (``_scenario_parts(48,
    tenant=f"mh{i}")``), built with one package's models."""
    if pkg == "ref":
        parts = [graft._scenario_parts(n_pods, tenant=f"mh{i}")
                 for i in range(n_slots)]
        tz = ref_tensorize.tensorize
    else:
        parts = [dryrun.scenario_parts(n_pods, tenant=f"mh{i}")
                 for i in range(n_slots)]
        tz = t_tensorize
    return [tz(p, parts[0][1], parts[0][2]) for p, _pv, _c in parts]


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, shape", [(2, (2, 1)), (8, (4, 2))])
def test_make_mesh_shapes_match_the_reference(n, shape):
    ref = ref_mesh.make_mesh(n)
    port = port_mesh(n)
    assert ref.devices.shape == port.devices.shape == shape
    assert port.axis_names == ref.axis_names == ("pods", "types")
    assert dict(port.shape) == dict(ref.shape)
    assert port.size == n
    assert all(d == torch.device("cpu") for d in port.devices.reshape(-1))
    assert (port.process_indexes == 0).all()
    # meshes are values: equal layouts compare and hash equal
    assert port == port_mesh(n) and hash(port) == hash(port_mesh(n))


class _Dev:
    def __init__(self, pid, i):
        self.process_index = pid
        self.id = i


@pytest.mark.parametrize("hosts, per", [(2, 4), (4, 2), (1, 8), (3, 2)])
def test_host_major_layout_matches_the_reference(hosts, per):
    devs = [_Dev(p, i) for p in range(hosts) for i in range(per)]
    ref = ref_mesh._host_major(devs)
    port = t_mesh._host_major(devs)
    assert port.shape == ref.shape
    assert [d.id for d in port.reshape(-1)] == [d.id for d in ref.reshape(-1)]
    assert [d.process_index for d in port.reshape(-1)] \
        == [d.process_index for d in ref.reshape(-1)]
    if hosts > 1:
        for row in port:
            assert len({d.process_index for d in row}) == 1


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back"):
        t_mesh.make_mesh(2)
    with pytest.raises(RuntimeError, match="never falls back"):
        t_mesh.make_mesh()
    with pytest.raises(RuntimeError, match="never falls back"):
        t_mesh.make_mesh(3, devices=["cpu"] * 2)
    assert t_mesh.make_mesh(2, devices=["cpu"] * 4).size == 2


def test_slot_mesh_and_cached_shardings():
    mesh = port_mesh(8)
    sm = t_mesh.slot_mesh(mesh)
    assert sm.axis_names == ("slots",) and sm.devices.shape == (8,)
    assert t_mesh.slot_mesh(mesh) is sm
    assert t_mesh.slot_sharding(port_mesh(8)) is t_mesh.slot_sharding(mesh)
    assert t_mesh.axis_sharding(mesh, "pods") is \
        t_mesh.axis_sharding(mesh, "pods")
    # one contiguous slot block per entry, in row-major entry order
    idx = [i for _p, _d, _r, i in
           t_mesh.slot_sharding(mesh).shard_indices((16,))]
    assert [(s.start, s.stop) for (s,) in idx] == [
        (2 * k, 2 * k + 2) for k in range(8)]
    with pytest.raises(ValueError):
        t_mesh.slot_sharding(mesh).shard_indices((12,))


def test_feasibility_shardings_partition_f_into_blocks():
    mesh = port_mesh(8)
    ins, (f_sh, d_sh) = t_mesh.feasibility_shardings(mesh)
    assert set(ins) == set(ref_mesh.feasibility_shardings(
        ref_mesh.make_mesh(8))[0])
    blocks = f_sh.shard_indices((32, 64))
    cover = np.zeros((32, 64), dtype=int)
    for _pos, _dev, _proc, (rs, cs) in blocks:
        assert (rs.stop - rs.start, cs.stop - cs.start) == (8, 32)
        cover[rs, cs] += 1
    assert (cover == 1).all()
    # dom_ok splits over pods only: each row block whole on its row
    for _pos, _dev, _proc, (rs, ds) in d_sh.shard_indices((32, 6)):
        assert (ds.start, ds.stop) == (0, 6) and rs.stop - rs.start == 8


def test_put_sharded_and_replicate_round_trip():
    mesh = port_mesh(8)
    value = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    arr = t_dist.put_sharded(value, t_mesh.slot_sharding(mesh))
    assert arr.nbytes == value.nbytes and len(arr.addressable_shards) == 8
    assert np.array_equal(t_dist.replicate_for_host(mesh, arr), value)
    rep = t_mesh.replicate(mesh, {"a": value, "b": [value[:2]]})
    assert all(np.array_equal(s.data.numpy(), value)
               for s in rep["a"].addressable_shards)
    assert len(rep["b"][0].addressable_shards) == 8


# ---------------------------------------------------------------------------
# the meshed solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a, b", [(2, 1), (4, 2), (8, 1)])
def test_meshed_solve_dims_are_the_reference(a, b):
    ref_st = graft._bench_scenario(2000)
    port_st = dryrun.bench_scenario(2000)
    for nb in (512, 2048):
        ref_d = ref_tpu.solve_dims(ref_st, NE=0, node_budget=nb, a=a, b=b)
        port_d = t_tpu.solve_dims(port_st, NE=0, node_budget=nb, a=a, b=b)
        assert port_d == ref_d
        assert port_d["G"] % a == 0 and port_d["C"] % b == 0
        assert port_d["NR"] % a == 0
    ref_sig = ref_tpu.TpuSolver().signature(
        ref_st, max_nodes=2048, mesh=ref_mesh.make_mesh(a * b))
    port_sig = t_tpu.TpuSolver(device="cpu").signature(
        port_st, max_nodes=2048, mesh=port_mesh(a * b))
    if (a, b) == ref_mesh.make_mesh(a * b).devices.shape:
        assert port_sig == ref_sig


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_matches_unsharded(n_devices):
    """The reference's ``test_sharded_matches_unsharded`` in the port: the
    sharded solve gives the unsharded packing."""
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.models.catalog import generate_catalog

    pods = [PodSpec(name=f"p{i}", requests={"cpu": 1.0},
                    owner_key=f"d{i % 3}") for i in range(40)]
    st = t_tensorize(pods, [Provisioner(name="default").with_defaults()],
                     generate_catalog(full=False))
    solver = t_tpu.TpuSolver(device="cpu")
    solo = solver.solve(st).result
    sharded = solver.solve(st, mesh=port_mesh(n_devices)).result
    assert sharded.n_scheduled == solo.n_scheduled == 40
    assert sharded.infeasible == {}
    assert abs(sharded.new_node_cost - solo.new_node_cost) < 1e-6
    assert node_multiset(sharded) == node_multiset(solo)


@pytest.mark.parametrize("n_devices", [2, 8])
@pytest.mark.parametrize("scenario", ["toy", "bench"])
def test_meshed_solve_matches_the_reference(n_devices, scenario):
    """The port's meshed solve against the reference's meshed solve (and
    the port's unmeshed one) on the same scenario."""
    if scenario == "toy":
        ref_st, port_st, kw = graft._scenario(), dryrun.scenario(), {}
    else:
        ref_st = graft._bench_scenario(2000)
        port_st = dryrun.bench_scenario(2000)
        kw = dict(max_nodes=2048, track_assignments=False)
    reset_names()
    ref = ref_tpu.TpuSolver().solve(
        ref_st, mesh=ref_mesh.make_mesh(n_devices), **kw).result
    reset_names()
    port = t_tpu.TpuSolver(device="cpu").solve(
        port_st, mesh=port_mesh(n_devices), **kw).result
    reset_names()
    solo = t_tpu.TpuSolver(device="cpu").solve(port_st, **kw).result
    assert node_multiset(port) == node_multiset(ref) == node_multiset(solo)
    assert abs(port.new_node_cost - ref.new_node_cost) < 1e-6
    assert port.infeasible == ref.infeasible == {}
    if scenario == "toy":
        assert plan(port) == plan(ref)


def test_sharded_feasibility_equals_the_single_device_blocks():
    st = dryrun.bench_scenario(2000)
    solver = t_tpu.TpuSolver(device="cpu")
    a, b = 4, 2
    np_consts, feas, _init, _dims = solver._host_arrays(
        st, (), node_budget=2048, track_assignments=False, full_nr=False,
        a=a, b=b)
    zk = st.vocab.key_id[t_labels.ZONE]
    ck = st.vocab.key_id[t_labels.CAPACITY_TYPE]
    F, dom = solver._feasibility(feas, np_consts, zk, ck, "cpu")
    Fs, doms = solver._sharded_feasibility(feas, np_consts, zk, ck,
                                           port_mesh(8))
    assert torch.equal(F, Fs) and torch.equal(dom, doms)


# ---------------------------------------------------------------------------
# the sharded megabatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_devices, n_req", [(2, 3), (8, 5), (8, 8)])
def test_sharded_flush_matches_solo_and_the_reference(n_devices, n_req):
    ref_sts = tenant_tensors("ref", n_req)
    port_sts = tenant_tensors("port", n_req)
    reset_names()
    ref_outs = ref_tpu.TpuSolver().solve_many(
        [dict(st=st) for st in ref_sts], mesh=ref_mesh.make_mesh(n_devices))
    reset_names()
    solver = t_tpu.TpuSolver(device="cpu")
    handle = solver.solve_many_async([dict(st=st) for st in port_sts],
                                     mesh=port_mesh(n_devices))
    outs = handle.results()
    assert handle.B_pad == ref_tpu._mega_rung(n_req, n_devices)
    assert handle.B_pad % n_devices == 0
    assert handle.owned_slots == (0, handle.B_pad)
    for i, (r, p) in enumerate(zip(ref_outs, outs)):
        assert plan(p.result) == plan(r.result), i
        assert set(p.result.assignments) == set(r.result.assignments)
        assert p.result.infeasible == r.result.infeasible
        reset_names()
        solo = solver.solve(port_sts[i]).result
        assert node_multiset(p.result) == node_multiset(solo)
        assert set(p.result.assignments) == set(solo.assignments)


def test_sharded_mega_signature_is_the_reference():
    ref_st = tenant_tensors("ref", 1)[0]
    port_st = tenant_tensors("port", 1)[0]
    for slots in (1, 3, 8, 32):
        ref_sig = ref_tpu.TpuSolver().mega_signature(
            ref_st, slots=slots, mesh=ref_mesh.make_mesh(8))
        port_sig = t_tpu.TpuSolver(device="cpu").mega_signature(
            port_st, slots=slots, mesh=port_mesh(8))
        assert port_sig == ref_sig
        assert dict(port_sig)["mesh"] == (("pods", 4), ("types", 2))
    for n_dev, n, want in ((8, 3, 8), (8, 9, 16), (6, 1, 6), (6, 13, 24),
                           (24, 32, 24), (1, 5, 8)):
        assert t_tpu._mega_rung(n, n_dev) == ref_tpu._mega_rung(n, n_dev) \
            == want


@pytest.mark.parametrize("devices, want", [
    (["cpu"] * 4, [4]),
    (["cpu"] * 2 + ["cpu:0"] * 2, [2, 2]),
])
def test_meshed_scheduler_flush_is_one_sharded_dispatch(devices, want):
    """``BatchScheduler(mesh=...).submit_many`` rides one slot-sharded
    megabatch: one block per device's run of mesh entries (four virtual
    shards of one device are one block; two devices two), mesh_serial at
    0, every plan the unmeshed solo plan's; the bucket key carries the
    mesh."""
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    parts = [dryrun.scenario_parts(48, tenant=f"s{i}") for i in range(4)]
    provs, cat = parts[0][1], parts[0][2]
    reg = t_metrics.Registry()
    mesh = t_mesh.make_mesh(devices=devices)
    sched = BatchScheduler(backend="tpu", device="cpu", mesh=mesh,
                           registry=reg)
    blocks = []
    real = sched._tpu._enqueue_entries
    sched._tpu._enqueue_entries = lambda e, *a, **kw: (
        blocks.append(len(e)), real(e, *a, **kw))[1]
    reqs = [dict(pods=p, provisioners=provs, instance_types=cat)
            for p, _pv, _c in parts]
    key = sched.bucket_key(reqs[0])
    assert dict(key)["mesh"] == (("pods", 2), ("types", 2))
    reset_names()
    results = [h.result() for h in sched.submit_many(reqs)]
    assert blocks[:len(want)] == want
    assert reg.counter(t_metrics.MEGABATCH_FLUSH).get(
        {"reason": "mesh_serial"}) == 0
    solo_sched = BatchScheduler(backend="tpu", device="cpu")
    for (p, _pv, _c), res in zip(parts, results):
        reset_names()
        assert node_multiset(res) == node_multiset(
            solo_sched.solve(p, provs, cat))
        assert not res.infeasible


def test_unshardable_mesh_counts_mesh_serial(caplog):
    """64 virtual shards: past the 32-slot ladder (``MEGA_MAX_SLOTS``), so
    the scheduler decides at construction that no sharded megabatch
    exists, bucket_key refuses, and a direct flush is served serially and
    counted once under ``mesh_serial`` (port only: conftest gives the
    reference 8 devices)."""
    parts = [dryrun.scenario_parts(48, tenant=f"u{i}") for i in range(3)]
    provs, cat = parts[0][1], parts[0][2]
    reg = t_metrics.Registry()
    mesh = port_mesh(64)
    with caplog.at_level(logging.INFO, logger="karpenter_tpu_torch"):
        sched = t_scheduler.BatchScheduler(backend="tpu", device="cpu",
                                           mesh=mesh, registry=reg)
    assert sched.mega_unshardable
    assert any("exceeds the 32-slot rung ladder" in r.getMessage()
               for r in caplog.records)
    reqs = [dict(pods=p, provisioners=provs, instance_types=cat)
            for p, _pv, _c in parts]
    assert sched.bucket_key(reqs[0]) is None
    results = [h.result() for h in sched.submit_many(reqs)]
    assert all(not r.infeasible for r in results)
    assert reg.counter(t_metrics.MEGABATCH_FLUSH).get(
        {"reason": "mesh_serial"}) == 1
    # a pipeline-owned flush counts exactly one reason: mesh_serial
    [h.result() for h in sched.submit_many(reqs, flush_reason="full")]
    assert reg.counter(t_metrics.MEGABATCH_FLUSH).get(
        {"reason": "mesh_serial"}) == 2
    assert reg.counter(t_metrics.MEGABATCH_FLUSH).get(
        {"reason": "full"}) == 0
    with pytest.raises(t_tpu.MegaBucketMismatch):
        sched._tpu.solve_many([dict(st=t_tensorize(*parts[0]))], mesh=mesh)


def test_meshed_delta_steps_run_host_local(monkeypatch):
    """A meshed scheduler's displaced-subproblem steps run on the
    host-local programs (mesh=None) and a full re-solve keeps the mesh;
    ``KT_DELTA_LOCAL=0`` keeps the steps on the mesh too."""
    from karpenter_tpu_torch.models.pod import PodSpec

    pods, provs, cat = dryrun.scenario_parts(48, tenant="d")
    mesh = port_mesh(2)
    sched = t_scheduler.BatchScheduler(backend="tpu", device="cpu",
                                       mesh=mesh)
    seen = []
    real = sched._tpu.solve

    def spy(st, **kw):
        seen.append(kw.get("mesh"))
        return real(st, **kw)

    sched._tpu.solve = spy
    base = sched.solve(pods, provs, cat)
    assert seen and all(m is mesh for m in seen)
    added = [PodSpec(name=f"new-{i}", requests={"cpu": 1.0},
                     owner_key="new") for i in range(3)]
    seen.clear()
    out = sched.solve_delta(base, added=added, provisioners=provs,
                            instance_types=cat)
    assert out.mode in ("scan", "host", "noop")
    assert all(m is None for m in seen)
    assert sched.mesh is mesh
    monkeypatch.setenv("KT_DELTA_LOCAL", "0")
    seen.clear()
    sched.solve_delta(out.result, added=[
        PodSpec(name="new-x", requests={"cpu": 1.0}, owner_key="new")],
        provisioners=provs, instance_types=cat)
    assert all(m is mesh for m in seen)
    seen.clear()
    sched.solve_delta(out.result, provisioners=provs, instance_types=cat,
                      force_full=True)
    assert seen and all(m is mesh for m in seen)


def test_meshed_sweep_matches_the_unmeshed_sweep():
    """The consolidation sweep on a meshed scheduler: one sharded dispatch,
    the unmeshed sweep's decisions."""
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.solver import consolidation as cons
    from karpenter_tpu_torch.solver.types import SimNode

    nodes = []
    for i in range(10):
        node = SimNode(
            instance_type="m5.4xlarge", provisioner="default",
            zone="zone-1a", capacity_type="on-demand", price=0.768,
            allocatable={"cpu": 16.0, "memory": 64 * 1024.0 ** 3,
                         "pods": 110.0},
            existing=True, name=f"sw{i}")
        node.stamp_labels()
        for j in range(4 + i % 3):
            node.pods.append(PodSpec(
                name=f"sw{i}-p{j}", requests={"cpu": 0.25 * (1 + j % 3)},
                owner_key=f"d{j % 3}"))
        nodes.append(node)
    cat = generate_catalog(full=False)
    provs = [Provisioner(name="default").with_defaults()]
    cands = [[i] for i in range(6)]

    def sweep(mesh):
        sched = t_scheduler.BatchScheduler(backend="tpu", device="cpu",
                                           mesh=mesh)
        return cons.sweep_what_ifs(sched, nodes, cands, provisioners=provs,
                                   instance_types=cat, max_new=1)

    plain = sweep(None)
    meshed = sweep(port_mesh(8))
    assert meshed.path == plain.path == "batched"
    assert meshed.dispatches == plain.dispatches == 1
    decide = lambda r: (not r.infeasible, len(r.nodes),  # noqa: E731
                        round(r.new_node_cost, 9))
    assert [decide(r) for r in meshed.results] \
        == [decide(r) for r in plain.results]
    # an unshardable mesh sweeps serially
    assert sweep(port_mesh(64)).path == "serial"


def test_meshed_hierarchical_solve_matches_unmeshed(monkeypatch):
    """The hierarchical solve's block waves on a mesh: sharded dispatches
    padded to the blocks' rung, the unmeshed plan."""
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )
    from karpenter_tpu_torch.models.provisioner import Provisioner

    monkeypatch.setenv("KT_HIER_THRESHOLD", "600")
    pods = []
    for d in range(6):
        sel = LabelSelector.of({"app": f"h{d}"})
        for i in range(110):
            pods.append(PodSpec(
                name=f"h{d}-{i}", labels={"app": f"h{d}"},
                requests={"cpu": 0.25 * (1 + d % 4),
                          "memory": (0.5 + d % 3) * 1024.0 ** 3},
                topology_spread=[TopologySpreadConstraint(
                    1, "topology.kubernetes.io/zone", "DoNotSchedule",
                    sel)],
                owner_key=f"h{d}"))
    provs = [Provisioner(name="default").with_defaults()]
    cat = generate_catalog(full=False)
    results = {}
    for name, mesh in (("plain", None), ("mesh", port_mesh(4))):
        sched = t_scheduler.BatchScheduler(backend="tpu", device="cpu",
                                           mesh=mesh)
        sharded = []
        real = sched._tpu._enqueue_sharded
        sched._tpu._enqueue_sharded = lambda p, *a, **kw: (
            sharded.append(len(p)), real(p, *a, **kw))[1]
        reset_names()
        results[name] = (sched.solve(pods, provs, cat), dict(sched.hier_stats),
                         sharded)
    (plain, pst, psh), (meshed, mst, msh) = results["plain"], results["mesh"]
    assert pst and mst, "the batch did not route hierarchically"
    assert not psh and len(msh) == mst["dispatches"] >= 1
    assert all(n % 4 == 0 and n >= mst["blocks"] for n in msh)
    assert plan(meshed) == plan(plain)
    assert meshed.infeasible == plain.infeasible


@pytest.mark.parametrize("n, ask, want", [
    (8, 2, 8), (8, 32, 32), (4, 1, 1), (2, 3, 3), (24, 32, 24), (64, 16, 16)])
def test_pipeline_slot_cap_follows_the_mesh(n, ask, want):
    """``SolvePipeline`` floors a meshed scheduler's flush size at the
    mesh's entry count and caps it at the largest sharded rung (the
    reference's on its 8 virtual devices); a mesh past the ladder keeps
    the asked cap and serves serially."""
    import karpenter_tpu.metrics as ref_metrics
    import karpenter_tpu.service.server as ref_server
    import karpenter_tpu.solver.scheduler as ref_sched
    from karpenter_tpu_torch.service.server import SolvePipeline

    reg = t_metrics.Registry()
    sched = t_scheduler.BatchScheduler(backend="tpu", device="cpu",
                                       mesh=port_mesh(n), registry=reg)
    pipe = SolvePipeline(sched, registry=reg, max_slots=ask)
    try:
        assert pipe.max_slots == want
        assert pipe._mesh_unshardable == (n > t_tpu.MEGA_MAX_SLOTS)
    finally:
        pipe.stop()
    if n <= 8:
        rreg = ref_metrics.Registry()
        rsched = ref_sched.BatchScheduler(
            backend="tpu", registry=rreg, mesh=ref_mesh.make_mesh(n),
            compile_behind=False)
        rpipe = ref_server.SolvePipeline(rsched, registry=rreg,
                                         max_slots=ask)
        try:
            assert rpipe.max_slots == want
        finally:
            rpipe.stop()
