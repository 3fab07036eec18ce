"""The port's multi-process serving against the reference package's, on the
CPU: the slot-ownership map, the per-host fence's read accessor, the
cross-host forwarding shim and a real two-process ``torch.distributed``
job over gloo.

The ownership helpers are pure functions: both packages get the same
per-device rank lists and must return the same tuples.  The forwarding
shim's cases are the reference's ``TestForwarder`` and ``TestZeroInit``,
each run over both packages (a fake transport stands in for the fleet).
The two-process job is the reference's 2-process dryrun in the port:
2 CPU ranks x 2 entries (``scripts/dryrun_multihost_torch.py`` through the
port's ``launch_workers``), each asserting the host-major layout on the
real ranks, a fence read of exactly 1/2 of the
whole batch, ``SlotNotOwned`` for every foreign slot naming its owner,
owned plans equal to serial solves, and one foreign slot forwarded over
gRPC to its owner's ``SolverService``.

Tolerance: equal tuples, equal byte counts, equal node plans.
"""

import threading
import types
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import karpenter_tpu.metrics as ref_metrics
import karpenter_tpu.parallel.forward as ref_forward
import karpenter_tpu.parallel.mesh as ref_mesh
import karpenter_tpu.service.server as ref_server
import karpenter_tpu.solver.scheduler as ref_scheduler
import karpenter_tpu_torch.metrics as t_metrics
import karpenter_tpu_torch.parallel.distributed as t_dist
import karpenter_tpu_torch.parallel.forward as t_forward
import karpenter_tpu_torch.parallel.mesh as t_mesh
import karpenter_tpu_torch.service.server as t_server
import karpenter_tpu_torch.solver.scheduler as t_scheduler
import karpenter_tpu_torch.solver.tpu as t_tpu
from karpenter_tpu_torch.models.tensorize import tensorize as t_tensorize
from scripts import dryrun_multihost_torch as dryrun

torch.set_num_threads(1)

REF = types.SimpleNamespace(
    name="ref", metrics=ref_metrics, forward=ref_forward, server=ref_server,
    scheduler=ref_scheduler)
PORT = types.SimpleNamespace(
    name="port", metrics=t_metrics, forward=t_forward, server=t_server,
    scheduler=t_scheduler)
BOTH = pytest.mark.parametrize("k", [REF, PORT], ids=["ref", "port"])


def port_mesh(n: int):
    return t_mesh.make_mesh(devices=["cpu"] * n)


def plan(res) -> list:
    return sorted(
        (n.instance_type, n.zone, n.capacity_type, round(n.price, 6),
         tuple(sorted(p.name for p in n.pods)))
        for n in res.nodes)


# ---------------------------------------------------------------------------
# the ownership map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("procs, n_slots", [
    ([0, 0, 1, 1], 8), ([0, 1, 2], 3), ([0, 1], 4), ([0] * 8, 8),
    ([0, 0, 0, 0, 1, 1, 1, 1], 32), ([0, 1, 1, 2], 4)])
def test_owner_blocks_are_the_reference(procs, n_slots):
    assert t_mesh._owner_blocks(procs, n_slots) \
        == ref_mesh._owner_blocks(procs, n_slots)


@pytest.mark.parametrize("procs, n_slots", [([0, 0, 1], 8), ([0, 1], 3)])
def test_owner_blocks_reject_uneven_division(procs, n_slots):
    with pytest.raises(ValueError) as port_err:
        t_mesh._owner_blocks(procs, n_slots)
    with pytest.raises(ValueError) as ref_err:
        ref_mesh._owner_blocks(procs, n_slots)
    assert str(port_err.value) == str(ref_err.value)


class _Dev:
    def __init__(self, pid, i):
        self.process_index = pid
        self.id = i


def _two_host_meshes(hosts: int, per: int):
    """The same fake multi-host layout in both packages: the reference's
    ``Mesh`` over fake devices, the port's over ``cpu`` entries tagged
    with the same ranks."""
    devs = [_Dev(p, i) for p in range(hosts) for i in range(per)]
    arr = ref_mesh._host_major(devs)
    ref = types.SimpleNamespace(devices=arr, axis_names=("pods", "types"))
    port = t_mesh.Mesh(
        t_mesh._obj_array([torch.device("cpu")] * arr.size, arr.shape),
        ("pods", "types"),
        np.array([d.process_index for d in arr.reshape(-1)]).reshape(
            arr.shape))
    return ref, port


@pytest.mark.parametrize("hosts, per, n_slots", [
    (2, 4, 8), (2, 4, 16), (2, 1, 8), (4, 2, 8), (1, 8, 8)])
def test_slot_hosts_and_local_ranges_are_the_reference(hosts, per, n_slots):
    ref, port = _two_host_meshes(hosts, per)
    assert t_mesh.slot_hosts(port, n_slots) \
        == ref_mesh.slot_hosts(ref, n_slots)
    for pid in range(hosts + 1):
        assert t_mesh.local_slot_range(port, n_slots, process_index=pid) \
            == ref_mesh.local_slot_range(ref, n_slots, process_index=pid)
    assert t_mesh.multihost(port) == ref_mesh.multihost(ref) == (hosts > 1)
    assert t_mesh.mesh_signature(port) == ref_mesh.mesh_signature(ref)


def test_single_process_mesh_owns_everything():
    mesh = port_mesh(8)
    ref = ref_mesh.make_mesh(8)
    assert not t_mesh.multihost(mesh) and not ref_mesh.multihost(ref)
    assert t_mesh.slot_hosts(mesh, 8) == ref_mesh.slot_hosts(ref, 8) \
        == (0,) * 8
    assert t_mesh.local_slot_range(mesh, 8) == (0, 8)
    assert t_mesh.local_slot_range(mesh, 8, process_index=7) == (0, 0)
    assert t_mesh.mesh_signature(mesh) == ref_mesh.mesh_signature(ref) \
        == (("pods", 4), ("types", 2))
    assert t_mesh.mesh_signature(None) == ref_mesh.mesh_signature(None) == ()


# ---------------------------------------------------------------------------
# the per-host fence
# ---------------------------------------------------------------------------


def test_shard_reads_match_whole_read():
    """``local_only`` (per-shard) and whole reads return identical rows
    on one process, and the byte accounting is honest (read == total)."""
    mesh = port_mesh(8)
    arrs = [
        t_dist.put_sharded(np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
                           t_mesh.slot_sharding(mesh)),
        t_dist.put_sharded(np.arange(8, dtype=np.int32),
                           t_mesh.slot_sharding(mesh)),
        torch.arange(16, dtype=torch.int64).reshape(8, 2),
    ]
    rows_l, read_l, total_l = t_tpu.read_slot_rows(arrs, local_only=True)
    rows_w, read_w, total_w = t_tpu.read_slot_rows(arrs, local_only=False)
    assert total_l == total_w == 8 * 3 * 4 + 8 * 4 + 16 * 8
    assert read_l == total_l and read_w == total_w
    for rl, rw in zip(rows_l, rows_w):
        assert sorted(rl) == sorted(rw) == list(range(8))
        for s in rl:
            assert np.array_equal(rl[s], rw[s])


def _tenants(n: int):
    parts = [dryrun.scenario_parts(48, tenant=f"mh{i}") for i in range(n)]
    return [t_tensorize(p, parts[0][1], parts[0][2]) for p, _pv, _c in parts]


def test_meshed_handle_accounts_fence_bytes():
    mesh = port_mesh(8)
    st = _tenants(1)[0]
    reg = t_metrics.Registry()
    handle = t_tpu.TpuSolver(device="cpu").solve_many_async(
        [dict(st=st)], mesh=mesh, registry=reg)
    outs = handle.results()
    assert not isinstance(outs[0], Exception), outs[0]
    assert handle.B_pad == 8
    assert handle.owned_slots == (0, handle.B_pad)
    assert handle.fence_bytes_read == handle.fence_bytes_total > 0
    c = reg.counter(t_metrics.MULTIHOST_FENCE_BYTES)
    assert c.get({"scope": "read"}) == float(handle.fence_bytes_read)
    assert c.get({"scope": "whole"}) == float(handle.fence_bytes_total)


def test_kill_switch_whole_read_gives_the_same_slots(monkeypatch):
    mesh = port_mesh(8)
    reqs = [dict(st=st) for st in _tenants(2)]
    solver = t_tpu.TpuSolver(device="cpu")
    on = solver.solve_many_async(reqs, mesh=mesh).results()
    monkeypatch.setenv("KT_MULTIHOST", "0")
    off_handle = solver.solve_many_async(reqs, mesh=mesh)
    off = off_handle.results()
    assert off_handle.fence_bytes_read == off_handle.fence_bytes_total
    for a, b in zip(on, off):
        assert plan(a.result) == plan(b.result)
        assert a.result.infeasible == b.result.infeasible


def test_foreign_slots_are_typed_with_their_owner(monkeypatch):
    """A mesh whose second half belongs to rank 1, seen from rank 0: only
    rank 0's blocks are enqueued and read (exactly half the bytes), and
    the other slots come back ``SlotNotOwned`` naming rank 1."""
    devs = t_mesh._obj_array([torch.device("cpu")] * 4, (2, 2))
    mesh = t_mesh.Mesh(devs, ("pods", "types"), [[0, 0], [1, 1]])
    reg = t_metrics.Registry()
    sts = _tenants(6)
    solver = t_tpu.TpuSolver(device="cpu")
    handle = solver.solve_many_async([dict(st=st) for st in sts],
                                     min_slots=8, mesh=mesh, registry=reg)
    outs = handle.results()
    assert handle.B_pad == 8 and handle.owned_slots == (0, 4)
    assert handle.fence_bytes_read * 2 == handle.fence_bytes_total
    for i, out in enumerate(outs):
        if i < 4:
            assert plan(out.result) == plan(solver.solve(sts[i]).result)
        else:
            assert isinstance(out, t_forward.SlotNotOwned)
            assert (out.slot, out.owner) == (i, 1)
    slots = reg.counter(t_metrics.MULTIHOST_SLOTS)
    assert slots.get({"ownership": "owned"}) == 4
    assert slots.get({"ownership": "foreign"}) == 2


# ---------------------------------------------------------------------------
# the forwarding shim (the reference's TestForwarder / TestZeroInit)
# ---------------------------------------------------------------------------


@BOTH
def test_disabled_shim_raises_typed_and_counts(k):
    reg = k.metrics.Registry()
    fwd = k.forward.ResultForwarder(peers=[], registry=reg, enabled=False)
    fwd.zero_init()
    with pytest.raises(k.forward.SlotNotOwned):
        fwd.forward({}, k.forward.SlotNotOwned(3, 1))
    assert reg.counter(k.metrics.MULTIHOST_FORWARDS).get(
        {"outcome": "unrouted"}) == 1.0


@BOTH
def test_fake_transport_routes_to_owner_endpoint(k):
    reg = k.metrics.Registry()
    calls = []

    def transport(endpoint, kwargs):
        calls.append((endpoint, sorted(kwargs)))
        return "owner-result"

    fwd = k.forward.ResultForwarder(peers=["hostA:1", "hostB:2"],
                                    registry=reg, transport=transport)
    assert fwd.enabled()
    assert fwd.forward({"pods": []}, k.forward.SlotNotOwned(5, 1)) \
        == "owner-result"
    assert calls == [("hostB:2", ["pods"])]
    assert reg.counter(k.metrics.MULTIHOST_FORWARDS).get(
        {"outcome": "forwarded"}) == 1.0


@BOTH
def test_transport_failure_counts_error(k):
    reg = k.metrics.Registry()

    def transport(endpoint, kwargs):
        raise RuntimeError("owner died")

    fwd = k.forward.ResultForwarder(peers=["a:1"], registry=reg,
                                    transport=transport)
    with pytest.raises(RuntimeError):
        fwd.forward({}, k.forward.SlotNotOwned(0, 0))
    assert reg.counter(k.metrics.MULTIHOST_FORWARDS).get(
        {"outcome": "error"}) == 1.0


@BOTH
def test_unroutable_owner_surfaces_typed(k):
    reg = k.metrics.Registry()
    fwd = k.forward.ResultForwarder(peers=["a:1"], registry=reg)
    assert fwd.enabled()
    err = k.forward.SlotNotOwned(2, 4)
    with pytest.raises(k.forward.SlotNotOwned) as info:
        fwd.forward({}, err)
    assert info.value is err
    assert reg.counter(k.metrics.MULTIHOST_FORWARDS).get(
        {"outcome": "unrouted"}) == 1.0


@BOTH
def test_env_peers_parsing(k, monkeypatch):
    monkeypatch.setenv("KT_MULTIHOST_PEERS", "h0:50151, h1:50151")
    fwd = k.forward.ResultForwarder()
    assert fwd.peers == ["h0:50151", "h1:50151"]
    assert fwd.enabled()
    assert fwd.endpoint_of(1) == "h1:50151"
    assert fwd.endpoint_of(7) is None
    monkeypatch.setenv("KT_MULTIHOST_FORWARD", "0")
    assert not k.forward.ResultForwarder().enabled()


class _Sched:
    backend = "oracle"


class _Result:
    solve_ms = 0.0


def _pending(k, slot, owner):
    class _Pending:
        def result(self):
            raise k.forward.SlotNotOwned(slot, owner)

    return _Pending()


@BOTH
def test_pipeline_routes_foreign_slot_off_thread(k):
    """``_finalize_mega`` hands a ``SlotNotOwned`` outcome to the shim and
    the RPC future resolves with the owner's result, off the dispatcher
    thread."""
    reg = k.metrics.Registry()
    pipe = k.server.SolvePipeline(_Sched(), registry=reg, max_slots=1)
    served = threading.Event()
    threads = []

    def transport(endpoint, kwargs):
        served.set()
        threads.append(threading.current_thread().name)
        assert endpoint == "owner:1"
        return _Result()

    pipe._forwarder = k.forward.ResultForwarder(
        peers=["me:0", "owner:1"], registry=reg, transport=transport)
    fut = Future()
    try:
        pipe._finalize_mega([(({"pods": []}, fut, 0.0, 0.0),
                              _pending(k, 1, 1))])
        out = fut.result(timeout=10.0)
        assert served.is_set() and isinstance(out, _Result)
        assert threads and threads[0] != threading.current_thread().name
    finally:
        pipe.stop()


@BOTH
def test_pipeline_forwards_admitted_priority_class(k):
    reg = k.metrics.Registry()
    pipe = k.server.SolvePipeline(_Sched(), registry=reg, max_slots=1)
    seen = []
    fwd = k.forward.ResultForwarder(peers=["me:0", "owner:1"], registry=reg,
                                    transport=lambda ep, kw: _Result())
    orig = fwd.forward
    fwd.forward = lambda kw, err, priority="": (
        seen.append(priority), orig(kw, err, priority=priority))[1]
    pipe._forwarder = fwd
    fut = Future()
    try:
        pipe._fwd_pclass[fut] = "critical"
        pipe._finalize_mega([(({"pods": []}, fut, 0.0, 0.0),
                              _pending(k, 1, 1))])
        fut.result(timeout=10.0)
        assert seen == ["critical"]
        assert fut not in pipe._fwd_pclass
    finally:
        pipe.stop()


@BOTH
def test_pipeline_disabled_shim_surfaces_typed_error(k):
    reg = k.metrics.Registry()
    pipe = k.server.SolvePipeline(_Sched(), registry=reg, max_slots=1)
    try:
        assert not pipe._forwarder.enabled()
        fut = Future()
        pipe._finalize_mega([(({"pods": []}, fut, 0.0, 0.0),
                              _pending(k, 2, 1))])
        with pytest.raises(k.forward.SlotNotOwned):
            fut.result(timeout=10.0)
        assert reg.counter(k.metrics.MULTIHOST_FORWARDS).get(
            {"outcome": "unrouted"}) == 1.0
    finally:
        pipe.stop()


@BOTH
def test_multihost_series_exist_from_construction(k):
    reg = k.metrics.Registry()
    k.scheduler.BatchScheduler(backend="oracle", registry=reg,
                               **({"device": "cpu"} if k is PORT else {}))
    m = k.metrics
    assert reg.counter(m.MULTIHOST_UNIFIED).get() == 0.0
    for scope in m.MULTIHOST_FENCE_SCOPES:
        assert reg.counter(m.MULTIHOST_FENCE_BYTES).get(
            {"scope": scope}) == 0.0
    for ownership in m.MULTIHOST_SLOT_OWNERSHIP:
        assert reg.counter(m.MULTIHOST_SLOTS).get(
            {"ownership": ownership}) == 0.0
    assert reg.counter(m.MEGABATCH_FLUSH).get(
        {"reason": "mesh_serial"}) == 0.0


@BOTH
def test_pipeline_zero_inits_forward_outcomes(k):
    reg = k.metrics.Registry()
    pipe = k.server.SolvePipeline(_Sched(), registry=reg, max_slots=1)
    try:
        for outcome in k.metrics.MULTIHOST_FORWARD_OUTCOMES:
            assert reg.counter(k.metrics.MULTIHOST_FORWARDS).get(
                {"outcome": outcome}) == 0.0
    finally:
        pipe.stop()


def test_wire_forward_over_the_ports_client():
    """Without a transport the shim re-sends the request to the owner's
    endpoint over ``SolverClient`` and decodes the owner's answer: here
    an in-process ``SolverService`` on a unix socket, whose plan the
    forwarded one equals."""
    import os
    import tempfile

    from karpenter_tpu_torch.service.client import SolverClient
    from karpenter_tpu_torch.service.codec import (
        decode_response,
        encode_request,
    )
    from karpenter_tpu_torch.solver import types as t_types

    pods, provs, cat = dryrun.scenario_parts(48, tenant="wire")
    sock = os.path.join(tempfile.mkdtemp(), "owner.sock")
    reg = t_metrics.Registry()
    service = t_server.SolverService(
        t_scheduler.BatchScheduler(backend="tpu", device="cpu",
                                   registry=reg), registry=reg)
    server, _ = t_server.make_server(service, host=f"unix:{sock}")
    try:
        fwd = t_forward.ResultForwarder(peers=["unix:/nowhere.sock",
                                               f"unix:{sock}"],
                                        registry=reg)
        with t_types._node_lock:
            t_types._node_next = 1000
        got = fwd.forward(dict(pods=pods, provisioners=provs,
                               instance_types=cat),
                          t_forward.SlotNotOwned(3, 1), priority="critical")
        with t_types._node_lock:
            t_types._node_next = 1000
        client = SolverClient(f"unix:{sock}")
        try:
            own = decode_response(client.solve_raw(
                encode_request(pods, provs, cat)))
        finally:
            client.close()
        assert plan(got) == plan(own) and got.nodes
        assert reg.counter(t_metrics.MULTIHOST_FORWARDS).get(
            {"outcome": "forwarded"}) == 1
        fwd.close()
    finally:
        server.stop(grace=None)
        service.close()


# ---------------------------------------------------------------------------
# a real two-process job
# ---------------------------------------------------------------------------


def test_two_process_per_host_fence_and_forward():
    """2 ranks x 2 CPU entries over gloo (the port's dryrun script through
    ``launch_workers``): host-major layout on the real ranks, the sharded
    single solve agreed by both, the 8-slot megabatch fenced per rank
    (exactly 1/2 of the bytes, contiguous owned range = ``slot_hosts``),
    foreign slots typed with their owner, owned plans equal to serial
    solves, and one foreign slot forwarded over gRPC to its owner.  The
    launcher kills both ranks after 100 s (a typical run takes under 10 s
    here)."""
    reason = t_dist.multiprocess_cpu_support()
    assert reason is None, reason
    recs = dryrun.run(2, 2, device="cpu", timeout=100.0)
    assert [r["pid"] for r in recs] == [0, 1]
    for r in recs:
        assert r["ok"] and r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["mesh"] == {"pods": 2, "types": 2}
        assert r["slots"] == 8 and r["foreign"] == 4
        assert r["read"] * 2 == r["total"] and r["frac"] == 0.5
    assert recs[0]["owned"] == [0, 4] and recs[1]["owned"] == [4, 8]
    assert recs[0]["forward"]["forwarded"]
    assert recs[0]["forward"]["owner"] == 1
    assert recs[0]["nodes"] == recs[1]["nodes"] > 0


def test_launch_dryrun_checks_the_layout_on_real_ranks():
    """``launch_dryrun`` runs the package's own worker: 2 CPU ranks x 2
    entries, each asserting the host-major layout on the real ranks and a
    slot-sharded round trip (each rank holds only its blocks).  Killed
    after 60 s (a typical run takes a few seconds here)."""
    import json

    outs = t_dist.launch_dryrun(2, 2, timeout=60.0, device="cpu")
    recs = [json.loads(ln[len("MHOSTW "):]) for o in outs
            for ln in o.splitlines() if ln.startswith("MHOSTW ")]
    assert [r["pid"] for r in recs] == [0, 1]
    for r in recs:
        assert r["ok"] and r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["mesh"] == {"pods": 2, "types": 2}


@pytest.mark.parametrize("entry", ["initialize", "worker_main",
                                   "launch_dryrun", "dryrun_run"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """A missing device resolves to the card and raises without one: the
    entry points never fall back to the CPU on their own, and raise before
    joining a job or spawning a rank (the card is hidden here, so the case
    holds on any machine)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "initialize": lambda: t_dist.initialize("127.0.0.1:1", 1, 0),
        "worker_main": lambda: t_dist.worker_main(
            ["--coordinator", "127.0.0.1:1", "--num-processes", "1",
             "--process-id", "0"]),
        "launch_dryrun": lambda: t_dist.launch_dryrun(1, 1, timeout=5.0),
        "dryrun_run": lambda: dryrun.run(1, 1, timeout=5.0),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
