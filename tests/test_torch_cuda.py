"""The port on the CUDA card: each hand-written kernel entry against its plain
PyTorch version, and the hierarchical solve on ``cuda`` against ``cpu``.

Marked ``cuda``; every test skips (from a fixture) where no CUDA device is
present.  The card-side suite runs without the reference package (the
machine with the card has no JAX), so it skips the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Both entries of ``csrc/packed_score.cu`` must be byte-equal to their plain
versions: ``packed_scan_scores`` on random rows, at 65,536 x 1,024 (beyond
L2), at every base-pointer offset mod 16, and past the shared-memory cap
(the unstaged variant); ``price_step_scores`` on the CPU suite's cases
(``chip_smoke.step_cases``) and at every offset.  Both entries of
``csrc/zone_fill.cu`` (``skew_band_fill``, ``water_fill``) must equal their
plain compositions on the card on every row of over 100,000 fuzzed rows,
and a config-2 solve plans the same with them as with the plain bodies,
launching each once per fill call.  The plain-PyTorch device
programs give the same bits on ``cuda`` as on ``cpu``: the relax program
(and its exp) and the consolidation screen.  The controllers' repack loop
makes the same decisions on ``cuda`` as on ``cpu``, and so do the serving
entry points: a megabatch flush, a constrained delta chain, and ``submit``
(never served cold).  The device hang guard latches on a real stall of
the card and recovers only once it drained, an injected hang degrades and
recovers, and a gang-bearing hierarchical batch plans the same on ``cuda``
as on ``cpu``.  The sidecar (``SolverService`` behind ``make_server``)
answers a serving request over gRPC with the plan of a direct ``cuda``
solve, and an ``Operator`` dialing it provisions what an in-process
operator on the card provisions.  The bench's consolidation-sweep probe
(``bench_torch.measure_consolidation_sweep``) makes the serial loop's
decisions in one batched dispatch on the card.  The kernel-library cache
(``KT_JIT_CACHE``): the bench's cold-restart children populate it and
then load from it, and a card warm in a fresh process loads the library
from it without running nvcc.  The whole-solve profile attributes every
kernel of a profiled config-2 solve to a stage, and the hierarchical
demo's contended solve launches the fused entry once per price iteration
and plans as the host does.  The benchmark's hierarchical cell
(``zonespread-100k``) plans node for node the same traced and untraced on
the card, at the CPU tests' 2,000 pods and at its full 100,000, and its
plans keep every guarantee of ``benchmark/reference.py``.  The group
loop's CUDA graphs (``solver/scan_graphs.py``): on the benchmark's cells
the eager first sight, the capture and the replays plan node for node
alike and count the zone fills alike, two unread async results of one
graph keep their own values, and a background warm beside the
foreground's capture and replays plans as eager.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.models.tensorize import pack_feasibility, pack_scores
from karpenter_tpu_torch.solver import hierarchy as hier

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from karpenter_tpu_torch import kernels

    kernels.build(kernels.ALL)
    return torch.device("cuda")


def _packed(f, pr, cuda):
    from karpenter_tpu_torch.kernels import PACKED_SCORE

    before = PACKED_SCORE.launches
    c_k, i_k = hier.packed_scan_scores(f.to(cuda), pr.to(cuda))
    torch.cuda.synchronize()
    assert PACKED_SCORE.launches == before + 1
    c_p, i_p = hier.packed_scan_scores_plain(f.cpu(), pr.cpu())
    assert c_k.cpu().numpy().tobytes() == c_p.numpy().tobytes()
    assert i_k.cpu().numpy().tobytes() == i_p.numpy().tobytes()


@pytest.mark.parametrize("G,C,p", [(5, 7, 0.6), (40, 425, 0.3),
                                   (48, 448, 0.05), (4096, 1024, 0.5),
                                   (3, 1, 0.0), (65536, 1024, 0.5)])
def test_packed_score_kernel_byte_equal_to_plain(cuda, G, C, p):
    rng = np.random.default_rng(G * 7 + C)
    f = torch.from_numpy(pack_feasibility(
        rng.random((G, C), dtype=np.float32) < p))
    price = rng.uniform(0.1, 9.0, size=C).astype(np.float32)
    price[C // 2:] = price[: C - C // 2]
    _packed(f, pack_scores(price), cuda)


@pytest.mark.parametrize("offset", range(16))
def test_both_entries_at_every_row_alignment(cuda, offset):
    # f as a contiguous view at a byte offset into a larger buffer: every
    # row's head, 16-byte body and tail shift with it
    import chip_smoke as cs

    feas, base, prov, lam = cs.step_case(40, 425, 6, 3, "mid", seed=offset)
    G, C = feas.shape
    flat = torch.zeros(G * C + 16, dtype=torch.int8, device=cuda)
    f = flat[offset:offset + G * C].view(G, C)
    f.copy_(torch.from_numpy(pack_feasibility(feas)).to(cuda))
    assert f.is_contiguous() and f.data_ptr() % 16 == offset % 16
    row = pack_scores(hier.price_adjusted(base, prov, lam).min(axis=1))
    _packed(f, row, cuda)
    cs.check_step_entry(f, base, prov, lam)


def test_packed_score_unstaged_beyond_the_shared_memory_cap(cuda):
    C = 120_000  # a staged row of 2 * (C + 8) bytes > 227 KB
    rng = np.random.default_rng(5)
    f = torch.from_numpy(pack_feasibility(rng.random((6, C)) < 0.01))
    price = rng.uniform(0.1, 9.0, size=C).astype(np.float32)
    _packed(f, pack_scores(price), cuda)


def test_price_step_kernel_byte_equal_on_every_case(cuda):
    import chip_smoke as cs

    for name, case in cs.step_cases(large=True).items():
        feas, base, prov, lam = case
        f = torch.from_numpy(pack_feasibility(feas)).to(cuda)
        # raises chip_smoke.SmokeFailure unless byte-equal
        assert cs.check_step_entry(f, base, prov, lam) == 0.0, name


def test_packed_score_rejects_bad_inputs(cuda):
    f = torch.zeros(4, 8, dtype=torch.int8, device=cuda)
    p = torch.zeros(8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        hier.packed_scan_scores(f.to(torch.int32), p)
    with pytest.raises(ValueError):
        hier.packed_scan_scores(f, p[:7])
    with pytest.raises(ValueError):
        hier.packed_scan_scores(f.t(), torch.zeros(4, dtype=torch.bfloat16,
                                                   device=cuda))
    with pytest.raises(ValueError):
        hier.packed_scan_scores(f, p.cpu())


def test_price_step_rejects_bad_inputs(cuda):
    f = torch.zeros(4, 8, dtype=torch.int8, device=cuda)
    base = torch.ones(8, 3, dtype=torch.float32, device=cuda)
    prov = torch.zeros(8, dtype=torch.int32, device=cuda)
    mult = torch.ones(2, dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        hier.price_step_scores(f, base.double(), prov, mult)
    with pytest.raises(TypeError):
        hier.price_step_scores(f, base, prov.long(), mult)
    with pytest.raises(ValueError):
        hier.price_step_scores(f, base[:7], prov, mult)
    with pytest.raises(ValueError):
        hier.price_step_scores(f, base, prov[:7], mult)
    with pytest.raises(ValueError):
        hier.price_step_scores(f, base[:, :0], prov, mult)
    with pytest.raises(ValueError):
        hier.price_step_scores(f, base.t().contiguous().t(), prov, mult)
    with pytest.raises(ValueError):
        hier.price_step_scores(f, base, prov, mult.cpu())
    # odd C: 8 staged copies of (C + 15) // 8 * 8 bf16 past 227 KB
    big = torch.zeros(1, 14_521, dtype=torch.int8, device=cuda)
    with pytest.raises(RuntimeError):
        hier.price_step_scores(
            big, torch.ones(14_521, 1, device=cuda),
            torch.zeros(14_521, dtype=torch.int32, device=cuda), mult)


def test_hierarchical_solve_cuda_matches_cpu(cuda, monkeypatch):
    import chip_smoke as cs
    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=False)
    pods = cs.deployments(6, 60, tag="q")
    monkeypatch.setenv("KT_HIER_THRESHOLD", str(len(pods)))
    out = {dev: cs.limited_solve(dev, pods, catalog) for dev in ("cuda", "cpu")}
    rg, rc = out["cuda"][4], out["cpu"][4]
    assert out["cuda"][2] == out["cpu"][2]
    assert cs.plan(rg) == cs.plan(rc) or cs.placements_tie(rg, rc)
    launches = out["cuda"][7]
    assert launches["price_step_score"] == out["cuda"][5]["price_iters"] >= 1
    assert launches["packed_score"] == 0


def _relax_inputs(n_per, spread_deps=0):
    """The relax program's inputs for a port-built batch (the scan and the
    partition on the host)."""
    import bench_torch as bt
    import chip_smoke as cs
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.solver import relax
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    pods = bt._relax_pods(n_per, spread_deps=spread_deps)
    st = tensorize(pods, [cs.provisioner()], generate_catalog(full=True))
    res = TpuSolver(device="cpu").solve(st).result
    _elig, freed, lifted, seats = relax.eligible_partition(st, res)
    return relax.relax_inputs(st, res, lifted, seats, freed,
                              relax._host_feasibility(st))


@pytest.mark.parametrize("n_per,spread_deps", [(40, 0), (250, 10)])
def test_relax_program_cuda_equals_cpu(cuda, n_per, spread_deps):
    """The relax program's float32 bits do not depend on the device."""
    from karpenter_tpu_torch.solver import relax

    inputs = _relax_inputs(n_per, spread_deps)
    before = relax.RELAX_PROGRAM.get("cuda")
    bx_g, bf_g = relax._run_relax(*inputs, 64, cuda)
    assert relax.RELAX_PROGRAM.get("cuda") == before + 1
    bx_c, bf_c = relax._run_relax(*inputs, 64, "cpu")
    assert bx_g.tobytes() == bx_c.tobytes()
    assert np.float32(bf_g) == np.float32(bf_c)


def test_exp_cuda_equals_cpu(cuda):
    from karpenter_tpu_torch.solver import relax

    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -95.0, 90.0, 1_000_000).astype(np.float32))
    assert relax._exp(x.to(cuda)).cpu().numpy().tobytes() \
        == relax._exp(x).numpy().tobytes()


def test_screen_cuda_equals_cpu(cuda):
    import chip_smoke as cs
    from karpenter_tpu_torch.solver import consolidation as cons

    nodes = cs.config4_fleet(1000)
    rng = np.random.default_rng(4)
    compat = rng.random((1000, 1000)) < 0.02
    subsets = [sorted(rng.choice(1000, size=int(rng.integers(1, 4)),
                                 replace=False).tolist()) for _ in range(300)]
    for args in ((nodes, [[i] for i in range(1000)], ~np.eye(1000, dtype=bool),
                  8), (nodes, subsets, compat, 16)):
        before = cons.SCREEN_PROGRAM.get("cuda")
        g = cons.screen_subset_deletes(*args[:3], pmax_total=args[3],
                                       device=cuda)
        assert cons.SCREEN_PROGRAM.get("cuda") == before + 1
        c = cons.screen_subset_deletes(*args[:3], pmax_total=args[3],
                                       device="cpu")
        assert g.deletable.tolist() == c.deletable.tolist()


def test_repack_controllers_cuda_equals_cpu(cuda):
    """The controllers' repack loop (chip_smoke phase 9(c)'s, here at 60
    nodes): the same actions, final cluster and bindings on ``cuda`` as on
    ``cpu``, with the screen run on the card."""
    from karpenter_tpu_torch import repack
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.solver import consolidation as cons

    catalog = generate_catalog(full=True)
    runs = {}
    for dev in ("cuda", "cpu"):
        repack.reset_name_counters()
        cons.SCREEN_PROGRAM.reset()
        state, info, keys = repack.repack_to_convergence(catalog, 60,
                                                         "auto", dev)
        assert repack.cluster_faults(state) == []
        assert info["pending_end"] == 0
        assert info["final_cost"] < info["initial_cost"]
        assert cons.SCREEN_PROGRAM.get(dev) >= 1
        runs[dev] = (keys, repack.cluster_plan(state), dict(state.bindings))
    assert runs["cuda"] == runs["cpu"]


def test_serving_flush_cuda_equals_cpu(cuda):
    """A flush of 8 serving requests (chip_smoke phase 10's requests): the
    same plans on ``cuda`` as on ``cpu``, none served cold."""
    import bench_torch as bt
    import chip_smoke as cs
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    catalog = generate_catalog(full=False)
    provs = [cs.provisioner()]
    clients = [bt._serving_pods(c) for c in range(8)]
    runs = {}
    for dev in ("cuda", "cpu"):
        sched = BatchScheduler(backend="auto", device=dev)
        res, _ms = cs.flush(sched, clients, provs, catalog)
        assert not any(r.served_cold or r.infeasible for r in res)
        runs[dev] = [cs.plan(r) for r in res]
    assert runs["cuda"] == runs["cpu"]


def test_constrained_delta_chain_cuda_equals_cpu(cuda):
    """A 10-step ``BatchScheduler.solve_delta`` chain whose adds are
    zone-spread deployments (the scan tier on the device backend): the
    same modes and final cluster on ``cuda`` as on ``cpu``."""
    import chip_smoke as cs

    runs = {}
    for dev in ("cuda", "cpu"):
        modes, res, _walls, _base = cs.constrained_chain(dev, 2000, 10)
        cs.check_seated(res, 2000)
        runs[dev] = (modes, cs.chain_snapshot(res))
    assert "scan" in runs["cuda"][0]
    assert runs["cuda"] == runs["cpu"]


def test_submit_on_cuda_never_served_cold(cuda):
    """``submit`` on a ``cuda`` scheduler serves a first-seen signature on
    the card: no result is served cold and no cold fallback is counted."""
    import bench_torch as bt
    import chip_smoke as cs
    from karpenter_tpu_torch.metrics import SOLVER_COLD_FALLBACKS, Registry
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    catalog = generate_catalog(full=False)
    reg = Registry()
    sched = BatchScheduler(backend="auto", registry=reg)
    for c in range(3):
        pods = bt._serving_pods(c, n_groups=4 + 2 * c)
        res = sched.submit(pods, [cs.provisioner()], catalog).result()
        assert not res.served_cold and not res.infeasible
    assert sum(reg.counter(SOLVER_COLD_FALLBACKS).values.values()) == 0


def test_guard_real_stall_latches_until_drained(cuda):
    """A guarded call that spins the card past the guard's deadline raises
    DeviceHang and latches the tier; the probe, an op on the same card,
    reports healthy only after the stall drained."""
    import chip_smoke as cs

    out = cs.real_stall(stall_s=3.0, timeout_s=1.0)
    assert out["events"] == [False, True]
    assert out["healthy_after_s"] >= out["stall_drained_s"] - 0.05


def test_gang_hierarchical_batch_cuda_matches_cpu(cuda):
    """A gang-bearing hierarchical batch under a binding limit plans the
    same on ``cuda`` as on ``cpu``, every gang all or none."""
    import chip_smoke as cs

    out = cs.gang_hier_parity(nd=6, per=60, n_gangs=2)
    assert out["plans_equal"] or out["placements_tie"]
    assert {"doomed", "short"} <= set(out["retracted"])


def test_injected_hang_degrades_and_recovers_on_cuda(cuda):
    """device_hang@fence on a fresh ``auto`` scheduler: a host tier serves
    the batch, the guard latches, the probe recovers, and the next solve
    equals an unfaulted one."""
    import chip_smoke as cs

    out = cs.injected_hang()
    assert out["device_hangs"] == 1 and out["recovered_equals_unfaulted"]


def test_solver_service_round_trip_on_cuda(cuda, tmp_path):
    """The port's sidecar on the card: ``SolverService()`` builds a
    ``cuda`` scheduler, and a serving request sent through
    ``make_server`` on a unix socket comes back with the plan a direct
    ``cuda`` solve gives; ``Health`` reports the card."""
    import grpc

    import bench_torch as bt
    import chip_smoke as cs
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.service import codec
    from karpenter_tpu_torch.service import solver_pb2 as pb
    from karpenter_tpu_torch.service.server import (
        SERVICE,
        SolverService,
        make_server,
    )
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    catalog = generate_catalog(full=False)
    pods = bt._serving_pods(0)
    service = SolverService()
    assert service.scheduler.device.type == "cuda"
    address = f"unix:{tmp_path}/solver.sock"
    server, _ = make_server(service, host=address)
    channel = grpc.insecure_channel(address)
    try:
        solve = channel.unary_unary(
            f"/{SERVICE}/Solve",
            request_serializer=pb.SolveRequest.SerializeToString,
            response_deserializer=pb.SolveResponse.FromString)
        health = channel.unary_unary(
            f"/{SERVICE}/Health",
            request_serializer=pb.HealthRequest.SerializeToString,
            response_deserializer=pb.HealthResponse.FromString)
        h = health(pb.HealthRequest(), timeout=60.0)
        cs.names_from()
        resp = solve(codec.encode_request(pods, [cs.provisioner()], catalog),
                     timeout=300.0)
    finally:
        channel.close()
        server.stop(0)
        service.close()
    assert (h.ok, h.backend) == (True, "cuda") and h.devices >= 1
    cs.names_from()
    direct = BatchScheduler(backend="auto").solve(pods, [cs.provisioner()],
                                                  catalog)
    got = codec.decode_response(resp)
    assert cs.plan(got) == cs.plan(direct)
    assert got.assignments == direct.assignments and not got.infeasible


def test_remote_operator_round_trip_against_a_cuda_sidecar(cuda, tmp_path):
    """The deployed topology in one process: an ``Operator`` whose
    ``RemoteScheduler`` dials a ``SolverService`` on the card provisions
    a zone-spread batch with the plan an in-process operator on the card
    makes, with no local fallback solve."""
    import bench_torch as bt
    import chip_smoke as cs
    from karpenter_tpu_torch.cloud.fake import FakeCloudProvider
    from karpenter_tpu_torch.metrics import REMOTE_FALLBACK_SOLVES, Registry
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.service.server import SolverService, make_server
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.utils.clock import FakeClock

    catalog = generate_catalog(full=False)
    pods = bt._serving_pods(0)
    service = SolverService(BatchScheduler(backend="tpu"))
    assert service.scheduler.device.type == "cuda"
    address = f"unix:{tmp_path}/solver.sock"
    server, _ = make_server(service, host=address)

    def provision(**kw):
        clock = FakeClock()
        reg = Registry()
        op = Operator(FakeCloudProvider(catalog, clock=clock), clock=clock,
                      registry=reg, scheduler_backend="tpu", **kw)
        try:
            op.state.apply_provisioner(cs.provisioner())
            for p in pods:
                op.state.add_pod(p)
            cs.names_from()
            for _ in range(3):
                op.tick()
                clock.advance(1.5)
            nodes = sorted((ns.node.instance_type, ns.node.zone,
                            ns.node.capacity_type,
                            tuple(sorted(p.name for p in ns.node.pods)))
                           for ns in op.state.nodes.values())
            return (nodes, len(op.state.pending_pods()),
                    reg.counter(REMOTE_FALLBACK_SOLVES).get())
        finally:
            op.shutdown()

    try:
        remote = provision(solver_address=address)
    finally:
        server.stop(0)
        service.close()
    local = provision()
    assert remote[1] == 0 and remote[2] == 0.0
    assert remote[:2] == local[:2]


def test_virtual_mesh_on_the_card_matches_unmeshed(cuda):
    """Eight virtual shards on ``cuda:0`` (shape (4, 2)): the sharded single
    solve and the slot-sharded megabatch give the unmeshed plans."""
    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.parallel.mesh import make_mesh
    from karpenter_tpu_torch.solver.tpu import TpuSolver
    from scripts.dryrun_multihost_torch import (
        plan_of,
        scenario,
        scenario_parts,
    )

    import chip_smoke as cs

    mesh = make_mesh(devices=["cuda:0"] * 8)
    assert mesh.shape == {"pods": 4, "types": 2}
    solver = TpuSolver()
    cs.names_from()
    solo = solver.solve(scenario()).result
    cs.names_from()
    meshed = solver.solve(scenario(), mesh=mesh).result
    assert plan_of(meshed) == plan_of(solo) and not meshed.infeasible
    parts = [scenario_parts(48, tenant=f"c{i}") for i in range(8)]
    sts = [tensorize(p, parts[0][1], parts[0][2]) for p, _pv, _c in parts]
    cs.names_from()
    outs = solver.solve_many([dict(st=st) for st in sts], mesh=mesh)
    for st, out in zip(sts, outs):
        cs.names_from()
        assert cs.node_types(out.result) == cs.node_types(
            solver.solve(st).result)


def test_make_mesh_past_the_cards_raises(cuda):
    """Asking for more cards than the machine has raises; the mesh never
    falls back to the CPU."""
    from karpenter_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    assert make_mesh(n).size == n
    with pytest.raises(RuntimeError, match="never falls back"):
        make_mesh(n + 1)


def test_bench_sweep_probe_on_cuda(cuda):
    """``bench_torch.measure_consolidation_sweep`` on the card at a small
    size: the batched sweep is one dispatch and its decisions equal the
    serial what-if loop's."""
    import bench_torch as bt

    rec = bt.measure_consolidation_sweep(4, n_nodes=40, pairs=1, device=cuda)
    assert rec["sweep_decisions_match"] is True
    assert rec["sweep_path"] == "batched" and rec["sweep_dispatches"] == 1
    assert not any("diverged" in f for f in
                   bt.check_budgets(rec).get("budget_flags", []))


def test_cold_restart_children_populate_then_load_the_cache(cuda):
    """``bench_torch.measure_cold_restart`` on the card: the first fresh
    process runs nvcc into its ``KT_JIT_CACHE`` directory, the second and
    the two concurrent ones load the library from it and come in under
    the first; no child launches a kernel during its warm."""
    import bench_torch as bt
    from karpenter_tpu_torch import kernels

    launches = {}
    rec = bt.measure_cold_restart(cuda, launches=launches)
    assert rec["cold_restart_cache_populated"] is True
    assert rec["cold_restart_second_ms"] < rec["cold_restart_first_ms"]
    assert rec["cold_restart_fleet_ms"] < rec["cold_restart_first_ms"]
    assert rec["cold_restart_fleet_replicas"] == 2
    assert rec["cold_restart_nvcc_s"] > 0
    assert rec["cold_restart_load_s"] is not None
    # the warm's zone-spread profile runs zoned group steps on the card,
    # and each launches the zone fills (csrc/zone_fill.cu)
    price_loop = ("packed_score", "price_step_score")
    assert set(launches) == {k.name for k in kernels.ALL}
    assert {k: launches[k] for k in price_loop} == dict.fromkeys(price_loop, 0)


_CACHED_WARM = """
import json
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.models.catalog import generate_catalog
from karpenter_tpu_torch.models.provisioner import Provisioner
from karpenter_tpu_torch.solver.scheduler import BatchScheduler
sched = BatchScheduler(backend="tpu", device="cuda")
sched.precompile_buckets([Provisioner(name="default").with_defaults()],
                         generate_catalog(full=False),
                         profiles=((2, 8, False),), mega_slots=(), wait=True)
sched.stop_warms()
print(json.dumps({lib.name: [lib.build_s, lib.load_s, lib.handle is not None,
                             str(lib.library_path())]
                  for lib in kernels.libraries()}))
"""


def test_a_card_warm_loads_the_library_from_the_cache(cuda, tmp_path):
    """A fresh process whose ``KT_JIT_CACHE`` holds the library (copied
    from this process's build) loads it in its warm and runs no nvcc."""
    import json
    import os
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    from karpenter_tpu_torch import kernels

    for lib in kernels.libraries():
        shutil.copy(lib.library_path(), tmp_path / lib.library_path().name)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, KT_JIT_CACHE=str(tmp_path), PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", _CACHED_WARM], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for lib in kernels.libraries():
        build_s, load_s, loaded, path = got[lib.name]
        assert build_s is None and load_s is not None and loaded
        assert Path(path).parent == tmp_path


def test_profile_attributes_every_kernel_to_a_stage_on_the_card(cuda):
    """``scripts/profile_solve_torch.py`` on a 2,000-pod cut of config 2:
    every kernel of the profiled solve attributed through its runtime
    launch call, the launches counted under ``device_execute`` (its
    ``device_enqueue``, and inside it ``scan.replay``: the profiled solve
    is the signature's third, so one graph launch makes its group loop's
    kernels), the named stages covering the wall, the stage clock
    anchored."""
    from scripts import profile_solve_torch as ps

    doc = ps.measure_solve(None, pods_n=2000, repeats=1, trace_dir=None)
    table = doc["stages"]
    rows = {r["stage"]: r for r in table["stages"]}
    assert doc["device"].startswith("cuda") and doc["launches"] > 0
    assert table["attributed_by"]["own"] == 0
    assert sum(r["launches"] for r in rows.values()) == doc["launches"]
    solve_rows = {k: r for k, r in rows.items()
                  if k.split(" > ")[-1] in ("device_execute", "device_enqueue",
                                            "device_readback", "scan.replay")
                  or k.split(" > ")[-1].startswith("step.")}
    assert sum(r["launches"] for r in solve_rows.values()) > 0
    assert sum(r["launches"] for k, r in solve_rows.items()
               if k.split(" > ")[-1] == "scan.replay") > 0
    assert table["covered"] >= 0.9 and table["profiled_covered"] >= 0.9
    assert abs(table["clock_check_ms"]) < 5.0


def test_hier_demo_contended_solve_on_the_card_matches_cpu(cuda):
    """``scripts/hier_demo_torch.py``'s contended solve on the card: one
    ``price_step_scores`` launch per price iteration, and the plan of the
    same batch solved on the host from the same node-name counter."""
    from scripts import fuzz_sweep_torch as fz
    from scripts import hier_demo_torch as hd

    run = hd.run(device=None, nd=4, per=500, verbose=False)
    stats = run["stats"]
    assert stats["price_iters"] >= 1
    launches = run["launches"]
    assert {k: launches[k] for k in ("packed_score", "price_step_score")} \
        == {"packed_score": 0, "price_step_score": stats["price_iters"]}
    cpu, _stats = hd.contended("cpu", run["pods"], run["limit_cpu"],
                               run["names_at"])
    assert fz.same_plan(run["result"], cpu)


# ---- the zone fills (csrc/zone_fill.cu) ------------------------------------


@pytest.mark.parametrize("Z", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("lead", [(), (1,), (32,), (4, 8)],
                         ids=["row", "1", "32", "4x8"])
def test_zone_fills_equal_the_plain_composition(cuda, lead, Z):
    """Both fill entries, one launch each, equal to their plain PyTorch
    compositions on the card on every row: ties, ineligible zones, zero
    totals, fractional band headroom, skew at BIG, BIG / 1e9 caps."""
    import chip_smoke as cs

    for draw in range(8):
        cs.check_fill_entries(cs.fill_case(lead, Z, seed=97 * Z + draw))


def test_zone_fills_over_100k_fuzzed_rows(cuda):
    import chip_smoke as cs

    rows = sum(cs.check_fill_entries(cs.fill_case((cs.FILL_BULK,), Z,
                                                  seed=11 + Z))
               for Z in cs.FILL_ZONES)
    assert rows >= 100_000


def test_zone_fills_take_any_layout_and_dtype(cuda):
    """Broadcast, non-contiguous, integer and non-bool inputs are made
    float32 / bool and dense by the wrapper, as the plain bodies take
    them."""
    from karpenter_tpu_torch.ops import masks

    rng = np.random.default_rng(3)
    cur = torch.from_numpy(rng.integers(0, 5, (6, 3)).astype(np.int32))
    cap = torch.full((3, 6), 7.0).t()  # non-contiguous [6, 3]
    rows = torch.tensor([2.0, 0.0, 1.0])  # broadcast over the rows
    total = torch.from_numpy(rng.integers(0, 9, 6).astype(np.int64))
    skew = torch.tensor(1.0)
    el = torch.from_numpy(rng.random((6, 3)) < 0.8)
    args = [t.to(cuda) for t in (cur, rows, cap, total, skew, el)]
    got = masks.skew_band_fill(*args)
    want = masks.skew_band_fill_plain(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    got = masks.water_fill(args[0], args[2], args[3], args[5])
    assert torch.equal(got, masks.water_fill_plain(args[0], args[2], args[3],
                                                   args[5]))
    empty = masks.water_fill(*(torch.zeros(0, 3, device=cuda),) * 2,
                             torch.zeros(0, device=cuda),
                             torch.zeros(0, 3, dtype=torch.bool, device=cuda))
    assert empty.shape == (0, 3) and empty.dtype == torch.int32


def _config2_plan(monkeypatch, plain: bool):
    import bench_torch as bt
    import chip_smoke as cs
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.ops import masks
    from karpenter_tpu_torch.solver import tpu
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    with monkeypatch.context() as m:
        if plain:
            for mod in (masks, tpu):
                m.setattr(mod, "skew_band_fill", masks.skew_band_fill_plain)
                m.setattr(mod, "water_fill", masks.water_fill_plain)
        pods, provs, catalog = bt.build_scenario()
        sched = BatchScheduler(backend="tpu", compile_behind=False,
                               device="cuda")
        try:
            sched.solve(pods, provs, catalog)  # the allocator's growth
            cs.names_from()
            kernels.reset_counts()
            res = sched.solve(pods, provs, catalog)
            torch.cuda.synchronize()
            return res, kernels.counts()
        finally:
            sched.stop_warms()


def test_config2_solve_plans_the_same_with_the_fill_kernels(cuda,
                                                           monkeypatch):
    """Config 2 (20 zone-spread deployments x 2,500 pods, the full
    catalog) on the card: one solve launches each zone fill once per fill
    call of its 20 zone-spread group steps (three band fills and one water
    fill a step) and plans node for node as the plain bodies do."""
    import chip_smoke as cs

    res_k, launches_k = _config2_plan(monkeypatch, plain=False)
    res_p, launches_p = _config2_plan(monkeypatch, plain=True)
    assert launches_k["skew_band_fill"] == 60
    assert launches_k["water_fill"] == 20
    assert launches_p["skew_band_fill"] == launches_p["water_fill"] == 0
    assert cs.plan(res_k) == cs.plan(res_p)
    assert res_k.assignments == res_p.assignments
    assert res_k.infeasible == res_p.infeasible


def _hier_burst_plans(monkeypatch, deployments: int, replicas: int,
                      solves: int = 2):
    """The benchmark's ``zonespread-100k`` configuration cut to
    ``deployments`` x ``replicas`` (the full batch at 40 x 2,500), its first
    pending set of one seed solved ``solves`` times on the card under
    ``auto``, every other one traced: the plain plans, the set, the
    reference's candidates and, per solve, the group loops it ran and how
    many of them its signature's graph replayed."""
    import copy

    from benchmark import catalog, harness, inputs, reference, workload
    from benchmark.tracing import ReqTrace
    from karpenter_tpu_torch.metrics import HIER_SOLVES, Registry
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    c = copy.deepcopy(harness.cell(harness.manifest(),
                                   "zonespread-100k.burst"))
    p = c["config"]["pending"]
    p["deployments"], p["replicas"] = deployments, replicas
    p["cpu"], p["memory_gib"] = (p["cpu"][:deployments],
                                 p["memory_gib"][:deployments])
    if deployments * replicas < 100_000:
        monkeypatch.setenv("KT_HIER_THRESHOLD", str(deployments * replicas))
    pending = workload.pending_sets(c["config"], c["traffic"],
                                    2 ** 33 + 29)[0]
    records = catalog.generate(full=True)
    tmpl = inputs.templates(pending)
    index = inputs.index_of(tmpl)
    reg = Registry()
    sched = BatchScheduler(backend="auto", registry=reg, device="cuda")
    plans, loops = [], []
    try:
        for k in range(solves):
            before = _replays(reg)
            res = sched.solve(inputs.fresh(tmpl, str(k)),
                              [inputs.provisioner(c["config"]["provisioner"])],
                              inputs.instance_types(records),
                              trace=ReqTrace() if k % 2 else None)
            plans.append(inputs.plain_plan(res, index, str(k)))
            loops.append(_replays(reg, before))
    finally:
        sched.stop_warms()
    assert reg.counter(HIER_SOLVES).get({"path": "hierarchical"}) == solves
    cands = reference.Candidates(records, c["config"]["provisioner"],
                                 catalog.ZONES)
    return plans, pending, cands, loops


def _replays(reg, since=(0, 0)) -> tuple:
    """``(loops, replayed)``: the group loops the registry's graph-replay
    histogram counted since the reading ``since``, and how many of them a
    replay of their signature's graph served."""
    from karpenter_tpu_torch.metrics import SCAN_GRAPH_REPLAYS

    h = reg.histogram(SCAN_GRAPH_REPLAYS)
    return (sum(h.totals.values()) - since[0],
            int(sum(h.sums.values())) - since[1])


@pytest.mark.parametrize("deployments,replicas", [(8, 250), (40, 2500)])
def test_hier_burst_plans_the_same_traced_on_the_card(cuda, monkeypatch,
                                                      deployments, replicas):
    """The benchmark's hierarchical cell on the card, at the CPU tests'
    size and at its full 100,000 pods: traced and untraced, the plan is
    node for node the same and breaks none of the guarantees."""
    from benchmark import reference

    plans, pending, cands, _loops = _hier_burst_plans(
        monkeypatch, deployments, replicas)

    def nodes(plan):
        return sorted((t, z, ct, pr, tuple(sorted(pods)))
                      for t, z, ct, pr, pods in plan["nodes"])

    assert nodes(plans[1]) == nodes(plans[0])
    for plan in plans:
        assert reference.check(pending, plan, cands) == dict.fromkeys(
            reference.FAULT_KINDS, 0)


# ---- the group loop's CUDA graphs (solver/scan_graphs.py) -----------------


def test_zonespread_50k_plans_the_same_eager_captured_and_replayed(cuda):
    """The four pending sets of ``zonespread-50k`` (one seed), each on a
    fresh scheduler solved four times: its first sight runs the group
    loops eagerly, the second captures them, the last two replay them.
    Every solve plans node for node as the eager one, and launches each
    zone fill as often (60 band fills and 20 water fills a solve)."""
    import chip_smoke as cs
    from benchmark import catalog, harness, inputs, workload
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    c = harness.cell(harness.manifest(), "zonespread-50k.burst")
    its = inputs.instance_types(catalog.generate(full=True))
    prov = inputs.provisioner(c["config"]["provisioner"])
    for pending in workload.pending_sets(c["config"], c["traffic"],
                                         2 ** 33 + 41):
        tmpl = inputs.templates(pending)
        reg = Registry()
        sched = BatchScheduler(backend="auto", registry=reg, device="cuda")
        got = []
        try:
            for _ in range(4):
                cs.names_from()
                kernels.reset_counts()
                before = _replays(reg)
                res = sched.solve(inputs.fresh(tmpl, "0"), [prov], its)
                torch.cuda.synchronize()
                got.append((cs.plan(res), res.assignments, res.infeasible,
                            kernels.counts(), _replays(reg, before)))
        finally:
            sched.stop_warms()
        plan, assignments, infeasible, launches, (loops, replayed) = got[0]
        assert loops > 0 and replayed == 0
        assert launches["skew_band_fill"] == 60
        assert launches["water_fill"] == 20
        assert got[1][4] == (loops, 0)
        for later in got[1:]:
            assert later[0] == plan
            assert later[1] == assignments and later[2] == infeasible
            assert later[3] == launches
        assert got[2][4] == got[3][4] == (loops, loops)


def test_hier_burst_replays_the_wave_and_the_tail(cuda, monkeypatch):
    """``zonespread-100k`` at the CPU tests' size, solved twelve times: the
    block wave's loop is captured at the second solve, the tail repack's
    once its eager runs have paid for a capture (``ScanGraphs``), and the
    last solves replay both and plan node for node as the first."""
    plans, _pending, _cands, loops = _hier_burst_plans(monkeypatch, 8, 250,
                                                       solves=12)

    def nodes(plan):
        return sorted((t, z, ct, pr, tuple(sorted(pods)))
                      for t, z, ct, pr, pods in plan["nodes"])

    n, replayed = loops[0]
    assert n >= 2 and replayed == 0          # the wave and the tail
    assert loops[1] == (n, 0)                # the wave's capture
    assert loops[-2] == loops[-1] == (n, n)
    for plan in plans[1:]:
        assert nodes(plan) == nodes(plans[0])


def _spread_tensors(shift: int):
    """Eight zone-spread deployments of 250 pods whose cpu and memory
    requests are rotated by ``shift``: the same signature for every
    shift, other pods to place."""
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.instancetype import GIB
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.models.tensorize import tensorize

    pods = []
    for d in range(8):
        r = (d + shift) % 8
        sel = LabelSelector.of({"app": f"d{d}"})
        pods += [PodSpec(
            name=f"d{d}-{i}", labels={"app": f"d{d}"},
            requests={"cpu": 0.25 * (1 + r), "memory": (0.5 + r % 6) * GIB},
            topology_spread=[TopologySpreadConstraint(
                1, L.ZONE, "DoNotSchedule", sel)],
            owner_key=f"d{d}") for i in range(250)]
    return tensorize(pods, [Provisioner(name="default").with_defaults()],
                     generate_catalog(full=True))


def _eager_plan(st):
    """``st`` solved by a fresh solver: the signature's first sight, an
    eager group loop."""
    import chip_smoke as cs
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    out = TpuSolver(device="cuda").solve(st)
    return cs.plan(out.result), sorted(out.result.infeasible)


def test_async_replays_of_one_graph_keep_their_own_results(cuda):
    """Two ``solve_async`` dispatches of one signature with other inputs,
    both replays of its graph, dispatched A then B and read A then B: B's
    replay does not overwrite A's unread result."""
    import chip_smoke as cs
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    a, b = _spread_tensors(0), _spread_tensors(3)
    want_a, want_b = _eager_plan(a), _eager_plan(b)
    assert want_a != want_b
    reg = Registry()
    solver = TpuSolver(device="cuda", registry=reg)
    assert solver.signature(a) == solver.signature(b)
    for _ in range(2):                  # first sight, then the capture
        solver.solve(a)
    before = _replays(reg)
    pa = solver.solve_async(a)
    pb = solver.solve_async(b)
    ra, rb = pa.result(), pb.result()
    assert _replays(reg, before) == (2, 2)
    assert (cs.plan(ra.result), sorted(ra.result.infeasible)) == want_a
    assert (cs.plan(rb.result), sorted(rb.result.infeasible)) == want_b


def test_a_warm_beside_a_capture_and_replays_plans_as_eager(cuda):
    """A background warm of a signature runs while the foreground solves
    the same signature: one of them captures the graph, the rest replay
    it, and every plan is the eager one."""
    import threading

    import chip_smoke as cs
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    st = _spread_tensors(5)
    want = _eager_plan(st)
    reg = Registry()
    solver = TpuSolver(device="cuda", registry=reg)
    solver.solve(st)                    # the signature's first sight
    outs, done = [], threading.Event()

    def warm():
        outs.append(solver.solve(st))

    assert solver.warm_custom(("graph-warm",), warm,
                              on_done=lambda *_a: done.set())
    fore = [solver.solve(st) for _ in range(3)]
    assert done.wait(600)
    assert len(outs) == 1
    for out in fore + outs:
        assert (cs.plan(out.result), sorted(out.result.infeasible)) == want
    loops, replayed = _replays(reg)
    assert loops == 5 and replayed == 3  # eager, one capture, 3 replays
