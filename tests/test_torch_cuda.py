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
(``chip_smoke.step_cases``) and at every offset.  The plain-PyTorch device
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
operator on the card provisions.
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
    import chip_smoke as cs
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.solver import relax
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    pods = cs.relax_pods(n_per, spread_deps=spread_deps)
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
    """The controllers' repack loop (chip_smoke phase 9(c), 60 nodes): the
    same actions, final cluster and bindings on ``cuda`` as on ``cpu``,
    with the screen run on the card."""
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
    import chip_smoke as cs
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    catalog = generate_catalog(full=False)
    provs = [cs.provisioner()]
    clients = [cs.serving_pods(c) for c in range(8)]
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
    import chip_smoke as cs
    from karpenter_tpu_torch.metrics import SOLVER_COLD_FALLBACKS, Registry
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    catalog = generate_catalog(full=False)
    reg = Registry()
    sched = BatchScheduler(backend="auto", registry=reg)
    for c in range(3):
        pods = cs.serving_pods(c, n_groups=4 + 2 * c)
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
    pods = cs.serving_pods(0)
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
    import chip_smoke as cs
    from karpenter_tpu_torch.cloud.fake import FakeCloudProvider
    from karpenter_tpu_torch.metrics import REMOTE_FALLBACK_SOLVES, Registry
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.service.server import SolverService, make_server
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.utils.clock import FakeClock

    catalog = generate_catalog(full=False)
    pods = cs.serving_pods(0)
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
