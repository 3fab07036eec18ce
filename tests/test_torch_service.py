"""The port's solver sidecar against the reference package's, on the CPU:
``service/server.py`` (``SolvePipeline``, ``SolverService``,
``make_server``, ``main``), ``service/delta.py`` (the session table) and
``service/snapshot.py`` (the spool).

Inputs are built once per package from one plain description (tenant
batches of zone-spread deployments, churn steps of seeded adds and
removals), both packages' node-name counters reset before each compared
run, and the reference's schedulers built with ``compile_behind=False``
(it then serves every shape from its device program, as the port does).

- ``SolvePipeline`` on ``device="cpu"``: solo and coalesced plans equal
  the reference pipeline's (node plans, assignments, infeasible sets).
- ``SolverService.Solve`` on encoded requests: an establish, churn deltas
  and a stale epoch give the reference service's replies (every wire
  field but the random chain nonce, the replica id and the timings).
- The spool: snapshot → restore → next delta equals the unsnapshotted
  chain's; corrupt, truncated, catalog-epoch-skewed and reference-package
  spools are refused and counted; the unplaced-pod objects of a full
  fallback survive a restart.
- An inline delta racing a dispatcher flush serves the chain the
  sequential run serves.
- The wire: the REFERENCE's ``RemoteScheduler`` and ``DeltaSession``
  (imported here only) against the port's gRPC server on loopback get the
  replies they get from the reference's server.

Tolerance: equal (plans, replies, counters).
"""

import importlib
import os
import threading
import time
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"
MODULES = {
    "server": "service.server", "codec": "service.codec",
    "pb": "service.solver_pb2", "delta": "service.delta",
    "snapshot": "service.snapshot", "scheduler": "solver.scheduler",
    "types": "solver.types", "pod": "models.pod",
    "prov": "models.provisioner", "catalog": "models.catalog",
    "L": "models.labels", "metrics": "metrics",
}
_PACKAGES = {}
GIB = 1024.0 ** 3
TENANTS = ("acme", "bravo", "cyan", "delta")


def package(root: str) -> SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = SimpleNamespace(root=root, **{
            alias: importlib.import_module(f"{root}.{path}")
            for alias, path in MODULES.items()})
    return _PACKAGES[root]


def reset_names() -> None:
    for root in (REFERENCE, PORT):
        types = package(root).types
        with types._node_lock:
            types._node_next = 0


def scheduler(k, backend, registry=None):
    if k.root == REFERENCE:
        return k.scheduler.BatchScheduler(backend=backend, registry=registry,
                                          compile_behind=False)
    return k.scheduler.BatchScheduler(backend=backend, registry=registry,
                                      device="cpu")


def tenant_batch(k, tenant: str, n_groups: int = 4, per: int = 10):
    """The megabatch tests' tenant: shared shapes, disjoint pods."""
    shift = sum(ord(c) for c in tenant) % 5
    pods = []
    for gi in range(n_groups):
        sel = k.pod.LabelSelector.of({"app": f"{tenant}-g{gi}"})
        for i in range(per):
            pods.append(k.pod.PodSpec(
                name=f"{tenant}-g{gi}-{i}", labels={"app": f"{tenant}-g{gi}"},
                requests={"cpu": 0.25 * (1 + (gi + shift) % 6),
                          "memory": float(1 + (gi + shift) % 3) * GIB},
                topology_spread=[k.pod.TopologySpreadConstraint(
                    1, k.L.ZONE, "DoNotSchedule", sel)],
                owner_key=f"{tenant}-g{gi}"))
    return pods


def churn_pods(k, tag: str, n: int, g0: int = 0):
    """Unconstrained pods in 4 deployments (the delta tests' shape)."""
    return [k.pod.PodSpec(
        name=f"{tag}-{i}", labels={"app": f"d{(i + g0) % 4}"},
        requests={"cpu": 0.5 + (i % 3) * 0.25,
                  "memory": (1 + i % 2) * GIB},
        owner_key=f"d{(i + g0) % 4}") for i in range(n)]


def plan(result):
    return sorted(
        (n.instance_type, n.zone, n.capacity_type, round(n.price, 6),
         tuple(sorted(p.name for p in n.pods)))
        for n in result.nodes)


def same_solve(a, b) -> bool:
    return (plan(a) == plan(b) and a.infeasible == b.infeasible
            and set(a.assignments) == set(b.assignments))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ("KT_SESSION_DIR", "KT_CATALOG_EPOCH", "KT_MULTIHOST_PEERS",
                 "KT_ADMISSION", "KT_DELTA", "KT_MAX_SLOTS",
                 "KT_MAX_WAIT_MS", "KT_FAULTS", "KT_SOLVE_PIPELINE",
                 "KT_TS_INTERVAL_S", "KT_REPLICA_ID"):
        monkeypatch.delenv(name, raising=False)
    # no background sampler thread per service
    monkeypatch.setenv("KT_TS_INTERVAL_S", "0")


# ---------------------------------------------------------------------------
# the port's entry points need the card unless asked for the host
# ---------------------------------------------------------------------------


def test_service_and_main_raise_without_cuda(monkeypatch):
    from karpenter_tpu_torch.service import server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        server.SolverService()
    with pytest.raises(RuntimeError, match="CUDA"):
        server.main(["--port", "0"])
    with pytest.raises(SystemExit):
        server.main(["--device", "cpu", "--backend", "gpu"])


def test_health_reports_the_torch_device():
    from karpenter_tpu_torch.service import server
    from karpenter_tpu_torch.service import solver_pb2 as pb

    service = server.SolverService(scheduler(package(PORT), "oracle"))
    try:
        h = service.Health(pb.HealthRequest(), None)
        assert (h.ok, h.backend, h.devices) == (True, "cpu", 1)
    finally:
        service.close()


def test_multihost_peers_are_refused(monkeypatch):
    from karpenter_tpu_torch.parallel.forward import MultiHostNotPorted
    from karpenter_tpu_torch.service.server import SolvePipeline

    monkeypatch.setenv("KT_MULTIHOST_PEERS", "10.0.0.1:50151,10.0.0.2:50151")
    with pytest.raises(MultiHostNotPorted, match="A10"):
        SolvePipeline(scheduler(package(PORT), "oracle"))


def test_solve_ms_ends_at_the_read_back(monkeypatch):
    """A pipelined single solve's ``solve_ms`` covers its read-back, not
    only the enqueue."""
    from karpenter_tpu_torch.service.server import SolvePipeline
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    k = package(PORT)
    read_back = TpuSolver._read_back

    def slow(self, *args, **kw):
        time.sleep(0.25)
        return read_back(self, *args, **kw)

    monkeypatch.setattr(TpuSolver, "_read_back", slow)
    pipe = SolvePipeline(scheduler(k, "tpu"), admission=False)
    try:
        res = pipe.solve(dict(
            pods=tenant_batch(k, "acme"),
            provisioners=[k.prov.Provisioner(name="default").with_defaults()],
            instance_types=k.catalog.generate_catalog(full=False)))
    finally:
        pipe.stop()
    assert not res.infeasible and res.solve_ms >= 250.0


# ---------------------------------------------------------------------------
# SolvePipeline plans against the reference's pipeline
# ---------------------------------------------------------------------------


def pipeline_plans(k, coalesced: bool) -> dict:
    reg = k.metrics.Registry()
    sched = scheduler(k, "tpu", reg)
    catalog = k.catalog.generate_catalog(full=False)
    provs = [k.prov.Provisioner(name="default").with_defaults()]
    batches = {t: tenant_batch(k, t) for t in TENANTS}
    out = {}
    if coalesced and k.root == REFERENCE:
        # the reference buckets only shapes whose program has compiled:
        # mark the tenants' single-solve signature ready (its compile state
        # is not what is compared; the flush then compiles inline)
        st = k.scheduler.tensorize(batches[TENANTS[0]], provs, catalog)
        sched._tpu._mark_ready(sched._tpu.signature(st))
    if coalesced:
        pipe = k.server.SolvePipeline(sched, registry=reg, max_slots=4,
                                      max_wait_ms=20_000.0, admission=False)
        barrier = threading.Barrier(len(TENANTS))

        def call(t):
            barrier.wait()
            out[t] = pipe.solve(dict(pods=batches[t], provisioners=provs,
                                     instance_types=catalog))

        threads = [threading.Thread(target=call, args=(t,))
                   for t in TENANTS]
        reset_names()
        for th in threads:
            th.start()
        for th in threads:
            th.join(300.0)
    else:
        pipe = k.server.SolvePipeline(sched, registry=reg, max_slots=1,
                                      admission=False)
        for t in TENANTS:
            reset_names()
            out[t] = pipe.solve(dict(pods=batches[t], provisioners=provs,
                                     instance_types=catalog))
    pipe.stop()
    h = reg.histogram(k.metrics.MEGABATCH_SLOTS)
    return dict(results=out, slots=(sum(h.totals.values()),
                                    sum(h.sums.values())))


@pytest.mark.parametrize("coalesced", [False, True], ids=["solo", "coalesced"])
def test_pipeline_plans_match_reference(coalesced):
    ref = pipeline_plans(package(REFERENCE), coalesced)
    port = pipeline_plans(package(PORT), coalesced)
    assert set(port["results"]) == set(TENANTS)
    for t in TENANTS:
        assert same_solve(port["results"][t], ref["results"][t]), t
        assert not port["results"][t].infeasible
    # the port dispatches the 4 requests as one 4-slot megabatch; the
    # reference serves a flush at a never-compiled slot rung serially
    # (four 1-slot dispatches), with the same plans
    assert port["slots"] == ((1, 4) if coalesced else (0, 0))
    assert ref["slots"][1] == port["slots"][1]


# ---------------------------------------------------------------------------
# SolverService.Solve: the session protocol against the reference's
# ---------------------------------------------------------------------------


def normalized(resp) -> bytes:
    """A reply's wire bytes without the fields that differ by design: the
    random chain nonce, the replica id and the timings."""
    resp = type(resp).FromString(resp.SerializeToString())
    resp.session_nonce = ""
    resp.replica_id = ""
    resp.solve_ms = 0.0
    return resp.SerializeToString(deterministic=True)


def session_script(k, backend: str, steps: int = 4):
    """(request kwargs) of one session: establish, ``steps`` churn deltas,
    then a delta on a stale epoch."""
    catalog = k.catalog.generate_catalog(full=False)
    provs = [k.prov.Provisioner(name="default").with_defaults()]
    base = churn_pods(k, "p", 40)
    live = [p.name for p in base]
    script = [dict(pods=base, provisioners=provs, instance_types=catalog,
                   backend=backend, session_id="s1", catalog_epoch=1)]
    for step in range(steps):
        rm = live[step::9][:3]
        live = [n for n in live if n not in rm]
        add = churn_pods(k, f"c{step}", 3, g0=step)
        live += [p.name for p in add]
        script.append(dict(pods=add, provisioners=[], instance_types=[],
                           backend=backend, session_id="s1",
                           base_epoch=None, delta=True, removed_pods=rm,
                           catalog_epoch=1))
    script.append(dict(pods=[], provisioners=[], instance_types=[],
                       backend=backend, session_id="s1", base_epoch=999,
                       delta=True, catalog_epoch=1))
    return script


def service_session(k, backend: str, restart_at=None):
    """The session script through a ``SolverService``.  With ``restart_at``
    the service is closed before that request (spooling the chain when
    ``KT_SESSION_DIR`` is set) and a fresh one, which restores it, serves
    the rest.  Returns the replies and the last service's registry."""
    def service_on(reg):
        return k.server.SolverService(scheduler(k, backend, reg),
                                      registry=reg)

    reg = k.metrics.Registry()
    service = service_on(reg)
    replies, epoch, nonce = [], 0, ""
    reset_names()
    try:
        for i, kw in enumerate(session_script(k, backend)):
            if i == restart_at:
                service.close()
                reg = k.metrics.Registry()
                service = service_on(reg)
            pods = kw.pop("pods")
            provs = kw.pop("provisioners")
            its = kw.pop("instance_types")
            if kw.get("base_epoch", 0) is None:
                kw["base_epoch"] = epoch
            req = k.codec.encode_request(pods, provs, its,
                                         session_nonce=nonce, **kw)
            resp = service.Solve(req, None)
            if resp.session_state == "ok":
                epoch, nonce = resp.session_epoch, resp.session_nonce
            replies.append(resp)
    finally:
        service.close()
    return replies, reg


@pytest.mark.parametrize("backend", ["oracle", "tpu"])
def test_service_session_replies_match_reference(backend):
    ref, ref_reg = service_session(package(REFERENCE), backend)
    port, port_reg = service_session(package(PORT), backend)
    assert [normalized(r) for r in port] == [normalized(r) for r in ref]
    assert [r.session_state for r in port][-1] == "unknown"
    assert {r.delta_mode for r in port[1:-1]} <= {"noop", "host", "scan",
                                                  "full"}
    for k_reg, k in ((port_reg, package(PORT)), (ref_reg,
                                                  package(REFERENCE))):
        assert k_reg.counter(k.metrics.DELTA_RPC).get(
            {"outcome": "establish"}) == 1
    assert {lk: v for lk, v in port_reg.counter(
        package(PORT).metrics.DELTA_RPC).values.items()} == \
        {lk: v for lk, v in ref_reg.counter(
            package(REFERENCE).metrics.DELTA_RPC).values.items()}


# ---------------------------------------------------------------------------
# the spool
# ---------------------------------------------------------------------------


def test_snapshot_restore_next_delta_matches_the_unsnapshotted_chain(
        tmp_path, monkeypatch):
    k = package(PORT)
    straight, _ = service_session(k, "oracle")
    monkeypatch.setenv("KT_SESSION_DIR", str(tmp_path))
    restarted, reg = service_session(k, "oracle", restart_at=3)
    assert [normalized(r) for r in restarted] == \
        [normalized(r) for r in straight]
    assert reg.counter(k.metrics.SNAPSHOT_RESTORE).get(
        {"outcome": "restored"}) == 1
    # the restarted replica served the next step warm, not a re-establish
    assert restarted[3].session_state == "ok"
    assert restarted[3].delta_mode in ("noop", "host", "scan")


def spooled_table(k, tmp_path, unplaced=None):
    """A table holding one session whose result carries the unplaced-pod
    objects of a full fallback, spooled under ``tmp_path``."""
    from_clock = importlib.import_module(f"{k.root}.utils.clock")
    reg = k.metrics.Registry()
    tab = k.delta.DeltaSessionTable(registry=reg,
                                    clock=from_clock.FakeClock(0.0),
                                    spool_dir=str(tmp_path))
    res = k.types.SolveResult(nodes=[], assignments={},
                              infeasible={"big-0": "no feasible placement"})
    if unplaced is not None:
        res._warmstart_unplaced = unplaced
    tab.put(k.delta.SessionEntry(
        session_id="s1", prev=res, epoch=7, catalog_epoch=2,
        provisioners=[], instance_types=[]))
    out = tab.snapshot(str(tmp_path))
    return tab, out


def restore_into_fresh(k, tmp_path, expected_epoch=None):
    from_clock = importlib.import_module(f"{k.root}.utils.clock")
    reg = k.metrics.Registry()
    tab = k.delta.DeltaSessionTable(registry=reg,
                                    clock=from_clock.FakeClock(0.0),
                                    spool_dir=str(tmp_path))
    n = tab.restore(str(tmp_path), expected_catalog_epoch=expected_epoch)
    outcomes = {dict(lk)["outcome"]: v for lk, v in reg.counter(
        k.metrics.SNAPSHOT_RESTORE).values.items() if v}
    return tab, n, outcomes


def record_files(tmp_path):
    return sorted(p for p in tmp_path.rglob("*.snap") if p.is_file())


def test_spool_keeps_the_unplaced_pod_objects(tmp_path):
    k = package(PORT)
    pod = k.pod.PodSpec(name="big-0", requests={"cpu": 1000.0},
                        owner_key="big")
    spooled_table(k, tmp_path, unplaced={"big-0": pod})
    tab, n, outcomes = restore_into_fresh(k, tmp_path)
    assert n == 1 and outcomes == {"restored": 1.0}
    prev = tab.get("s1").prev
    kept = prev._warmstart_unplaced
    assert list(kept) == ["big-0"] and kept["big-0"].requests == pod.requests
    # and the port's warm-start bookkeeping re-offers it from there
    from karpenter_tpu_torch.solver.warmstart import build_meta

    assert "big-0" in build_meta(prev).unplaced


@pytest.mark.parametrize("damage", ["corrupt", "truncated",
                                    "catalog_epoch", "reference_spool"])
def test_damaged_spools_are_refused_and_counted(tmp_path, damage,
                                                monkeypatch):
    # one replica identity for both packages: the record's lease is ours
    monkeypatch.setenv("KT_REPLICA_ID", "replica-under-test")
    k = package(PORT)
    if damage == "reference_spool":
        # the reference package's record: its pickles name the reference's
        # modules, and the port's schema fingerprint refuses it unread
        spooled_table(package(REFERENCE), tmp_path)
    else:
        spooled_table(k, tmp_path)
    files = record_files(tmp_path)
    assert files
    if damage == "corrupt":
        raw = bytearray(files[0].read_bytes())
        raw[-5] ^= 0xFF
        files[0].write_bytes(bytes(raw))
    elif damage == "truncated":
        raw = files[0].read_bytes()
        files[0].write_bytes(raw[:len(raw) - 40])
    expected = 3 if damage == "catalog_epoch" else None
    tab, n, outcomes = restore_into_fresh(k, tmp_path, expected)
    want = "version" if damage == "reference_spool" else damage
    assert n == 0 and tab.get("s1") is None
    assert outcomes == {want: 1.0}


# ---------------------------------------------------------------------------
# the inline delta shortcut against a running flush
# ---------------------------------------------------------------------------


def test_inline_delta_racing_a_flush_serves_the_sequential_chain():
    """Delta RPCs race full solves through one pipeline: an idle pipeline
    serves a delta inline on its RPC thread, a busy one queues it behind
    the flush (the scheduler-ownership lock).  The chain must come out as
    the same deltas applied one after another, and both routes must have
    been taken."""
    k = package(PORT)
    catalog = k.catalog.generate_catalog(full=False)
    provs = [k.prov.Provisioner(name="default").with_defaults()]
    reg = k.metrics.Registry()
    sched = scheduler(k, "tpu", reg)
    pipe = k.server.SolvePipeline(sched, registry=reg, admission=False)
    inline = []
    solve_inline = pipe._solve_inline

    def counted(*a, **kw):
        inline.append(1)
        return solve_inline(*a, **kw)

    pipe._solve_inline = counted
    steps = 12
    base = churn_pods(k, "p", 60)
    adds = [churn_pods(k, f"c{s}", 2, g0=s) for s in range(steps)]

    def info(delta, epoch):
        return dict(session_id="s1", base_epoch=epoch, delta=delta,
                    removed=[], reclaimed=[], catalog_epoch=0, nonce="")

    def chain(race: bool):
        reset_names()
        reply = pipe.solve(dict(pods=base, provisioners=provs,
                                instance_types=catalog,
                                _delta=info(False, 0)))
        epoch = epoch0 = reply.epoch  # establish epochs only ever grow
        stop = threading.Event()
        flushes = []

        def full_solves():
            while not stop.is_set():
                flushes.append(pipe.solve(dict(
                    pods=tenant_batch(k, "acme"), provisioners=provs,
                    instance_types=catalog)))

        racer = threading.Thread(target=full_solves)
        if race:
            racer.start()
        replies = []
        try:
            for add in adds:
                r = pipe.solve(dict(pods=add, provisioners=[],
                                    instance_types=[],
                                    _delta=info(True, epoch)))
                assert r.state == "ok"
                epoch = r.epoch
                replies.append((r.mode, r.epoch - epoch0,
                                sorted(r.assignments)))
                time.sleep(0.01)
        finally:
            stop.set()
            if race:
                racer.join(60.0)
        entry = pipe._delta_tab.get("s1")
        return replies, entry.prev, flushes

    try:
        quiet, quiet_prev, _ = chain(race=False)
        n_quiet_inline = len(inline)
        raced, raced_prev, flushes = chain(race=True)
    finally:
        pipe.stop()
    # idle, the shortcut serves (the dispatcher's idle tick can hold the
    # lock for an instant, sending a request down the queue instead);
    # under a running flush some delta must have queued behind it
    assert n_quiet_inline >= steps // 2
    assert len(inline) - n_quiet_inline < steps + 1
    assert flushes and all(not f.infeasible for f in flushes)
    assert raced == quiet
    assert raced_prev.assignments.keys() == quiet_prev.assignments.keys()
    assert plan(raced_prev) == plan(quiet_prev)


# ---------------------------------------------------------------------------
# the wire: the reference's clients against the port's server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    """The port's and the reference's sidecars on loopback, oracle
    backend, each on its own registry."""
    out = {}
    for root in (REFERENCE, PORT):
        k = package(root)
        os.environ["KT_TS_INTERVAL_S"] = "0"
        reg = k.metrics.Registry()
        service = k.server.SolverService(scheduler(k, "oracle", reg),
                                         registry=reg)
        srv, port = k.server.make_server(service, port=0)
        out[root] = (service, srv, f"127.0.0.1:{port}", reg)
    yield out
    for service, srv, _addr, _reg in out.values():
        srv.stop(grace=None)
        service.close()


def test_reference_remote_scheduler_gets_the_reference_plans(servers):
    from karpenter_tpu.service.client import RemoteScheduler

    k = package(REFERENCE)   # the client's models: the reference's own
    catalog = k.catalog.generate_catalog(full=False)
    provs = [k.prov.Provisioner(name="default").with_defaults()]
    results = {}
    for root in (REFERENCE, PORT):
        remote = RemoteScheduler(servers[root][2])
        try:
            reset_names()
            results[root] = [remote.solve(tenant_batch(k, t), provs, catalog)
                             for t in TENANTS[:2]]
            results[root].append(remote.solve(
                churn_pods(k, "w", 30), provs, catalog,
                unavailable={(catalog[0].name, "zone-1a", "spot")},
                max_new_nodes=3))
        finally:
            remote.client.close()
        assert not remote.degraded()
    for a, b in zip(results[PORT], results[REFERENCE]):
        assert same_solve(a, b)
        assert [n.name for n in a.nodes] == [n.name for n in b.nodes]


def test_reference_delta_session_gets_the_reference_replies(servers):
    from karpenter_tpu.service.client import DeltaSession

    k = package(REFERENCE)
    catalog = k.catalog.generate_catalog(full=False)
    provs = [k.prov.Provisioner(name="default").with_defaults()]
    views = {}
    for root in (REFERENCE, PORT):
        sess = DeltaSession(servers[root][2], session_id=f"wire-{root}")
        try:
            reset_names()
            base = churn_pods(k, "p", 48)
            live = [p.name for p in base]
            out = [sess.solve(base, provs, catalog)]
            for step in range(5):
                rm = live[step::7][:3]
                live = [n for n in live if n not in rm]
                add = churn_pods(k, f"c{step}", 3, g0=step)
                live += [p.name for p in add]
                out.append(sess.solve_delta(added=add, removed=rm))
            victim = out[-1].nodes[0]
            out.append(sess.solve_delta(iced=[victim.name]))
            views[root] = dict(
                plans=[plan(r) for r in out],
                assignments=[dict(r.assignments) for r in out],
                infeasible=[dict(r.infeasible) for r in out],
                epoch=sess.epoch, resends=sess.full_resends,
                deltas=sess.delta_rpcs)
        finally:
            sess.close()
    assert views[PORT] == views[REFERENCE]
    reg = servers[PORT][3]
    assert reg.counter(package(PORT).metrics.DELTA_RPC).get(
        {"outcome": "delta"}) >= 5
