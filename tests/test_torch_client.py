"""The port's sidecar client (``service/client.py``: ``SolverClient``,
``RemoteScheduler``, ``DeltaSession``, ``FleetClient``) against the
reference package's, on the CPU.

Each scenario is one function over a package namespace ``k`` and runs
twice: the reference's client against the reference's server, and the
port's client against the port's server (``device="cpu"``), each from
fresh node-name counters.  The reference's own assertions (from
``tests/test_service.py``, ``tests/test_delta_serving.py`` and
``tests/test_fleet.py``) hold in both runs, and what each run observed —
plans, merged session views, typed errors, epochs, resend counts and the
metric counters — must be equal.  The cross-package wire (the port's
client against the reference's server and the reverse) must give the
plans a local solve gives.

The port's difference, pinned here: ``RemoteScheduler``'s availability
fallback is an oracle scheduler on the host CPU, so a remote operator
needs no card; ``device`` names that host device and ``_tensorize_cache``
is None (ROADMAP C5: the reference's facade lacks the attribute, and its
sweep raises on it).

Tolerance: equal.
"""

import contextlib
import importlib
import inspect
import os
import time
from types import SimpleNamespace

import grpc
import pytest
import torch

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"
ROOTS = (REFERENCE, PORT)
MODULES = {
    "client": "service.client", "server": "service.server",
    "codec": "service.codec", "pb": "service.solver_pb2",
    "delta": "service.delta", "snapshot": "service.snapshot",
    "scheduler": "solver.scheduler", "types": "solver.types",
    "pod": "models.pod", "prov": "models.provisioner",
    "catalog": "models.catalog", "L": "models.labels",
    "metrics": "metrics", "admission": "admission", "faults": "faults",
    "clock": "utils.clock", "export": "obs.export",
}
_PACKAGES: dict = {}
GIB = 1024.0 ** 3


def package(root: str) -> SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = SimpleNamespace(root=root, **{
            alias: importlib.import_module(f"{root}.{path}")
            for alias, path in MODULES.items()})
    return _PACKAGES[root]


def reset_names(k) -> None:
    with k.types._node_lock:
        k.types._node_next = 0


def scheduler(k, backend="oracle", registry=None):
    if k.root == REFERENCE:
        return k.scheduler.BatchScheduler(backend=backend, registry=registry,
                                          compile_behind=False)
    return k.scheduler.BatchScheduler(backend=backend, registry=registry,
                                      device="cpu")


@contextlib.contextmanager
def serve(k, backend="oracle", host=None):
    """One in-process sidecar of package ``k`` on loopback (or ``host``,
    a ``unix:`` address): yields (service, address, registry)."""
    reg = k.metrics.Registry()
    service = k.server.SolverService(scheduler(k, backend, reg),
                                     registry=reg)
    if host is None:
        srv, port = k.server.make_server(service, port=0, host="127.0.0.1")
        address = f"127.0.0.1:{port}"
    else:
        srv, _ = k.server.make_server(service, host=host)
        address = host
    try:
        yield service, address, reg
    finally:
        srv.stop(grace=None)
        service.close()
        unlink_socket(address)


def unlink_socket(address: str) -> None:
    """Free a ``unix:`` address for the other package's run: the fleet's
    rendezvous hashes the endpoint string, so both runs dial the same
    one."""
    if address.startswith("unix:") and os.path.exists(address[5:]):
        os.remove(address[5:])


def run_both(fn, *args):
    """``fn(k, *args)`` over the reference, then the port, each from
    fresh counters; returns {root: observation}."""
    out = {}
    for root in ROOTS:
        k = package(root)
        reset_names(k)
        out[root] = fn(k, *args)
    return out


def assert_same(fn, *args):
    out = run_both(fn, *args)
    assert out[PORT] == out[REFERENCE]
    return out[PORT]


def pods_of(k, tag, n, g0=0):
    return [k.pod.PodSpec(
        name=f"{tag}-{i}", labels={"app": f"d{(i + g0) % 4}"},
        requests={"cpu": 0.5 + (i % 3) * 0.25, "memory": (1 + i % 2) * GIB},
        owner_key=f"d{(i + g0) % 4}") for i in range(n)]


def spread_pods(k, tag, n):
    sel = k.pod.LabelSelector.of({"app": tag})
    return [k.pod.PodSpec(
        name=f"{tag}-{i}", labels={"app": tag}, requests={"cpu": 0.5},
        topology_spread=[k.pod.TopologySpreadConstraint(
            1, k.L.ZONE, "DoNotSchedule", sel)],
        owner_key=tag) for i in range(n)]


def prov(k):
    return k.prov.Provisioner(name="default").with_defaults()


def small(k):
    return k.catalog.generate_catalog(full=False)


def view(res) -> tuple:
    """A solve's whole answer, names included (the counters are reset)."""
    return (sorted((n.name, n.instance_type, n.zone, n.capacity_type,
                    round(n.price, 6), tuple(sorted(p.name for p in n.pods)))
                   for n in res.nodes),
            sorted(res.assignments.items()), sorted(res.infeasible.items()))


def partition(res) -> tuple:
    """Name-blind: the node partition and the infeasible set."""
    return (sorted((n.instance_type, n.zone, n.capacity_type,
                    tuple(sorted(p.name for p in n.pods)))
                   for n in res.nodes), sorted(res.infeasible))


def node_map(nodes):
    return {n.name: sorted(p.name for p in n.pods) for n in nodes}


def counter(reg, name) -> dict:
    return {tuple(sorted(dict(lk).items())): v
            for lk, v in reg.counter(name).values.items()}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ("KT_SESSION_DIR", "KT_DELTA", "KT_FAULTS",
                 "KT_FLEET_ENDPOINTS", "KT_RPC_RETRIES", "KT_RPC_BACKOFF_MS",
                 "KT_REPLICA_ID", "KT_SOLVER_DEADLINE_MS", "KT_TRACE",
                 "KT_OBS_PEERS", "KT_SESSION_SNAPSHOT_S",
                 "KT_SESSION_LEASE_S", "KT_FLEET_BUCKET_AFFINITY"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KT_TS_INTERVAL_S", "0")


# ---------------------------------------------------------------------------
# the facade contract (tests/test_service.py::TestFacadeContract)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["solve", "warm_startup", "stop_warms"])
def test_facade_signatures_match(name):
    port, ref = package(PORT), package(REFERENCE)
    local = inspect.signature(getattr(port.scheduler.BatchScheduler, name))
    for remote_cls in (port.client.RemoteScheduler,
                       ref.client.RemoteScheduler):
        remote = inspect.signature(getattr(remote_cls, name))
        assert list(local.parameters) == list(remote.parameters)
        for p in local.parameters.values():
            q = remote.parameters[p.name]
            assert (p.kind, p.default) == (q.kind, q.default)


def test_remote_scheduler_signature_is_the_reference_one():
    for cls in ("SolverClient", "FleetClient", "RemoteScheduler",
                "DeltaSession"):
        a = inspect.signature(getattr(package(PORT).client, cls).__init__)
        b = inspect.signature(getattr(package(REFERENCE).client,
                                      cls).__init__)
        assert [(p.name, p.kind, p.default) for p in a.parameters.values()] \
            == [(p.name, p.kind, p.default) for p in b.parameters.values()]


def test_shared_attributes_and_the_host_fallback(monkeypatch):
    k = package(PORT)
    # the operator's node has no card: the facade must build without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with serve(k) as (_svc, address, _reg):
        remote = k.client.RemoteScheduler(address)
        try:
            local = scheduler(k)
            for attr in ("backend", "mesh", "registry"):
                assert hasattr(remote, attr) and hasattr(local, attr)
            assert remote.device == torch.device("cpu")
            assert remote.fallback.device == torch.device("cpu")
            assert remote.fallback.backend == "oracle"
            assert remote._tensorize_cache is None
            assert remote.mesh is None
        finally:
            remote.close()


# ---------------------------------------------------------------------------
# RemoteScheduler over the wire (tests/test_service.py::TestGrpc)
# ---------------------------------------------------------------------------


def _remote_solves(k, address):
    catalog = small(k)
    remote = k.client.RemoteScheduler(address)
    try:
        assert remote.client.health().ok
        out = [partition(remote.solve(pods_of(k, "w", 40) + spread_pods(
            k, "sp", 9), [prov(k)], catalog))]
        out.append(partition(remote.solve(
            pods_of(k, "u", 30), [prov(k)], catalog,
            unavailable={(catalog[0].name, "zone-1a", "spot")},
            max_new_nodes=3)))
        assert not remote.degraded()
        return out
    finally:
        remote.close()


def _local_solves(k):
    catalog = small(k)
    sched = scheduler(k)
    return [partition(sched.solve(pods_of(k, "w", 40) + spread_pods(
        k, "sp", 9), [prov(k)], catalog)),
        partition(sched.solve(
            pods_of(k, "u", 30), [prov(k)], catalog,
            unavailable={(catalog[0].name, "zone-1a", "spot")},
            max_new_nodes=3))]


@pytest.mark.parametrize("client_root,server_root", [
    (REFERENCE, REFERENCE), (PORT, PORT), (PORT, REFERENCE),
    (REFERENCE, PORT)])
def test_remote_solve_matches_local(client_root, server_root):
    expected = _local_solves(package(REFERENCE))
    with serve(package(server_root)) as (_svc, address, _reg):
        assert _remote_solves(package(client_root), address) == expected


def test_remote_solve_plans_equal_node_for_node():
    def scenario(k):
        with serve(k) as (_svc, address, reg):
            remote = k.client.RemoteScheduler(address, backend="oracle")
            try:
                res = remote.solve(pods_of(k, "p", 60), [prov(k)], small(k))
                by_name = {p.name for n in res.nodes for p in n.pods}
            finally:
                remote.close()
            return view(res), sorted(by_name), counter(
                reg, k.metrics.ADMISSION_ADMITTED)

    assert_same(scenario)


# ---------------------------------------------------------------------------
# availability: fallback, reconnect, typed errors (TestFallback)
# ---------------------------------------------------------------------------


def test_solve_falls_back_when_unreachable(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def scenario(k):
        reg = k.metrics.Registry()
        remote = k.client.RemoteScheduler("127.0.0.1:1", timeout=2.0,
                                          reconnect_interval=600.0,
                                          registry=reg)
        catalog = small(k)
        first = remote.solve(pods_of(k, "p", 8), [prov(k)], catalog)
        assert first.infeasible == {} and first.n_scheduled == 8
        assert remote.degraded()
        fb = reg.counter(k.metrics.REMOTE_FALLBACK_SOLVES).get()
        warm = remote.warm_startup([prov(k)], catalog)
        second = remote.solve(pods_of(k, "q", 8), [prov(k)], catalog)
        out = (view(first), view(second), fb, warm,
               reg.counter(k.metrics.REMOTE_FALLBACK_SOLVES).get(),
               reg.gauge(k.metrics.REMOTE_DEGRADED).get(),
               counter(reg, k.metrics.FAULTS_RECOVERED))
        remote.close()
        return out

    obs = assert_same(scenario)
    assert obs[2:5] == (1.0, 0, 2.0)


def test_health_gated_reconnect():
    def scenario(k):
        reg = k.metrics.Registry()
        with serve(k) as (_svc, address, _sreg):
            remote = k.client.RemoteScheduler(address, reconnect_interval=0.0,
                                              registry=reg)
            remote._mark_degraded(RuntimeError("injected outage"))
            was = (remote.degraded(), reg.gauge(k.metrics.REMOTE_DEGRADED)
                   .get())
            res = remote.solve(pods_of(k, "p", 6), [prov(k)], small(k))
            out = (was, remote.degraded(),
                   reg.gauge(k.metrics.REMOTE_DEGRADED).get(),
                   reg.counter(k.metrics.REMOTE_FALLBACK_SOLVES).get(),
                   view(res))
            remote.close()
            return out

    obs = assert_same(scenario)
    assert obs[:4] == ((True, 1), False, 0, 0.0)


def test_warm_unimplemented_does_not_degrade():
    from concurrent import futures

    def scenario(k):
        service = k.server.SolverService(scheduler(k))
        handlers = {
            "Solve": grpc.unary_unary_rpc_method_handler(
                service.Solve,
                request_deserializer=k.pb.SolveRequest.FromString,
                response_serializer=k.pb.SolveResponse.SerializeToString),
            "Health": grpc.unary_unary_rpc_method_handler(
                service.Health,
                request_deserializer=k.pb.HealthRequest.FromString,
                response_serializer=k.pb.HealthResponse.SerializeToString),
        }
        srv = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        srv.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(k.server.SERVICE,
                                                  handlers),))
        port = srv.add_insecure_port("127.0.0.1:0")
        srv.start()
        try:
            remote = k.client.RemoteScheduler(f"127.0.0.1:{port}")
            warm = remote.warm_startup([prov(k)], small(k))
            deg = remote.degraded()
            res = remote.solve(pods_of(k, "p", 8), [prov(k)], small(k))
            out = (warm, deg, remote.degraded(), view(res))
            remote.close()
            return out
        finally:
            srv.stop(grace=None)
            service.close()

    obs = assert_same(scenario)
    assert obs[:3] == (0, False, False)


class _Raising:
    """``solve_raw`` stub raising one gRPC status, then delegating."""

    def __init__(self, inner, code, times=1):
        self._inner = inner
        self.code = code
        self.times = times
        self.timeout = inner.timeout

    def solve_raw(self, req, timeout=None):
        if self.times:
            self.times -= 1
            err = grpc.RpcError()
            err.code = lambda: self.code
            err.details = lambda: f"injected {self.code.name}"
            raise err
        return self._inner.solve_raw(req, timeout=timeout)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.mark.parametrize("code,deadline_s,shed_fallback", [
    ("RESOURCE_EXHAUSTED", None, False),
    ("RESOURCE_EXHAUSTED", None, True),
    ("DEADLINE_EXCEEDED", 30.0, False),
    ("DEADLINE_EXCEEDED", 30.0, True),
    ("DEADLINE_EXCEEDED", None, False),
    ("UNAVAILABLE", None, False),
    ("INTERNAL", None, False),
])
def test_remote_typed_errors(code, deadline_s, shed_fallback):
    """Sheds and spent budgets are typed (or, under ``shed_fallback``,
    served locally without latching degraded); a transport failure
    latches degraded; anything else serves this one solve locally."""
    status = getattr(grpc.StatusCode, code)

    def scenario(k):
        reg = k.metrics.Registry()
        with serve(k) as (_svc, address, _sreg):
            remote = k.client.RemoteScheduler(
                address, registry=reg, priority="critical",
                deadline_s=deadline_s, shed_fallback=shed_fallback)
            remote.client = _Raising(remote.client, status)
            try:
                res = remote.solve(pods_of(k, "p", 6), [prov(k)], small(k))
                outcome = ("served", view(res))
            except Exception as err:  # noqa: BLE001 - the typed surface
                outcome = (type(err).__name__, str(err),
                           getattr(err, "pclass", None),
                           getattr(err, "reason", None))
            after = remote.solve(pods_of(k, "q", 6), [prov(k)], small(k))
            out = (outcome, remote.degraded(),
                   reg.counter(k.metrics.REMOTE_FALLBACK_SOLVES).get(),
                   counter(reg, k.metrics.FAULTS_RECOVERED), view(after))
            remote.close()
            return out

    obs = assert_same(scenario)
    if code in ("RESOURCE_EXHAUSTED",) and not shed_fallback:
        assert obs[0][0] == "SolveShedError"
    if code == "DEADLINE_EXCEEDED" and deadline_s and not shed_fallback:
        assert obs[0][0] == "SolveDeadlineError"
    assert obs[1] is (code == "UNAVAILABLE"
                      or (code == "DEADLINE_EXCEEDED" and not deadline_s))


def test_retries_exhausted_is_typed():
    def scenario(k):
        reg = k.metrics.Registry()
        client = k.client.SolverClient("127.0.0.1:1", timeout=2.0,
                                       retries=1, backoff_s=0.0,
                                       registry=reg)
        req = k.codec.encode_request(pods_of(k, "p", 3), [prov(k)],
                                     small(k))
        try:
            client.solve_raw(req)
        except k.client.SolveRetriesExhausted as err:
            got = (err.code(), err.attempts, isinstance(err, grpc.RpcError))
        finally:
            client.close()
        return got, counter(reg, k.metrics.FAULTS_RECOVERED)

    obs = assert_same(scenario)
    assert obs[0] == (grpc.StatusCode.UNAVAILABLE, 2, True)


def test_ride_through_an_injected_unavailable(monkeypatch):
    """``KT_FAULTS="rpc_unavailable@transport:at=1"`` set while the client
    is built: the first attempt fails UNAVAILABLE, one retry on a fresh
    channel rides through, counted ``retried``."""

    def scenario(k):
        reg = k.metrics.Registry()
        injected0 = counter(k.metrics.registry, k.metrics.FAULTS_INJECTED)
        with serve(k) as (_svc, address, _sreg):
            monkeypatch.setenv("KT_FAULTS", "rpc_unavailable@transport:at=1")
            try:
                client = k.client.SolverClient(address, retries=1,
                                               backoff_s=0.0, registry=reg)
            finally:
                monkeypatch.delenv("KT_FAULTS")
            try:
                req = k.codec.encode_request(pods_of(k, "p", 5), [prov(k)],
                                             small(k))
                resp = client.solve_raw(req)
                got = view(k.codec.decode_response(resp))
            finally:
                client.close()
        injected = {key: v - injected0.get(key, 0.0) for key, v in counter(
            k.metrics.registry, k.metrics.FAULTS_INJECTED).items()}
        return (got, counter(reg, k.metrics.FAULTS_RECOVERED),
                {key: v for key, v in injected.items() if v})

    obs = assert_same(scenario)
    assert obs[1][(("outcome", "retried"), ("site", "transport"))] == 1.0
    assert obs[2] == {(("kind", "rpc_unavailable"),
                       ("site", "transport")): 1.0}


# ---------------------------------------------------------------------------
# DeltaSession (tests/test_delta_serving.py)
# ---------------------------------------------------------------------------


def _entry(service, session_id):
    pipe = list(service._pipelines.values())[0]
    return pipe._delta_tab.get(session_id)


def _synced(service, sess, res):
    entry = _entry(service, sess.session_id)
    assert entry is not None and entry.epoch == sess.epoch
    assert entry.prev.assignments == res.assignments
    assert entry.prev.infeasible == res.infeasible
    assert node_map(entry.prev.nodes) == node_map(res.nodes)
    return view(res)


def _delta_rpc(k, reg):
    return {dict(lk)["outcome"]: v
            for lk, v in reg.counter(k.metrics.DELTA_RPC).values.items()}


def d_churn_chain(k, service, address, reg):
    sess = k.client.DeltaSession(address, session_id="chain")
    base = pods_of(k, "p", 60)
    out = [view(sess.solve(base, [prov(k)], small(k)))]
    live = {p.name for p in base}
    for step in range(6):
        rm = sorted(live)[step::11][:4]
        live -= set(rm)
        add = pods_of(k, f"c{step}", 4, g0=step)
        live |= {p.name for p in add}
        res = sess.solve_delta(added=add, removed=rm)
        out.append(_synced(service, sess, res))
    assert set(res.assignments) == live
    rpc = _delta_rpc(k, reg)
    assert (rpc["delta"], rpc["fallback_full"], rpc["session_unknown"]) \
        == (6, 0, 0)
    sess.close()
    return out, rpc


def d_reclaim_and_ice(k, service, address, reg):
    sess = k.client.DeltaSession(address, session_id="reclaim")
    r = sess.solve(pods_of(k, "p", 24), [prov(k)], small(k))
    victim = r.nodes[0]
    ice = (victim.instance_type, victim.zone, victim.capacity_type)
    r2 = sess.solve_delta(iced=[victim.name, ice])
    assert victim.name not in {n.name for n in r2.nodes}
    assert ice in _entry(service, sess.session_id).unavailable
    out = _synced(service, sess, r2)
    sess.close()
    return out


def d_guard_trip(k, service, address, reg):
    sess = k.client.DeltaSession(address, session_id="guard")
    sess.solve(pods_of(k, "p", 20) + spread_pods(k, "sp", 6), [prov(k)],
               small(k))
    res = sess.solve_delta(removed=["sp-0"])
    out = [_synced(service, sess, res), _delta_rpc(k, reg)]
    res2 = sess.solve_delta(added=pods_of(k, "x", 2))
    out += [_synced(service, sess, res2), _delta_rpc(k, reg)]
    sess.close()
    return out


def d_epoch_bump(k, service, address, reg):
    sess = k.client.DeltaSession(address, session_id="bump")
    sess.solve(pods_of(k, "p", 30), [prov(k)], small(k), catalog_epoch=1)
    full = k.catalog.generate_catalog(full=True)
    res = sess.solve_delta(added=pods_of(k, "x", 2), catalog_epoch=2,
                           instance_types=full)
    entry = _entry(service, sess.session_id)
    out = [_synced(service, sess, res), entry.catalog_epoch,
           len(entry.instance_types), sess.full_resends]
    sess.solve_delta(added=pods_of(k, "y", 2))
    out.append(_delta_rpc(k, reg))
    with pytest.raises(ValueError, match="instance_types"):
        sess.solve_delta(added=pods_of(k, "z", 1), catalog_epoch=7)
    sess.close()
    return out


def d_session_loss(k, service, address, reg):
    sess = k.client.DeltaSession(address, session_id="loss")
    sess.solve(pods_of(k, "p", 20), [prov(k)], small(k))
    list(service._pipelines.values())[0]._delta_tab.clear("stop")
    fr, dr = sess.full_resends, sess.delta_rpcs
    res = sess.solve_delta(added=pods_of(k, "x", 3), removed=["p-0"])
    assert (sess.full_resends, sess.delta_rpcs) == (fr + 1, dr + 1)
    assert "p-0" not in res.assignments
    out = [_synced(service, sess, res), _delta_rpc(k, reg)]
    sess.close()
    return out


def d_epoch_mismatch(k, service, address, reg):
    sess = k.client.DeltaSession(address, session_id="mismatch")
    sess.solve(pods_of(k, "p", 12), [prov(k)], small(k))
    entry = _entry(service, sess.session_id)
    sess._epoch = 99
    res = sess.solve_delta(added=pods_of(k, "x", 1))
    entry2 = _entry(service, sess.session_id)
    assert entry2 is not entry and entry2.epoch > entry.epoch
    out = [_synced(service, sess, res), sess.full_resends]
    sess.close()
    return out


def d_nonce(k, service, address, reg):
    sess = k.client.DeltaSession(address, session_id="nonce")
    sess.solve(pods_of(k, "p", 20), [prov(k)], small(k))
    entry = _entry(service, sess.session_id)
    int(entry.nonce, 16)
    assert len(entry.nonce) == 16 and sess._nonce == entry.nonce
    sess.solve_delta(added=pods_of(k, "x", 2))
    assert sess._nonce == entry.nonce
    # a foreign lineage at the client's acked epoch: typed, one resend
    _entry(service, sess.session_id).nonce = "f" * 16
    res = sess.solve_delta(added=pods_of(k, "y", 3), removed=["p-0"])
    assert sess._nonce == _entry(service, sess.session_id).nonce != "f" * 16
    out = [_synced(service, sess, res), sess.full_resends,
           _delta_rpc(k, reg)]
    # the legacy wildcard: an empty nonce on either side still serves
    sess._nonce = ""
    sess.solve_delta(added=pods_of(k, "z", 1))
    _entry(service, sess.session_id).nonce = ""
    sess._nonce = ""
    sess.solve_delta(added=pods_of(k, "w", 1))
    out.append(_delta_rpc(k, reg))
    sess.close()
    return out


def d_kill_switch_client(k, service, address, reg, monkeypatch=None):
    os.environ["KT_DELTA"] = "0"
    try:
        sess = k.client.DeltaSession(address, session_id="off")
    finally:
        os.environ.pop("KT_DELTA")
    assert not sess.enabled
    pods = pods_of(k, "off", 18)
    sess.solve(list(pods), [prov(k)], small(k))
    r2 = sess.solve_delta(added=pods_of(k, "off2", 2))
    assert sess.full_resends == 2 and not sess.established
    tab = list(service._pipelines.values())[0]._delta_tab
    assert tab is None or len(tab) == 0
    remote = k.client.RemoteScheduler(address)
    plain = remote.solve(pods + pods_of(k, "off2", 2), [prov(k)], small(k))
    remote.close()
    assert partition(r2) == partition(plain)
    sess.close()
    return partition(r2)


def d_shed_preserves_pending(k, service, address, reg):
    sess = k.client.DeltaSession(address, session_id="shed")
    sess.solve(pods_of(k, "p", 12), [prov(k)], small(k))
    epoch0 = sess.epoch
    sess.client = _Raising(sess.client, grpc.StatusCode.RESOURCE_EXHAUSTED,
                           times=2)
    errors = []
    for add in (pods_of(k, "x", 1), pods_of(k, "y", 1)):
        with pytest.raises(k.admission.SolveShedError) as exc:
            sess.solve_delta(added=add,
                             removed=["p-0"] if add[0].name == "x-0" else ())
        errors.append(str(exc.value))
        assert sess.established and sess.epoch == epoch0
    res = sess.solve_delta()
    assert sess.epoch == epoch0 + 1 and sess.full_resends == 1
    assert "x-0" in res.assignments and "y-0" in res.assignments
    out = [errors, _synced(service, sess, res)]
    sess.client = sess.client._inner
    sess.close()
    return out


def d_deadline_typed(k, service, address, reg):
    sess = k.client.DeltaSession(address, session_id="deadline",
                                 deadline_s=30.0)
    sess.solve(pods_of(k, "p", 10), [prov(k)], small(k))
    sess.client = _Raising(sess.client, grpc.StatusCode.DEADLINE_EXCEEDED)
    with pytest.raises(k.admission.SolveDeadlineError) as exc:
        sess.solve_delta(added=pods_of(k, "x", 1))
    assert sess.established
    res = sess.solve_delta()
    assert "x-0" in res.assignments
    out = [str(exc.value), _synced(service, sess, res)]
    sess.client = sess.client._inner
    sess.close()
    return out


def d_readd_pending_removal(k, service, address, reg):
    sess = k.client.DeltaSession(address, session_id="readd")
    sess.solve(pods_of(k, "p", 12), [prov(k)], small(k))
    sess.client = _Raising(sess.client, grpc.StatusCode.RESOURCE_EXHAUSTED)
    with pytest.raises(k.admission.SolveShedError):
        sess.solve_delta(removed=["p-0"])
    new = k.pod.PodSpec(name="p-0", requests={"cpu": 2.0}, owner_key="re")
    res = sess.solve_delta(added=[new])
    entry = _entry(service, sess.session_id)
    seated = [p for n in (list(entry.prev.existing_nodes)
                          + list(entry.prev.nodes))
              for p in n.pods if p.name == "p-0"]
    assert len(seated) == 1 and seated[0].requests == {"cpu": 2.0}
    out = _synced(service, sess, res)
    sess.client = sess.client._inner
    sess.close()
    return out


def d_failed_step(k, service, address, reg):
    sess = k.client.DeltaSession(address, session_id="failed")
    sess.solve(pods_of(k, "p", 12), [prov(k)], small(k))
    pipe = list(service._pipelines.values())[0]
    orig = pipe.scheduler.solve_delta

    def boom(*a, **kw):
        raise RuntimeError("injected mid-step failure")

    pipe.scheduler.solve_delta = boom
    try:
        with pytest.raises(k.client.SolveStepFailed) as exc:
            sess.solve_delta(added=pods_of(k, "x", 1))
    finally:
        pipe.scheduler.solve_delta = orig
    assert _entry(service, sess.session_id) is None
    res = sess.solve_delta(added=pods_of(k, "y", 1))
    assert "x-0" in res.assignments and "y-0" in res.assignments
    out = [type(exc.value).__name__,
           reg.counter(k.metrics.DELTA_EVICTIONS).get({"reason": "error"}),
           _synced(service, sess, res)]
    sess.close()
    return out


def d_preseated_removal(k, service, address, reg):
    it = small(k)[0]
    seated = [k.pod.PodSpec(name=f"seated-{i}", requests={"cpu": 1.0},
                            owner_key="s") for i in range(3)]
    existing = k.types.SimNode(
        instance_type=it.name, provisioner="default", zone="zone-1a",
        capacity_type="on-demand", price=1.0,
        allocatable=dict(it.allocatable), existing=True, name="ex-0",
        pods=list(seated)).stamp_labels()
    sess = k.client.DeltaSession(address, session_id="preseated")
    sess.solve(pods_of(k, "p", 8), [prov(k)], small(k),
               existing_nodes=[existing])
    res = sess.solve_delta(removed=["seated-1"])
    assert all(p.name != "seated-1"
               for n in res.existing_nodes for p in n.pods)
    list(service._pipelines.values())[0]._delta_tab.clear("stop")
    res2 = sess.solve_delta(added=pods_of(k, "z", 1))
    chain = sorted(p.name for n in _entry(service, sess.session_id)
                   .prev.existing_nodes for p in n.pods)
    assert chain == ["seated-0", "seated-2"] and "z-0" in res2.assignments
    out = [view(res), _synced(service, sess, res2)]
    sess.close()
    return out


DELTA_SCENARIOS = {
    "churn_chain": d_churn_chain, "reclaim_and_ice": d_reclaim_and_ice,
    "guard_trip_fallback": d_guard_trip, "catalog_epoch_bump": d_epoch_bump,
    "session_loss": d_session_loss, "epoch_mismatch": d_epoch_mismatch,
    "nonce_guard": d_nonce, "kill_switch_client": d_kill_switch_client,
    "shed_preserves_pending": d_shed_preserves_pending,
    "deadline_typed": d_deadline_typed,
    "readd_during_pending_removal": d_readd_pending_removal,
    "failed_step_evicts": d_failed_step,
    "preseated_removal": d_preseated_removal,
}


@pytest.mark.parametrize("transport", ["tcp", "unix"])
@pytest.mark.parametrize("name", sorted(DELTA_SCENARIOS))
def test_delta_session(name, transport, tmp_path):
    def scenario(k):
        host = (f"unix:{tmp_path}/solver.sock" if transport == "unix"
                else None)
        with serve(k, host=host) as (service, address, reg):
            return DELTA_SCENARIOS[name](k, service, address, reg)

    assert_same(scenario)


def test_delta_off_server_answers_unknown_and_client_recovers(monkeypatch):
    def scenario(k):
        monkeypatch.setenv("KT_DELTA", "0")
        with serve(k) as (service, address, reg):
            assert not service._pipeline_for(service.scheduler).delta_live()
            monkeypatch.delenv("KT_DELTA")
            sess = k.client.DeltaSession(address, session_id="srv-off")
            assert sess.enabled
            sess.solve(pods_of(k, "p", 10), [prov(k)], small(k))
            assert not sess.established
            res = sess.solve_delta(added=pods_of(k, "x", 2))
            assert all(f"x-{i}" in res.assignments for i in range(2))
            sess.close()
            return view(res), sess.full_resends

    assert_same(scenario)


def test_delta_session_needs_an_establishment():
    def scenario(k):
        sess = k.client.DeltaSession("127.0.0.1:1")
        with pytest.raises(k.delta.DeltaSessionUnknown) as exc:
            sess.solve_delta(added=pods_of(k, "x", 1))
        sess.close()
        return str(exc.value)

    assert_same(scenario)


def test_journey_trace_id_is_the_reference_one(monkeypatch):
    """The session's origin-side trace sampling is decided from the
    session id's SHA-256, identically in both packages."""
    monkeypatch.setenv("KT_TRACE_SAMPLE_EVERY", "4")
    monkeypatch.setenv("KT_REPLICA_ID", "origin")
    sampled = {}
    for root in ROOTS:
        k = package(root)
        sampled[root] = [
            k.client.DeltaSession("127.0.0.1:1", session_id=f"s{i}")._trace_id
            for i in range(24)]
    assert sampled[PORT] == sampled[REFERENCE]
    assert any(sampled[PORT]) and not all(sampled[PORT])


# ---------------------------------------------------------------------------
# FleetClient (tests/test_fleet.py)
# ---------------------------------------------------------------------------


def test_fleet_requires_endpoints_and_parses_the_env(monkeypatch):
    def scenario(k):
        with pytest.raises(ValueError) as exc:
            k.client.FleetClient()
        monkeypatch.setenv("KT_FLEET_ENDPOINTS",
                           "unix:/tmp/a.sock, unix:/tmp/b.sock")
        fc = k.client.FleetClient(registry=k.metrics.Registry())
        eps = fc.endpoints
        fc.close()
        monkeypatch.delenv("KT_FLEET_ENDPOINTS")
        return str(exc.value), eps

    obs = assert_same(scenario)
    assert obs[1] == ["unix:/tmp/a.sock", "unix:/tmp/b.sock"]


def test_fleet_rendezvous_is_the_reference_hash():
    """SHA-256 rendezvous, copied exactly: a port client and a reference
    client home every session on the same replica, and a dead endpoint
    moves only its own sessions."""

    def scenario(k):
        eps = [f"unix:/tmp/e{i}.sock" for i in range(3)]
        fc = k.client.FleetClient(eps, registry=k.metrics.Registry())
        orders = [fc.rendezvous(f"session-{i}") for i in range(60)]
        homes = [fc.endpoint_for(f"session-{i}") for i in range(60)]
        assert len(set(homes)) == 3
        dead = max(set(homes), key=homes.count)
        fc._mark(dead, "dead")
        fc._last_probe = {ep: float("inf") for ep in eps}
        moved = [fc.endpoint_for(f"session-{i}") for i in range(60)]
        for i, home in enumerate(moved):
            assert home != dead
            if orders[i][0] != dead:
                assert home == orders[i][0]
        weights = [fc._weight(f"session-{i}", eps[i % 3])
                   for i in range(10)]
        fc.close()
        return orders, homes, moved, weights

    assert_same(scenario)


def test_fleet_bucket_affinity_key_is_the_reference_one():
    def scenario(k):
        out = []
        for n in (0, 1, 3, 40, 257):
            req = k.codec.encode_request(pods_of(k, "p", n), [prov(k)],
                                         small(k), allow_new_nodes=n % 2 == 0)
            out.append(k.client.FleetClient.bucket_affinity_key(req))
        return out

    assert_same(scenario)


def test_fleet_metrics_zero_init_and_states():
    def scenario(k):
        reg = k.metrics.Registry()
        eps = ["unix:/tmp/x.sock", "unix:/tmp/y.sock"]
        fc = k.client.FleetClient(eps, registry=reg)
        out = (counter(reg, k.metrics.FLEET_FAILOVERS),
               {dict(lk)["state"]: v for lk, v in
                reg.gauge(k.metrics.FLEET_ENDPOINTS).values.items()},
               fc.states())
        fc.close()
        return out

    obs = assert_same(scenario)
    assert obs[1] == {"known": 2.0, "healthy": 2.0, "draining": 0.0}


def test_fleet_fails_over_a_dead_endpoint(tmp_path):
    """A session whose home is a dead address re-routes to the live
    replica, counted failover ``death``; the dead endpoint reads dead."""

    def scenario(k):
        reg = k.metrics.Registry()
        with serve(k, host=f"unix:{tmp_path}/live.sock") as (
                service, live, _sreg):
            dead = "127.0.0.1:1"
            fc = k.client.FleetClient([dead, live], retries=0,
                                      backoff_s=0.0, registry=reg,
                                      reconnect_interval=600.0)
            sid = next(f"s{i}" for i in range(100)
                       if fc.rendezvous(f"s{i}")[0] == dead)
            sess = k.client.DeltaSession(live, session_id=sid, client=fc)
            res = sess.solve(pods_of(k, "p", 16), [prov(k)], small(k))
            res2 = sess.solve_delta(added=pods_of(k, "x", 2))
            out = (view(res), _synced(service, sess, res2), fc.states(),
                   counter(reg, k.metrics.FLEET_FAILOVERS),
                   sess.full_resends)
            sess.close()
            return out

    obs = assert_same(scenario)
    assert obs[2]["127.0.0.1:1"] == "dead" and obs[4] == 1


def build_replica(k, sock, spool, replica, lease_s=0.4, snapshot_s=0.0001):
    """One in-process replica with its spool config captured from the env
    at construction (scripts/chaos_drive.py's ``_build_replica``)."""
    saved = {}
    env = {"KT_REPLICA_ID": replica, "KT_SESSION_DIR": spool,
           "KT_SESSION_SNAPSHOT_S": str(snapshot_s),
           "KT_SESSION_LEASE_S": str(lease_s)}
    try:
        for key, val in env.items():
            saved[key] = os.environ.pop(key, None)
            os.environ[key] = val
        reg = k.metrics.Registry()
        sched = scheduler(k, "oracle", reg)
        service = k.server.SolverService(sched, registry=reg)
        pipe = service._pipeline_for(sched)
        srv, _ = k.server.make_server(service, host=sock)
    finally:
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old
    return {"k": k, "reg": reg, "service": service, "pipe": pipe,
            "srv": srv, "sock": sock, "alive": True}


def hard_kill(rep):
    rep["srv"].stop(grace=None)
    rep["pipe"]._stop.set()
    rep["pipe"]._thread.join(timeout=10)
    rep["alive"] = False


def settle_spool(reps, deadline_s=10.0):
    k = reps[0]["k"]
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        behind = 0
        for rep in reps:
            tab, spool = rep["pipe"]._delta_tab, rep["pipe"]._spool_dir
            if not rep["alive"] or tab is None or not spool:
                continue
            with tab._lock:
                live = {sid: e.epoch for sid, e in tab._sessions.items()}
            for sid, epoch in live.items():
                blob = k.snapshot.read_record(spool, sid)
                try:
                    raw, _ = k.snapshot.unpack(blob)
                    if int(k.snapshot.unpack_entry(raw[0])["epoch"]) != epoch:
                        behind += 1
                except (k.snapshot.SnapshotRefused, TypeError):
                    behind += 1
        if behind == 0:
            return
        time.sleep(0.05)
    raise RuntimeError("the session spool never settled")


@contextlib.contextmanager
def fleet(k, tmp_path, monkeypatch):
    monkeypatch.setenv("KT_SESSION_SNAPSHOT_S", "0.0001")
    monkeypatch.setenv("KT_SESSION_LEASE_S", "0.4")
    spool = str(tmp_path / f"{k.root}-spool")
    reps = [build_replica(k, f"unix:{tmp_path}/r{i}.sock", spool,
                          f"replica-{i}") for i in range(3)]
    try:
        yield reps
    finally:
        for rep in reps:
            if rep["alive"]:
                rep["srv"].stop(grace=None)
            rep["service"].close()
            unlink_socket(rep["sock"])


def fleet_sessions(k, reps):
    socks = [r["sock"] for r in reps]
    fc = k.client.FleetClient(socks, timeout=60.0, retries=0,
                              backoff_s=0.01)
    return fc, k.client.DeltaSession(socks[0], timeout=60.0, client=fc,
                                     session_id="journey")


def test_fleet_kill_one_replica_adopts_warm(tmp_path, monkeypatch):
    def scenario(k):
        with fleet(k, tmp_path, monkeypatch) as reps:
            fc, sess = fleet_sessions(k, reps)
            sess.solve(pods_of(k, "kw", 150), [prov(k)], small(k))
            for i in range(2):
                sess.solve_delta(added=pods_of(k, f"kw{i}", 2))
            settle_spool(reps)
            home = fc.endpoint_for(sess.session_id)
            victim = next(r for r in reps if r["sock"] == home)
            hard_kill(victim)
            time.sleep(0.7)  # past the 0.4 s lease
            epoch = sess.epoch
            cur = sess.solve_delta(added=pods_of(k, "kwpost", 2))
            assert sess.full_resends == 1 and sess.epoch == epoch + 1
            new_home = fc.endpoint_for(sess.session_id)
            adopter = next(r for r in reps if r["sock"] == new_home)
            assert new_home != home
            with adopter["pipe"]._delta_tab._lock:
                entry = adopter["pipe"]._delta_tab._sessions[sess.session_id]
            assert entry.prev.assignments == cur.assignments
            out = (reps.index(victim), reps.index(adopter), view(cur),
                   counter(adopter["reg"], k.metrics.SESSION_ADOPTIONS))
            sess.close()
            return out

    obs = assert_same(scenario)
    assert obs[3][(("outcome", "stolen"),)] == 1.0


def test_fleet_drain_rehomes_warm(tmp_path, monkeypatch):
    def scenario(k):
        with fleet(k, tmp_path, monkeypatch) as reps:
            fc, sess = fleet_sessions(k, reps)
            sess.solve(pods_of(k, "dh", 120), [prov(k)], small(k))
            sess.solve_delta(added=pods_of(k, "dh1", 2))
            home = fc.endpoint_for(sess.session_id)
            victim = next(r for r in reps if r["sock"] == home)
            victim["service"].drain()
            epoch = sess.epoch
            sess.solve_delta(added=pods_of(k, "dh2", 2))
            assert sess.epoch == epoch + 1
            assert fc.states()[home] == "draining"
            cur = sess.solve_delta(added=pods_of(k, "dh3", 2))
            assert sess.full_resends == 1 and sess.epoch == epoch + 2
            new_home = fc.endpoint_for(sess.session_id)
            adopter = next(r for r in reps if r["sock"] == new_home)
            out = (reps.index(victim), reps.index(adopter), view(cur),
                   victim["reg"].counter(k.metrics.DELTA_EVICTIONS).get(
                       {"reason": "drain"}),
                   counter(adopter["reg"], k.metrics.SESSION_ADOPTIONS),
                   counter(fc._registry, k.metrics.FLEET_FAILOVERS))
            sess.close()
            return out

    obs = assert_same(scenario)
    assert obs[3] == 1.0 and obs[4][(("outcome", "adopted"),)] == 1.0


def test_fleet_wide_drain_refuses_typed(tmp_path, monkeypatch):
    def scenario(k):
        with fleet(k, tmp_path, monkeypatch) as reps:
            for rep in reps:
                rep["service"].drain()
            fc, sess = fleet_sessions(k, reps)
            with pytest.raises(k.client.SolverDraining) as exc:
                sess.solve(pods_of(k, "fd", 40), [prov(k)], small(k))
            one = k.client.DeltaSession(reps[0]["sock"], session_id="one")
            with pytest.raises(k.client.SolverDraining):
                one.solve(pods_of(k, "dr", 40), [prov(k)], small(k))
            out = (str(exc.value), [r["reg"].counter(
                k.metrics.DELTA_RPC).get({"outcome": "drain_refused"})
                for r in reps])
            sess.close()
            one.close()
            return out

    assert_same(scenario)
