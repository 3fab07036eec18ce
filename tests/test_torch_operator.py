"""The port's operator and its host control plane against the reference
package, on the CPU: ``operator.py`` (``Lease``, ``InMemoryLeaseStore``,
``LeaderElector``, ``Operator``), ``controllers/{garbagecollect,
interruption,nodetemplate}.py``, ``providers/{pricing,subnet,
securitygroup}.py`` and ``cloud/batched.py``.

Every scenario of the reference's ``tests/test_operator.py``,
``tests/test_periphery.py`` (the parts these modules own),
``tests/test_batched_cloud.py`` and ``tests/test_split_topology.py`` is
one function over a package namespace ``k``, run over the reference's
modules and over the port's from fresh name counters (machines, fake
instances, auto-named nodes), each package under its own ``FakeClock``.
The reference's assertions hold on both, and what each run observed —
bindings, node plans, pending pods, events, lease holders and metric
counts — must be equal.  The port's operators solve on ``device="cpu"``
(in-process) or through a sidecar of their own package on loopback
(remote); the remote operator's scale-up must equal the in-process
operator's, and its scale-down the reference's remote operator's.

Tolerance: equal.
"""

import contextlib
import importlib
import itertools
import json
import os
import socket
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"
ROOTS = (REFERENCE, PORT)
MODULES = {
    "operator": "operator", "batched": "cloud.batched",
    "base": "cloud.base", "fake": "cloud.fake",
    "templates": "cloud.templates", "gc": "controllers.garbagecollect",
    "interruption": "controllers.interruption",
    "nodetemplate": "controllers.nodetemplate",
    "provisioning": "controllers.provisioning",
    "state_mod": "controllers.state",
    "termination": "controllers.termination", "events": "events",
    "metrics": "metrics", "L": "models.labels", "catalog": "models.catalog",
    "machine": "models.machine", "pod": "models.pod",
    "provisioner": "models.provisioner", "req": "models.requirements",
    "pricing": "providers.pricing", "sg": "providers.securitygroup",
    "subnet": "providers.subnet", "settings": "settings",
    "scheduler": "solver.scheduler", "types": "solver.types",
    "clock": "utils.clock", "client": "service.client",
    "server": "service.server",
}
_PACKAGES: dict = {}

COUNTED = (
    "karpenter_nodes_created_total", "karpenter_nodes_terminated_total",
    "karpenter_deprovisioning_actions_performed_total",
    "karpenter_provisioner_usage", "karpenter_provisioner_limit",
    "karpenter_interruption_received_messages_total",
    "karpenter_interruption_message_latency_seconds",
    "karpenter_solver_remote_fallback_solves_total",
    "karpenter_solver_remote_degraded",
)


def package(root: str) -> SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = SimpleNamespace(root=root, **{
            alias: importlib.import_module(f"{root}.{path}")
            for alias, path in MODULES.items()})
    return _PACKAGES[root]


def reset_counters(k) -> None:
    k.machine._machine_counter = itertools.count()
    k.fake._instance_counter = itertools.count()
    with k.types._node_lock:
        k.types._node_next = 0


def run_both(scenario, *args):
    seen = {}
    for root in ROOTS:
        k = package(root)
        reset_counters(k)
        seen[root] = scenario(k, *args)
    assert seen[PORT] == seen[REFERENCE]
    return seen[PORT]


def small(k):
    return k.catalog.generate_catalog(full=False)


def operator(k, cloud, clock, **kw):
    """The package's ``Operator``; the port's in-process scheduler on the
    host CPU (a remote one needs no device)."""
    kw.setdefault("registry", k.metrics.Registry())
    kw.setdefault("scheduler_backend", "oracle")
    if k.root == PORT and not kw.get("solver_address"):
        kw["device"] = "cpu"
    return k.operator.Operator(cloud, clock=clock, **kw)


def metric_counts(registry) -> dict:
    out = {}
    for name in COUNTED:
        if name in registry.counters:
            out[name] = dict(registry.counters[name].values)
        if name in registry.gauges:
            out[name] = dict(registry.gauges[name].values)
        if name in registry.histograms:
            out[name] = dict(registry.histograms[name].totals)
    return out


def snapshot(op) -> dict:
    state = op.state
    return dict(
        bindings=dict(sorted(state.bindings.items())),
        nodes=sorted(
            (ns.node.name, ns.node.instance_type, ns.node.zone,
             ns.node.capacity_type, round(ns.node.price, 6),
             tuple(sorted(p.name for p in ns.node.pods)))
            for ns in state.nodes.values()),
        pending=sorted(p.name for p in state.pending_pods()),
        events=[(e.kind, e.name, e.reason, e.message, e.event_type)
                for e in op.recorder.events],
        metrics=metric_counts(op.registry),
    )


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def pods(k, n, tag="p", cpu=None):
    return [k.pod.PodSpec(name=f"{tag}{i}",
                          requests={"cpu": cpu or 0.5 + (i % 4) * 0.5},
                          owner_key=f"d{i % 5}") for i in range(n)]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ("KT_OBS_PEERS", "KT_SOLVER_DEADLINE_MS", "KT_FAULTS",
                 "KT_SESSION_DIR", "KT_DELTA", "KARPENTER_SOLVER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KT_TS_INTERVAL_S", "0")


# ---------------------------------------------------------------------------
# the operator (tests/test_operator.py::TestOperator)
# ---------------------------------------------------------------------------


def default_op(k):
    clock = k.clock.FakeClock()
    cloud = k.fake.FakeCloudProvider(small(k), clock=clock)
    op = operator(k, cloud, clock)
    op.state.apply_provisioner(k.provisioner.Provisioner(
        name="default", consolidation_enabled=True))
    return op


def s_scale_up(k):
    op = default_op(k)
    for i in range(20):
        op.state.add_pod(k.pod.PodSpec(name=f"p{i}", requests={"cpu": 0.5},
                                       owner_key="d"))
    for _ in range(3):
        op.tick()
        op.clock.advance(1.5)
    assert not op.state.pending_pods() and op.state.nodes
    return snapshot(op)


def s_leadership_gates(k):
    clock = k.clock.FakeClock()
    op = operator(k, k.fake.FakeCloudProvider(small(k), clock=clock), clock)
    op.elector = k.operator.LeaderElector(elect=lambda: False)
    op.state.apply_provisioner(k.provisioner.Provisioner(name="default"))
    op.state.add_pod(k.pod.PodSpec(name="p", requests={"cpu": 0.5}))
    for _ in range(3):
        op.tick()
        clock.advance(2.0)
    assert not op.state.nodes
    return snapshot(op)


def s_hydration_adopts(k):
    clock = k.clock.FakeClock()
    cloud = k.fake.FakeCloudProvider(small(k), clock=clock)
    cloud.create(k.machine.Machine(
        provisioner="default",
        requirements=k.req.Requirements([k.req.Requirement(
            k.L.INSTANCE_TYPE, k.req.IN, ["m5.large"])])))
    op = operator(k, cloud, clock)
    op.state.apply_provisioner(k.provisioner.Provisioner(name="default"))
    op.tick()
    assert len(op.state.nodes) == 1
    return snapshot(op)


def s_restart_resumes(k):
    clock = k.clock.FakeClock()
    cloud = k.fake.FakeCloudProvider(small(k), clock=clock)

    def durable(op):
        op.state.apply_provisioner(k.provisioner.Provisioner(
            name="default", consolidation_enabled=True))
        for i in range(6):
            op.state.add_pod(k.pod.PodSpec(name=f"p{i}",
                                           requests={"cpu": 1.0},
                                           owner_key="d"))

    op1 = operator(k, cloud, clock)
    durable(op1)
    for _ in range(3):
        op1.tick()
        clock.advance(1.5)
    n_nodes, launches = len(op1.state.nodes), len(cloud.create_calls)
    first = snapshot(op1)
    op1.shutdown()
    op2 = operator(k, cloud, clock)
    durable(op2)
    for _ in range(3):
        op2.tick()
        clock.advance(1.5)
    assert len(op2.state.nodes) == n_nodes
    assert len(cloud.create_calls) == launches
    assert not op2.state.pending_pods()
    live = [i for i in cloud.instances.values() if not i.terminated]
    assert len(live) == n_nodes
    return first, snapshot(op2)


def s_settings_hot_reload(k):
    op = default_op(k)
    op.settings.update(batch_idle_duration=0.1, batch_max_duration=5.0)
    op.settings.update(drift_enabled=True)
    op.settings.update(deprovisioning_ttl=30.0)
    op.settings.update(isolated_vpc=True)
    with pytest.raises(ValueError) as exc:
        op.settings.update(deprovisioning_ttl=-1.0)
    return (op.provisioning.window.idle, op.deprovisioning.drift_enabled,
            op.deprovisioning.deprovisioning_ttl, op.pricing.isolated_vpc,
            str(exc.value))


def s_interruption_gated(k):
    op = default_op(k)
    op.state.add_pod(k.pod.PodSpec(name="p", requests={"cpu": 0.5}))
    for _ in range(3):
        op.tick()
        op.clock.advance(1.5)
    node = op.state.bindings["p"]
    pid = op.state.nodes[node].machine.provider_id
    op.queue.send(k.interruption.InterruptionMessage(
        k.interruption.SPOT_INTERRUPTION, pid, op.clock.now()))
    op.tick()
    assert node in op.state.nodes and len(op.queue) == 1
    op.settings.update(interruption_queue_name="q")
    op.tick()
    assert node not in op.state.nodes
    return snapshot(op)


def s_operator_pushes_settings(k):
    clock = k.clock.FakeClock()
    cloud = k.fake.FakeCloudProvider(small(k), clock=clock)
    op = operator(k, cloud, clock)
    op.settings.update(cluster_name="blue",
                       node_name_convention="resource-name",
                       tags={"owner": "sre"})
    return cloud.cluster_name, cloud.node_name_convention, cloud.default_tags


OPERATOR_SCENARIOS = {
    "scale_up_via_ticks": s_scale_up,
    "leadership_gates_reconciles": s_leadership_gates,
    "hydration_on_election_adopts_orphans": s_hydration_adopts,
    "restart_resumes_from_cloud_state": s_restart_resumes,
    "settings_hot_reload_rewires_batch_window": s_settings_hot_reload,
    "interruption_gated_on_queue_name": s_interruption_gated,
    "operator_pushes_settings_into_cloud": s_operator_pushes_settings,
}


@pytest.mark.parametrize("name", sorted(OPERATOR_SCENARIOS))
def test_operator(name):
    run_both(OPERATOR_SCENARIOS[name])


def http(url: str):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.headers.get("Content-Type"), \
                resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, None, ""


def test_http_endpoints():
    """/metrics, /healthz, /tracez, /statusz, /fleetz (no peers) and a
    404 on the operator's HTTP server, as the reference serves them."""

    def scenario(k):
        clock = k.clock.FakeClock()
        cloud = k.fake.FakeCloudProvider(small(k), clock=clock)
        op = operator(k, cloud, clock, metrics_port=free_port())
        port = op.start_http()
        try:
            op.state.apply_provisioner(k.provisioner.Provisioner(
                name="default"))
            op.state.add_pod(k.pod.PodSpec(name="p", requests={"cpu": 0.5}))
            op.tick()
            clock.advance(1.5)
            op.tick()
            base = f"http://127.0.0.1:{port}"
            code, _ct, metrics = http(f"{base}/metrics")
            assert code == 200 and "karpenter_nodes_created_total" in metrics
            samples = sorted(ln for ln in metrics.splitlines()
                             if ln.startswith("karpenter_nodes_created"))
            health = http(f"{base}/healthz")[:2]
            tz = json.loads(http(f"{base}/tracez")[2])
            names = {c["name"] for t in tz["traces"]
                     for c in t.get("spans", ())}
            assert {"window", "dispatch"} <= names
            st = json.loads(http(f"{base}/statusz")[2])
            assert st["flight_recorder"]["ring"] == tz["count"]
            fz = json.loads(http(f"{base}/fleetz")[2])
            return (samples, health, tz["count"], sorted(names),
                    sorted(st), st["fallbacks"], sorted(fz),
                    fz["partial"], len(fz["replicas"]), http(f"{base}/nope")[0])
        finally:
            op.shutdown()

    obs = run_both(scenario)
    assert obs[1] == (200, None) and obs[-1] == 404


def test_admission_over_http():
    good = ("apiVersion: karpenter.sh/v1alpha5\nkind: Provisioner\n"
            "metadata:\n  name: web\nspec:\n  limits:\n    resources:\n"
            "      cpu: 100\n")
    bad = ("apiVersion: karpenter.sh/v1alpha5\nkind: Provisioner\n"
           "metadata:\n  name: web\nspec:\n  weight: -3\n")

    def scenario(k):
        op = default_op(k)
        out = [op.admit_http(good), op.admit_http(bad), op.admit_http(""),
               op.admit_http("kind: Deployment\n"),
               op.admit_http(good, apply=True)]
        return out, sorted(op.state.provisioners)

    obs = run_both(scenario)
    assert obs[0][0][0] == 200 and obs[0][1][0] == 422
    assert "web" in obs[1]


# ---------------------------------------------------------------------------
# leader election (tests/test_operator.py::TestLeaderElection)
# ---------------------------------------------------------------------------


def pair(k):
    clock = k.clock.FakeClock()
    store = k.operator.InMemoryLeaseStore()
    cloud = k.fake.FakeCloudProvider(small(k), clock=clock)

    def mk(ident):
        op = operator(k, cloud, clock, lease_store=store, identity=ident)
        op.state.apply_provisioner(k.provisioner.Provisioner(name="default"))
        return op

    return clock, store, cloud, mk("op-1"), mk("op-2")


def lease_of(store):
    lease = store.get("karpenter-tpu-leader")
    return None if lease is None else (lease.holder, lease.renewed_at,
                                       lease.ttl)


def e_holder_renews(k):
    clock, store, _cloud, op1, op2 = pair(k)
    op1.tick()
    seen = []
    for _ in range(10):
        clock.advance(5.0)
        op1.tick()
        op2.tick()
        seen.append((op1.elector.elected, op2.elector.elected))
    assert all(s == (True, False) for s in seen)
    return seen, lease_of(store)


def e_standby_does_not_reconcile(k):
    clock, store, cloud, op1, op2 = pair(k)
    op1.tick()
    op2.state.add_pod(k.pod.PodSpec(name="p", requests={"cpu": 0.5}))
    for _ in range(3):
        op2.tick()
        clock.advance(1.5)
        op1.tick()
    assert not cloud.create_calls and "p" not in op2.state.bindings
    return lease_of(store), snapshot(op2)


def e_failover_mid_reconcile(k):
    clock, store, cloud, op1, op2 = pair(k)
    for op in (op1, op2):
        for i in range(4):
            op.state.add_pod(k.pod.PodSpec(name=f"p{i}",
                                           requests={"cpu": 1.0},
                                           owner_key="d"))
    op1.tick()
    clock.advance(1.5)
    op1.tick()
    launches, n_nodes = len(cloud.create_calls), len(op1.state.nodes)
    clock.advance(5.0)
    op2.tick()
    assert not op2.elector.elected
    clock.advance(k.operator.LeaderElector.DEFAULT_TTL + 1.0)
    for _ in range(3):
        op2.tick()
        clock.advance(1.5)
    assert op2.elector.elected and len(op2.state.nodes) == n_nodes
    assert len(cloud.create_calls) == launches
    assert not op2.state.pending_pods()
    return lease_of(store), snapshot(op1), snapshot(op2)


def e_deposed_steps_down(k):
    clock, store, _cloud, op1, op2 = pair(k)
    op1.tick()
    clock.advance(k.operator.LeaderElector.DEFAULT_TTL + 1.0)
    op2.tick()
    op1.tick()
    assert op2.elector.elected and not op1.elector.elected
    return lease_of(store)


def e_clean_shutdown(k):
    _clock, store, _cloud, op1, op2 = pair(k)
    op1.tick()
    op1.shutdown()
    op2.tick()
    assert op2.elector.elected
    return lease_of(store)


def e_lease_store(k):
    store = k.operator.InMemoryLeaseStore()
    out = [store.try_acquire("l", "a", 10.0, 0.0),
           store.try_acquire("l", "b", 10.0, 5.0),
           store.try_acquire("l", "a", 10.0, 6.0),
           store.try_acquire("l", "b", 10.0, 16.0),
           store.get("l").expired(25.9), store.get("l").expired(26.0)]
    store.release("l", "a")
    out.append(lease_of_named(store, "l"))
    store.release("l", "b")
    out.append(store.get("l"))
    return out


def lease_of_named(store, name):
    lease = store.get(name)
    return (lease.holder, lease.renewed_at, lease.ttl)


ELECTION_SCENARIOS = {
    "holder_renews_and_standby_never_steals": e_holder_renews,
    "standby_does_not_reconcile": e_standby_does_not_reconcile,
    "failover_mid_reconcile_resumes_within_ttl": e_failover_mid_reconcile,
    "deposed_leader_steps_down": e_deposed_steps_down,
    "clean_shutdown_hands_over_without_waiting_ttl": e_clean_shutdown,
    "lease_store_grants_renews_refuses": e_lease_store,
}


@pytest.mark.parametrize("name", sorted(ELECTION_SCENARIOS))
def test_leader_election(name):
    run_both(ELECTION_SCENARIOS[name])


def test_default_identities_are_unique():
    for root in ROOTS:
        k = package(root)
        ids = {k.operator.LeaderElector().identity for _ in range(8)}
        assert len(ids) == 8 and all(i.startswith("operator-") for i in ids)


# ---------------------------------------------------------------------------
# periphery (tests/test_periphery.py)
# ---------------------------------------------------------------------------


def make_env(k, provisioner=None):
    clock = k.clock.FakeClock()
    state = k.state_mod.ClusterState(clock=clock)
    cloud = k.fake.FakeCloudProvider(small(k), clock=clock)
    rec, reg = k.events.Recorder(), k.metrics.Registry()
    sched = (k.scheduler.BatchScheduler(backend="oracle", registry=reg)
             if k.root == REFERENCE else k.scheduler.BatchScheduler(
                 backend="oracle", registry=reg, device="cpu"))
    prov = k.provisioning.ProvisioningController(
        state, cloud, scheduler=sched, recorder=rec, registry=reg,
        clock=clock)
    term = k.termination.TerminationController(
        state, cloud, recorder=rec, registry=reg, clock=clock)
    state.apply_provisioner(provisioner
                            or k.provisioner.Provisioner(name="default"))
    return SimpleNamespace(clock=clock, state=state, cloud=cloud, prov=prov,
                           term=term, rec=rec, reg=reg)


def pump(ctrl, clock):
    ctrl.reconcile()
    clock.advance(1.5)
    return ctrl.reconcile()


def spot_env(k):
    env = make_env(k, k.provisioner.Provisioner(
        name="default", requirements=[k.req.Requirement(
            k.L.CAPACITY_TYPE, k.req.IN, [k.L.CAPACITY_TYPE_SPOT])]))
    env.state.add_pod(k.pod.PodSpec(name="p", requests={"cpu": 0.5}))
    pump(env.prov, env.clock)
    env.ns = env.state.nodes[env.state.bindings["p"]]
    env.queue = k.interruption.MessageQueue()
    env.ic = k.interruption.InterruptionController(
        env.state, env.term, env.queue, unavailable=env.prov.unavailable,
        recorder=env.rec, registry=env.reg, clock=env.clock)
    return env


def env_view(env):
    return dict(
        nodes=sorted(env.state.nodes), bindings=dict(env.state.bindings),
        events=[(e.kind, e.name, e.reason, e.message, e.event_type)
                for e in env.rec.events],
        metrics=metric_counts(env.reg))


def i_spot_interruption(k):
    env = spot_env(k)
    env.queue.send(k.interruption.InterruptionMessage(
        k.interruption.SPOT_INTERRUPTION, env.ns.machine.provider_id,
        env.clock.now() - 2.0))
    handled = env.ic.reconcile()
    assert handled == 1 and env.ns.node.name not in env.state.nodes
    assert env.ic.unavailable.is_unavailable(
        env.ns.node.instance_type, env.ns.node.zone, k.L.CAPACITY_TYPE_SPOT)
    hist = env.reg.histogram(
        "karpenter_interruption_message_latency_seconds")
    return handled, env_view(env), dict(hist.sums)


def i_rebalance(k):
    env = spot_env(k)
    env.queue.send(k.interruption.InterruptionMessage(
        k.interruption.REBALANCE_RECOMMENDATION, env.ns.machine.provider_id,
        env.clock.now()))
    env.ic.reconcile()
    assert env.ns.node.name in env.state.nodes
    return env_view(env)


def i_state_change(k):
    env = spot_env(k)
    env.queue.send(k.interruption.InterruptionMessage(
        k.interruption.STATE_CHANGE, env.ns.machine.provider_id,
        env.clock.now(), state="stopping"))
    env.ic.reconcile()
    assert env.ns.node.name not in env.state.nodes
    return env_view(env)


def i_unknown_instance(k):
    env = spot_env(k)
    env.queue.send(k.interruption.InterruptionMessage(
        k.interruption.SPOT_INTERRUPTION, "fake://unknown/999",
        env.clock.now()))
    assert env.ic.reconcile() == 1
    return env_view(env)


def g_gc_reaps(k):
    env = make_env(k)
    env.cloud.create(k.machine.Machine(
        provisioner="other", requirements=k.req.Requirements([
            k.req.Requirement(k.L.INSTANCE_TYPE, k.req.IN, ["m5.large"])])))
    gc = k.gc.GarbageCollectController(env.state, env.cloud,
                                       recorder=env.rec, clock=env.clock)
    young = gc.reconcile()
    env.clock.advance(6 * 60)
    reaped = gc.reconcile()
    assert (young, reaped, len(env.cloud.list())) == (0, 1, 0)
    return env_view(env)


def g_link_adopts(k):
    env = make_env(k)
    m = env.cloud.create(k.machine.Machine(
        provisioner="default", requirements=k.req.Requirements([
            k.req.Requirement(k.L.INSTANCE_TYPE, k.req.IN, ["m5.large"])])))
    link = k.gc.LinkController(env.state, env.cloud, recorder=env.rec,
                               clock=env.clock)
    assert link.reconcile() == 1
    ns = next(iter(env.state.nodes.values()))
    assert ns.machine.provider_id == m.provider_id
    gc = k.gc.GarbageCollectController(env.state, env.cloud,
                                       recorder=env.rec, clock=env.clock)
    env.clock.advance(10 * 60)
    assert gc.reconcile() == 0
    return env_view(env), ns.node.labels


def p_lookups(k):
    p = k.pricing.PricingProvider(small(k))
    od = p.on_demand_price("m5.xlarge")
    sp = p.spot_price("m5.xlarge", "zone-1a")
    assert od and sp and sp < od
    return od, sp, p.price("m5.xlarge", "zone-1a", "on-demand"), \
        p.liveness_ok()


def p_refresh(k):
    clock = k.clock.FakeClock()
    prices = {"val": 1.0}
    p = k.pricing.PricingProvider(
        small(k), source=lambda: [("m5.xlarge", "zone-1a", "on-demand",
                                   prices["val"])],
        clock=clock, refresh_period=100.0)
    out = [p.maybe_refresh(), p.on_demand_price("m5.xlarge"), p.updates,
           p.maybe_refresh()]
    clock.advance(101)
    out += [p.maybe_refresh(), p.updates]
    prices["val"] = 2.0
    clock.advance(101)
    out += [p.maybe_refresh(), p.on_demand_price("m5.xlarge")]
    return out


def p_isolated_vpc(k):
    clock = k.clock.FakeClock()
    static = k.pricing.PricingProvider(small(k)).on_demand_price("m5.xlarge")
    p = k.pricing.PricingProvider(
        small(k), source=lambda: [("m5.xlarge", "zone-1a", "on-demand", 99.0)],
        clock=clock, refresh_period=1.0, isolated_vpc=True)
    clock.advance(100)
    out = (p.maybe_refresh(), p.on_demand_price("m5.xlarge"), p.updates)
    assert out == (False, static, 0)
    return out


def t_nodetemplate_status(k):
    clock = k.clock.FakeClock()
    subnets = k.subnet.SubnetProvider([
        k.subnet.Subnet("sn-1", "zone-1a", 100, tags={"env": "prod"}),
        k.subnet.Subnet("sn-2", "zone-1b", 50, tags={"env": "dev"})])
    sgs = k.sg.SecurityGroupProvider([
        k.sg.SecurityGroup("sg-1", tags={"env": "prod"}),
        k.sg.SecurityGroup("sg-2", tags={"env": "dev"})], clock=clock)
    ctrl = k.nodetemplate.NodeTemplateController(subnets, sgs, clock=clock)
    ctrl.apply(k.templates.NodeTemplate(
        name="t", subnet_selector={"env": "prod"},
        security_group_selector={"env": "prod"}))
    t = ctrl.get("t")
    assert t.status_subnets == ["sn-1"] and t.status_security_groups == \
        ["sg-1"] and t.status_images
    clock.advance(301)
    requeued = ctrl.reconcile()
    return (t.status_subnets, t.status_security_groups,
            [i.image_id for i in t.status_images], requeued)


def t_subnets(k):
    p = k.subnet.SubnetProvider([
        k.subnet.Subnet("sn-a1", "zone-1a", 10),
        k.subnet.Subnet("sn-a2", "zone-1a", 100),
        k.subnet.Subnet("sn-b1", "zone-1b", 5)])
    out = [p.zonal_subnets_for_launch({})["zone-1a"].subnet_id]
    p.reserve("sn-a2", 95)
    out.append(p.zonal_subnets_for_launch({})["zone-1a"].subnet_id)
    p.sync("sn-a2", 100)
    out.append(p.zonal_subnets_for_launch({})["zone-1a"].subnet_id)
    q = k.subnet.SubnetProvider([k.subnet.Subnet("sn-b1", "zone-1b", 1)])
    q.reserve("sn-b1", 1)
    out.append(sorted(q.zonal_subnets_for_launch({})))
    assert out == ["sn-a2", "sn-a1", "sn-a2", []]
    return out


def t_security_groups(k):
    clock = k.clock.FakeClock()
    groups = [k.sg.SecurityGroup("sg-1", tags={"env": "prod"}),
              k.sg.SecurityGroup("sg-2", tags={"env": "dev"})]
    p = k.sg.SecurityGroupProvider(groups, clock=clock)
    out = [[g.group_id for g in p.list({"env": "prod"})],
           [g.group_id for g in p.list({"id": "sg-2"})]]
    groups.append(k.sg.SecurityGroup("sg-3", tags={"env": "prod"}))
    out.append([g.group_id for g in p.list({"env": "prod"})])
    clock.advance(3600)
    out.append([g.group_id for g in p.list({"env": "prod"})])
    return out


PERIPHERY_SCENARIOS = {
    "spot_interruption_drains_and_blacklists": i_spot_interruption,
    "rebalance_is_advisory": i_rebalance,
    "state_change_stopping_drains": i_state_change,
    "unknown_instance_ignored": i_unknown_instance,
    "gc_reaps_leaked_instances": g_gc_reaps,
    "link_adopts_owned_orphans": g_link_adopts,
    "pricing_lookups_from_catalog": p_lookups,
    "pricing_refresh_period_and_change_monitor": p_refresh,
    "pricing_isolated_vpc_static_fallback": p_isolated_vpc,
    "nodetemplate_controller_status": t_nodetemplate_status,
    "subnets_zonal_pick_and_inflight": t_subnets,
    "security_groups_selector_and_ttl": t_security_groups,
}


@pytest.mark.parametrize("name", sorted(PERIPHERY_SCENARIOS))
def test_periphery(name):
    run_both(PERIPHERY_SCENARIOS[name])


def test_no_dead_settings_keys_in_the_port():
    """Every ``Settings`` field is read somewhere in the port outside
    ``settings.py`` (the reference's test over its own package)."""
    import pathlib
    from dataclasses import fields

    from karpenter_tpu_torch.settings import Settings

    root = pathlib.Path(__file__).resolve().parents[1] / PORT
    corpus = "\n".join(p.read_text() for p in root.rglob("*.py")
                       if p.name != "settings.py")
    for f in fields(Settings):
        assert f.name in corpus, f"settings key {f.name!r} is read nowhere"


# ---------------------------------------------------------------------------
# BatchedCloud (tests/test_batched_cloud.py)
# ---------------------------------------------------------------------------


def machine(k, itype="m5.large"):
    reqs = k.req.Requirements()
    reqs.add(k.req.Requirement(k.L.INSTANCE_TYPE, k.req.IN, [itype]))
    return k.machine.Machine(provisioner="default", requirements=reqs)


def concurrently(fns):
    barrier = threading.Barrier(len(fns))
    out = [None] * len(fns)

    def runner(i, fn):
        barrier.wait()
        try:
            out[i] = ("ok", fn())
        except Exception as err:  # noqa: BLE001 - per-caller outcome
            out[i] = ("err", type(err).__name__)

    threads = [threading.Thread(target=runner, args=(i, f))
               for i, f in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def batched(k):
    return k.batched.BatchedCloud(k.fake.FakeCloudProvider(small(k)),
                                  idle_seconds=0.05)


def b_identical_specs(k):
    b = batched(k)
    res = concurrently([lambda: b.create(machine(k)) for _ in range(6)])
    assert all(kind == "ok" for kind, _ in res)
    assert len({m.provider_id for _, m in res}) == 6
    return (b.creates.batch_count, list(b.creates.batch_sizes),
            b.inner.fleet_calls)


def b_distinct_specs(k):
    b = batched(k)
    concurrently([lambda: b.create(machine(k)),
                  lambda: b.create(machine(k, "c5.large"))])
    return b.creates.batch_count


def b_describe_merge(k):
    b = batched(k)
    pids = [b.create(machine(k)).provider_id for _ in range(4)]
    b.describes.batch_count = 0
    res = concurrently([lambda p=p: b.get(p) for p in pids])
    assert {m.provider_id for _, m in res} == set(pids)
    return b.describes.batch_count, b.describes.batch_sizes[-1]


def b_not_found(k):
    b = batched(k)
    pid = b.create(machine(k)).provider_id
    res = concurrently([lambda: b.get(pid), lambda: b.get("fake://nope/999")])
    return sorted((kind, v if kind == "err" else "machine")
                  for kind, v in res)


def b_terminate_merge(k):
    b = batched(k)
    ms = [b.create(machine(k)) for _ in range(5)]
    res = concurrently([lambda m=m: b.delete(m) for m in ms])
    assert all(kind == "ok" for kind, _ in res)
    gone = 0
    for m in ms:
        with pytest.raises(k.base.MachineNotFoundError):
            b.inner.get(m.provider_id)
        gone += 1
    return b.terminates.batch_count, list(b.terminates.batch_sizes), gone


def b_pass_through(k):
    b = batched(k)
    b.inject_ice("m5.large", "zone-a", "on-demand")
    return (("m5.large", "zone-a", "on-demand") in b.inner.ice_offerings,
            b.node_ready_delay, b.name())


BATCHED_SCENARIOS = {
    "identical_specs_share_one_fleet_call": b_identical_specs,
    "distinct_specs_use_distinct_buckets": b_distinct_specs,
    "concurrent_gets_merge_into_one_describe": b_describe_merge,
    "not_found_maps_per_caller": b_not_found,
    "concurrent_deletes_merge": b_terminate_merge,
    "provider_attrs_pass_through": b_pass_through,
}


@pytest.mark.parametrize("name", sorted(BATCHED_SCENARIOS))
def test_batched_cloud(name):
    run_both(BATCHED_SCENARIOS[name])


# ---------------------------------------------------------------------------
# the split topology (tests/test_split_topology.py), sidecars in-process
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def sidecar(k, backend="oracle", host=None):
    reg = k.metrics.Registry()
    sched = (k.scheduler.BatchScheduler(backend=backend, registry=reg,
                                        compile_behind=False)
             if k.root == REFERENCE else k.scheduler.BatchScheduler(
                 backend=backend, registry=reg, device="cpu"))
    service = k.server.SolverService(sched, registry=reg)
    if host is None:
        srv, port = k.server.make_server(service, port=0, host="127.0.0.1")
        address = f"127.0.0.1:{port}"
    else:
        srv, _ = k.server.make_server(service, host=host)
        address = host
    box = SimpleNamespace(srv=srv, service=service, address=address,
                          registry=reg)
    try:
        yield box
    finally:
        box.srv.stop(grace=None)
        box.service.close()


def forty_pod_cycle(k, op, n=40, deleted=30, must_save=True):
    """tests/test_split_topology.py's cycle: 40 pods up, 30 deleted, the
    deprovisioning what-ifs, the settle (``n`` and ``deleted`` scale it to
    the demo's).  Returns (after the scale-up, after the scale-down)."""
    op.state.apply_provisioner(k.provisioner.Provisioner(
        name="default", consolidation_enabled=True).with_defaults())
    for i in range(n):
        op.state.add_pod(k.pod.PodSpec(
            name=f"pod-{i}", requests={"cpu": 0.5 + (i % 4) * 0.5},
            owner_key=f"d{i % 5}"))
    for _ in range(4):
        op.tick()
        op.clock.advance(1.5)
    assert not op.state.pending_pods()
    up = snapshot(op)
    for i in range(deleted):
        op.state.delete_pod(f"pod-{i}")
    op.clock.advance(6 * 60)
    for _ in range(10):
        op.tick()
        op.clock.advance(4.0)
    for _ in range(8):
        if not op.state.pending_pods():
            break
        op.tick()
        op.clock.advance(2.0)
    assert not op.state.pending_pods()
    down = snapshot(op)
    cost = lambda s: sum(n[4] for n in s["nodes"])  # noqa: E731
    assert cost(down) < cost(up) or not must_save
    return up, down


def remote_cycle(k, backend="oracle", n=40, deleted=30, must_save=True):
    with sidecar(k, backend) as box:
        clock = k.clock.FakeClock()
        cloud = k.fake.FakeCloudProvider(small(k), clock=clock)
        op = operator(k, cloud, clock, solver_address=box.address,
                      scheduler_backend=backend if backend != "oracle"
                      else "auto")
        try:
            assert isinstance(op.scheduler, k.client.RemoteScheduler)
            up, down = forty_pod_cycle(k, op, n, deleted, must_save)
            assert op.registry.counter(
                k.metrics.REMOTE_FALLBACK_SOLVES).get() == 0
            assert not op.scheduler.degraded()
            admitted = box.registry.counter(
                "karpenter_admission_admitted_total").get(
                    {"class": "critical"})
            return up, down, admitted
        finally:
            op.shutdown()


def test_remote_operator_scale_down_equals_the_reference_remote_operator():
    obs = run_both(remote_cycle)
    assert obs[2] > 0


def test_remote_operator_scale_up_equals_the_in_process_operator():
    k = package(PORT)
    reset_counters(k)
    remote_up, _down, _n = remote_cycle(k)
    reset_counters(k)
    clock = k.clock.FakeClock()
    op = operator(k, k.fake.FakeCloudProvider(small(k), clock=clock), clock,
                  scheduler_backend="auto")
    try:
        local_up, _local_down = forty_pod_cycle(k, op)
    finally:
        op.shutdown()
    remote_up.pop("metrics")
    local_up.pop("metrics")
    assert remote_up == local_up


def test_remote_operator_on_the_device_backend_consolidates(monkeypatch):
    """``--backend tpu`` over the wire (ROADMAP C5): the reference's
    remote operator raises in its first consolidation sweep (its facade
    has no ``_tensorize_cache``); the port's sends each what-if as one
    RPC and reaches the in-process device operator's decisions.  The
    remote operator builds and runs with no card."""
    ref = package(REFERENCE)
    reset_counters(ref)
    with pytest.raises(AttributeError, match="_tensorize_cache"):
        remote_cycle(ref, backend="tpu", n=100, deleted=70,
                     must_save=False)
    k = package(PORT)
    reset_counters(k)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        remote_up, remote_down, _n = remote_cycle(
            k, backend="tpu", n=100, deleted=70, must_save=False)
    reset_counters(k)
    clock = k.clock.FakeClock()
    op = operator(k, k.fake.FakeCloudProvider(small(k), clock=clock), clock,
                  scheduler_backend="tpu")
    try:
        local_up, local_down = forty_pod_cycle(k, op, 100, 70, False)
    finally:
        op.shutdown()
    for snap in (remote_up, remote_down, local_up, local_down):
        snap.pop("metrics")
    assert (remote_up, remote_down) == (local_up, local_down)


def test_sidecar_death_degrades_then_the_probe_resumes(tmp_path):
    """The sidecar dies: the operator keeps scheduling from its host
    fallback (counted, degraded gauge set); a sidecar back on the same
    address is found by the health probe and solves go remote again."""

    def scenario(k):
        sock = f"unix:{tmp_path}/solver.sock"
        clock = k.clock.FakeClock()
        cloud = k.fake.FakeCloudProvider(small(k), clock=clock)
        reg = k.metrics.Registry()
        with sidecar(k, host=sock) as box:
            op = operator(k, cloud, clock, registry=reg,
                          solver_address=sock)
            op.scheduler.client.timeout = 3.0
            op.scheduler.reconnect_interval = 0.0
            op.state.apply_provisioner(k.provisioner.Provisioner(
                name="default"))
            op.state.add_pod(k.pod.PodSpec(name="before",
                                           requests={"cpu": 1.0}))
            for _ in range(3):
                op.tick()
                clock.advance(1.5)
            seen = [(len(op.state.pending_pods()),
                     reg.counter(k.metrics.REMOTE_FALLBACK_SOLVES).get())]
        # the sidecar is gone
        op.state.add_pod(k.pod.PodSpec(name="after", requests={"cpu": 1.0}))
        for _ in range(2):
            op.tick()
            clock.advance(1.5)
        seen.append((len(op.state.pending_pods()), op.scheduler.degraded(),
                     reg.counter(k.metrics.REMOTE_FALLBACK_SOLVES).get(),
                     reg.gauge(k.metrics.REMOTE_DEGRADED).get()))
        if os.path.exists(sock[5:]):
            os.remove(sock[5:])
        with sidecar(k, host=sock) as box:
            # the first probe after the restart dials the channel rebuilt
            # during the outage; the next ones find the sidecar
            for i in range(3):
                op.state.add_pod(k.pod.PodSpec(name=f"back-{i}",
                                               requests={"cpu": 1.0}))
                for _ in range(2):
                    op.tick()
                    clock.advance(1.5)
            seen.append((len(op.state.pending_pods()),
                         op.scheduler.degraded(),
                         reg.counter(k.metrics.REMOTE_FALLBACK_SOLVES).get(),
                         reg.gauge(k.metrics.REMOTE_DEGRADED).get(),
                         box.registry.counter(
                             "karpenter_admission_admitted_total").get(
                                 {"class": "critical"})))
            op.shutdown()
        if os.path.exists(sock[5:]):
            os.remove(sock[5:])
        return seen, snapshot(op)["nodes"]

    seen, _nodes = run_both(scenario)
    assert seen[0] == (0, 0.0)
    assert seen[1][:2] == (0, True) and seen[1][2] >= 1 and seen[1][3] == 1
    assert seen[2][:2] == (0, False) and seen[2][3] == 0 and seen[2][4] >= 1


# ---------------------------------------------------------------------------
# the port's device rule for the operator
# ---------------------------------------------------------------------------


def test_in_process_operator_needs_the_card_unless_asked(monkeypatch):
    k = package(PORT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cloud = k.fake.FakeCloudProvider(small(k))
    with pytest.raises(RuntimeError, match="CUDA"):
        k.operator.Operator(cloud, registry=k.metrics.Registry())
    op = k.operator.Operator(cloud, registry=k.metrics.Registry(),
                             device="cpu")
    assert op.scheduler.device == torch.device("cpu")
    remote = k.operator.Operator(cloud, registry=k.metrics.Registry(),
                                 solver_address="127.0.0.1:1")
    assert remote.scheduler.device == torch.device("cpu")
    assert remote.scheduler.backend == ""
    remote.shutdown()
    op.shutdown()


def test_operator_main_passes_the_device(monkeypatch, capsys):
    k = package(PORT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        k.operator.main(["--demo", "--pods", "4", "--small"])
    assert k.operator.main(["--demo", "--pods", "4", "--small",
                            "--device", "cpu"]) == 0
    assert "pending=0" in capsys.readouterr().out
