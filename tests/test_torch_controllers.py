"""The port's provisioning controller, batcher, caches and fake cloud against
the reference package, on the CPU.

Every class of the reference's ``tests/test_controllers.py`` is here as
parametrised cases: the batching window and coalescer, the TTL and
unavailable-offerings caches, provisioning end to end (the 1,000-pod
batch, coalescing across adds, the insufficient-capacity retry, an
infeasible pod, reuse of existing capacity, a deleted provisioner), the
device backend end to end and the fake cloud (cheapest resolve, eventual
consistency, delete, the ``decorate`` metrics).  Each scenario is one
function written against a package namespace ``k`` and run twice, once
over the reference's modules and once over the port's, each from fresh
name counters: the reference's assertions hold on both, and what each
run observed — bindings, node plans (name, type, zone, capacity type,
price, pods), events and the controllers' metric counts — must be equal.
The end-to-end cases run with the ``oracle`` backend and with the device
backend (``backend="tpu"``; the port on ``device="cpu"``, the reference
compiling inline) as two cases of one test.

Left out: the reference's ``TestAutoBackendE2E`` drives its native C++
tier, which the port does not have yet.
"""

import importlib
import itertools
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"

#: alias -> module path, the same in both packages
MODULES = {
    "batcher": "batcher",
    "cache": "cache",
    "base": "cloud.base",
    "fake": "cloud.fake",
    "templates": "cloud.templates",
    "provisioning": "controllers.provisioning",
    "deprovisioning": "controllers.deprovisioning",
    "state_mod": "controllers.state",
    "termination": "controllers.termination",
    "events": "events",
    "metrics": "metrics",
    "L": "models.labels",
    "catalog": "models.catalog",
    "machine": "models.machine",
    "pdb": "models.pdb",
    "pod": "models.pod",
    "provisioner": "models.provisioner",
    "req": "models.requirements",
    "volume": "models.volume",
    "scheduler": "solver.scheduler",
    "types": "solver.types",
    "clock": "utils.clock",
}

#: the controllers' and the cloud provider's metric families compared
#: between the packages (durations compare by count only)
COUNTED = (
    "karpenter_provisioner_batch_size",
    "karpenter_nodes_created_total",
    "karpenter_nodes_terminated_total",
    "karpenter_deprovisioning_actions_performed_total",
    "karpenter_deprovisioning_evaluation_duration_seconds",
    "karpenter_pods_startup_time_seconds",
    "karpenter_provisioner_usage",
    "karpenter_provisioner_limit",
    "karpenter_cloudprovider_duration_seconds",
    "karpenter_trace_traces_total",
)
#: histograms whose observed values are set by the fake clock or the
#: batch, not by the host's speed: their sums compare too
EXACT_SUMS = ("karpenter_provisioner_batch_size",
              "karpenter_pods_startup_time_seconds")

_PACKAGES: dict = {}


def package(root: str) -> SimpleNamespace:
    """The modules of one package under the aliases of :data:`MODULES`."""
    if root not in _PACKAGES:
        _PACKAGES[root] = SimpleNamespace(root=root, **{
            alias: importlib.import_module(f"{root}.{path}")
            for alias, path in MODULES.items()})
    return _PACKAGES[root]


def reset_counters(k) -> None:
    """Restart one package's name counters (machines, fake instances,
    auto-named nodes)."""
    k.machine._machine_counter = itertools.count()
    k.fake._instance_counter = itertools.count()
    with k.types._node_lock:
        k.types._node_next = 0


def make_scheduler(k, backend, registry=None):
    """The package's ``BatchScheduler``: the port's on the CPU, the
    reference's compiling inline (no compile-behind, so it serves every
    shape from the device program)."""
    if k.root == REFERENCE:
        return k.scheduler.BatchScheduler(backend=backend, registry=registry,
                                          compile_behind=False)
    return k.scheduler.BatchScheduler(backend=backend, registry=registry,
                                      device="cpu")


def metric_counts(registry) -> dict:
    out = {}
    for name in COUNTED:
        if name in registry.counters:
            out[name] = dict(registry.counters[name].values)
        if name in registry.gauges:
            out[name] = dict(registry.gauges[name].values)
        if name in registry.histograms:
            h = registry.histograms[name]
            out[name] = dict(h.totals)
            if name in EXACT_SUMS:
                out[name + "_sum"] = {k: round(v, 9)
                                      for k, v in h.sums.items()}
    return out


def snapshot(state, recorder=None, registry=None) -> dict:
    """What a run observed: bindings, node plans, pending pods, events and
    metric counts."""
    out = dict(
        bindings=dict(sorted(state.bindings.items())),
        nodes=sorted(
            (ns.node.name, ns.node.instance_type, ns.node.zone,
             ns.node.capacity_type, round(ns.node.price, 9),
             tuple(sorted(p.name for p in ns.node.pods)))
            for ns in state.nodes.values()),
        pending=sorted(p.name for p in state.pending_pods()),
    )
    if recorder is not None:
        out["events"] = [(e.kind, e.name, e.reason, e.message, e.event_type)
                         for e in recorder.events]
    if registry is not None:
        out["metrics"] = metric_counts(registry)
    return out


def run_both(scenario, *args, backend=None, **kw):
    """Run ``scenario(k, ...)`` over the reference and over the port, each
    from fresh name counters; the two observations must be equal.  With
    ``backend``, ``k.backend`` names the scheduler backend the scenario's
    controllers use."""
    seen = []
    for root in (REFERENCE, PORT):
        k = package(root)
        if backend is not None:
            k = SimpleNamespace(**vars(k), backend=backend)
        reset_counters(k)
        seen.append(scenario(k, *args, **kw))
    assert seen[1] == seen[0]
    return seen[1]


def catalog(k, full=False):
    return k.catalog.generate_catalog(full=full)


def pump(ctrl, clock, idle=1.5):
    """Queue pending pods, let the idle window expire, reconcile."""
    ctrl.reconcile()
    clock.advance(idle)
    return ctrl.reconcile()


def provisioning_env(k, backend="oracle"):
    clock = k.clock.FakeClock()
    state = k.state_mod.ClusterState(clock=clock)
    cloud = k.fake.FakeCloudProvider(catalog(k), clock=clock)
    recorder = k.events.Recorder()
    registry = k.metrics.Registry()
    ctrl = k.provisioning.ProvisioningController(
        state, cloud, scheduler=make_scheduler(k, backend, registry),
        recorder=recorder, registry=registry, clock=clock)
    state.apply_provisioner(k.provisioner.Provisioner(name="default"))
    return SimpleNamespace(clock=clock, state=state, cloud=cloud, ctrl=ctrl,
                           recorder=recorder, registry=registry)


# ---------------------------------------------------------------------------
# batching window and caches
# ---------------------------------------------------------------------------


def _idle_window(k):
    clock = k.clock.FakeClock()
    w = k.batcher.Window(idle_seconds=1.0, max_seconds=10.0, clock=clock)
    seen = []
    w.add("a")
    seen.append(w.ready())
    clock.advance(0.5)
    w.add("b")
    seen.append(w.ready())
    clock.advance(1.1)  # idle expired
    seen.append(w.ready())
    seen.append(w.pop())
    seen.append(w.ready())
    assert seen == [False, False, True, ["a", "b"], False]
    return seen


def _max_window(k):
    clock = k.clock.FakeClock()
    w = k.batcher.Window(idle_seconds=1.0, max_seconds=10.0, clock=clock)
    w.add("a")
    ready = []
    for _ in range(20):  # keep stream busy: never idle
        clock.advance(0.6)
        w.add("x")
        ready.append(w.ready())
    assert ready[-1]  # max window fired even though never idle
    return ready


def _coalescer_buckets(k):
    calls = []

    def execute(reqs):
        calls.append(list(reqs))
        return [f"r-{r}" for r in reqs]

    c = k.batcher.Coalescer(hasher=lambda r: r[0], execute=execute)
    c.add("ab")
    c.add("ac")
    c.add("bx")
    out = c.flush()
    assert len(calls) == 2  # two buckets: 'a' and 'b'
    assert out["a"] == ["r-ab", "r-ac"]
    return calls, out


def _ttl_cache_expiry(k):
    clock = k.clock.FakeClock()
    c = k.cache.TTLCache(ttl=60.0, clock=clock)
    c.put("k", 1)
    seen = [c.get("k")]
    clock.advance(61)
    seen.append(c.get("k"))
    assert seen == [1, None]
    return seen


def _unavailable_offerings(k):
    clock = k.clock.FakeClock()
    u = k.cache.UnavailableOfferings(clock=clock, ttl=180.0)
    s0 = u.seqnum
    u.mark_unavailable("m5.xlarge", "zone-1a", "on-demand")
    assert u.seqnum == s0 + 1
    assert u.is_unavailable("m5.xlarge", "zone-1a", "on-demand")
    marked = sorted(u.as_set())
    assert ("m5.xlarge", "zone-1a", "on-demand") in marked
    clock.advance(181)
    assert not u.is_unavailable("m5.xlarge", "zone-1a", "on-demand")
    assert u.as_set() == set()
    return s0, u.seqnum, marked


HOST_CASES = {
    "batching_idle_window": _idle_window,
    "batching_max_window": _max_window,
    "batching_coalescer_buckets": _coalescer_buckets,
    "cache_ttl_expiry": _ttl_cache_expiry,
    "cache_unavailable_offerings_ttl_and_seqnum": _unavailable_offerings,
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_batching_and_caches_match_reference(case):
    run_both(HOST_CASES[case])


# ---------------------------------------------------------------------------
# provisioning end to end
# ---------------------------------------------------------------------------


def _config1_1k_pods(k, backend):
    """BASELINE config #1: 1k uniform pods, 1 provisioner, 20 types."""
    e = provisioning_env(k, backend)
    for i in range(1000):
        e.state.add_pod(k.pod.PodSpec(name=f"p{i}", requests={"cpu": 1.0},
                                      owner_key="d"))
    assert e.ctrl.reconcile() is None  # window not fired yet
    e.clock.advance(1.5)  # idle window expires
    result = e.ctrl.reconcile()
    assert result is not None
    assert len(e.state.pending_pods()) == 0
    assert len(e.state.nodes) > 0
    assert len(e.cloud.instances) == len(e.state.nodes)
    for pod_name in e.state.pods:  # every pod bound to a node that exists
        assert e.state.bindings[pod_name] in e.state.nodes
    assert e.registry.histogram(
        "karpenter_provisioner_batch_size").count() == 1
    return snapshot(e.state, e.recorder, e.registry)


def _coalesces_across_adds(k, backend):
    e = provisioning_env(k, backend)
    e.state.add_pod(k.pod.PodSpec(name="a", requests={"cpu": 0.5},
                                  owner_key="d"))
    e.ctrl.reconcile()
    e.clock.advance(0.5)
    e.state.add_pod(k.pod.PodSpec(name="b", requests={"cpu": 0.5},
                                  owner_key="d"))
    e.ctrl.reconcile()
    e.clock.advance(1.2)
    assert e.ctrl.reconcile() is not None
    assert len(e.state.nodes) == 1  # both pods in one batch, one node
    return snapshot(e.state, e.recorder, e.registry)


def _ice_routes_around_and_retries(k, backend):
    L = k.L
    e = provisioning_env(k, backend)
    state, cloud, ctrl, clock = e.state, e.cloud, e.ctrl, e.clock
    # find what the solver would pick, then ICE it
    state.add_pod(k.pod.PodSpec(name="probe",
                                requests={"cpu": 1.0, "memory": 2**30}))
    res = pump(ctrl, clock)
    chosen, zone = res.nodes[0].instance_type, res.nodes[0].zone
    state.delete_pod("probe")
    for name in list(state.nodes):
        state.remove_node(name)
    cloud.instances.clear()

    cloud.inject_ice(chosen, zone, "on-demand")
    cloud.next_error = None
    state.add_pod(k.pod.PodSpec(name="p",
                                requests={"cpu": 1.0, "memory": 2**30},
                                node_selector={L.ZONE: zone}))
    pump(ctrl, clock)
    # the machine pins (type, zone, capacity-type), so the first create
    # MUST hit the injected ICE: offering marked, pod left pending
    assert "p" not in state.bindings
    assert ctrl.unavailable.is_unavailable(chosen, zone, "on-demand")
    pump(ctrl, clock)
    assert "p" in state.bindings
    assert state.node_of("p").instance_type != chosen
    assert len(e.recorder.of("InsufficientCapacity")) == 1
    return chosen, zone, snapshot(state, e.recorder, e.registry)


def _infeasible_pod_gets_event(k, backend):
    e = provisioning_env(k, backend)
    e.state.add_pod(k.pod.PodSpec(name="giant", requests={"cpu": 10000.0}))
    pump(e.ctrl, e.clock)
    assert len(e.recorder.of("FailedScheduling")) == 1
    assert "giant" not in e.state.bindings
    return snapshot(e.state, e.recorder, e.registry)


def _existing_capacity_reused(k, backend):
    e = provisioning_env(k, backend)
    e.state.add_pod(k.pod.PodSpec(name="first", requests={"cpu": 1.0},
                                  owner_key="d"))
    pump(e.ctrl, e.clock)
    n_nodes = len(e.state.nodes)
    # a second small pod should fit the node just made
    e.state.add_pod(k.pod.PodSpec(name="second", requests={"cpu": 0.1},
                                  owner_key="d"))
    pump(e.ctrl, e.clock)
    assert len(e.state.nodes) == n_nodes
    assert e.state.bindings["second"] == e.state.bindings["first"]
    return snapshot(e.state, e.recorder, e.registry)


def _provisioner_deleted_no_creates(k, backend):
    e = provisioning_env(k, backend)
    e.state.delete_provisioner("default")
    e.state.add_pod(k.pod.PodSpec(name="p", requests={"cpu": 1.0}))
    pump(e.ctrl, e.clock)
    assert len(e.state.nodes) == 0
    assert "p" not in e.state.bindings
    return snapshot(e.state, e.recorder, e.registry)


def _scheduler_end_to_end(k, backend):
    """The reference's ``TestTpuBackendE2E``: 50 pods through a controller
    over a default tracer and the package's global registry."""
    clock = k.clock.FakeClock()
    state = k.state_mod.ClusterState(clock=clock)
    cloud = k.fake.FakeCloudProvider(catalog(k), clock=clock)
    ctrl = k.provisioning.ProvisioningController(
        state, cloud, scheduler=make_scheduler(k, backend), clock=clock)
    state.apply_provisioner(k.provisioner.Provisioner(name="default"))
    for i in range(50):
        state.add_pod(k.pod.PodSpec(name=f"p{i}", requests={"cpu": 1.0},
                                    owner_key="d"))
    assert pump(ctrl, clock) is not None
    assert len(state.pending_pods()) == 0
    assert all(p in state.bindings for p in state.pods)
    return snapshot(state, ctrl.recorder)


E2E_CASES = {
    "config1_1k_pods_end_to_end": _config1_1k_pods,
    "batching_coalesces_pods_across_adds": _coalesces_across_adds,
    "ice_routes_around_and_retries": _ice_routes_around_and_retries,
    "infeasible_pod_gets_event": _infeasible_pod_gets_event,
    "existing_capacity_reused": _existing_capacity_reused,
    "provisioner_deleted_no_creates": _provisioner_deleted_no_creates,
    "scheduler_end_to_end_50_pods": _scheduler_end_to_end,
}


@pytest.mark.parametrize("backend", ["oracle", "tpu"])
@pytest.mark.parametrize("case", sorted(E2E_CASES))
def test_provisioning_end_to_end_matches_reference(case, backend):
    run_both(E2E_CASES[case], backend)


# ---------------------------------------------------------------------------
# the fake cloud
# ---------------------------------------------------------------------------


def _machine(k, instance_type="m5.large"):
    reqs = k.req.Requirements([k.req.Requirement(
        k.L.INSTANCE_TYPE, k.req.IN, [instance_type])])
    return k.machine.Machine(requirements=reqs)


def _create_resolves_cheapest(k):
    cloud = k.fake.FakeCloudProvider(catalog(k))
    m = cloud.create(_machine(k))
    assert m.instance_type == "m5.large"
    assert m.provider_id.startswith("fake://")
    assert m.capacity_type == "spot"  # unconstrained: spot is cheapest
    return (m.name, m.provider_id, m.instance_type, m.zone,
            m.capacity_type, round(m.price, 9), m.node_name, m.image_id,
            sorted(m.labels.items()), sorted(m.allocatable.items()))


def _eventual_consistency(k):
    cloud = k.fake.FakeCloudProvider(catalog(k), eventual_consistency_calls=2)
    m = cloud.create(_machine(k))
    for _ in range(2):
        with pytest.raises(k.base.MachineNotFoundError):
            cloud.get(m.provider_id)
    assert cloud.get(m.provider_id).provider_id == m.provider_id
    return m.provider_id


def _delete_then_not_found(k):
    cloud = k.fake.FakeCloudProvider(catalog(k))
    m = cloud.create(_machine(k))
    cloud.delete(m)
    with pytest.raises(k.base.MachineNotFoundError):
        cloud.get(m.provider_id)
    return m.provider_id, list(cloud.delete_calls)


def _metrics_decorator(k):
    reg = k.metrics.Registry()
    cloud = k.metrics.decorate(k.fake.FakeCloudProvider(catalog(k)), reg)
    cloud.list()
    cloud.create(_machine(k))
    hist = reg.histogram("karpenter_cloudprovider_duration_seconds")
    assert hist.count({"controller": "cloudprovider", "method": "list"}) == 1
    return metric_counts(reg)


CLOUD_CASES = {
    "create_resolves_cheapest": _create_resolves_cheapest,
    "eventual_consistency": _eventual_consistency,
    "delete_then_not_found": _delete_then_not_found,
    "metrics_decorator": _metrics_decorator,
}


@pytest.mark.parametrize("case", sorted(CLOUD_CASES))
def test_fake_cloud_matches_reference(case):
    run_both(CLOUD_CASES[case])


def test_metric_help_text_is_the_reference():
    ref, port = package(REFERENCE).metrics, package(PORT).metrics
    for name, entry in port.INVENTORY.items():
        assert ref.INVENTORY[name] == entry
    for name in COUNTED:
        assert name in port.INVENTORY

