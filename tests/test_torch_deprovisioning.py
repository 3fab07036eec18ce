"""The port's deprovisioning and termination controllers against the
reference package, on the CPU.

Every class of the reference's ``tests/test_deprovisioning.py`` —
emptiness, consolidation delete and replace, replacement wait-ready, the
deprovisioning TTL, multi-node, the multi-subset screen, blockers and
PDBs, expiration and drift, repack convergence, capacity-type spread,
volume pins, kubelet density — and ``TestControllerIntegration`` and
``TestControllerSimulateBatch`` of ``tests/test_consolidation_batch.py``,
as parametrised cases.  Each scenario is one function written against a
package namespace ``k`` (``test_torch_controllers.package``) and run over
the reference's modules and over the port's, each from fresh name
counters and driven tick for tick on a ``FakeClock``: the reference's
assertions hold on both, and the ``Action`` sequence (kind, mechanism,
nodes, savings rounded to 1e-9, and the tick it came on), the final node
set, the bindings, the events and the controllers' metric counts must be
equal.

Every case runs with the ``oracle`` backend and with the device backend
(``backend="tpu"``; the port on ``device="cpu"``, the reference compiling
inline), except the two that count the serial path's solves.  The repack
fleet (the reference bench's ``_repack_fleet``, 60 nodes) runs to
convergence through the reference's controllers and through the port's
``karpenter_tpu_torch.repack`` (the harness ``chip_smoke.py`` drives on
the card) with the oracle backend; on the device backend the reference's
inline compiles alone take over a minute at that size.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_controllers import (  # noqa: E402
    PORT,
    REFERENCE,
    catalog,
    make_scheduler,
    package,
    pump,
    reset_counters,
    run_both,
    snapshot,
)

torch.set_num_threads(1)

GIB = 1024.0 ** 3


def action_key(action):
    return (None if action is None else
            (action.kind, action.mechanism, tuple(action.nodes),
             round(action.savings, 9)))


class Env:
    """The reference test's ``make_env`` over package ``k``: the three
    controllers over one scheduler (``k.backend``, else the oracle), TTL 0
    unless given.  Every
    deprovisioning reconcile goes through :meth:`reconcile`, which logs
    the returned action with its tick."""

    def __init__(self, k, provisioner=None, drift_enabled=False,
                 deprovisioning_ttl=0.0, backend=None, provisioning=True,
                 instance_types=None):
        self.k = k
        backend = backend or getattr(k, "backend", "oracle")
        self.clock = k.clock.FakeClock()
        self.state = k.state_mod.ClusterState(clock=self.clock)
        self.cloud = k.fake.FakeCloudProvider(
            instance_types or catalog(k), clock=self.clock)
        self.recorder = k.events.Recorder()
        self.registry = k.metrics.Registry()
        sched = make_scheduler(k, backend, self.registry)
        self.prov_ctrl = k.provisioning.ProvisioningController(
            self.state, self.cloud, scheduler=sched, recorder=self.recorder,
            registry=self.registry, clock=self.clock)
        self.term = k.termination.TerminationController(
            self.state, self.cloud, recorder=self.recorder,
            registry=self.registry, clock=self.clock)
        kw = {}
        if deprovisioning_ttl is not None:
            kw["deprovisioning_ttl"] = deprovisioning_ttl
        self.deprov = k.deprovisioning.DeprovisioningController(
            self.state, self.cloud, self.term,
            provisioning=self.prov_ctrl if provisioning else None,
            scheduler=sched, recorder=self.recorder, registry=self.registry,
            clock=self.clock, drift_enabled=drift_enabled, **kw)
        self.state.apply_provisioner(provisioner or k.provisioner.Provisioner(
            name="default", consolidation_enabled=True))
        self.log = []

    def reconcile(self):
        action = self.deprov.reconcile()
        self.log.append((self.clock.now(), action_key(action)))
        return action

    def schedule(self, pods):
        for p in pods:
            self.state.add_pod(p)
        return pump(self.prov_ctrl, self.clock)

    def observed(self, *extra):
        return (self.log, snapshot(self.state, self.recorder, self.registry),
                extra)


def prov(k, **kw):
    return k.provisioner.Provisioner(name="default", **kw)


def c2x(k):
    return k.req.Requirement(k.L.INSTANCE_TYPE, k.req.IN, ["c5.2xlarge"])


def pod(k, name, cpu, **kw):
    return k.pod.PodSpec(name=name, requests={"cpu": cpu}, **kw)


def lifetime(k):
    return k.deprovisioning.MIN_NODE_LIFETIME


# ---------------------------------------------------------------------------
# emptiness
# ---------------------------------------------------------------------------


def _ttl_after_empty_deletes(k):
    e = Env(k, prov(k, ttl_seconds_after_empty=30.0))
    e.schedule([pod(k, "p", 1.0)])
    node_name = e.state.bindings["p"]
    e.state.delete_pod("p")
    e.state.empty_nodes()  # observe emptiness start
    e.clock.advance(31)
    action = e.reconcile()
    assert action is not None and action.mechanism == "emptiness"
    assert node_name not in e.state.nodes
    assert e.cloud.delete_calls  # instance terminated
    return e.observed(list(e.cloud.delete_calls))


def _consolidation_owns_empty_nodes(k):
    e = Env(k)
    e.schedule([pod(k, "p", 1.0)])
    node_name = e.state.bindings["p"]
    e.state.delete_pod("p")
    e.clock.advance(lifetime(k) + 1)
    action = e.reconcile()
    assert action is not None
    assert action.mechanism == "consolidation" and action.kind == "delete"
    assert node_name not in e.state.nodes
    return e.observed()


def _daemon_only_node_reclaimed(k):
    e = Env(k)
    e.schedule([pod(k, "p", 1.0)])
    node_name = e.state.bindings["p"]
    e.state.add_pod(pod(k, "ds-p", 0.1, is_daemon=True))
    e.state.bind("ds-p", node_name)
    e.state.delete_pod("p")
    e.state.add_pod(pod(k, "stuck", 1.0,
                        node_selector={k.L.INSTANCE_TYPE: "no-such-type"}))
    e.clock.advance(lifetime(k) + 1)
    action = e.reconcile()
    assert action is not None and action.kind == "delete"
    assert node_name not in e.state.nodes
    assert "ds-p" not in e.state.pods
    nodes_before = len(e.state.nodes)
    creates_before = len(e.cloud.create_calls)
    pump(e.prov_ctrl, e.clock)
    assert len(e.cloud.create_calls) == creates_before
    assert len(e.state.nodes) == nodes_before
    return e.observed()


def _young_nodes_not_consolidated(k):
    e = Env(k)
    e.schedule([pod(k, "p", 1.0)])
    e.state.delete_pod("p")
    e.clock.advance(60)  # < 5 min lifetime
    assert e.reconcile() is None
    return e.observed()


# ---------------------------------------------------------------------------
# consolidation: delete, replace, wait-ready, TTL
# ---------------------------------------------------------------------------


def _underutilized_node_drained_onto_peer(k):
    e = Env(k, prov(k, consolidation_enabled=True, requirements=[c2x(k)]))
    e.schedule([pod(k, f"p{i}", 0.5, owner_key="d") for i in range(20)])
    assert len(e.state.nodes) == 2
    node_pods = {}
    for p, n in e.state.bindings.items():
        node_pods.setdefault(n, []).append(p)
    big_node = max(node_pods, key=lambda n: len(node_pods[n]))
    for p in node_pods[big_node][:10]:
        e.state.delete_pod(p)
    e.clock.advance(lifetime(k) + 1)
    action = e.reconcile()
    assert action is not None and action.mechanism == "consolidation"
    pump(e.prov_ctrl, e.clock)
    assert len(e.state.nodes) == 1
    assert not e.state.pending_pods()
    return e.observed()


def _spot_is_delete_only(k):
    L = k.L
    e = Env(k, prov(k, consolidation_enabled=True, requirements=[
        k.req.Requirement(L.CAPACITY_TYPE, k.req.IN, [L.CAPACITY_TYPE_SPOT]),
        c2x(k)]))
    e.schedule([pod(k, "p", 1.0)])
    e.clock.advance(lifetime(k) + 1)
    assert e.reconcile() is None
    assert len(e.state.nodes) == 1
    return e.observed()


def _replace_with_cheaper_node(k):
    e = Env(k, prov(k, consolidation_enabled=True, requirements=[c2x(k)]))
    e.schedule([pod(k, "p", 0.5)])
    old_node = e.state.bindings["p"]
    old_price = e.state.nodes[old_node].node.price
    e.state.apply_provisioner(prov(k, consolidation_enabled=True))
    e.clock.advance(lifetime(k) + 1)
    action = e.reconcile()
    assert action is not None and action.kind == "replace"
    assert action.savings > 0
    assert old_node not in e.state.nodes
    assert len(e.state.nodes) == 1
    new_ns = next(iter(e.state.nodes.values()))
    assert new_ns.node.price < old_price
    pump(e.prov_ctrl, e.clock)
    assert e.state.bindings["p"] == new_ns.node.name
    return e.observed()


def _trigger_replace(k, ready_delay):
    e = Env(k, prov(k, consolidation_enabled=True, requirements=[c2x(k)]))
    e.schedule([pod(k, "p", 0.5)])
    old_node = e.state.bindings["p"]
    e.state.apply_provisioner(prov(k, consolidation_enabled=True))
    e.cloud.node_ready_delay = ready_delay
    e.clock.advance(lifetime(k) + 1)
    action = e.reconcile()
    assert action is not None and action.kind == "replace"
    return e, old_node


def _old_node_survives_until_replacement_ready(k):
    e, old_node = _trigger_replace(k, 30.0)
    assert old_node in e.state.nodes and len(e.state.nodes) == 2
    repl = next(n for n in e.state.nodes if n != old_node)
    assert not e.state.nodes[repl].initialized
    assert e.state.nodes[repl].nominated_until > e.clock.now()
    e.clock.advance(10)
    assert e.reconcile() is None
    assert old_node in e.state.nodes
    e.clock.advance(25)
    e.reconcile()
    assert old_node not in e.state.nodes
    assert e.state.nodes[repl].initialized
    return e.observed()


def _interrupted_replacement_abandons(k):
    e, old_node = _trigger_replace(k, 60.0)
    repl = next(n for n in e.state.nodes if n != old_node)
    e.state.remove_node(repl)
    e.clock.advance(10)
    assert e.reconcile() is None
    assert old_node in e.state.nodes
    assert e.deprov._pending is None
    return e.observed()


def _timeout_abandons_and_reaps(k):
    e, old_node = _trigger_replace(k, 1e12)  # never becomes ready
    repl = next(n for n in e.state.nodes if n != old_node)
    e.clock.advance(k.deprovisioning.REPLACEMENT_READY_TIMEOUT + 1)
    e.reconcile()
    assert repl not in e.state.nodes
    assert old_node in e.state.nodes
    assert any(ev.reason == "ReplacementTimedOut" for ev in e.recorder.events)
    return e.observed()


def _ttl_action_deferred_then_executed(k):
    e = Env(k, deprovisioning_ttl=None)  # the default 15 s TTL
    e.schedule([pod(k, "p", 1.0)])
    node = e.state.bindings["p"]
    e.state.delete_pod("p")
    e.clock.advance(lifetime(k) + 1)
    assert e.reconcile() is None
    assert node in e.state.nodes
    e.clock.advance(5)
    assert e.reconcile() is None
    assert node in e.state.nodes
    e.clock.advance(11)
    action = e.reconcile()
    assert action is not None and action.kind == "delete"
    assert node not in e.state.nodes
    return e.observed()


def _ttl_grown_delete_set(k):
    e = Env(k, deprovisioning_ttl=None)
    e.schedule([pod(k, "p1", 1.0), pod(k, "p2", 7.0)])
    n1, n2 = e.state.bindings["p1"], e.state.bindings["p2"]
    e.state.delete_pod("p1")
    e.clock.advance(lifetime(k) + 1)
    assert e.reconcile() is None
    e.state.delete_pod("p2")
    e.clock.advance(16)
    action = e.reconcile()
    assert action is not None and action.kind == "delete"
    assert set(action.nodes) <= {n1, n2} and len(action.nodes) >= 1
    return e.observed()


def _ttl_invalidated_proposal_dropped(k):
    e = Env(k, deprovisioning_ttl=None)
    e.schedule([pod(k, "p", 1.0)])
    node = e.state.bindings["p"]
    e.state.delete_pod("p")
    e.clock.advance(lifetime(k) + 1)
    assert e.reconcile() is None
    e.state.add_pod(pod(k, "q", 1.0))
    e.state.bind("q", node)
    e.clock.advance(16)
    assert e.reconcile() is None
    assert node in e.state.nodes
    return e.observed()


# ---------------------------------------------------------------------------
# multi-node, the subset screen, blockers
# ---------------------------------------------------------------------------


def _multi_node_delete(k):
    e = Env(k, prov(k, consolidation_enabled=True, requirements=[c2x(k)]))
    e.schedule([pod(k, f"p{i}", 0.5, owner_key="d") for i in range(30)])
    n0 = len(e.state.nodes)
    assert n0 >= 2
    for p in list(e.state.pods)[: len(e.state.pods) - 4]:
        e.state.delete_pod(p)
    e.clock.advance(lifetime(k) + 1)
    action = e.reconcile()
    assert action is not None and action.kind == "delete"
    pump(e.prov_ctrl, e.clock)
    assert len(e.state.nodes) < n0
    assert not e.state.pending_pods()
    return e.observed()


def _subset_screen_finds_pairwise_delete(k):
    e = Env(k, prov(k, consolidation_enabled=True, requirements=[c2x(k)]))
    e.schedule([pod(k, f"p{i}", 0.5, owner_key="d") for i in range(60)])
    assert len(e.state.nodes) >= k.deprovisioning.SUBSET_SCREEN_MIN
    for p in list(e.state.pods)[: len(e.state.pods) - 5]:
        e.state.delete_pod(p)
    e.clock.advance(lifetime(k) + 1)
    action = e.reconcile()
    assert action is not None and action.kind == "delete"
    assert len(action.nodes) >= 2  # a genuine multi-node action
    pump(e.prov_ctrl, e.clock)
    assert not e.state.pending_pods()
    return e.observed()


def _do_not_evict_blocks(k):
    e = Env(k)
    e.schedule([pod(k, "p", 0.5, do_not_evict=True)])
    e.state.add_pod(pod(k, "q", 0.5))
    pump(e.prov_ctrl, e.clock)
    e.clock.advance(lifetime(k) + 1)
    assert e.reconcile() is None
    return e.observed()


def _pdb_blocks_drain(k):
    e = Env(k)
    e.schedule([pod(k, "p", 0.5, labels={"app": "db"})])
    e.term.pdbs.append(k.pdb.PodDisruptionBudget(
        name="db-pdb", selector=k.pod.LabelSelector.of({"app": "db"}),
        min_available=1))
    node = e.state.bindings["p"]
    e.term.begin(node)
    e.term.reconcile()
    assert node in e.state.nodes
    assert e.state.bindings.get("p") == node
    assert e.term.blocked(node) == ["p"]
    return e.observed(e.term.blocked(node))


# ---------------------------------------------------------------------------
# expiration and drift
# ---------------------------------------------------------------------------


def _new_image(k):
    return k.templates.Image("img-standard-amd64-v2", k.L.ARCH_AMD64,
                             created_at=99.0, family="standard")


def _expiration_replaces(k):
    e = Env(k, prov(k, ttl_seconds_until_expired=3600.0))
    e.schedule([pod(k, "p", 0.5)])
    node = e.state.bindings["p"]
    assert e.reconcile() is None
    e.clock.advance(3601)
    action = e.reconcile()
    assert action is not None and action.mechanism == "expiration"
    assert node not in e.state.nodes
    pump(e.prov_ctrl, e.clock)
    assert "p" in e.state.bindings
    return e.observed()


def _drift_gated_and_replaces(k):
    e = Env(k, drift_enabled=True)
    e.schedule([pod(k, "p", 0.5)])
    node = e.state.bindings["p"]
    e.cloud.mark_drifted(e.state.nodes[node].machine.provider_id)
    e.clock.advance(10)
    action = e.reconcile()
    assert action is not None and action.mechanism == "drift"
    assert node not in e.state.nodes
    return e.observed()


def _drift_disabled_no_action(k):
    e = Env(k, prov(k), drift_enabled=False)
    e.schedule([pod(k, "p", 0.5)])
    node = e.state.bindings["p"]
    e.cloud.mark_drifted(e.state.nodes[node].machine.provider_id)
    e.clock.advance(10)
    assert e.reconcile() is None
    return e.observed()


def _image_drift_detected(k):
    e = Env(k, drift_enabled=True)
    e.schedule([pod(k, "p", 0.5)])
    node = e.state.bindings["p"]
    machine = e.state.nodes[node].machine
    assert machine.image_id == "img-standard-amd64"
    assert not e.cloud.is_machine_drifted(machine)
    e.cloud.publish_image(_new_image(k))
    assert e.cloud.is_machine_drifted(machine)
    e.clock.advance(10)
    action = e.reconcile()
    assert action is not None and action.mechanism == "drift"
    assert node not in e.state.nodes
    return e.observed()


def _launch_template_override_drift(k):
    e = Env(k, drift_enabled=True)
    e.cloud.templates["default"] = k.templates.NodeTemplate(
        name="default", subnet_selector={"discovery": "c"},
        launch_template_name="my-lt")
    e.cloud.register_launch_template("my-lt", "img-custom-v1")
    e.schedule([pod(k, "p", 0.5)])
    machine = e.state.nodes[e.state.bindings["p"]].machine
    assert machine.image_id == "img-custom-v1"
    assert not e.cloud.is_machine_drifted(machine)
    e.cloud.register_launch_template("my-lt", "img-custom-v2")
    assert e.cloud.is_machine_drifted(machine)
    return e.observed(machine.image_id)


def _drift_replace_waits_for_readiness(k):
    e = Env(k, drift_enabled=True)
    e.schedule([pod(k, "p", 0.5)])
    old = e.state.bindings["p"]
    e.cloud.node_ready_delay = 40.0
    e.cloud.publish_image(_new_image(k))
    e.clock.advance(10)
    action = e.reconcile()
    assert action is not None and action.mechanism == "drift"
    assert old in e.state.nodes
    repl = next(n for n in e.state.nodes if n != old)
    assert not e.state.nodes[repl].initialized
    e.clock.advance(5)
    assert e.reconcile() is None and old in e.state.nodes
    e.clock.advance(36)
    e.reconcile()
    assert old not in e.state.nodes
    pump(e.prov_ctrl, e.clock)
    assert e.state.bindings["p"] == repl
    return e.observed()


def _failed_replace_backs_off(k):
    e = Env(k, drift_enabled=True)
    e.schedule([pod(k, "p", 0.5)])
    old = e.state.bindings["p"]
    e.cloud.publish_image(_new_image(k))
    creates_before = len(e.cloud.create_calls)
    e.cloud.next_error = k.base.InsufficientCapacityError(
        "c5.large", "zone-1a", "on-demand")
    e.clock.advance(10)
    e.reconcile()   # create fails -> action aborted
    assert old in e.state.nodes
    first_attempt = len(e.cloud.create_calls)
    assert first_attempt == creates_before + 1
    for _ in range(5):
        e.clock.advance(10)
        e.reconcile()
    assert len(e.cloud.create_calls) == first_attempt
    e.clock.advance(k.deprovisioning.REPLACE_RETRY_BACKOFF + 1)
    e.reconcile()
    assert len(e.cloud.create_calls) == first_attempt + 1
    assert old not in e.state.nodes
    return e.observed()


def _infeasible_replace_defers(k):
    L = k.L
    e = Env(k, prov(k, ttl_seconds_until_expired=3600.0,
                    requirements=[c2x(k)]))
    e.schedule([pod(k, "p", 1.0,
                    node_selector={L.INSTANCE_TYPE: "c5.2xlarge"})])
    node = e.state.bindings["p"]
    e.state.apply_provisioner(prov(
        k, ttl_seconds_until_expired=3600.0,
        requirements=[k.req.Requirement(L.INSTANCE_TYPE, k.req.IN,
                                        ["m5.large"])]))
    deletes_before = len(e.cloud.delete_calls)
    e.clock.advance(3601)
    e.reconcile()
    assert node in e.state.nodes
    assert e.state.bindings["p"] == node
    assert len(e.cloud.delete_calls) == deletes_before
    assert not e.cloud.create_calls[1:]
    assert any(ev.reason == "ReplacementInfeasible"
               for ev in e.recorder.events)
    for _ in range(3):
        e.clock.advance(10)
        e.reconcile()
    assert node in e.state.nodes
    e.clock.advance(k.deprovisioning.REPLACE_RETRY_BACKOFF + 1)
    e.reconcile()
    assert node in e.state.nodes and e.state.bindings["p"] == node
    return e.observed()


def _selector_images_do_not_drift(k):
    e = Env(k, drift_enabled=True)
    e.cloud.templates["default"] = k.templates.NodeTemplate(
        image_selector={"id": "img-pinned"})
    e.cloud.publish_image(k.templates.Image("img-pinned", k.L.ARCH_AMD64,
                                            created_at=1.0))
    e.schedule([pod(k, "p", 0.5)])
    machine = e.state.nodes[e.state.bindings["p"]].machine
    assert machine.image_id == "img-pinned"
    e.cloud.publish_image(k.templates.Image("img-other", k.L.ARCH_AMD64,
                                            created_at=99.0))
    assert not e.cloud.is_machine_drifted(machine)
    e.clock.advance(10)
    assert e.reconcile() is None
    return e.observed()


# ---------------------------------------------------------------------------
# what-ifs that must refuse: capacity-type spread, volume pins, density
# ---------------------------------------------------------------------------


def _ct_spread(k, hard):
    L = k.L
    e = Env(k, prov(k, consolidation_enabled=True, requirements=[
        k.req.Requirement(L.CAPACITY_TYPE, k.req.IN,
                          [L.CAPACITY_TYPE_SPOT, L.CAPACITY_TYPE_ON_DEMAND])]))
    sel = k.pod.LabelSelector.of({"app": "web"})
    when = "DoNotSchedule" if hard else "ScheduleAnyway"
    e.schedule([
        pod(k, f"web-{i}", 0.25, labels={"app": "web"}, owner_key="web",
            topology_spread=[k.pod.TopologySpreadConstraint(
                1, L.CAPACITY_TYPE, when, sel)])
        for i in range(4)])
    cts = {e.state.node_of(f"web-{i}").capacity_type for i in range(4)}
    e.clock.advance(lifetime(k) + 1)
    action = e.reconcile()
    assert cts == {L.CAPACITY_TYPE_SPOT, L.CAPACITY_TYPE_ON_DEMAND}
    assert action is None or action.kind != "delete", action
    return e.observed(sorted(cts))


def _volume_pinned(k, bind_volume):
    L = k.L
    e = Env(k)
    e.state.apply_storage(k.volume.StorageClass(name="ebs"))
    e.state.apply_storage(k.volume.PersistentVolumeClaim(
        name="data", storage_class="ebs"))
    if bind_volume:
        e.state.bind_volume("default", "data", k.volume.PersistentVolume(
            name="pv", zones=("zone-1b",)))
    e.schedule([pod(k, f"web-{i}", 1.0, node_selector={L.ZONE: "zone-1a"},
                    owner_key="web") for i in range(3)])
    db = pod(k, "db", 0.5, volume_claims=["data"] if bind_volume else [],
             preferred_affinity_terms=(
                 [] if bind_volume
                 else [[k.req.Requirement(L.ZONE, k.req.IN, ["zone-1b"])]]),
             owner_key="db")
    e.schedule([db])
    db_node = e.state.node_of("db")
    assert db_node.zone == "zone-1b"
    e.clock.advance(lifetime(k) + 1)
    action = e.reconcile()
    if bind_volume:
        assert db_node.name in e.state.nodes, action
    else:
        assert action is not None and action.mechanism == "consolidation"
        assert db_node.name in action.nodes or \
            db_node.name not in e.state.nodes
    return e.observed(db_node.name)


def _kubelet_density(k, shrink_to):
    e = Env(k, prov(k, consolidation_enabled=True,
                    kubelet=k.provisioner.KubeletConfiguration(max_pods=4)))
    e.schedule([pod(k, f"p-{i}", 0.1, owner_key="d") for i in range(8)])
    assert len(e.state.nodes) == 2  # density forced the split
    if shrink_to is not None:
        per: dict = {}
        for name in sorted(e.state.bindings):
            node = e.state.node_of(name).name
            per[node] = per.get(node, 0) + 1
            if per[node] > shrink_to:
                e.state.delete_pod(name)
    e.clock.advance(lifetime(k) + 1)
    action = e.reconcile()
    if shrink_to is None:
        assert action is None, action
        assert len(e.state.nodes) == 2
    else:
        assert action is not None and action.mechanism == "consolidation"
    return e.observed()


# ---------------------------------------------------------------------------
# test_consolidation_batch.py: the screen path and the batched what-ifs
# ---------------------------------------------------------------------------


def _screen_path_fires_above_threshold(k):
    e = Env(k, prov(k, consolidation_enabled=True, requirements=[c2x(k)]))
    for i in range(280):  # 40 nodes x 7 pods, then empty most of them
        e.state.add_pod(pod(k, f"p{i}", 1.0, owner_key="d"))
    pump(e.prov_ctrl, e.clock)
    assert len(e.state.nodes) >= 32
    for i in range(270):
        e.state.delete_pod(f"p{i}")
    e.clock.advance(lifetime(k) + 1)
    assert e.reconcile() is not None
    for _ in range(60):  # loop to steady state
        e.prov_ctrl.reconcile()
        e.clock.advance(2.0)
        e.prov_ctrl.reconcile()
        if e.reconcile() is None and not e.state.pending_pods():
            break
    assert len(e.state.nodes) < 10
    assert not e.state.pending_pods()
    return e.observed()


def _sweep_cluster(k, n_nodes, npods, cpu_alloc=8.0, pod_cpu=0.5):
    L = k.L
    nodes = []
    for i in range(n_nodes):
        node = k.types.SimNode(
            instance_type="m5.xlarge", provisioner="default", zone="zone-1a",
            capacity_type="on-demand", price=0.192,
            allocatable={L.RESOURCE_CPU: cpu_alloc,
                         L.RESOURCE_MEMORY: 64 * 2**30,
                         L.RESOURCE_PODS: 50.0},
            labels={L.ZONE: "zone-1a"}, name=f"c{i}")
        for j in range(npods):
            node.pods.append(k.pod.PodSpec(
                name=f"c{i}-p{j}", requests={L.RESOURCE_CPU: pod_cpu},
                owner_key=f"g{j % 3}"))
        nodes.append(node)
    return nodes


def _simulate_env(k, n_nodes, npods):
    """The reference's ``TestControllerSimulateBatch._controller``: a
    deprovisioning controller without provisioning over a sweep cluster."""
    e = Env(k, provisioning=False)
    for node in _sweep_cluster(k, n_nodes, npods):
        e.state.add_node(node).initialized = True
    return e, [[e.state.nodes[f"c{i}"]] for i in range(n_nodes)]


def _batch_matches_serial_simulate(k):
    e, targets = _simulate_env(k, 6, 3)
    serial = [e.deprov._simulate(t) for t in targets]
    batch = e.deprov._simulate_batch(targets)
    assert len(batch) == len(serial)
    assert any(a is not None and a.kind == "delete" for a in serial)
    assert [action_key(a) for a in batch] == [action_key(a) for a in serial]
    return [action_key(a) for a in batch]


def _boxed_exception_skips_only_its_candidate(k):
    e, targets = _simulate_env(k, 4, 2)
    real_solve = e.deprov.scheduler.solve

    def poisoned(pods, *a, **kw):
        if any(p.name.startswith("c2-") for p in pods):
            raise RuntimeError("injected what-if failure")
        return real_solve(pods, *a, **kw)

    e.deprov.scheduler.solve = poisoned
    batch = e.deprov._simulate_batch(targets)
    assert batch[2] is None
    assert all(batch[i] is not None and batch[i].kind == "delete"
               for i in (0, 1, 3))
    return [action_key(a) for a in batch]


def _stop_on_halts_serial_fill(k):
    e, targets = _simulate_env(k, 6, 3)
    calls = []
    real_solve = e.deprov.scheduler.solve

    def counting(pods, *a, **kw):
        calls.append([p.name for p in pods])
        return real_solve(pods, *a, **kw)

    e.deprov.scheduler.solve = counting
    serial_first = e.deprov._simulate(targets[0])
    assert serial_first is not None and serial_first.kind == "delete"
    calls.clear()
    batch = e.deprov._simulate_batch(
        targets, stop_on=lambda a: a is not None and a.kind == "delete")
    assert len(calls) == 1  # one what-if solve, not six
    assert action_key(batch[0]) == action_key(serial_first)
    assert all(a is None for a in batch[1:])
    return [action_key(a) for a in batch], calls


CASES = {
    "emptiness_ttl_after_empty_deletes": _ttl_after_empty_deletes,
    "emptiness_consolidation_owns_empty_nodes":
        _consolidation_owns_empty_nodes,
    "emptiness_daemon_only_node_reclaimed_under_pending_pods":
        _daemon_only_node_reclaimed,
    "emptiness_young_nodes_not_consolidated": _young_nodes_not_consolidated,
    "delete_underutilized_node_drained_onto_peer":
        _underutilized_node_drained_onto_peer,
    "delete_spot_is_delete_only": _spot_is_delete_only,
    "replace_with_cheaper_node": _replace_with_cheaper_node,
    "wait_ready_old_node_survives_until_replacement_ready":
        _old_node_survives_until_replacement_ready,
    "wait_ready_interrupted_replacement_abandons_action":
        _interrupted_replacement_abandons,
    "wait_ready_timeout_abandons_and_reaps_replacement":
        _timeout_abandons_and_reaps,
    "ttl_action_deferred_then_executed": _ttl_action_deferred_then_executed,
    "ttl_grown_delete_set_does_not_starve_proposal": _ttl_grown_delete_set,
    "ttl_invalidated_proposal_dropped": _ttl_invalidated_proposal_dropped,
    "multi_node_delete": _multi_node_delete,
    "multi_subset_screen_finds_pairwise_delete":
        _subset_screen_finds_pairwise_delete,
    "blockers_do_not_evict": _do_not_evict_blocks,
    "blockers_pdb_blocks_drain": _pdb_blocks_drain,
    "expiration_replaces": _expiration_replaces,
    "drift_gated_and_replaces": _drift_gated_and_replaces,
    "drift_disabled_no_action": _drift_disabled_no_action,
    "drift_image_detected_when_newer_image_published": _image_drift_detected,
    "drift_launch_template_override": _launch_template_override_drift,
    "drift_replace_waits_for_replacement_readiness":
        _drift_replace_waits_for_readiness,
    "drift_failed_replace_backs_off": _failed_replace_backs_off,
    "expiration_infeasible_replace_defers": _infeasible_replace_defers,
    "drift_selector_images_do_not_drift": _selector_images_do_not_drift,
    "ct_spread_hard_refuses_delete": lambda k: _ct_spread(k, True),
    "ct_spread_soft_refuses_delete": lambda k: _ct_spread(k, False),
    "volume_pinned_refuses_delete": lambda k: _volume_pinned(k, True),
    "volume_unpinned_consolidates": lambda k: _volume_pinned(k, False),
    "kubelet_density_cap_blocks_merge": lambda k: _kubelet_density(k, None),
    "kubelet_density_merge_at_cap": lambda k: _kubelet_density(k, 2),
    "integration_screen_path_fires_above_threshold":
        _screen_path_fires_above_threshold,
    "simulate_batch_matches_serial_simulate": _batch_matches_serial_simulate,
    "simulate_batch_boxed_exception_skips_only_its_candidate":
        _boxed_exception_skips_only_its_candidate,
    "simulate_batch_stop_on_halts_serial_fill_at_first_confirm":
        _stop_on_halts_serial_fill,
}


#: cases of the serial what-if path (they count the scheduler's serial
#: solves): the oracle backend only, as in the reference
SERIAL_ONLY = ("simulate_batch_boxed_exception_skips_only_its_candidate",
               "simulate_batch_stop_on_halts_serial_fill_at_first_confirm")


@pytest.mark.parametrize("case,backend", [
    (case, backend) for case in sorted(CASES) for backend in ("oracle", "tpu")
    if backend == "oracle" or case not in SERIAL_ONLY])
def test_deprovisioning_matches_reference(case, backend):
    run_both(CASES[case], backend=backend)


# ---------------------------------------------------------------------------
# the repack fleet to convergence
# ---------------------------------------------------------------------------


def _reference_repack(n_nodes, backend):
    """The reference bench's ``_repack_to_convergence`` over the
    reference's controllers, logging each tick's action."""
    k = package(REFERENCE)
    reset_counters(k)
    cat = catalog(k, full=True)
    e = Env(k, prov(k, consolidation_enabled=True).with_defaults(),
            deprovisioning_ttl=None, backend=backend, instance_types=cat)
    rng = np.random.default_rng(42)
    it = next(t for t in cat if t.allocatable.get("cpu", 0) >= 15)
    L = k.L
    for i in range(n_nodes):
        zone = f"zone-1{'abc'[i % 3]}"
        pods = [k.pod.PodSpec(
            name=f"n{i}-p{j}",
            requests={"cpu": float(rng.uniform(0.25, 1.5)),
                      "memory": float(rng.uniform(0.5, 2.0)) * GIB},
            owner_key=f"n{i}") for j in range(int(rng.integers(2, 6)))]
        node = k.types.SimNode(
            instance_type=it.name, provisioner="default", zone=zone,
            capacity_type="on-demand", price=it.offerings[0].price,
            allocatable=dict(it.allocatable),
            labels={**it.labels(), L.ZONE: zone,
                    L.CAPACITY_TYPE: "on-demand",
                    L.PROVISIONER_NAME: "default"},
            existing=True, name=f"bench-n{i}")
        node.labels[L.HOSTNAME] = node.name
        for p in pods:
            e.state.add_pod(p)
        node.pods = list(pods)
        e.state.add_node(node, machine=k.machine.Machine(
            name=f"m{i}", provider_id=f"i-r{i:08d}")).initialized = True
    e.clock.advance(lifetime(k) + 1)
    idle, ticks, log = 0, 0, []
    while idle < 12 and ticks < 800:
        act = e.deprov.reconcile()
        e.term.reconcile()
        e.prov_ctrl.reconcile()
        e.clock.advance(5.0)
        ticks += 1
        if act is not None:
            log.append((ticks, action_key(act)))
            idle = 0
        else:
            idle += 1
    return log, e.state


def test_repack_fleet_converges_like_reference():
    from karpenter_tpu_torch import repack

    ref_log, ref_state = _reference_repack(60, "oracle")
    port_pkg = package(PORT)
    cat = catalog(port_pkg, full=True)
    repack.reset_name_counters()
    log = []
    state, info, keys = repack.repack_to_convergence(
        cat, 60, "oracle", "cpu",
        on_tick=lambda t, _s, a: a is not None and log.append(
            (t, action_key(a))))
    assert log == ref_log
    assert keys == [key for _t, key in ref_log]
    assert repack.cluster_plan(state) == repack.cluster_plan(ref_state)
    assert state.bindings == ref_state.bindings
    assert repack.cluster_faults(state) == []
    assert info["pending_end"] == 0
    assert info["final_cost"] < info["initial_cost"]
