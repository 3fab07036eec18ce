"""Provisioning controller: pending pods -> batch -> solve -> create machines.

The reconcile loop of SURVEY.md §3.2: watch unschedulable pods, batch them
(idle/max windows), invoke the scheduler, then ``CloudProvider.create`` per
proposed machine; ICE errors feed the unavailable-offerings cache so the next
solve routes around the missing capacity (§5 failure-detection posture).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..batcher import Window
from ..cache import UnavailableOfferings
from ..cloud.base import CloudProvider, InsufficientCapacityError
from ..events import Event, Recorder
from ..metrics import (
    BATCH_SIZE,
    NODES_CREATED,
    PODS_STARTUP_DURATION,
    PROVISIONER_LIMIT,
    PROVISIONER_USAGE,
    Registry,
    registry as default_registry,
)
from ..models import labels as L
from ..models.machine import Machine
from ..models.pod import PodSpec
from ..models.requirements import IN, Requirement, Requirements
from ..obs import tracer_for
from ..obs.trace import NULL_TRACE, Tracer
from ..solver.scheduler import BatchScheduler
from ..solver.types import SimNode, SolveResult
from ..utils.clock import Clock
from .state import ClusterState


class ProvisioningController:
    def __init__(
        self,
        state: ClusterState,
        cloud: CloudProvider,
        scheduler: Optional[BatchScheduler] = None,
        recorder: Optional[Recorder] = None,
        registry: Optional[Registry] = None,
        unavailable: Optional[UnavailableOfferings] = None,
        clock: Optional[Clock] = None,
        idle_seconds: float = 1.0,
        max_seconds: float = 10.0,
        tracer: Optional[Tracer] = None,
    ) -> None:
        self.state = state
        self.cloud = cloud
        self.scheduler = scheduler or BatchScheduler()
        self.recorder = recorder or Recorder()
        self.registry = registry or default_registry
        self.unavailable = unavailable or UnavailableOfferings(clock=clock or state.clock)
        self.clock = clock or state.clock
        # after self.clock: the default tracer must run on the controller's
        # clock, or FakeClock tests would mix two time bases in one trace
        self.tracer = (tracer if tracer is not None
                       else tracer_for(self.registry, clock=self.clock))
        self.window: Window[PodSpec] = Window(idle_seconds, max_seconds, clock=self.clock)
        self._queued: Set[str] = set()

    # ---- reconcile loop ------------------------------------------------
    def reconcile(self) -> Optional[SolveResult]:
        """One tick: enqueue pending pods; when the batch window fires, solve
        and launch.  Returns the SolveResult when a solve happened."""
        for pod in self.state.pending_pods():  # daemon pods excluded by state
            if pod.name not in self._queued:
                self.window.add(pod)
                self._queued.add(pod.name)
        if not self.window.ready():
            return None
        window_opened = self.window.opened_at
        batch = self.window.pop()
        self._queued.difference_update(p.name for p in batch)
        # pods may have been deleted/bound/replaced while queued: re-resolve
        # the live spec from state so a same-name re-add isn't solved stale
        batch = [
            self.state.pods[p.name]
            for p in batch
            if p.name in self.state.pods and p.name not in self.state.bindings
        ]
        if not batch:
            return None
        self.registry.histogram(BATCH_SIZE).observe(len(batch))
        # one trace per provisioning pass: the batcher window the pods sat
        # in, then the scheduler's own spans (tensorize/dispatch/fence/
        # reseat), then the machine launches
        with self.tracer.start("provision", n_pods=len(batch)) as trace:
            if window_opened is not None:
                trace.record("window", window_opened, self.clock.now())
            return self._provision(batch, trace=trace)

    def _provision(self, batch: List[PodSpec],
                   trace=NULL_TRACE) -> SolveResult:
        # volume-topology injection: fold each pod's storage reach (bound PV
        # zone / WaitForFirstConsumer allowedTopologies) into its scheduling
        # requirements before the solve (scheduling.md:378-433).  Pods whose
        # claims can't resolve stay pending — scheduling them storage-blind
        # would land them off-zone.
        ready: List[PodSpec] = []
        for pod in batch:
            errors = self.state.volume_topology.inject(pod)
            if errors:
                self.recorder.publish(Event(
                    "Pod", pod.name, "FailedScheduling",
                    "; ".join(errors), "Warning",
                ))
                continue
            ready.append(pod)
        batch = ready
        if not batch:
            return SolveResult(nodes=[], assignments={}, infeasible={})
        provisioners = [p.with_defaults() for p in self.state.provisioners.values()]
        instance_types = self.cloud.get_instance_types()
        result = self.scheduler.solve(
            batch,
            provisioners,
            instance_types,
            existing_nodes=self.state.schedulable_nodes(),
            daemonsets=self.state.daemonsets,
            unavailable=self.unavailable.as_set(),
            trace=trace,
        )

        for pod_name, reason in result.infeasible.items():
            self.recorder.publish(
                Event("Pod", pod_name, "FailedScheduling", reason, "Warning")
            )

        # pods placed on existing nodes: nominate + bind
        new_node_names = {n.name for n in result.nodes}
        for pod_name, node_name in result.assignments.items():
            if node_name not in new_node_names and node_name in self.state.nodes:
                self.state.nominate(node_name)
                self.state.bind(pod_name, node_name)

        # launch one machine per proposed node
        with trace.span("launch", n_nodes=len(result.nodes)):
            for node in result.nodes:
                machine = self._machine_for(node, provisioners)
                try:
                    machine = self.cloud.create(machine)
                except InsufficientCapacityError as err:
                    self.unavailable.mark_unavailable(
                        err.instance_type, err.zone, err.capacity_type
                    )
                    self.recorder.publish(Event(
                        "Machine", machine.name, "InsufficientCapacity",
                        str(err), "Warning",
                    ))
                    # pods stay pending; next reconcile re-solves around the ICE
                    continue
                # ICE'd pools the fleet skipped on the way to success still feed
                # the blacklist (instance.go:395-401); flexibility warnings
                # surface as events (checkODFallback, instance.go:261-281)
                for t, z, ct in machine.ice_errors:
                    self.unavailable.mark_unavailable(t, z, ct)
                for w in machine.launch_warnings:
                    self.recorder.publish(Event(
                        "Machine", machine.name, "OnDemandFlexibility", w, "Warning",
                    ))
                # ktlint: allow[KT003] the provisioner label value is runtime
                # data (user-defined names); the series cannot be pre-created at
                # construction
                self.registry.counter(NODES_CREATED).inc(
                    {"provisioner": machine.provisioner}
                )
                launched = SimNode(
                    instance_type=machine.instance_type,
                    provisioner=machine.provisioner,
                    zone=machine.zone,
                    capacity_type=machine.capacity_type,
                    price=machine.price,
                    allocatable=dict(machine.allocatable),
                    labels=dict(machine.labels),
                    taints=list(machine.taints),
                    existing=True,
                    # the registered node carries the cloud's name (per
                    # nodeNameConvention, settings.go:52); binds below use it,
                    # and existing-vs-new discrimination above used node.name
                    name=machine.node_name or node.name,
                    created_at=self.clock.now(),
                )
                launched.labels[L.HOSTNAME] = launched.name
                prov = self.state.provisioners.get(machine.provisioner)
                if prov and prov.ttl_seconds_until_expired is not None:
                    launched.expires_at = self.clock.now() + prov.ttl_seconds_until_expired
                ns = self.state.add_node(launched, machine=machine)
                ns.initialized = True
                for pod in node.pods:
                    if pod.name in self.state.pods:
                        self.state.bind(pod.name, launched.name)
        self._observe_bind_latency(result)
        self._update_limit_gauges()
        return result

    def _observe_bind_latency(self, result: SolveResult) -> None:
        """Pod startup latency: add_pod -> bound (pods_startup_time analog)."""
        now = self.clock.now()
        hist = self.registry.histogram(PODS_STARTUP_DURATION)
        for pod_name in result.assignments:
            if pod_name in self.state.bindings:
                t0 = self.state.pod_added_at.get(pod_name)
                if t0 is not None:
                    hist.observe(max(0.0, now - t0))

    def _update_limit_gauges(self) -> None:
        """Per-provisioner usage vs configured limits (metrics.md gauges).
        Usage counts raw machine CAPACITY — the same accounting every solver
        enforces the limit with (reference.py/tpu.py/native.py), so the
        exported headroom matches what scheduling will actually allow."""
        raw_cap = {it.name: it.capacity for it in self.cloud.get_instance_types()}
        usage: dict = {}
        for ns in self.state.nodes.values():
            prov_name = ns.node.labels.get(L.PROVISIONER_NAME, "")
            if not prov_name:
                continue
            per = usage.setdefault(prov_name, {})
            cap = raw_cap.get(ns.node.instance_type, ns.node.allocatable)
            for rname, v in cap.items():
                per[rname] = per.get(rname, 0.0) + v
        for prov_name, prov in self.state.provisioners.items():
            for rname, v in usage.get(prov_name, {}).items():
                self.registry.gauge(PROVISIONER_USAGE).set(
                    v, {"provisioner": prov_name, "resource_type": rname})
            for rname, lim in prov.limits.items():
                self.registry.gauge(PROVISIONER_LIMIT).set(
                    lim, {"provisioner": prov_name, "resource_type": rname})

    def _machine_for(self, node: SimNode, provisioners) -> Machine:
        """Build the Machine (desired-node) spec from a solver-proposed node,
        mirroring how core emits machines with requirement sets (§3.2 step 3)."""
        prov = next((p for p in provisioners if p.name == node.provisioner), None)
        reqs = Requirements()
        reqs.add(Requirement(L.INSTANCE_TYPE, IN, [node.instance_type]))
        reqs.add(Requirement(L.ZONE, IN, [node.zone]))
        reqs.add(Requirement(L.CAPACITY_TYPE, IN, [node.capacity_type]))
        requests: Dict[str, float] = {}
        for p in node.pods:
            for k, v in p.requests.items():
                requests[k] = requests.get(k, 0.0) + v
        return Machine(
            provisioner=node.provisioner,
            requirements=reqs,
            taints=list(prov.taints) if prov else [],
            labels=dict(prov.labels) if prov else {},
            resource_requests=requests,
            node_template=prov.node_template if prov else "default",
            kubelet=prov.kubelet if prov else None,
        )
