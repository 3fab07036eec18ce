"""In-memory cluster-state mirror.

Core's ``state.Cluster`` analog (SURVEY.md §2.2: "nodes, pods, bindings,
in-flight capacity consumed by scheduler + consolidation";
state.NewCluster(clock, client, cloudProvider) at suite_test.go:152).  All
durable state lives in the (simulated) API objects; this mirror is rebuilt
from them — same stateless-by-design posture as the reference (§5
checkpoint/resume).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from ..models import labels as L
from ..models.machine import Machine
from ..models.pod import PodSpec
from ..models.provisioner import Provisioner
from ..solver.types import SimNode
from ..utils.clock import Clock


@dataclass
class NodeState:
    node: SimNode
    machine: Optional[Machine] = None
    cordoned: bool = False
    initialized: bool = False
    marked_for_deletion: bool = False
    nominated_until: float = 0.0  # in-flight pods expected to land here
    empty_since: Optional[float] = None

    def workload_empty(self) -> bool:
        """No non-daemon pods: the single emptiness predicate shared by
        empty_nodes() and the deprovisioning empties paths (daemonset pods
        never make a node non-empty)."""
        return not any(not p.is_daemon for p in self.node.pods)


class ClusterState:
    def __init__(self, clock: Optional[Clock] = None) -> None:
        self.clock = clock or Clock()
        self.nodes: Dict[str, NodeState] = {}
        self.pods: Dict[str, PodSpec] = {}
        self.bindings: Dict[str, str] = {}  # pod name -> node name
        self.provisioners: Dict[str, Provisioner] = {}
        self.daemonsets: List[PodSpec] = []
        self.pod_added_at: Dict[str, float] = {}  # feeds pod-startup latency
        # storage objects backing volume-topology injection (scheduling.md:378-433)
        from ..models.volume import VolumeTopology

        self.volume_topology = VolumeTopology()
        self.seqnum = 0  # bumps on any change; consolidation backs off on no-change

    # ---- mutation ------------------------------------------------------
    def _changed(self) -> None:
        self.seqnum += 1

    def apply_provisioner(self, prov: Provisioner) -> None:
        from ..webhooks import admit_provisioner

        admit_provisioner(prov, apply_defaults=False)  # raises AdmissionError
        self.provisioners[prov.name] = prov
        self._changed()

    def delete_provisioner(self, name: str) -> None:
        self.provisioners.pop(name, None)
        self._changed()

    def add_pod(self, pod: PodSpec) -> None:
        self.pods[pod.name] = pod
        self.pod_added_at.setdefault(pod.name, self.clock.now())
        if pod.volume_claims:
            # best-effort early pin; _provision re-injects and holds back
            # pods whose claims still can't resolve
            self.volume_topology.inject(pod)
        self._changed()

    def _apply_storage_obj(self, obj) -> None:
        """Dispatch one PVC / PV / StorageClass into the volume registry."""
        from ..models.volume import (
            PersistentVolume,
            PersistentVolumeClaim,
            StorageClass,
        )

        vt = self.volume_topology
        if isinstance(obj, PersistentVolumeClaim):
            vt.apply_claim(obj)
        elif isinstance(obj, PersistentVolume):
            vt.apply_volume(obj)
        elif isinstance(obj, StorageClass):
            vt.apply_class(obj)
        else:  # pragma: no cover - programming error
            raise TypeError(f"not a storage object: {obj!r}")

    def apply_storage(self, obj) -> None:
        """Register one PVC / PV / StorageClass and re-pin affected pods."""
        self._apply_storage_obj(obj)
        self._storage_changed()

    def apply_storage_batch(self, objs) -> None:
        """Register many storage objects with ONE re-pin sweep (bulk manifest
        apply would otherwise sweep all pods once per object).  The sweep
        runs even if a later object raises, so objects applied before the
        failure are still reflected in pod pins."""
        applied = 0
        try:
            for obj in objs:
                self._apply_storage_obj(obj)
                applied += 1
        finally:
            if applied:
                self._storage_changed()

    def bind_volume(self, namespace: str, claim_name: str, pv) -> None:
        """CSI bound a volume to a claim (the WaitForFirstConsumer aftermath):
        register it and re-pin affected pods immediately."""
        self.volume_topology.bind(namespace, claim_name, pv)
        self._storage_changed()

    def _storage_changed(self) -> None:
        # storage reach changed: re-pin every claim-bearing pod NOW so
        # consolidation what-ifs and screens never simulate against stale
        # zone requirements (a wffc claim that just bound pins its pods)
        for pod in self.pods.values():
            if pod.volume_claims:
                self.volume_topology.inject(pod)
        self._changed()

    def delete_pod(self, name: str) -> None:
        self.pods.pop(name, None)
        self.pod_added_at.pop(name, None)
        node_name = self.bindings.pop(name, None)
        if node_name and node_name in self.nodes:
            ns = self.nodes[node_name]
            ns.node.pods = [p for p in ns.node.pods if p.name != name]
        self._changed()

    def add_node(self, node: SimNode, machine: Optional[Machine] = None) -> NodeState:
        ns = NodeState(node=node, machine=machine)
        self.nodes[node.name] = ns
        for p in node.pods:
            self.bindings[p.name] = node.name
        self._changed()
        return ns

    def remove_node(self, name: str) -> List[PodSpec]:
        """Remove a node; its workload pods become pending again
        (rescheduled).  Daemon pods are deleted outright — the daemonset
        controller only runs them on nodes that exist."""
        ns = self.nodes.pop(name, None)
        if ns is None:
            return []
        orphans = [p for p in ns.node.pods if not p.is_daemon]
        for p in ns.node.pods:
            self.bindings.pop(p.name, None)
            if p.is_daemon:
                self.pods.pop(p.name, None)
                self.pod_added_at.pop(p.name, None)
        ns.node.pods = []
        self._changed()
        return orphans

    def bind(self, pod_name: str, node_name: str) -> None:
        pod = self.pods.get(pod_name)
        ns = self.nodes.get(node_name)
        if pod is None or ns is None:
            raise KeyError(f"bind {pod_name}->{node_name}: unknown object")
        self.bindings[pod_name] = node_name
        if pod not in ns.node.pods:
            ns.node.pods.append(pod)
        ns.empty_since = None
        self._changed()

    def nominate(self, node_name: str, ttl: float = 30.0) -> None:
        ns = self.nodes.get(node_name)
        if ns:
            ns.nominated_until = self.clock.now() + ttl

    # ---- queries -------------------------------------------------------
    def pending_pods(self) -> List[PodSpec]:
        """Unbound pods that provisioning could help.  Daemon pods are
        excluded everywhere: the daemonset controller only places them on
        nodes that already exist, so they are never provisionable pending
        work and must not freeze consolidation's stabilization wait."""
        return [
            p for name, p in self.pods.items()
            if name not in self.bindings and not p.is_daemon
        ]

    def schedulable_nodes(self) -> List[SimNode]:
        """Nodes the scheduler may pack onto (not cordoned / being deleted)."""
        return [
            ns.node
            for ns in self.nodes.values()
            if not ns.cordoned and not ns.marked_for_deletion
        ]

    def provisioned_nodes(self) -> List[NodeState]:
        """Nodes owned by a provisioner (candidates for deprovisioning)."""
        return [
            ns for ns in self.nodes.values()
            if ns.node.labels.get(L.PROVISIONER_NAME) in self.provisioners
        ]

    def node_of(self, pod_name: str) -> Optional[SimNode]:
        name = self.bindings.get(pod_name)
        return self.nodes[name].node if name and name in self.nodes else None

    def empty_nodes(self, now: Optional[float] = None) -> List[NodeState]:
        now = self.clock.now() if now is None else now
        out = []
        for ns in self.provisioned_nodes():
            if ns.workload_empty():
                if not ns.marked_for_deletion:
                    if ns.empty_since is None:
                        ns.empty_since = now
                    out.append(ns)
            else:
                ns.empty_since = None
        return out

    def provisioner_usage(self, name: str) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for ns in self.nodes.values():
            if ns.node.labels.get(L.PROVISIONER_NAME) != name:
                continue
            for k, v in ns.node.allocatable.items():
                total[k] = total.get(k, 0.0) + v
        return total
