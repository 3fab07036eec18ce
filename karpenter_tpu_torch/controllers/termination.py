"""Termination controller — graceful node teardown.

Finalizer-flow semantics from designs/termination.md + deprovisioning.md:9-16:
cordon -> evict pods via the (simulated) Eviction API respecting PDBs and the
do-not-evict annotation -> when drained, CloudProvider.Delete -> remove the
node object ("remove finalizer").  Daemonset pods don't block drain.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..cloud.base import CloudProvider, MachineNotFoundError
from ..events import Event, Recorder
from ..metrics import NODES_TERMINATED, Registry, registry as default_registry
from ..models.pdb import PodDisruptionBudget
from ..models.pod import PodSpec
from ..utils.clock import Clock
from .state import ClusterState


class TerminationController:
    def __init__(
        self,
        state: ClusterState,
        cloud: CloudProvider,
        recorder: Optional[Recorder] = None,
        registry: Optional[Registry] = None,
        clock: Optional[Clock] = None,
    ) -> None:
        self.state = state
        self.cloud = cloud
        self.recorder = recorder or Recorder()
        self.registry = registry or default_registry
        self.clock = clock or state.clock
        self.pdbs: List[PodDisruptionBudget] = []
        #: nodes holding the "finalizer" — reconcile visits ONLY these (a
        #: full-cluster scan per reconcile turned the interruption hot path
        #: O(cluster x messages)).  begin() is the only marker, so this is
        #: authoritative; a dict (not a set) so drain order stays insertion-
        #: ordered and deterministic (PDB budgets go to the first-marked
        #: node, independent of string hashing).
        self._pending: Dict[str, None] = {}

    # ---- API -----------------------------------------------------------
    def begin(self, node_name: str) -> None:
        """Start terminating a node (adds the 'finalizer': cordon + mark)."""
        ns = self.state.nodes.get(node_name)
        if ns is None:
            return
        ns.cordoned = True
        ns.marked_for_deletion = True
        self._pending[node_name] = None
        self.recorder.publish(Event("Node", node_name, "TerminationStarted", "cordoned"))

    def reconcile(self) -> None:
        """Drain marked nodes; delete fully-drained ones."""
        for name in list(self._pending):
            ns = self.state.nodes.get(name)
            if ns is None or not ns.marked_for_deletion:
                self._pending.pop(name, None)
                continue
            self._drain(name)
            ns = self.state.nodes.get(name)
            if ns is None:
                self._pending.pop(name, None)
                continue
            if not ns.node.pods:
                self._finalize(name)
                self._pending.pop(name, None)

    # ---- internals -------------------------------------------------------
    def _evictable(self, pod: PodSpec) -> bool:
        if pod.do_not_evict:
            return False
        for pdb in self.pdbs:
            if pdb.matches(pod):
                if pdb.disruptions_allowed(list(self.state.pods.values()), self.state.bindings) < 1:
                    return False
        return True

    def _drain(self, node_name: str) -> None:
        ns = self.state.nodes.get(node_name)
        if ns is None:
            return
        for pod in list(ns.node.pods):
            if not self._evictable(pod):
                continue
            if pod.is_daemon:
                # daemon pods die with the node (the daemonset controller
                # recreates them only on nodes that exist) — they never
                # become pending
                self.state.delete_pod(pod.name)
                continue
            # eviction: unbind; the owning controller recreates it -> pending
            self.state.bindings.pop(pod.name, None)
            ns.node.pods.remove(pod)
            self.state._changed()
            self.recorder.publish(Event("Pod", pod.name, "Evicted", f"drained from {node_name}"))

    def _finalize(self, node_name: str) -> None:
        ns = self.state.nodes.get(node_name)
        if ns is None:
            return
        if ns.machine is not None and ns.machine.provider_id:
            try:
                self.cloud.delete(ns.machine)
            except MachineNotFoundError:
                pass  # already gone; proceed to remove the node object
        self.state.remove_node(node_name)
        # ktlint: allow[KT003] the provisioner label value is runtime data
        # (user-defined names); the series cannot be pre-created
        self.registry.counter(NODES_TERMINATED).inc(
            {"provisioner": ns.node.provisioner}
        )
        self.recorder.publish(Event("Node", node_name, "Terminated", "finalizer removed"))

    def blocked(self, node_name: str) -> List[str]:
        """Pods preventing this node from draining (for events/metrics)."""
        ns = self.state.nodes.get(node_name)
        if ns is None:
            return []
        return [p.name for p in ns.node.pods if not self._evictable(p)]
