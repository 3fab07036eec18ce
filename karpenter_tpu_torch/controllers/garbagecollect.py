"""Machine GC + link controllers.

- GC (pkg/controllers/machine/garbagecollect/controller.go:39-116): cloud
  instances with no matching in-cluster machine are leaked capacity; reap
  them on a periodic sweep (with a grace period so just-launched instances
  aren't reaped before registration).
- Link (pkg/controllers/machine/link/controller.go:46-134): orphaned cloud
  instances that carry our ownership tags are re-adopted as machines/nodes
  (warm-state rebuild after restart — SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

from typing import List, Optional

from ..cloud.base import CloudProvider, MachineNotFoundError
from ..events import Event, Recorder
from ..models import labels as L
from ..solver.types import SimNode
from ..utils.clock import Clock
from .state import ClusterState

GC_GRACE_SECONDS = 5 * 60.0  # mirror the reference's creation-age guard


class GarbageCollectController:
    def __init__(
        self,
        state: ClusterState,
        cloud: CloudProvider,
        recorder: Optional[Recorder] = None,
        clock: Optional[Clock] = None,
        grace_seconds: float = GC_GRACE_SECONDS,
    ) -> None:
        self.state = state
        self.cloud = cloud
        self.recorder = recorder or Recorder()
        self.clock = clock or state.clock
        self.grace = grace_seconds

    def reconcile(self) -> int:
        """Terminate instances with no matching machine; returns reap count."""
        known = {
            ns.machine.provider_id
            for ns in self.state.nodes.values()
            if ns.machine is not None and ns.machine.provider_id
        }
        reaped = 0
        for machine in self.cloud.list():
            if machine.provider_id in known:
                continue
            if machine.launched_at is not None and (
                self.clock.now() - machine.launched_at < self.grace
            ):
                continue  # too young: may still be registering
            try:
                self.cloud.delete(machine)
            except MachineNotFoundError:
                continue
            reaped += 1
            self.recorder.publish(Event(
                "Machine", machine.name, "GarbageCollected",
                f"leaked instance {machine.provider_id} terminated",
            ))
        return reaped


class LinkController:
    def __init__(
        self,
        state: ClusterState,
        cloud: CloudProvider,
        recorder: Optional[Recorder] = None,
        clock: Optional[Clock] = None,
    ) -> None:
        self.state = state
        self.cloud = cloud
        self.recorder = recorder or Recorder()
        self.clock = clock or state.clock

    def reconcile(self) -> int:
        """Adopt orphaned owned instances back into cluster state."""
        known = {
            ns.machine.provider_id
            for ns in self.state.nodes.values()
            if ns.machine is not None and ns.machine.provider_id
        }
        adopted = 0
        for machine in self.cloud.list():
            if machine.provider_id in known:
                continue
            if machine.provisioner not in self.state.provisioners:
                continue  # not ours
            node = SimNode(
                instance_type=machine.instance_type,
                provisioner=machine.provisioner,
                zone=machine.zone,
                capacity_type=machine.capacity_type,
                price=machine.price,
                allocatable=dict(machine.allocatable),
                labels=dict(machine.labels),
                taints=list(machine.taints),
                existing=True,
                # adoption must preserve the node's identity: the same
                # instance re-registers under its nodeNameConvention name,
                # not a fresh synthetic one (hostname topology would diverge)
                name=machine.node_name,
                created_at=machine.launched_at or self.clock.now(),
            )
            node.labels[L.HOSTNAME] = node.name
            ns = self.state.add_node(node, machine=machine)
            ns.initialized = True
            adopted += 1
            self.recorder.publish(Event(
                "Machine", machine.name, "Linked",
                f"adopted orphaned instance {machine.provider_id}",
            ))
        return adopted
