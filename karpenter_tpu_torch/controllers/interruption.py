"""Interruption controller — proactive failure detection from a message queue.

Mirrors pkg/controllers/interruption (SURVEY.md §3.4): long-poll a queue of
infrastructure events, parse the four message schemas (spot interruption,
rebalance recommendation, scheduled change, instance state change), map
instance -> node, mark the spot offering unavailable so the solver routes
around it, then cordon-and-drain the node.  Latency is measured from the
event timestamp (interruption/controller.go:158).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..cache import UnavailableOfferings
from ..events import Event, Recorder
from ..metrics import (
    INTERRUPTION_LATENCY,
    INTERRUPTION_RECEIVED,
    Registry,
    registry as default_registry,
)
from ..models import labels as L
from ..utils.clock import Clock
from .state import ClusterState
from .termination import TerminationController

# message kinds (messages/* schemas in the reference)
SPOT_INTERRUPTION = "SpotInterruptionKind"
REBALANCE_RECOMMENDATION = "RebalanceRecommendationKind"
SCHEDULED_CHANGE = "ScheduledChangeKind"
STATE_CHANGE = "StateChangeKind"
_STOPPING_STATES = {"stopping", "stopped", "shutting-down", "terminated"}


@dataclass(frozen=True)
class InterruptionMessage:
    kind: str
    instance_id: str           # provider id
    timestamp: float
    detail: str = ""
    state: str = ""            # for STATE_CHANGE


class MessageQueue:
    """In-memory stand-in for the SQS long-poll (interruption/sqs.go)."""

    def __init__(self) -> None:
        self._messages: List[InterruptionMessage] = []
        self.deleted: int = 0

    def send(self, msg: InterruptionMessage) -> None:
        self._messages.append(msg)

    def receive(self, max_messages: int = 10) -> List[InterruptionMessage]:
        out, self._messages = self._messages[:max_messages], self._messages[max_messages:]
        return out

    def delete(self, msg: InterruptionMessage) -> None:
        self.deleted += 1

    def __len__(self) -> int:
        return len(self._messages)


class InterruptionController:
    def __init__(
        self,
        state: ClusterState,
        termination: TerminationController,
        queue: MessageQueue,
        unavailable: Optional[UnavailableOfferings] = None,
        recorder: Optional[Recorder] = None,
        registry: Optional[Registry] = None,
        clock: Optional[Clock] = None,
    ) -> None:
        self.state = state
        self.termination = termination
        self.queue = queue
        self.unavailable = unavailable or UnavailableOfferings(clock=clock or state.clock)
        self.recorder = recorder or Recorder()
        self.registry = registry or default_registry
        self.clock = clock or state.clock
        # zero-init every known message-kind series so Prometheus
        # rate()/increase() never lose the first interruption of a kind
        # (the ADVICE-r5 counter bug class; enforced package-wide by KT003)
        for kind in (SPOT_INTERRUPTION, REBALANCE_RECOMMENDATION,
                     SCHEDULED_CHANGE, STATE_CHANGE):
            self.registry.counter(INTERRUPTION_RECEIVED).inc(
                {"message_type": kind}, value=0.0
            )

    def reconcile(self) -> int:
        """Drain the queue; returns number of messages handled."""
        handled = 0
        while True:
            batch = self.queue.receive()
            if not batch:
                break
            for msg in batch:
                self._handle(msg)
                self.queue.delete(msg)
                handled += 1
        return handled

    # ---- internals -----------------------------------------------------
    def _node_of_instance(self, provider_id: str):
        for ns in self.state.nodes.values():
            if ns.machine is not None and ns.machine.provider_id == provider_id:
                return ns
        return None

    def _handle(self, msg: InterruptionMessage) -> None:
        self.registry.counter(INTERRUPTION_RECEIVED).inc({"message_type": msg.kind})
        self.registry.histogram(INTERRUPTION_LATENCY).observe(
            max(0.0, self.clock.now() - msg.timestamp), {"message_type": msg.kind}
        )
        ns = self._node_of_instance(msg.instance_id)
        if ns is None:
            return  # event for an instance we don't manage

        node = ns.node
        if msg.kind == SPOT_INTERRUPTION:
            # the spot market is reclaiming this offering: blacklist it
            if node.capacity_type == L.CAPACITY_TYPE_SPOT:
                self.unavailable.mark_unavailable(
                    node.instance_type, node.zone, node.capacity_type
                )
            self._cordon_and_drain(node.name, "SpotInterrupted", msg)
        elif msg.kind == REBALANCE_RECOMMENDATION:
            # advisory only: record the event; do not drain (reference parity)
            self.recorder.publish(Event("Node", node.name, "RebalanceRecommendation", msg.detail))
        elif msg.kind == SCHEDULED_CHANGE:
            self._cordon_and_drain(node.name, "ScheduledChange", msg)
        elif msg.kind == STATE_CHANGE:
            if msg.state.lower() in _STOPPING_STATES:
                self._cordon_and_drain(node.name, "InstanceStateChange", msg)

    def _cordon_and_drain(self, node_name: str, reason: str, msg: InterruptionMessage) -> None:
        self.recorder.publish(Event("Node", node_name, reason, msg.detail or msg.kind))
        self.termination.begin(node_name)
        self.termination.reconcile()
