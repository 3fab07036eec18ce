"""Batched cloud boundary — request coalescing at the provider edge.

Mirrors pkg/batcher (batcher.go:29-171 generic coalescer; createfleet.go,
describeinstances.go, terminateinstances.go executors): concurrent cloud
calls are hash-bucketed, the first caller in a bucket waits a short idle
window for peers to join, then ONE backend round trip serves the whole
bucket with per-caller results fanned back out.

- ``create``: bucketed by machine spec (provisioner, template, requirements)
  — the CreateFleet fan-out: identical specs share one fleet request and each
  requester receives its own instance (createfleet.go semantics).
- ``get``: all concurrent gets merge into one describe (describeinstances.go)
  resolved via a single ``inner.list()``; absent ids map back to per-caller
  ``MachineNotFoundError``.
- ``delete``: concurrent deletes merge into one terminate round trip
  (terminateinstances.go).

The decorator sits *below* the metrics decorator, like the reference's
batcher sits inside the AWS provider under core's metrics.Decorate.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..batcher import ThreadCoalescer
from ..models.instancetype import InstanceType
from ..models.machine import Machine
from ..models.provisioner import Provisioner
from .base import CloudProvider, MachineNotFoundError

#: outcome of one request inside a batch: ("ok", value) | ("err", exception)
_Outcome = Tuple[str, object]


class BatchedCloud(CloudProvider):
    """Coalescing decorator over any CloudProvider."""

    def __init__(self, inner: CloudProvider, idle_seconds: float = 0.002) -> None:
        self.inner = inner
        self.creates = ThreadCoalescer(self._do_creates, idle_seconds)
        self.describes = ThreadCoalescer(self._do_describes, idle_seconds)
        self.terminates = ThreadCoalescer(self._do_terminates, idle_seconds)

    # ---- batch executors: one backend round trip each -------------------
    def _do_creates(self, machines: List[Machine]) -> List[_Outcome]:
        bulk = getattr(self.inner, "create_fleet", None)
        if bulk is not None:
            # one fleet round trip; per-slot Machine or error fans out
            return [
                ("err", slot) if isinstance(slot, Exception) else ("ok", slot)
                for slot in bulk(machines)
            ]
        # provider without a bulk hook: coalescing only dedups the window,
        # each create is still its own round trip
        out: List[_Outcome] = []
        for m in machines:
            try:
                out.append(("ok", self.inner.create(m)))
            # ktlint: allow[KT005] per-machine fan-out contract: each slot
            # carries its own outcome and the caller re-raises its slot
            except Exception as err:
                out.append(("err", err))
        return out

    def _do_describes(self, pids: List[str]) -> List[_Outcome]:
        try:
            by_id = {m.provider_id: m for m in self.inner.list()}
        # ktlint: allow[KT005] a failed list fans the error to every
        # coalesced describe; each caller re-raises its slot
        except Exception as err:
            return [("err", err)] * len(pids)
        out: List[_Outcome] = []
        for pid in pids:
            m = by_id.get(pid)
            if m is None:
                out.append(("err", MachineNotFoundError(pid)))
            else:
                out.append(("ok", m))
        return out

    def _do_terminates(self, machines: List[Machine]) -> List[_Outcome]:
        out: List[_Outcome] = []
        for m in machines:
            try:
                self.inner.delete(m)
                out.append(("ok", None))
            # ktlint: allow[KT005] per-machine fan-out contract, as above
            except Exception as err:
                out.append(("err", err))
        return out

    # ---- CloudProvider ---------------------------------------------------
    def create(self, machine: Machine) -> Machine:
        key = (
            "create", machine.provisioner, machine.node_template,
            repr(machine.requirements),  # spec-hash bucket (createfleet.go)
        )
        return self.creates.call(key, machine)

    def get(self, provider_id: str) -> Machine:
        return self.describes.call("describe", provider_id)

    def delete(self, machine: Machine) -> None:
        return self.terminates.call("terminate", machine)

    def list(self) -> List[Machine]:
        return self.inner.list()

    def get_instance_types(self, provisioner: Optional[Provisioner] = None) -> List[InstanceType]:
        return self.inner.get_instance_types(provisioner)

    def is_machine_drifted(self, machine: Machine) -> bool:
        return self.inner.is_machine_drifted(machine)

    def link(self, machine: Machine) -> Machine:
        return self.inner.link(machine)

    def name(self) -> str:
        return self.inner.name()

    def liveness(self) -> bool:
        return self.inner.liveness()

    def configure_settings(self, settings) -> None:
        # explicit forward: the base class's no-op default would otherwise
        # shadow __getattr__ delegation and strand settings at this layer
        self.inner.configure_settings(settings)

    def __getattr__(self, name: str):
        # transparent for provider-specific surface (test injection hooks,
        # node_ready_delay, instance tables) — only missing attrs land here
        return getattr(self.inner, name)
