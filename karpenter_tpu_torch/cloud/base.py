"""The provider-neutral CloudProvider boundary.

Mirrors core ``cloudprovider.CloudProvider`` exactly (asserted implemented at
upstream karpenter pkg/cloudprovider/cloudprovider.go:74; methods Create :130,
Link :155, List :165, Get :181, GetInstanceTypes :206, Delete :223,
IsMachineDrifted :233, Name :254).  The solver sits behind this boundary the
same way EC2 does in the reference: controllers never touch provider
internals.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..models.instancetype import InstanceType
from ..models.machine import Machine
from ..models.provisioner import Provisioner


class CloudProviderError(Exception):
    pass


class InsufficientCapacityError(CloudProviderError):
    """ICE — maps to the unfulfillable-capacity error codes taxonomy
    (pkg/errors/errors.go:40-46); callers mark the offering unavailable."""

    def __init__(self, instance_type: str, zone: str, capacity_type: str) -> None:
        self.instance_type = instance_type
        self.zone = zone
        self.capacity_type = capacity_type
        super().__init__(f"insufficient capacity: {capacity_type}:{instance_type}:{zone}")


class MachineNotFoundError(CloudProviderError):
    pass


class CloudProvider(abc.ABC):
    def configure_settings(self, settings) -> None:
        """Push the hot-reloadable global settings into the provider
        (settings.go:40-65 are consumed by the AWS layer in the reference:
        cluster name/endpoint into bootstrap, default instance profile and
        tags into launches, node-name convention into node naming).
        Default: no-op for providers that don't consume them."""

    @abc.abstractmethod
    def create(self, machine: Machine) -> Machine:
        """Launch an instance satisfying the machine's requirements; returns
        the machine with status (provider_id, instance_type, zone, ...)."""

    @abc.abstractmethod
    def delete(self, machine: Machine) -> None:
        ...

    @abc.abstractmethod
    def get(self, provider_id: str) -> Machine:
        ...

    @abc.abstractmethod
    def list(self) -> List[Machine]:
        ...

    @abc.abstractmethod
    def get_instance_types(self, provisioner: Optional[Provisioner] = None) -> List[InstanceType]:
        ...

    @abc.abstractmethod
    def is_machine_drifted(self, machine: Machine) -> bool:
        ...

    def link(self, machine: Machine) -> Machine:
        """Adopt an orphaned instance (migration path, cloudprovider.go:155)."""
        return self.get(machine.provider_id)

    def name(self) -> str:
        return "tpu-sim"

    def liveness(self) -> bool:
        return True
