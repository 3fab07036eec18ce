"""Machine — the desired-node intermediate between scheduler and cloud.

Mirrors core's v1alpha5 Machine (SURVEY.md §2.2: "desired-node intermediate
with requirements/resources, providerID status"; created per scheduled node at
cloudprovider.go:130-152).  The solver emits one Machine per proposed node;
the cloud layer launches it and fills in status.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .pod import PodSpec, Taint
from .provisioner import KubeletConfiguration
from .requirements import Requirement, Requirements
from .resources import ResourceList

_machine_counter = itertools.count()


@dataclass
class Machine:
    name: str = ""
    provisioner: str = "default"
    requirements: Requirements = field(default_factory=Requirements)
    taints: List[Taint] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    resource_requests: ResourceList = field(default_factory=dict)  # sum of pods to place
    node_template: str = "default"
    # provisioner's kubeletConfiguration rides along so the cloud layer can
    # apply density/reservation overrides at launch
    kubelet: Optional[KubeletConfiguration] = None

    # status (set by the cloud layer)
    provider_id: str = ""
    node_name: str = ""  # node object name per nodeNameConvention (settings.go:52)
    launch_template: str = ""  # LT the instance launched with (EnsureAll)
    instance_type: str = ""
    zone: str = ""
    capacity_type: str = ""
    price: float = 0.0
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    launched_at: Optional[float] = None
    image_id: str = ""                  # instance's launch image (drift input)
    registered: bool = False
    initialized: bool = False
    # launch diagnostics (set by the cloud layer): ICE'd offerings skipped on
    # the way to a successful fleet launch, and flexibility warnings
    ice_errors: List[tuple] = field(default_factory=list)  # (type, zone, ct)
    launch_warnings: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.name:
            self.name = f"machine-{next(_machine_counter)}"
