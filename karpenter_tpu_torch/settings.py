"""Global settings — the karpenter-global-settings ConfigMap analog.

Three config layers mirror the reference (SURVEY.md §5 config/flag system):
(1) process options (env/flags — operator.py), (2) these hot-reloadable
global settings (pkg/apis/settings/settings.go:40-156 + core batch settings,
concepts/settings.md), (3) per-pool CRDs (Provisioner / NodeTemplate).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional


@dataclass(frozen=True)
class Settings:
    cluster_name: str = "sim"
    cluster_endpoint: str = ""
    default_instance_profile: str = ""
    vm_memory_overhead_percent: float = 0.075   # settings.go:48
    enable_pod_eni: bool = False
    enable_eni_limited_pod_density: bool = True
    isolated_vpc: bool = False
    node_name_convention: str = "ip-name"
    interruption_queue_name: str = ""
    tags: Dict[str, str] = field(default_factory=dict)
    # core batch settings (settings.md:41-47)
    batch_max_duration: float = 10.0
    batch_idle_duration: float = 1.0
    # feature gates (settings.md:76-78)
    drift_enabled: bool = False
    # deprovisioning tunable (designs/deprovisioning.md "DeprovisioningTTL
    # of 15 seconds ... can be tuned")
    deprovisioning_ttl: float = 15.0

    def validate(self) -> List[str]:
        errs = []
        if not 0.0 <= self.vm_memory_overhead_percent < 1.0:
            errs.append("vmMemoryOverheadPercent must be in [0, 1)")
        if self.batch_idle_duration < 0 or self.batch_max_duration < 0:
            errs.append("batch durations must be non-negative")
        if self.batch_idle_duration > self.batch_max_duration:
            errs.append("batchIdleDuration must be <= batchMaxDuration")
        if self.deprovisioning_ttl < 0:
            errs.append("deprovisioningTTL must be non-negative")
        for k in self.tags:
            if k.startswith("karpenter.sh/") or k.startswith("kubernetes.io/cluster/"):
                # reserved prefixes: global tags must not override the
                # ownership/attribution tags the launcher stamps
                errs.append(f"tags[{k!r}] uses a restricted tag prefix")
        return errs


class SettingsStore:
    """Hot-reloadable settings with change subscribers (the ConfigMap watcher
    analog: settings are re-injected per reconcile in the reference)."""

    def __init__(self, initial: Optional[Settings] = None) -> None:
        self._current = initial or Settings()
        self._subscribers: List[Callable[[Settings], None]] = []

    @property
    def current(self) -> Settings:
        return self._current

    def update(self, **changes) -> Settings:
        new = replace(self._current, **changes)
        errs = new.validate()
        if errs:
            raise ValueError(f"invalid settings: {errs}")
        self._current = new
        for fn in self._subscribers:
            fn(new)
        return new

    def subscribe(self, fn: Callable[[Settings], None]) -> None:
        self._subscribers.append(fn)
