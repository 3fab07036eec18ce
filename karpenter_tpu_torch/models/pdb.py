"""PodDisruptionBudget — gates eviction during termination/consolidation.

The reference consults PDBs in the termination drain (designs/termination.md)
and excludes nodes whose pods are PDB-blocked from consolidation
(designs/consolidation.md "Pods that Prevent Consolidation").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

from .pod import LabelSelector, PodSpec


@dataclass(frozen=True)
class PodDisruptionBudget:
    name: str
    selector: LabelSelector
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None
    namespace: str = "default"

    def matches(self, pod: PodSpec) -> bool:
        return pod.namespace == self.namespace and self.selector.matches(pod.labels)

    def disruptions_allowed(self, pods: Sequence[PodSpec], bound: Mapping[str, str]) -> int:
        """How many matching pods may be evicted right now.

        ``bound`` maps pod name -> node (a bound pod counts as healthy).
        """
        matching = [p for p in pods if self.matches(p)]
        healthy = sum(1 for p in matching if p.name in bound)
        if self.max_unavailable is not None:
            unavailable = len(matching) - healthy
            return max(0, self.max_unavailable - unavailable)
        if self.min_available is not None:
            return max(0, healthy - self.min_available)
        return len(matching)
