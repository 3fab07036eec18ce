"""Subnet provider — tag-based discovery + in-flight IP accounting.

Mirrors pkg/providers/subnet/subnet.go:40-246: selector-driven discovery,
pick the most-free-IP subnet per zone for a launch, and track in-flight IPs
so concurrent launches don't oversubscribe a subnet before the cloud reports
the new usage.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence


@dataclass
class Subnet:
    subnet_id: str
    zone: str
    available_ips: int
    tags: Dict[str, str] = field(default_factory=dict)


def _matches(tags: Mapping[str, str], selector: Mapping[str, str]) -> bool:
    for k, v in selector.items():
        if k in ("id", "ids"):
            # comma-separated membership, like the reference's aws-ids
            # selector (subnet.go:211-233, SplitCommaSeparatedString)
            wanted = {s.strip() for s in v.split(",")}
            if tags.get("id") not in wanted and tags.get("subnet-id", "") not in wanted:
                return False
        elif v == "*":
            if k not in tags:
                return False
        elif tags.get(k) != v:
            return False
    return True


class SubnetProvider:
    def __init__(self, subnets: Sequence[Subnet] = ()) -> None:
        self.subnets: List[Subnet] = list(subnets)
        self._inflight: Dict[str, int] = {}

    def list(self, selector: Mapping[str, str]) -> List[Subnet]:
        if not selector:
            return list(self.subnets)
        out = []
        for s in self.subnets:
            tags = {**s.tags, "id": s.subnet_id}
            if _matches(tags, selector):
                out.append(s)
        return out

    def zonal_subnets_for_launch(self, selector: Mapping[str, str]) -> Dict[str, Subnet]:
        """Most-free-IP subnet per zone, net of in-flight usage
        (subnet.go:91-127)."""
        best: Dict[str, Subnet] = {}
        for s in self.list(selector):
            free = s.available_ips - self._inflight.get(s.subnet_id, 0)
            if free <= 0:
                continue
            cur = best.get(s.zone)
            if cur is None or free > (cur.available_ips - self._inflight.get(cur.subnet_id, 0)):
                best[s.zone] = s
        return best

    def reserve(self, subnet_id: str, ips: int = 1) -> None:
        """In-flight IP accounting (subnet.go:119-125)."""
        self._inflight[subnet_id] = self._inflight.get(subnet_id, 0) + ips

    def sync(self, subnet_id: str, available_ips: int) -> None:
        """Cloud reported fresh availability: clear in-flight for it
        (subnet.go:130-183 UpdateInflightIPs)."""
        for s in self.subnets:
            if s.subnet_id == subnet_id:
                s.available_ips = available_ips
        self._inflight.pop(subnet_id, None)
