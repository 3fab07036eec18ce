"""Security-group provider — tag/id discovery with TTL cache
(pkg/providers/securitygroup/securitygroup.go:36-128)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

from ..cache import DEFAULT_TTL, TTLCache
from ..utils.clock import Clock


@dataclass
class SecurityGroup:
    group_id: str
    name: str = ""
    tags: Dict[str, str] = field(default_factory=dict)


class SecurityGroupProvider:
    def __init__(self, groups: Sequence[SecurityGroup] = (), clock: Optional[Clock] = None) -> None:
        self.groups: List[SecurityGroup] = list(groups)
        self._cache: TTLCache = TTLCache(DEFAULT_TTL, clock=clock)

    def list(self, selector: Mapping[str, str]) -> List[SecurityGroup]:
        key = tuple(sorted(selector.items()))
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        out = []
        for g in self.groups:
            ok = True
            for k, v in selector.items():
                if k in ("id", "ids"):
                    if g.group_id not in {s.strip() for s in v.split(",")}:
                        ok = False
                        break
                elif v == "*":
                    if k not in g.tags:
                        ok = False
                        break
                elif g.tags.get(k) != v:
                    ok = False
                    break
            if ok:
                out.append(g)
        self._cache.put(key, out)
        return out
