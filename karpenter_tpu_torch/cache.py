"""TTL caches and the unavailable-offerings (ICE) cache.

Mirrors pkg/cache/cache.go TTL constants and
pkg/cache/unavailableofferings.go:31-80: offerings that failed with
insufficient-capacity are blacklisted (keyed capacityType:instanceType:zone)
for a TTL, and a seqnum bumps so downstream caches (instance-type lists,
solver tensors) invalidate.
"""

from __future__ import annotations

from typing import Dict, Generic, Optional, Set, Tuple, TypeVar

from .utils.clock import Clock

K = TypeVar("K")
V = TypeVar("V")

# TTLs from the reference (pkg/cache/cache.go)
DEFAULT_TTL = 60.0
UNAVAILABLE_OFFERINGS_TTL = 3 * 60.0
INSTANCE_TYPES_ZONES_TTL = 5 * 60.0
PRICING_REFRESH_PERIOD = 12 * 3600.0


class TTLCache(Generic[K, V]):
    def __init__(self, ttl: float, clock: Optional[Clock] = None) -> None:
        self.ttl = ttl
        self.clock = clock or Clock()
        self._data: Dict[K, Tuple[float, V]] = {}

    def get(self, key: K) -> Optional[V]:
        got = self._data.get(key)
        if got is None:
            return None
        ts, val = got
        if self.clock.now() - ts > self.ttl:
            del self._data[key]
            return None
        return val

    def put(self, key: K, value: V) -> None:
        self._data[key] = (self.clock.now(), value)

    def invalidate(self, key: K) -> None:
        self._data.pop(key, None)

    def flush(self) -> None:
        self._data.clear()

    def __len__(self) -> int:
        now = self.clock.now()
        return sum(1 for ts, _ in self._data.values() if now - ts <= self.ttl)


class UnavailableOfferings:
    """ICE blacklist with TTL + seqnum (unavailableofferings.go:45-61)."""

    def __init__(self, clock: Optional[Clock] = None, ttl: float = UNAVAILABLE_OFFERINGS_TTL) -> None:
        self.clock = clock or Clock()
        self.ttl = ttl
        self.seqnum = 0
        self._entries: Dict[Tuple[str, str, str], float] = {}  # key -> expiry

    @staticmethod
    def _key(instance_type: str, zone: str, capacity_type: str) -> Tuple[str, str, str]:
        return (instance_type, zone, capacity_type)

    def mark_unavailable(self, instance_type: str, zone: str, capacity_type: str) -> None:
        self._entries[self._key(instance_type, zone, capacity_type)] = (
            self.clock.now() + self.ttl
        )
        self.seqnum += 1

    def is_unavailable(self, instance_type: str, zone: str, capacity_type: str) -> bool:
        key = self._key(instance_type, zone, capacity_type)
        expiry = self._entries.get(key)
        if expiry is None:
            return False
        if self.clock.now() > expiry:
            del self._entries[key]
            self.seqnum += 1
            return False
        return True

    def as_set(self) -> Set[Tuple[str, str, str]]:
        """Snapshot for tensorize(unavailable=...) — expired entries pruned."""
        now = self.clock.now()
        expired = [k for k, exp in self._entries.items() if now > exp]
        for k in expired:
            del self._entries[k]
        if expired:
            self.seqnum += 1
        return set(self._entries)
