"""Gang membership helpers the ported solver path reads.

A copy of the reference package's membership helpers (``gang_enabled``,
``gang_of``, ``gang_fixed``, ``has_gangs``, ``nodes_carry_gangs``).  The all-or-nothing epilogue
itself is not ported yet: the port's ``BatchScheduler.solve`` refuses a
batch that carries gang pods instead of solving it without the epilogue.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

from ..models.pod import PodSpec


def gang_enabled() -> bool:
    """KT_GANG kill switch: default on; 0 restores pre-gang behavior."""
    return os.environ.get("KT_GANG", "1") != "0"


def gang_of(pod: PodSpec) -> str:
    """The pod's gang id, "" for ungrouped."""
    return getattr(pod, "gang_id", "") or ""


def gang_fixed(pod: PodSpec) -> bool:
    """True when the pod's seat is a fixed boundary condition (a gang
    member with the subsystem enabled)."""
    return gang_enabled() and bool(gang_of(pod))


def has_gangs(pods: Iterable[PodSpec]) -> bool:
    return any(gang_of(p) for p in pods)


def nodes_carry_gangs(nodes: Sequence) -> bool:
    """Whether any of ``nodes`` hosts a gang member — consolidation routes
    such candidates through the serial what-if, never the batched sweep."""
    if not gang_enabled():
        return False
    return any(gang_of(q) for n in nodes for q in n.pods)
