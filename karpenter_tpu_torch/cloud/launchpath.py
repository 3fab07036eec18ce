"""Launch-path instance-type selection — the reference's Create pipeline.

Mirrors pkg/cloudprovider/instance.go's launch path semantics:

- exotic-type filtering (GPU/accelerator/metal types dropped when generic
  types suffice) — instance.go:505-529 filterExoticInstanceTypes
- unwanted-spot filtering on mixed-capacity launches (spot types whose
  cheapest offering beats no on-demand option) — instance.go:481-503
- price ordering by cheapest requirement-satisfying offering —
  instance.go:421-438 orderInstanceTypesByPrice
- truncation to MAX_INSTANCE_TYPES (60) — cloudprovider.go:64-67, applied
  instance.go:85-87
- capacity-type choice: spot iff a spot offering is reachable —
  instance.go:405-419 getCapacityType
- on-demand-fallback flexibility warning below 5 types —
  instance.go:52,261-281 checkODFallback

The TPU solver pins (type, zone, capacity-type) per machine, so controller
launches degenerate to a 1-type list and this pipeline is a no-op for them;
flexible machines (adoption, replacement launches, direct API users) get the
full fleet semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..models import labels as L
from ..models.instancetype import InstanceType, Offering
from ..models.machine import Machine
from ..models.requirements import Requirements

#: Max instance types handed to one fleet launch (cloudprovider.go:64-67).
MAX_INSTANCE_TYPES = 60

#: Below this many types, falling back to on-demand while flexible to spot
#: risks insufficient-capacity errors (instance.go:52).
FLEXIBILITY_THRESHOLD = 5

_EXOTIC_RESOURCES = (L.RESOURCE_GPU,)


@dataclass
class LaunchSelection:
    """Outcome of the selection pipeline, pre-launch."""

    instance_types: List[InstanceType]
    capacity_type: str
    warnings: List[str] = field(default_factory=list)


def _offerings_ok(it: InstanceType, reqs: Requirements) -> List[Offering]:
    """Available offerings of ``it`` satisfying the machine requirements."""
    zone_req = reqs.get(L.ZONE)
    ct_req = reqs.get(L.CAPACITY_TYPE)
    return [
        o for o in it.offerings
        if o.available and zone_req.contains(o.zone) and ct_req.contains(o.capacity_type)
    ]


def _cheapest(it: InstanceType, reqs: Requirements) -> float:
    offs = _offerings_ok(it, reqs)
    return min((o.price for o in offs), default=float("inf"))


def filter_exotic(instance_types: Sequence[InstanceType]) -> List[InstanceType]:
    """Drop GPU/accelerator/metal types when generic types remain
    (instance.go:505-529): a flexible request should not land on an
    expensive accelerator node just because one fits."""
    generic = []
    for it in instance_types:
        if "metal" in it.requirements.get(L.INSTANCE_SIZE).values:
            continue
        if any(it.capacity.get(r, 0.0) > 0 for r in _EXOTIC_RESOURCES):
            continue
        generic.append(it)
    return generic if generic else list(instance_types)


def is_mixed_capacity_launch(
    reqs: Requirements, instance_types: Sequence[InstanceType]
) -> bool:
    """Both spot and on-demand could launch (instance.go:455-479)."""
    ct_req = reqs.get(L.CAPACITY_TYPE)
    if not (ct_req.contains(L.CAPACITY_TYPE_SPOT) and ct_req.contains(L.CAPACITY_TYPE_ON_DEMAND)):
        return False
    has_spot = has_od = False
    for it in instance_types:
        for o in _offerings_ok(it, reqs):
            if o.capacity_type == L.CAPACITY_TYPE_SPOT:
                has_spot = True
            else:
                has_od = True
    return has_spot and has_od


def filter_unwanted_spot(
    instance_types: Sequence[InstanceType], reqs: Requirements
) -> List[InstanceType]:
    """Drop types whose cheapest offering is pricier than the cheapest
    on-demand type that would work (instance.go:481-503): prevents a large
    expensive spot instance beating a small sufficient on-demand one."""
    cheapest_od = float("inf")
    for it in instance_types:
        for o in _offerings_ok(it, reqs):
            if o.capacity_type == L.CAPACITY_TYPE_ON_DEMAND and o.price < cheapest_od:
                cheapest_od = o.price
    out = []
    for it in instance_types:
        price = _cheapest(it, reqs)
        if price != float("inf") and price <= cheapest_od:
            out.append(it)
    return out


def order_by_price(
    instance_types: Sequence[InstanceType], reqs: Requirements
) -> List[InstanceType]:
    """Cheapest requirement-satisfying offering first; name tiebreak
    (instance.go:421-438)."""
    return sorted(instance_types, key=lambda it: (_cheapest(it, reqs), it.name))


def choose_capacity_type(
    reqs: Requirements, instance_types: Sequence[InstanceType]
) -> str:
    """Spot iff the requirements admit spot and a spot offering is reachable;
    on-demand otherwise (instance.go:405-419)."""
    if reqs.get(L.CAPACITY_TYPE).contains(L.CAPACITY_TYPE_SPOT):
        for it in instance_types:
            if any(o.capacity_type == L.CAPACITY_TYPE_SPOT for o in _offerings_ok(it, reqs)):
                return L.CAPACITY_TYPE_SPOT
    return L.CAPACITY_TYPE_ON_DEMAND


def select_launch_types(
    machine: Machine,
    instance_types: Sequence[InstanceType],
    max_types: int = MAX_INSTANCE_TYPES,
) -> LaunchSelection:
    """The full Create-path pipeline: requirement prefilter -> exotic filter
    -> unwanted-spot filter -> price sort -> truncate -> capacity-type choice
    -> flexibility check (instance.go:83-87 + checkODFallback)."""
    from ..models.resources import fits

    reqs = machine.requirements
    type_req = reqs.get(L.INSTANCE_TYPE)
    types = [
        it for it in instance_types
        if type_req.contains(it.name) and _offerings_ok(it, reqs)
        and fits(machine.resource_requests, it.allocatable)
    ]
    types = filter_exotic(types)
    if is_mixed_capacity_launch(reqs, types):
        types = filter_unwanted_spot(types, reqs)
    types = order_by_price(types, reqs)
    if len(types) > max_types:
        types = types[:max_types]

    capacity_type = choose_capacity_type(reqs, types)
    warnings: List[str] = []
    if (
        capacity_type == L.CAPACITY_TYPE_ON_DEMAND
        and reqs.get(L.CAPACITY_TYPE).contains(L.CAPACITY_TYPE_SPOT)
        and len(types) < FLEXIBILITY_THRESHOLD
    ):
        warnings.append(
            f"at least {FLEXIBILITY_THRESHOLD} instance types are recommended when "
            f"flexible to spot but requesting on-demand; this request has {len(types)}"
        )
    return LaunchSelection(instance_types=types, capacity_type=capacity_type,
                           warnings=warnings)
