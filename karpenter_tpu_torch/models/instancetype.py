"""Instance types, offerings, and the capacity/overhead/allocatable model.

Provider-neutral types mirroring the karpenter-core ``cloudprovider`` boundary
(SURVEY.md §2.2): an ``InstanceType`` carries a requirement set (its labels as
scheduling constraints), per-(zone, capacity-type) priced ``Offering``s, raw
``capacity``, and an ``overhead`` whose components follow the reference's
kubelet-reservation model:

- system-reserved defaults 100m CPU / 100Mi mem / 1Gi storage
  (upstream karpenter pkg/cloudprovider/instancetype.go:241-252)
- kube-reserved: memory 11*pods+255 Mi; CPU via the staircase
  6%/1%/0.5%/0.25% over the first 1/1/2/rest vCPUs (instancetype.go:254-289)
- eviction threshold 100Mi memory (instancetype.go:291-324)
- VM memory overhead percent applied to raw memory (settings, default 7.5% —
  pkg/apis/settings/settings.go:48)

``allocatable = capacity - overhead`` is what the solver packs against.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Mapping, Optional, Sequence

from . import labels as L
from .requirements import IN, Requirement, Requirements
from .resources import ResourceList, add, fits, subtract

MIB = 1024.0**2
GIB = 1024.0**3


@dataclass(frozen=True)
class Offering:
    """One purchasable (zone, capacity-type) combination of an instance type.

    Mirrors core ``cloudprovider.Offering`` constructed at
    upstream karpenter pkg/cloudprovider/instancetypes.go:122-150.
    """

    zone: str
    capacity_type: str  # "spot" | "on-demand"
    price: float  # $/hr
    available: bool = True


@dataclass
class Overhead:
    """kubelet reservations; total() is what's deducted from capacity."""

    kube_reserved: ResourceList = field(default_factory=dict)
    system_reserved: ResourceList = field(default_factory=dict)
    eviction_threshold: ResourceList = field(default_factory=dict)

    def total(self) -> ResourceList:
        return add(self.kube_reserved, self.system_reserved, self.eviction_threshold)


@dataclass
class InstanceType:
    """Solver-visible instance type (core ``cloudprovider.InstanceType``)."""

    name: str
    requirements: Requirements
    offerings: List[Offering]
    capacity: ResourceList
    overhead: Overhead

    @cached_property
    def allocatable(self) -> ResourceList:
        return {k: max(0.0, v) for k, v in subtract(self.capacity, self.overhead.total()).items()}

    def available_offerings(self) -> List[Offering]:
        return [o for o in self.offerings if o.available]

    def cheapest_offering(
        self, requirements: Optional[Requirements] = None
    ) -> Optional[Offering]:
        """Cheapest available offering compatible with ``requirements``
        (zone/capacity-type), mirroring ``Offerings.Available().Requirements().Cheapest()``
        at upstream karpenter pkg/cloudprovider/instance.go:421-438."""
        best: Optional[Offering] = None
        for o in self.offerings:
            if not o.available:
                continue
            if requirements is not None:
                if not requirements.get(L.ZONE).contains(o.zone):
                    continue
                if not requirements.get(L.CAPACITY_TYPE).contains(o.capacity_type):
                    continue
            if best is None or o.price < best.price:
                best = o
        return best

    def labels(self) -> Dict[str, str]:
        """Single-valued labels this type stamps on nodes (zone/capacity-type
        resolved per-offering at launch, so excluded here)."""
        out: Dict[str, str] = {}
        for req in self.requirements.to_list():
            if req.operator == IN and len(req.values) == 1 and req.key not in (
                L.ZONE,
                L.CAPACITY_TYPE,
            ):
                out[req.key] = req.values[0]
        return out

    def fits(self, requests: ResourceList) -> bool:
        return fits(requests, self.allocatable)


# ---------------------------------------------------------------------------
# Overhead model (reference parity)
# ---------------------------------------------------------------------------

# (start_millis, end_millis, fraction) staircase for kube-reserved CPU
_KUBE_RESERVED_CPU_STAIRCASE = (
    (0, 1000, 0.06),
    (1000, 2000, 0.01),
    (2000, 4000, 0.005),
    (4000, 1 << 31, 0.0025),
)


def kube_reserved(cpu_cores: float, pod_count: float) -> ResourceList:
    """instancetype.go:254-289 semantics."""
    cpu_millis = cpu_cores * 1000.0
    reserved_millis = 0.0
    for start, end, frac in _KUBE_RESERVED_CPU_STAIRCASE:
        if cpu_millis >= start:
            span = (min(cpu_millis, end) - start)
            reserved_millis += int(span * frac)
    return {
        L.RESOURCE_CPU: reserved_millis / 1000.0,
        L.RESOURCE_MEMORY: (11.0 * pod_count + 255.0) * MIB,
        L.RESOURCE_EPHEMERAL_STORAGE: 1.0 * GIB,
    }


def system_reserved() -> ResourceList:
    return {
        L.RESOURCE_CPU: 0.1,
        L.RESOURCE_MEMORY: 100.0 * MIB,
        L.RESOURCE_EPHEMERAL_STORAGE: 1.0 * GIB,
    }


def eviction_threshold() -> ResourceList:
    return {L.RESOURCE_MEMORY: 100.0 * MIB}


def compute_overhead(cpu_cores: float, pod_count: float) -> Overhead:
    return Overhead(
        kube_reserved=kube_reserved(cpu_cores, pod_count),
        system_reserved=system_reserved(),
        eviction_threshold=eviction_threshold(),
    )


def vm_memory_overhead(raw_memory_bytes: float, percent: float = 0.075) -> float:
    """VM-level memory not visible to the OS (settings.go:48, default 7.5%)."""
    return raw_memory_bytes * (1.0 - percent)


# ---------------------------------------------------------------------------
# Per-provisioner kubeletConfiguration specialization
# ---------------------------------------------------------------------------

import math as _math

# node-pressure eviction signal the capacity model understands
MEMORY_AVAILABLE = "memory.available"


def kubelet_pod_density(default_pods: float, vcpus: float, kc) -> float:
    """Pod capacity under a kubeletConfiguration, mirroring ``pods()`` at
    upstream karpenter pkg/cloudprovider/instancetype.go:326-340: maxPods
    replaces the (ENI-limited or 110) default, then podsPerCore caps at
    podsPerCore * vCPUs, whichever is smaller."""
    count = float(kc.max_pods) if kc.max_pods is not None else float(default_pods)
    if kc.pods_per_core:
        count = min(float(kc.pods_per_core) * vcpus, count)
    return count


def eviction_override(capacity_memory_bytes: float, *signal_maps) -> Optional[float]:
    """memory.available eviction threshold across hard/soft signal maps
    (instancetype.go:291-324): per map, a percentage is ceil(capacity * p/100)
    (100% disables -> 0), a quantity parses as bytes; the override is the MAX
    across maps, and None when no map names memory.available."""
    from ..utils.quantity import parse_quantity

    best: Optional[float] = None
    for m in signal_maps:
        if not m:
            continue
        v = m.get(MEMORY_AVAILABLE)
        if v is None:
            continue
        if v.endswith("%"):
            p = float(v[:-1])
            if p == 100.0:
                p = 0.0
            got = _math.ceil(capacity_memory_bytes / 100.0 * p)
        else:
            got = parse_quantity(v)
        best = got if best is None else max(best, got)
    return best


def specialize_for_kubelet(it: InstanceType, kc) -> InstanceType:
    """Derive the per-provisioner InstanceType a kubeletConfiguration implies.

    The reference constructs instance types per-provisioner, threading kc into
    pod density, kube/system-reserved, and the eviction threshold
    (instancetype.go:50-357).  We specialize the shared catalog object
    instead: pod capacity is recomputed from the catalog's density default,
    reserved maps get lo.Assign-style per-resource overrides on top of the
    already-computed bases (which keeps AL2's ENI-limited kube-reserved
    memory semantics — UsesENILimitedMemoryOverhead — intact under a maxPods
    override), and the eviction threshold takes the max memory.available
    signal.  Returns ``it`` unchanged when kc changes nothing solver-visible.
    """
    if kc is None or not kc.affects_capacity():
        return it
    vcpus = it.capacity.get(L.RESOURCE_CPU, 0.0)
    default_pods = it.capacity.get(L.RESOURCE_PODS, 0.0)
    pods = kubelet_pod_density(default_pods, vcpus, kc)

    capacity = dict(it.capacity)
    capacity[L.RESOURCE_PODS] = pods

    kube = dict(it.overhead.kube_reserved)
    kube.update(kc.kube_reserved)
    system = dict(it.overhead.system_reserved)
    system.update(kc.system_reserved)
    evict = dict(it.overhead.eviction_threshold)
    override = eviction_override(
        capacity.get(L.RESOURCE_MEMORY, 0.0), kc.eviction_hard, kc.eviction_soft
    )
    if override is not None:
        evict[L.RESOURCE_MEMORY] = override

    reqs = Requirements([r for r in it.requirements.to_list() if r.key != L.INSTANCE_PODS])
    reqs.add(Requirement(L.INSTANCE_PODS, IN, [str(int(pods))]))
    return InstanceType(
        name=it.name,
        requirements=reqs,
        offerings=it.offerings,
        capacity=capacity,
        overhead=Overhead(kube_reserved=kube, system_reserved=system,
                          eviction_threshold=evict),
    )
