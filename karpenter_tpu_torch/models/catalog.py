"""Synthetic cloud instance-type catalog.

The reference ships a generated EC2 catalog (pkg/fake/zz_generated.describe_
instance_types.go) plus pricing tables (pkg/providers/pricing/zz_generated.
pricing.go).  We *generate* an EC2-shaped catalog deterministically instead of
copying data: families x generations x sizes with the standard category
memory ratios (c=2GiB/vCPU, m=4, r=8, x=16), a linear-in-vCPU price model with
family multipliers, ENI-limited pod density per the reference formula
(maxENI*(IPs-1)+2, instancetype.go:230-239), VM memory overhead (7.5%), and
per-zone spot pricing with deterministic jitter.

This feeds benchmarks, tests, and the fake cloud provider.  A real deployment
would swap in a live catalog via providers/pricing + the cloud layer.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from . import labels as L
from .instancetype import (
    GIB,
    InstanceType,
    Offering,
    compute_overhead,
    vm_memory_overhead,
)
from .requirements import DOES_NOT_EXIST, IN, Requirement, Requirements

DEFAULT_ZONES = ("zone-1a", "zone-1b", "zone-1c")
DEFAULT_REGION = "region-1"

# (category, memory GiB per vCPU, price $/vCPU-hr for gen-5 on-demand)
_CATEGORIES = {
    "c": (2.0, 0.0425),
    "m": (4.0, 0.048),
    "r": (8.0, 0.063),
    "t": (4.0, 0.0376),   # burstable: cheap, small sizes only
    "x": (16.0, 0.0834),
    "i": (8.0, 0.078),    # storage-optimized (local nvme)
    "g": (4.0, 0.1578),   # gpu
    "p": (8.0, 0.306),    # big gpu
}

# family suffix -> (price multiplier, arch, extra attrs)
_VARIANTS = {
    "": (1.0, L.ARCH_AMD64),
    "a": (0.90, L.ARCH_AMD64),   # AMD
    "g": (0.80, L.ARCH_ARM64),   # Graviton-like
    "d": (1.155, L.ARCH_AMD64),  # + local NVMe
    "n": (1.25, L.ARCH_AMD64),   # network-optimized
    "i": (1.05, L.ARCH_AMD64),   # newer intel
}

_SIZES = {
    # name -> vCPUs
    "medium": 1, "large": 2, "xlarge": 4, "2xlarge": 8, "4xlarge": 16,
    "8xlarge": 32, "12xlarge": 48, "16xlarge": 64, "24xlarge": 96,
}
_T_SIZES = {"micro": 2, "small": 2, "medium": 2, "large": 2, "xlarge": 4, "2xlarge": 8}
# burstable memory GiB by size (not ratio-derived)
_T_MEM = {"micro": 1.0, "small": 2.0, "medium": 4.0, "large": 8.0, "xlarge": 16.0, "2xlarge": 32.0}
_T_PRICE = {"micro": 0.0104, "small": 0.0208, "medium": 0.0416, "large": 0.0832,
            "xlarge": 0.1664, "2xlarge": 0.3328}


def _stable_unit(seed: str) -> float:
    """Deterministic uniform [0,1) from a string (replaces RNG for spot jitter)."""
    h = hashlib.sha256(seed.encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0**64


def _eni_limited_pods(vcpus: int) -> int:
    """ENI model by size tier, then the reference formula maxENI*(IPs-1)+2."""
    if vcpus <= 2:
        enis, ips = 3, 6
    elif vcpus <= 8:
        enis, ips = 4, 15
    elif vcpus <= 32:
        enis, ips = 8, 30
    else:
        enis, ips = 15, 50
    return enis * (ips - 1) + 2


@dataclass(frozen=True)
class CatalogSpec:
    zones: Sequence[str] = DEFAULT_ZONES
    region: str = DEFAULT_REGION
    generations: Sequence[int] = (3, 4, 5, 6, 7)
    vm_memory_overhead_percent: float = 0.075
    spot_discount: float = 0.62  # mean spot discount vs on-demand
    spot_jitter: float = 0.15
    # settings-driven capacity shape (settings.go:40-65; instancetype.go):
    # ENI-limited density off -> flat 110-pod default; pod-ENI on -> expose
    # the branch-interface resource.  Field names mirror Settings exactly.
    enable_eni_limited_pod_density: bool = True
    enable_pod_eni: bool = False

    @classmethod
    def from_settings(cls, s) -> "CatalogSpec":
        """Build a spec from the global Settings (the wiring an instance-type
        provider uses at catalog-construction time)."""
        return cls(
            vm_memory_overhead_percent=s.vm_memory_overhead_percent,
            enable_eni_limited_pod_density=s.enable_eni_limited_pod_density,
            enable_pod_eni=s.enable_pod_eni,
        )


DEFAULT_MAX_PODS = 110.0  # kubelet default when ENI-limited density is off


def _mk_type(
    name: str,
    category: str,
    family: str,
    generation: int,
    size: str,
    vcpus: int,
    mem_gib: float,
    arch: str,
    od_price: float,
    spec: CatalogSpec,
    gpus: int = 0,
    local_nvme_gb: int = 0,
) -> InstanceType:
    mem_bytes = vm_memory_overhead(mem_gib * GIB, spec.vm_memory_overhead_percent)
    pods = (
        float(_eni_limited_pods(vcpus))
        if spec.enable_eni_limited_pod_density
        else DEFAULT_MAX_PODS
    )
    capacity = {
        L.RESOURCE_CPU: float(vcpus),
        L.RESOURCE_MEMORY: mem_bytes,
        L.RESOURCE_EPHEMERAL_STORAGE: 20.0 * GIB if not local_nvme_gb else local_nvme_gb * GIB,
        L.RESOURCE_PODS: pods,
    }
    if spec.enable_pod_eni:
        # branch network interfaces for pod-ENI workloads (instancetype.go
        # :133-232 pod-eni resource); scale with the ENI tier
        capacity[L.RESOURCE_POD_ENI] = float(_eni_limited_pods(vcpus) // 3)
    if gpus:
        capacity[L.RESOURCE_GPU] = float(gpus)

    offerings: List[Offering] = []
    for zone in spec.zones:
        offerings.append(Offering(zone=zone, capacity_type=L.CAPACITY_TYPE_ON_DEMAND, price=od_price))
        jitter = (1.0 - spec.spot_jitter) + 2.0 * spec.spot_jitter * _stable_unit(f"{name}/{zone}")
        spot = round(od_price * spec.spot_discount * jitter, 6)
        offerings.append(Offering(zone=zone, capacity_type=L.CAPACITY_TYPE_SPOT, price=spot))

    reqs = Requirements([
        Requirement(L.INSTANCE_TYPE, IN, [name]),
        Requirement(L.ARCH, IN, [arch]),
        Requirement(L.OS, IN, [L.OS_LINUX]),
        Requirement(L.ZONE, IN, list(spec.zones)),
        Requirement(L.REGION, IN, [spec.region]),
        Requirement(L.CAPACITY_TYPE, IN, [L.CAPACITY_TYPE_SPOT, L.CAPACITY_TYPE_ON_DEMAND]),
        Requirement(L.INSTANCE_CPU, IN, [str(vcpus)]),
        Requirement(L.INSTANCE_MEMORY, IN, [str(int(mem_gib * 1024))]),  # MiB like the reference
        Requirement(L.INSTANCE_PODS, IN, [str(int(pods))]),
        Requirement(L.INSTANCE_CATEGORY, IN, [category]),
        Requirement(L.INSTANCE_FAMILY, IN, [family]),
        Requirement(L.INSTANCE_GENERATION, IN, [str(generation)]),
        Requirement(L.INSTANCE_SIZE, IN, [size]),
        Requirement(L.INSTANCE_HYPERVISOR, IN, ["nitro" if generation >= 5 else "xen"]),
    ])
    if local_nvme_gb:
        reqs.add(Requirement(L.INSTANCE_LOCAL_NVME, IN, [str(local_nvme_gb)]))
    else:
        reqs.add(Requirement(L.INSTANCE_LOCAL_NVME, DOES_NOT_EXIST))
    if gpus:
        reqs.add(Requirement(L.INSTANCE_GPU_COUNT, IN, [str(gpus)]))
        reqs.add(Requirement(L.INSTANCE_GPU_NAME, IN, ["t4" if category == "g" else "v100"]))
        reqs.add(Requirement(L.INSTANCE_GPU_MANUFACTURER, IN, ["nvidia"]))
    else:
        reqs.add(Requirement(L.INSTANCE_GPU_COUNT, DOES_NOT_EXIST))
        reqs.add(Requirement(L.INSTANCE_GPU_NAME, DOES_NOT_EXIST))

    return InstanceType(
        name=name,
        requirements=reqs,
        offerings=offerings,
        capacity=capacity,
        overhead=compute_overhead(float(vcpus), float(pods)),
    )


def generate_catalog(spec: Optional[CatalogSpec] = None, full: bool = True) -> List[InstanceType]:
    """Build the catalog. ``full=True`` ≈ the full-EC2-scale set (~650 types);
    ``full=False`` gives a small 20-type set (BASELINE config #1)."""
    spec = spec or CatalogSpec()
    out: List[InstanceType] = []

    if not full:
        for family, category, gen in (("c5", "c", 5), ("m5", "m", 5), ("r5", "r", 5), ("t3a", "t", 3)):
            sizes = _T_SIZES if category == "t" else _SIZES
            picks = ("small", "medium") if category == "t" else (
                "large", "xlarge", "2xlarge", "4xlarge", "8xlarge", "16xlarge")
            for size in picks:
                if size not in sizes:
                    continue
                out.append(_mk_family_member(family, category, gen, size, spec))
        return out

    for category, (ratio, base_price) in _CATEGORIES.items():
        if category == "t":
            for gen, variants in ((2, [""]), (3, ["", "a"]), (4, ["g"])):
                for var in variants:
                    family = f"t{gen}{var}"
                    for size in _T_SIZES:
                        out.append(_mk_family_member(family, "t", gen, size, spec))
            continue
        if category in ("g", "p"):
            gpu_families = (("g4dn", 4, "d"), ("g5", 5, ""), ("p3", 3, ""), ("p4d", 4, "d"))
            for family, gen, var in gpu_families:
                if family[0] != category:
                    continue
                for size, gpus in (("xlarge", 1), ("2xlarge", 1), ("4xlarge", 1),
                                   ("8xlarge", 4), ("16xlarge", 8)):
                    out.append(_mk_family_member(family, category, gen, size, spec, gpus=gpus))
            continue
        for gen in _gens_for(category):
            for var, (mult, arch) in _VARIANTS.items():
                if var == "i" and gen < 6:
                    continue  # "i" suffix only exists gen>=6
                if var == "g" and gen < 6:
                    continue
                if var == "" and gen >= 7:
                    continue  # gen-7 families always carry a vendor suffix
                family = f"{category}{gen}{var}"
                for size, vcpus in _SIZES.items():
                    if size == "medium" and category != "c":
                        continue
                    out.append(_mk_family_member(family, category, gen, size, spec))
    return out


def _gens_for(category: str) -> Sequence[int]:
    return {"c": (4, 5, 6, 7), "m": (4, 5, 6, 7), "r": (4, 5, 6, 7),
            "x": (1, 2), "i": (3, 4)}.get(category, (5,))


def _mk_family_member(
    family: str, category: str, gen: int, size: str, spec: CatalogSpec, gpus: int = 0
) -> InstanceType:
    var = family[len(category) + len(str(gen)):] if family[0] == category else ""
    mult, arch = _VARIANTS.get(var[:1] or "", (1.0, L.ARCH_AMD64))
    if category == "t":
        vcpus = _T_SIZES[size]
        mem_gib = _T_MEM[size]
        price = _T_PRICE[size] * (0.9 if var == "a" else 0.8 if var == "g" else 1.0)
        arch = L.ARCH_ARM64 if var == "g" else L.ARCH_AMD64
    else:
        vcpus = _SIZES[size]
        ratio, base = _CATEGORIES[category]
        mem_gib = vcpus * ratio
        # generation discount: newer gens slightly cheaper per vCPU
        gen_mult = {3: 1.10, 4: 1.05, 5: 1.0, 6: 0.96, 7: 0.965}.get(gen, 1.0)
        price = round(base * vcpus * mult * gen_mult, 6)
    name = f"{family}.{size}"
    local_nvme = vcpus * 75 if ("d" in var or category == "i") else 0
    return _mk_type(name, category, family, gen, size, vcpus, mem_gib, arch, price, spec,
                    gpus=gpus, local_nvme_gb=local_nvme)
