"""The instance-type catalog as plain records: a frozen copy of the
generated EC2-shaped catalog the deployments run against.

Families x generations x sizes with the category memory ratios (c=2 GiB
per vCPU, m=4, r=8, x=16), a linear-in-vCPU on-demand price with family
and generation multipliers, ENI-limited pod density
(maxENI*(IPs-1)+2), 7.5% VM memory overhead, the kubelet reservations
(kube-reserved CPU staircase, 11*pods+255 MiB, system-reserved, the
100 MiB eviction threshold) and per-zone spot prices with a deterministic
jitter.  Pure Python: both the reference and the harness's adapter read
these records, so the catalog is an input the benchmark makes, never a
table the program made.
"""

from __future__ import annotations

import hashlib

GIB = 1024.0 ** 3
MIB = 1024.0 ** 2

ZONES = ("zone-1a", "zone-1b", "zone-1c")
REGION = "region-1"
VM_MEMORY_OVERHEAD = 0.075
SPOT_DISCOUNT = 0.62
SPOT_JITTER = 0.15

# label keys (the well-known keys the program's requirement algebra reads)
INSTANCE_TYPE = "node.kubernetes.io/instance-type"
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"
ZONE = "topology.kubernetes.io/zone"
REGION_KEY = "topology.kubernetes.io/region"
CAPACITY_TYPE = "karpenter.sh/capacity-type"
INSTANCE_CPU = "karpenter.k8s.tpu/instance-cpu"
INSTANCE_MEMORY = "karpenter.k8s.tpu/instance-memory"
INSTANCE_PODS = "karpenter.k8s.tpu/instance-pods"
INSTANCE_CATEGORY = "karpenter.k8s.tpu/instance-category"
INSTANCE_FAMILY = "karpenter.k8s.tpu/instance-family"
INSTANCE_GENERATION = "karpenter.k8s.tpu/instance-generation"
INSTANCE_SIZE = "karpenter.k8s.tpu/instance-size"
INSTANCE_LOCAL_NVME = "karpenter.k8s.tpu/instance-local-nvme"
INSTANCE_GPU_NAME = "karpenter.k8s.tpu/instance-gpu-name"
INSTANCE_GPU_MANUFACTURER = "karpenter.k8s.tpu/instance-gpu-manufacturer"
INSTANCE_GPU_COUNT = "karpenter.k8s.tpu/instance-gpu-count"
INSTANCE_HYPERVISOR = "karpenter.k8s.tpu/instance-hypervisor"

CPU, MEMORY, STORAGE, PODS, GPU = (
    "cpu", "memory", "ephemeral-storage", "pods", "nvidia.com/gpu")
ON_DEMAND, SPOT = "on-demand", "spot"

# category -> (memory GiB per vCPU, $/vCPU-hr for a gen-5 on-demand)
_CATEGORIES = {
    "c": (2.0, 0.0425), "m": (4.0, 0.048), "r": (8.0, 0.063),
    "t": (4.0, 0.0376), "x": (16.0, 0.0834), "i": (8.0, 0.078),
    "g": (4.0, 0.1578), "p": (8.0, 0.306),
}
# family suffix -> (price multiplier, arch)
_VARIANTS = {
    "": (1.0, "amd64"), "a": (0.90, "amd64"), "g": (0.80, "arm64"),
    "d": (1.155, "amd64"), "n": (1.25, "amd64"), "i": (1.05, "amd64"),
}
_SIZES = {
    "medium": 1, "large": 2, "xlarge": 4, "2xlarge": 8, "4xlarge": 16,
    "8xlarge": 32, "12xlarge": 48, "16xlarge": 64, "24xlarge": 96,
}
_T_SIZES = {"micro": 2, "small": 2, "medium": 2, "large": 2, "xlarge": 4,
            "2xlarge": 8}
_T_MEM = {"micro": 1.0, "small": 2.0, "medium": 4.0, "large": 8.0,
          "xlarge": 16.0, "2xlarge": 32.0}
_T_PRICE = {"micro": 0.0104, "small": 0.0208, "medium": 0.0416,
            "large": 0.0832, "xlarge": 0.1664, "2xlarge": 0.3328}
_GEN_MULT = {3: 1.10, 4: 1.05, 5: 1.0, 6: 0.96, 7: 0.965}


def _stable_unit(seed: str) -> float:
    h = hashlib.sha256(seed.encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


def _eni_pods(vcpus: int) -> int:
    if vcpus <= 2:
        enis, ips = 3, 6
    elif vcpus <= 8:
        enis, ips = 4, 15
    elif vcpus <= 32:
        enis, ips = 8, 30
    else:
        enis, ips = 15, 50
    return enis * (ips - 1) + 2


def _kube_reserved_cpu(vcpus: float) -> float:
    millis = vcpus * 1000.0
    reserved = 0.0
    for start, end, frac in ((0, 1000, 0.06), (1000, 2000, 0.01),
                             (2000, 4000, 0.005), (4000, 1 << 31, 0.0025)):
        if millis >= start:
            reserved += int((min(millis, end) - start) * frac)
    return reserved / 1000.0


def _record(name, category, family, gen, size, vcpus, mem_gib, arch,
            od_price, gpus=0, nvme_gb=0) -> dict:
    pods = float(_eni_pods(vcpus))
    capacity = {
        CPU: float(vcpus),
        MEMORY: mem_gib * GIB * (1.0 - VM_MEMORY_OVERHEAD),
        STORAGE: 20.0 * GIB if not nvme_gb else nvme_gb * GIB,
        PODS: pods,
    }
    if gpus:
        capacity[GPU] = float(gpus)
    overhead = {
        "kube_reserved": {CPU: _kube_reserved_cpu(float(vcpus)),
                          MEMORY: (11.0 * pods + 255.0) * MIB,
                          STORAGE: 1.0 * GIB},
        "system_reserved": {CPU: 0.1, MEMORY: 100.0 * MIB,
                            STORAGE: 1.0 * GIB},
        "eviction_threshold": {MEMORY: 100.0 * MIB},
    }
    offerings = []
    for zone in ZONES:
        offerings.append((zone, ON_DEMAND, od_price))
        jitter = (1.0 - SPOT_JITTER) + 2.0 * SPOT_JITTER * _stable_unit(
            f"{name}/{zone}")
        offerings.append((zone, SPOT, round(od_price * SPOT_DISCOUNT * jitter,
                                            6)))
    labels = [
        (INSTANCE_TYPE, "In", [name]), (ARCH, "In", [arch]),
        (OS, "In", ["linux"]), (ZONE, "In", list(ZONES)),
        (REGION_KEY, "In", [REGION]),
        (CAPACITY_TYPE, "In", [SPOT, ON_DEMAND]),
        (INSTANCE_CPU, "In", [str(vcpus)]),
        (INSTANCE_MEMORY, "In", [str(int(mem_gib * 1024))]),
        (INSTANCE_PODS, "In", [str(int(pods))]),
        (INSTANCE_CATEGORY, "In", [category]),
        (INSTANCE_FAMILY, "In", [family]),
        (INSTANCE_GENERATION, "In", [str(gen)]),
        (INSTANCE_SIZE, "In", [size]),
        (INSTANCE_HYPERVISOR, "In", ["nitro" if gen >= 5 else "xen"]),
    ]
    labels.append((INSTANCE_LOCAL_NVME, "In", [str(nvme_gb)]) if nvme_gb
                  else (INSTANCE_LOCAL_NVME, "DoesNotExist", []))
    if gpus:
        labels += [(INSTANCE_GPU_COUNT, "In", [str(gpus)]),
                   (INSTANCE_GPU_NAME, "In",
                    ["t4" if category == "g" else "v100"]),
                   (INSTANCE_GPU_MANUFACTURER, "In", ["nvidia"])]
    else:
        labels += [(INSTANCE_GPU_COUNT, "DoesNotExist", []),
                   (INSTANCE_GPU_NAME, "DoesNotExist", [])]
    allocatable = dict(capacity)
    for part in overhead.values():
        for k, v in part.items():
            allocatable[k] = allocatable.get(k, 0.0) - v
    allocatable = {k: max(0.0, v) for k, v in allocatable.items()}
    return {
        "name": name, "category": category, "family": family,
        "generation": gen, "size": size, "vcpus": vcpus, "arch": arch,
        "os": "linux", "capacity": capacity, "overhead": overhead,
        "allocatable": allocatable, "offerings": offerings,
        "requirements": labels,
    }


def _member(family, category, gen, size, gpus=0) -> dict:
    var = family[len(category) + len(str(gen)):] if family[0] == category \
        else ""
    mult, arch = _VARIANTS.get(var[:1] or "", (1.0, "amd64"))
    if category == "t":
        vcpus = _T_SIZES[size]
        mem_gib = _T_MEM[size]
        price = _T_PRICE[size] * (0.9 if var == "a" else
                                  0.8 if var == "g" else 1.0)
        arch = "arm64" if var == "g" else "amd64"
    else:
        vcpus = _SIZES[size]
        ratio, base = _CATEGORIES[category]
        mem_gib = vcpus * ratio
        price = round(base * vcpus * mult * _GEN_MULT.get(gen, 1.0), 6)
    nvme = vcpus * 75 if ("d" in var or category == "i") else 0
    return _record(f"{family}.{size}", category, family, gen, size, vcpus,
                   mem_gib, arch, price, gpus=gpus, nvme_gb=nvme)


def generate(full: bool = True) -> list:
    """The catalog's records: ``full`` is the ~650-type set, else the
    20-type set of BASELINE config 1."""
    out = []
    if not full:
        for family, category, gen in (("c5", "c", 5), ("m5", "m", 5),
                                      ("r5", "r", 5), ("t3a", "t", 3)):
            sizes = _T_SIZES if category == "t" else _SIZES
            picks = (("small", "medium") if category == "t" else
                     ("large", "xlarge", "2xlarge", "4xlarge", "8xlarge",
                      "16xlarge"))
            out += [_member(family, category, gen, s) for s in picks
                    if s in sizes]
        return out
    for category in _CATEGORIES:
        if category == "t":
            for gen, variants in ((2, [""]), (3, ["", "a"]), (4, ["g"])):
                for var in variants:
                    out += [_member(f"t{gen}{var}", "t", gen, s)
                            for s in _T_SIZES]
            continue
        if category in ("g", "p"):
            for family, gen in (("g4dn", 4), ("g5", 5), ("p3", 3),
                                ("p4d", 4)):
                if family[0] != category:
                    continue
                for size, gpus in (("xlarge", 1), ("2xlarge", 1),
                                   ("4xlarge", 1), ("8xlarge", 4),
                                   ("16xlarge", 8)):
                    out.append(_member(family, category, gen, size, gpus))
            continue
        gens = {"c": (4, 5, 6, 7), "m": (4, 5, 6, 7), "r": (4, 5, 6, 7),
                "x": (1, 2), "i": (3, 4)}.get(category, (5,))
        for gen in gens:
            for var in _VARIANTS:
                if var in ("i", "g") and gen < 6:
                    continue
                if var == "" and gen >= 7:
                    continue
                for size in _SIZES:
                    if size == "medium" and category != "c":
                        continue
                    out.append(_member(f"{category}{gen}{var}", category,
                                       gen, size))
    return out


def allowed(record: dict, provisioner: dict) -> bool:
    """Whether the provisioner's requirements admit the type: each
    requirement is ``[key, op, values]`` over the type's own attributes
    (``arch``, ``os``, ``category``, ``generation``)."""
    for key, op, values in provisioner["requirements"]:
        have = str(record[key])
        if op == "In" and have not in values:
            return False
        if op == "Gt" and not int(have) > int(values[0]):
            return False
    return True
