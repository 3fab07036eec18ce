"""Well-known label keys and values.

Mirrors the label surface the reference exposes on every instance type
(upstream karpenter pkg/cloudprovider/instancetype.go:67-122) plus the karpenter
domain labels (pkg/apis/v1alpha5 + v1alpha1).  The TPU solver treats all of
these uniformly through the vocab interning layer; nothing here is special at
solve time except ZONE / CAPACITY_TYPE / HOSTNAME, which form the topology
domain axes.
"""

# Well-known upstream (kubernetes.io)
INSTANCE_TYPE = "node.kubernetes.io/instance-type"
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"
ZONE = "topology.kubernetes.io/zone"
REGION = "topology.kubernetes.io/region"
HOSTNAME = "kubernetes.io/hostname"

# Well-known to karpenter
CAPACITY_TYPE = "karpenter.sh/capacity-type"
PROVISIONER_NAME = "karpenter.sh/provisioner-name"
DO_NOT_EVICT = "karpenter.sh/do-not-evict"          # annotation in the reference
DO_NOT_CONSOLIDATE = "karpenter.sh/do-not-consolidate"  # annotation
EMPTINESS_TIMESTAMP = "karpenter.sh/emptiness-timestamp"
VOLUNTARY_DISRUPTION = "karpenter.sh/voluntary-disruption"

# Well-known to the cloud layer (aws-analogous instance attribute labels,
# instancetype.go:76-95)
INSTANCE_CPU = "karpenter.k8s.tpu/instance-cpu"
INSTANCE_MEMORY = "karpenter.k8s.tpu/instance-memory"
INSTANCE_NETWORK_BANDWIDTH = "karpenter.k8s.tpu/instance-network-bandwidth"
INSTANCE_PODS = "karpenter.k8s.tpu/instance-pods"
INSTANCE_CATEGORY = "karpenter.k8s.tpu/instance-category"
INSTANCE_FAMILY = "karpenter.k8s.tpu/instance-family"
INSTANCE_GENERATION = "karpenter.k8s.tpu/instance-generation"
INSTANCE_SIZE = "karpenter.k8s.tpu/instance-size"
INSTANCE_LOCAL_NVME = "karpenter.k8s.tpu/instance-local-nvme"
INSTANCE_GPU_NAME = "karpenter.k8s.tpu/instance-gpu-name"
INSTANCE_GPU_MANUFACTURER = "karpenter.k8s.tpu/instance-gpu-manufacturer"
INSTANCE_GPU_COUNT = "karpenter.k8s.tpu/instance-gpu-count"
INSTANCE_GPU_MEMORY = "karpenter.k8s.tpu/instance-gpu-memory"
INSTANCE_HYPERVISOR = "karpenter.k8s.tpu/instance-hypervisor"
INSTANCE_ENCRYPTION_IN_TRANSIT = "karpenter.k8s.tpu/instance-encryption-in-transit-supported"

# Capacity types (v1alpha5)
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"

# Architectures / OS
ARCH_AMD64 = "amd64"
ARCH_ARM64 = "arm64"
OS_LINUX = "linux"

# Resource names
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"
RESOURCE_PODS = "pods"
RESOURCE_GPU = "nvidia.com/gpu"
RESOURCE_POD_ENI = "vpc.amazonaws.com/pod-eni"

# Taint effects
EFFECT_NO_SCHEDULE = "NoSchedule"
EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
EFFECT_NO_EXECUTE = "NoExecute"

# Restricted label domains a provisioner may not set arbitrarily
# (v1alpha5 provisioner validation semantics)
RESTRICTED_DOMAINS = ("kubernetes.io", "k8s.io", "karpenter.sh")
ALLOWED_IN_RESTRICTED = {
    INSTANCE_TYPE, ARCH, OS, ZONE, REGION, HOSTNAME, CAPACITY_TYPE,
}
