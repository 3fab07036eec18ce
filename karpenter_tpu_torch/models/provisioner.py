"""Provisioner — per-pool provisioning policy.

Models the core Provisioner CRD
(upstream karpenter pkg/apis/crds/karpenter.sh_provisioners.yaml:37-315): layered
requirements, taints/startup taints, labels stamped on nodes, resource limits,
TTLs, consolidation flag, and weight (priority among provisioners,
scheduling.md:435-525).  AWS-overlay defaulting (linux/amd64/on-demand,
categories c,m,r gen>2 — pkg/apis/v1alpha5/provisioner.go:55-85) is applied by
``with_defaults``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

from . import labels as L
from .pod import PodSpec, Taint, Toleration
from .requirements import GT, IN, NOT_IN, Requirement, Requirements
from .resources import ResourceList


@dataclass(frozen=True)
class KubeletConfiguration:
    """Per-provisioner kubelet overrides (karpenter.sh_provisioners.yaml:56-135).

    The solver-visible fields change node capacity/allocatable the way
    upstream karpenter pkg/cloudprovider/instancetype.go:226-340 computes them:
    ``max_pods``/``pods_per_core`` override pod density, ``system_reserved``/
    ``kube_reserved`` replace the matching default reservations (lo.Assign
    semantics: override wins per-resource), and ``eviction_hard``/
    ``eviction_soft`` raise the eviction threshold (max across signals;
    percentages are of node memory capacity).  The remaining fields flow to
    bootstrap userdata only (cluster_dns, container_runtime, grace periods).
    """

    max_pods: Optional[int] = None
    pods_per_core: Optional[int] = None
    system_reserved: Mapping[str, float] = field(default_factory=dict)  # parsed quantities
    kube_reserved: Mapping[str, float] = field(default_factory=dict)
    eviction_hard: Mapping[str, str] = field(default_factory=dict)   # signal -> "5%" | "200Mi"
    eviction_soft: Mapping[str, str] = field(default_factory=dict)
    eviction_soft_grace_period: Mapping[str, float] = field(default_factory=dict)  # seconds
    eviction_max_pod_grace_period: Optional[int] = None
    cluster_dns: Tuple[str, ...] = ()
    container_runtime: Optional[str] = None

    def signature(self) -> tuple:
        """Hashable identity for memo keys (dict fields defeat dataclass hash)."""
        return (
            self.max_pods, self.pods_per_core,
            tuple(sorted(self.system_reserved.items())),
            tuple(sorted(self.kube_reserved.items())),
            tuple(sorted(self.eviction_hard.items())),
            tuple(sorted(self.eviction_soft.items())),
        )

    def affects_capacity(self) -> bool:
        """True when any field changes solver-visible capacity/allocatable."""
        return bool(
            self.max_pods is not None or self.pods_per_core
            or self.system_reserved or self.kube_reserved
            or self.eviction_hard or self.eviction_soft
        )

    def validate(self) -> List[str]:
        """Webhook rules (v1alpha5 provisioner validation: non-negative counts,
        parseable eviction signals, percentages in (0,100])."""
        errs: List[str] = []
        if self.max_pods is not None and self.max_pods <= 0:
            errs.append(f"kubeletConfiguration.maxPods {self.max_pods} must be positive")
        if self.pods_per_core is not None and self.pods_per_core <= 0:
            errs.append(f"kubeletConfiguration.podsPerCore {self.pods_per_core} must be positive")
        for fname, rl in (("systemReserved", self.system_reserved),
                          ("kubeReserved", self.kube_reserved)):
            for k, v in rl.items():
                if v < 0:
                    errs.append(f"kubeletConfiguration.{fname}[{k}] must be non-negative")
        from ..utils.quantity import parse_quantity

        for fname, sig in (("evictionHard", self.eviction_hard),
                           ("evictionSoft", self.eviction_soft)):
            for k, v in sig.items():
                if v.endswith("%"):
                    try:
                        p = float(v[:-1])
                    except ValueError:
                        errs.append(f"kubeletConfiguration.{fname}[{k}]: bad percentage {v!r}")
                        continue
                    if not (0.0 < p <= 100.0):
                        errs.append(
                            f"kubeletConfiguration.{fname}[{k}]: percentage {v!r} outside (0,100]")
                else:
                    try:
                        parse_quantity(v)
                    except ValueError:
                        errs.append(f"kubeletConfiguration.{fname}[{k}]: bad quantity {v!r}")
        for k in self.eviction_soft:
            if k not in self.eviction_soft_grace_period:
                errs.append(
                    f"kubeletConfiguration.evictionSoft[{k}] has no matching "
                    "evictionSoftGracePeriod")
        return errs

    def bootstrap_flags(self) -> Dict[str, str]:
        """kubelet CLI flags for bootstrap userdata, the way the reference
        renders kc into --kubelet-extra-args (bootstrap/eksbootstrap.go):
        reserved maps as k=v lists, eviction signals as signal<value lists."""
        from ..utils.quantity import format_quantity

        def _rl(rl: Mapping[str, float]) -> str:
            return ",".join(
                f"{k}={format_quantity(v, binary=(k == 'memory'))}"
                for k, v in sorted(rl.items())
            )

        flags: Dict[str, str] = {}
        if self.max_pods is not None:
            flags["max-pods"] = str(self.max_pods)
        if self.pods_per_core is not None:
            flags["pods-per-core"] = str(self.pods_per_core)
        if self.system_reserved:
            flags["system-reserved"] = _rl(self.system_reserved)
        if self.kube_reserved:
            flags["kube-reserved"] = _rl(self.kube_reserved)
        if self.eviction_hard:
            flags["eviction-hard"] = ",".join(
                f"{k}<{v}" for k, v in sorted(self.eviction_hard.items()))
        if self.eviction_soft:
            flags["eviction-soft"] = ",".join(
                f"{k}<{v}" for k, v in sorted(self.eviction_soft.items()))
        if self.eviction_soft_grace_period:
            flags["eviction-soft-grace-period"] = ",".join(
                f"{k}={v:g}s" for k, v in sorted(self.eviction_soft_grace_period.items()))
        if self.eviction_max_pod_grace_period is not None:
            flags["eviction-max-pod-grace-period"] = str(self.eviction_max_pod_grace_period)
        if self.cluster_dns:
            flags["cluster-dns"] = ",".join(self.cluster_dns)
        if self.container_runtime:
            flags["container-runtime"] = self.container_runtime
        return flags


@dataclass
class Provisioner:
    name: str = "default"
    requirements: List[Requirement] = field(default_factory=list)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    limits: ResourceList = field(default_factory=dict)  # sparse caps on total provisioned
    weight: int = 0  # higher tried first (scheduling.md:435-525)
    consolidation_enabled: bool = False
    ttl_seconds_after_empty: Optional[float] = None
    ttl_seconds_until_expired: Optional[float] = None
    node_template: str = "default"  # providerRef analog
    kubelet: Optional[KubeletConfiguration] = None

    def with_defaults(self) -> "Provisioner":
        """AWS-overlay defaulting (provisioner.go:55-85): OS/arch/capacity-type
        defaults plus generic instance-category defaults when the user left the
        instance dimension unconstrained."""
        reqs = {r.key for r in self.requirements}
        extra: List[Requirement] = []
        if L.OS not in reqs:
            extra.append(Requirement(L.OS, IN, [L.OS_LINUX]))
        if L.ARCH not in reqs:
            extra.append(Requirement(L.ARCH, IN, [L.ARCH_AMD64]))
        if L.CAPACITY_TYPE not in reqs:
            extra.append(Requirement(L.CAPACITY_TYPE, IN, [L.CAPACITY_TYPE_ON_DEMAND]))
        if not reqs & {L.INSTANCE_TYPE, L.INSTANCE_FAMILY, L.INSTANCE_CATEGORY}:
            extra.append(Requirement(L.INSTANCE_CATEGORY, IN, ["c", "m", "r"]))
            extra.append(Requirement(L.INSTANCE_GENERATION, GT, ["2"]))
        out = Provisioner(**self.__dict__)
        out.requirements = list(self.requirements) + extra
        out.taints = list(self.taints)
        out.startup_taints = list(self.startup_taints)
        out.labels = dict(self.labels)
        out.limits = dict(self.limits)
        return out

    def scheduling_requirements(self) -> Requirements:
        """Provisioner-level requirement layer (labels become In-requirements)."""
        reqs = Requirements(self.requirements)
        for k, v in self.labels.items():
            reqs.add(Requirement(k, IN, [v]))
        reqs.add(Requirement(L.PROVISIONER_NAME, IN, [self.name]))
        return reqs

    def tolerates(self, pod: PodSpec) -> bool:
        """Pod must tolerate every hard provisioner taint (scheduling.md:256-301).
        Startup taints are ignored for scheduling (they're removed post-boot)."""
        return not any(t.blocks(pod.tolerations) for t in self.taints)

    def validate(self) -> List[str]:
        """Static validation mirroring the v1alpha5 webhook rules."""
        errs: List[str] = []
        for k in self.labels:
            dom = k.split("/")[0] if "/" in k else ""
            if any(dom == d or dom.endswith("." + d) for d in L.RESTRICTED_DOMAINS):
                if k not in L.ALLOWED_IN_RESTRICTED:
                    errs.append(f"label {k!r} in restricted domain")
        for t in self.taints + self.startup_taints:
            if not t.key:
                errs.append("taint with empty key")
            if t.effect not in (L.EFFECT_NO_SCHEDULE, L.EFFECT_PREFER_NO_SCHEDULE, L.EFFECT_NO_EXECUTE):
                errs.append(f"taint {t.key!r}: bad effect {t.effect!r}")
        for r in self.requirements:
            dom = r.key.split("/")[0] if "/" in r.key else ""
            if any(dom == d or dom.endswith("." + d) for d in L.RESTRICTED_DOMAINS):
                if r.key not in L.ALLOWED_IN_RESTRICTED and not r.key.startswith("karpenter.k8s.tpu/"):
                    errs.append(f"requirement key {r.key!r} in restricted domain")
        if self.weight < 0 or self.weight > 100:
            errs.append(f"weight {self.weight} outside [0,100]")
        if self.kubelet is not None:
            errs.extend(self.kubelet.validate())
        return errs
