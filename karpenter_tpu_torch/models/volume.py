"""Persistent-volume topology — storage-aware zone constraints.

Mirrors the reference's volume topology detection
(website/content/en/preview/concepts/scheduling.md:378-433): the scheduler
follows Pod -> PersistentVolumeClaim -> {bound PersistentVolume |
StorageClass} and folds the storage's zonal reach into the pod's scheduling
requirements *before* the solve:

- a claim **bound** to a PV pins the pod to the PV's zone(s) (the PV's
  node-affinity rule);
- an **unbound** claim whose StorageClass uses ``WaitForFirstConsumer``
  constrains the pod to the class's ``allowedTopologies`` zones (the CSI
  driver will then create the volume wherever the pod lands);
- an unbound claim with ``Immediate`` binding adds nothing (the volume binds
  independently of pod placement; once bound, the PV pins future pods).

CSI drivers use their own zone label keys (``topology.ebs.csi.aws.com/zone``);
like the reference we alias them to ``topology.kubernetes.io/zone`` in memory.
``topology.kubernetes.io/region`` is explicitly unsupported (scheduling.md's
legacy in-tree CSI note) and reported as an injection error.

The output of resolution is plain zone ``Requirement``s on the pod
(``PodSpec.volume_zone_requirements``), so every tier — oracle, device
solver, native tier — honors volume topology through the ordinary zone
eligibility machinery with no solver-side special casing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import labels as L
from .pod import PodSpec
from .requirements import IN, Requirement

# zone label keys we alias to the canonical topology.kubernetes.io/zone
ZONE_KEY_ALIASES = (
    L.ZONE,
    "topology.ebs.csi.aws.com/zone",
    "topology.gke.io/zone",
    "failure-domain.beta.kubernetes.io/zone",
)
REGION_KEY = "topology.kubernetes.io/region"

VOLUME_BINDING_IMMEDIATE = "Immediate"
VOLUME_BINDING_WAIT = "WaitForFirstConsumer"


@dataclass(frozen=True)
class StorageClass:
    name: str
    provisioner: str = "ebs.csi.tpu"
    volume_binding_mode: str = VOLUME_BINDING_IMMEDIATE
    # zones from allowedTopologies matchLabelExpressions (zone-aliased keys
    # only); empty tuple = no topology restriction
    allowed_zones: Tuple[str, ...] = ()


@dataclass(frozen=True)
class PersistentVolume:
    """The solver-facing slice of a PV: its zonal node-affinity reach."""

    name: str
    zones: Tuple[str, ...] = ()  # from spec.nodeAffinity; empty = zone-free (e.g. EFS)
    storage_class: str = ""
    capacity: float = 0.0  # bytes


@dataclass
class PersistentVolumeClaim:
    name: str
    namespace: str = "default"
    storage_class: str = ""
    volume_name: str = ""  # bound PV name; "" = unbound
    requested: float = 0.0  # bytes


class VolumeTopology:
    """Registry of PVCs/PVs/StorageClasses + the requirement injector.

    The reference injects volume-derived node affinity into each pending pod
    inside the provisioning reconcile (scheduling.md:378-390 "Karpenter
    follows references from the Pod to PersistentVolumeClaim to
    StorageClass"); ``inject`` is that step.
    """

    def __init__(self) -> None:
        self.claims: Dict[Tuple[str, str], PersistentVolumeClaim] = {}
        self.volumes: Dict[str, PersistentVolume] = {}
        self.classes: Dict[str, StorageClass] = {}

    # ---- registry ------------------------------------------------------
    def apply_claim(self, pvc: PersistentVolumeClaim) -> None:
        self.claims[(pvc.namespace, pvc.name)] = pvc

    def apply_volume(self, pv: PersistentVolume) -> None:
        self.volumes[pv.name] = pv

    def apply_class(self, sc: StorageClass) -> None:
        self.classes[sc.name] = sc

    def bind(self, namespace: str, claim_name: str, pv: PersistentVolume) -> None:
        """Simulate the CSI driver creating + binding a volume (the
        WaitForFirstConsumer aftermath: later pods using this claim are
        pinned to the volume's zone)."""
        self.apply_volume(pv)
        pvc = self.claims.get((namespace, claim_name))
        if pvc is not None:
            pvc.volume_name = pv.name

    # ---- resolution ----------------------------------------------------
    def zones_for_claim(
        self, namespace: str, claim_name: str
    ) -> Tuple[Optional[Tuple[str, ...]], Optional[str]]:
        """(zones, error): zones is None for "no constraint", a tuple for a
        zonal restriction; error is a human-readable injection failure (claim
        missing, bound PV missing)."""
        pvc = self.claims.get((namespace, claim_name))
        if pvc is None:
            return None, f"persistentvolumeclaim {namespace}/{claim_name} not found"
        if pvc.volume_name:
            pv = self.volumes.get(pvc.volume_name)
            if pv is None:
                return None, (
                    f"persistentvolumeclaim {namespace}/{claim_name} bound to "
                    f"missing volume {pvc.volume_name}")
            return (pv.zones or None), None
        sc = self.classes.get(pvc.storage_class)
        if sc is None:
            # unbound + no known class: nothing to constrain on
            return None, None
        if sc.volume_binding_mode == VOLUME_BINDING_WAIT and sc.allowed_zones:
            return tuple(sc.allowed_zones), None
        return None, None

    def requirements_for(self, pod: PodSpec) -> Tuple[List[Requirement], List[str]]:
        """All volume-derived zone requirements for a pod (ANDed — a pod with
        two zonal claims must land where both volumes live)."""
        reqs: List[Requirement] = []
        errors: List[str] = []
        for claim in pod.volume_claims:
            zones, err = self.zones_for_claim(pod.namespace, claim)
            if err:
                errors.append(err)
                continue
            if zones:
                reqs.append(Requirement(L.ZONE, IN, sorted(zones)))
        return reqs, errors

    def inject(self, pod: PodSpec) -> List[str]:
        """Resolve and stamp the pod's volume_zone_requirements in place
        (idempotent — recomputed from the registry each call, so a claim that
        bound since the last reconcile re-pins the pod).  Returns errors; a
        pod with errors should stay pending (the reference retries it next
        reconcile rather than scheduling it storage-blind)."""
        if not pod.volume_claims:
            return []
        reqs, errors = self.requirements_for(pod)
        if reqs != pod.volume_zone_requirements:
            pod.volume_zone_requirements = reqs
            pod.__dict__.pop("_group_key", None)  # constraints changed
        return errors


def parse_zone_topology(match_label_expressions: Sequence[dict]) -> Tuple[Tuple[str, ...], List[str]]:
    """allowedTopologies / PV nodeAffinity expressions -> (zones, errors),
    with CSI zone-key aliasing and the explicit region-key rejection.

    Only ``In`` (the operator CSI drivers write, and the only shape
    StorageClass allowedTopologies can express) is supported on zone keys;
    any other operator is an error rather than a silent mis-pin — treating
    ``NotIn [z]`` as a pin TO z would schedule pods exactly where their
    volume can never attach."""
    zones: List[str] = []
    errors: List[str] = []
    for expr in match_label_expressions:
        key = expr.get("key", "")
        op = expr.get("operator", "In")
        if key in ZONE_KEY_ALIASES:
            if op != "In":
                errors.append(
                    f"unsupported operator {op!r} on zone topology key {key!r} "
                    "(only In is supported)")
                continue
            zones.extend(expr.get("values", []) or [])
        elif key == REGION_KEY:
            errors.append(
                "topology.kubernetes.io/region is not supported; use a zonal "
                "out-of-tree CSI provider (scheduling.md:430-433)")
        # other keys (hostname-scoped local volumes etc.) are ignored
    return tuple(dict.fromkeys(zones)), errors
