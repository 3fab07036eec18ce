"""Declarative config: YAML manifests -> admission -> API objects: the
port of the reference package's ``manifests.py``.

The reference is configured almost entirely through YAML — CRD instances
(`pkg/apis/crds/karpenter.sh_provisioners.yaml:37-315`,
`charts/karpenter-crd/`) and the `karpenter-global-settings` ConfigMap.
This module is the framework's ingestion path for the same three kinds:

- ``Provisioner``      (karpenter.sh/v1alpha5-shaped spec)
- ``NodeTemplate``     (the AWSNodeTemplate analog, provider spec)
- ``ConfigMap``        (karpenter-global-settings data)

Every parsed object passes through the admission layer (``webhooks.py``)
before it reaches cluster state — invalid documents are rejected with the
structured admission errors, exactly like the reference's validating
webhooks (`pkg/webhooks/webhooks.go:33-63`).

The port's difference: PyYAML is imported where a document is parsed
(``load_documents``, ``parse_settings``), not at module import, so the
operator imports and runs on a host without PyYAML as long as no
``--config`` is given.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from dataclasses import replace

from .cloud.templates import BlockDevice, NodeTemplate
from .models import labels as L  # noqa: F401  (manifest docs reference labels)
from .models.pod import Taint
from .models.provisioner import KubeletConfiguration, Provisioner
from .models.requirements import Requirement
from .models.volume import (
    VOLUME_BINDING_IMMEDIATE,
    PersistentVolume,
    PersistentVolumeClaim,
    StorageClass,
    parse_zone_topology,
)
from .settings import Settings
from .utils.quantity import parse_quantity
from .webhooks import (
    AdmissionError,
    admit_node_template,
    admit_provisioner,
    admit_settings,
)

_DURATION_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ms|s|m|h)?\s*$")
_DURATION_SCALE = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, None: 1.0}


def parse_duration(value) -> float:
    """'10s' / '500ms' / '9.5m' / bare numbers -> seconds."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _DURATION_RE.match(str(value))
    if not m:
        raise ValueError(f"invalid duration: {value!r}")
    return float(m.group(1)) * _DURATION_SCALE[m.group(2)]


def _parse_bool(value) -> bool:
    if isinstance(value, bool):
        return value
    return str(value).strip().lower() in ("1", "true", "yes", "on")


# ---------------------------------------------------------------------------
# provisioner (karpenter.sh_provisioners.yaml spec shape)
# ---------------------------------------------------------------------------


def parse_provisioner(doc: dict) -> Provisioner:
    meta = doc.get("metadata", {}) or {}
    spec = doc.get("spec", {}) or {}
    reqs = [
        Requirement(r["key"], r["operator"], list(r.get("values", [])))
        for r in spec.get("requirements", []) or []
    ]
    taints = [
        Taint(t.get("key", ""), t.get("effect", ""), t.get("value", ""))
        for t in spec.get("taints", []) or []
    ]
    startup = [
        Taint(t.get("key", ""), t.get("effect", ""), t.get("value", ""))
        for t in spec.get("startupTaints", []) or []
    ]
    limits = {
        k: parse_quantity(v)
        for k, v in ((spec.get("limits", {}) or {}).get("resources", {}) or {}).items()
    }
    consolidation = spec.get("consolidation", {}) or {}
    provider_ref = spec.get("providerRef", {}) or {}
    kc_doc = spec.get("kubeletConfiguration")
    kubelet = _parse_kubelet(kc_doc) if kc_doc else None
    return Provisioner(
        name=meta.get("name", "default"),
        requirements=reqs,
        taints=taints,
        startup_taints=startup,
        labels=dict(spec.get("labels", {}) or {}),
        limits=limits,
        weight=int(spec.get("weight", 0) or 0),
        consolidation_enabled=_parse_bool(consolidation.get("enabled", False)),
        ttl_seconds_after_empty=(
            float(spec["ttlSecondsAfterEmpty"])
            if spec.get("ttlSecondsAfterEmpty") is not None else None
        ),
        ttl_seconds_until_expired=(
            float(spec["ttlSecondsUntilExpired"])
            if spec.get("ttlSecondsUntilExpired") is not None else None
        ),
        node_template=provider_ref.get("name", "default"),
        kubelet=kubelet,
    )


def _parse_kubelet(doc: dict) -> KubeletConfiguration:
    """spec.kubeletConfiguration (karpenter.sh_provisioners.yaml:56-135):
    reserved maps are resource quantities, eviction signals stay strings
    (percentage-or-quantity is resolved against each node's capacity at
    instance-type specialization time), grace periods are durations."""
    return KubeletConfiguration(
        max_pods=int(doc["maxPods"]) if doc.get("maxPods") is not None else None,
        pods_per_core=(
            int(doc["podsPerCore"]) if doc.get("podsPerCore") is not None else None
        ),
        system_reserved={
            k: parse_quantity(v) for k, v in (doc.get("systemReserved") or {}).items()
        },
        kube_reserved={
            k: parse_quantity(v) for k, v in (doc.get("kubeReserved") or {}).items()
        },
        eviction_hard=dict(doc.get("evictionHard") or {}),
        eviction_soft=dict(doc.get("evictionSoft") or {}),
        eviction_soft_grace_period={
            k: parse_duration(v)
            for k, v in (doc.get("evictionSoftGracePeriod") or {}).items()
        },
        eviction_max_pod_grace_period=(
            int(doc["evictionMaxPodGracePeriod"])
            if doc.get("evictionMaxPodGracePeriod") is not None else None
        ),
        cluster_dns=tuple(doc.get("clusterDNS") or ()),
        container_runtime=doc.get("containerRuntime"),
    )


# ---------------------------------------------------------------------------
# storage objects (PV topology inputs — scheduling.md:378-433)
# ---------------------------------------------------------------------------


def parse_storage_class(doc: dict) -> StorageClass:
    meta = doc.get("metadata", {}) or {}
    exprs = []
    for topo in doc.get("allowedTopologies", []) or []:
        exprs.extend(topo.get("matchLabelExpressions", []) or [])
    zones, errors = parse_zone_topology(exprs)
    if errors:
        raise AdmissionError("StorageClass", meta.get("name", "?"), errors)
    return StorageClass(
        name=meta.get("name", "default"),
        provisioner=doc.get("provisioner", "ebs.csi.tpu"),
        volume_binding_mode=doc.get("volumeBindingMode", VOLUME_BINDING_IMMEDIATE),
        allowed_zones=zones,
    )


def parse_persistent_volume(doc: dict) -> PersistentVolume:
    meta = doc.get("metadata", {}) or {}
    spec = doc.get("spec", {}) or {}
    exprs = []
    required = ((spec.get("nodeAffinity", {}) or {}).get("required", {}) or {})
    for term in required.get("nodeSelectorTerms", []) or []:
        exprs.extend(term.get("matchExpressions", []) or [])
    zones, errors = parse_zone_topology(exprs)
    if errors:
        raise AdmissionError("PersistentVolume", meta.get("name", "?"), errors)
    storage = (spec.get("capacity", {}) or {}).get("storage", 0)
    return PersistentVolume(
        name=meta.get("name", "?"),
        zones=zones,
        storage_class=spec.get("storageClassName", ""),
        capacity=parse_quantity(storage) if storage else 0.0,
    )


def parse_persistent_volume_claim(doc: dict) -> PersistentVolumeClaim:
    meta = doc.get("metadata", {}) or {}
    spec = doc.get("spec", {}) or {}
    requested = (((spec.get("resources", {}) or {}).get("requests", {}) or {})
                 .get("storage", 0))
    return PersistentVolumeClaim(
        name=meta.get("name", "?"),
        namespace=meta.get("namespace", "default"),
        storage_class=spec.get("storageClassName", ""),
        volume_name=spec.get("volumeName", ""),
        requested=parse_quantity(requested) if requested else 0.0,
    )


# ---------------------------------------------------------------------------
# node template (AWSNodeTemplate analog spec shape)
# ---------------------------------------------------------------------------


def parse_node_template(doc: dict) -> NodeTemplate:
    meta = doc.get("metadata", {}) or {}
    spec = doc.get("spec", {}) or {}
    md = spec.get("metadataOptions", {}) or {}
    devices = [
        BlockDevice(
            device_name=d.get("deviceName", "/dev/xvda"),
            size_gib=(
                parse_quantity(d["sizeGiB"]) if "sizeGiB" in d
                else parse_quantity(d.get("volumeSize", "20Gi")) / 1024.0**3
            ),
            volume_type=d.get("volumeType", "gp3"),
            encrypted=_parse_bool(d.get("encrypted", True)),
        )
        for d in spec.get("blockDevices", []) or []
    ]
    return NodeTemplate(
        name=meta.get("name", "default"),
        image_family=spec.get("imageFamily", "standard"),
        image_selector=dict(spec.get("imageSelector", {}) or {}),
        subnet_selector=dict(spec.get("subnetSelector", {}) or {}),
        security_group_selector=dict(spec.get("securityGroupSelector", {}) or {}),
        user_data=spec.get("userData", "") or "",
        instance_profile=spec.get("instanceProfile", "") or "",
        block_devices=devices,
        launch_template_name=spec.get("launchTemplateName"),
        metadata_http_tokens=md.get("httpTokens", "required"),
        metadata_http_endpoint=md.get("httpEndpoint", "enabled"),
        metadata_hop_limit=int(md.get("httpPutResponseHopLimit", 2)),
        tags=dict(spec.get("tags", {}) or {}),
        detailed_monitoring=_parse_bool(spec.get("detailedMonitoring", False)),
    )


# ---------------------------------------------------------------------------
# global-settings ConfigMap (settings.go:40-65 data keys)
# ---------------------------------------------------------------------------

#: data key -> (Settings field, parser)
_SETTINGS_KEYS = {
    "clusterName": ("cluster_name", str),
    "clusterEndpoint": ("cluster_endpoint", str),
    "defaultInstanceProfile": ("default_instance_profile", str),
    "vmMemoryOverheadPercent": ("vm_memory_overhead_percent", float),
    "enablePodENI": ("enable_pod_eni", _parse_bool),
    "enableENILimitedPodDensity": ("enable_eni_limited_pod_density", _parse_bool),
    "isolatedVPC": ("isolated_vpc", _parse_bool),
    "nodeNameConvention": ("node_name_convention", str),
    "interruptionQueueName": ("interruption_queue_name", str),
    "batchMaxDuration": ("batch_max_duration", parse_duration),
    "batchIdleDuration": ("batch_idle_duration", parse_duration),
    "featureGates.driftEnabled": ("drift_enabled", _parse_bool),
    "deprovisioningTTL": ("deprovisioning_ttl", parse_duration),
}


def parse_settings(doc: dict) -> Dict[str, object]:
    """ConfigMap data -> Settings field overrides (unknown keys rejected so
    config typos fail loudly instead of silently doing nothing)."""
    data = doc.get("data", {}) or {}
    out: Dict[str, object] = {}
    unknown = []
    for k, v in data.items():
        if k == "tags" or k.startswith("tags."):
            tags = out.setdefault("tags", {})
            if k == "tags":
                import yaml

                tags.update(yaml.safe_load(v) or {})
            else:
                tags[k.split(".", 1)[1]] = str(v)
            continue
        ent = _SETTINGS_KEYS.get(k)
        if ent is None:
            unknown.append(k)
            continue
        field_name, parser = ent
        out[field_name] = parser(v)
    if unknown:
        raise AdmissionError(
            "ConfigMap", doc.get("metadata", {}).get("name", "settings"),
            [f"unknown settings key {k!r}" for k in sorted(unknown)],
        )
    return out


# ---------------------------------------------------------------------------
# loading + admission
# ---------------------------------------------------------------------------


def load_documents(path) -> List[dict]:
    """All YAML documents under ``path`` (a file, or a directory scanned for
    *.yaml/*.yml in sorted order; multi-document files supported).  Missing
    paths and empty directories are config errors (AdmissionError), not
    silent successes."""
    import yaml

    p = Path(path)
    if not p.exists():
        raise AdmissionError("Manifest", str(p), ["path does not exist"])
    files = (
        sorted(list(p.glob("*.yaml")) + list(p.glob("*.yml")))
        if p.is_dir() else [p]
    )
    if not files:
        raise AdmissionError("Manifest", str(p), ["no *.yaml/*.yml files found"])
    docs: List[dict] = []
    for f in files:
        try:
            for doc in yaml.safe_load_all(f.read_text()):
                if doc:
                    docs.append(doc)
        except (OSError, yaml.YAMLError) as err:
            raise AdmissionError("Manifest", str(f), [f"unreadable: {err}"])
    return docs


def admit_documents(
    docs: Iterable[dict],
    current_settings: Optional[Settings] = None,
) -> Tuple[List[Provisioner], List[NodeTemplate], Dict[str, object], List[object]]:
    """Parse + ADMIT every recognized document; raises AdmissionError on the
    first invalid one.  Unrecognized kinds are skipped (a manifest dir may
    carry Deployments/RBAC alongside the karpenter objects).  Settings
    overrides are judged against ``current_settings`` (the LIVE settings of
    the operator the docs will apply to — a partial override is valid or
    invalid only relative to the values it leaves in place)."""
    provisioners: List[Provisioner] = []
    templates: List[NodeTemplate] = []
    settings: Dict[str, object] = {}
    storage: List[object] = []  # StorageClass | PersistentVolume | PVC
    for doc in docs:
        kind = str(doc.get("kind", ""))
        name = str((doc.get("metadata", {}) or {}).get("name", "?"))
        try:
            if kind == "Provisioner":
                prov = parse_provisioner(doc)
                admit_provisioner(prov)  # default-then-validate; raises
                # store the RAW spec (state.apply_provisioner's convention;
                # controllers call with_defaults() at use time)
                provisioners.append(prov)
            elif kind in ("NodeTemplate", "AWSNodeTemplate"):
                templates.append(admit_node_template(parse_node_template(doc)))
            elif (kind == "ConfigMap" and name == "karpenter-global-settings"):
                settings.update(parse_settings(doc))
            elif kind == "StorageClass":
                storage.append(parse_storage_class(doc))
            elif kind == "PersistentVolume":
                storage.append(parse_persistent_volume(doc))
            elif kind == "PersistentVolumeClaim":
                storage.append(parse_persistent_volume_claim(doc))
        except AdmissionError:
            raise
        except (ValueError, KeyError, TypeError, AttributeError) as err:
            # malformed-but-parseable specs deny with structure, they do not
            # crash the ingestion path (bad quantities, missing requirement
            # keys, non-numeric TTLs, ...)
            raise AdmissionError(kind or "?", name, [f"malformed spec: {err!r}"])
    if settings:
        # judged against the live baseline (apply_objects re-validates under
        # the operator's lock right before mutating)
        admit_settings(replace(current_settings or Settings(), **settings))
    return provisioners, templates, settings, storage


def apply_objects(
    provisioners: List[Provisioner],
    templates: List[NodeTemplate],
    overrides: Dict[str, object],
    storage: List[object] = (),
    *,
    state=None,
    cloud=None,
    settings_store=None,
) -> None:
    """Apply admitted objects to a running operator — the SINGLE apply
    sequence shared by apply_path and the HTTP /admission/apply endpoint.
    Validates the settings against the LIVE store first, so an invalid
    combination denies before any provisioner/template is committed."""
    if settings_store is not None and overrides:
        admit_settings(replace(settings_store.current, **overrides))
    if state is not None:
        for prov in provisioners:
            state.apply_provisioner(prov)
        state.apply_storage_batch(storage)
    if cloud is not None and hasattr(cloud, "templates"):
        for t in templates:
            cloud.templates[t.name] = t
    if settings_store is not None and overrides:
        settings_store.update(**overrides)


def apply_path(path, *, state=None, cloud=None, settings_store=None):
    """Load manifests from ``path`` and apply the admitted objects to a
    running operator's state/cloud/settings.  Returns the admitted tuple."""
    provisioners, templates, overrides, storage = admit_documents(
        load_documents(path),
        current_settings=settings_store.current if settings_store else None,
    )
    apply_objects(provisioners, templates, overrides, storage,
                  state=state, cloud=cloud, settings_store=settings_store)
    return provisioners, templates, overrides, storage
