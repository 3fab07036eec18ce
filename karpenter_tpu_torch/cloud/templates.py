"""Node templates, image-family resolution, userdata bootstrap, and the
launch-template cache.

Re-creates the reference's L2 launch stack in provider-neutral form:

- ``NodeTemplate`` — the AWSNodeTemplate CRD analog
  (pkg/apis/v1alpha1/awsnodetemplate.go): image family + selectors, userdata,
  block devices, metadata options, tags; status carries discovered
  subnets/security-groups (filled by the nodetemplate controller).
- image families — strategy interface like amifamily/resolver.go:72-79:
  per-family default image aliases (SSM-alias analog), bootstrap script
  generation (MIME-merge for the eks-like family per
  bootstrap/eksbootstrap.go:165-263, TOML for the bottlerocket-like family),
  and per-(arch, accelerator) image variants (al2.go:37-45).
- ``LaunchTemplateProvider`` — one cached launch template per resolved
  (image, userdata, ...) hash with create-on-miss, eviction-deletes, and
  invalidate-on-not-found (launchtemplate.go:130-136, 291-305, 120-128).
"""

from __future__ import annotations

import base64
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..models import labels as L
from ..models.instancetype import InstanceType
from ..models.pod import Taint

# ---------------------------------------------------------------------------
# image families
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Image:
    image_id: str
    arch: str
    accelerated: bool = False
    created_at: float = 0.0
    family: str = "standard"


class ImageFamily:
    """Strategy interface (amifamily/resolver.go AMIFamily analog)."""

    name = "base"

    def default_images(self) -> List[Image]:
        raise NotImplementedError

    def bootstrap_script(
        self,
        cluster_name: str,
        labels: Dict[str, str],
        taints: Sequence[Taint],
        kubelet_flags: Dict[str, str],
        custom_userdata: str = "",
        cluster_endpoint: str = "",
    ) -> str:
        raise NotImplementedError


class StandardFamily(ImageFamily):
    """eks/AL2-like: shell bootstrap merged with custom userdata via MIME
    multipart (eksbootstrap.go:165-263 semantics)."""

    name = "standard"

    def default_images(self) -> List[Image]:
        return [
            Image("img-standard-amd64", L.ARCH_AMD64, created_at=2.0, family="standard"),
            Image("img-standard-arm64", L.ARCH_ARM64, created_at=2.0, family="standard"),
            Image("img-standard-gpu", L.ARCH_AMD64, accelerated=True, created_at=2.0, family="standard"),
        ]

    def bootstrap_script(self, cluster_name, labels, taints, kubelet_flags,
                         custom_userdata="", cluster_endpoint="") -> str:
        label_arg = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        taint_arg = ",".join(f"{t.key}={t.value}:{t.effect}" for t in taints)
        flags = " ".join(f"--{k}={v}" for k, v in sorted(kubelet_flags.items()))
        endpoint_arg = (
            f" --apiserver-endpoint '{cluster_endpoint}'" if cluster_endpoint else ""
        )
        script = (
            "#!/bin/bash\n"
            f"/etc/node/bootstrap.sh '{cluster_name}'{endpoint_arg} "
            f"--kubelet-extra-args '--node-labels={label_arg} "
            f"--register-with-taints={taint_arg} {flags}'\n"
        )
        if not custom_userdata:
            return script
        # MIME multipart merge: custom part first, bootstrap last
        boundary = "//"
        return (
            f'MIME-Version: 1.0\nContent-Type: multipart/mixed; boundary="{boundary}"\n\n'
            f"--{boundary}\nContent-Type: text/x-shellscript; charset=\"us-ascii\"\n\n"
            f"{custom_userdata}\n"
            f"--{boundary}\nContent-Type: text/x-shellscript; charset=\"us-ascii\"\n\n"
            f"{script}\n--{boundary}--\n"
        )


class TomlFamily(ImageFamily):
    """bottlerocket-like: structured TOML config; custom userdata must itself
    be TOML and is merged key-wise (bottlerocketsettings.go semantics)."""

    name = "toml"

    def default_images(self) -> List[Image]:
        return [
            Image("img-toml-amd64", L.ARCH_AMD64, created_at=1.0, family="toml"),
            Image("img-toml-arm64", L.ARCH_ARM64, created_at=1.0, family="toml"),
        ]

    def bootstrap_script(self, cluster_name, labels, taints, kubelet_flags,
                         custom_userdata="", cluster_endpoint="") -> str:
        lines = ["[settings.kubernetes]", f'cluster-name = "{cluster_name}"']
        if cluster_endpoint:
            lines.append(f'api-server = "{cluster_endpoint}"')
        if custom_userdata:
            lines.append(custom_userdata.strip())
        lines.append("[settings.kubernetes.node-labels]")
        for k, v in sorted(labels.items()):
            lines.append(f'"{k}" = "{v}"')
        if taints:
            lines.append("[settings.kubernetes.node-taints]")
            for t in taints:
                lines.append(f'"{t.key}" = "{t.value}:{t.effect}"')
        return "\n".join(lines) + "\n"


class CustomFamily(ImageFamily):
    """Pass-through userdata; requires explicit image selectors
    (amifamily/custom.go)."""

    name = "custom"

    def default_images(self) -> List[Image]:
        return []

    def bootstrap_script(self, cluster_name, labels, taints, kubelet_flags,
                         custom_userdata="", cluster_endpoint="") -> str:
        return custom_userdata


_FAMILIES = {f.name: f for f in (StandardFamily(), TomlFamily(), CustomFamily())}


def get_family(name: str) -> ImageFamily:
    """resolver.go:143-154 GetAMIFamily analog (defaults to standard)."""
    return _FAMILIES.get(name, _FAMILIES["standard"])


# ---------------------------------------------------------------------------
# node template
# ---------------------------------------------------------------------------


@dataclass
class BlockDevice:
    device_name: str = "/dev/xvda"
    size_gib: float = 20.0
    volume_type: str = "gp3"
    encrypted: bool = True


@dataclass
class NodeTemplate:
    """AWSNodeTemplate analog: how to build nodes for a provisioner."""

    name: str = "default"
    image_family: str = "standard"
    image_selector: Dict[str, str] = field(default_factory=dict)  # tag/id selectors
    subnet_selector: Dict[str, str] = field(default_factory=dict)
    security_group_selector: Dict[str, str] = field(default_factory=dict)
    user_data: str = ""
    instance_profile: str = ""
    block_devices: List[BlockDevice] = field(default_factory=list)
    # pre-built launch template override; excludes the fields it replaces
    # (provider_validation.go:64-84)
    launch_template_name: Optional[str] = None
    metadata_http_tokens: str = "required"
    metadata_http_endpoint: str = "enabled"
    metadata_hop_limit: int = 2
    tags: Dict[str, str] = field(default_factory=dict)
    detailed_monitoring: bool = False
    # status (filled by the nodetemplate controller)
    status_subnets: List[str] = field(default_factory=list)
    status_security_groups: List[str] = field(default_factory=list)
    status_images: List[Image] = field(default_factory=list)

    def validate(self) -> List[str]:
        """Full spec validation; single source of truth lives in
        webhooks.validate_node_template_spec."""
        from ..webhooks import validate_node_template_spec

        return validate_node_template_spec(self)


# ---------------------------------------------------------------------------
# image resolution
# ---------------------------------------------------------------------------


def resolve_images(
    template: NodeTemplate,
    available_images: Sequence[Image] = (),
) -> List[Image]:
    """Selector-based discovery (ami.go:158-230) or family-alias defaults
    (ami.go:135-149), newest-first (ami.go:232-241).

    The alias path has SSM semantics: it returns only the *current* image per
    (arch, accelerated) variant — when a newer image is published into the
    pool, older ones drop out of the resolved set, which is exactly what the
    drift check keys off (cloudprovider.go:258-287)."""
    family = get_family(template.image_family)
    if template.image_selector:
        ids = {
            one.strip()
            for k, v in template.image_selector.items()
            if k in ("id", "ids")
            for one in str(v).split(",")
        }
        pool = list(available_images) or family.default_images()
        picked = [i for i in pool if not ids or i.image_id in ids]
    else:
        pool = [i for i in available_images if i.family == family.name]
        if not pool:
            pool = family.default_images()
        newest: Dict[Tuple[str, bool], Image] = {}
        for img in pool:
            key = (img.arch, img.accelerated)
            cur = newest.get(key)
            if cur is None or img.created_at > cur.created_at:
                newest[key] = img
        picked = list(newest.values())
    return sorted(picked, key=lambda i: (-i.created_at, i.image_id))


def images_for_instance_type(images: Sequence[Image], it: InstanceType) -> List[Image]:
    """All resolved images mapping to this type's arch/accelerator variant
    (ami.go:99-133 MapInstanceTypes analog).  The drift check tests membership
    of the instance's image in this set (cloudprovider.go:258-287)."""
    arch = it.labels().get(L.ARCH, L.ARCH_AMD64)
    accelerated = L.RESOURCE_GPU in it.capacity
    exact = [i for i in images if i.arch == arch and i.accelerated == accelerated]
    if exact:
        return exact
    return [i for i in images if i.arch == arch]  # fall back on arch alone


def image_for_instance_type(images: Sequence[Image], it: InstanceType) -> Optional[Image]:
    """Pick the (newest) image matching the type's arch/accelerator."""
    mapped = images_for_instance_type(images, it)
    return mapped[0] if mapped else None


# ---------------------------------------------------------------------------
# launch templates
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LaunchTemplate:
    name: str
    image_id: str
    user_data_b64: str
    instance_profile: str
    security_groups: Tuple[str, ...]
    tags: Tuple[Tuple[str, str], ...]


class LaunchTemplateProvider:
    """Hash-keyed ensure-exists cache (launchtemplate.go:54-317)."""

    def __init__(
        self,
        cluster_name: str = "sim",
        max_templates: int = 256,
        cluster_endpoint: str = "",
        default_instance_profile: str = "",
    ) -> None:
        self.cluster_name = cluster_name
        self.cluster_endpoint = cluster_endpoint          # settings.go:44
        self.default_instance_profile = default_instance_profile  # settings.go:46
        self.max_templates = max_templates
        self._cache: Dict[str, LaunchTemplate] = {}
        self.created: List[str] = []
        self.deleted: List[str] = []

    @staticmethod
    def _hash(*parts: str) -> str:
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]

    def ensure(
        self,
        template: NodeTemplate,
        image: Image,
        labels: Dict[str, str],
        taints: Sequence[Taint],
        kubelet_flags: Optional[Dict[str, str]] = None,
    ) -> LaunchTemplate:
        family = get_family(template.image_family)
        userdata = family.bootstrap_script(
            self.cluster_name, labels, taints, kubelet_flags or {},
            template.user_data, cluster_endpoint=self.cluster_endpoint,
        )
        # the template's own profile wins; the settings-wide default fills
        # the gap (settings.go defaultInstanceProfile semantics)
        profile = template.instance_profile or self.default_instance_profile
        key = self._hash(
            image.image_id, userdata, profile,
            ",".join(sorted(template.status_security_groups)),
            str(sorted(template.tags.items())),
        )
        got = self._cache.get(key)
        if got is not None:
            return got
        lt = LaunchTemplate(
            name=f"karpenter.k8s.tpu/{key}",
            image_id=image.image_id,
            user_data_b64=base64.b64encode(userdata.encode()).decode(),
            instance_profile=profile,
            security_groups=tuple(sorted(template.status_security_groups)),
            tags=tuple(sorted(template.tags.items())),
        )
        if len(self._cache) >= self.max_templates:
            # evict-deletes (launchtemplate.go:291-305)
            evict_key = next(iter(self._cache))
            self.deleted.append(self._cache.pop(evict_key).name)
        self._cache[key] = lt
        self.created.append(lt.name)
        return lt

    def invalidate(self, name: str) -> None:
        """Drop a template reported not-found by the cloud
        (launchtemplate.go:120-128); next ensure() recreates it."""
        for key, lt in list(self._cache.items()):
            if lt.name == name:
                del self._cache[key]

    def hydrate(self, existing: Sequence[LaunchTemplate]) -> None:
        """Warm the cache from the cloud on leadership (launchtemplate.go:272-289)."""
        for lt in existing:
            key = lt.name.rsplit("/", 1)[-1]
            self._cache.setdefault(key, lt)

    def __len__(self) -> int:
        return len(self._cache)
