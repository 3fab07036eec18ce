"""Admission — defaulting + validation for API objects.

The knative webhook analog (pkg/webhooks/webhooks.go + the *_validation.go
files; ~357 LoC of provider validation).  Every Provisioner / NodeTemplate /
Settings mutation passes through ``admit_*`` before reaching cluster state.

Rule provenance:
- provider_validation.go:64-84   — launch-template override mutual exclusions
- provider_validation.go:86-128  — subnet/security-group selectors: required,
  non-empty entries, id-shape regexes
- provider_validation.go:131-141 — empty tag keys unsupported
- provider_validation.go:143-186 — metadata options enums + hop-limit bounds
- provider_validation.go:188-193 — image-family enum
- provider_validation.go:203-255 — block devices: device name, volume-type
  enum, size bounds [1 GiB, 64 TiB]
- awsnodetemplate_validation.go:60-102 — userData/amiSelector vs launch
  template, custom family requires a selector, image-id shape
- v1alpha5 provisioner rules     — restricted label domains, taint shape,
  duplicate taints, weight bounds, non-negative limits, label syntax
"""

from __future__ import annotations

import re
from typing import List

from .cloud.templates import NodeTemplate
from .models.provisioner import Provisioner
from .settings import Settings

SUPPORTED_IMAGE_FAMILIES = ("standard", "toml", "custom")
SUPPORTED_VOLUME_TYPES = ("gp2", "gp3", "io1", "io2", "st1", "sc1", "standard")
SUPPORTED_HTTP_TOKENS = ("required", "optional")
SUPPORTED_HTTP_ENDPOINT = ("enabled", "disabled")
MIN_VOLUME_GIB = 1.0
MAX_VOLUME_GIB = 64.0 * 1024.0  # 64 TiB (provider_validation.go:40-41)

_SUBNET_ID = re.compile(r"^subnet-[0-9a-z]+$")
_SG_ID = re.compile(r"^sg-[0-9a-z]+$")
_IMG_ID = re.compile(r"^img-[0-9a-z][0-9a-z-]*$")
_LABEL_VALUE = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9._-]{0,61}[A-Za-z0-9])?$|^$")
_QUALIFIED_NAME = re.compile(
    r"^([a-z0-9]([a-z0-9.-]*[a-z0-9])?/)?[A-Za-z0-9]([A-Za-z0-9._-]{0,61}[A-Za-z0-9])?$"
)


class AdmissionError(ValueError):
    def __init__(self, kind: str, name: str, errors: List[str]) -> None:
        self.kind = kind
        self.name = name
        self.errors = errors
        super().__init__(f"{kind}/{name} rejected: " + "; ".join(errors))


# ---------------------------------------------------------------------------
# provisioner
# ---------------------------------------------------------------------------


def validate_provisioner_spec(prov: Provisioner) -> List[str]:
    errs = list(prov.validate())  # restricted domains, taint shape, weight
    if prov.consolidation_enabled and prov.ttl_seconds_after_empty is not None:
        errs.append("consolidation.enabled and ttlSecondsAfterEmpty are mutually exclusive")
    if prov.ttl_seconds_after_empty is not None and prov.ttl_seconds_after_empty < 0:
        errs.append("ttlSecondsAfterEmpty must be non-negative")
    if prov.ttl_seconds_until_expired is not None and prov.ttl_seconds_until_expired <= 0:
        errs.append("ttlSecondsUntilExpired must be positive")
    for rname, v in prov.limits.items():
        if v < 0:
            errs.append(f"limits[{rname!r}] must be non-negative, got {v}")
    seen_taints = set()
    for t in prov.taints:
        key = (t.key, t.effect)
        if key in seen_taints:
            errs.append(f"duplicate taint {t.key!r} with effect {t.effect!r}")
        seen_taints.add(key)
    for k, v in prov.labels.items():
        if not _QUALIFIED_NAME.match(k):
            errs.append(f"label key {k!r} is not a qualified name")
        if not _LABEL_VALUE.match(v):
            errs.append(f"label value {v!r} for {k!r} is not a valid label value")
    for r in prov.requirements:
        if not r.key:
            errs.append("requirement with empty key")
    return errs


def admit_provisioner(prov: Provisioner, *, apply_defaults: bool = True) -> Provisioner:
    out = prov.with_defaults() if apply_defaults else prov
    # validate the defaulted object — the one that will actually be admitted —
    # so defects introduced (or cured) by defaulting are judged correctly,
    # matching the knative default-then-validate order
    errs = validate_provisioner_spec(out)
    if errs:
        raise AdmissionError("Provisioner", prov.name, errs)
    return out


# ---------------------------------------------------------------------------
# node template
# ---------------------------------------------------------------------------


def _validate_selector(errs: List[str], selector, path: str, id_regex, id_kind: str) -> None:
    for k, v in selector.items():
        if not k or not v:
            errs.append(f"{path} entries must have non-empty key and value")
        elif k in ("id", "ids"):
            for one in str(v).split(","):
                if not id_regex.match(one.strip()):
                    errs.append(f"{path}[{k!r}]: {one.strip()!r} is not a valid {id_kind}")


def validate_node_template_spec(t: NodeTemplate) -> List[str]:
    errs: List[str] = []

    # launch-template override excludes everything it would replace
    lt = getattr(t, "launch_template_name", None)
    if lt is not None:
        for fieldname, present in (
            ("security_group_selector", bool(t.security_group_selector)),
            ("image_selector", bool(t.image_selector)),
            ("user_data", bool(t.user_data)),
            ("instance_profile", bool(t.instance_profile)),
            ("block_devices", bool(t.block_devices)),
        ):
            if present:
                errs.append(f"launch_template_name and {fieldname} are mutually exclusive")

    # subnets: always required
    if not t.subnet_selector:
        errs.append("subnet_selector is required")
    _validate_selector(errs, t.subnet_selector, "subnet_selector", _SUBNET_ID, "subnet id")

    # security groups: required unless a launch template supplies them
    if lt is None and not t.security_group_selector:
        errs.append("security_group_selector is required")
    _validate_selector(
        errs, t.security_group_selector, "security_group_selector", _SG_ID, "security-group id"
    )

    for k in t.tags:
        if not k:
            errs.append("empty tag keys aren't supported")

    # metadata options
    if t.metadata_http_tokens not in SUPPORTED_HTTP_TOKENS:
        errs.append(
            f"metadata_http_tokens {t.metadata_http_tokens!r} not in {SUPPORTED_HTTP_TOKENS}"
        )
    endpoint = getattr(t, "metadata_http_endpoint", "enabled")
    if endpoint not in SUPPORTED_HTTP_ENDPOINT:
        errs.append(f"metadata_http_endpoint {endpoint!r} not in {SUPPORTED_HTTP_ENDPOINT}")
    if not (1 <= t.metadata_hop_limit <= 64):
        errs.append(f"metadata_hop_limit {t.metadata_hop_limit} outside [1, 64]")

    # image family + selector
    if t.image_family not in SUPPORTED_IMAGE_FAMILIES:
        errs.append(f"image_family {t.image_family!r} not in {SUPPORTED_IMAGE_FAMILIES}")
    if t.image_family == "custom" and not t.image_selector:
        errs.append("custom image family requires an image selector")
    _validate_selector(errs, t.image_selector, "image_selector", _IMG_ID, "image id")

    # block devices
    for i, bd in enumerate(t.block_devices):
        if not bd.device_name:
            errs.append(f"block_devices[{i}]: device_name is required")
        if bd.volume_type not in SUPPORTED_VOLUME_TYPES:
            errs.append(
                f"block_devices[{i}]: volume_type {bd.volume_type!r} not in {SUPPORTED_VOLUME_TYPES}"
            )
        if not (MIN_VOLUME_GIB <= bd.size_gib <= MAX_VOLUME_GIB):
            errs.append(
                f"block_devices[{i}]: size {bd.size_gib}Gi outside "
                f"[{MIN_VOLUME_GIB:g}Gi, {MAX_VOLUME_GIB:g}Gi]"
            )
    return errs


def admit_node_template(t: NodeTemplate) -> NodeTemplate:
    errs = validate_node_template_spec(t)
    if errs:
        raise AdmissionError("NodeTemplate", t.name, errs)
    return t


def admit_settings(s: Settings) -> Settings:
    errs = s.validate()
    if errs:
        raise AdmissionError("Settings", "global", errs)
    return s
