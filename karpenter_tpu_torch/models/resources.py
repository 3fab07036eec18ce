"""Resource-list arithmetic.

The reference does this with k8s ``v1.ResourceList`` + helper math
(karpenter-core ``resources`` utils, used at
upstream karpenter pkg/cloudprovider/instancetype.go:133-232).  We model a
resource list as a plain ``dict[str, float]`` in base units (see
utils/quantity.py) and keep the math free-standing so the tensorize layer can
lower lists directly into dense f32 rows over a resource vocabulary.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

from ..utils.quantity import parse_quantity

ResourceList = Dict[str, float]


def parse_resource_list(raw: Mapping[str, "str | int | float"]) -> ResourceList:
    return {k: parse_quantity(v) for k, v in raw.items()}


def add(*lists: Mapping[str, float]) -> ResourceList:
    out: ResourceList = {}
    for lst in lists:
        for k, v in lst.items():
            out[k] = out.get(k, 0.0) + v
    return out


def subtract(a: Mapping[str, float], b: Mapping[str, float]) -> ResourceList:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) - v
    return out


def merge_max(*lists: Mapping[str, float]) -> ResourceList:
    out: ResourceList = {}
    for lst in lists:
        for k, v in lst.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def fits(requests: Mapping[str, float], available: Mapping[str, float]) -> bool:
    """True if ``requests`` fits in ``available`` (missing resource == 0)."""
    return all(v <= available.get(k, 0.0) + 1e-9 for k, v in requests.items() if v > 0)


def positive(lst: Mapping[str, float]) -> ResourceList:
    return {k: max(0.0, v) for k, v in lst.items()}


def any_exceeds(requests: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """True if any resource in ``requests`` exceeds the (sparse) ``limits``."""
    return any(k in limits and v > limits[k] + 1e-9 for k, v in requests.items())


def keys(*lists: Mapping[str, float]) -> Iterable[str]:
    seen = []
    for lst in lists:
        for k in lst:
            if k not in seen:
                seen.append(k)
    return seen
