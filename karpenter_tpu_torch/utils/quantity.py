"""Kubernetes-style resource quantity parsing and formatting.

The reference consumes k8s ``resource.Quantity`` values everywhere (pod requests,
instance capacity, overhead math — e.g. upstream karpenter pkg/cloudprovider/instancetype.go:133-232).
We normalize every quantity to a float64 in *base units*:

- ``cpu``: cores (so "100m" == 0.1)
- ``memory`` / ``ephemeral-storage``: bytes
- counted resources (``pods``, ``nvidia.com/gpu``, ...): plain counts

Floats keep the solver tensors uniform (everything becomes an f32/f64 lane on
TPU); parity with the integer-milli representation of the reference is
maintained because all test quantities are exactly representable.
"""

from __future__ import annotations

import re

_BINARY_SUFFIX = {
    "Ki": 1024.0,
    "Mi": 1024.0**2,
    "Gi": 1024.0**3,
    "Ti": 1024.0**4,
    "Pi": 1024.0**5,
    "Ei": 1024.0**6,
}
_DECIMAL_SUFFIX = {
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "": 1.0,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}

_QUANTITY_RE = re.compile(
    r"^\s*([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*"
    r"(Ki|Mi|Gi|Ti|Pi|Ei|n|u|m|k|M|G|T|P|E)?\s*$"
)


def parse_quantity(value: "str | int | float") -> float:
    """Parse a k8s quantity string ("100m", "1.5Gi", "2") to a float in base units."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _QUANTITY_RE.match(value)
    if not m:
        raise ValueError(f"invalid quantity: {value!r}")
    num, suffix = m.group(1), m.group(2) or ""
    scale = _BINARY_SUFFIX.get(suffix) or _DECIMAL_SUFFIX[suffix]
    return float(num) * scale


def format_quantity(value: float, *, binary: bool = False) -> str:
    """Best-effort human formatting (used for logs/events only, never for math)."""
    if binary:
        for suffix in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
            scale = _BINARY_SUFFIX[suffix]
            if value >= scale and value % (scale / 1024.0) == 0:
                q = value / scale
                return f"{q:g}{suffix}"
        return f"{value:g}"
    if value == int(value):
        return str(int(value))
    milli = value * 1000.0
    if milli == int(milli):
        return f"{int(milli)}m"
    return f"{value:g}"
