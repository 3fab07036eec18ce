"""Cloud error taxonomy (pkg/errors/errors.go:31-79 analog).

Classifies provider errors so controllers react correctly: not-found is
swallowed on delete paths, unfulfillable-capacity feeds the ICE cache, and
everything else propagates.
"""

from __future__ import annotations

from .cloud.base import (
    CloudProviderError,
    InsufficientCapacityError,
    MachineNotFoundError,
)

# unfulfillable-capacity classes beyond plain ICE (errors.go:40-46)
UNFULFILLABLE_REASONS = (
    "InsufficientInstanceCapacity",
    "MaxSpotInstanceCountExceeded",
    "VcpuLimitExceeded",
    "UnfulfillableCapacity",
    "Unsupported",
)


def is_not_found(err: Exception) -> bool:
    return isinstance(err, MachineNotFoundError)


def is_unfulfillable_capacity(err: Exception) -> bool:
    if isinstance(err, InsufficientCapacityError):
        return True
    return any(r in str(err) for r in UNFULFILLABLE_REASONS)


def ignore_not_found(err: Exception) -> None:
    """Re-raise unless it's a not-found (the lo.Must/IgnoreNotFound idiom)."""
    if not is_not_found(err):
        raise err
