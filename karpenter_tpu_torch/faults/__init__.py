"""Fault-injection plane of the port — seeded, deterministic chaos.

A copy of the reference package's ``faults`` package, its imports pointing
into the port.  The serving failure paths (a device hang latching the
guard, the degraded serve, a dispatch exception) are driven on demand,
deterministically, through the real choke points:

- :class:`FaultPlane` — a schedule of injection rules parsed from
  ``KT_FAULTS`` (default off), fired at named choke-point sites.  The port
  wires the solver's two: ``TpuSolver`` fires ``dispatch`` before every
  enqueue and ``fence`` before every device-to-host read.  Every injection
  is counted (``karpenter_faults_injected_total{kind,site}``).
- :data:`NULL_PLANE` — the zero-cost default: falsy, so hot call sites
  guard with ``if self._faults:`` and pay one truthiness check.
- :func:`count_recovery` / :func:`zero_init_recovery` — the recovery-
  outcome funnel (``karpenter_faults_recovered_total{site,outcome}``).
- :func:`jitter` — the seeded randomness source for serving-path code.
"""

from .plane import (  # noqa: F401
    FAULT_KINDS,
    FAULT_RECOVERY_OUTCOMES,
    FAULT_SITES,
    Effect,
    FaultPlane,
    InjectedFault,
    NULL_PLANE,
    NullPlane,
    count_recovery,
    faults_enabled,
    jitter,
    plane,
    zero_init_recovery,
)


def __getattr__(name):  # PEP 562: grpc-backed class resolves lazily
    if name == "InjectedRpcError":
        # importlib, not `from . import plane`: the factory function
        # `plane` above shadows the submodule name on this package
        import importlib

        return importlib.import_module(
            __name__ + ".plane").InjectedRpcError
    raise AttributeError(name)

__all__ = [
    "FAULT_KINDS", "FAULT_RECOVERY_OUTCOMES", "FAULT_SITES", "Effect",
    "FaultPlane", "InjectedFault", "InjectedRpcError", "NULL_PLANE",
    "NullPlane", "count_recovery", "faults_enabled", "jitter", "plane",
    "zero_init_recovery",
]
