"""Observability of the port: per-solve span tracing and the black-box
flight recorder.

- :mod:`.trace` — ``Tracer`` / ``Trace`` / ``Span``: one span tree per
  solve or per consolidation evaluation, near-zero-cost when sampling is
  off (``KT_TRACE=0``).
- :mod:`.recorder` — ``FlightRecorder``: bounded ring of recent traces,
  events and counter deltas, dumped on anomalies.
- :mod:`.timeseries` — the background registry sampler: bounded
  per-series ring buffers answering windowed rate / percentile queries
  (off by knob → falsy ``NULL_SAMPLER``).
- :mod:`.slo` — per-priority-class objectives evaluated as multi-window
  burn rates with error-budget accounting; the ``/sloz`` document.
- :mod:`.occupancy` — device-busy share (device-solve spans, an upper bound),
  megabatch slot occupancy and delta inline fraction.
- :mod:`.protocol` — the session-protocol conformance tap.
- :mod:`.export` — the ``/tracez`` / ``/statusz`` documents and the
  sidecar's observability HTTP server (``/sloz``, ``/tunez``,
  ``/fleetz``, ``/metrics`` too).
- :mod:`.fleet` — the ``/fleetz`` fan-out over ``KT_OBS_PEERS`` and its
  merge of replicas, sessions and cross-replica trace trees.
- :mod:`.replay` — the trace-replay harness: capture, synthesize and
  replay traffic through a real solver endpoint, with its fidelity check.

Process-default singletons
mirror ``metrics.registry``: components accept an injected ``Tracer``;
those constructed bare share :func:`default_tracer` (whose traces land in
:func:`default_flight`), and those handed a private ``Registry`` get a
tracer of their own from :func:`tracer_for`.
"""

from __future__ import annotations

import threading
from typing import Optional

from .occupancy import OccupancyAccountant
from .recorder import FlightRecorder
from .slo import SloEngine, merge_sloz
from .timeseries import NULL_SAMPLER, NullSampler, Sampler, sampler_for
from .trace import NULL_SPAN, NULL_TRACE, Span, Trace, Tracer, replica_id

__all__ = [
    "FlightRecorder", "NULL_SAMPLER", "NULL_SPAN", "NULL_TRACE",
    "NullSampler", "OccupancyAccountant", "Sampler", "SloEngine", "Span",
    "Trace", "Tracer", "default_flight", "default_tracer", "merge_sloz",
    "replica_id", "sampler_for", "tracer_for",
]

# RLock: default_tracer() resolves default_flight() while holding it
_defaults_lock = threading.RLock()
_default_flight: Optional[FlightRecorder] = None
_default_tracer: Optional[Tracer] = None


def default_flight() -> FlightRecorder:
    """The process-default flight recorder (lazy; global metrics registry)."""
    global _default_flight
    with _defaults_lock:
        if _default_flight is None:
            _default_flight = FlightRecorder()
        return _default_flight


def default_tracer() -> Tracer:
    """The process-default tracer, reporting into :func:`default_flight`."""
    global _default_tracer
    with _defaults_lock:
        if _default_tracer is None:
            _default_tracer = Tracer(flight=default_flight())
        return _default_tracer


def tracer_for(registry, clock=None) -> Tracer:
    """Default tracer for a component handed ``registry`` but no tracer.

    Metric ownership must follow the registry: a component constructed over
    a private Registry (tests, per-scenario controllers) must emit its trace
    metrics THERE, not onto the process globals — so it gets a
    registry-local tracer + flight recorder, on the component's injected
    ``clock`` so FakeClock-driven traces keep ONE time base.  Only the
    global registry maps to the shared process singletons (whose clock is
    necessarily the wall clock).
    """
    from .. import metrics

    if registry is None or registry is metrics.registry:
        return default_tracer()
    return Tracer(clock=clock, registry=registry,
                  flight=FlightRecorder(clock=clock, registry=registry))
