"""Device-occupancy accounting: the port of the reference package's
``obs/occupancy.py``.

"Is the fleet under- or over-provisioned?" becomes three queryable
gauges, refreshed once per sampler tick and therefore recorded as series
by the same tick that publishes them:

- ``karpenter_occupancy_device_busy_share`` — the share of wall time
  inside device-solve spans (``dispatch`` / ``fence``) over the last
  interval, on every device.  The accountant subscribes to the tracer's
  finished-trace stream (a :meth:`Tracer.add_sink` sink) and sums those
  spans' durations; with trace sampling on (``KT_TRACE_SAMPLE_EVERY`` >
  1) each sampled trace stands for ``sample_every`` solves, so the sum is
  scaled back up.
- ``karpenter_occupancy_megabatch_slot_fill`` — mean occupied slots per
  dispatched megabatch over the interval, from windowed deltas of the
  existing ``karpenter_solver_megabatch_slots`` histogram sum/count
  (slot capacity is a dynamic power-of-two rung, so the absolute
  occupancy is the honest number — compare against --max-slots).
- ``karpenter_occupancy_delta_inline_fraction`` — the share of delta
  steps served inline on the RPC thread (the idle-pipeline shortcut);
  high values mean the dispatcher is idle enough that session traffic
  never queues — a strong over-provisioning signal, and the inverse of
  device_busy's under-provisioning one.

The device-busy share is an UPPER BOUND on the device's occupancy, not
the kernels' share of the wall: the spans hold the host's enqueue (the
group loop makes its launches from Python, and on a launch-bound loop
the card idles for most of that time) as well as the wait for the
device.  The kernels' own share comes from a profiler (the benchmark's
traced runs read it).  A CUDA-event pair around a dispatch does not
measure it either: on a launch-bound loop the events span the enqueue,
not the kernels.
"""

from __future__ import annotations

import threading
from typing import Optional

from .. import metrics as M
from ..utils.clock import Clock

#: span names whose duration counts as device busy time.  "dispatch"
#: wraps the backend call (device_dispatch etc. are its children —
#: counting those too would double-book) and "fence" is the wait for
#: device results on the pipelined path.
DEVICE_SPANS = ("dispatch", "fence")

class OccupancyAccountant:
    """Tracer sink + sampler hook pair.

    ``on_trace`` runs on whatever thread closes a trace (RPC or
    dispatcher) and only accumulates scalars under ``_lock``;
    ``tick(now)`` runs on the sampler thread, deltas the accumulators
    against the previous tick, and publishes the three gauges.
    """

    def __init__(self, registry, clock: Optional[Clock] = None,
                 sample_every: int = 1) -> None:
        self.registry = registry
        self.clock = clock or Clock()
        self.sample_every = max(1, int(sample_every))
        self._lock = threading.Lock()
        self._device_s = 0.0     # guarded-by: _lock
        self._deltas = 0         # guarded-by: _lock
        self._inline = 0         # guarded-by: _lock
        # previous tick's (t, device_s, slot_sum, slot_count, deltas,
        # inline) for the windowed differences
        self._last = None
        for name in (M.OCCUPANCY_DEVICE_BUSY, M.OCCUPANCY_SLOT_FILL,
                     M.OCCUPANCY_DELTA_INLINE):
            g = registry.gauge(name)
            if not g.has():
                g.set(0.0)

    # ---- tracer sink (solve-path threads) ----------------------------

    def on_trace(self, trace) -> None:
        """Accumulate one finished trace's device time and delta/inline
        markers.  Never raises usefully — the tracer guards sinks."""
        device_s = 0.0
        is_delta = False
        inline = False
        for sp in trace.spans():
            if sp.name in DEVICE_SPANS and sp.done:
                device_s += sp.duration_s
            elif sp.name == "delta":
                is_delta = True
                if sp.attrs.get("inline"):
                    inline = True
        with self._lock:
            self._device_s += device_s * self.sample_every
            if is_delta:
                self._deltas += self.sample_every
                if inline:
                    self._inline += self.sample_every

    # ---- sampler hook (sampler thread) -------------------------------

    def tick(self, now: Optional[float] = None) -> None:
        """Publish the interval's occupancy gauges (registered as a
        sampler pre-snapshot hook, so the tick that computes them also
        records them as series)."""
        if now is None:
            now = self.clock.now()
        slots = self.registry.histograms.get(M.MEGABATCH_SLOTS)
        lkey = M._lkey(None)
        slot_sum = slots.sums.get(lkey, 0.0) if slots is not None else 0.0
        slot_count = slots.totals.get(lkey, 0) if slots is not None else 0
        with self._lock:
            cur = (now, self._device_s, slot_sum, slot_count,
                   self._deltas, self._inline)
        last, self._last = self._last, cur
        if last is None:
            return
        wall = now - last[0]
        if wall <= 0:
            return
        busy = min(1.0, max(0.0, (cur[1] - last[1]) / wall))
        self.registry.gauge(M.OCCUPANCY_DEVICE_BUSY).set(busy)
        d_count = cur[3] - last[3]
        d_sum = cur[2] - last[2]
        self.registry.gauge(M.OCCUPANCY_SLOT_FILL).set(
            d_sum / d_count if d_count > 0 else 0.0)
        d_deltas = cur[4] - last[4]
        d_inline = cur[5] - last[5]
        self.registry.gauge(M.OCCUPANCY_DELTA_INLINE).set(
            d_inline / d_deltas if d_deltas > 0 else 0.0)
