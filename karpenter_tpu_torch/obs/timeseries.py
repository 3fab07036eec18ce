"""Time-resolved telemetry: bounded ring buffers over the metrics registry.

Everything else on the observability surface is a point-in-time snapshot
(/statusz, /fleetz) or a cumulative counter; this module adds the time
axis.  A background :class:`Sampler` snapshots every counter/gauge/
histogram series in a :class:`~karpenter_tpu_torch.metrics.Registry` into a
bounded per-series ring buffer every ``KT_TS_INTERVAL_S`` seconds and
answers windowed queries off the rings:

- ``rate(name, window_s=...)`` / ``increase(...)`` — counter deltas with
  reset detection (a restarted series contributes its post-reset value,
  never a negative delta),
- ``quantile(name, q, window_s=...)`` — latency percentiles from
  histogram *bucket deltas* over the window (the lifetime histogram
  converges to its steady state; the windowed view is what an SLO burn
  rate needs),
- ``gauge_stats(...)`` — last/min/max/mean of a gauge over the window.

The sampler is clock-injectable (FakeClock tests drive ``tick()``
directly) and OFF by default in tests: ``sampler_for(registry)`` returns
the falsy :data:`NULL_SAMPLER` when the interval knob is unset or <= 0,
so the serving path pays one truthiness check (the NULL_TRACE pattern).

Sampling cost is bounded: one pass over the registry dicts per tick
(``karpenter_ts_sample_duration_seconds`` observes it) and
``KT_TS_CAPACITY`` points per series (default 720 — one hour at the 5 s
default interval).  bench.py's ``measure_ts_overhead`` gates the
sampler-on serving overhead at <= 2%.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics as M
from ..utils.clock import Clock

log = logging.getLogger("karpenter.obs.timeseries")

#: sampler interval knob, seconds; unset/<= 0 disables sampling entirely
INTERVAL_ENV = "KT_TS_INTERVAL_S"
#: ring capacity knob, points per series
CAPACITY_ENV = "KT_TS_CAPACITY"
DEFAULT_INTERVAL_S = 5.0
DEFAULT_CAPACITY = 720


class NullSampler:
    """Falsy no-op stand-in when sampling is off (the NULL_TRACE pattern):
    every query answers None, tick/start/stop cost nothing."""

    interval_s = 0.0
    capacity = 0

    def __bool__(self) -> bool:
        return False

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def tick(self) -> float:
        return 0.0

    def add_hook(self, hook) -> None:
        pass

    def series_count(self) -> int:
        return 0

    def coverage(self, window_s: float = 300.0):
        return None

    def increase(self, name, labels=None, window_s: float = 300.0):
        return None

    def rate(self, name, labels=None, window_s: float = 300.0):
        return None

    def gauge_stats(self, name, labels=None, window_s: float = 300.0):
        return None

    def hist_window(self, name, labels=None, window_s: float = 300.0):
        return None

    def quantile(self, name, q: float, labels=None,
                 window_s: float = 300.0):
        return None


NULL_SAMPLER = NullSampler()


class Sampler:
    """Background registry snapshotter + windowed query engine.

    Ring entries are ``(t, value)`` for counters/gauges and
    ``(t, bucket_counts, sum, total)`` for histograms, appended under
    ``_lock`` so queries race-free coexist with the sampler thread.
    Queries answer ``None`` when the window holds fewer than two samples
    (no anchor to delta against) — callers treat None as "no data yet",
    never as zero.
    """

    def __init__(self, registry, clock: Optional[Clock] = None,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 capacity: int = DEFAULT_CAPACITY) -> None:
        self.registry = registry
        self.clock = clock or Clock()
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self._rings: Dict[Tuple[str, str, tuple], deque] = {}
        self._lock = threading.Lock()
        self._hooks: List[Callable[[float], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        registry.counter(M.TS_SAMPLES).inc(value=0.0)
        registry.gauge(M.TS_SERIES).set(0.0)
        registry.histogram(M.TS_SAMPLE_DURATION)

    def __bool__(self) -> bool:
        return True

    # ---- sampling ----------------------------------------------------

    def add_hook(self, hook: Callable[[float], None]) -> None:
        """Register a pre-snapshot hook run at the top of every tick with
        the tick's timestamp (the occupancy accountant publishes its
        gauges here so the same tick samples them)."""
        self._hooks.append(hook)

    def tick(self) -> float:
        """Take one snapshot of every registry series; returns the tick's
        timestamp.  Safe to call directly (FakeClock tests, the replay
        harness's final flush) whether or not the thread runs."""
        t0 = time.perf_counter()
        now = self.clock.now()
        for hook in self._hooks:
            try:
                hook(now)
            except Exception:
                log.exception("sampler hook failed")
        with self._lock:
            self._snap_scalars("counter", self.registry.counters, now)
            self._snap_scalars("gauge", self.registry.gauges, now)
            for name, h in list(self.registry.histograms.items()):
                try:
                    for lkey in list(h.totals.keys()):
                        counts = h.counts.get(lkey)
                        entry = (now,
                                 tuple(counts) if counts is not None else (),
                                 h.sums.get(lkey, 0.0),
                                 h.totals.get(lkey, 0))
                        self._ring("histogram", name, lkey).append(entry)
                except RuntimeError:
                    # family mutated mid-snapshot (a new series raced in);
                    # the next tick sees it — skipping beats locking the
                    # hot solve path
                    continue
        self.registry.counter(M.TS_SAMPLES).inc()
        self.registry.gauge(M.TS_SERIES).set(float(len(self._rings)))
        self.registry.histogram(M.TS_SAMPLE_DURATION).observe(
            time.perf_counter() - t0)
        return now

    def _snap_scalars(self, kind: str, families, now: float) -> None:
        for name, fam in list(families.items()):
            # skip the sampler's own families: sampling them would grow
            # the snapshot it is taking (and they are per-tick anyway)
            if name in (M.TS_SAMPLES, M.TS_SERIES):
                continue
            try:
                for lkey, value in list(fam.values.items()):
                    self._ring(kind, name, lkey).append((now, float(value)))
            except RuntimeError:
                continue

    def _ring(self, kind: str, name: str, lkey: tuple) -> deque:
        key = (kind, name, lkey)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = deque(maxlen=self.capacity)
        return ring

    # ---- background thread -------------------------------------------

    def start(self) -> None:
        """Start the background thread (idempotent; restartable after
        stop()).  Takes one anchor tick synchronously so the first
        windowed query after interval_s has something to delta against."""
        if self._thread is not None:
            return
        self.tick()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="kt-ts-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5.0)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                log.exception("sampler tick failed")

    # ---- queries -----------------------------------------------------

    def series_count(self) -> int:
        with self._lock:
            return len(self._rings)

    def coverage(self, window_s: float = 300.0) -> Optional[float]:
        """Seconds of history actually held within the window (may be
        shorter than window_s right after start); None before 2 ticks."""
        with self._lock:
            ts = sorted({e[0] for ring in self._rings.values()
                         for e in ring})
        if len(ts) < 2:
            return None
        now = ts[-1]
        lo = max(ts[0], now - window_s)
        return now - lo

    def _window(self, kind: str, name: str, labels, window_s: float):
        """(anchor_entry, newest_entry) for the series, or None.  The
        anchor is the newest sample at or before now - window_s — the
        sample *outside* the window, so the delta covers the full window
        rather than window - interval."""
        lkey = M._lkey(labels)
        with self._lock:
            ring = self._rings.get((kind, name, lkey))
            if ring is None or len(ring) < 2:
                return None
            entries = list(ring)
        now = entries[-1][0]
        cutoff = now - window_s
        anchor = None
        for e in entries[:-1]:
            if e[0] <= cutoff:
                anchor = e
        if anchor is None:
            anchor = entries[0]
        if anchor[0] >= now:
            return None
        return anchor, entries[-1], entries

    def increase(self, name: str, labels=None,
                 window_s: float = 300.0) -> Optional[float]:
        """Counter increase over the window, reset-aware: walking the
        in-window samples, a drop (cur < prev) means the process
        restarted — the post-reset value itself is the increase since
        the reset."""
        w = self._window("counter", name, labels, window_s)
        if w is None:
            return None
        anchor, newest, entries = w
        start = entries.index(anchor)
        total, prev = 0.0, anchor[1]
        for _, value in entries[start + 1:]:
            total += value - prev if value >= prev else value
            prev = value
        return total

    def rate(self, name: str, labels=None,
             window_s: float = 300.0) -> Optional[float]:
        """Counter rate (1/s) over the window: increase / covered time."""
        w = self._window("counter", name, labels, window_s)
        if w is None:
            return None
        anchor, newest, _ = w
        inc = self.increase(name, labels, window_s)
        elapsed = newest[0] - anchor[0]
        if inc is None or elapsed <= 0:
            return None
        return inc / elapsed

    def gauge_stats(self, name: str, labels=None,
                    window_s: float = 300.0) -> Optional[dict]:
        w = self._window("gauge", name, labels, window_s)
        if w is None:
            return None
        anchor, newest, entries = w
        vals = [v for t, v in entries if t > newest[0] - window_s]
        if not vals:
            vals = [newest[1]]
        return {"last": newest[1], "min": min(vals), "max": max(vals),
                "mean": sum(vals) / len(vals)}

    def hist_window(self, name: str, labels=None, window_s: float = 300.0):
        """Histogram deltas over the window:
        ``(bucket_deltas, sum_delta, count_delta, buckets)``.  A total
        reset (newest total < anchor total) uses the newest counts
        outright — everything observed since the restart is in-window."""
        w = self._window("histogram", name, labels, window_s)
        if w is None:
            return None
        anchor, newest, _ = w
        _, a_counts, a_sum, a_total = anchor
        _, n_counts, n_sum, n_total = newest
        hist = self.registry.histograms.get(name)
        buckets = hist.buckets if hist is not None else M._DEFAULT_BUCKETS
        if n_total < a_total or len(a_counts) != len(n_counts):
            return (list(n_counts), n_sum, n_total, buckets)
        deltas = [max(0, n - a) for n, a in zip(n_counts, a_counts)]
        return (deltas, max(0.0, n_sum - a_sum), n_total - a_total, buckets)

    def quantile(self, name: str, q: float, labels=None,
                 window_s: float = 300.0) -> Optional[float]:
        """Windowed quantile from bucket deltas, linearly interpolated
        within the landing bucket (Prometheus histogram_quantile
        semantics).  None when nothing was observed in the window; the
        overflow bucket answers the last finite boundary (the honest
        lower bound — the true value is off the bucket scale)."""
        hw = self.hist_window(name, labels, window_s)
        if hw is None:
            return None
        deltas, _, count, buckets = hw
        if count <= 0 or not deltas:
            return None
        rank = q * count
        seen = 0.0
        for i, d in enumerate(deltas):
            seen += d
            if seen >= rank and d > 0:
                if i >= len(buckets):
                    return float(buckets[-1])
                lo = buckets[i - 1] if i > 0 else 0.0
                hi = buckets[i]
                frac = (rank - (seen - d)) / d
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
        return float(buckets[-1])


def sampler_for(registry, clock: Optional[Clock] = None,
                interval_s: Optional[float] = None,
                capacity: Optional[int] = None):
    """Build a Sampler from the KT_TS_* knobs, or NULL_SAMPLER when the
    effective interval is <= 0 (sampling off — the test default)."""
    if interval_s is None:
        try:
            interval_s = float(os.environ.get(INTERVAL_ENV,
                                              "") or DEFAULT_INTERVAL_S)
        except ValueError:
            interval_s = DEFAULT_INTERVAL_S
    if interval_s <= 0:
        return NULL_SAMPLER
    if capacity is None:
        try:
            capacity = int(os.environ.get(CAPACITY_ENV,
                                          "") or DEFAULT_CAPACITY)
        except ValueError:
            capacity = DEFAULT_CAPACITY
    return Sampler(registry, clock=clock, interval_s=interval_s,
                   capacity=max(2, capacity))
