"""The port's serving observability against the reference package's, on
the CPU: ``obs/timeseries.py`` (the registry sampler and its windowed
queries), ``obs/slo.py`` (per-class burn rates, budgets, verdicts, the
fleet merge), ``obs/occupancy.py`` (device-busy share, slot fill, delta
inline fraction) and ``obs/protocol.py`` (the session-protocol tap).

Every scenario is ONE function over a package namespace, driven on both
packages under each package's own ``FakeClock`` with the same seeded
traffic and synthetic traces, and the outputs compared.  Tolerance:
equal.  The busy share is the span stream's on every device, held on its
own below as well.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"
MODULES = {
    "obs": "obs", "timeseries": "obs.timeseries", "slo": "obs.slo",
    "occupancy": "obs.occupancy", "protocol": "obs.protocol",
    "trace": "obs.trace", "metrics": "metrics", "clock": "utils.clock",
}
_PACKAGES = {}


def package(root: str) -> SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = SimpleNamespace(root=root, **{
            alias: importlib.import_module(f"{root}.{path}")
            for alias, path in MODULES.items()})
    return _PACKAGES[root]


def both(fn, *args):
    return fn(package(REFERENCE), *args), fn(package(PORT), *args)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ("KT_TS_INTERVAL_S", "KT_TS_CAPACITY", "KT_SLO_AVAIL_TARGET",
                 "KT_SLO_LATENCY_TARGET", "KT_SLO_P99_MS",
                 "KT_SLO_FAST_BURN", "KT_TRACE", "KT_TRACE_SAMPLE_EVERY"):
        monkeypatch.delenv(name, raising=False)


def test_exports_match_reference():
    ref, port = package(REFERENCE).obs, package(PORT).obs
    for name in ("OccupancyAccountant", "SloEngine", "merge_sloz",
                 "NULL_SAMPLER", "NullSampler", "Sampler", "sampler_for",
                 "tracer_for"):
        assert name in port.__all__ and name in ref.__all__
    assert package(PORT).slo.WINDOWS == package(REFERENCE).slo.WINDOWS
    assert package(PORT).slo.VERDICTS == package(REFERENCE).slo.VERDICTS
    assert package(PORT).occupancy.DEVICE_SPANS == \
        package(REFERENCE).occupancy.DEVICE_SPANS


def sampler_run(k, seed: int) -> list:
    """A counter, a labelled counter with a reset, a gauge and a latency
    histogram sampled every second for 6 minutes; every windowed query
    the service reads, at several points."""
    M = k.metrics
    clock = k.clock.FakeClock(500.0)
    reg = M.Registry()
    s = k.timeseries.Sampler(reg, clock=clock, interval_s=1.0, capacity=400)
    rng = np.random.default_rng(seed)
    out = []
    for t in range(360):
        reg.counter("req_total").inc(value=float(rng.integers(0, 9)))
        lab = {"class": ("a", "b")[t % 2]}
        reg.counter("lab_total").inc(lab, value=float(rng.integers(1, 4)))
        if t == 200:
            reg.counters["lab_total"].values.clear()  # a reset
        reg.gauge("depth").set(float(rng.integers(0, 50)))
        for _ in range(int(rng.integers(0, 6))):
            reg.histogram("lat_seconds").observe(float(rng.gamma(2.0, 0.05)))
        clock.advance(1.0)
        s.tick()
        if t % 60 == 59:
            out.append((
                t, s.series_count(), s.coverage(window_s=120.0),
                s.increase("req_total", window_s=60.0),
                s.rate("req_total", window_s=300.0),
                s.increase("lab_total", labels={"class": "a"},
                           window_s=120.0),
                s.gauge_stats("depth", window_s=30.0),
                s.quantile("lat_seconds", 0.99, window_s=60.0),
                s.quantile("lat_seconds", 0.5, window_s=300.0),
                s.hist_window("lat_seconds", window_s=60.0)))
    out.append(("null", bool(k.timeseries.NULL_SAMPLER),
                k.timeseries.NULL_SAMPLER.increase("req_total"),
                type(k.timeseries.sampler_for(reg, interval_s=0)).__name__))
    return out


@pytest.mark.parametrize("seed", [1, 5])
def test_sampler_queries_match_reference(seed):
    ref, port = both(sampler_run, seed)
    assert port == ref


def slo_run(k, seed: int) -> dict:
    """Seeded per-class traffic with an error burst and a latency regime
    change, evaluated every 30 s on a live sampler; the gauges after."""
    M = k.metrics
    clock = k.clock.FakeClock(1000.0)
    reg = M.Registry()
    s = k.timeseries.Sampler(reg, clock=clock, interval_s=1.0, capacity=4000)
    eng = k.slo.SloEngine(reg, sampler=s, clock=clock, replica="r0")
    rng = np.random.default_rng(seed)
    docs = []
    for t in range(900):
        for cls in ("critical", "batch", "best_effort"):
            for _ in range(int(rng.integers(0, 5))):
                slow = 300 <= t < 420 and cls == "batch"
                ms = float(rng.gamma(2.0, 400.0 if slow else 40.0))
                eng.record(cls, "ok", solve_ms=ms)
        if 500 <= t < 530:
            eng.record("critical", "shed")
            eng.record("best_effort", "error")
        if t == 700:
            eng.record("bogus-class", "weird")
        clock.advance(1.0)
        s.tick()
        if t % 30 == 29:
            docs.append(eng.evaluate())
    gauges = {name: dict(reg.gauge(name).values) for name in (
        M.SLO_BURN_RATE, M.SLO_BUDGET_REMAINING, M.SLO_VERDICT)}
    no_sampler = k.slo.SloEngine(reg, sampler=None, clock=clock,
                                 replica="r1").evaluate()
    return dict(docs=docs, gauges=gauges, no_sampler=no_sampler,
                merged=k.slo.merge_sloz([docs[-1], no_sampler,
                                         docs[len(docs) // 2]]))


@pytest.mark.parametrize("seed", [2, 9])
def test_slo_burn_sequence_matches_reference(seed):
    ref, port = both(slo_run, seed)
    assert port == ref
    verdicts = {c["verdict"] for d in port["docs"]
                for c in d["classes"].values()}
    assert {"ok", "breach"} <= verdicts or {"ok", "warn"} <= verdicts


def occupancy_run(k, sample_every: int) -> list:
    """Synthetic traces on a FakeClock tracer: solves with dispatch and
    fence spans, megabatch slot observations, delta traces inline and
    queued; the three gauges after every tick."""
    M = k.metrics
    clock = k.clock.FakeClock(0.0)
    reg = M.Registry()
    tracer = k.trace.Tracer(clock=clock, registry=reg, enabled=True,
                            sample_every=1)
    acc = k.occupancy.OccupancyAccountant(reg, clock=clock,
                                          sample_every=sample_every)
    tracer.add_sink(acc.on_trace)
    rng = np.random.default_rng(4)
    out = []
    acc.tick(clock.now())
    for step in range(12):
        for _ in range(int(rng.integers(1, 4))):
            with tracer.start("solve") as tr:
                with tr.span("dispatch"):
                    clock.advance(float(rng.integers(1, 20)) / 100.0)
                with tr.span("fence"):
                    clock.advance(float(rng.integers(1, 10)) / 100.0)
                with tr.span("reseat"):
                    clock.advance(0.01)
        for _ in range(int(rng.integers(0, 3))):
            reg.histogram(M.MEGABATCH_SLOTS).observe(
                float(rng.integers(1, 9)))
        for j in range(int(rng.integers(0, 4))):
            with tracer.start("solve") as tr:
                t0 = tr.now()
                clock.advance(0.002)
                tr.record("delta", t0, tr.now(), inline=bool(j % 2))
        clock.advance(1.0)
        acc.tick()
        out.append(tuple(reg.gauge(name).get() for name in (
            M.OCCUPANCY_DEVICE_BUSY, M.OCCUPANCY_SLOT_FILL,
            M.OCCUPANCY_DELTA_INLINE)))
    return out


@pytest.mark.parametrize("sample_every", [1, 3])
def test_occupancy_sequence_matches_reference(sample_every):
    ref, port = both(occupancy_run, sample_every)
    assert port == ref
    assert any(busy > 0 for busy, _f, _i in port)


def test_occupancy_busy_from_device_events():
    """The busy share is the device-solve spans' share of the wall, host
    enqueue included, on every device: the ``dispatch`` and ``fence``
    spans of the stream count, their ``device_*`` children do not count
    again, and there is no CUDA-event busy source beside them."""
    from karpenter_tpu_torch import metrics as M
    from karpenter_tpu_torch.obs import occupancy
    from karpenter_tpu_torch.obs.trace import Tracer
    from karpenter_tpu_torch.utils.clock import FakeClock

    assert not hasattr(occupancy, "record_device_ms")
    assert not hasattr(occupancy, "device_busy_ms")
    clock = FakeClock(0.0)
    reg = M.Registry()
    tracer = Tracer(clock=clock, registry=reg, enabled=True, sample_every=1)
    acc = occupancy.OccupancyAccountant(reg, clock=clock)
    tracer.add_sink(acc.on_trace)
    acc.tick(clock.now())
    with tracer.start("solve") as tr:
        with tr.span("dispatch"):
            with tr.span("device_execute"), tr.span("device_enqueue"):
                clock.advance(0.4)
            clock.advance(0.1)
        with tr.span("reseat"):
            clock.advance(0.3)   # host stages outside the spans: not busy
    clock.advance(1.2)
    acc.tick()
    assert reg.gauge(M.OCCUPANCY_DEVICE_BUSY).get() == pytest.approx(0.25)
    clock.advance(1.0)
    acc.tick()
    assert reg.gauge(M.OCCUPANCY_DEVICE_BUSY).get() == 0.0
    with tracer.start("solve") as tr:
        with tr.span("fence"):
            clock.advance(5.0)
    acc.tick()
    assert reg.gauge(M.OCCUPANCY_DEVICE_BUSY).get() == 1.0  # clamped


def protocol_run(k) -> dict:
    P = k.protocol
    out = {}
    P.emit("s0", "dropped-before-install")
    with P.recording() as rec:
        P.emit("s1", "establish", epoch=1)
        P.emit("s1", "commit", replica="r", epoch=2)
        P.emit("s2", "serve_unknown", why="epoch")
        out["inside"] = P.installed() is rec
        out["events"] = rec.events_by_session()
        out["len"] = len(rec)
    out["after"] = P.installed()
    empty = P.TransitionRecorder()
    with P.recording(empty) as rec2:
        out["empty_kept"] = rec2 is empty
    return out


def test_protocol_tap_matches_reference():
    ref, port = both(protocol_run)
    assert port == ref
