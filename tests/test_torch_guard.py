"""The port's device hang guard (``solver/guard.py``) and the scheduler's
degraded serve against the reference package, on the CPU.

Every case of the reference's ``tests/test_device_guard.py`` is here.
``TestDeviceGuard``'s four run against the port's guard with the
reference's assertions.  ``TestSchedulerDegradation``'s three run through
both packages' ``BatchScheduler`` (the reference compiling inline with its
device program marked ready, the port on ``device="cpu"``) from reset
node-name counters, with a patched device solve that blocks past a short
deadline: the degraded answer (served by the native tier), the counters,
the warm gate and the recovered device answer must be equal.  Tolerance:
none — bools, ints, names and prices to 1e-6 equal.

Also here: the port's guard latches on a :class:`DeviceHang` raised inside
a guarded call, its probe runs on the guard's device, and the scheduler's
megabatch collector, async dispatch and hierarchical block waves degrade
under a hang.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import pytest
import torch

import karpenter_tpu_torch.metrics as t_metrics
from karpenter_tpu_torch.solver import guard as t_guard
from karpenter_tpu_torch.solver.guard import DeviceGuard, DeviceHang

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"

MODULES = {
    "metrics": "metrics",
    "catalog": "models.catalog",
    "pod": "models.pod",
    "provisioner": "models.provisioner",
    "scheduler": "solver.scheduler",
    "tpu": "solver.tpu",
    "types": "solver.types",
}

_PACKAGES: dict = {}
_CATALOGS: dict = {}


def package(root: str) -> SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = SimpleNamespace(root=root, **{
            alias: importlib.import_module(f"{root}.{path}")
            for alias, path in MODULES.items()})
    return _PACKAGES[root]


def small_catalog(k):
    if k.root not in _CATALOGS:
        _CATALOGS[k.root] = k.catalog.generate_catalog(full=False)
    return _CATALOGS[k.root]


def run_both(scenario, *args):
    seen = []
    for root in (REFERENCE, PORT):
        k = package(root)
        with k.types._node_lock:
            k.types._node_next = 0
        seen.append(scenario(k, *args))
    assert seen[1] == seen[0]
    return seen[1]


def scheduler(k, backend, registry):
    if k.root == REFERENCE:
        sched = k.scheduler.BatchScheduler(backend=backend, registry=registry,
                                           compile_behind=False)
        # device program "ready" so the dispatch path is the guarded call
        sched._device_ready = lambda *a: True
        return sched
    return k.scheduler.BatchScheduler(backend=backend, registry=registry,
                                      device="cpu")


def device_solver(k):
    return (k.tpu.TpuSolver() if k.root == REFERENCE
            else k.tpu.TpuSolver(device="cpu"))


def scenario(k):
    pods = [k.pod.PodSpec(name=f"p{i}", requests={"cpu": 0.5}, owner_key="d")
            for i in range(300)]  # > NATIVE_BATCH_LIMIT: routes to device
    provs = [k.provisioner.Provisioner(name="default").with_defaults()]
    return pods, provs, small_catalog(k)


def observe(res) -> dict:
    return dict(
        nodes=sorted(
            (n.name, n.instance_type, n.zone, n.capacity_type,
             round(n.price, 6), tuple(sorted(p.name for p in n.pods)))
            for n in res.nodes),
        assignments=dict(sorted(res.assignments.items())),
        infeasible=dict(sorted(res.infeasible.items())),
    )


def health(k, reg) -> dict:
    m = k.metrics
    return dict(
        hangs=reg.counter(m.SOLVER_DEVICE_HANGS).get(),
        healthy=reg.gauge(m.SOLVER_DEVICE_HEALTHY).get(),
        degraded=dict(reg.counter(m.SOLVER_DEGRADED_SOLVES).values),
        cold=dict(reg.counter(m.SOLVER_COLD_FALLBACKS).values),
    )


# ---------------------------------------------------------------------------
# TestDeviceGuard, against the port's guard
# ---------------------------------------------------------------------------


def test_disabled_runs_inline():
    g = DeviceGuard(timeout_s=0)
    assert not g.enabled
    assert g.run(lambda x: x + 1, 41) == 42


def test_passthrough_value_and_exception():
    g = DeviceGuard(timeout_s=5.0)
    assert g.run(lambda: "ok") == "ok"

    class Boom(RuntimeError):
        pass

    with pytest.raises(Boom):
        g.run(lambda: (_ for _ in ()).throw(Boom("x")))
    assert g.healthy  # exceptions are not hangs


def test_timeout_latches_unhealthy_and_probe_recovers():
    events = []
    release = threading.Event()
    probe_ok = threading.Event()

    def probe():
        if not probe_ok.is_set():
            raise RuntimeError("still down")

    g = DeviceGuard(timeout_s=0.1, probe_interval_s=0.05,
                    probe_fn=probe, on_health_change=events.append)
    with pytest.raises(DeviceHang):
        g.run(release.wait, 5.0)  # blocks past the 0.1 s deadline
    assert not g.healthy
    assert events == [False]
    time.sleep(0.2)
    assert not g.healthy  # probe failing -> stays unhealthy
    probe_ok.set()
    deadline = time.time() + 5.0
    while not g.healthy and time.time() < deadline:
        time.sleep(0.02)
    assert g.healthy
    assert events == [False, True]
    release.set()  # unblock the abandoned worker thread
    g.stop()


def test_second_hang_does_not_stack_probes():
    events = []
    g = DeviceGuard(timeout_s=0.05, probe_interval_s=30.0,
                    probe_fn=lambda: None, on_health_change=events.append)
    with pytest.raises(DeviceHang):
        g.run(time.sleep, 1.0)
    with pytest.raises(DeviceHang):
        g.run(time.sleep, 1.0)
    assert events == [False]
    assert sum(1 for t in threading.enumerate()
               if t.name == "kt-device-probe") == 1
    g.stop()


# ---------------------------------------------------------------------------
# TestSchedulerDegradation, through both schedulers
# ---------------------------------------------------------------------------


def _hang_degrades_to_warm_tier_and_recovers(k):
    reg = k.metrics.Registry()
    sched = scheduler(k, "auto", reg)
    sched._guard.timeout_s = 0.1
    sched._guard.probe_interval_s = 3600.0  # recovery driven manually
    hang = threading.Event()

    def hanging_solve(*a, **kw):
        hang.wait(10.0)
        raise AssertionError("abandoned solve result must be discarded")

    sched._tpu.solve = hanging_solve
    pods, provs, cat = scenario(k)
    res = sched.solve(pods, provs, cat)
    assert res.n_scheduled == 300 and not res.infeasible
    assert not sched._guard.healthy
    after_hang = health(k, reg)
    assert after_hang["hangs"] == 1 and after_hang["healthy"] == 0
    assert sum(after_hang["degraded"].values()) >= 1

    def must_not_run(*a, **kw):
        raise AssertionError("device dispatched while unhealthy")

    sched._tpu.solve = must_not_run
    res2 = sched.solve(pods, provs, cat)
    assert res2.n_scheduled == 300
    warms = sched.warm_startup(provs, cat)
    assert warms == 0  # warms are gated while unhealthy

    called = {}

    def healthy_solve(st, **kw):
        called["yes"] = True
        return device_solver(k).solve(st, **kw)

    sched._tpu.solve = healthy_solve
    sched._guard.timeout_s = 120.0
    with sched._guard._lock:
        sched._guard._healthy = True
        sched._guard._probing = False
    sched._device_health_changed(True)
    res3 = sched.solve(pods, provs, cat)
    assert res3.n_scheduled == 300 and called.get("yes")
    recovered = health(k, reg)
    assert recovered["healthy"] == 1 and recovered["hangs"] == 1
    hang.set()
    sched.stop_warms()
    return (observe(res), after_hang, observe(res2), warms, observe(res3),
            recovered)


def _reseat_keeps_degraded(k, monkeypatch):
    """The reseat epilogue is NOT skipped for device-unhealthy degraded
    solves, whose nodes are real and long-lived (the reference's cold
    half of this case has no counterpart: the port serves cold shapes on
    the device, so no solve of it is ever ``served_cold``)."""
    calls = []

    def spy(self, result, *a, **kw):
        calls.append(result.served_cold)

    monkeypatch.setattr(k.scheduler.BatchScheduler, "_reseat_capped", spy)
    pods, provs, cat = scenario(k)
    sched = scheduler(k, "auto", k.metrics.Registry())
    with sched._guard._lock:
        sched._guard._healthy = False
        sched._guard._probing = True  # no probe thread in this test
    res = sched.solve(pods, provs, cat)
    monkeypatch.undo()
    assert calls == [False]
    return calls, observe(res)


def _forced_tpu_backend_is_unguarded(k):
    reg = k.metrics.Registry()
    sched = scheduler(k, "tpu", reg)
    sched._guard.timeout_s = 0.05
    pods, provs, cat = scenario(k)
    real = sched._tpu.solve
    slow = {}

    def slow_solve(*a, **kw):
        time.sleep(0.2)  # beyond the guard deadline
        slow["ran"] = True
        return real(*a, **kw)

    sched._tpu.solve = slow_solve
    res = sched.solve(pods, provs, cat)
    assert res.n_scheduled == 300 and slow.get("ran")
    assert sched._guard.healthy
    return observe(res), health(k, reg)


def test_hang_degrades_to_warm_tier_and_recovers():
    run_both(_hang_degrades_to_warm_tier_and_recovers)


def test_reseat_skips_cold_fallback_keeps_degraded(monkeypatch):
    run_both(_reseat_keeps_degraded, monkeypatch)


def test_forced_tpu_backend_is_unguarded():
    run_both(_forced_tpu_backend_is_unguarded)


# ---------------------------------------------------------------------------
# the port's own guard behaviour
# ---------------------------------------------------------------------------


def test_device_hang_raised_inside_a_guarded_call_latches():
    """A DeviceHang from inside the call (the fault plane's injected hang)
    latches the tier like a timeout; the reference re-raises it without
    latching (ROADMAP Queue C)."""
    events = []
    g = DeviceGuard(timeout_s=5.0, probe_interval_s=0.05,
                    probe_fn=lambda: None, on_health_change=events.append)

    def injected():
        raise DeviceHang("injected device_hang@fence (call #1)")

    with pytest.raises(DeviceHang):
        g.run(injected)
    deadline = time.time() + 5.0
    while not g.healthy and time.time() < deadline:
        time.sleep(0.02)
    assert events == [False, True]
    g.stop()


def test_probe_runs_on_the_guard_device():
    """The default probe is a small op read back from the guard's device:
    on ``cpu`` it answers; on an absent card it raises (still down)."""
    t_guard.device_probe("cpu")()
    g = DeviceGuard(device="cpu")
    g.probe_fn()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            t_guard.device_probe()()


def test_budgeted_run_splits_the_deadline():
    g = DeviceGuard(timeout_s=1.0, probe_interval_s=30.0,
                    probe_fn=lambda: None)
    t0 = time.perf_counter()
    with pytest.raises(DeviceHang):
        g.run_budgeted(time.sleep, 2.0, budget_frac=0.1)
    assert time.perf_counter() - t0 < 0.9
    g.stop()


def _mega_and_async_degrade(k):
    """A hang at the collector's read and at an async read-back degrades
    each request to the native tier with the same answers."""
    reg = k.metrics.Registry()
    sched = scheduler(k, "auto", reg)
    sched._guard.timeout_s = 5.0
    sched._guard.probe_interval_s = 3600.0
    pods, provs, cat = scenario(k)
    real_async = sched._tpu.solve_async

    class HungRead:
        def __init__(self, pending):
            self.pending = pending

        def result(self):
            raise k.scheduler.DeviceHang("read-back hung")

    sched._tpu.solve_async = lambda *a, **kw: HungRead(real_async(*a, **kw))
    res = sched.submit(pods, provs, cat).result()
    assert res.n_scheduled == 300
    # the one divergence (ROADMAP Queue C): a DeviceHang raised inside the
    # guarded read latches the port's guard, not the reference's
    assert sched._guard.healthy == (k.root == REFERENCE)
    degraded = dict(reg.counter(k.metrics.SOLVER_DEGRADED_SOLVES).values)
    sched.stop_warms()
    return observe(res), degraded


def test_async_read_back_hang_degrades_like_the_reference():
    run_both(_mega_and_async_degrade)


def test_megabatch_hang_degrades_each_request():
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    reg = t_metrics.Registry()
    sched = BatchScheduler(backend="auto", registry=reg, device="cpu")
    sched._guard.probe_interval_s = 3600.0
    cat = generate_catalog(full=False)
    provs = [Provisioner(name="default").with_defaults()]

    def batch(tag):
        return [PodSpec(name=f"{tag}-{i}", requests={"cpu": 0.5},
                        owner_key=tag) for i in range(300)]

    def hung(*a, **kw):
        raise DeviceHang("megabatch dispatch hung")

    sched._tpu.solve_many_async = hung
    pendings = sched.submit_many([
        dict(pods=batch(t), provisioners=provs, instance_types=cat)
        for t in ("a", "b")])
    results = [p.result() for p in pendings]
    assert all(r.n_scheduled == 300 and not r.infeasible for r in results)
    assert reg.counter(t_metrics.SOLVER_DEVICE_HANGS).get() == 1
    assert reg.counter(t_metrics.SOLVER_DEGRADED_SOLVES).get(
        {"backend": "native"}) == 2
    assert sched.bucket_key(dict(pods=batch("c"), provisioners=provs,
                                 instance_types=cat)) is None
    sched.stop_warms()


def test_hierarchical_wave_hang_degrades_the_batch(monkeypatch):
    """A block wave that trips the guard counts ``fallback_degraded``; the
    flat path then serves the batch from a host tier, every pod seated."""
    import chip_smoke as cs
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    pods = cs.deployments(4, 80, tag="hw")
    monkeypatch.setenv("KT_HIER_THRESHOLD", str(len(pods)))
    reg = t_metrics.Registry()
    sched = BatchScheduler(backend="auto", registry=reg, device="cpu")
    sched._guard.probe_interval_s = 3600.0
    budgets = []
    real = sched._guard._run

    def spy(timeout_s, fn, args, kwargs):
        budgets.append(timeout_s)
        return real(timeout_s, fn, args, kwargs)

    def hung(entries, **kwargs):  # the wave passes its trace
        raise DeviceHang("block wave hung")

    monkeypatch.setattr(sched._guard, "_run", spy)
    sched._tpu.solve_many_prepared = hung
    res = sched.solve(pods, [cs.provisioner()], generate_catalog(full=False))
    assert res.n_scheduled == len(pods) and not res.infeasible
    assert reg.counter(t_metrics.HIER_SOLVES).get(
        {"path": "fallback_degraded"}) == 1
    assert reg.counter(t_metrics.SOLVER_DEVICE_HANGS).get() == 1
    assert sum(reg.counter(t_metrics.SOLVER_DEGRADED_SOLVES)
               .values.values()) == 1
    # the wave ran under 1 / (1 + KT_HIER_PRICE_ITERS) of the deadline
    assert budgets[0] == pytest.approx(t_guard.DEFAULT_TIMEOUT_S / 5)
    sched.stop_warms()
