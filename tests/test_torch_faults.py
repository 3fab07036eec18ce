"""The port's fault-injection plane (``faults/``) against the reference
package, on the CPU.

Every case of the reference's ``TestFaultPlane`` (``tests/test_faults.py``)
is here, each ONE function over a package namespace ``k``, run over
``karpenter_tpu`` and over ``karpenter_tpu_torch``: the reference's
assertions hold on both, and what each plane did must be equal — which
calls fired, the raised types' fields, the mangled bytes, the counters.
For a given seed and schedule both planes fire on the same calls.

Through the solvers: a ``device_hang@fence`` schedule through each
package's ``BatchScheduler`` gives the same degraded answer and the same
degraded and injected counts, and ``dispatch_exc@dispatch`` raises
``InjectedFault`` out of both.  One divergence is held explicitly: the
injected hang latches the port's guard (``SOLVER_DEVICE_HANGS`` 1, healthy
0, recovery by the probe) and leaves the reference's healthy (ROADMAP
Queue C).  The snapshot, client and service classes of that file come
with the service.  Tolerance: none — bools, ints, names and bytes equal.
"""

import importlib
import time
from types import SimpleNamespace

import grpc
import pytest
import torch

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"

MODULES = {
    "faults": "faults",
    "plane": "faults.plane",
    "metrics": "metrics",
    "catalog": "models.catalog",
    "pod": "models.pod",
    "provisioner": "models.provisioner",
    "scheduler": "solver.scheduler",
    "tpu": "solver.tpu",
    "guard": "solver.guard",
    "tensorize": "models.tensorize",
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


# ---------------------------------------------------------------------------
# TestFaultPlane
# ---------------------------------------------------------------------------


def _null_plane_is_falsy_and_inert(k, monkeypatch):
    monkeypatch.delenv("KT_FAULTS", raising=False)
    f = k.faults
    assert not f.NULL_PLANE
    assert f.NULL_PLANE.fire("dispatch") is None
    assert f.NULL_PLANE.mangle("snapshot_write", b"x") == b"x"
    assert f.plane() is f.NULL_PLANE
    return bool(f.NULL_PLANE), f.NULL_PLANE.stats(), f.faults_enabled()


def _env_plane_construction(k, monkeypatch):
    monkeypatch.setenv("KT_FAULTS", "dispatch_exc@dispatch:at=1")
    p = k.faults.plane(registry=k.metrics.Registry())
    monkeypatch.delenv("KT_FAULTS")
    assert p and isinstance(p, k.faults.FaultPlane)
    return p.stats()


def _bad_schedule_raises_loud(k, monkeypatch):
    out = []
    for spec in ("typo_kind@dispatch:at=1", "dispatch_exc@nowhere:at=1",
                 "dispatch_exc@dispatch:at=1:bogus=2",
                 "dispatch_exc@dispatch:at"):
        with pytest.raises(ValueError) as exc:
            k.faults.FaultPlane(spec, registry=k.metrics.Registry())
        out.append(str(exc.value))
    return out


def _unenactable_kind_site_combo_raises_loud(k, monkeypatch):
    out = []
    for combo in ("slow_fence@dispatch", "session_wipe@transport",
                  "snapshot_corrupt@snapshot_read", "device_hang@dispatch"):
        with pytest.raises(ValueError) as exc:
            k.faults.FaultPlane(f"{combo}:at=1", registry=k.metrics.Registry())
        out.append(str(exc.value))
    return out


def _every_kind_has_an_enacting_site(k, monkeypatch):
    KIND_SITES = k.plane.KIND_SITES
    assert set(KIND_SITES) == set(k.metrics.FAULT_KINDS)
    for kind, sites in KIND_SITES.items():
        assert sites and set(sites) <= set(k.metrics.FAULT_SITES)
        for site in sites:
            k.faults.FaultPlane(f"{kind}@{site}:at=1",
                                registry=k.metrics.Registry())
    return (KIND_SITES, k.metrics.FAULT_KINDS, k.metrics.FAULT_SITES,
            k.metrics.FAULT_RECOVERY_OUTCOMES, k.plane.RAISE_KINDS)


def _at_rule_fires_exactly_once(k, monkeypatch):
    reg = k.metrics.Registry()
    p = k.faults.FaultPlane("dispatch_exc@dispatch:at=2", registry=reg)
    assert p.fire("dispatch") is None
    with pytest.raises(k.faults.InjectedFault) as ei:
        p.fire("dispatch")
    assert ei.value.kind == "dispatch_exc"
    assert ei.value.occurrence == 2
    for _ in range(10):
        assert p.fire("dispatch") is None
    n = reg.counter(k.metrics.FAULTS_INJECTED).get(
        {"kind": "dispatch_exc", "site": "dispatch"})
    assert n == 1.0
    return str(ei.value), ei.value.site, p.stats(), \
        dict(reg.counter(k.metrics.FAULTS_RECOVERED).values)


def _every_and_n_compose(k, monkeypatch):
    p = k.faults.FaultPlane("slow_fence@fence:every=2:n=2:value=0.0",
                            registry=k.metrics.Registry())
    hits = [p.fire("fence") is not None for _ in range(8)]
    assert hits == [False, True, False, True, False, False, False, False]
    return hits, p.stats()


def _p_rule_replays_identically_per_seed(k, monkeypatch):
    def run(seed):
        p = k.faults.FaultPlane(
            f"seed={seed};slow_step@delta_step:p=0.5:value=0.0",
            registry=k.metrics.Registry())
        return [p.fire("delta_step") is not None for _ in range(32)]

    assert run(7) == run(7)
    assert run(7) != run(8)
    return run(7), run(8)


def _injected_rpc_error_is_a_real_rpc_error(k, monkeypatch):
    p = k.faults.FaultPlane("rpc_unavailable@transport:at=1",
                            registry=k.metrics.Registry())
    with pytest.raises(grpc.RpcError) as ei:
        p.fire("transport")
    assert ei.value.code() == grpc.StatusCode.UNAVAILABLE
    assert isinstance(ei.value, k.faults.InjectedRpcError)
    return ei.value.details(), ei.value.kind, ei.value.occurrence


def _mangle_truncates_and_corrupts(k, monkeypatch):
    data = bytes(range(256)) * 8
    p = k.faults.FaultPlane(
        "snapshot_truncate@snapshot_write:at=1:value=0.25",
        registry=k.metrics.Registry())
    cut = p.mangle("snapshot_write", data)
    assert len(cut) == len(data) // 4
    p2 = k.faults.FaultPlane("seed=3;snapshot_corrupt@snapshot_write:at=1",
                             registry=k.metrics.Registry())
    mangled = p2.mangle("snapshot_write", data)
    assert len(mangled) == len(data) and mangled != data
    return cut, mangled


def _recovery_funnel_counts(k, monkeypatch):
    reg = k.metrics.Registry()
    k.faults.zero_init_recovery(reg)
    k.faults.count_recovery(reg, "transport", "retried")
    assert reg.counter(k.metrics.FAULTS_RECOVERED).get(
        {"site": "transport", "outcome": "retried"}) == 1.0
    k.plane._JITTER_RNG.seed(0x4B54)
    return dict(reg.counter(k.metrics.FAULTS_RECOVERED).values), \
        [k.faults.jitter() for _ in range(4)]


PLANE = {
    "null_plane_is_falsy_and_inert": _null_plane_is_falsy_and_inert,
    "env_plane_construction": _env_plane_construction,
    "bad_schedule_raises_loud": _bad_schedule_raises_loud,
    "unenactable_kind_site_combo_raises_loud":
        _unenactable_kind_site_combo_raises_loud,
    "every_kind_has_an_enacting_site": _every_kind_has_an_enacting_site,
    "at_rule_fires_exactly_once": _at_rule_fires_exactly_once,
    "every_and_n_compose": _every_and_n_compose,
    "p_rule_replays_identically_per_seed":
        _p_rule_replays_identically_per_seed,
    "injected_rpc_error_is_a_real_rpc_error":
        _injected_rpc_error_is_a_real_rpc_error,
    "mangle_truncates_and_corrupts": _mangle_truncates_and_corrupts,
    "recovery_funnel_counts": _recovery_funnel_counts,
}


@pytest.mark.parametrize("case", sorted(PLANE))
def test_fault_plane_matches_reference(case, monkeypatch):
    run_both(PLANE[case], monkeypatch)


def _seeded_schedule_fires_on_the_same_calls(k, monkeypatch):
    """A composed schedule over several sites: the same calls fire, with
    the same kinds, on both planes."""
    p = k.faults.FaultPlane(
        "seed=11;slow_fence@fence:p=0.3:value=0.0;"
        "dispatch_exc@dispatch:every=5:n=3;"
        "slow_step@delta_step:p=0.6:value=0.0",
        registry=k.metrics.Registry())
    fired = []
    for i in range(60):
        site = ("fence", "dispatch", "delta_step")[i % 3]
        try:
            eff = p.fire(site)
            fired.append((site, None if eff is None else
                          (eff.kind, eff.occurrence, eff.value)))
        except k.faults.InjectedFault as err:
            fired.append((site, ("raised", err.kind, err.occurrence)))
    return fired, p.stats()


def test_seeded_schedule_fires_on_the_same_calls(monkeypatch):
    run_both(_seeded_schedule_fires_on_the_same_calls, monkeypatch)


# ---------------------------------------------------------------------------
# through the solvers
# ---------------------------------------------------------------------------


def _scheduler(k, spec, monkeypatch, reg):
    """A scheduler whose solver's plane parses ``spec``: KT_FAULTS is set
    only while it is built."""
    monkeypatch.setenv("KT_FAULTS", spec)
    if k.root == REFERENCE:
        sched = k.scheduler.BatchScheduler(backend="auto", registry=reg,
                                           compile_behind=False)
        sched._device_ready = lambda *a: True
    else:
        sched = k.scheduler.BatchScheduler(backend="auto", registry=reg,
                                           device="cpu")
    monkeypatch.delenv("KT_FAULTS")
    # the plane counts injections into the package's global registry
    sched._tpu._faults.registry = reg
    return sched


def _batch(k):
    pods = [k.pod.PodSpec(name=f"p{i}", requests={"cpu": 0.5}, owner_key="d")
            for i in range(300)]
    return pods, [k.provisioner.Provisioner(name="default").with_defaults()]


def _observe(res) -> dict:
    return dict(
        nodes=sorted(
            (n.name, n.instance_type, n.zone, n.capacity_type,
             round(n.price, 6), tuple(sorted(p.name for p in n.pods)))
            for n in res.nodes),
        assignments=dict(sorted(res.assignments.items())),
        infeasible=dict(res.infeasible),
    )


def _device_hang_at_fence_degrades(k, monkeypatch):
    reg = k.metrics.Registry()
    sched = _scheduler(k, "device_hang@fence:at=1", monkeypatch, reg)
    sched._guard.probe_interval_s = 0.05
    pods, provs = _batch(k)
    res = sched.solve(pods, provs, small_catalog(k), relax=False)
    assert res.n_scheduled == 300 and not res.infeasible
    m = k.metrics
    degraded = dict(reg.counter(m.SOLVER_DEGRADED_SOLVES).values)
    injected = dict(reg.counter(m.FAULTS_INJECTED).values)
    assert degraded[(("backend", "native"),)] == 1.0
    assert injected[(("kind", "device_hang"), ("site", "fence"))] == 1.0
    hangs = reg.counter(m.SOLVER_DEVICE_HANGS).get()
    if k.root == PORT:
        # the port latches on the injected hang and its probe recovers
        assert hangs == 1 and reg.gauge(m.SOLVER_DEVICE_HEALTHY).get() == 0
        deadline = time.time() + 10.0
        while not sched._guard.healthy and time.time() < deadline:
            time.sleep(0.02)
        assert reg.gauge(m.SOLVER_DEVICE_HEALTHY).get() == 1
    else:
        assert hangs == 0 and sched._guard.healthy
    # the next solve runs on the device again and matches a clean solve
    with k.types._node_lock:
        k.types._node_next = 0
    again = sched.solve(pods, provs, small_catalog(k), relax=False)
    with k.types._node_lock:
        k.types._node_next = 0
    clean = _scheduler(k, "", monkeypatch, k.metrics.Registry()).solve(
        pods, provs, small_catalog(k), relax=False)
    assert _observe(again) == _observe(clean)
    assert dict(reg.counter(m.SOLVER_DEGRADED_SOLVES).values) == degraded
    sched.stop_warms()
    return _observe(res), degraded, injected, _observe(again)


def test_device_hang_at_fence_degrades_like_the_reference(monkeypatch):
    run_both(_device_hang_at_fence_degrades, monkeypatch)


def _dispatch_exc_raises(k, monkeypatch):
    reg = k.metrics.Registry()
    sched = _scheduler(k, "dispatch_exc@dispatch:at=1", monkeypatch, reg)
    pods, provs = _batch(k)
    with pytest.raises(k.faults.InjectedFault) as exc:
        sched.solve(pods, provs, small_catalog(k), relax=False)
    assert sched._guard.healthy  # an exception is not a hang
    res = sched.solve(pods, provs, small_catalog(k), relax=False)
    assert res.n_scheduled == 300
    sched.stop_warms()
    return (str(exc.value), exc.value.site,
            dict(reg.counter(k.metrics.FAULTS_INJECTED).values),
            dict(reg.counter(k.metrics.SOLVER_DEGRADED_SOLVES).values))


def test_dispatch_exc_raises_injected_fault_in_both(monkeypatch):
    run_both(_dispatch_exc_raises, monkeypatch)


def test_slow_fence_sleeps_on_the_plane_clock(monkeypatch):
    """``slow_fence@fence`` is enacted at the port's read-back: the plane's
    clock sleeps ``value`` seconds there."""
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    monkeypatch.setenv("KT_FAULTS", "slow_fence@fence:at=1:value=7.5")
    solver = TpuSolver(device="cpu")
    monkeypatch.delenv("KT_FAULTS")
    slept = []
    solver._faults.clock.sleep = slept.append
    st = tensorize([PodSpec(name=f"p{i}", requests={"cpu": 1.0})
                    for i in range(8)],
                   [Provisioner(name="default").with_defaults()],
                   generate_catalog(full=False))
    out = solver.solve(st)
    assert slept == [7.5] and not out.result.infeasible
    assert solver._faults.stats()["site_calls"] == {"dispatch": 1,
                                                    "fence": 1}


def test_unset_plane_is_the_null_plane(monkeypatch):
    from karpenter_tpu_torch import faults
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    monkeypatch.delenv("KT_FAULTS", raising=False)
    assert TpuSolver(device="cpu")._faults is faults.NULL_PLANE
