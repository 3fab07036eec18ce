"""The port's knob registry and feedback controller against the reference
package's, on the CPU: ``tuning/knobs.py`` (``KnobSpec``, ``Knobs``,
``global_knobs``) and ``tuning/controller.py`` (``TuningController``).

Every scenario is ONE function over a package namespace (the same module
aliases for ``karpenter_tpu`` and ``karpenter_tpu_torch``), run on both
under each package's own ``FakeClock`` with the same seeded traffic, and
the logs compared: registry reads, lattice steps, refusals, every
controller decision (knob, outcome, reason, values), the tuning metric
series.  Tolerance: equal.

The port routes the hierarchical threshold and the relax iteration budget
through the registry as the reference does (``hier_threshold``,
``configured_iters``): env workflows are unchanged until a knob is set.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"
MODULES = {
    "knobs": "tuning.knobs", "controller": "tuning.controller",
    "tuning": "tuning", "metrics": "metrics", "clock": "utils.clock",
    "timeseries": "obs.timeseries", "slo": "obs.slo",
}
_PACKAGES = {}


def package(root: str) -> SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = SimpleNamespace(root=root, **{
            alias: importlib.import_module(f"{root}.{path}")
            for alias, path in MODULES.items()})
    return _PACKAGES[root]


def both(fn, *args):
    """``fn`` over each package; returns (reference's, port's)."""
    return fn(package(REFERENCE), *args), fn(package(PORT), *args)


@pytest.fixture(autouse=True)
def _clean_knob_env(monkeypatch):
    for env in package(PORT).knobs.KNOB_ENVS:
        monkeypatch.delenv(env, raising=False)
    monkeypatch.delenv("KT_TUNE_FREEZE", raising=False)
    monkeypatch.delenv("KT_TUNE", raising=False)
    monkeypatch.delenv("KT_TUNE_INTERVAL_S", raising=False)


def test_relax_lattice_mirrors_the_port_rungs():
    from karpenter_tpu.tuning.knobs import RELAX_ITER_LATTICE as ref_lattice
    from karpenter_tpu_torch.solver import relax
    from karpenter_tpu_torch.tuning.knobs import RELAX_ITER_LATTICE

    assert tuple(RELAX_ITER_LATTICE) == tuple(relax.RELAX_ITER_RUNGS)
    assert tuple(RELAX_ITER_LATTICE) == tuple(ref_lattice)


@pytest.mark.parametrize("name", [s.name for s in package(PORT).knobs.SPECS])
def test_knob_spec_matches_reference(name):
    ref = {s.name: s for s in package(REFERENCE).knobs.SPECS}[name]
    port = {s.name: s for s in package(PORT).knobs.SPECS}[name]
    assert (port.env, port.cast, port.default, port.lattice, port.doc) == \
        (ref.env, ref.cast, ref.default, ref.lattice, ref.doc)


def test_specs_and_envs_match_reference():
    ref, port = package(REFERENCE).knobs, package(PORT).knobs
    assert [s.name for s in port.SPECS] == [s.name for s in ref.SPECS]
    assert port.KNOB_ENVS == ref.KNOB_ENVS
    assert package(PORT).controller.DEFAULT_TUNED == \
        package(REFERENCE).controller.DEFAULT_TUNED


def registry_log(k, env: dict) -> list:
    """Reads, writes, refusals and lattice steps of one fresh registry,
    with ``env`` applied around the call-time reads."""
    import os

    log = []
    saved = {e: os.environ.get(e) for e in env}
    os.environ.update(env)
    try:
        knobs = k.knobs.Knobs(frozen=frozenset())
        log.append(("snap", dict(knobs.snapshot().values)))
        for name in ("max_slots", "max_wait_ms", "hier_threshold",
                     "relax_iters", "brownout_ms", "inline_delta"):
            log.append(("step", name, knobs.step(name, +1),
                        knobs.step(name, -1)))
        log.append(("set", knobs.set("max_slots", 16),
                    knobs.set("max_slots", 3), knobs.set("nope", 1)))
        log.append(("update", knobs.update(max_wait_ms=5.0, max_slots=3),
                    knobs.update(max_wait_ms=5.0, max_slots=32)))
        log.append(("hier", knobs.set("hier_threshold", 2000),
                    knobs.set("hier_threshold", 25_000),
                    knobs.get("hier_threshold")))
        knobs.freeze("brownout_ms")
        log.append(("frozen", knobs.set("brownout_ms", 500.0),
                    knobs.update(brownout_ms=500.0, max_slots=8)))
        knobs.thaw("brownout_ms")
        log.append(("thawed", knobs.set("brownout_ms", 500.0)))
        snap = knobs.snapshot()
        log.append(("snap", dict(snap.values), sorted(snap.overridden),
                    snap.version))
        knobs.reset("hier_threshold")
        log.append(("reset", knobs.get("hier_threshold"), knobs.version))
        log.append(("describe", knobs.describe()))
        knobs.reset()
        log.append(("cleared", dict(knobs.snapshot().values)))
    finally:
        for e, v in saved.items():
            if v is None:
                os.environ.pop(e, None)
            else:
                os.environ[e] = v
    return log


@pytest.mark.parametrize("env", [
    {},
    {"KT_MAX_SLOTS": "24", "KT_HIER_THRESHOLD": "2000",
     "KT_RELAX_ITERS": "100", "KT_DELTA_INLINE": "0"},
    {"KT_MAX_WAIT_MS": "not-a-number", "KT_BROWNOUT_MS": "750"},
], ids=["defaults", "off_lattice_env", "bad_env"])
def test_registry_sequence_matches_reference(env):
    ref, port = both(registry_log, env)
    assert port == ref


def controller_run(k, seed: int) -> dict:
    """A seeded closed loop under FakeClock: each second the served count
    and latency depend on the live knobs; the sampler ticks every second,
    the controller decides every 5 s; a burst of critical sheds
    (seconds 120–140) must freeze it.  Returns every decision and the
    tuning series."""
    clock = k.clock.FakeClock(1000.0)
    reg = k.metrics.Registry()
    sampler = k.timeseries.Sampler(reg, clock=clock, interval_s=1.0,
                                   capacity=900)
    slo = k.slo.SloEngine(reg, sampler=sampler, clock=clock, replica="r0")
    knobs = k.knobs.Knobs(frozen=frozenset())
    ctl = k.controller.TuningController(
        knobs, reg, sampler=sampler, slo=slo, interval_s=5.0)
    sampler.add_hook(ctl.on_tick)
    rng = np.random.default_rng(seed)
    classes = ("critical", "batch", "best_effort")
    for t in range(240):
        slots = int(knobs.get("max_slots"))
        wait = float(knobs.get("max_wait_ms"))
        served = int(20 + 2 * min(slots, 16) - wait / 5.0
                     + rng.integers(0, 4))
        for i in range(served):
            slo.record(classes[i % 3], "ok",
                       solve_ms=float(40 + 3 * slots + wait
                                      + rng.integers(0, 30)))
        if 120 <= t < 140:
            for _ in range(3):
                slo.record("critical", "shed")
        clock.advance(1.0)
        sampler.tick()
    steps = reg.counter(k.metrics.TUNING_STEPS)
    return dict(
        decisions=list(ctl.decisions),
        steps={lk: v for lk, v in steps.values.items() if v},
        values=dict(reg.gauge(k.metrics.TUNING_KNOB_VALUE).values),
        knobs=dict(knobs.snapshot().values),
        tunez={key: val for key, val in ctl.tunez().items()
               if key != "decisions"})


@pytest.mark.parametrize("seed", [3, 11])
def test_controller_decisions_match_reference(seed):
    ref, port = both(controller_run, seed)
    assert port["decisions"] == ref["decisions"]
    assert port["steps"] == ref["steps"]
    assert port["values"] == ref["values"]
    assert port["knobs"] == ref["knobs"]
    assert port["tunez"] == ref["tunez"]
    outcomes = {d["outcome"] for d in port["decisions"]}
    assert "applied" in outcomes and "frozen" in outcomes


def test_zero_init_matches_reference():
    def series(k):
        reg = k.metrics.Registry()
        k.controller.zero_init(reg)
        return (dict(reg.counter(k.metrics.TUNING_STEPS).values),
                dict(reg.gauge(k.metrics.TUNING_KNOB_VALUE).values),
                sorted(reg.histograms))

    ref, port = both(series)
    assert port == ref


def test_thresholds_read_through_the_registry(monkeypatch):
    """The port's ``hier_threshold()`` and ``configured_iters()`` answer
    as the reference's do: the env while the knob is unset, the knob once
    set, the env again after a reset."""
    from karpenter_tpu.solver import hierarchy as ref_hier
    from karpenter_tpu.solver import relax as ref_relax
    from karpenter_tpu.tuning.knobs import global_knobs as ref_knobs
    from karpenter_tpu_torch.solver import hierarchy, relax
    from karpenter_tpu_torch.tuning.knobs import global_knobs

    def read():
        return ((hierarchy.hier_threshold(), relax.configured_iters()),
                (ref_hier.hier_threshold(), ref_relax.configured_iters()))

    port, ref = read()
    assert port == ref == (100_000, 64)
    monkeypatch.setenv("KT_HIER_THRESHOLD", "2000")
    monkeypatch.setenv("KT_RELAX_ITERS", "128")
    port, ref = read()
    assert port == ref == (2000, 128)
    try:
        for knobs in (global_knobs(), ref_knobs()):
            assert knobs.set("hier_threshold", 50_000)
            assert knobs.set("relax_iters", 32)
        port, ref = read()
        assert port == ref == (50_000, 32)
    finally:
        for knobs in (global_knobs(), ref_knobs()):
            knobs.reset()
    port, ref = read()
    assert port == ref == (2000, 128)
    monkeypatch.setenv("KT_HIER_THRESHOLD", "bad")
    port, ref = read()
    assert port == ref == (100_000, 128)


def test_knob_moves_hierarchical_routing():
    """A runtime ``set`` reroutes the port's scheduler: the same batch
    routes flat at the default threshold and hierarchically once the
    knob sits at or below its size."""
    from karpenter_tpu_torch.metrics import HIER_SOLVES, Registry
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.tuning.knobs import global_knobs

    reg = Registry()
    sched = BatchScheduler(backend="tpu", device="cpu", registry=reg)
    pods = [PodSpec(name=f"d{d}-{i}", labels={"app": f"d{d}"},
                    requests={"cpu": 0.25 * (1 + d % 4)}, owner_key=f"d{d}")
            for d in range(25) for i in range(1000)]
    provs = [Provisioner(name="default").with_defaults()]
    catalog = generate_catalog(full=False)
    hier = reg.counter(HIER_SOLVES)
    assert sched._route_hier(pods, (), True, None) is False
    knobs = global_knobs()
    try:
        assert not knobs.set("hier_threshold", 2000)  # off the lattice
        assert knobs.set("hier_threshold", 25_000)
        assert sched._route_hier(pods, (), True, None) is True
        res = sched.solve(pods, provs, catalog)
    finally:
        knobs.reset("hier_threshold")
    assert hier.get({"path": "hierarchical"}) == 1
    assert len(res.assignments) == len(pods) and not res.infeasible
    assert sched._route_hier(pods, (), True, None) is False
