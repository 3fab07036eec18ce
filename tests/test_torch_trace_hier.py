"""The hierarchical solve traced from inside, on the CPU: the spans
``solver/hierarchy.py`` opens around its parts (``hier.partition``,
``hier.entries``, ``hier.wave``, ``hier.price``, ``hier.merge``,
``hier.repair``, ``hier.tail``), and inside each block wave the batched
dispatch named as the flat solve names its own: ``device_execute`` holding
``device_enqueue`` (covered by the group step's ``step.*`` parts) and
``device_readback``, then one ``extract`` per block.  Then the benchmark's
readers of those spans and of its histograms.

The benchmark's own ``ReqTrace`` and the port's ``Trace`` are handed to
``BatchScheduler.solve`` (``tpu`` and ``auto``); the waves run on the
hang guard's thread.  Plans with tracing on equal plans with it off.
Tolerance: equal.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

import chip_smoke as cs
from benchmark import harness
from benchmark.tracing import ReqTrace
from karpenter_tpu_torch.metrics import Registry
from karpenter_tpu_torch.models.catalog import generate_catalog
from karpenter_tpu_torch.models.provisioner import Provisioner
from karpenter_tpu_torch.obs.trace import Tracer
from karpenter_tpu_torch.solver.scheduler import BatchScheduler
from scripts import hier_demo_torch as hd

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ND, PER = 8, 250
#: the hierarchical spans, in the order a solve opens them first
STAGES = ("hier.partition", "hier.entries", "hier.wave", "hier.price",
          "hier.merge", "hier.repair", "hier.tail")


@pytest.fixture(autouse=True)
def hier_at_batch_size(monkeypatch):
    monkeypatch.setenv("KT_HIER_THRESHOLD", str(ND * PER))


@pytest.fixture(scope="module")
def problem():
    return ([Provisioner(name="default").with_defaults()],
            generate_catalog(full=False))


def canon(res) -> tuple:
    """The plan without node names: each pod's (type, zone, capacity
    type, co-residents), the infeasible pods and the cost."""
    by_node = {n.name: (n.instance_type, n.zone, n.capacity_type,
                        tuple(sorted(p.name for p in n.pods)))
               for n in res.nodes}
    return ({p: by_node.get(n) for p, n in res.assignments.items()},
            sorted(res.infeasible), round(res.new_node_cost, 6))


def covered(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + (b - a), b
        elif b > end:
            total, end = total + (b - end), b
    return total


def inside(spans, a, b, name=None) -> list:
    return [(n, x, y) for n, x, y in spans
            if x >= a and y <= b and (name is None or n == name)]


def check_waves(spans: list, blocks: list) -> None:
    """Each ``hier.wave`` holds one ``device_execute`` with its enqueue and
    read-back, the group step's parts covering 90% of the enqueue, and
    then one ``extract`` per block of the wave."""
    waves = [(a, b) for n, a, b in spans if n == "hier.wave"]
    assert len(waves) == len(blocks)
    for (a, b), n_blocks in zip(sorted(waves), blocks):
        (_, x, y), = inside(spans, a, b, "device_execute")
        (_, e0, e1), = inside(spans, x, y, "device_enqueue")
        (_, r0, r1), = inside(spans, x, y, "device_readback")
        assert e1 <= r0
        steps = [(s, t) for n, s, t in inside(spans, e0, e1)
                 if n.startswith("step.")]
        assert covered(steps) >= 0.9 * (e1 - e0)
        extracts = inside(spans, a, b, "extract")
        assert len(extracts) == n_blocks
        assert all(s >= y for _n, s, _t in extracts)


@pytest.mark.parametrize("backend", ["tpu", "auto"])
def test_free_solve_names_every_stage_and_plans_as_untraced(problem,
                                                            backend):
    """Every wave runs on the hang guard's thread; its spans still land on
    the request's trace, inside ``hier.wave``."""
    provs, cat = problem
    pods = cs.deployments(ND, PER, tag="tf")
    sched = BatchScheduler(backend=backend, device="cpu")
    assert sched._guard.enabled
    plain = canon(sched.solve(pods, provs, cat))
    rt = ReqTrace()
    assert canon(sched.solve(pods, provs, cat, trace=rt)) == plain
    sched.stop_warms()
    stats = sched.hier_stats
    assert stats["blocks"] == ND and stats["price_iters"] == 0
    spans = [(n, a, b) for n, a, b, _ in rt.spans]
    names = [n for n, *_ in sorted(rt.spans, key=lambda s: s[1])]
    firsts = [names.index(s) for s in STAGES]
    assert firsts == sorted(firsts), names
    # the hierarchical stages do not overlap one another
    tops = sorted((a, b) for n, a, b in spans if n in STAGES)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(tops, tops[1:]))
    check_waves(spans, [ND])
    # nothing to repair: the stage opens and re-seats nothing
    (_, a, b), = [s for s in spans if s[0] == "hier.repair"]
    assert [n for n, *_ in inside(spans, a, b)] == ["hier.repair"]
    # the tail repack re-enters the flat solve, which names its own parts
    (_, a, b), = [s for s in spans if s[0] == "hier.tail"]
    assert {"tensorize", "device_execute", "extract"} <= {
        n for n, *_ in inside(spans, a, b)}


def test_the_port_trace_holds_the_hierarchy_stages(problem):
    """The port's own ``Trace``: every stage, within its span cap.  The
    wave runs on the hang guard's thread, whose spans the trace roots at
    the request (its open-span stacks are per thread); they lie inside
    ``hier.wave`` on the clock, the dispatch's tree as the flat solve's."""
    provs, cat = problem
    pods = cs.deployments(ND, PER, tag="tp")
    sched = BatchScheduler(backend="tpu", device="cpu")
    plain = canon(sched.solve(pods, provs, cat))
    tracer = Tracer(registry=Registry(), enabled=True)
    with tracer.start("solve") as trace:
        assert canon(sched.solve(pods, provs, cat, trace=trace)) == plain
    assert "spans_dropped" not in trace.root.attrs
    spans = trace.spans()[1:]
    assert set(STAGES) <= {sp.name for sp in spans}
    check_waves([(sp.name, sp.t0, sp.t1) for sp in spans], [ND])
    wave = next(sp for sp in spans if sp.name == "hier.wave")
    execute = next(sp for sp in spans if sp.name == "device_execute"
                   and wave.t0 <= sp.t0 and sp.t1 <= wave.t1)
    assert [c.name for c in execute.children] == ["device_enqueue",
                                                  "device_readback"]
    assert {c.name for c in execute.children[0].children} <= {
        "step.rows", "step.caps", "step.seed", "step.alloc", "step.place",
        "step.count"}


def test_contended_solve_traces_price_waves_and_repair(problem):
    """Under a cpu limit at 99% of the free buy the price loop re-solves
    the contending blocks and the repair re-seats the evicted nodes' pods:
    ``hier.price`` per iteration, one ``hier.wave`` per wave, and the
    repair's flat solve inside ``hier.repair``."""
    provs, cat = problem
    pods = hd.deployments(ND, PER, tag="tc")
    sched = BatchScheduler(backend="tpu", device="cpu")
    free = sched.solve(pods, provs, cat)
    lim = hd.limited(round(hd.bought_cpu(sched, pods, provs, cat,
                                         free.nodes) * 0.99, 1))
    plain = canon(sched.solve(pods, [lim], cat))
    rt = ReqTrace()
    assert canon(sched.solve(pods, [lim], cat, trace=rt)) == plain
    stats = sched.hier_stats
    assert stats["price_iters"] >= 1 and stats["repair_pods"] > 0
    spans = [(n, a, b) for n, a, b, _ in rt.spans]
    prices = [s for s in spans if s[0] == "hier.price"]
    assert len(prices) >= stats["price_iters"]
    waves = sorted((a, b) for n, a, b in spans if n == "hier.wave")
    blocks = [ND] + [len(inside(spans, a, b, "extract"))
                     for a, b in waves[1:]]
    check_waves(spans, blocks)
    assert len(waves) == stats["waves"]
    (_, a, b), = [s for s in spans if s[0] == "hier.repair"]
    assert inside(spans, a, b, "device_execute")


# ---------------------------------------------------------------------------
# the benchmark's readers of the hierarchical spans and histograms
# ---------------------------------------------------------------------------


def _reader(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "test_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(requests, hist=None):
    window = []
    for i, (t0, t1, spans) in enumerate(requests):
        rt = None
        if spans is not None:
            rt = ReqTrace()
            rt.spans = [(n, a, b, None) for n, a, b in spans]
            rt.t0, rt.t1 = t0, t1
        window.append(harness.Request(set=0, tag=str(i), pods=100, t0=t0,
                                      t1=t1, trace=rt))
    return harness.Run(window=window, window_s=10.0, setup_s=1.0,
                       hist_delta=hist or {})


#: two served requests: [0, 4] and [5, 9] on the clock
REQS = [(0.0, 4.0, [("hier.partition", 0.0, 0.5), ("hier.entries", 0.5, 1.0),
                    ("hier.wave", 1.0, 2.5), ("hier.merge", 2.5, 3.0),
                    ("hier.repair", 3.0, 3.0), ("hier.tail", 3.0, 4.0)]),
        (5.0, 9.0, [("hier.partition", 5.0, 5.25),
                    ("hier.entries", 5.25, 5.5), ("hier.wave", 5.5, 7.0),
                    ("hier.price", 7.0, 7.25), ("hier.entries", 7.25, 7.5),
                    ("hier.wave", 7.5, 8.0), ("hier.merge", 8.0, 8.5),
                    ("hier.repair", 8.5, 8.75), ("hier.tail", 8.75, 9.0)])]


def test_span_readers_sum_the_hierarchy_spans_per_request():
    run = _run(REQS)
    assert _reader("hier.wave_ms_per_solve")(run) == pytest.approx(1750.0)
    assert _reader("hier.tail_ms_per_solve")(run) == pytest.approx(625.0)
    assert _reader("hier.repair_ms_per_solve")(run) == pytest.approx(125.0)
    # partition, entries and merge, the price loop's entries included
    assert _reader("hier.host_ms_per_solve")(run) == pytest.approx(
        (1.5 + 1.25) / 2 * 1000.0)


@pytest.mark.parametrize("name", ["hier.wave_ms_per_solve",
                                  "hier.tail_ms_per_solve",
                                  "hier.repair_ms_per_solve",
                                  "hier.host_ms_per_solve"])
def test_span_readers_say_nothing_without_the_spans(name):
    """A program that opens no ``hier.*`` span (an older program, or
    a batch the flat route served) reads None, and does not raise."""
    flat = [(0.0, 1.0, [("tensorize", 0.0, 0.5)]), (2.0, 3.0, None)]
    assert _reader(name)(_run(flat)) is None


def test_counter_readers_need_every_request_on_the_route():
    dur = "karpenter_solver_hier_duration_seconds"
    pods = "karpenter_solver_hier_repair_pods"
    hist = {dur: (3.0, 2), pods: (7.0, 2)}
    run = _run(REQS, hist)
    assert _reader("hier.ms_per_solve")(run) == pytest.approx(1500.0)
    assert _reader("hier.repair_pods_per_solve")(run) == pytest.approx(3.5)
    # one of the two requests left the route: no reading
    short = _run(REQS, {dur: (1.5, 1), pods: (0.0, 1)})
    assert _reader("hier.ms_per_solve")(short) is None
    assert _reader("hier.repair_pods_per_solve")(short) is None
    # the route never taken, or the histograms absent
    for h in ({dur: (0.0, 0), pods: (0.0, 0)}, {}):
        assert _reader("hier.ms_per_solve")(_run(REQS, h)) is None
        assert _reader("hier.repair_pods_per_solve")(_run(REQS, h)) is None
