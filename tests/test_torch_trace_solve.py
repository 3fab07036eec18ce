"""The device solve traced from inside, on the CPU: ``device_enqueue`` and
``device_readback`` inside ``device_execute``, the group step's
``step.*`` parts covering the enqueue, the scheduler's host stages
(``harden``, ``route``, ``ladder``, ``relax_gate``, ``gang_gate``),
collector pauses as ``gc`` spans (``obs/trace.py`` ``gc_spans``), the
span cap holding a traced request whole, and the benchmark's readers of
those spans.

Both the port's own ``Trace`` and a duck shaped like the benchmark's
``ReqTrace`` (``span``, ``record``, ``now``, ``annotate`` and nothing
else) are handed to ``BatchScheduler.solve``.  Plans with tracing on
equal plans with it off.  Tolerance: equal.
"""

from __future__ import annotations

import gc
import threading
import time
from pathlib import Path

import pytest
import torch

from karpenter_tpu_torch.metrics import Registry
from karpenter_tpu_torch.models import labels as L
from karpenter_tpu_torch.models.catalog import generate_catalog
from karpenter_tpu_torch.models.instancetype import GIB
from karpenter_tpu_torch.models.pod import (
    LabelSelector,
    PodSpec,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.models.provisioner import Provisioner
from karpenter_tpu_torch.obs import trace as trace_mod
from karpenter_tpu_torch.obs.trace import MAX_SPANS_PER_TRACE, Tracer
from karpenter_tpu_torch.solver import scheduler as sched_mod
from karpenter_tpu_torch.solver.scheduler import BatchScheduler

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
#: the span cap before the group step's parts were traced
OLD_CAP = 512
#: spans per group step at most: rows, caps x2, seed x2, alloc, place,
#: count, four fills, and the picks and writes of the creation rounds
#: (four each per zone and one more round unzoned, three for the seeds)
STEP_SPANS_MAX = 12 + 8 * (3 + 1) + 3


class DuckTrace:
    """The benchmark's ``ReqTrace`` in shape: every span the program opens
    or records, as ``(name, t0, t1, attrs)`` on ``perf_counter``, under a
    non-reentrant lock; ``on_add`` runs inside that lock."""

    def __init__(self, on_add=None) -> None:
        self.spans: list = []
        self._lock = threading.Lock()
        self.on_add = on_add

    def __bool__(self) -> bool:
        return True

    def now(self) -> float:
        return time.perf_counter()

    def span(self, name: str, **attrs):
        return _DuckSpan(self, name)

    def record(self, name: str, t0: float, t1: float, **attrs):
        self.add(name, t0, t1, attrs)
        return _DuckSpan(self, name)

    def annotate(self, **attrs) -> None:
        return None

    def add(self, name, t0, t1, attrs=None) -> None:
        with self._lock:
            if self.on_add is not None:
                self.on_add()
            self.spans.append((name, t0, t1, attrs or {}))


class _DuckSpan:
    def __init__(self, trace: DuckTrace, name: str) -> None:
        self.trace, self.name, self.t0 = trace, name, 0.0

    def annotate(self, **attrs):
        return self

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.trace.add(self.name, self.t0, time.perf_counter())
        return False


def zone_spread_pods(deployments: int, replicas: int) -> list:
    """Config 2's shape, cut: ``deployments`` x ``replicas`` pods, each
    deployment a zone spread (maxSkew 1, DoNotSchedule) on its own
    selector."""
    pods = []
    for d in range(deployments):
        sel = LabelSelector.of({"app": f"d{d}"})
        for i in range(replicas):
            pods.append(PodSpec(
                name=f"d{d}-{i}", labels={"app": f"d{d}"},
                requests={"cpu": 0.25 * (1 + d % 8),
                          "memory": (0.5 + d % 6) * GIB},
                topology_spread=[TopologySpreadConstraint(
                    1, L.ZONE, "DoNotSchedule", sel)],
                owner_key=f"d{d}"))
    return pods


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


def duck_spans(trace: DuckTrace) -> list:
    return [(n, a, b) for n, a, b, _ in trace.spans]


def port_spans(trace) -> list:
    return [(sp.name, sp.t0, sp.t1) for sp in trace.spans()[1:]]


def covered(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + (b - a), b
        elif b > end:
            total, end = total + (b - end), b
    return total


def check_device_solve(spans: list) -> None:
    """Every enqueue and read-back lies inside a ``device_execute``; the
    two cover it; the ``step.*`` parts cover 90% of each enqueue, with a
    bounded number of spans per group step."""
    execs = [(a, b) for n, a, b in spans if n == "device_execute"]
    enqs = [(a, b) for n, a, b in spans if n == "device_enqueue"]
    backs = [(a, b) for n, a, b in spans if n == "device_readback"]
    assert execs and len(enqs) == len(backs) == len(execs)
    for a, b in enqs + backs:
        assert any(x <= a and b <= y for x, y in execs)
    for x, y in execs:
        inside = [(a, b) for a, b in enqs + backs if x <= a and b <= y]
        assert covered(inside) >= 0.9 * (y - x)
    steps = [(n, a, b) for n, a, b in spans if n.startswith("step.")]
    for x, y in enqs:
        mine = [(a, b) for _n, a, b in steps if x <= a and b <= y]
        assert covered(mine) >= 0.9 * (y - x)
    starts = sorted(a for n, a, _b in steps if n == "step.rows")
    assert starts
    per_step = [sum(1 for _n, a, _b in steps if s <= a < e)
                for s, e in zip(starts, starts[1:] + [float("inf")])]
    assert max(per_step) <= STEP_SPANS_MAX


def test_traced_solve_names_the_device_solve_from_inside(problem):
    provs, cat = problem
    pods = zone_spread_pods(5, 60)
    sched = BatchScheduler(backend="tpu", device="cpu")
    plain = canon(sched.solve(pods, provs, cat))
    duck = DuckTrace()
    traced = canon(sched.solve(pods, provs, cat, trace=duck))
    tracer = Tracer(registry=Registry(), enabled=True)
    with tracer.start("solve") as trace:
        port = canon(sched.solve(pods, provs, cat, trace=trace))
    assert traced == plain and port == plain
    for spans in (duck_spans(duck), port_spans(trace)):
        names = {n for n, _a, _b in spans}
        assert {"harden", "route", "ladder", "relax_gate", "gang_gate",
                "dispatch", "device_execute", "device_enqueue",
                "device_readback",
                "step.rows", "step.caps", "step.alloc", "step.fill",
                "step.place", "step.pick", "step.write",
                "step.count"} <= names
        check_device_solve(spans)
    by_id = {sp.span_id: sp for sp in trace.spans()}
    execute = next(sp for sp in by_id.values()
                   if sp.name == "device_execute")
    assert [c.name for c in execute.children] == ["device_enqueue",
                                                  "device_readback"]
    enqueue = execute.children[0]
    assert {c.name for c in enqueue.children} <= {
        "step.rows", "step.caps", "step.seed", "step.alloc", "step.place",
        "step.count"}


def test_async_dispatch_holds_enqueue_and_fence_holds_readback(problem):
    """``submit`` dispatches the first wave without reading it back: the
    enqueue and its step parts open inside ``device_dispatch``, the
    read-back inside ``device_fence``, each span keeping its extent."""
    provs, cat = problem
    pods = zone_spread_pods(3, 40)
    sched = BatchScheduler(backend="tpu", device="cpu")
    plain = canon(sched.solve(pods, provs, cat))
    duck = DuckTrace()
    assert canon(sched.submit(pods, provs, cat, trace=duck).result()) == plain
    spans = duck_spans(duck)

    def one(name):
        (got,) = [(a, b) for n, a, b in spans if n == name]
        return got

    (d0, d1), (e0, e1) = one("device_dispatch"), one("device_enqueue")
    (f0, f1), (r0, r1) = one("device_fence"), one("device_readback")
    assert d0 <= e0 and e1 <= d1 and f0 <= r0 and r1 <= f1 and d1 <= f0
    assert not any(n == "device_execute" for n, *_ in spans)
    steps = [(a, b) for n, a, b in spans if n.startswith("step.")]
    assert steps and all(e0 <= a and b <= e1 for a, b in steps)
    assert covered(steps) >= 0.9 * (e1 - e0)


def test_megabatch_enqueue_opens_no_step_spans(problem):
    """The megabatch callers of the group loop pass no trace: a flush
    records its ``megabatch`` span and no ``step.*`` part."""
    provs, cat = problem
    sched = BatchScheduler(backend="tpu", device="cpu")
    ducks = [DuckTrace(), DuckTrace()]
    pendings = sched.submit_many([
        dict(pods=zone_spread_pods(2, 20 + i), provisioners=provs,
             instance_types=cat, trace=d) for i, d in enumerate(ducks)])
    for p in pendings:
        p.result()
    for d in ducks:
        names = {n for n, *_ in d.spans}
        assert "megabatch" in names
        assert not any(n.startswith("step.") for n in names)


def test_forced_collection_inside_a_traced_request_is_a_gc_span(
        problem, monkeypatch):
    provs, cat = problem
    harden = sched_mod._harden_preferences
    fired = []

    def collecting(pod, keep=None):
        if not fired:
            fired.append(gc.collect())
        return harden(pod, keep)

    monkeypatch.setattr(sched_mod, "_harden_preferences", collecting)
    duck = DuckTrace()
    sched = BatchScheduler(backend="tpu", device="cpu")
    sched.solve(zone_spread_pods(2, 20), provs, cat, trace=duck)
    gcs = [(a, b, attrs) for n, a, b, attrs in duck.spans if n == "gc"]
    assert fired and gcs
    assert any(attrs.get("generation") == 2 for _a, _b, attrs in gcs)
    harden_span = next((a, b) for n, a, b, _ in duck.spans
                       if n == "harden")
    assert any(harden_span[0] <= a and b <= harden_span[1]
               for a, b, _ in gcs)
    assert getattr(trace_mod._gc_bound, "b", None) is None


def test_collection_on_the_guard_thread_is_a_gc_span(problem, monkeypatch):
    """Under ``auto`` the device call runs on the hang guard's thread,
    which the request binds too."""
    provs, cat = problem
    sched = BatchScheduler(backend="auto", device="cpu",
                           native_batch_limit=8)
    assert sched._guard.enabled
    solve = sched._tpu.solve
    callers = []

    def collecting(*args, **kwargs):
        callers.append(threading.current_thread().name)
        gc.collect()
        return solve(*args, **kwargs)

    monkeypatch.setattr(sched._tpu, "solve", collecting)
    duck = DuckTrace()
    sched.solve(zone_spread_pods(2, 20), provs, cat, trace=duck,
                relax=False)
    assert callers and callers[0] != threading.current_thread().name
    prepare = min(a for n, a, _b, _ in duck.spans if n == "device_prepare")
    assert any(n == "gc" and b <= prepare for n, _a, b, _ in duck.spans)


def test_collection_inside_the_traces_own_lock_completes(problem):
    """A collection fired while this thread holds the trace's
    non-reentrant lock (inside ``add``) must not wait on that lock: the
    hook stamps the pause without calling the trace, and the binding
    records it once the call returns."""
    provs, cat = problem
    left = [3]

    def collect_in_lock():
        if left[0] > 0:
            left[0] -= 1
            gc.collect()

    duck = DuckTrace(on_add=collect_in_lock)
    out: dict = {}

    def run():
        sched = BatchScheduler(backend="tpu", device="cpu")
        out["res"] = sched.solve(zone_spread_pods(2, 20), provs, cat,
                                 trace=duck)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "a collection inside the trace's lock hung"
    assert out["res"].assignments
    assert left[0] == 0
    assert sum(1 for n, *_ in duck.spans if n == "gc") >= 3


def test_untraced_request_records_nothing_and_binds_nothing(
        problem, monkeypatch):
    provs, cat = problem
    made = []
    binding = trace_mod._GcSpans

    def counting(*args):
        made.append(args)
        return binding(*args)

    monkeypatch.setattr(trace_mod, "_GcSpans", counting)
    for backend, limit in (("tpu", 256), ("auto", 8)):
        sched = BatchScheduler(backend=backend, device="cpu",
                               native_batch_limit=limit)
        res = sched.solve(zone_spread_pods(2, 20), provs, cat)
        assert res.assignments
        gc.collect()
    assert made == []
    assert getattr(trace_mod._gc_bound, "b", None) is None
    assert trace_mod.gc_spans(None) is trace_mod.NULL_SPAN
    assert trace_mod._gc_hook in gc.callbacks


def test_traced_request_at_the_new_cap_keeps_extract_and_reseat(problem):
    """A traced solve of 20 zone-spread deployments opens more spans than
    the old cap held; the cap now keeps the request whole."""
    provs, cat = problem
    tracer = Tracer(registry=Registry(), enabled=True)
    sched = BatchScheduler(backend="tpu", device="cpu")
    with tracer.start("solve") as trace:
        sched.solve(zone_spread_pods(20, 15), provs, cat, trace=trace)
    spans = trace.spans()
    names = {sp.name for sp in spans}
    assert len(spans) > OLD_CAP
    assert len(spans) < MAX_SPANS_PER_TRACE // 4
    assert "spans_dropped" not in trace.root.attrs
    assert {"extract", "reseat", "relax", "device_enqueue"} <= names


def test_span_cap_still_counts_dropped_spans():
    tracer = Tracer(registry=Registry(), enabled=True)
    with tracer.start("solve") as trace:
        for _ in range(MAX_SPANS_PER_TRACE + 10):
            with trace.span("x"):
                pass
        trace.record("gc", trace.now(), trace.now(), generation=0)
    assert len(trace.spans()) == MAX_SPANS_PER_TRACE
    assert trace.root.attrs["spans_dropped"] == 12


# ---------------------------------------------------------------------------
# the benchmark's readers of the new spans
# ---------------------------------------------------------------------------


def _run(requests):
    from benchmark import harness

    window = []
    for i, (t0, t1, spans, error) in enumerate(requests):
        rt = None
        if spans is not None:
            from benchmark.tracing import ReqTrace

            rt = ReqTrace()
            rt.spans = [(n, a, b, None) for n, a, b in spans]
            rt.t0, rt.t1 = t0, t1
        window.append(harness.Request(set=0, tag=str(i), pods=100, t0=t0,
                                      t1=t1, trace=rt, error=error))
    return harness.Run(window=window, window_s=10.0, setup_s=1.0)


#: two served requests and one failed one: [0, 1] and [2, 4] on the clock
REQUESTS = [
    (0.0, 1.0, [("dispatch", 0.0, 0.9), ("device_execute", 0.1, 0.8),
                ("device_enqueue", 0.1, 0.6), ("device_readback", 0.6, 0.8),
                ("step.fill", 0.2, 0.3), ("step.fill", 0.25, 0.35),
                ("gc", 0.95, 0.97), ("gc", 0.96, 1.2)], None),
    (2.0, 4.0, [("harden", 2.0, 2.5), ("device_enqueue", 2.5, 3.5),
                ("step.fill", 2.6, 2.7)], None),
    (5.0, 6.0, [("device_enqueue", 5.0, 6.0), ("gc", 5.0, 6.0),
                ("step.fill", 5.0, 6.0)], "boom"),
]
EXPECTED = {
    # (0.5 + 1.0) / 2 requests, ms
    "scan.enqueue_ms_per_solve": 750.0,
    "scan.readback_ms_per_solve": 100.0,
    # the union of the overlapping fills, 0.15 and 0.1 s
    "scan.fill_ms_per_solve": 125.0,
    # clipped to the request: 0.95..1.0
    "scheduler.gc_ms_per_solve": 25.0,
    # 1.0 - 0.95 covered (0..0.9, 0.95..1.0) and 2.0 - 1.5 covered
    "scheduler.unspanned_ms_per_solve": 275.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_reader_reads_known_spans(name):
    from benchmark import harness

    read = harness.reader(name)
    assert read(_run(REQUESTS)) == pytest.approx(EXPECTED[name])
    # a program that opens none of the span: nothing to read, no raise
    bare = [(t0, t1, [(n, a, b) for n, a, b in sp
                      if n in ("dispatch", "harden")], err)
            for t0, t1, sp, err in REQUESTS]
    if name == "scheduler.unspanned_ms_per_solve":
        assert read(_run(bare)) == pytest.approx(
            ((1.0 - 0.9) + (2.0 - 0.5)) / 2 * 1000.0)
    else:
        assert read(_run(bare)) is None
    assert read(_run([(0.0, 1.0, None, None)])) is None


def test_span_readers_are_listed_for_the_cell():
    from benchmark import harness

    man = harness.manifest(ROOT)
    per_layer = {m["name"]: m for m in man["per_layer"]}
    for name in EXPECTED:
        m = per_layer[name]
        assert m["workloads"] == ["zonespread-50k.burst"]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "ms", "lower", "program_span", "pods_per_s")
        assert (ROOT / "benchmark" / "metrics" / f"{name}.py").exists()
