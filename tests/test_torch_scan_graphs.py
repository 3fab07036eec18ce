"""The group loop's graph cache (``solver/scan_graphs.py``) as a host unit.

A stand-in takes the place of ``torch.cuda.CUDAGraph``: what the loop does
while the stand-in "captures" is recorded as closures over the static
tensors, and a replay runs them again, as a CUDA graph replays its
kernels against the buffers it captured.  So the cache's own logic runs
here whole: the signature key, first sight eager, second sight captured
while captures cost one eager run and later where they cost more, replay
after, least-recently-used eviction at the bound, inputs copied
into the static buffers, outputs cloned off the static outputs, the
replay histogram, the kernel-entry launches a replay adds, and a
concurrent stress on shared keys.  ``TpuSolver`` on host tensors never
consults the cache.  The captures themselves run on the card
(``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import sys
import threading

import pytest
import torch

from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.metrics import INVENTORY, SCAN_GRAPH_REPLAYS, Registry
from karpenter_tpu_torch.obs.trace import Tracer
from karpenter_tpu_torch.solver import scan_graphs as sg
from karpenter_tpu_torch.solver.scheduler import BatchScheduler
from karpenter_tpu_torch.solver.tpu import TpuSolver

torch.set_num_threads(1)

_CAPTURING = threading.local()


@pytest.fixture(autouse=True)
def _launch_counts():
    """The kernel-entry counters are the process's: leave them at 0."""
    yield
    kernels.reset_counts()


class StandInGraph:
    """``capture_begin`` / ``capture_end`` / ``replay`` over host tensors:
    the operations the loop records while this thread captures run again
    at every replay."""

    made = 0

    def __init__(self) -> None:
        StandInGraph.made += 1
        self.ops: list = []
        self.modes: list = []
        self.replays = 0

    def capture_begin(self, capture_error_mode: str = "global") -> None:
        self.modes.append(capture_error_mode)
        _CAPTURING.graph = self

    def capture_end(self) -> None:
        _CAPTURING.graph = None

    def replay(self) -> None:
        self.replays += 1
        for op in self.ops:
            op()


def op(fn) -> None:
    """Run ``fn`` now, and at every replay of the graph capturing it."""
    graph = getattr(_CAPTURING, "graph", None)
    if graph is not None:
        graph.ops.append(fn)
    fn()


class Loop:
    """A group loop of host operations only, counting its calls: carry =
    (init[0] + counts * scale, init[1]), ys = counts * 2, and one
    ``skew_band_fill`` launch counted per run."""

    def __init__(self, fail: bool = False) -> None:
        self.calls = 0
        self.fail = fail

    def __call__(self, consts, init):
        self.calls += 1
        if self.fail:
            raise RuntimeError("operation not permitted when capturing")
        a = torch.empty_like(init[0])
        ys = torch.empty_like(consts["counts"])
        op(lambda: a.copy_(init[0] + consts["counts"] * consts["scale"]))
        op(lambda: ys.copy_(consts["counts"] * 2))
        kernels.SKEW_BAND_FILL.count_launch()
        return (a, init[1]), ys


def inputs(value: float, B: int = 2, G: int = 3):
    consts = {"counts": torch.full((B, G), value),
              "scale": torch.full((1, G), 10.0).expand(B, G)}
    init = (torch.full((B, G), value + 1), torch.zeros(B, 1, dtype=torch.int32))
    return consts, init


def expected(value: float, B: int = 2, G: int = 3):
    return torch.full((B, G), value + 1 + 10 * value), torch.full(
        (B, G), 2 * value)


FLAGS = {n: [False, True, False] for n in sg.FLAG_NAMES}


def still(capacity: int, new_graph=StandInGraph, registry=None):
    """A cache whose clock stands still: it measures no capture, so every
    key is captured at its second sight."""
    return sg.ScanGraphs(capacity, new_graph, registry, clock=lambda: 0.0)


def key_of(consts, init, track=True, flags=FLAGS):
    return sg.scan_key(consts, init, track, flags)


def replay_obs(reg) -> tuple:
    h = reg.histogram(SCAN_GRAPH_REPLAYS)
    return sum(h.sums.values()), sum(h.totals.values())


# ---- the key ---------------------------------------------------------------


def test_the_key_separates_what_the_loop_launches():
    consts, init = inputs(1.0)
    base = key_of(consts, init)
    assert key_of(*inputs(7.0)) == base            # values: not in the key
    assert key_of(*inputs(1.0, B=4)) != base       # a shape
    c2 = dict(consts, counts=consts["counts"].to(torch.float64))
    assert key_of(c2, init) != base                # a dtype
    i2 = (init[0], init[1].to(torch.int64))
    assert key_of(consts, i2) != base              # a carry dtype
    assert key_of(consts, init, track=False) != base
    for name in sg.FLAG_NAMES:
        flipped = dict(FLAGS, **{name: [True, True, False]})
        assert key_of(consts, init, flags=flipped) != base
    meta = ({k: torch.empty(v.shape, device="meta") for k, v in
             consts.items()},
            tuple(torch.empty(t.shape, dtype=t.dtype, device="meta")
                  for t in init))
    assert key_of(*meta) != base                   # the device
    # the key takes no trace: tracing does not change what is launched
    assert "trace" not in sg.scan_key.__code__.co_varnames


def test_a_stride_zero_input_keys_as_its_dense_shape():
    consts, init = inputs(1.0)
    dense = dict(consts, scale=consts["scale"].contiguous())
    assert key_of(dense, init) == key_of(consts, init)


# ---- sights ----------------------------------------------------------------


def test_eager_at_first_sight_captured_at_the_second_replayed_after():
    reg = Registry()
    made = StandInGraph.made
    cache = still(4, StandInGraph, reg)
    loop = Loop()
    tracer = Tracer(registry=Registry(), enabled=True)
    names = []
    for v in (1.0, 2.0, 3.0, 4.0):
        consts, init = inputs(v)
        with tracer.start("solve") as trace:
            (a, n), ys = cache.run(key_of(consts, init), consts, init, loop,
                                   trace)
        names.append([s for s in trace.span_names()
                      if s.startswith("scan.")])
        want_a, want_ys = expected(v)
        assert torch.equal(a, want_a) and torch.equal(ys, want_ys)
        assert torch.equal(n, init[1])
    assert loop.calls == 2             # the eager run and the capture
    assert StandInGraph.made == made + 1
    assert cache.graphs() == 1 and cache.seen() == 0
    assert names == [[], ["scan.capture"], ["scan.replay"], ["scan.replay"]]
    assert replay_obs(reg) == (2.0, 4)


def test_a_capture_is_thread_local_and_replays_at_once():
    graphs = []

    def new_graph():
        graphs.append(StandInGraph())
        return graphs[-1]

    cache = still(4, new_graph)
    loop = Loop()
    for v in (1.0, 2.0):
        consts, init = inputs(v)
        cache.run(key_of(consts, init), consts, init, loop)
    assert graphs[0].modes == ["thread_local"]
    assert graphs[0].replays == 1


def test_replays_read_the_new_inputs_and_never_overwrite_a_result():
    """Results handed back are copies: a later replay of the same graph
    (another request's inputs) leaves an unread earlier result whole."""
    cache = still(4, StandInGraph)
    loop = Loop()
    outs = []
    for v in (1.0, 2.0, 5.0, 9.0):
        consts, init = inputs(v)
        outs.append(cache.run(key_of(consts, init), consts, init, loop))
    for v, ((a, _n), ys) in zip((1.0, 2.0, 5.0, 9.0), outs):
        want_a, want_ys = expected(v)
        assert torch.equal(a, want_a) and torch.equal(ys, want_ys)
    entry = next(iter(cache._graphs.values()))
    carry, ys = entry.out
    assert all(x.data_ptr() != carry[0].data_ptr() for (x, _), _y in outs)
    # a stride-0 input was materialised into its static buffer
    assert entry.consts["scale"].is_contiguous()
    assert entry.consts["scale"].stride() != inputs(1.0)[0]["scale"].stride()


def test_one_off_keys_run_eagerly_and_are_never_captured():
    reg = Registry()
    cache = still(4, StandInGraph, reg)
    loop = Loop()
    for B in range(1, 4):
        consts, init = inputs(1.0, B=B)
        cache.run(key_of(consts, init), consts, init, loop)
    assert loop.calls == 3 and cache.graphs() == 0 and cache.seen() == 3
    assert replay_obs(reg) == (0.0, 3)


class Clock:
    """A host clock the test moves: a second a loop run, four more a
    ``SlowCapture`` capture."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def test_a_costly_capture_defers_the_next_keys_capture():
    """A capture measured at five times its loop's issue: the next key is
    captured once its eager runs pay the excess, at its fifth sight."""
    clock = Clock()

    class SlowCapture(StandInGraph):
        def capture_end(self) -> None:
            super().capture_end()
            clock.t += 4.0              # instantiating: four issues

    loop = Loop()

    def timed(consts, init):
        clock.t += 1.0
        return loop(consts, init)

    cache = sg.ScanGraphs(4, SlowCapture, clock=clock)

    def run(B):
        consts, init = inputs(float(B), B=B)
        return cache.run(key_of(consts, init), consts, init, timed)

    run(1), run(1)                      # the first capture: second sight
    assert cache.graphs() == 1 and cache.capture_runs == 5.0
    for sight in range(1, 5):
        run(2)
        assert cache.graphs() == 1, sight
    calls = loop.calls
    run(2)                              # four eager runs paid: captured
    assert cache.graphs() == 2 and loop.calls == calls + 1
    run(2)
    assert loop.calls == calls + 1      # replayed


# ---- bounds ----------------------------------------------------------------


def test_graphs_are_evicted_least_recently_used_at_the_bound():
    cache = still(2, StandInGraph)
    loop = Loop()

    def run(B):
        consts, init = inputs(float(B), B=B)
        return cache.run(key_of(consts, init), consts, init, loop)

    for B in (1, 1, 2, 2):         # two graphs: B=1 and B=2
        run(B)
    assert cache.graphs() == 2
    run(1)                          # B=1 is now the most recently used
    calls = loop.calls
    run(3), run(3)                  # B=3 captured: B=2 goes
    assert cache.graphs() == 2 and loop.calls == calls + 2
    keys = [k[2][0][1][0] for k in cache._graphs]
    assert keys == [1, 3]
    calls = loop.calls
    run(2)                          # evicted: a first sight again
    run(1)                          # still held: a replay
    assert loop.calls == calls + 1


def test_keys_seen_once_are_bounded_too():
    cache = still(2, StandInGraph)
    loop = Loop()
    for B in (1, 2, 3):
        consts, init = inputs(1.0, B=B)
        cache.run(key_of(consts, init), consts, init, loop)
    assert cache.seen() == 2
    consts, init = inputs(1.0, B=1)
    cache.run(key_of(consts, init), consts, init, loop)
    assert cache.graphs() == 0      # B=1 was forgotten: a first sight


def test_an_evicted_graph_is_retired():
    cache = still(1, StandInGraph)
    loop = Loop()
    for B in (1, 1):
        consts, init = inputs(1.0, B=B)
        cache.run(key_of(consts, init), consts, init, loop)
    first = next(iter(cache._graphs.values()))
    for B in (2, 2):
        consts, init = inputs(1.0, B=B)
        cache.run(key_of(consts, init), consts, init, loop)
    assert first.graph is None and first.out is None and not first.consts


def test_a_failed_capture_is_forgotten_and_raises():
    cache = still(4, StandInGraph)
    consts, init = inputs(1.0)
    key = key_of(consts, init)
    cache.run(key, consts, init, Loop())
    with pytest.raises(RuntimeError, match="capturing"):
        cache.run(key, consts, init, Loop(fail=True))
    assert cache.graphs() == 0 and cache.seen() == 0
    loop = Loop()
    cache.run(key, consts, init, loop)   # a first sight again: eager
    assert loop.calls == 1 and cache.seen() == 1


# ---- counts ----------------------------------------------------------------


def test_replays_add_the_fill_launches_their_capture_recorded():
    cache = still(4, StandInGraph)
    loop = Loop()
    per_run = []
    for v in (1.0, 2.0, 3.0, 4.0):
        consts, init = inputs(v)
        kernels.reset_counts()
        cache.run(key_of(consts, init), consts, init, loop)
        per_run.append(kernels.counts()["skew_band_fill"])
    assert per_run == [1, 1, 1, 1]


def test_a_tally_counts_its_own_thread_and_nests():
    with kernels.tally() as outer:
        kernels.WATER_FILL.count_launch()
        with kernels.tally() as inner:
            kernels.WATER_FILL.count_launch(2)
        t = threading.Thread(target=kernels.WATER_FILL.count_launch)
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert inner == {kernels.WATER_FILL: 2}
    assert outer == {kernels.WATER_FILL: 3}


def test_the_replay_histogram_is_in_the_inventory_and_born_at_a_loop():
    """The scheduler hands its registry to the cache, whose first loop
    makes the series: a host-only scheduler's registry has the
    reference's series and no other."""
    assert INVENTORY[SCAN_GRAPH_REPLAYS][0] == "histogram"
    reg = Registry()
    sched = BatchScheduler(backend="tpu", device="cpu", registry=reg)
    assert SCAN_GRAPH_REPLAYS not in reg.histograms
    consts, init = inputs(1.0)
    sched._tpu._scan_graphs.run(key_of(consts, init), consts, init, Loop())
    assert replay_obs(reg) == (0.0, 1)


# ---- the host path ---------------------------------------------------------


def test_host_solves_never_consult_the_cache(monkeypatch):
    """On host tensors the loop runs as it always did: the cache is not
    asked, not filled and observes nothing."""
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.instancetype import GIB
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.models.provisioner import Provisioner

    def refuse(*_a, **_k):
        raise AssertionError("the host loop consulted the graph cache")

    monkeypatch.setattr(sg.ScanGraphs, "run", refuse)
    monkeypatch.setattr(sg, "scan_key", refuse)
    reg = Registry()
    sched = BatchScheduler(backend="tpu", device="cpu", registry=reg)
    pods = [PodSpec(name=f"p{i}", requests={"cpu": 0.5, "memory": GIB})
            for i in range(12)]
    provs = [Provisioner(name="default").with_defaults()]
    cat = generate_catalog(full=False)
    for _ in range(3):
        res = sched.solve(pods, provs, cat)
        assert len(res.assignments) == 12
    assert sched._tpu._scan_graphs.graphs() == 0
    assert sched._tpu._scan_graphs.seen() == 0
    assert replay_obs(reg) == (0.0, 0)
    assert isinstance(TpuSolver(device="cpu")._scan_graphs, sg.ScanGraphs)


# ---- threads ---------------------------------------------------------------


def test_concurrent_callers_each_get_their_own_result():
    """Eight threads over three keys with a short switch interval: every
    result is its own inputs', and every run is observed once."""
    reg = Registry()
    cache = still(2, StandInGraph, reg)
    loop = Loop()
    errors: list = []
    n_runs = 40

    def worker(w: int) -> None:
        try:
            for i in range(n_runs):
                B = 1 + (w + i) % 3
                v = float(w * 1000 + i)
                consts, init = inputs(v, B=B)
                (a, _n), ys = cache.run(key_of(consts, init), consts, init,
                                        loop)
                want_a, want_ys = expected(v, B=B)
                if not (torch.equal(a, want_a) and torch.equal(ys, want_ys)):
                    errors.append((w, i))
        except Exception as err:  # noqa: BLE001 — asserted below
            errors.append(err)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert replay_obs(reg)[1] == 8 * n_runs
    assert cache.graphs() <= 2
