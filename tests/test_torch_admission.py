"""The port's admission control against the reference package's, on the
CPU: ``admission/policy.py`` (classes, token buckets, quotas),
``queue.py`` (the bounded priority queue), ``breaker.py`` (the device-path
circuit breaker), ``brownout.py`` (the queue-delay ladder) and
``AdmissionControl``, then the shed and deadline outcomes of a
``SolvePipeline`` with admission on.

Every scenario is ONE function over a package namespace, run on both
packages under each package's own ``FakeClock``, and the logs compared:
states, levels, allow/shed decisions, typed errors (class, reason), the
admission metric series.  Tolerance: equal.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"
MODULES = {
    "admission": "admission", "policy": "admission.policy",
    "queue": "admission.queue", "breaker": "admission.breaker",
    "brownout": "admission.brownout", "metrics": "metrics",
    "clock": "utils.clock", "server": "service.server",
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


def series(reg, name, kind="counter"):
    fam = getattr(reg, kind)(name)
    return {lk: v for lk, v in fam.values.items()}


def typed(err) -> tuple:
    return (type(err).__name__, getattr(err, "pclass", None),
            getattr(err, "reason", None))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ("KT_ADMISSION", "KT_DEFAULT_PRIORITY_CLASS",
                 "KT_DEFAULT_DEADLINE_MS", "KT_ADMIT_QUEUE_TOTAL",
                 "KT_BROWNOUT_MS", "KT_BROWNOUT_ALPHA",
                 "KT_BROWNOUT_SLOT_CAP", "KT_FAULTS"):
        monkeypatch.delenv(name, raising=False)


def test_vocabulary_matches_reference():
    ref, port = package(REFERENCE), package(PORT)
    for name in ("PRIORITY_CLASSES", "SHED_REASONS", "HOST_ROUTE_REASONS",
                 "CRITICAL", "BATCH", "BEST_EFFORT", "CLOSED", "OPEN",
                 "HALF_OPEN", "MAX_LEVEL"):
        assert getattr(port.admission, name) == getattr(ref.admission, name)
    for raw in ("critical", "CRITICAL", " batch ", "best-effort",
                "best_effort", "", "bogus"):
        assert port.policy.parse_class(raw) == ref.policy.parse_class(raw)
    for c in port.admission.PRIORITY_CLASSES:
        assert port.policy.rank(c) == ref.policy.rank(c)


@pytest.mark.parametrize("env", [
    {}, {"KT_ADMIT_QUEUE_TOTAL": "5", "KT_ADMIT_CRITICAL_CONCURRENCY": "2",
         "KT_ADMIT_RATE": "3", "KT_DEFAULT_DEADLINE_MS": "250"}],
    ids=["defaults", "env"])
def test_policy_from_env_matches_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref, port = both(lambda k: k.policy.AdmissionPolicy.from_env())
    assert (port.max_queue_total, port.default_deadline_s) == \
        (ref.max_queue_total, ref.default_deadline_s)
    assert {c: vars(q) for c, q in port.quotas.items()} == \
        {c: vars(q) for c, q in ref.quotas.items()}


def limiter_run(k) -> list:
    clock = k.clock.FakeClock()
    lim = k.policy.RateLimiter(rate=2.0, burst=3.0, clock=clock)
    out = []
    for dt in (0, 0, 0, 0, 0.2, 0.3, 0.5, 0, 2.0, 0, 0, 0, 0):
        clock.advance(dt)
        out.append(lim.allow())
    return out


def test_rate_limiter_matches_reference():
    ref, port = both(limiter_run)
    assert port == ref


def breaker_run(k) -> dict:
    """Failures to open, the open interval to half-open, probes, a
    re-open on a half-open failure, the counter feeds (a hang delta, a
    latched-unhealthy gauge, degraded-solve bursts) and recovery."""
    M = k.metrics
    clock = k.clock.FakeClock(50.0)
    reg = M.Registry()
    trans = []
    b = k.breaker.CircuitBreaker(
        failure_threshold=3, open_interval_s=10.0, half_open_probes=2,
        recovery_window_s=5.0, clock=clock, registry=reg,
        on_transition=trans.append)
    log = []

    def snap(tag, *extra):
        log.append((tag, b.state, clock.now(), *extra))

    b.poll()
    for _ in range(2):
        b.record_failure("device_hang")
    snap("two failures", b.allow())
    b.record_success()
    b.record_failure()
    b.record_failure()
    snap("reset streak", b.allow())
    b.record_failure()
    snap("opened", b.allow())
    clock.advance(9.9)
    snap("still open", b.allow())
    clock.advance(0.2)
    snap("half open", [b.allow() for _ in range(3)])
    b.record_failure("probe failed")
    snap("reopened", b.allow())
    clock.advance(10.0)
    snap("half open again", b.allow(), b.allow())
    b.record_success()
    b.record_success()
    snap("closed by probes", b.allow())
    # counter feeds
    reg.counter(M.SOLVER_DEVICE_HANGS).inc()
    b.poll()
    snap("hang delta opens")
    clock.advance(10.0)
    snap("after interval", b.allow())
    reg.gauge(M.SOLVER_DEVICE_HEALTHY).set(0)
    b.poll()
    snap("unhealthy reopens")
    reg.gauge(M.SOLVER_DEVICE_HEALTHY).set(1)
    clock.advance(10.0)
    snap("half open", b.allow())
    clock.advance(5.0)
    b.poll()
    snap("clean window closes")
    for i in range(3):
        reg.counter(M.SOLVER_DEGRADED_SOLVES).inc({"backend": "native"},
                                                  value=4)
        b.poll()
        snap(f"degraded burst {i}")
    return dict(log=log, trans=trans,
                counts=series(reg, M.ADMISSION_BREAKER_TRANSITIONS),
                gauge=series(reg, M.ADMISSION_BREAKER_STATE, "gauge"))


def test_breaker_sequence_matches_reference():
    ref, port = both(breaker_run)
    assert port == ref
    assert port["trans"].count("open") >= 3


def brownout_run(k) -> dict:
    """The EWMA climbing the rungs under long waits, the overlays at each
    level, time-based idle decay, a live retune, and the disabled
    ladder."""
    M = k.metrics
    clock = k.clock.FakeClock()
    reg = M.Registry()
    bo = k.brownout.BrownoutController(step_s=0.5, alpha=0.5, slot_cap=2,
                                       registry=reg, clock=clock)
    log = []

    def snap(tag):
        log.append((tag, bo.level, round(bo.ewma_s, 12), bo.max_wait(0.02),
                    bo.slot_cap(8), [bo.route_to_host(c) for c in
                                     ("critical", "batch", "best_effort")],
                    [bo.shed(c) for c in ("critical", "batch",
                                          "best_effort")]))

    for w in (0.1, 0.6, 1.2, 2.0, 4.0, 8.0, 8.0, 8.0):
        bo.observe(w)
        snap(f"wait {w}")
    for dt in (0.05, 0.1, 0.5, 1.0, 3.0):
        clock.advance(dt)
        bo.idle(clock.now())
        snap(f"idle {dt}")
    bo.retune(step_s=0.25)
    snap("retuned step")
    bo.retune(slot_cap=4)
    snap("retuned cap")
    off = k.brownout.BrownoutController(step_s=0.0, registry=reg,
                                        clock=clock)
    off.observe(100.0)
    log.append(("disabled", off.enabled, off.level, off.slot_cap(8)))
    return dict(log=log, level=series(reg, M.ADMISSION_BROWNOUT_LEVEL,
                                      "gauge"))


def test_brownout_sequence_matches_reference():
    ref, port = both(brownout_run)
    assert port == ref
    assert max(entry[1] for entry in port["log"][:8]) == \
        package(PORT).admission.MAX_LEVEL


def queue_run(k) -> list:
    """Class ordering, FIFO within a class, per-class depth quotas,
    preemption of the newest lowest class by a higher arrival at the total
    bound, the gate, drain."""
    A = k.admission
    clock = k.clock.FakeClock()
    policy = A.AdmissionPolicy(
        quotas={A.BEST_EFFORT: A.ClassQuota(max_queue_depth=2)},
        max_queue_total=4)
    depths = []
    q = k.queue.AdmissionQueue(policy, clock=clock,
                               on_depth=lambda c, d: depths.append((c, d)))
    log = []

    def put(item, pclass, gate=None):
        t, reason, pre = q.put(item, pclass, deadline=clock.now() + 1.0,
                               gate=gate)
        log.append(("put", item, None if t is None else t.item, reason,
                    [v.item for v in pre]))

    put("be1", A.BEST_EFFORT)
    put("be2", A.BEST_EFFORT)
    put("be3", A.BEST_EFFORT)                 # class depth quota
    put("b1", A.BATCH)
    put("c1", A.CRITICAL)                     # total bound: preempts be2
    put("c2", A.CRITICAL, gate=lambda: "rate_limited")
    put("b2", A.BATCH)                        # preempts be1
    put("c3", A.CRITICAL)                     # preempts b2 (newest batch)
    put("c4", A.CRITICAL)                     # nothing below critical left
    clock.advance(2.0)
    while True:
        t = q.get(timeout=0)
        if t is None:
            break
        log.append(("get", t.item, t.pclass, t.expired(clock.now())))
    put("late", A.BATCH)
    log.append(("drain", [t.item for t in q.drain()], len(q)))
    log.append(("depths", depths))
    return log


def test_queue_sequence_matches_reference():
    ref, port = both(queue_run)
    assert port == ref


def control_run(k) -> dict:
    """``AdmissionControl`` end to end on a FakeClock: every shed reason
    (queue_full, rate_limited, concurrency, deadline, preempted,
    brownout), inline admission, pickup with queue-delay accounting and
    deadline expiry, host routing by breaker and by brownout, stats."""
    A, M = k.admission, k.metrics
    clock = k.clock.FakeClock(10.0)
    reg = M.Registry()
    policy = A.AdmissionPolicy(
        quotas={A.BEST_EFFORT: A.ClassQuota(max_queue_depth=1,
                                            max_concurrency=3),
                A.BATCH: A.ClassQuota(rate=1.0, burst=2.0)},
        max_queue_total=3, default_deadline_s=5.0)
    shed_log = []
    adm = A.AdmissionControl(
        policy=policy, registry=reg, clock=clock,
        breaker=A.CircuitBreaker(open_interval_s=3.0, clock=clock,
                                 registry=reg),
        brownout=A.BrownoutController(step_s=1.0, alpha=1.0, slot_cap=2,
                                      registry=reg, clock=clock),
        on_shed=lambda t, exc: shed_log.append((t.item, typed(exc))))
    log = []
    tickets = {}

    def admit(item, pclass, deadline_s=None):
        try:
            tickets[item] = adm.admit(item, pclass, deadline_s=deadline_s)
            log.append(("admit", item, "ok"))
        except A.SolveShedError as err:
            log.append(("admit", item, typed(err)))

    admit("be1", A.BEST_EFFORT)
    admit("be2", A.BEST_EFFORT)               # queue_full (depth 1)
    admit("b1", A.BATCH)
    admit("b2", A.BATCH)
    admit("b3", A.BATCH)                      # rate_limited
    admit("c1", A.CRITICAL, deadline_s=0.0)   # expired on arrival
    admit("c2", A.CRITICAL, deadline_s=0.5)   # preempts be1
    clock.advance(1.0)
    for _ in range(3):
        t = adm.get(timeout=0)
        if t is None:
            break
        wait = adm.observe_dispatch(t)
        if t.expired(clock.now()):
            log.append(("expired", t.item, typed(adm.expire(t))))
        else:
            log.append(("dispatch", t.item, wait, adm.route_host(t.pclass)))
        adm.release(t)
    try:
        inline = adm.admit_inline(A.BEST_EFFORT, deadline_s=None)
        log.append(("inline", inline.pclass))
        adm.release(inline)
    except A.SolveShedError as err:
        log.append(("inline", typed(err)))
    # concurrency quota: three in flight, the fourth is shed
    held = [adm.admit_inline(A.BEST_EFFORT) for _ in range(3)]
    try:
        adm.admit_inline(A.BEST_EFFORT)
    except A.SolveShedError as err:
        log.append(("inline4", typed(err)))
    for t in held:
        adm.release(t)
    # brownout: long waits push the ladder to its shed rung
    for _ in range(4):
        adm.brownout.observe(9.0)
    log.append(("brownout", adm.brownout.level,
                adm.route_host(A.BEST_EFFORT), adm.route_host(A.CRITICAL)))
    admit("be3", A.BEST_EFFORT)               # brownout shed
    clock.advance(20.0)
    adm.observe_idle()
    # the breaker opens on a hang and routes every class to the host
    reg.counter(M.SOLVER_DEVICE_HANGS).inc()
    adm.observe_idle()
    log.append(("breaker", adm.breaker.state, adm.route_host(A.CRITICAL),
                adm.route_host(A.BATCH)))
    log.append(("stats", adm.stats()))
    log.append(("drain", [t.item for t in adm.drain()]))
    return dict(
        log=log, shed_log=shed_log,
        admitted=series(reg, M.ADMISSION_ADMITTED),
        shed=series(reg, M.ADMISSION_SHED),
        routed=series(reg, M.ADMISSION_HOST_ROUTED),
        depth=series(reg, M.ADMISSION_QUEUE_DEPTH, "gauge"),
        delay=(dict(reg.histogram(M.ADMISSION_QUEUE_DELAY).totals),
               dict(reg.histogram(M.ADMISSION_QUEUE_DELAY).sums)))


def test_admission_control_sequence_matches_reference():
    ref, port = both(control_run)
    assert port == ref
    reasons = {e[2][2] for e in port["log"]
               if e[0] == "admit" and e[2] != "ok"}
    reasons |= {s[1][2] for s in port["shed_log"]}
    assert {"queue_full", "rate_limited", "deadline", "preempted",
            "brownout"} <= reasons


class BlockingScheduler:
    """A scheduler facade whose solve blocks until released: the queue
    fills behind it deterministically.  Returns the pod names it served."""

    backend = "oracle"

    def __init__(self, result_type) -> None:
        self.gate = threading.Event()
        self.served = []
        self.result_type = result_type

    def submit(self, pods, provisioners, instance_types, **kw):
        self.gate.wait(30.0)
        self.served.append(pods[0])
        result = self.result_type(nodes=[], assignments={pods[0]: "n"},
                                  infeasible={})

        class Done:
            def result(self_inner):
                return result
        return Done()


def pipeline_run(k) -> dict:
    """Admission in a ``SolvePipeline``: a blocker holds the dispatcher;
    behind it the queue (total 3, best_effort depth 1) sheds, preempts and
    lets a deadline expire before pickup (FakeClock); the blocker's
    release serves the rest in class order."""
    A, M = k.admission, k.metrics
    from_types = importlib.import_module(f"{k.root}.solver.types")
    clock = k.clock.FakeClock(100.0)
    reg = M.Registry()
    sched = BlockingScheduler(from_types.SolveResult)
    adm = A.AdmissionControl(
        policy=A.AdmissionPolicy(
            quotas={A.BEST_EFFORT: A.ClassQuota(max_queue_depth=1)},
            max_queue_total=3),
        registry=reg, clock=clock)
    pipe = k.server.SolvePipeline(sched, registry=reg, clock=clock,
                                  admission=adm, max_slots=1)
    outcomes = {}

    def call(name, pclass, deadline_s=None):
        try:
            pipe.solve(dict(pods=[name], provisioners=[],
                            instance_types=[]),
                       pclass=pclass, deadline_s=deadline_s)
            outcomes[name] = "ok"
        except A.SolveShedError as err:
            outcomes[name] = typed(err)

    threads = []

    def until(cond, what):
        deadline = time.monotonic() + 10.0
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"timed out waiting for {what}")
            time.sleep(0.002)

    def start(name, pclass, until_cond, deadline_s=None):
        t = threading.Thread(target=call, args=(name, pclass, deadline_s))
        t.start()
        threads.append(t)
        until(until_cond, name)

    try:
        start("blocker", A.BATCH, lambda: bool(pipe._in_hand))
        start("be1", A.BEST_EFFORT, lambda: len(adm.queue) == 1)
        start("be2", A.BEST_EFFORT, lambda: "be2" in outcomes)  # queue_full
        start("b1", A.BATCH, lambda: len(adm.queue) == 2, deadline_s=1.0)
        start("c1", A.CRITICAL, lambda: len(adm.queue) == 3)
        start("c2", A.CRITICAL, lambda: "be1" in outcomes)  # preempts be1
        clock.advance(5.0)                             # b1's deadline passes
        sched.gate.set()
        for t in threads:
            t.join(10.0)
    finally:
        sched.gate.set()
        pipe.stop()
    return dict(outcomes=outcomes, served=sched.served,
                shed=series(reg, M.ADMISSION_SHED),
                admitted=series(reg, M.ADMISSION_ADMITTED))


def test_pipeline_shed_and_deadline_outcomes_match_reference():
    ref, port = both(pipeline_run)
    assert port == ref
    assert port["outcomes"]["be2"][2] == "queue_full"
    assert port["outcomes"]["be1"][2] == "preempted"
    assert port["outcomes"]["b1"] == ("SolveDeadlineError", "batch",
                                      "deadline")
    assert port["served"] == ["blocker", "c1", "c2"]


def test_host_routing_uses_an_oracle_on_the_pipelines_device():
    """Breaker-open routing takes the host tier: an oracle scheduler on the
    serving scheduler's device (never a default-device build, which would
    need the card)."""
    from karpenter_tpu_torch.admission import AdmissionControl
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.service.server import SolvePipeline
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    reg = Registry()
    sched = BatchScheduler(backend="tpu", device="cpu", registry=reg)
    pipe = SolvePipeline(sched, registry=reg,
                         admission=AdmissionControl(registry=reg))
    try:
        host = pipe._host_scheduler()
        assert host.backend == "oracle" and host.device == sched.device
    finally:
        pipe.stop()


def hang_through_breaker(k) -> dict:
    """``KT_FAULTS="device_hang@fence:at=1"`` set while a fresh ``auto``
    scheduler is built; a pipeline with admission on over it serves the
    300-pod batch six times."""
    import os

    M, A = k.metrics, k.admission
    B = importlib.import_module(f"{k.root}.solver.scheduler")
    P = importlib.import_module(f"{k.root}.models.pod")
    PR = importlib.import_module(f"{k.root}.models.provisioner")
    C = importlib.import_module(f"{k.root}.models.catalog")
    reg = M.Registry()
    kw = (dict(compile_behind=False) if k.root == REFERENCE
          else dict(device="cpu"))
    os.environ["KT_FAULTS"] = "device_hang@fence:at=1"
    try:
        sched = B.BatchScheduler(backend="auto", registry=reg, **kw)
    finally:
        os.environ.pop("KT_FAULTS", None)
    sched._guard.probe_interval_s = 0.25
    trans = []
    breaker = A.CircuitBreaker(open_interval_s=30.0, registry=reg,
                               on_transition=trans.append)
    pipe = k.server.SolvePipeline(sched, registry=reg, admission=A.
                                  AdmissionControl(registry=reg,
                                                   breaker=breaker))
    pods = [P.PodSpec(name=f"p{i}", requests={"cpu": 0.5}, owner_key="d")
            for i in range(300)]
    kwargs = dict(pods=pods, instance_types=C.generate_catalog(full=False),
                  provisioners=[PR.Provisioner(name="default")
                                .with_defaults()])
    try:
        served = []
        for _ in range(6):
            served.append(len(pipe.solve(dict(kwargs)).assignments))
            time.sleep(0.15)
    finally:
        pipe.stop()
    return dict(
        served=served, transitions=trans,
        hangs=reg.counter(M.SOLVER_DEVICE_HANGS).get(),
        routed=sum(reg.counter(M.ADMISSION_HOST_ROUTED).values.values()))


def test_injected_hang_opens_the_port_breaker_only():
    """ROADMAP C4 (follows from C3): the port's guard latches on an
    injected hang and counts it, so its breaker opens and host-routes the
    requests after it; the reference's guard does neither and its breaker
    stays closed.  Every request is served whole in both."""
    ref, port = both(hang_through_breaker)
    assert ref["served"] == port["served"] == [300] * 6
    assert (ref["transitions"], ref["hangs"], ref["routed"]) == ([], 0, 0)
    assert port["transitions"] == ["open"] and port["hangs"] == 1
    assert port["routed"] >= 1
