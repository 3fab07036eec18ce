"""The port's lock sanitizer (``karpenter_tpu_torch/analysis/sanitize.py``)
on the port's own classes, on the CPU: the scenarios of the reference's
``tests/test_sanitize.py``.

1. **Violation detection** — two threads inside one object's
   non-reentrant section (``BatchScheduler.solve``,
   ``InflightQueue.push``) raise :class:`SanitizerError`; a thread handoff
   and a same-thread re-entry do not.
2. **The pipeline** — concurrent ``Solve`` RPCs through the port's
   ``SolverService`` under the sanitizer: one dispatcher thread, disjoint
   submit windows, each response carrying exactly its own pods.
3. **The lock-order watcher** — the port's ``LOCK_ORDER`` (a linear
   extension of its KT012 graph; ``BatchScheduler._mesh_serial_lock``
   where the reference has ``_cold_lock``): legal nestings are recorded,
   an inversion raises at the acquisition site and records nothing, every
   table row is a real lock and becomes a proxy.
4. **Wiring** — ``KT_SANITIZE=1`` installs the port's sanitizer at
   ``import karpenter_tpu_torch``; install is idempotent, uninstall
   restores.

No test asserts on wall-clock time.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from karpenter_tpu_torch.analysis import sanitize
from karpenter_tpu_torch.analysis.sanitize import SanitizerError
from karpenter_tpu_torch.batcher import InflightQueue
from karpenter_tpu_torch.metrics import Registry
from karpenter_tpu_torch.models.pod import PodSpec
from karpenter_tpu_torch.models.provisioner import Provisioner
from karpenter_tpu_torch.solver.scheduler import BatchScheduler
from karpenter_tpu_torch.solver.types import SolveResult

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GIB = 1024.0 ** 3


@pytest.fixture
def sanitizer():
    pre = sanitize.installed()
    sanitize.install()
    yield
    if not pre:
        sanitize.uninstall()


def scheduler(**kw):
    return BatchScheduler(backend="oracle", device="cpu",
                          registry=Registry(), **kw)


def batch(n=5, app="a"):
    return [PodSpec(name=f"{app}-{i}", labels={"app": app},
                    requests={"cpu": 0.5, "memory": GIB}, owner_key=app)
            for i in range(n)]


class TestViolationDetection:
    def test_concurrent_scheduler_solve_raises(self, sanitizer):
        sched = scheduler()
        gate, entered = threading.Event(), threading.Event()
        orig = sched._submit

        def stalled_submit(*a, **kw):
            entered.set()
            gate.wait(5)
            return orig(*a, **kw)

        sched._submit = stalled_submit
        outcome = {}
        t = threading.Thread(
            target=lambda: outcome.update(first=sched.solve([], [], [])))
        t.start()
        assert entered.wait(5)
        try:
            with pytest.raises(SanitizerError, match="cross-thread"):
                sched.solve([], [], [])
        finally:
            gate.set()
            t.join()
        assert isinstance(outcome["first"], SolveResult)

    def test_thread_handoff_is_legal(self, sanitizer):
        sched = scheduler()
        sched.solve([], [], [])
        err = []

        def other():
            try:
                sched.solve([], [], [])
            except Exception as e:  # surfaced by the assert below
                err.append(e)

        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert not err

    def test_concurrent_inflight_push_raises(self, sanitizer):
        gate, entered = threading.Event(), threading.Event()
        q = InflightQueue(depth=2, on_depth=lambda d: (entered.set(),
                                                       gate.wait(5)))
        t = threading.Thread(target=lambda: q.push("a"))
        t.start()
        assert entered.wait(5)
        try:
            with pytest.raises(SanitizerError, match="single-threaded"):
                q.push("b")
        finally:
            gate.set()
            t.join()
        assert list(q._q) == ["a"]

    def test_reentrant_same_thread_is_legal(self, sanitizer):
        sched = scheduler()
        inner = {}
        orig = sched._submit

        def reentering_submit(*a, **kw):
            if not inner.get("active"):
                inner["active"] = True
                inner["done"] = sched.solve([], [], [])
            return orig(*a, **kw)

        sched._submit = reentering_submit
        assert isinstance(sched.solve([], [], []), SolveResult)
        assert isinstance(inner["done"], SolveResult)

    def test_violation_rings_the_flight_recorder(self, sanitizer):
        from karpenter_tpu_torch.metrics import FLIGHT_DUMPS

        sched = scheduler()
        gate, entered = threading.Event(), threading.Event()
        orig = sched._submit

        def stalled_submit(*a, **kw):
            entered.set()
            gate.wait(5)
            return orig(*a, **kw)

        sched._submit = stalled_submit
        t = threading.Thread(target=lambda: sched.solve([], [], []))
        t.start()
        assert entered.wait(5)
        try:
            with pytest.raises(SanitizerError):
                sched.solve([], [], [])
        finally:
            gate.set()
            t.join()
        assert sched.registry.counter(FLIGHT_DUMPS).get(
            {"reason": "sanitizer_error"}) == 1


class TestPipeline:
    def test_concurrent_solve_rpcs_serialize(self, sanitizer):
        from karpenter_tpu_torch.models.catalog import generate_catalog
        from karpenter_tpu_torch.service import codec
        from karpenter_tpu_torch.service.server import SolverService

        record = []
        rec_lock = threading.Lock()

        class RecordingScheduler(BatchScheduler):
            def submit(self, *args, **kwargs):
                t0 = time.perf_counter()
                pending = super().submit(*args, **kwargs)
                time.sleep(0.01)  # widen the window a racer would hit
                with rec_lock:
                    record.append((threading.current_thread(), t0,
                                   time.perf_counter()))
                return pending

        reg = Registry()
        svc = SolverService(RecordingScheduler(
            backend="oracle", device="cpu", registry=reg), registry=reg)
        catalog = generate_catalog(full=False)
        prov = Provisioner(name="default").with_defaults()
        n = 6
        results, errors = {}, []

        def call(i):
            try:
                req = codec.encode_request(batch(5, f"g{i}"), [prov],
                                           catalog)
                results[i] = svc.Solve(req, None)
            except Exception as e:  # surfaced by the assert below
                errors.append((i, e))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        svc.close()
        assert not errors
        assert len(results) == n
        assert len({t.name for t, _, _ in record}) == 1
        assert record[0][0].name == "solve-pipeline"
        spans = sorted((t0, t1) for _, t0, t1 in record)
        for (_, end), (start, _) in zip(spans, spans[1:]):
            assert start >= end, "submit windows overlap: dispatch raced"
        for i, resp in results.items():
            assert set(resp.assignments.keys()) == {
                f"g{i}-{j}" for j in range(5)}
        edges = sanitize.observed_lock_edges()
        order = {n: i for i, n in enumerate(sanitize.LOCK_ORDER)}
        for outer, inner in edges:
            if outer in order and inner in order and outer != inner:
                assert order[outer] < order[inner], (outer, inner)


class TestLockOrderWatcher:
    def test_legal_nesting_passes_and_is_recorded(self, sanitizer):
        sched = scheduler()
        with sched._mesh_serial_lock:
            with sched._tpu._lock:
                pass
        assert ("BatchScheduler._mesh_serial_lock", "TpuSolver._lock") \
            in sanitize.observed_lock_edges()

    def test_inversion_raises_at_the_acquisition_site(self, sanitizer):
        sched = scheduler()
        with pytest.raises(SanitizerError, match="lock-order inversion"):
            with sched._tpu._lock:
                with sched._mesh_serial_lock:
                    pass
        with sched._mesh_serial_lock:
            with sched._tpu._lock:
                pass

    def test_inverted_acquisition_records_no_edge(self, sanitizer):
        sched = scheduler()
        with pytest.raises(SanitizerError, match="lock-order inversion"):
            with sched._tpu._lock:
                with sched._mesh_serial_lock:
                    pass
        assert ("TpuSolver._lock", "BatchScheduler._mesh_serial_lock") \
            not in sanitize.observed_lock_edges()

    def test_admission_gate_nesting_is_observed_in_order(self, sanitizer):
        from karpenter_tpu_torch.admission import AdmissionControl
        from karpenter_tpu_torch.admission.policy import (
            AdmissionPolicy,
            ClassQuota,
        )
        from karpenter_tpu_torch.utils.clock import FakeClock

        adm = AdmissionControl(
            policy=AdmissionPolicy(
                quotas={"batch": ClassQuota(rate=100.0, burst=10.0)}),
            registry=Registry(), clock=FakeClock())
        ticket = adm.admit(("item", None), "batch")
        adm.release(ticket)
        edges = sanitize.observed_lock_edges()
        assert ("AdmissionQueue._cond", "RateLimiter._lock") in edges
        order = {n: i for i, n in enumerate(sanitize.LOCK_ORDER)}
        for outer, inner in edges:
            if outer in order and inner in order and outer != inner:
                assert order[outer] < order[inner], (outer, inner)

    def test_condition_reentry_and_wait_survive_the_proxy(self, sanitizer):
        from karpenter_tpu_torch.admission.queue import AdmissionQueue
        from karpenter_tpu_torch.utils.clock import FakeClock

        q = AdmissionQueue(clock=FakeClock())
        ticket, reason, preempted = q.put(("x", None), "batch")
        assert reason is None and not preempted
        assert q.get(timeout=0.01) is ticket
        assert q.get(timeout=0.0) is None

    def test_deep_reentry_of_held_reentrant_lock_is_legal(self, sanitizer):
        from karpenter_tpu_torch.admission import CircuitBreaker
        from karpenter_tpu_torch.utils.clock import FakeClock

        br = CircuitBreaker(clock=FakeClock(), registry=Registry())
        sched = scheduler()
        with br._lock:
            with sched._mesh_serial_lock:
                with br._lock:
                    pass
        assert ("BatchScheduler._mesh_serial_lock", "CircuitBreaker._lock") \
            not in sanitize.observed_lock_edges()

    def test_reentry_on_top_does_not_mask_inversion_beneath(self, sanitizer):
        from karpenter_tpu_torch.admission import CircuitBreaker
        from karpenter_tpu_torch.utils.clock import FakeClock

        br = CircuitBreaker(clock=FakeClock(), registry=Registry())
        sched = scheduler()
        with pytest.raises(SanitizerError, match="lock-order inversion"):
            with br._lock:
                with sched._tpu._lock:
                    with br._lock:
                        with sched._mesh_serial_lock:
                            pass

    def test_uninstall_restores_plain_locks(self):
        pre = sanitize.installed()
        sanitize.install()
        sanitize.uninstall()
        try:
            sched = scheduler()
            assert type(sched._mesh_serial_lock).__name__ != "_OrderedLock"
            assert sanitize.observed_lock_edges() == set()
        finally:
            if pre:
                sanitize.install()

    def test_every_lock_order_entry_is_proxied(self, sanitizer):
        from karpenter_tpu_torch.admission import (
            AdmissionControl,
            CircuitBreaker,
            RateLimiter,
        )
        from karpenter_tpu_torch.batcher import ThreadCoalescer
        from karpenter_tpu_torch.operator import InMemoryLeaseStore, Operator
        from karpenter_tpu_torch.service.delta import DeltaSessionTable
        from karpenter_tpu_torch.service.server import (
            SolvePipeline,
            SolverService,
        )
        from karpenter_tpu_torch.solver.guard import DeviceGuard
        from karpenter_tpu_torch.utils.clock import FakeClock

        reg = Registry()
        sched = BatchScheduler(backend="oracle", device="cpu", registry=reg)
        seen = {
            "BatchScheduler._mesh_serial_lock": sched._mesh_serial_lock,
            "TpuSolver._lock": sched._tpu._lock,
            "DeviceGuard._lock": DeviceGuard()._lock,
        }
        adm = AdmissionControl(registry=reg, clock=FakeClock())
        seen["AdmissionControl._lock"] = adm._lock
        seen["AdmissionQueue._cond"] = adm.queue._cond
        seen["RateLimiter._lock"] = RateLimiter(rate=1.0,
                                                clock=FakeClock())._lock
        seen["CircuitBreaker._lock"] = adm.breaker._lock
        seen["ThreadCoalescer._lock"] = ThreadCoalescer(lambda r: [])._lock
        svc = SolverService(sched, registry=reg)
        seen["SolverService._direct_lock"] = svc._direct_lock
        pipe = SolvePipeline(sched, registry=reg, max_slots=1)
        seen["SolvePipeline._submit_lock"] = pipe._submit_lock
        seen["SolvePipeline._sched_lock"] = pipe._sched_lock
        seen["DeltaSessionTable._lock"] = DeltaSessionTable(
            registry=reg, clock=FakeClock())._lock
        seen["InMemoryLeaseStore._lock"] = InMemoryLeaseStore()._lock
        try:
            assert [n for n in sanitize.LOCK_ORDER if n in seen
                    and type(seen[n]).__name__ != "_OrderedLock"] == []
            assert [n for n in sanitize.LOCK_ORDER if n not in seen
                    and n != "Operator._reconcile_lock"] == []
        finally:
            pipe.stop()
        assert Operator in sanitize._init_originals

    def test_the_sanitizer_wraps_the_ports_classes_only(self, sanitizer):
        assert getattr(BatchScheduler.__dict__["solve"], "_kt_sanitized",
                       False)
        assert all(cls.__module__.startswith("karpenter_tpu_torch.")
                   for cls, _name in sanitize._originals)
        assert all(cls.__module__.startswith("karpenter_tpu_torch.")
                   for cls in sanitize._init_originals)


class TestWiring:
    def test_env_var_installs_at_package_import(self):
        env = dict(os.environ, KT_SANITIZE="1", PYTHONPATH=str(ROOT))
        out = subprocess.run(
            [sys.executable, "-c",
             "import sys\n"
             "import karpenter_tpu_torch\n"
             "from karpenter_tpu_torch.analysis import sanitize\n"
             "assert sanitize.installed()\n"
             "from karpenter_tpu_torch.solver.scheduler import "
             "BatchScheduler\n"
             "assert getattr(BatchScheduler.solve, '_kt_sanitized', False)\n"
             "assert 'karpenter_tpu' not in sys.modules\n"
             "assert 'jax' not in sys.modules\n"
             "print('sanitize-wired')\n"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr
        assert "sanitize-wired" in out.stdout

    def test_without_the_env_nothing_is_installed(self):
        env = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
        env["PYTHONPATH"] = str(ROOT)
        out = subprocess.run(
            [sys.executable, "-c",
             "import sys\n"
             "import karpenter_tpu_torch\n"
             "assert 'karpenter_tpu_torch.analysis.sanitize' "
             "not in sys.modules\n"
             "assert 'torch' not in sys.modules\n"
             "print('plain')\n"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr
        assert "plain" in out.stdout

    def test_install_is_idempotent_and_uninstall_restores(self):
        pre = sanitize.installed()
        sanitize.install()
        sanitize.install()
        fn = BatchScheduler.__dict__["solve"]
        assert getattr(fn, "_kt_sanitized", False)
        assert not getattr(sanitize._originals[(BatchScheduler, "solve")],
                           "_kt_sanitized", False)
        sanitize.uninstall()
        assert not sanitize.installed()
        assert not getattr(BatchScheduler.__dict__["solve"],
                           "_kt_sanitized", False)
        if pre:
            sanitize.install()
