"""The reference's battletest (``tests/test_battle.py``) over the port, on
the CPU.

- The seeded controller churn (``scripts/fuzz_sweep_torch.py``
  ``run_battle``: pod adds and deletes, ICE injections and clears, image
  publications and clock jumps, each followed by the provisioning,
  deprovisioning and termination reconciles under random delays, the
  invariants after every step, then a drain until every node is reaped)
  on ``backend="oracle"`` over both packages from reset name counters:
  at every step the same nodes (name, instance type, zone, capacity
  type), the same bindings and the same events.  Then on
  ``backend="tpu", device="cpu"``: the invariants after every step and
  every node reaped.
- The three coalescer races on the port's ``batcher.ThreadCoalescer``.
- The device churn once more with the port's lock sanitizer installed
  (``analysis/sanitize.py``): no ``SanitizerError``.

``KT_BATTLE_SEEDS`` (default 6) widens the sweep, as in the reference.
"""

import os
import sys
import threading

import pytest
import torch

from karpenter_tpu.solver.scheduler import BatchScheduler as RefScheduler
from karpenter_tpu_torch.analysis import sanitize
from karpenter_tpu_torch.batcher import (
    CoalescerTimeout,
    ThreadCoalescer,
    _Batch,
)
from karpenter_tpu_torch.models.catalog import generate_catalog
from scripts import fuzz_sweep_torch as fz

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_controllers import (  # noqa: E402
    PORT,
    REFERENCE,
    package,
    reset_counters,
)

torch.set_num_threads(1)

N_SEEDS = int(os.environ.get("KT_BATTLE_SEEDS", "6"))


@pytest.fixture(scope="module")
def catalogs():
    from karpenter_tpu.models.catalog import generate_catalog as ref_catalog

    return ref_catalog(full=False), generate_catalog(full=False)


def battle(root, seed, catalog, backend, **kw):
    """One churn seed over a package from reset name counters."""
    k = package(root)
    reset_counters(k)
    if root == REFERENCE:
        kw["make_scheduler"] = lambda reg: RefScheduler(
            backend=backend, registry=reg, compile_behind=False)
    else:
        kw.setdefault("device", "cpu")
    return fz.run_battle(seed, catalog, k=k, backend=backend, **kw)


def assert_clean(out):
    assert not out["problems"], out["problems"][:5]
    assert out["reaped"], f"seed {out['seed']}: {out['nodes_left']} " \
                          "nodes never reaped"
    assert out["max_nodes"] > 0 and out["pods_added"] > 0


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_randomized_controller_churn(seed, catalogs):
    """The churn on the oracle backend: the port and the reference agree
    at every step and every drain tick."""
    rcat, pcat = catalogs
    ref = battle(REFERENCE, seed, rcat, "oracle", trace=True)
    got = battle(PORT, seed, pcat, "oracle", trace=True)
    assert_clean(ref)
    assert_clean(got)
    assert len(got["snapshots"]) == len(ref["snapshots"])
    for a, b in zip(got["snapshots"], ref["snapshots"]):
        assert a["nodes"] == b["nodes"], f"step {a['step']}"
        assert a["bindings"] == b["bindings"], f"step {a['step']}"
        assert a["events"] == b["events"], f"step {a['step']}"


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_randomized_controller_churn_on_the_device_backend(seed, catalogs):
    """The churn on ``backend="tpu"`` on the host: every invariant after
    every step, every node reaped."""
    out = battle(PORT, seed, catalogs[1], "tpu")
    assert_clean(out)
    assert out["device"] == "cpu"


@pytest.fixture
def counted_sanitizer():
    """The port's sanitizer installed for one test; yields the messages of
    every ``SanitizerError`` constructed meanwhile."""
    raised = []
    base = sanitize.SanitizerError

    class Counted(base):
        def __init__(self, *args):
            raised.append(str(args[0]) if args else "")
            super().__init__(*args)

    pre = sanitize.installed()
    sanitize.SanitizerError = Counted
    sanitize.install()
    try:
        yield raised
    finally:
        if not pre:
            sanitize.uninstall()
        sanitize.SanitizerError = base


def test_device_churn_under_the_sanitizer(counted_sanitizer, catalogs):
    assert sanitize.installed()
    out = battle(PORT, 0, catalogs[1], "tpu")
    assert_clean(out)
    assert counted_sanitizer == []


class TestCoalescerRace:
    def test_concurrent_leaders_count_exactly(self):
        """Many threads across many buckets: every request served exactly
        once, per-bucket fan-out intact, counters consistent."""
        served = []
        lock = threading.Lock()

        def execute(reqs):
            with lock:
                served.extend(reqs)
            return [("ok", r * 2) for r in reqs]

        co = ThreadCoalescer(execute, idle_seconds=0.001)
        results = {}
        res_lock = threading.Lock()

        def worker(i):
            val = co.call(f"bucket-{i % 7}", i)
            with res_lock:
                results[i] = val

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(200)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(served) == list(range(200))           # exactly once
        assert all(results[i] == i * 2 for i in range(200))  # right fan-out
        assert co.requests_served == 200                    # no lost counts
        assert co.batch_count <= 200

    def test_executor_exception_fans_out_and_recovers(self):
        calls = {"n": 0}

        def execute(reqs):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("backend down")
            return [("ok", r) for r in reqs]

        co = ThreadCoalescer(execute, idle_seconds=0.0)
        with pytest.raises(RuntimeError):
            co.call("k", 1)
        assert co.call("k", 2) == 2  # coalescer usable after failure

    def test_follower_times_out_on_dead_leader(self):
        """A follower whose leader died between registering the bucket and
        publishing results raises a distinguishable error."""
        co = ThreadCoalescer(lambda reqs: [("ok", r) for r in reqs],
                             idle_seconds=0.0, follower_timeout=0.05)
        dead = _Batch()
        dead.reqs.append("leader-req")
        co._buckets["k"] = dead
        with pytest.raises(CoalescerTimeout):
            co.call("k", "follower-req")
        # the dead batch was unregistered: the bucket is usable again
        assert co.call("k", "fresh") == "fresh"
