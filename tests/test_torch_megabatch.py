"""The port's serving entry points against the reference package, on the CPU:
``TpuSolver.solve_many`` / ``solve_many_async`` / ``solve_async``, the
scheduler's ``submit`` / ``submit_many`` megabatch collector, bucket keys
and the bucket-grid warm (``precompile_buckets``).

One case per non-service case of ``tests/test_megabatch.py``, each built
twice from one description (the tenant batches below) — once with the
reference's models, once with the port's — and run as the reference's own
tests run it (``TpuSolver()`` / ``BatchScheduler(backend="tpu")`` compiling
inline).  Both packages' node-name counters are reset before each run
(coalescing orders candidates by ``(size, name)``).

Tolerance: equal node plans, assignments, infeasible sets and costs — the
tolerance of the reference's own megabatch tests — and, for the key
functions, equal tuples.

The reference's cold-rung case (``tests/test_megabatch.py:235``: a flush
whose slot-rung program is not compiled is served serially while the rung
compiles behind) has no counterpart: the port compiles nothing, so a new
rung is dispatched batched, and its results equal the reference's serial
ones (``test_new_rung_dispatches_batched``).
"""

import logging
import threading
import types

import pytest
import torch

import karpenter_tpu.metrics as ref_metrics
import karpenter_tpu.models.catalog as ref_catalog
import karpenter_tpu.models.labels as ref_labels
import karpenter_tpu.models.pod as ref_pod
import karpenter_tpu.models.provisioner as ref_prov
import karpenter_tpu.models.tensorize as ref_tensorize
import karpenter_tpu.solver.scheduler as ref_scheduler
import karpenter_tpu.solver.tpu as ref_tpu
import karpenter_tpu.solver.types as ref_types
import karpenter_tpu_torch.metrics as t_metrics
import karpenter_tpu_torch.models.catalog as t_catalog
import karpenter_tpu_torch.models.labels as t_labels
import karpenter_tpu_torch.models.pod as t_pod
import karpenter_tpu_torch.models.provisioner as t_prov
import karpenter_tpu_torch.models.tensorize as t_tensorize
import karpenter_tpu_torch.solver.scheduler as t_scheduler
import karpenter_tpu_torch.solver.tpu as t_tpu
import karpenter_tpu_torch.solver.types as t_types
from karpenter_tpu_torch.obs.trace import Tracer

torch.set_num_threads(1)

GIB = 1024.0 ** 3

REF = types.SimpleNamespace(
    name="ref", pod=ref_pod, prov=ref_prov, L=ref_labels, types=ref_types,
    tensorize=ref_tensorize, tpu=ref_tpu, scheduler=ref_scheduler,
    metrics=ref_metrics, catalog=ref_catalog)
PORT = types.SimpleNamespace(
    name="port", pod=t_pod, prov=t_prov, L=t_labels, types=t_types,
    tensorize=t_tensorize, tpu=t_tpu, scheduler=t_scheduler,
    metrics=t_metrics, catalog=t_catalog)

TENANTS = ("acme", "bravo", "cyan", "delta")


def reset_names() -> None:
    """Restart both packages' auto node-name counters."""
    for k in (REF, PORT):
        with k.types._node_lock:
            k.types._node_next = 0


def tenant_batch(k, tenant: str, n_groups: int = 4, per: int = 10,
                 spread: bool = True):
    """One tenant's pod batch (the reference test's ``tenant_batch``):
    tenants share shapes (one bucket) but carry disjoint pods, labels and
    requests."""
    shift = sum(ord(c) for c in tenant) % 5
    pods = []
    for gi in range(n_groups):
        sel = k.pod.LabelSelector.of({"app": f"{tenant}-g{gi}"})
        tsc = ([k.pod.TopologySpreadConstraint(1, k.L.ZONE, "DoNotSchedule",
                                               sel)]
               if spread else [])
        for i in range(per):
            pods.append(k.pod.PodSpec(
                name=f"{tenant}-g{gi}-{i}",
                labels={"app": f"{tenant}-g{gi}"},
                requests={"cpu": 0.25 * (1 + (gi + shift) % 6),
                          "memory": float(1 + (gi + shift) % 3) * GIB},
                topology_spread=list(tsc),
                owner_key=f"{tenant}-g{gi}",
            ))
    return pods


def plan(result):
    """Node-plan fingerprint, independent of the node-name counter."""
    return sorted(
        (n.instance_type, n.zone, n.capacity_type, round(n.price, 6),
         tuple(sorted(p.name for p in n.pods)))
        for n in result.nodes)


def assert_same_solve(a, b):
    assert plan(a) == plan(b)
    assert a.infeasible == b.infeasible
    assert set(a.assignments) == set(b.assignments)
    assert abs(a.new_node_cost - b.new_node_cost) < 1e-9


@pytest.fixture(scope="module")
def world():
    """Per package: its small catalog, default provisioner, a solver and
    the four tenants' tensors (module-scoped: the reference's jit cache
    serves every case from a few compiles)."""
    out = {}
    for k in (REF, PORT):
        catalog = k.catalog.generate_catalog(full=False)
        provs = [k.prov.Provisioner(name="default").with_defaults()]
        solver = (k.tpu.TpuSolver() if k is REF
                  else k.tpu.TpuSolver(device="cpu"))
        sts = {t: k.tensorize.tensorize(tenant_batch(k, t), provs, catalog)
               for t in TENANTS}
        assert len({solver.signature(st) for st in sts.values()}) == 1, \
            "tenants must share one shape bucket"
        out[k.name] = types.SimpleNamespace(
            k=k, catalog=catalog, provs=provs, solver=solver, sts=sts)
    return out


def port_scheduler(world, **kw):
    kw.setdefault("backend", "tpu")
    return t_scheduler.BatchScheduler(device="cpu", **kw)


def ref_scheduler_for(world, **kw):
    kw.setdefault("backend", "tpu")
    sched = ref_scheduler.BatchScheduler(**kw)
    sched._tpu = world["ref"].solver  # reuse the warm jit/bucket state
    return sched


# ---------------------------------------------------------------------------
# TpuSolver.solve_many parity
# ---------------------------------------------------------------------------


def test_per_request_parity_and_padding_isolation(world):
    # B=3 pads to the 4-slot rung: slot 3 is a padding copy of request 0
    # whose output is discarded — parity proves it leaked nothing
    tenants = ["acme", "bravo", "cyan"]
    outs = {}
    for name, w in world.items():
        reset_names()
        outs[name] = w.solver.solve_many([dict(st=w.sts[t]) for t in tenants])
    assert t_tpu._mega_rung(3) == ref_tpu._mega_rung(3) == 4
    port = world["port"]
    for i, t in enumerate(tenants):
        o = outs["port"][i]
        assert not isinstance(o, Exception)
        assert_same_solve(o.result, port.solver.solve(port.sts[t]).result)
        assert_same_solve(o.result, outs["ref"][i].result)


def test_adversarial_mixed_tenant_isolation(world):
    w = world["port"]
    reset_names()
    outs = w.solver.solve_many([dict(st=w.sts[t]) for t in TENANTS])
    reset_names()
    ref_outs = world["ref"].solver.solve_many(
        [dict(st=world["ref"].sts[t]) for t in TENANTS])
    for t, out, ref in zip(TENANTS, outs, ref_outs):
        names = set(out.result.assignments) | set(out.result.infeasible)
        assert names, f"tenant {t} got an empty result"
        foreign = {n for n in names if not n.startswith(f"{t}-")}
        assert not foreign, f"tenant {t} result references {foreign}"
        for node in out.result.nodes:
            bad = [p.name for p in node.pods if not p.name.startswith(f"{t}-")]
            assert not bad, f"tenant {t} node carries {bad}"
        assert_same_solve(out.result, ref.result)


def test_single_request_megabatch_matches_solo(world):
    w = world["port"]
    out, = w.solver.solve_many([dict(st=w.sts["acme"])])
    assert_same_solve(out.result, w.solver.solve(w.sts["acme"]).result)
    ref, = world["ref"].solver.solve_many([dict(st=world["ref"].sts["acme"])])
    assert_same_solve(out.result, ref.result)


def test_mega_signature_marked_ready(world):
    w = world["port"]
    sig4 = w.solver.mega_signature(w.sts["acme"], slots=4)
    w.solver.solve_many([dict(st=w.sts[t]) for t in TENANTS[:3]])
    assert w.solver.ready(sig4)
    assert dict(kv for kv in sig4 if isinstance(kv, tuple)
                and kv[0] == "mega_slots")["mega_slots"] == 4
    assert sig4 == world["ref"].solver.mega_signature(
        world["ref"].sts["acme"], slots=4)


def test_per_slot_megabatch_spans(world):
    """Every request's trace carries a pre-closed 'megabatch' span with its
    slot index and the batch occupancy."""
    w = world["port"]
    tracer = Tracer(enabled=True, registry=t_metrics.Registry())
    tenants = ["acme", "bravo", "cyan"]
    traces, reqs = [], []
    for t in tenants:
        tr = tracer.start("solve")
        tr.__enter__()
        traces.append(tr)
        reqs.append(dict(st=w.sts[t], trace=tr))
    outs = w.solver.solve_many(reqs)
    assert all(not isinstance(o, Exception) for o in outs)
    for i, tr in enumerate(traces):
        spans = {sp.name: sp for sp in tr.spans()}
        mb = spans["megabatch"]
        assert mb.attrs["slot"] == i
        assert mb.attrs["slots"] == 4      # rung of 3
        assert mb.attrs["occupied"] == 3
        assert mb.done
        tr.__exit__(None, None, None)


def test_solve_async_matches_solve(world):
    w = world["port"]
    pending = w.solver.solve_async(w.sts["bravo"])
    out = pending.result()
    assert pending.result() is out  # idempotent
    assert_same_solve(out.result, w.solver.solve(w.sts["bravo"]).result)
    reset_names()
    ref = world["ref"].solver.solve_async(world["ref"].sts["bravo"]).result()
    assert_same_solve(out.result, ref.result)


def test_two_threads_resolving_one_flush_agree(world):
    """Slots resolve from whichever thread reads first: two threads reading
    the same pending flush get the same outputs (one read-back)."""
    w = world["port"]
    pending = w.solver.solve_many_async([dict(st=w.sts[t]) for t in TENANTS])
    got = [None, None]
    barrier = threading.Barrier(2)

    def read(i):
        barrier.wait()
        got[i] = pending.results()

    threads = [threading.Thread(target=read, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60.0)
        assert not th.is_alive()
    assert got[0] is got[1]
    for t, out in zip(TENANTS, got[0]):
        assert_same_solve(out.result, w.solver.solve(w.sts[t]).result)


def test_unified_mixed_bucket_flush(world):
    """Two buckets where one dominates on every padded axis share one
    dispatch at the dominant dims; each result equals its own-bucket solo
    solve."""
    w = world["port"]
    big = w.k.tensorize.tensorize(
        tenant_batch(PORT, "echo", n_groups=20), w.provs, w.catalog)
    small = w.sts["acme"]
    ka = w.solver.mega_signature(big, slots=1)
    kb = w.solver.mega_signature(small, slots=1)
    assert ka != kb
    u = t_tpu.unify_mega_keys(ka, kb)
    assert u == ka
    assert u == ref_tpu.unify_mega_keys(
        world["ref"].solver.mega_signature(
            world["ref"].k.tensorize.tensorize(
                tenant_batch(REF, "echo", n_groups=20), world["ref"].provs,
                world["ref"].catalog), slots=1),
        world["ref"].solver.mega_signature(world["ref"].sts["acme"], slots=1))
    outs = w.solver.solve_many_async(
        [dict(st=big), dict(st=small)],
        target_dims=t_tpu.mega_key_dims(u)).results()
    assert_same_solve(outs[0].result, w.solver.solve(big).result)
    assert_same_solve(outs[1].result, w.solver.solve(small).result)


# ---------------------------------------------------------------------------
# keys: the reference's tuples on the same inputs
# ---------------------------------------------------------------------------


def _existing(k, catalog, n):
    it = next(t for t in catalog if t.name == "m5.4xlarge")
    out = []
    for i in range(n):
        zone = ("zone-1a", "zone-1b", "zone-1c")[i % 3]
        price = next(o.price for o in it.offerings
                     if o.zone == zone and o.capacity_type == "on-demand")
        out.append(k.types.SimNode(
            instance_type=it.name, provisioner="default", zone=zone,
            capacity_type="on-demand", price=price,
            allocatable=dict(it.allocatable),
            labels={**it.labels(), k.L.ZONE: zone,
                    k.L.CAPACITY_TYPE: "on-demand",
                    k.L.PROVISIONER_NAME: "default"},
            existing=True, name=f"ex-{i}"))
    return out


KEY_CASES = {
    "spread_tenant": dict(n_groups=4, per=10, spread=True, existing=0),
    "plain_tenant": dict(n_groups=3, per=30, spread=False, existing=0),
    "wide_with_existing": dict(n_groups=20, per=5, spread=True, existing=70),
    "budgeted": dict(n_groups=4, per=10, spread=True, existing=5,
                     max_new=3),
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_signature_and_bucket_key_tuples_equal_reference(world, case):
    c = KEY_CASES[case]
    got = {}
    for name, w in world.items():
        k = w.k
        pods = tenant_batch(k, "kilo", n_groups=c["n_groups"], per=c["per"],
                            spread=c["spread"])
        existing = _existing(k, w.catalog, c["existing"])
        max_new = c.get("max_new")
        st = k.tensorize.tensorize(pods, w.provs, w.catalog)
        budget = len(existing) + (len(pods) if max_new is None else max_new)
        solver = (k.tpu.TpuSolver() if k is REF
                  else k.tpu.TpuSolver(device="cpu"))
        sig = solver.signature(st, existing_nodes=existing, max_nodes=budget)
        megas = [solver.mega_signature(st, existing_nodes=existing,
                                       max_nodes=budget, slots=s)
                 for s in (1, 2, 3, 8, 32)]
        sched = (k.scheduler.BatchScheduler(backend="tpu") if k is REF
                 else port_scheduler(world))
        # the reference buckets only shapes whose program has compiled:
        # mark its single-solve signature ready (its compile state is not
        # what is compared)
        sched._tpu._mark_ready(sched._tpu.signature(
            st, existing_nodes=existing, max_nodes=budget))
        bkey = sched.bucket_key(dict(
            pods=pods, provisioners=w.provs, instance_types=w.catalog,
            existing_nodes=existing, max_new_nodes=max_new))
        got[name] = (sig, megas, bkey)
    assert got["port"] == got["ref"]
    assert got["port"][2] == got["port"][1][0]


def test_bucket_key_none_where_a_request_cannot_megabatch(world):
    w = world["port"]
    pods = tenant_batch(PORT, "lima")
    kw = dict(pods=pods, provisioners=w.provs, instance_types=w.catalog)
    assert port_scheduler(world, backend="oracle").bucket_key(kw) is None
    # auto serves small batches from the oracle
    assert port_scheduler(world, backend="auto").bucket_key(kw) is None
    assert port_scheduler(world).bucket_key(
        dict(kw, allow_new_nodes=False)) is None
    assert port_scheduler(world).bucket_key(kw) is not None


# ---------------------------------------------------------------------------
# the scheduler's submit / submit_many
# ---------------------------------------------------------------------------


def test_submit_many_demultiplexes(world):
    results = {}
    for name, w in world.items():
        k = w.k
        reg = k.metrics.Registry()
        sched = (ref_scheduler_for(world, registry=reg) if k is REF
                 else port_scheduler(world, registry=reg))
        reqs = [dict(pods=tenant_batch(k, t), provisioners=w.provs,
                     instance_types=w.catalog) for t in TENANTS]
        reset_names()
        pendings = sched.submit_many([dict(r) for r in reqs])
        results[name] = [p.result() for p in pendings]
        for t, res in zip(TENANTS, results[name]):
            solo = sched.solve(tenant_batch(k, t), w.provs, w.catalog)
            assert_same_solve(res, solo)
            assert not res.served_cold
        h = reg.histogram(k.metrics.MEGABATCH_SLOTS)
        assert sum(h.totals.values()) >= 1
        assert max(h.sums.values()) >= 4.0
    for a, b in zip(results["port"], results["ref"]):
        assert_same_solve(a, b)


def test_submit_matches_solve(world):
    w = world["port"]
    reg = t_metrics.Registry()
    sched = port_scheduler(world, registry=reg)
    res = sched.submit(tenant_batch(PORT, "mike"), w.provs,
                       w.catalog).result()
    assert not res.served_cold
    assert_same_solve(res, sched.solve(tenant_batch(PORT, "mike"), w.provs,
                                       w.catalog))
    ref = ref_scheduler_for(world).submit(
        tenant_batch(REF, "mike"), world["ref"].provs,
        world["ref"].catalog).result()
    assert_same_solve(res, ref)
    assert reg.counter(t_metrics.SOLVER_COLD_FALLBACKS).get(
        {"backend": "oracle"}) == 0.0


def test_new_rung_dispatches_batched(world):
    """Replaces the reference's cold-rung case: a flush whose slot rung the
    process has never run is dispatched batched (one solve_many_async),
    and its results equal the reference's serial ones."""
    w = world["port"]
    reg = t_metrics.Registry()
    sched = port_scheduler(world, registry=reg, compile_behind=True)
    pods_a, pods_b = tenant_batch(PORT, "echo"), tenant_batch(PORT, "fxtrt")
    st, _ = sched._tensorize_cache.tensorize(pods_a, w.provs, w.catalog)
    assert not sched._tpu.ready(sched._tpu.mega_signature(st, slots=2))
    calls = []
    orig = sched._tpu.solve_many_async

    def counting(reqs, **kw):
        calls.append(len(reqs))
        return orig(reqs, **kw)

    sched._tpu.solve_many_async = counting
    pendings = sched.submit_many([
        dict(pods=pods_a, provisioners=w.provs, instance_types=w.catalog),
        dict(pods=pods_b, provisioners=w.provs, instance_types=w.catalog),
    ])
    results = [p.result() for p in pendings]
    assert calls == [2]
    assert sched._tpu.ready(sched._tpu.mega_signature(st, slots=2))
    assert reg.histogram(t_metrics.MEGABATCH_SLOTS).sums[()] == 2.0
    rw = world["ref"]
    ref_sched = ref_scheduler_for(world)
    for res, tag in zip(results, ("echo", "fxtrt")):
        assert not res.infeasible and not res.served_cold
        serial = ref_sched.solve(tenant_batch(REF, tag), rw.provs, rw.catalog)
        assert_same_solve(res, serial)


def test_slot_cap_enforced(world):
    w = world["port"]
    reqs = [dict(st=w.sts["acme"])] * (t_tpu.MEGA_MAX_SLOTS + 1)
    with pytest.raises(t_tpu.MegaBucketMismatch):
        w.solver.solve_many(reqs)
    assert t_tpu.max_mega_slots(None) == ref_tpu.max_mega_slots(None) == 32
    assert t_tpu.mesh_shardable(None)
    # a mesh caps the flush at its sharded rung (the reference's on its
    # 8 virtual devices); one with more entries than the ladder has none
    from karpenter_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from karpenter_tpu_torch.parallel.mesh import make_mesh

    assert (t_tpu.max_mega_slots(make_mesh(devices=["cpu"] * 8))
            == ref_tpu.max_mega_slots(ref_make_mesh(8)) == 32)
    wide = make_mesh(devices=["cpu"] * 64)
    assert not t_tpu.mesh_shardable(wide)
    assert t_tpu.max_mega_slots(wide) == 0
    with pytest.raises(t_tpu.MegaBucketMismatch):
        w.solver.solve_many(reqs[:2], mesh=wide)


def test_megabatch_construction_failure_degrades_serial(world, caplog):
    """A megabatch-layer failure must degrade the flush to serial dispatches
    with a warning — every request still gets ITS correct result."""
    w = world["port"]
    sched = port_scheduler(world, registry=t_metrics.Registry())

    def boom(reqs, **kw):
        raise t_tpu.MegaBucketMismatch("injected mid-flush bucket flip")

    sched._tpu.solve_many_async = boom
    tenants = ("acme", "bravo", "cyan")
    with caplog.at_level(logging.WARNING, logger="karpenter_tpu_torch"):
        pendings = sched.submit_many([
            dict(pods=tenant_batch(PORT, t), provisioners=w.provs,
                 instance_types=w.catalog) for t in tenants])
        results = [p.result() for p in pendings]
    assert any("serving the flush serially" in r.getMessage()
               for r in caplog.records)
    for t, res in zip(tenants, results):
        assert not res.infeasible
        assert set(res.assignments) == {p.name for p in tenant_batch(PORT, t)}
        assert_same_solve(res, sched.solve(tenant_batch(PORT, t), w.provs,
                                           w.catalog))


# ---------------------------------------------------------------------------
# the bucket-grid warm
# ---------------------------------------------------------------------------


def test_precompile_covers_every_reachable_bucket(world):
    """Every single-solve signature AND every megabatch slot-rung signature
    reachable from the warm profiles is targeted by precompile_buckets
    (stubbed warms: coverage only), and the targets are the reference's
    (whose extra relax-program warms come with the serving layer)."""
    accepted = {}
    for name, w in world.items():
        k = w.k
        sched = (k.scheduler.BatchScheduler(backend="tpu",
                                            compile_behind=True)
                 if k is REF else port_scheduler(world, compile_behind=True))
        got = []

        def fake_warm(st, existing_nodes=(), max_nodes=None,
                      track_assignments=True, mesh=None, on_done=None,
                      slots=None, sched=sched, got=got):
            if slots and slots > 1:
                got.append(sched._tpu.mega_signature(
                    st, existing_nodes=existing_nodes, max_nodes=max_nodes,
                    slots=slots))
            else:
                got.append(sched._tpu.signature(
                    st, existing_nodes=existing_nodes, max_nodes=max_nodes))
            return True

        def fake_warm_custom(sig, thunk, on_done=None, got=got):
            got.append(sig)
            return True

        sched._tpu.warm_async = fake_warm
        sched._tpu.warm_custom = fake_warm_custom
        n = sched.precompile_buckets(w.provs, w.catalog, mega_slots=(2, 4, 8))
        assert n == len(got)
        for st in sched._profile_tensors(w.provs, w.catalog, ()):
            assert sched._tpu.signature(st) in got
            for s in (2, 4, 8):
                assert sched._tpu.mega_signature(st, slots=s) in got
        accepted[name] = got
    ref_scan = [s for s in accepted["ref"] if s[0] != ("relax", True)]
    assert accepted["port"] == ref_scan


def test_precompile_wait_runs_every_rung(world):
    """precompile_buckets(wait=True) runs one solve per single shape and per
    slot rung on background threads: afterwards each signature is ready,
    and the wait is observed in PRECOMPILE_DURATION."""
    w = world["port"]
    reg = t_metrics.Registry()
    sched = port_scheduler(world, registry=reg, compile_behind=True)
    profiles = ((2, 8, False),)
    n = sched.precompile_buckets(w.provs, w.catalog, profiles=profiles,
                                 mega_slots=(2, 4), wait=True, timeout=300.0)
    assert n == 3
    assert sched._tpu.warm_idle()
    st, = sched._profile_tensors(w.provs, w.catalog, (), profiles)
    assert sched._tpu.ready(sched._tpu.signature(st))
    for s in (2, 4):
        assert sched._tpu.ready(sched._tpu.mega_signature(st, slots=s))
    assert reg.histogram(t_metrics.PRECOMPILE_DURATION).count() == 1
    assert reg.histogram(t_metrics.SOLVER_COMPILE_DURATION).count() == 3
    assert reg.gauge(t_metrics.SOLVER_COMPILE_IN_PROGRESS).get() == 0


def test_precompile_wait_observes_duration(world):
    w = world["port"]
    reg = t_metrics.Registry()
    sched = port_scheduler(world, registry=reg)
    sched._tpu.warm_async = lambda *a, **kw: True
    sched._tpu.warm_idle = lambda: True
    sched.precompile_buckets(w.provs, w.catalog, mega_slots=(2,),
                             wait=True, timeout=5.0)
    assert reg.histogram(t_metrics.PRECOMPILE_DURATION).count() == 1


def test_flush_reason_counted_once(world):
    w = world["port"]
    reg = t_metrics.Registry()
    sched = port_scheduler(world, registry=reg)
    flush = reg.counter(t_metrics.MEGABATCH_FLUSH)
    for reason in t_metrics.MEGABATCH_FLUSH_REASONS:
        assert flush.has({"reason": reason})
    assert sched.counts_flush_reason
    pendings = sched.submit_many(
        [dict(pods=tenant_batch(PORT, t), provisioners=w.provs,
              instance_types=w.catalog) for t in TENANTS[:2]],
        flush_reason="full")
    for p in pendings:
        p.result()
    assert flush.get({"reason": "full"}) == 1.0
    assert sum(flush.values.values()) == 1.0


def test_hierarchical_request_in_a_flush(world, monkeypatch):
    """A greenfield request at/above KT_HIER_THRESHOLD routes
    hierarchically inside submit_many's registration (a finished result,
    no slot in the collector) while its batchmates share one dispatch;
    every result equals its solo solve."""
    monkeypatch.setenv("KT_HIER_THRESHOLD", "400")
    w = world["port"]
    from karpenter_tpu_torch.metrics import HIER_SOLVES

    big = tenant_batch(PORT, "hotel", n_groups=6, per=80)
    reg = t_metrics.Registry()
    sched = port_scheduler(world, registry=reg)
    calls = []
    orig = sched._tpu.solve_many_async
    sched._tpu.solve_many_async = lambda reqs, **kw: (
        calls.append(len(reqs)) or orig(reqs, **kw))
    reqs = [dict(pods=big, provisioners=w.provs, instance_types=w.catalog)]
    reqs += [dict(pods=tenant_batch(PORT, t), provisioners=w.provs,
                  instance_types=w.catalog) for t in TENANTS[:3]]
    reset_names()
    results = [p.result() for p in sched.submit_many(reqs)]
    assert reg.counter(HIER_SOLVES).get({"path": "hierarchical"}) == 1.0
    assert calls == [3]
    solo_sched = port_scheduler(world)
    for req, res in zip(reqs, results):
        reset_names()
        solo = solo_sched.solve(req["pods"], w.provs, w.catalog, relax=False)
        assert_same_solve(res, solo)
