"""The port's bench probes (``bench_torch.py``'s ``measure_*`` beyond the
headline) against the reference bench's (``bench.py``) on the CPU.

- every probe's scenario builder makes the reference's pods, nodes and
  replay captures, record for record (one parametrised test);
- the port's ``solver/validate.py`` returns the reference validator's
  violations on the same plans (valid, a dropped pod, an overfilled node,
  a broken zone spread, a violated provisioner limit, a taint);
- each of the fifteen probes, run on ``device="cpu"`` at a small size
  through its own size arguments, returns exactly the reference probe's
  key set: from running the reference at the same small size where that
  is cheap (replay, gangs), and from ``bench.py``'s source
  otherwise (the keys of the dicts each probe returns, the f-string keys
  expanded over its scenario names; the warmed cold start's from the
  record ``run_bench`` builds of its tuple), plus the keys the port adds
  (:data:`PORT_KEYS`: the restart and fleet probes' backend, the
  relaunch's wait for health, the kernel library's nvcc and load
  seconds);
- the parity keys hold: ``sweep_what_ifs`` decisions equal the
  reference's on a 40-node, 4-candidate ``_sweep_cluster``; the gang
  probe's outcomes equal the reference's; the probes' own equality
  booleans (``delta_parity``, ``delta_off_parity``, ``relax_valid``,
  ``relax_never_worse``, ``sweep_decisions_match``, ``multihost_parity``,
  ``replay_class_mix_match``) are true;
- ``relax_valid`` is false for a plan that loses a pod or leaves one
  infeasible that the scan placed (the validator alone passes both);
- the child-process probes add every child's kernel launch counts to the
  dict they are given; ``measure_multihost_fence`` reads a given rank
  verdict instead of running the ranks again; the replica probes remove
  their socket directories;
- ``NOT_PORTED`` is empty: every reference probe has its port;
- ``check_budgets`` flags a breach of each restart, fleet and
  cold-restart gate;
- ``scripts/dryrun_multihost_torch.py --lone-ab --device cpu`` prints one
  parseable ``LONE_AB`` line and one ``LAUNCHES`` line.

Tolerance: equal.
"""

import ast
import copy
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import pytest
import torch

import bench_torch as bt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, os.path.dirname(__file__))
from test_torch_bench import canon  # noqa: E402
from test_torch_relax import to_port  # noqa: E402


def _load(name, file):
    spec = importlib.util.spec_from_file_location(name, ROOT / file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench = _load("benchmod_torch_bench_probes", "bench.py")

#: the ported probes and the small sizes the CPU runs them at
SMALL = {
    "measure_throughput": dict(duration_s=0.2, max_slots=8, clients=2,
                               per=1),
    "measure_sharded_throughput": dict(n_dev=2, duration_s=0.1, per=1),
    "measure_overload": dict(duration_s=0.2, pairs=1),
    "measure_warm_coldstart": {},
    "measure_relax": dict(n_per=10, constrained_per=4),
    "measure_warmstart": dict(pods_n=200, churn=2, steps=4),
    "measure_delta_serving": dict(pods_n=200, churn=2, steps=4),
    "measure_consolidation_sweep": dict(n_candidates=4, n_nodes=40,
                                        pairs=1),
    "measure_gang": dict(pairs=1),
    "measure_multihost_fence": dict(n_processes=2, local_devices=1,
                                    lone_ab_devices=2, lone_ab_pairs=1),
    "measure_replay_fidelity": dict(n=12, mean_rate=40.0),
    "measure_tuning": dict(n=6, mean_rate=80.0, pairs=1),
    "measure_cold_restart": {},
    "measure_restart_recovery": dict(pods_n=300, clients=2, pre_steps=2,
                                     post_steps=2, churn=3),
    "measure_fleet_failover": dict(clients=4, pods_n=320, pre_steps=2,
                                   post_steps=2, churn=3),
}
#: keys a port probe returns beyond the reference probe's
PORT_KEYS = {
    "measure_restart_recovery": {"restart_backend",
                                 "restart_relaunch_ready_s"},
    "measure_fleet_failover": {"fleet_backend"},
    "measure_cold_restart": {"cold_restart_nvcc_s", "cold_restart_load_s"},
}
#: the probes whose work runs in child processes: started together
CHILD_PROBES = ("measure_sharded_throughput", "measure_warm_coldstart",
                "measure_multihost_fence", "measure_cold_restart",
                "measure_restart_recovery")
#: the reference probes run here at the same small size (cheap on the
#: CPU); the others' keys come from the source
REF_SMALL = {
    "measure_replay_fidelity": dict(n=12, mean_rate=40.0),
    "measure_gang": {},
}
LONE_AB = [sys.executable, str(ROOT / "scripts" / "dryrun_multihost_torch.py"),
           "--lone-ab", "--device", "cpu", "--devices", "2", "--pairs", "1"]

_PORT_RUNS: dict = {}
#: the kernel launches the child-process probes' children report
CHILD_LAUNCHES = {"measure_warm_coldstart": {},
                  "measure_multihost_fence": {},
                  "measure_cold_restart": {}}


@pytest.fixture(scope="module")
def child_runs():
    """The child-process probes and the ``--lone-ab`` script, each from
    its own thread at once (their work is in the children; the parent
    only waits).  Values are fragments, the completed process, or the
    exception a run raised."""
    out = {}

    def go(key, fn):
        try:
            out[key] = fn()
        except Exception as e:  # re-raised by the test that reads it
            out[key] = e

    def probe(name):
        kw = dict(SMALL[name])
        if name in CHILD_LAUNCHES:
            kw["launches"] = CHILD_LAUNCHES[name]
        return getattr(bt, name)(device="cpu", **kw)

    jobs = {name: (lambda name=name: probe(name)) for name in CHILD_PROBES}
    jobs["lone_ab"] = lambda: subprocess.run(
        LONE_AB, cwd=ROOT, capture_output=True, text=True, timeout=300)
    threads = [threading.Thread(target=go, args=item)
               for item in jobs.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out


def port_run(name, child_runs=None):
    """The port probe's fragment at its small size on the CPU, run once
    per session (the child-process probes from :func:`child_runs`)."""
    if name in CHILD_PROBES:
        got = child_runs[name]
        if isinstance(got, Exception):
            raise got
        return got
    if name not in _PORT_RUNS:
        _PORT_RUNS[name] = getattr(bt, name)(device="cpu", **SMALL[name])
    return _PORT_RUNS[name]


# ---------------------------------------------------------------------------
# the reference's probes, run or read
# ---------------------------------------------------------------------------


class _Recorder:
    """Records what the reference hands two of its functions while a probe
    runs: the replay captures it synthesizes and the batches (with their
    existing nodes) its scheduler solves."""

    def __init__(self):
        self.captures = []
        self.solves = []


@pytest.fixture(scope="module")
def reference_runs():
    from karpenter_tpu.obs import replay as ref_replay
    from karpenter_tpu.solver import scheduler as ref_sched

    rec = _Recorder()
    real_synth, real_solve = ref_replay.synthesize, \
        ref_sched.BatchScheduler.solve

    def synth(*a, **kw):
        out = real_synth(*a, **kw)
        rec.captures.append(canon(out))
        return out

    def solve(self, pods, provs, catalog, *a, **kw):
        rec.solves.append((canon(list(pods)),
                           canon(list(kw.get("existing_nodes", ())))))
        return real_solve(self, pods, provs, catalog, *a, **kw)

    ref_replay.synthesize = synth
    ref_sched.BatchScheduler.solve = solve
    try:
        out = {}
        for name, kw in REF_SMALL.items():
            rec.captures.clear()
            rec.solves.clear()
            frag = getattr(bench, name)(**kw)
            out[name] = (frag, list(rec.captures), list(rec.solves))
    finally:
        ref_replay.synthesize = real_synth
        ref_sched.BatchScheduler.solve = real_solve
    return out


def _fn(tree, name):
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


#: the names a reference probe builds its fragment under
FRAGMENT = ("out", "rec")


def _walk_own(fn):
    """The nodes of ``fn``'s own body, nested functions left out (their
    dicts are internal, not the probe's fragment)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def source_keys(name):
    """The record keys the reference probe ``name`` returns, read from
    ``bench.py``: string keys of the dicts it returns, builds as its
    fragment (``out`` or ``rec``) or merges into it, and of ``out[...]``
    / ``rec[...]`` assignments,
    an f-string key expanded
    over the first field of its ``scenarios`` tuples.  Failure-path keys
    (``*_error``, ``multihost_skipped``) are left out: the port raises
    there instead."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    if name == "measure_warm_coldstart":
        # it returns a tuple; run_bench names its fields in the record
        run = _fn(tree, "run_bench")
        fields = set()
        for node in ast.walk(run):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and getattr(node.value.func, "id", "") == name):
                fields = {e.id for e in node.targets[0].elts}
        rec_cold = next(n.value for n in ast.walk(run)
                        if isinstance(n, ast.Assign)
                        and getattr(n.targets[0], "id", "") == "rec_cold")
        return {k.value for k, v in zip(rec_cold.keys, rec_cold.values)
                if isinstance(v, ast.Name) and v.id in fields}
    fn = _fn(tree, name)
    scenario_names = []
    for node in _walk_own(fn):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "scenarios"):
            scenario_names = [e.elts[0].value for e in node.value.elts]
    keys = set()

    def take(key):
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            keys.add(key.value)
        elif isinstance(key, ast.JoinedStr):
            for s in scenario_names:
                keys.add("".join(
                    p.value if isinstance(p, ast.Constant) else s
                    for p in key.values))

    for node in _walk_own(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                take(k)
        elif (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
              and getattr(node.targets[0], "id", "") in FRAGMENT):
            for k in node.value.keys:
                take(k)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "update"
              and getattr(node.func.value, "id", "") in FRAGMENT
              and node.args and isinstance(node.args[0], ast.Dict)):
            for k in node.args[0].keys:
                take(k)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and getattr(t.value, "id", "") in FRAGMENT):
                    take(t.slice)
    return {k for k in keys
            if not k.endswith("_error") and k != "multihost_skipped"}


def test_source_keys_agree_with_the_reference_runs(reference_runs):
    for name, (frag, _c, _s) in reference_runs.items():
        assert source_keys(name) == set(frag), name


@pytest.mark.parametrize("name", sorted(SMALL))
def test_probe_returns_the_reference_keys(name, reference_runs, child_runs):
    want = (set(reference_runs[name][0]) if name in reference_runs
            else source_keys(name))
    assert want, name
    got = port_run(name, child_runs)
    assert set(got) == want | PORT_KEYS.get(name, set())
    assert set(bt.check_budgets(got)) <= {"budget_flags"}


def test_twelve_probes_and_not_ported():
    assert len(SMALL) == 15
    assert bt.NOT_PORTED == ()
    ref = {n.name for n in ast.parse((ROOT / "bench.py").read_text()).body
           if isinstance(n, ast.FunctionDef) and n.name.startswith("measure_")}
    ported = {n for n in ref if hasattr(bt, n)}
    assert ref == ported
    assert set(SMALL) | {"measure_trace_overhead", "measure_ts_overhead",
                         "measure_coldstart", "measure_hierarchical"} \
        == ported


def test_run_bench_calls_the_probes_in_the_reference_order():
    """``run_bench`` calls every probe in ``bench.py``'s order."""
    def calls(tree):
        run = _fn(tree, "run_bench")
        names = [n for n in ast.walk(run)
                 if isinstance(n, ast.Name) and n.id.startswith("measure_")]
        return [n.id for n in sorted(
            names, key=lambda n: (n.lineno, n.col_offset))]

    ref = [n for n in calls(ast.parse((ROOT / "bench.py").read_text()))
           if n != "measure_tensorize"]
    port = calls(ast.parse((ROOT / "bench_torch.py").read_text()))
    # the reference calls each probe once, in order; the port names them
    # in its probe table (the tensorize tiers are the headline's)
    ref_order = [n for n in dict.fromkeys(ref)]
    port_order = [n for n in dict.fromkeys(port) if n != "measure_tensorize"]
    assert port_order == ref_order


#: a record of the three probes with every gate held, and one breach of
#: each gate
_HELD = {
    "restart_recovery_clients": 4,
    "restart_recovery_resends_with_snapshot": 0,
    "restart_recovery_resends_without": 4,
    "restart_first_delta_p50_ms": 3.0,
    "fleet_victim_sessions": 2, "fleet_warm_failover_resends": 0,
    "fleet_steal_adoptions": 2, "fleet_cold_victim_sessions": 2,
    "fleet_cold_failover_resends": 2,
    "cold_restart_first_ms": 9000.0, "cold_restart_second_ms": 800.0,
    "cold_restart_cache_populated": True, "cold_restart_fleet_ms": 900.0,
}
_BREACHES = {
    "restart_resends_with_snapshot": (
        {"restart_recovery_resends_with_snapshot": 1}, "WITH a session"),
    "restart_resends_without": (
        {"restart_recovery_resends_without": 3}, "snapshot-less restart"),
    "restart_first_delta": (
        {"restart_first_delta_p50_ms": 251.0}, "restore budget"),
    "fleet_warm_resends": (
        {"fleet_warm_failover_resends": 1}, "kill-one-of-N"),
    "fleet_no_victims": (
        {"fleet_victim_sessions": 0, "fleet_steal_adoptions": 0},
        "zero sessions"),
    "fleet_steals": ({"fleet_steal_adoptions": 1}, "lease-steal"),
    "fleet_cold": ({"fleet_cold_failover_resends": 3}, "no-spool fleet"),
    "cold_restart_unpopulated": (
        {"cold_restart_cache_populated": False}, "directory empty"),
    "cold_restart_second": (
        {"cold_restart_second_ms": 9000.0}, "did not improve"),
    "cold_restart_fleet": (
        {"cold_restart_fleet_ms": 9500.0}, "second-replica"),
}


def test_held_gates_raise_no_flag():
    assert bt.check_budgets(dict(_HELD)).get("budget_flags", []) == []


@pytest.mark.parametrize("case", sorted(_BREACHES))
def test_check_budgets_flags_a_breach_of_each_new_gate(case):
    change, phrase = _BREACHES[case]
    flags = bt.check_budgets({**_HELD, **change}).get("budget_flags", [])
    assert len(flags) == 1 and phrase in flags[0], flags


# ---------------------------------------------------------------------------
# scenarios, record for record
# ---------------------------------------------------------------------------


def _scenario_cases():
    return {
        "serving_pods_0": (lambda: bench._serving_pods(0),
                           lambda: bt._serving_pods(0)),
        "serving_pods_31": (lambda: bench._serving_pods(31),
                            lambda: bt._serving_pods(31)),
        "overload_pods_critical": (lambda: bench._overload_pods(1),
                                   lambda: bt._overload_pods(1)),
        "overload_pods_best_effort": (lambda: bench._overload_pods(107),
                                      lambda: bt._overload_pods(107)),
        "relax_pods_unconstrained": (
            lambda: bench._relax_pods(2500, tag="rxu"),
            lambda: bt._relax_pods(2500, tag="rxu")),
        "relax_pods_all_spread": (
            lambda: bench._relax_pods(250, spread_deps=20, tag="rxs"),
            lambda: bt._relax_pods(250, spread_deps=20, tag="rxs")),
        "relax_pods_mixed": (
            lambda: bench._relax_pods(250, spread_deps=10, tag="rxm"),
            lambda: bt._relax_pods(250, spread_deps=10, tag="rxm")),
        "warmstart_pods": (lambda: bench._warmstart_pods(20_000, "ws"),
                           lambda: bt._warmstart_pods(20_000, "ws")),
        "warmstart_churn": (lambda: bench._warmstart_pods(8, "wsc3"),
                            lambda: bt._warmstart_pods(8, "wsc3")),
        "sweep_cluster": (lambda: bench._sweep_cluster(),
                          lambda: bt._sweep_cluster()),
    }


SCENARIOS = sorted(_scenario_cases()) + [
    "gang_atomicity", "gang_pack", "gang_free", "replay_bursty_seed9",
    "tuning_seed19"]


def rows(objs):
    """``canon`` of each object, plain field values taken as they are (the
    same view, several times faster on 50,000 pods)."""
    plain = (str, int, float, bool, type(None))

    def row(x):
        if not dataclasses.is_dataclass(x):
            return canon(x)
        out = []
        for f in dataclasses.fields(x):
            if f.name == "uid":
                continue
            v = getattr(x, f.name)
            if isinstance(v, plain) or (isinstance(v, (list, tuple))
                                        and not v):
                out.append((f.name, v if v or isinstance(v, plain) else ()))
            elif isinstance(v, dict) and all(
                    isinstance(w, plain) for w in v.values()):
                out.append((f.name, tuple(sorted(v.items()))))
            else:
                out.append((f.name, canon(v)))
        return (type(x).__name__, tuple(out))

    return [row(x) for x in objs]


def test_rows_is_canon():
    pods = bt._relax_pods(2, spread_deps=1) + bt._gang_pack_members()
    assert rows(pods) == [canon(p) for p in pods]
    assert rows(bt._sweep_cluster(2, 3)) == [
        canon(n) for n in bt._sweep_cluster(2, 3)]


@pytest.mark.parametrize("case", SCENARIOS)
def test_scenario_is_the_reference(case, reference_runs):
    if case in _scenario_cases():
        ref, port = _scenario_cases()[case]
        want, got = ref(), port()
        assert len(got) == len(want)
        assert rows(got) == rows(want)
        return
    if case.startswith("gang"):
        solves = reference_runs["measure_gang"][2]
        if case == "gang_atomicity":
            assert solves[:4] == [(canon(bt._gang_atomicity_batch(v)[1]),
                                   canon([])) for v in range(4)]
        elif case == "gang_pack":
            want = (canon(bt._gang_pack_members()),
                    canon(bt._gang_spread_cluster()))
            assert solves[4:6] == [want, want]  # naive, then packed
        else:
            free = (canon(bt._gang_free_pods()), canon([]))
            assert all(s == free for s in solves[6:]) and solves[6:]
        return
    if case == "replay_bursty_seed9":
        kw = SMALL["measure_replay_fidelity"]
        assert reference_runs["measure_replay_fidelity"][1] == [
            canon(bt._replay_records(kw["n"], kw["mean_rate"]))]
        # and at the probe's own size
        from karpenter_tpu.obs import replay as ref_replay

        assert canon(bt._replay_records()) == canon(ref_replay.synthesize(
            n=60, shape="bursty", seed=9, mean_rate=5.0, n_pods=30,
            churn=3, sessions=4))
        return
    # the reference probe's captures at its own size and seed
    # (bench.py measure_tuning: its class mix, shapes and synthesize call)
    from karpenter_tpu.obs import replay as ref_replay

    mix = {"batch": 0.5, "critical": 0.35, "best_effort": 0.15}
    want = [ref_replay.synthesize(n=96, seed=19, n_pods=96, churn=4,
                                  sessions=4, class_mix=mix, **kw)
            for kw in (dict(shape="bursty", mean_rate=40.0),
                       dict(shape="diurnal", mean_rate=40.0, period=2.0),
                       dict(shape="uniform", mean_rate=40.0 / 6.0))]
    port = bt._tuning_records()
    assert [name for name, _r in port] == ["bursty", "diurnal", "starved"]
    assert [canon(r) for _name, r in port] == [canon(r) for r in want]


# ---------------------------------------------------------------------------
# the validator
# ---------------------------------------------------------------------------


def _validator_case(case):
    """A reference plan of two zone-spread deployments under a provisioner
    with a cpu limit, broken the way ``case`` says: ``(pods, provs,
    result, catalog)`` in the reference's models."""
    from karpenter_tpu.models import labels as RL
    from karpenter_tpu.models.catalog import generate_catalog
    from karpenter_tpu.models.instancetype import GIB
    from karpenter_tpu.models.pod import (
        LabelSelector,
        PodSpec,
        Taint,
        TopologySpreadConstraint,
    )
    from karpenter_tpu.models.provisioner import Provisioner
    from karpenter_tpu.solver import reference

    catalog = generate_catalog(full=False)
    pods = []
    for d in range(2):
        sel = LabelSelector.of({"app": f"v{d}"})
        pods += [PodSpec(name=f"v{d}-{i}", labels={"app": f"v{d}"},
                         requests={"cpu": 1.0 + d, "memory": 2 * GIB},
                         topology_spread=[TopologySpreadConstraint(
                             1, RL.ZONE, "DoNotSchedule", sel)],
                         owner_key=f"v{d}")
                 for i in range(6)]
    provs = [Provisioner(name="default",
                         limits={"cpu": 1000.0}).with_defaults()]
    res = copy.deepcopy(reference.solve(pods, provs, catalog))
    assert res.nodes and not res.infeasible
    node = res.nodes[0]
    if case == "dropped_pod":
        gone = node.pods.pop()
        res.assignments.pop(gone.name)
    elif case == "overfilled_node":
        node.pods.append(PodSpec(name="v0-big", requests={"cpu": 512.0},
                                 owner_key="v0"))
        pods = pods + [node.pods[-1]]
    elif case == "broken_spread":
        for n in res.nodes:
            n.zone = "zone-1a"
    elif case == "violated_limit":
        provs = [Provisioner(name="default",
                             limits={"cpu": 1.0}).with_defaults()]
    elif case == "intolerable_taint":
        node.taints = [Taint(key="team", effect=RL.EFFECT_NO_SCHEDULE,
                             value="a")]
    return pods, provs, res, catalog


@pytest.mark.parametrize("case,broken", [
    ("valid", False), ("dropped_pod", False), ("overfilled_node", True),
    ("broken_spread", True), ("violated_limit", True),
    ("intolerable_taint", True)])
def test_validator_is_the_reference(case, broken):
    from test_fuzz_parity import validate_solution as ref_validate

    from karpenter_tpu_torch.solver.validate import validate_solution

    pods, provs, res, catalog = _validator_case(case)
    want = ref_validate(pods, provs, res, catalog)
    got = validate_solution(to_port(pods), to_port(provs), to_port(res),
                            to_port(catalog))
    assert got == want
    assert bool(got) == broken


# ---------------------------------------------------------------------------
# parity keys
# ---------------------------------------------------------------------------


def test_sweep_decisions_are_the_reference():
    from karpenter_tpu.models.catalog import generate_catalog as ref_catalog
    from karpenter_tpu.models.provisioner import Provisioner as RefProv
    from karpenter_tpu.solver.consolidation import (
        sweep_what_ifs as ref_sweep,
    )
    from karpenter_tpu.solver.scheduler import BatchScheduler as RefSched

    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.solver.consolidation import sweep_what_ifs
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    cands = [[i] for i in range(4)]
    port = sweep_what_ifs(
        BatchScheduler(backend="tpu", device="cpu"), bt._sweep_cluster(40),
        cands, provisioners=[Provisioner(name="default").with_defaults()],
        instance_types=generate_catalog(full=False))
    ref = ref_sweep(
        RefSched(backend="tpu", compile_behind=False),
        bench._sweep_cluster(40), cands,
        provisioners=[RefProv(name="default").with_defaults()],
        instance_types=ref_catalog(full=False))
    assert port.path == "batched" and port.dispatches == 1
    assert ([bt.sweep_decision(r) for r in port.results]
            == [bt.sweep_decision(r) for r in ref.results])


def test_gang_outcomes_are_the_reference(reference_runs):
    ref = reference_runs["measure_gang"][0]
    port = port_run("measure_gang")
    for key in ref:
        if key != "gang_latency_ratio":
            assert port[key] == ref[key], key
    assert port["gang_atomicity_violations"] == 0


@pytest.mark.parametrize("name,key", [
    ("measure_delta_serving", "delta_parity"),
    ("measure_delta_serving", "delta_off_parity"),
    ("measure_relax", "relax_valid"),
    ("measure_relax", "relax_never_worse"),
    ("measure_consolidation_sweep", "sweep_decisions_match"),
    ("measure_multihost_fence", "multihost_parity"),
    ("measure_replay_fidelity", "replay_class_mix_match")])
def test_probe_equality_holds_on_the_host(name, key, child_runs):
    assert port_run(name, child_runs)[key] is True


def test_lone_ab_prints_one_line(child_runs):
    from karpenter_tpu_torch import kernels

    proc = child_runs["lone_ab"]
    if isinstance(proc, Exception):
        raise proc
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("LONE_AB ")]
    assert len(lines) == 1
    ab = json.loads(lines[0][len("LONE_AB "):])
    assert set(ab) == {"on_ms", "off_ms", "ratio"}
    assert ab["on_ms"] > 0 and ab["off_ms"] > 0
    assert abs(ab["ratio"] - ab["on_ms"] / ab["off_ms"]) < 0.01
    counts = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("LAUNCHES ")]
    assert len(counts) == 1
    # on the CPU no wrapper launches its kernel
    assert json.loads(counts[0][len("LAUNCHES "):]) == {
        k.name: 0 for k in kernels.ALL}


# ---------------------------------------------------------------------------
# the relax probe's validity, the children's kernel counts, the multihost
# verdict, the replicas' socket directories
# ---------------------------------------------------------------------------


def _relax_plans(case):
    """A port plan of 2 small deployments as the scan and as the shipped
    plan, the shipped one broken the way ``case`` says."""
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.solver import reference

    catalog = generate_catalog(full=False)
    provs = [Provisioner(name="default").with_defaults()]
    pods = bt._relax_pods(3, n_dep=2)
    scan = reference.solve(pods, provs, catalog)
    shipped = copy.deepcopy(scan)
    assert shipped.nodes and not shipped.infeasible
    node = next(n for n in shipped.nodes if n.pods)
    if case == "lost_pod":
        gone = node.pods.pop()
        shipped.assignments.pop(gone.name)
    elif case == "newly_infeasible":
        gone = node.pods.pop()
        shipped.assignments.pop(gone.name)
        shipped.infeasible[gone.name] = "no capacity"
    return pods, provs, catalog, scan, shipped


@pytest.mark.parametrize("case,valid", [
    ("valid", True), ("lost_pod", False), ("newly_infeasible", False)])
def test_relax_valid_accounts_for_every_pod(case, valid):
    from karpenter_tpu_torch.solver.validate import validate_solution

    pods, provs, catalog, scan, shipped = _relax_plans(case)
    # the validator alone does not see either
    assert validate_solution(pods, provs, shipped, catalog) == []
    assert bt.relax_valid(pods, provs, catalog, scan, shipped) is valid


def test_relax_probe_is_invalid_when_the_rung_loses_a_pod(monkeypatch):
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    real = BatchScheduler.solve

    def losing(self, pods, *a, **kw):
        res = real(self, pods, *a, **kw)
        if os.environ.get("KT_RELAX") != "0":
            res = copy.deepcopy(res)
            node = next(n for n in res.nodes if n.pods)
            res.assignments.pop(node.pods.pop().name)
        return res

    monkeypatch.setattr(BatchScheduler, "solve", losing)
    frag = bt.measure_relax(n_per=3, constrained_per=3, device="cpu")
    assert frag["relax_valid"] is False
    assert frag["relax_never_worse"] is True


@pytest.mark.parametrize("name", sorted(CHILD_LAUNCHES))
def test_child_probes_report_their_kernel_launches(name, child_runs):
    from karpenter_tpu_torch import kernels

    port_run(name, child_runs)
    # every kernel counted by the children; on the CPU none launches
    assert CHILD_LAUNCHES[name] == {k.name: 0 for k in kernels.ALL}


def _rank_record(frac, parity, launches):
    return dict(slots=8, frac=frac, flush_ms=3.0, parity=parity,
                forward=None, launches=launches)


def test_multihost_reads_a_given_rank_verdict(monkeypatch):
    from scripts.dryrun_multihost_torch import summary

    calls = []

    def fake_child(cmd, timeout, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=(
            'LONE_AB {"on_ms": 2.0, "off_ms": 2.5, "ratio": 0.8}\n'
            'LAUNCHES {"packed_score": 0, "price_step_score": 2}\n'),
            stderr="")

    monkeypatch.setattr(bt, "run_child", fake_child)
    mhost = summary([_rank_record(0.5, True, {"packed_score": 1,
                                              "price_step_score": 0}),
                     _rank_record(0.5, False, {"packed_score": 0,
                                               "price_step_score": 0})],
                    2, 4)
    launches = {}
    frag = bt.measure_multihost_fence(2, 4, device="cpu", summary=mhost,
                                      launches=launches)
    assert len(calls) == 1 and "--lone-ab" in calls[0]
    assert frag["multihost_parity"] is False
    assert frag["multihost_fence_frac"] == 0.5
    assert frag["multihost_lone_latency_ratio"] == 0.8
    assert launches == {"packed_score": 1, "price_step_score": 2}
    with pytest.raises(ValueError):
        bt.measure_multihost_fence(2, 2, device="cpu", summary=mhost)


def test_replica_removes_its_socket_directory(tmp_path, monkeypatch):
    from karpenter_tpu_torch.metrics import Registry

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with bt._oracle_replica(Registry(), "cpu") as (_service, sock):
        assert sock.startswith(f"unix:{tmp_path}")
    assert list(tmp_path.iterdir()) == []
