"""The four demos of the port (``scripts/hier_demo_torch.py``,
``slo_demo_torch.py``, ``tune_demo_torch.py``, ``fleet_trace_demo_torch.py``)
against the reference's demos and the JAX package on the CPU.

- hier: the partition line, the buy line and the contended solve's line
  equal the reference demo's (its CLI in a fresh process), and the
  contended solve (blocks, price iterations, nodes, cost, infeasible pods,
  the plan) equals the reference's ``solve_hierarchical`` on the same
  8 x 1,250 batch under the same limit from the same node-name counter;
- slo: on ``--backend oracle`` the per-class verdicts and the exit code
  are the reference's (both under a 5 s latency objective, so that a
  loaded test host does not breach critical on latency; the split the
  demo shows is admission's, on the availability objective);
- tune: at ``--pairs 1`` both print the same keys with no replay error and
  exit by their verdict, and on the same scoreboards both exit rules give
  the same code;
- fleet: on ``device="cpu"`` the session's journey is one tree over two
  replicas, as the reference demo's is;
- without ``--device`` every demo raises on a machine without a card.

Tolerance: equal (plans: equal node plans or ``placements_tie``).
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from karpenter_tpu.models.catalog import generate_catalog as ref_catalog
from karpenter_tpu.models.provisioner import Provisioner as RefProv
from karpenter_tpu.models.tensorize import tensorize as ref_tensorize
from karpenter_tpu.solver import hierarchy as ref_hier
from karpenter_tpu.solver import types as ref_types
from karpenter_tpu.solver.scheduler import BatchScheduler as RefScheduler
from scripts import fleet_trace_demo_torch as fd
from scripts import fuzz_sweep_torch as fz
from scripts import hier_demo_torch as hd
from scripts import slo_demo_torch as slo

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the SLO demos' latency objective, raised above what a loaded test host
#: adds to an oracle solve: the slo cases hold the admission split (the
#: availability objective), which the latency threshold does not move
SLO_ENV = {"KT_SLO_P99_MS": "5000"}


def _run(script, *args, env=None, timeout=600):
    base = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
    base.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
                OMP_NUM_THREADS="1")
    base.update(env or {})
    return subprocess.run([sys.executable, str(ROOT / "scripts" / script),
                           *args], cwd=ROOT, env=base, capture_output=True,
                          text=True, timeout=timeout)


# ---- hier -------------------------------------------------------------------


@pytest.fixture(scope="module")
def hier_runs():
    ref_proc = _run("hier_demo.py")
    assert ref_proc.returncode in (0, 1), ref_proc.stderr[-2000:]
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port = hd.run(device="cpu")
    return ref_proc.stdout.splitlines(), buf.getvalue().splitlines(), port


def _strip_ms(line: str) -> str:
    return re.sub(r"(in|,) [0-9.]+ ms", r"\1 _ ms", line)


def test_hier_lines_are_the_reference_demos(hier_runs):
    ref, port, _run_out = hier_runs
    assert port[0] == "== 1M-pod hierarchical walk (cpu) =="
    assert _strip_ms(port[1]) == _strip_ms(ref[1])  # partition
    assert port[2] == ref[2]  # the unconstrained buy and the limit
    # the contended solve: blocks, waves, dispatches, price iterations,
    # repaired, tail-repacked, nodes, infeasible (the wall differs)
    assert _strip_ms(port[3]) == _strip_ms(ref[3])
    assert port[4].startswith("modeled 1M wall: host ")
    assert port[4].endswith("[FAIL: budget 250 ms]") or \
        port[4].endswith("[PASS: budget 250 ms]")


def test_hier_partition_is_the_references(hier_runs):
    _ref, _port, run = hier_runs
    provs = [RefProv(name="default").with_defaults()]
    st = ref_tensorize(_load("ref_hier_demo", "scripts/hier_demo.py")
                       .deployments(400, 25), provs, ref_catalog(full=False))
    comps = ref_hier.coupling_components(st)
    masks = ref_hier.partition_blocks(st, comps, 32)
    budgets = ref_hier.block_budgets(st, masks)
    part = run["partition"]
    assert (part["groups"], part["components"], part["blocks"],
            part["max_budget"]) == (st.G, len(comps), len(masks),
                                    int(round(max(budgets) * 100)))


def test_hier_contended_solve_is_the_references(hier_runs):
    _ref, _port, run = hier_runs
    demo = _load("ref_hier_demo_solve", "scripts/hier_demo.py")
    catalog = ref_catalog(full=False)
    provs = [RefProv(name="default").with_defaults()]
    pods = demo.deployments(8, 1250, tag="hw")
    sched = RefScheduler(backend="tpu", compile_behind=False)
    free = ref_hier.solve_hierarchical(sched, pods, provs, catalog, stats={})
    bought = sum(float(sched._tensorize(pods, provs, catalog, (), ())[0]
                       .capacity_row(n.instance_type, n.allocatable)[0])
                 for n in free.nodes)
    assert round(bought * 0.99, 1) == run["limit_cpu"]
    lim = RefProv(name="default").with_defaults()
    lim.limits = {"cpu": run["limit_cpu"]}
    with ref_types._node_lock:
        ref_types._node_next = run["names_at"]
    stats: dict = {}
    ref = ref_hier.solve_hierarchical(sched, pods, [lim], catalog,
                                      stats=stats)
    got, gstats = run["result"], run["stats"]
    for key in ("blocks", "waves", "dispatches", "price_iters",
                "repair_pods", "tail_repack_pods"):
        assert gstats[key] == stats[key], key
    assert len(got.nodes) == len(ref.nodes)
    assert abs(got.new_node_cost - ref.new_node_cost) <= 1e-6
    assert set(got.infeasible) == set(ref.infeasible)
    assert fz.same_plan(got, ref)


def test_hier_replay_on_another_device_gives_the_plan(hier_runs):
    _ref, _port, run = hier_runs
    res, stats = hd.contended("cpu", run["pods"], run["limit_cpu"],
                              run["names_at"])
    assert stats["price_iters"] == run["stats"]["price_iters"]
    assert fz.plan(res) == fz.plan(run["result"])
    # no card here: the price loop's score step ran its plain version
    assert run["launches"] == {"packed_score": 0, "price_step_score": 0}


# ---- slo --------------------------------------------------------------------


def test_slo_on_oracle_is_the_references_split():
    ref = _run("slo_demo.py", env=SLO_ENV)
    port = _run("slo_demo_torch.py", "--backend", "oracle", "--device", "cpu",
                env=SLO_ENV)
    assert port.returncode == ref.returncode == 0, port.stderr[-2000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    got = json.loads(port.stdout.strip().splitlines()[-1])
    assert got == want
    assert want["verdicts"]["best_effort"] in ("warn", "breach")
    assert want["verdicts"]["critical"] != "breach"
    lines = port.stdout.splitlines()
    assert lines[0] == ref.stdout.splitlines()[0]
    assert any(ln.startswith("critical latency: ") for ln in lines)


def test_slo_objective_verdicts_follow_the_engines_ladder(monkeypatch):
    for key, val in SLO_ENV.items():
        monkeypatch.setenv(key, val)
    report, doc = slo.run(backend="oracle", device="cpu")
    assert doc["config"]["p99_ms"] == 5000.0
    fast = doc["config"]["fast_burn"]
    be = doc["classes"]["best_effort"]
    assert slo.objective_verdict(be["availability"], fast) == "breach"
    assert slo.split_holds(doc)
    for cls, info in doc["classes"].items():
        worst = max((slo.objective_verdict(info[o], fast)
                     for o in ("availability", "latency")),
                    key=["no_data", "ok", "warn", "breach"].index)
        if info["verdict"] != "no_data":
            assert info["verdict"] == worst, cls
    assert report["outcomes"].get("error", 0) == 0


# ---- tune -------------------------------------------------------------------


def test_tune_at_one_pair_prints_the_reference_keys():
    ref = _run("tune_demo.py", "--pairs", "1", "--json")
    port = _run("tune_demo_torch.py", "--pairs", "1", "--json", "--device",
                "cpu")
    for proc in (ref, port):
        assert proc.returncode in (0, 1), proc.stderr[-2000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    got = json.loads(port.stdout.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["tuning_replay_errors"] == want["tuning_replay_errors"] == 0
    # each exits by its own verdict (the scoreboards are timing-bound)
    assert ref.returncode == (0 if want["ok"] else 1)
    assert port.returncode == (0 if got["ok"] else 1)


@pytest.mark.parametrize("board", [
    (1.01, 0.9, 0, {"ctrl_s": 0.01, "wall_s": 10.0, "errors": 0}),
    (0.97, 0.9, 0, {"ctrl_s": 0.01, "wall_s": 10.0, "errors": 0}),
    (1.01, 1.2, 0, {"ctrl_s": 0.01, "wall_s": 10.0, "errors": 0}),
    (1.01, 0.9, 1, {"ctrl_s": 0.01, "wall_s": 10.0, "errors": 0}),
    (1.01, None, 0, {"ctrl_s": 0.5, "wall_s": 10.0, "errors": 0}),
    (1.01, 0.9, 0, {"ctrl_s": 0.01, "wall_s": 10.0, "errors": 2}),
], ids=["holds", "throughput", "p99", "sheds", "overhead", "errors"])
def test_tune_exit_rule_is_the_references(board, monkeypatch, capsys):
    thr, p99r, sheds, agg = board
    agg = dict(agg, steps=3, learned={"max_wait_ms": 2.0},
               baseline={"max_wait_ms": 5.0}, static_thr=[10.0],
               judged_thr=[10.0 * thr], static_p99=[100.0],
               judged_p99=[100.0 * (p99r or 1.0)])
    codes = []
    for name, rel in (("ref_tune_demo", "scripts/tune_demo.py"),
                      ("port_tune_demo", "scripts/tune_demo_torch.py")):
        mod = _load(name, rel)
        monkeypatch.setattr(mod, "run_pairs",
                            lambda *a, **k: (thr, p99r, sheds, dict(agg)))
        codes.append(mod.main(["--pairs", "1"] + (
            ["--device", "cpu"] if name.startswith("port") else [])))
    assert codes[0] == codes[1]
    out = capsys.readouterr().out
    assert out.count("verdict:") == 2


# ---- fleet ------------------------------------------------------------------


def test_fleet_journey_is_one_cross_replica_tree():
    out = fd.run(backend="tpu", device="cpu", verbose=False)
    journey = out["journey"]
    assert out["ok"] and fd.journey_holds(journey)
    assert journey["n_hops"] >= 3
    assert len({h["replica"] for h in journey["hops"]}) >= 2
    assert [h["parent_hop"] for h in journey["hops"][1:]] == \
        [0] * (journey["n_hops"] - 1)
    assert out["served_after_kill"] != out["victim"]
    assert out["device"] == "cpu"


def test_fleet_verdict_is_the_reference_demos():
    ref = _run("fleet_trace_demo.py")
    port = _run("fleet_trace_demo_torch.py", "--backend", "oracle",
                "--device", "cpu")
    assert port.returncode == ref.returncode == 0, port.stderr[-2000:]
    verdict = [ln for ln in port.stdout.splitlines()
               if ln.startswith("journey: ")]
    assert verdict == [ln for ln in ref.stdout.splitlines()
                       if ln.startswith("journey: ")]
    assert verdict == ["journey: ONE cross-replica tree, remote-parent "
                       "linked — OK"]


# ---- the card ---------------------------------------------------------------


@pytest.mark.parametrize("script,args", [
    ("hier_demo_torch.py", ()), ("slo_demo_torch.py", ()),
    ("tune_demo_torch.py", ("--pairs", "1")),
    ("fleet_trace_demo_torch.py", ())])
def test_without_device_a_demo_needs_the_card(script, args):
    proc = _run(script, *args, env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
