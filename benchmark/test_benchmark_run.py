"""The harness end to end on the host, at a size a test run holds: the
manifest and the files it names, the result line, the import guard, and
``correct`` coming out false when the timed path is broken underneath.
The one test that needs the card is marked ``cuda``.

    python -m pytest benchmark -q
    python -m pytest benchmark -q -m cuda      (on the card)
"""

from __future__ import annotations

import ast
import copy
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parent.parent
CELLS = ("zonespread-50k.burst",)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def tiny(man, name: str) -> dict:
    """The cell at a host size: 3 deployments of 12 pods, one set, so
    that every offer of the window repeats the warm-up's set, 4 offers
    copied ahead, and the device path forced where the cell would route
    a small batch to the host."""
    c = copy.deepcopy(harness.cell(man, name))
    p = c["config"]["pending"]
    p["deployments"], p["replicas"] = 3, 12
    p["cpu"], p["memory_gib"] = p["cpu"][:3], p["memory_gib"][:3]
    c["traffic"].update(backend="tpu", sets=1, offers=4)
    return c


def run_tiny(man, name: str, trace: bool = False) -> dict:
    import torch

    return harness.run_cell(tiny(man, name), 2 ** 33 + 3, 1.0, trace,
                            torch.device("cpu"), time.perf_counter())


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------


def test_manifest_has_the_contract_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        if m["unit"] == "%":
            assert m["name"].endswith("_roofline")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(man, name):
    c = harness.cell(man, name)
    assert c["config"]["name"] == harness.cell(man, name)["config"]["name"]
    assert callable(harness.driver_class(c["traffic"]["entry"]))
    metrics = c["end_to_end"] + c["per_layer"]
    assert {"setup_s", "pods_per_s", "cost_vs_ffd"} <= {
        m["name"] for m in c["end_to_end"]}
    assert c["per_layer"]
    for m in metrics:
        assert callable(harness.reader(m["name"]))
    for cfg in man["configs"]:
        assert Path(ROOT / cfg["file"]).is_file()
        assert cfg["file"].startswith("benchmark/")


def test_an_unknown_cell_is_refused(man):
    with pytest.raises(KeyError):
        harness.cell(man, "no-such.cell")


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "karpenter_tpu_torch_x", sys)
    assert "karpenter_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "karpenter_tpu.solver", sys)
    assert harness.banned_modules() == ["karpenter_tpu"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("module", ["reference", "catalog", "workload",
                                    "roofline", "control"])
def test_the_reference_loads_nothing_of_the_program(module):
    assert not _imports(ROOT / "benchmark" / f"{module}.py") & {
        "karpenter_tpu_torch", "karpenter_tpu", "jax", "torch"}
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import benchmark.{module}, benchmark.reference; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith(('karpenter', 'jax'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax(man):
    code = (f"import sys, time, copy; sys.path.insert(0, {str(ROOT)!r})\n"
            "import torch\n"
            "from benchmark import harness, test_benchmark_run as t\n"
            "out = harness.run_cell(t.tiny(harness.manifest(), "
            "'zonespread-50k.burst'), 5, 0.5, False, torch.device('cpu'), "
            "time.perf_counter())\n"
            "print(harness.banned_modules(), out['correct'])\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT, check=True)
    assert got.stdout.strip().splitlines()[-1] == "[] True"


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------


def _run_py(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "zonespread-50k.burst", "--seed", str(2 ** 33), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    got = _run_py(ROOT)
    assert got.returncode == 2
    assert got.stdout == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only the benchmark's files: the program is not
    there, so a run stops before any result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time, torch; sys.path.insert(0, '.')\n"
            "from benchmark import harness\n"
            "c = harness.cell(harness.manifest(harness.ROOT), "
            "'zonespread-50k.burst', harness.ROOT)\n"
            "print(harness.run_cell(c, 1, 1.0, False, torch.device('cpu'), "
            "time.perf_counter()))\n")
    got = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode != 0
    assert "karpenter_tpu_torch" in got.stderr
    assert got.stdout == ""
    if not __import__("torch").cuda.is_available():
        assert _run_py(tmp_path).returncode != 0


# ---------------------------------------------------------------------------
# a run's line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(man, name, trace):
    out = run_tiny(man, name, trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["compared"] == {"plan_faults": {"value": 0, "limit": 0}}
    c = harness.cell(man, name)
    want = {m["name"]: m["unit"] for m in
            (c["per_layer"] if trace else c["end_to_end"])}
    got = {k: v["unit"] for k, v in out["metrics"].items()}
    assert set(got) <= set(want) and all(want[k] == u
                                         for k, u in got.items())
    if not trace:
        assert set(got) == set(want)
        assert all(v["value"] > 0 for v in out["metrics"].values())
    else:
        # the host has no device trace: the span readers report, the
        # device's readers find nothing and say nothing
        assert "tensorize.ms_per_solve" in got
        assert "device.launches_per_solve" not in got
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    json.dumps(out)


# ---------------------------------------------------------------------------
# correct comes out false when the timed path is broken underneath
# ---------------------------------------------------------------------------


def _unchanged(res, memo):
    """A solve that hands back the state it was given: no node bought."""
    res.nodes, res.assignments = [], {}
    return res


def _half_left_out(res, memo):
    """Half the batch never solved: the pods of every other deployment
    dropped from the plan."""
    def kept(name):
        dep = name.split("-")[1]
        return int(dep[1:]) % 2 == 0
    for n in res.nodes:
        n.pods = [p for p in n.pods if kept(p.name)]
    res.assignments = {p: n for p, n in res.assignments.items() if kept(p)}
    return res


def _altered(res, memo):
    """One answer altered where it is made: the first node's type swapped
    for the smallest one."""
    res.nodes[0].instance_type = "c5.large"
    return res


def _stale(res, memo):
    """A plan cached by shape: each set's first plan handed back for its
    later offers, with the pods under the earlier offer's names."""
    return memo.setdefault(next(iter(res.assignments)).split("-")[0], res)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered,
                                   _stale])
def test_a_broken_timed_path_reads_not_correct(man, monkeypatch, name,
                                               fault):
    from karpenter_tpu_torch.solver import scheduler

    orig = scheduler.PendingScheduleResult.result
    memo: dict = {}
    monkeypatch.setattr(scheduler.PendingScheduleResult, "result",
                        lambda self: fault(orig(self), memo))
    out = run_tiny(man, name)
    assert out["correct"] is False
    assert out["compared"]["plan_faults"]["value"] > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(card, name):
    got = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2 ** 33 + 17), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
