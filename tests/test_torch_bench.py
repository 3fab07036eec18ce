"""The port's benchmark entry points (``bench_torch.py``,
``bench_all_torch.py``, ``karpenter-tpu-torch bench``) against the
reference's (``bench.py``, ``bench_all.py``) on the CPU.

- the headline scenario and configs 1, 3 and 5 build the reference's pods
  and provisioners, field for field;
- config 1's harness (``_ffd_and_tpu``) on ``device="cpu"`` gives the
  reference's node counts and infeasible counts on JAX-CPU, and its cost
  ratio to the 4 places both round to;
- config 6's interruption controller handles every message of the
  100-message rung;
- ``hierarchy.scale_model`` is the reference's model where the device
  per-pod rate is given, and raises without one;
- ``TpuSolver.solve(measure=True)`` returns the plan of
  ``measure=False`` with a first-execution ``compile_ms``;
- the hierarchical ladder runs end to end on the host;
- ``cli bench --device cpu --configs 6`` prints one config line and exits
  0; without a card and without ``--device`` it exits non-zero.

Tolerance: equal (cost ratios as rounded by both harnesses).
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_all_torch as bat
import bench_torch as bt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(name, file):
    spec = importlib.util.spec_from_file_location(name, ROOT / file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench = _load("benchmod_torch_bench", "bench.py")
bench_all = _load("bench_all_torch_ref", "bench_all.py")


def canon(x):
    """A package-independent view of a model object: class name and
    fields, recursively (dicts and sets sorted).  A pod's ``uid`` is left
    out: it comes from a process-wide counter, so it depends on how many
    pods each package built before."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple(
            (f.name, canon(getattr(x, f.name)))
            for f in dataclasses.fields(x) if f.name != "uid"))
    if isinstance(x, dict):
        return tuple(sorted((canon(k), canon(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return tuple(sorted(canon(v) for v in x))
    if hasattr(x, "__dict__") and not isinstance(x, type):
        return (type(x).__name__, canon(vars(x)))
    return x


class _Captured(Exception):
    pass


def _capture(module, monkeypatch, config):
    """The (pods, provisioners, catalog) a config hands its harness."""
    def grab(pods, provs, catalog, label, *rest):
        raise _Captured(pods, provs, catalog, label)

    monkeypatch.setattr(module, "_ffd_and_tpu", grab)
    with pytest.raises(_Captured) as got:
        config()
    return got.value.args


def test_headline_scenario_is_the_reference():
    ref_pods, ref_provs, ref_cat = bench.build_scenario()
    pods, provs, cat = bt.build_scenario()
    assert len(pods) == len(ref_pods) == 50_000
    for a, b in zip(ref_pods, pods):
        assert canon(a) == canon(b)
    assert canon(provs) == canon(ref_provs)
    assert [t.name for t in cat] == [t.name for t in ref_cat]


@pytest.mark.parametrize("n", [1, 3, 5])
def test_config_pods_and_provisioners_are_the_reference(monkeypatch, n):
    ref = _capture(bench_all, monkeypatch, getattr(bench_all, f"config{n}"))
    port = _capture(bat, monkeypatch, getattr(bat, f"config{n}"))
    assert len(port[0]) == len(ref[0])
    assert canon(port[0]) == canon(ref[0])
    assert canon(port[1]) == canon(ref[1])
    assert [t.name for t in port[2]] == [t.name for t in ref[2]]
    assert port[3] == ref[3]


def test_config1_harness_matches_the_reference(monkeypatch):
    with monkeypatch.context() as m:
        ref_args = _capture(bench_all, m, bench_all.config1)
    with monkeypatch.context() as m:
        port_args = _capture(bat, m, bat.config1)
    ref = bench_all._ffd_and_tpu(*ref_args)
    port = bat._ffd_and_tpu(*port_args, device="cpu")
    for key in ("tpu_nodes", "ffd_nodes", "infeasible", "infeasible_ffd",
                "cost_ratio_vs_ffd", "serving_tier", "serving_nodes",
                "serving_cost_ratio", "metric", "unit"):
        assert port[key] == ref[key], key
    assert port["value"] > 0 and port["compile_ms"] > 0
    assert set(port) == set(ref)


def test_config6_handles_every_message_of_the_first_rung():
    from karpenter_tpu_torch.models.catalog import generate_catalog

    handled, seconds = bat._interruption_run(generate_catalog(full=False),
                                             100)
    assert handled == 100 and seconds > 0


def test_scale_model_is_the_reference_given_a_device_rate():
    from karpenter_tpu.solver import hierarchy as ref_hier

    from karpenter_tpu_torch.solver import hierarchy as port_hier

    measured = {"n_pods": 10_000, "blocks": 4, "waves": 2,
                "partition_ms": 3.5, "entries_ms": 11.25, "repair_ms": 40.0,
                "device_per_pod_us": 7.75}
    for n in bt.HIER_SCALE_RUNGS:
        assert (port_hier.scale_model(dict(measured), n)
                == ref_hier.scale_model(dict(measured), n))
    assert (port_hier.scale_model(dict(measured, dispatch_overhead_ms=0.5),
                                  10_000)
            == ref_hier.scale_model(dict(measured, dispatch_overhead_ms=0.5),
                                    10_000))


def test_scale_model_needs_a_measured_device_rate():
    from karpenter_tpu_torch.solver import hierarchy as port_hier

    with pytest.raises(KeyError):
        port_hier.scale_model({"n_pods": 10_000, "blocks": 4}, 1_000_000)


def _plan(res):
    return (sorted((n.name, n.instance_type, n.zone, n.capacity_type,
                    n.price, tuple(sorted(p.name for p in n.pods)))
                   for n in res.nodes),
            sorted(res.assignments.items()), sorted(res.infeasible.items()))


def test_measure_keeps_the_plan_and_reports_the_first_execution():
    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.repack import reset_name_counters
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    pods, provs, catalog = bt.build_scenario()
    pods = pods[::50]  # 1,000 pods over all 20 spread deployments
    st = tensorize(pods, provs, catalog)
    solver = TpuSolver(device="cpu")
    reset_name_counters()
    plain = solver.solve(st, track_assignments=True)
    reset_name_counters()
    measured = solver.solve(st, track_assignments=True, measure=True)
    assert _plan(measured.result) == _plan(plain.result)
    assert np.array_equal(measured.takes, plain.takes)
    assert measured.n_used == plain.n_used
    assert plain.compile_ms == plain.solve_ms >= 0
    assert measured.compile_ms >= 0 and measured.solve_ms >= 0
    assert measured.result.solve_ms == measured.solve_ms


def test_hierarchical_ladder_runs_on_the_host():
    from karpenter_tpu_torch import kernels

    kernels.reset_counts()
    rec = bt.measure_hierarchical("cpu")
    assert rec["hier_pods"] == 10_000 and rec["hier_blocks"] == 4
    assert rec["hier_disjoint_parity"] is True
    assert rec["hier_pallas_parity"] is True
    assert rec["hier_kernel"] == "cpu packed_scan_scores vs plain"
    assert rec["hier_dispatches_per_wave"] == 1
    assert rec["hier_infeasible_regressions"] == 0
    assert rec["hier_device_per_pod_us"] > 0
    assert 0 < rec["hier_model_100k_ms"] < rec["hier_model_1m_ms"]
    # the host takes the plain version: no kernel launched
    assert all(k.launches == 0 for k in kernels.ALL)
    assert set(bt.check_budgets(rec)) <= {"budget_flags"}


def _cli_bench(*args, env=None):
    base = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
    base.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    base.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.cli", "bench", *args],
        cwd=ROOT, env=base, capture_output=True, text=True, timeout=300)


def test_cli_bench_on_the_host_prints_one_config_line():
    proc = _cli_bench("--device", "cpu", "--configs", "6")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["config"] == 6 and rec["device"] == "cpu"
    assert rec["gpu"] is None and "error" not in rec
    assert rec["value"] == rec["rate_15k"] > 0


def test_cli_bench_without_a_card_exits_nonzero():
    proc = _cli_bench("--configs", "6", env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["value"] is None and "CUDA" in rec["error"]
