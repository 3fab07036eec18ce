"""The port's bench gates (``bench_torch.py``) against the reference's
(``bench.py``), on the CPU.

``check_budgets`` is the reference's gate verbatim: every case of
``tests/test_bench_gate.py`` runs against the port, and every record those
cases build gives the port exactly the reference's flags (the budget
constants are the reference's values).  ``check_regression`` reads only
the port's own ``bench_torch_rNN.json`` records, and only those measured
on the same device and card (their ``gpu`` field); the reference's
``BENCH_r*.json`` are never read.  The reference's backend-probe cache has
no counterpart: ``ensure_device()`` resolves to the card or raises, and
the watchdog exits with an error line and nothing re-run.

Tolerance: equal.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench_torch as bt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "benchmod_torch_gate", ROOT / "bench.py")
benchmod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(benchmod)

GPU = "NVIDIA H100 80GB HBM3, 700.00 W"


def check(rec):
    """The port's budget verdict on ``rec``, held equal to the
    reference's."""
    out = bt.check_budgets(rec)
    assert out == benchmod.check_budgets(rec)
    return out


# --- check_regression: the port's own records ------------------------------


def _write_prior(tmp_path, n, **kw):
    rec = {"metric": "m", "value": 150.0, "unit": "ms",
           "cold_first_solve_ms": 600.0, "tpu_nodes": 560,
           "cost_ratio_vs_ffd": 0.99, "device": "cuda", "gpu": GPU, **kw}
    (tmp_path / f"bench_torch_r{n:02d}.json").write_text(json.dumps(rec))
    return rec


def _rec(**kw):
    return {"value": 150.0, "cold_first_solve_ms": 600.0, "tpu_nodes": 560,
            "cost_ratio_vs_ffd": 0.99, "device": "cuda", "gpu": GPU, **kw}


def test_no_prior_rounds(tmp_path):
    assert bt.check_regression(_rec(value=100.0),
                               prior_dir=str(tmp_path)) == {}


def test_newest_round_wins(tmp_path):
    _write_prior(tmp_path, 3, value=999.0)
    _write_prior(tmp_path, 4, value=150.0)
    out = bt.check_regression(_rec(), prior_dir=str(tmp_path))
    assert out["prior_round"] == "bench_torch_r04.json"
    assert out["warm_vs_prior"] == 1.0
    assert "regression_flags" not in out


def test_rounds_sort_numerically(tmp_path):
    _write_prior(tmp_path, 9, value=999.0)
    (tmp_path / "bench_torch_r10.json").write_text(json.dumps(
        {"metric": "m", "value": 150.0, "device": "cuda", "gpu": GPU}))
    out = bt.check_regression(_rec(), prior_dir=str(tmp_path))
    assert out["prior_round"] == "bench_torch_r10.json"


def test_warm_regression_flagged(tmp_path):
    _write_prior(tmp_path, 4)
    out = bt.check_regression(_rec(value=180.0), prior_dir=str(tmp_path))
    assert any("warm" in f for f in out["regression_flags"])


def test_cold_regression_flagged(tmp_path):
    _write_prior(tmp_path, 4)
    out = bt.check_regression(_rec(cold_first_solve_ms=1000.0),
                              prior_dir=str(tmp_path))
    assert any("cold" in f for f in out["regression_flags"])


def test_quality_gain_excuses_latency(tmp_path):
    # slower but strictly fewer nodes: recorded, not flagged
    _write_prior(tmp_path, 4)
    out = bt.check_regression(_rec(value=180.0, tpu_nodes=500),
                              prior_dir=str(tmp_path))
    assert out["warm_vs_prior"] == 1.2
    assert "regression_flags" not in out


def test_within_budget_not_flagged(tmp_path):
    _write_prior(tmp_path, 4)
    out = bt.check_regression(_rec(value=160.0, cold_first_solve_ms=650.0),
                              prior_dir=str(tmp_path))
    assert "regression_flags" not in out


def test_driver_wrapped_artifact_parsed(tmp_path):
    # a wrapped artifact {"n", "cmd", "rc", "tail": "...<json line>..."}
    inner = json.dumps({"metric": "m", "value": 150.0,
                        "cold_first_solve_ms": 600.0, "tpu_nodes": 560,
                        "cost_ratio_vs_ffd": 0.99, "device": "cuda",
                        "gpu": GPU})
    (tmp_path / "bench_torch_r04.json").write_text(json.dumps(
        {"n": 4, "cmd": "python3 bench_torch.py", "rc": 0,
         "tail": "WARNING: some log line\n" + inner + "\n"}))
    out = bt.check_regression(_rec(value=165.1, cold_first_solve_ms=400.0),
                              prior_dir=str(tmp_path))
    assert out["prior_round"] == "bench_torch_r04.json"
    assert out["warm_vs_prior"] == 1.101
    assert out["cold_vs_prior"] == 0.667
    assert any("warm" in f for f in out["regression_flags"])


def test_errored_prior_skipped(tmp_path):
    _write_prior(tmp_path, 3)
    (tmp_path / "bench_torch_r04.json").write_text(json.dumps(
        {"metric": "m", "value": None, "error": "watchdog"}))
    out = bt.check_regression(_rec(), prior_dir=str(tmp_path))
    assert out["prior_round"] == "bench_torch_r03.json"


def test_record_without_gpu_skipped(tmp_path):
    _write_prior(tmp_path, 3)
    _write_prior(tmp_path, 4, value=10.0, gpu=None)
    out = bt.check_regression(_rec(), prior_dir=str(tmp_path))
    assert out["prior_round"] == "bench_torch_r03.json"
    assert "regression_flags" not in out


def test_other_card_or_device_not_compared(tmp_path):
    _write_prior(tmp_path, 3, gpu="NVIDIA H100 80GB HBM3, 500.00 W",
                 value=10.0)
    _write_prior(tmp_path, 4, device="cpu", value=10.0)
    assert bt.check_regression(_rec(), prior_dir=str(tmp_path)) == {}
    # a host rehearsal (no gpu field) never compares to a card's record
    assert bt.check_regression(_rec(device="cpu", gpu=None),
                               prior_dir=str(tmp_path)) == {}


def test_reference_records_never_read(tmp_path):
    # the reference's TPU / JAX-on-CPU records, even carrying a gpu field
    (tmp_path / "BENCH_r05.json").write_text(json.dumps(
        {"metric": "m", "value": 24.244, "device": "cuda", "gpu": GPU}))
    assert bt.check_regression(_rec(), prior_dir=str(tmp_path)) == {}


def test_write_record_takes_the_next_round(tmp_path):
    _write_prior(tmp_path, 7)
    path = bt.write_record(_rec(value=140.0), record_dir=tmp_path)
    assert path.name == "bench_torch_r08.json"
    out = bt.check_regression(_rec(value=140.0), prior_dir=str(tmp_path))
    assert out["prior_round"] == "bench_torch_r08.json"
    assert out["warm_vs_prior"] == 1.0


# --- device and watchdog: no fallback ---------------------------------------


def test_ensure_device_raises_without_cuda_and_never_returns_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.ensure_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.ensure_device("cuda")
    # only an explicit request runs on the host
    assert bt.ensure_device("cpu") == torch.device("cpu")


def test_watchdog_prints_an_error_line_and_reruns_nothing():
    snippet = ("import time, bench_torch as b; "
               "b.arm_watchdog(0.5, metric='m'); time.sleep(30)")
    env = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", snippet], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "m" and rec["value"] is None
    assert rec["error"].startswith("watchdog: exceeded")


def test_bench_without_a_card_prints_an_error_line():
    env = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["value"] is None and "CUDA" in rec["error"]


# --- check_budgets: the reference's cases -----------------------------------


class TestBudgetGate:
    """Absolute per-round budgets: steady-state tensorize under threshold,
    cached-path byte parity, FFD cost parity."""

    BASE = {"tensorize_steady_ms": 3.2, "tensorize_parity": True,
            "cost_ratio_vs_ffd": 0.99,
            "tensorize_cold_ms": 200.0, "tensorize_shape_ms": 110.0}

    def test_within_budgets_clean(self):
        assert check(dict(self.BASE)) == {}

    def test_steady_tensorize_over_budget_flagged(self):
        out = check(dict(self.BASE, tensorize_steady_ms=31.0))
        assert any("tensorize" in f for f in out["budget_flags"])

    def test_shape_tier_regression_flagged(self):
        out = check(dict(self.BASE, tensorize_shape_ms=190.0))
        assert any("shape-tier" in f for f in out["budget_flags"])

    def test_parity_break_flagged(self):
        out = check(dict(self.BASE, tensorize_parity=False))
        assert any("diverged" in f for f in out["budget_flags"])

    def test_cost_ratio_over_ceiling_flagged(self):
        out = check(dict(self.BASE, cost_ratio_vs_ffd=1.03))
        assert any("cost_ratio" in f for f in out["budget_flags"])

    def test_missing_fields_not_flagged(self):
        assert check({"value": 100.0}) == {}

    def test_trace_overhead_over_budget_flagged(self):
        out = check(dict(self.BASE, trace_overhead_pct=3.5))
        assert any("trace overhead" in f for f in out["budget_flags"])

    def test_trace_overhead_within_budget_clean(self):
        assert check(dict(self.BASE, trace_overhead_pct=1.2)) == {}
        # the noise floor can read slightly negative — never a flag
        assert check(dict(self.BASE, trace_overhead_pct=-0.8)) == {}

    def test_ts_overhead_over_budget_flagged(self):
        out = check(dict(self.BASE, ts_overhead_pct=2.5))
        assert any("time-series sampler" in f for f in out["budget_flags"])


OVERLOAD_OK = {
    "admission_overhead_pct": 0.4,
    "unloaded_critical_p99_ms": 90.0,
    "overload_critical_p99_ms": 150.0,
    "overload_critical_p99_ratio": 1.67,
    "overload_critical_sheds": 0.0,
    "overload_best_effort_sheds": 120.0,
}


def test_overload_budgets_clean():
    assert check(dict(OVERLOAD_OK)) == {}


def test_critical_p99_blowout_flagged():
    flags = check(dict(OVERLOAD_OK,
                       overload_critical_p99_ratio=2.4))["budget_flags"]
    assert any("critical p99 under 4x overload" in f for f in flags)


def test_critical_shed_flagged():
    flags = check(dict(OVERLOAD_OK, overload_critical_sheds=2.0))["budget_flags"]
    assert any("critical" in f and "shed" in f for f in flags)


def test_no_best_effort_sheds_flagged():
    flags = check(dict(OVERLOAD_OK,
                       overload_best_effort_sheds=0.0))["budget_flags"]
    assert any("did not engage" in f for f in flags)


def test_admission_overhead_flagged():
    flags = check(dict(OVERLOAD_OK, admission_overhead_pct=3.5))["budget_flags"]
    assert any("admission budget" in f for f in flags)


SHARDED_OK = {
    "sharded_devices": 8,
    "sharded_serial_per_sec": 2.5,
    "sharded_mega_per_sec": 39.8,
    "sharded_megabatch_speedup": 15.9,
    "sharded_single_latency_ratio": 0.95,
    "sharded_batch_occupancy": 8.0,
}


def test_sharded_budgets_clean():
    assert check(dict(SHARDED_OK)) == {}


def test_sharded_megabatch_not_beating_serial_flagged():
    for speedup in (0.97, 1.0):
        flags = check(dict(SHARDED_OK,
                           sharded_megabatch_speedup=speedup))["budget_flags"]
        assert any("meshed serial baseline" in f for f in flags)


def test_sharded_single_latency_tax_flagged():
    flags = check(dict(SHARDED_OK,
                       sharded_single_latency_ratio=1.2))["budget_flags"]
    assert any("meshed single-request latency" in f for f in flags)


def test_sharded_phase_missing_not_flagged():
    assert check({"sharded_error": "rc=1: boom"}) == {}


class TestWarmstartAndSweepGates:
    GOOD = {"warmstart_p50_ms": 0.7, "warmstart_cost_ratio": 1.004,
            "warmstart_full_fallbacks": 0,
            "sweep_speedup": 5.6, "sweep_candidates": 16,
            "sweep_dispatches": 1, "sweep_decisions_match": True}

    def test_within_budgets_clean(self):
        assert check(dict(self.GOOD)) == {}

    def test_delta_p50_over_budget_flagged(self):
        out = check(dict(self.GOOD, warmstart_p50_ms=1.4))
        assert any("delta solve p50" in f for f in out["budget_flags"])

    def test_warmstart_cost_ratio_flagged(self):
        out = check(dict(self.GOOD, warmstart_cost_ratio=1.05))
        assert any("warm-start chain cost" in f for f in out["budget_flags"])

    def test_steady_state_full_fallbacks_flagged(self):
        out = check(dict(self.GOOD, warmstart_full_fallbacks=3))
        assert any("fell back" in f for f in out["budget_flags"])

    def test_sweep_speedup_under_budget_flagged(self):
        out = check(dict(self.GOOD, sweep_speedup=3.1))
        assert any("sweep speedup" in f for f in out["budget_flags"])

    def test_sweep_decision_divergence_flagged(self):
        out = check(dict(self.GOOD, sweep_decisions_match=False))
        assert any("diverged" in f for f in out["budget_flags"])

    def test_sweep_multi_dispatch_flagged(self):
        out = check(dict(self.GOOD, sweep_dispatches=3))
        assert any("one vmapped dispatch" in f for f in out["budget_flags"])


class TestDeltaServingGates:
    GOOD = {"delta_rpc_p50_ms": 2.4, "delta_parity": True,
            "delta_chain_cost_ratio": 1.003,
            "delta_unexplained_fallbacks": 0, "delta_off_parity": True,
            "cold_restart_first_ms": 8400.0,
            "cold_restart_second_ms": 900.0,
            "cold_restart_cache_populated": True}

    def test_within_budgets_clean(self):
        assert check(dict(self.GOOD)) == {}

    def test_rpc_p50_over_budget_flagged(self):
        out = check(dict(self.GOOD, delta_rpc_p50_ms=3.6))
        assert any("delta RPC p50" in f for f in out["budget_flags"])

    def test_wire_divergence_flagged(self):
        out = check(dict(self.GOOD, delta_parity=False))
        assert any("not lossless" in f for f in out["budget_flags"])

    def test_chain_cost_over_ceiling_flagged(self):
        out = check(dict(self.GOOD, delta_chain_cost_ratio=1.05))
        assert any("chain cost ratio" in f for f in out["budget_flags"])

    def test_unexplained_fallbacks_flagged(self):
        out = check(dict(self.GOOD, delta_unexplained_fallbacks=2))
        assert any("fell back" in f for f in out["budget_flags"])

    def test_kill_switch_divergence_flagged(self):
        out = check(dict(self.GOOD, delta_off_parity=False))
        assert any("KT_DELTA=0" in f for f in out["budget_flags"])

    def test_unpopulated_jit_cache_flagged(self):
        out = check(dict(self.GOOD, cold_restart_cache_populated=False))
        assert any("KT_JIT_CACHE" in f for f in out["budget_flags"])

    def test_cold_restart_no_improvement_flagged(self):
        out = check(dict(self.GOOD, cold_restart_second_ms=9000.0))
        assert any("persistent cache" in f for f in out["budget_flags"])

    def test_missing_delta_fields_not_flagged(self):
        assert check({"value": 100.0}) == {}


class TestRestartRecoveryGates:
    GOOD = {"restart_recovery_clients": 4,
            "restart_recovery_resends_with_snapshot": 0,
            "restart_recovery_resends_without": 4,
            "restart_first_delta_p50_ms": 2.8}

    def test_within_budgets_clean(self):
        assert check(dict(self.GOOD)) == {}

    def test_resends_after_snapshot_restart_flagged(self):
        out = check(dict(self.GOOD, restart_recovery_resends_with_snapshot=2))
        assert any("WITH a session snapshot" in f
                   for f in out["budget_flags"])

    def test_wrong_no_spool_baseline_flagged(self):
        for wrong in (2, 7):
            out = check(dict(self.GOOD,
                             restart_recovery_resends_without=wrong))
            assert any("exactly one full solve per client" in f
                       for f in out["budget_flags"])

    def test_slow_restore_flagged(self):
        out = check(dict(self.GOOD, restart_first_delta_p50_ms=900.0))
        assert any("restore budget" in f for f in out["budget_flags"])

    def test_missing_restart_fields_not_flagged(self):
        assert check({"value": 100.0}) == {}


class TestFleetFailoverGates:
    GOOD = {"fleet_victim_sessions": 3,
            "fleet_warm_failover_resends": 0,
            "fleet_steal_adoptions": 3,
            "fleet_cold_victim_sessions": 2,
            "fleet_cold_failover_resends": 2}

    def test_within_budgets_clean(self):
        assert check(dict(self.GOOD)) == {}

    def test_warm_failover_resends_flagged(self):
        out = check(dict(self.GOOD, fleet_warm_failover_resends=2))
        assert any("kill-one-of-N failover WITH the shared spool" in f
                   for f in out["budget_flags"])

    def test_unexercised_scenario_flagged(self):
        out = check(dict(self.GOOD, fleet_victim_sessions=0,
                         fleet_steal_adoptions=0))
        assert any("never exercised" in f for f in out["budget_flags"])

    def test_missing_steal_adoptions_flagged(self):
        out = check(dict(self.GOOD, fleet_steal_adoptions=1))
        assert any("not adopting" in f for f in out["budget_flags"])

    def test_wrong_cold_baseline_flagged(self):
        for wrong in (0, 5):
            out = check(dict(self.GOOD, fleet_cold_failover_resends=wrong))
            assert any("exactly one full solve per session" in f
                       for f in out["budget_flags"])

    def test_missing_fleet_fields_not_flagged(self):
        assert check({"value": 100.0}) == {}


class TestMultihostFenceGates:
    GOOD = {"multihost_processes": 2,
            "multihost_fence_frac": 0.5,
            "multihost_parity": True,
            "multihost_lone_latency_ratio": 0.97}

    def test_within_budgets_clean(self):
        assert check(dict(self.GOOD)) == {}

    def test_whole_batch_fence_frac_flagged(self):
        out = check(dict(self.GOOD, multihost_fence_frac=1.0))
        assert any("DCN for slots they do not own" in f
                   for f in out["budget_flags"])

    def test_exact_share_with_tolerance_clean(self):
        assert check(dict(self.GOOD, multihost_fence_frac=0.6)) == {}

    def test_parity_divergence_flagged(self):
        out = check(dict(self.GOOD, multihost_parity=False))
        assert any("byte-identical" in f for f in out["budget_flags"])

    def test_lone_latency_tax_flagged(self):
        out = check(dict(self.GOOD, multihost_lone_latency_ratio=1.31))
        assert any("lone meshed flush" in f for f in out["budget_flags"])

    def test_skipped_run_not_flagged(self):
        assert check({"multihost_skipped": "no gloo"}) == {}

    def test_fleet_jit_cache_regression_flagged(self):
        out = check({"cold_restart_first_ms": 8000.0,
                     "cold_restart_second_ms": 2000.0,
                     "cold_restart_fleet_ms": 9000.0})
        assert any("shared fleet jit cache" in f
                   for f in out["budget_flags"])


class TestHierarchicalGates:
    GOOD = {"hier_model_1m_ms": 130.0, "hier_cost_ratio": 1.008,
            "hier_infeasible_regressions": 0,
            "hier_disjoint_parity": True, "hier_pallas_parity": True,
            "hier_dispatches_per_wave": 1}

    def test_within_budgets_clean(self):
        assert check(dict(self.GOOD)) == {}

    def test_model_over_target_flagged(self):
        out = check(dict(self.GOOD, hier_model_1m_ms=251.0))
        assert any("1M-pod hierarchical solve" in f
                   for f in out["budget_flags"])
        # the budget is a strict ceiling: AT the target also flags
        out = check(dict(self.GOOD,
                         hier_model_1m_ms=bt.HIER_MODEL_1M_BUDGET_MS))
        assert any("1M-pod" in f for f in out["budget_flags"])

    def test_cost_ratio_over_ceiling_flagged(self):
        out = check(dict(self.GOOD, hier_cost_ratio=1.03))
        assert any("not reconciling cross-block contention" in f
                   for f in out["budget_flags"])
        # the 1.02 ceiling itself is inclusive-OK
        assert check(dict(self.GOOD,
                          hier_cost_ratio=bt.COST_PARITY_CEILING)) == {}

    def test_infeasible_regression_flagged(self):
        out = check(dict(self.GOOD, hier_infeasible_regressions=3))
        assert any("no straggler" in f for f in out["budget_flags"])

    def test_disjoint_divergence_flagged(self):
        out = check(dict(self.GOOD, hier_disjoint_parity=False))
        assert any("fully decoupled blocks" in f
                   for f in out["budget_flags"])

    def test_kernel_divergence_flagged(self):
        out = check(dict(self.GOOD, hier_pallas_parity=False))
        assert any("packed-score kernel diverged" in f
                   for f in out["budget_flags"])

    def test_extra_dispatches_per_wave_flagged(self):
        out = check(dict(self.GOOD, hier_dispatches_per_wave=2.0))
        assert any("ONE vmapped dispatch" in f for f in out["budget_flags"])

    def test_fallback_error_flagged(self):
        out = check({"hier_error": "fell back"})
        assert any("hierarchical bench fell back" in f
                   for f in out["budget_flags"])

    def test_phase_missing_not_flagged(self):
        assert check({"solve_p50_ms": 30.0}) == {}


class TestGangGates:
    GOOD = {"gang_atomicity_violations": 0, "gang_retracted_untyped": 0,
            "gang_spread_naive_zones": 3, "gang_spread_packed_zones": 1,
            "gang_pack_whole": True, "gang_latency_ratio": 1.02}

    def test_within_budgets_clean(self):
        assert check(dict(self.GOOD)) == {}

    @pytest.mark.parametrize("field,value,needle", [
        ("gang_atomicity_violations", 1, "PARTIALLY placed"),
        ("gang_retracted_untyped", 2, "typed GangUnplaced"),
        ("gang_spread_packed_zones", 3, "co-location what-if"),
        ("gang_pack_whole", False, "lost member"),
        ("gang_latency_ratio", 1.2, "gang machinery"),
    ])
    def test_breach_flagged(self, field, value, needle):
        out = check(dict(self.GOOD, **{field: value}))
        assert any(needle in f for f in out["budget_flags"])


class TestRelaxAndReplayGates:
    GOOD = {"relax_cost_ratio": 0.93, "relax_cost_ratio_vs_ffd": 0.92,
            "relax_latency_ratio": 1.4, "relax_never_worse": True,
            "relax_valid": True, "replay_interarrival_p50_err": 0.01,
            "replay_class_mix_match": True, "replay_errors": 0,
            "single_latency_ratio": 1.01, "solves_per_sec_c1": 1.2,
            "solves_per_sec_c32": 9.8, "cold_first_solve_warm_ms": 40.0,
            "cold_first_solve_warm_served_cold": False}

    def test_within_budgets_clean(self):
        assert check(dict(self.GOOD)) == {}

    @pytest.mark.parametrize("field,value,needle", [
        ("relax_cost_ratio", 1.0, "not strictly below 1.0"),
        ("relax_cost_ratio_vs_ffd", 0.989, "better-than-FFD bar"),
        ("relax_latency_ratio", 2.5, "scan-only solve"),
        ("relax_never_worse", False, "min-of-two select"),
        ("relax_valid", False, "ground-truth validator"),
        ("replay_interarrival_p50_err", 0.3, "distorting the traffic"),
        ("replay_class_mix_match", False, "class mix diverged"),
        ("replay_errors", 2, "replayed request(s) errored"),
        ("single_latency_ratio", 1.2, "coalescer-off path"),
        ("solves_per_sec_c32", 1.0, "does not beat the serial"),
        ("cold_first_solve_warm_ms", 120.0, "AOT budget"),
        ("cold_first_solve_warm_served_cold", True, "precompile did not"),
    ])
    def test_breach_flagged(self, field, value, needle):
        out = check(dict(self.GOOD, **{field: value}))
        assert any(needle in f for f in out["budget_flags"])


class TestTuningGates:
    GOOD = {"tuning_throughput_ratio": 1.01,
            "tuning_critical_p99_ratio": 0.97,
            "tuning_new_critical_sheds": 0,
            "tuning_overhead_pct": 0.2,
            "tuning_steps": 48,
            "tuning_replay_errors": 0}

    def test_within_budgets_clean(self):
        assert check(dict(self.GOOD)) == {}

    def test_throughput_below_floor_flagged(self):
        out = check(dict(self.GOOD, tuning_throughput_ratio=0.9))
        assert any("static run's throughput" in f
                   for f in out["budget_flags"])
        assert check(dict(self.GOOD,
                          tuning_throughput_ratio=bt.TUNING_THROUGHPUT_FLOOR)
                     ) == {}

    def test_critical_p99_over_slack_flagged(self):
        out = check(dict(self.GOOD, tuning_critical_p99_ratio=1.31))
        assert any("protected class" in f for f in out["budget_flags"])
        assert check(dict(
            self.GOOD,
            tuning_critical_p99_ratio=bt.TUNING_CRITICAL_P99_SLACK)) == {}

    def test_new_critical_sheds_flagged(self):
        out = check(dict(self.GOOD, tuning_new_critical_sheds=1))
        assert any("guardrails are not holding" in f
                   for f in out["budget_flags"])

    def test_controller_overhead_flagged(self):
        out = check(dict(self.GOOD, tuning_overhead_pct=3.1))
        assert any("feedback loop itself became load" in f
                   for f in out["budget_flags"])

    def test_replay_errors_flagged(self):
        out = check(dict(self.GOOD, tuning_replay_errors=2))
        assert any("errored during the self-tuning" in f
                   for f in out["budget_flags"])

    def test_missing_tuning_fields_not_flagged(self):
        assert check({"value": 100.0}) == {}


# --- parity with the reference over every base record at once ---------------

_BASES = {
    "tensorize": TestBudgetGate.BASE, "overload": OVERLOAD_OK,
    "sharded": SHARDED_OK, "warmstart": TestWarmstartAndSweepGates.GOOD,
    "delta": TestDeltaServingGates.GOOD,
    "restart": TestRestartRecoveryGates.GOOD,
    "fleet": TestFleetFailoverGates.GOOD,
    "multihost": TestMultihostFenceGates.GOOD,
    "hier": TestHierarchicalGates.GOOD, "gang": TestGangGates.GOOD,
    "relax": TestRelaxAndReplayGates.GOOD, "tuning": TestTuningGates.GOOD,
}


def _breaches():
    """Each base record, and the record with each of its numeric fields
    doubled plus one and each flag flipped, and every base merged into
    one record."""
    out = [("empty", {})]
    merged = {}
    for name, base in _BASES.items():
        out.append((name, dict(base)))
        merged.update(base)
        for k, v in base.items():
            if isinstance(v, bool):
                out.append((f"{name}-{k}", dict(base, **{k: not v})))
            elif isinstance(v, (int, float)):
                out.append((f"{name}-{k}", dict(base, **{k: 2 * v + 1})))
    out.append(("merged", merged))
    return out


@pytest.mark.parametrize("rec", [r for _, r in _breaches()],
                         ids=[n for n, _ in _breaches()])
def test_port_gate_equals_the_reference(rec):
    assert bt.check_budgets(rec) == benchmod.check_budgets(rec)


_CONSTANTS = [
    "METRIC", "TENSORIZE_STEADY_BUDGET_MS", "COST_PARITY_CEILING",
    "TENSORIZE_SHAPE_MAX_COLD_FRACTION", "TRACE_OVERHEAD_BUDGET_PCT",
    "TS_OVERHEAD_BUDGET_PCT", "SINGLE_LATENCY_REGRESSION_MAX",
    "WARMUP_COLD_SOLVE_BUDGET_MS", "WARMSTART_P50_BUDGET_MS",
    "SWEEP_SPEEDUP_MIN", "GANG_LATENCY_RATIO_MAX", "DELTA_RPC_P50_BUDGET_MS",
    "RESTART_FIRST_DELTA_P50_BUDGET_MS", "MULTIHOST_FENCE_FRAC_TOLERANCE",
    "REPLAY_INTERARRIVAL_P50_TOL", "OVERLOAD_CRITICAL_P99_MAX_RATIO",
    "ADMISSION_OVERHEAD_BUDGET_PCT", "TUNING_THROUGHPUT_FLOOR",
    "TUNING_CRITICAL_P99_SLACK", "TUNING_OVERHEAD_BUDGET_PCT",
    "RELAX_LATENCY_MAX_RATIO", "RELAX_FFD_CEILING",
    "HIER_MODEL_1M_BUDGET_MS", "HIER_SCALE_RUNGS",
]


@pytest.mark.parametrize("name", _CONSTANTS)
def test_budget_constant_equals_the_reference(name):
    assert getattr(bt, name) == getattr(benchmod, name)


def test_every_reference_budget_constant_is_carried():
    import re

    ref = {n for n in vars(benchmod)
           if re.fullmatch(r"[A-Z][A-Z0-9_]+", n)
           and re.search(r"BUDGET|CEILING|MAX|MIN|TOL|FLOOR|SLACK|FRACTION|"
                         r"RUNGS", n)}
    assert ref <= set(_CONSTANTS)
