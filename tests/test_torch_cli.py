"""The port's command line (``cli.py``, ``operator.main``, the overload
demo ``admission/__main__.py`` and the sidecar's ``--obs-port``) against
the reference package's, on the CPU, each command in a fresh process.

``version``, ``solve --device cpu`` and ``demo --device cpu`` print what
the reference's CLI prints for the same arguments (``solve``'s wall time
aside); the remote demo — ``cli serve --device cpu`` as a sidecar and
``cli demo --solver-address`` with no card visible — prints what the
in-process demo prints.  The port refuses ``bench`` without a card (it
runs ``bench_all_torch.py``, on the card or with ``--device cpu``) and a
non-zero ``--profile-port``, with their messages, says in one line where
``--jit-cache-dir`` puts the kernel library (building nothing on the
CPU), and writes ``metrics-doc`` to stdout
or ``--out`` but never over the reference's ``docs/METRICS.md``.

Tolerance: equal.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
#: one host thread per child process: the suite runs files side by side
QUIET = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
         "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                      "intra_op_parallelism_threads=1"}


def run(*args, env=None, timeout=300, cwd=ROOT):
    base = {k: v for k, v in os.environ.items()
            if k not in ("KT_SANITIZE", "KARPENTER_SOLVER_ADDR",
                         "KT_JIT_CACHE_DIR", "KT_OBS_PEERS")}
    base["JAX_PLATFORMS"] = "cpu"
    base["PYTHONPATH"] = str(ROOT)
    base.update(QUIET)
    base.update(env or {})
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=base,
                          capture_output=True, text=True, timeout=timeout)


def ref_cli(*args, **kw):
    return run("karpenter_tpu.cli", *args, **kw)


def port_cli(*args, **kw):
    return run("karpenter_tpu_torch.cli", *args, **kw)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_version_prints_the_reference_line():
    a, b = ref_cli("version"), port_cli("version")
    assert (a.returncode, b.returncode) == (0, 0)
    assert b.stdout == a.stdout and b.stdout.startswith("karpenter-tpu ")


def _solve_doc(proc):
    doc = json.loads(proc.stdout)
    doc.pop("solve_ms")
    return doc


@pytest.mark.parametrize("backend", ["oracle", "tpu"])
def test_solve_prints_the_reference_plan(backend):
    args = ("solve", "--pods", "30", "--small", "--backend", backend,
            "--assignments", "--compact")
    a = ref_cli(*args)
    b = port_cli(*args, "--device", "cpu")
    assert (a.returncode, b.returncode) == (0, 0), b.stderr[-2000:]
    assert _solve_doc(b) == _solve_doc(a)


def test_solve_scenario_file_and_its_infeasible_exit_code(tmp_path):
    scenario = tmp_path / "s.json"
    scenario.write_text(json.dumps({
        "pods": [{"name": "a", "requests": {"cpu": 2.0}},
                 {"name": "b", "requests": {"cpu": 4.0},
                  "node_selector": {"topology.kubernetes.io/zone":
                                    "zone-1b"}},
                 {"name": "huge", "requests": {"cpu": 4096.0}}],
        "provisioners": [{"name": "default", "limits": {"cpu": 1000}}]}))
    a = ref_cli("solve", "--scenario", str(scenario), "--small",
                "--backend", "oracle")
    b = port_cli("solve", "--scenario", str(scenario), "--small",
                 "--backend", "oracle", "--device", "cpu")
    assert (a.returncode, b.returncode) == (3, 3)
    assert _solve_doc(b) == _solve_doc(a)


def test_solve_without_a_card_refuses():
    b = port_cli("solve", "--pods", "3", "--small", "--backend", "oracle",
                 env={"CUDA_VISIBLE_DEVICES": ""})
    assert b.returncode != 0 and "CUDA" in b.stderr


@pytest.mark.parametrize("backend", ["oracle", "tpu"])
def test_demo_prints_the_reference_lines(backend):
    args = ("demo", "--pods", "60", "--small", "--backend", backend)
    a = ref_cli(*args)
    b = port_cli(*args, "--device", "cpu")
    assert (a.returncode, b.returncode) == (0, 0), b.stderr[-2000:]
    assert b.stdout == a.stdout
    assert "pending=0" in b.stdout


def test_demo_prints_the_tracez_and_statusz_snapshot():
    b = port_cli("demo", "--pods", "20", "--small", "--backend", "oracle",
                 "--device", "cpu", "--tracez")
    assert b.returncode == 0, b.stderr[-2000:]
    assert "== /tracez ==" in b.stdout
    statusz = json.loads(b.stdout.split("== /statusz ==", 1)[1])
    assert statusz["fallbacks"]["remote_degraded"] is False


def test_remote_demo_through_a_sidecar_prints_the_in_process_lines():
    """The deployed topology on the host: ``cli serve --device cpu`` and
    ``cli demo --solver-address`` with no card visible print what the
    in-process demo prints; the sidecar's obs port answers, and SIGTERM
    drains and stops it."""
    port, obs = free_port(), free_port()
    env = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
    env["PYTHONPATH"] = str(ROOT)
    env.update(QUIET)
    sidecar = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch.cli", "serve",
         "--device", "cpu", "--backend", "tpu", "--port", str(port),
         "--obs-port", str(obs)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{obs}/statusz", timeout=2) as r:
                    assert r.status == 200
                break
            except OSError:
                assert sidecar.poll() is None and time.monotonic() < deadline
                time.sleep(0.3)
        args = ("demo", "--pods", "60", "--small", "--backend", "tpu")
        remote = port_cli(*args, "--solver-address", f"127.0.0.1:{port}",
                          "--tracez", env={"CUDA_VISIBLE_DEVICES": ""})
        with urllib.request.urlopen(f"http://127.0.0.1:{obs}/statusz",
                                    timeout=30) as r:
            admitted = json.loads(r.read())["admission"]["admitted"]
        sidecar.send_signal(signal.SIGTERM)
        out, err = sidecar.communicate(timeout=60)
    finally:
        if sidecar.poll() is None:
            sidecar.kill()
            sidecar.wait()
    local = port_cli(*args, "--device", "cpu")
    assert remote.returncode == 0, remote.stderr[-2000:]
    assert "fallback" not in remote.stderr
    lines = [ln for ln in remote.stdout.splitlines() if "->" in ln
             or ln.startswith("scale-")]
    assert lines == local.stdout.splitlines()
    assert admitted["critical"] >= 1
    assert sidecar.returncode == 0
    assert "device=cpu" in out and "observability on" in out
    assert "draining" in out and "solver sidecar stopped" in out


def test_bench_is_refused_with_its_message():
    # the bench runs on the card: without one and without --device it
    # refuses with an error line naming CUDA
    b = port_cli("bench", "--configs", "6", env={"CUDA_VISIBLE_DEVICES": ""})
    assert b.returncode != 0
    rec = json.loads(b.stdout.strip().splitlines()[-1])
    assert rec["value"] is None and "CUDA" in rec["error"]


@pytest.mark.parametrize("command", ["demo", "serve"])
def test_a_profiler_port_is_refused(command):
    b = port_cli(command, "--profile-port", "9999", "--device", "cpu")
    assert b.returncode == 2
    assert "karpenter_tpu_torch.profile_wave" in b.stderr


def test_jit_cache_dir_says_it_does_nothing(tmp_path):
    cache = tmp_path / "jit"
    b = port_cli("solve", "--pods", "4", "--small", "--backend", "oracle",
                 "--device", "cpu", "--jit-cache-dir", str(cache))
    assert b.returncode == 0
    notes = [ln for ln in b.stderr.splitlines() if "cache at" in ln]
    assert notes == [f"kernel library cache at {cache}"]
    # a CPU solve builds no kernel library, so the directory is not made
    assert not cache.exists()
    # KT_JIT_CACHE wins over the flag
    env_cache = tmp_path / "env"
    b = port_cli("solve", "--pods", "4", "--small", "--backend", "oracle",
                 "--device", "cpu", "--jit-cache-dir", str(cache),
                 env={"KT_JIT_CACHE": str(env_cache)})
    assert b.returncode == 0
    assert f"kernel library cache at {env_cache}" in b.stderr.splitlines()
    assert not cache.exists() and not env_cache.exists()


def test_metrics_doc_goes_to_stdout_or_out_never_the_reference_page(
        tmp_path):
    b = port_cli("metrics-doc")
    assert b.returncode == 0 and b.stdout.startswith("# Metrics\n")
    assert "`karpenter_solver_remote_fallback_solves_total`" in b.stdout
    out = tmp_path / "m.md"
    assert port_cli("metrics-doc", "--out", str(out)).returncode == 0
    assert out.read_text() == b.stdout
    assert port_cli("metrics-doc", "--out", str(out),
                    "--check").returncode == 0
    out.write_text("stale\n")
    assert port_cli("metrics-doc", "--out", str(out),
                    "--check").returncode == 1
    before = (ROOT / "docs" / "METRICS.md").read_text()
    refused = port_cli("metrics-doc", "--out",
                       str(ROOT / "docs" / "METRICS.md"))
    assert refused.returncode == 2
    assert (ROOT / "docs" / "METRICS.md").read_text() == before


def test_operator_module_runs_the_demo():
    args = ("--demo", "--pods", "30", "--small", "--backend", "oracle")
    a = run("karpenter_tpu.operator", *args)
    b = run("karpenter_tpu_torch.operator", *args, "--device", "cpu")
    assert (a.returncode, b.returncode) == (0, 0)
    assert b.stdout == a.stdout


def test_overload_demo_runs_with_the_reference_scoreboard():
    args = ("--duration", "1")
    a = run("karpenter_tpu.admission", *args)
    b = run("karpenter_tpu_torch.admission", *args, "--device", "cpu")
    assert (a.returncode, b.returncode) == (0, 0), b.stderr[-2000:]

    def board(proc):
        text = proc.stdout.split("\n", 1)[1]
        doc = json.loads(text[:text.rindex("}") + 1])
        return sorted(doc), sorted(doc["stats"])

    assert board(b) == board(a)
    assert "critical protected:" in b.stdout
