"""The port's replay CLI (``scripts/replay_traffic_torch.py``) against the
reference's (``scripts/replay_traffic.py``) on the CPU, each in a fresh
process.

``--synthesize`` writes the reference's capture, record for record;
``--replay`` of that capture against an in-process replica on ``--device
cpu`` prints one JSON line with the reference CLI's keys, every request
served, the class mix intact and the conformance check clean, and exits
0; without ``--device`` and without a card it raises instead of running
on the host.

Tolerance: equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CAPTURE = ["--shape", "bursty", "--rate", "40", "--n", "16", "--seed", "9"]


def run(script, *args, env=None):
    base = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
    base.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
                OMP_NUM_THREADS="1", KT_SLO_P99_MS="5000")
    base.update(env or {})
    return subprocess.run([sys.executable, str(ROOT / "scripts" / script),
                           *args], cwd=ROOT, env=base, capture_output=True,
                          text=True, timeout=300)


def last_json(proc):
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_synthesize_then_replay_prints_the_reference_keys(tmp_path):
    ref_cap, port_cap = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    want = last_json(run("replay_traffic.py", "--synthesize", str(ref_cap),
                         *CAPTURE))
    got = last_json(run("replay_traffic_torch.py", "--synthesize",
                        str(port_cap), *CAPTURE))
    assert {**got, "written": None} == {**want, "written": None}
    assert port_cap.read_text() == ref_cap.read_text()

    ref = last_json(run("replay_traffic.py", "--replay", str(ref_cap),
                        "--speedup", "2"))
    port = last_json(run("replay_traffic_torch.py", "--replay",
                         str(port_cap), "--speedup", "2", "--device", "cpu"))
    assert set(port) == set(ref)
    assert port["outcomes"] == {"ok": 16}
    assert port["errors"] == 0 and port["class_mix_match"] is True
    assert port["conformance"]["ok"] is True
    assert port["class_mix"] == ref["class_mix"]


def test_replay_needs_the_card_without_device(tmp_path):
    cap = tmp_path / "c.jsonl"
    last_json(run("replay_traffic_torch.py", "--synthesize", str(cap),
                  *CAPTURE))
    proc = run("replay_traffic_torch.py", "--replay", str(cap),
               env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
