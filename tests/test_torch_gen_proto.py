"""``scripts/gen_proto_torch.py`` — the port's generator of its
``service/solver_pb2.py`` — against the checked-in module and the
reference's generator: ``--check`` exits 0, the regenerated text equals
the port's module (which is byte-identical to the reference's), the schema
deltas are the reference's, and a write reproduces the module.

Tolerance: equal.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gen = _load("gen_proto_torch")


def test_check_exits_zero():
    env = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "gen_proto_torch.py"),
         "--check"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_regenerated_text_is_the_checked_in_module():
    added, text, _fdp = gen.render()
    assert added == 0
    assert gen.OUT == ROOT / "karpenter_tpu_torch" / "service" / "solver_pb2.py"
    assert text == gen.OUT.read_text()
    assert text == (ROOT / "karpenter_tpu" / "service"
                    / "solver_pb2.py").read_text()


def test_schema_deltas_are_the_references():
    ref = _load("gen_proto")
    assert gen.NEW_FIELDS == ref.NEW_FIELDS


def test_write_reproduces_the_module(tmp_path, monkeypatch, capsys):
    out = tmp_path / "solver_pb2.py"
    monkeypatch.setattr(gen, "OUT", out)
    assert gen.main([]) == 0
    assert out.read_text() == (ROOT / "karpenter_tpu_torch" / "service"
                               / "solver_pb2.py").read_text()
    assert "0 fields added" in capsys.readouterr().out


def test_check_fails_on_a_stale_module(tmp_path, monkeypatch, capsys):
    out = tmp_path / "solver_pb2.py"
    out.write_text(gen.OUT.read_text().replace("_serialized_end=",
                                               "_serialized_end= ", 1))
    monkeypatch.setattr(gen, "OUT", out)
    assert gen.main(["--check"]) == 1
    assert "is stale" in capsys.readouterr().err
