"""The port stands alone: every ``karpenter_tpu_torch`` module, and
``chip_smoke.py``, imports with JAX, ml_dtypes and the reference package
BLOCKED (a meta-path finder refusing ``jax``, ``jaxlib``, ``ml_dtypes`` and
``karpenter_tpu`` / ``karpenter_tpu.*`` by exact name — the port's own
``karpenter_tpu_torch`` is not caught by it).  Entry points resolve their
default device to the CUDA card and raise without one; ``chip_smoke.py``
refuses to run without a card or without the repository.
"""

import json
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import karpenter_tpu_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(
        karpenter_tpu_torch.__path__, prefix="karpenter_tpu_torch."))

_PROBE = r"""
import importlib, json, sys

BLOCKED = ("jax", "jaxlib", "ml_dtypes", "karpenter_tpu")


class Blocker:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, Blocker())
out = {}
for name in sys.argv[1:]:
    try:
        importlib.import_module(name)
        out[name] = "ok"
    except Exception as e:  # report every module, not just the first
        out[name] = f"{type(e).__name__}: {e}"
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": out, "leaked": leaked}))
"""


@pytest.fixture(scope="module")
def probe():
    env = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, *MODULES, "chip_smoke"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_module_is_probed():
    assert "karpenter_tpu_torch.solver.hierarchy" in MODULES
    assert "karpenter_tpu_torch.kernels" in MODULES
    assert "karpenter_tpu_torch.solver.relax" in MODULES
    assert "karpenter_tpu_torch.solver.consolidation" in MODULES
    for name in ("utils.clock", "events", "models.machine", "models.pdb",
                 "models.volume", "settings", "cloud.templates", "cloud.base",
                 "cloud.launchpath", "cloud.fake", "webhooks", "cache",
                 "batcher", "metrics", "obs", "obs.trace", "obs.recorder",
                 "controllers.state", "controllers.termination",
                 "controllers.provisioning", "controllers.deprovisioning",
                 "repack", "errors", "faults", "faults.plane", "gang",
                 "solver.guard", "solver.native", "tuning", "tuning.knobs",
                 "tuning.controller", "admission", "admission.policy",
                 "admission.queue", "admission.breaker",
                 "admission.brownout", "obs.protocol", "obs.occupancy",
                 "obs.slo", "obs.timeseries", "parallel", "parallel.forward",
                 "service", "service.solver_pb2", "service.codec",
                 "service.snapshot", "service.delta", "service.server",
                 "service.client", "obs.export", "obs.fleet", "obs.replay",
                 "providers", "providers.pricing", "providers.subnet",
                 "providers.securitygroup", "cloud.batched",
                 "controllers.garbagecollect", "controllers.interruption",
                 "controllers.nodetemplate", "manifests", "operator", "cli",
                 "admission.__main__"):
        assert f"karpenter_tpu_torch.{name}" in MODULES
    assert len(MODULES) >= 90


@pytest.mark.parametrize("module", MODULES + ["chip_smoke"])
def test_imports_without_jax_or_reference(probe, module):
    assert probe["modules"][module] == "ok"


def test_nothing_blocked_was_loaded(probe):
    assert probe["leaked"] == []


def test_default_device_raises_without_cuda(monkeypatch):
    from karpenter_tpu_torch.device import resolve_device
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (resolve_device, BatchScheduler, TpuSolver):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert BatchScheduler(device="cpu").device == torch.device("cpu")


def test_controllers_default_scheduler_raises_without_cuda(monkeypatch):
    from karpenter_tpu_torch.cloud.fake import FakeCloudProvider
    from karpenter_tpu_torch.controllers.deprovisioning import (
        DeprovisioningController,
    )
    from karpenter_tpu_torch.controllers.provisioning import (
        ProvisioningController,
    )
    from karpenter_tpu_torch.controllers.state import ClusterState
    from karpenter_tpu_torch.controllers.termination import (
        TerminationController,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state, cloud = ClusterState(), FakeCloudProvider([])
    term = TerminationController(state, cloud)
    for make in (lambda: ProvisioningController(state, cloud),
                 lambda: DeprovisioningController(state, cloud, term)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the refusal needs none")
    env = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("KT_SANITIZE", "PYTHONPATH")}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
