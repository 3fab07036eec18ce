"""The port's declarative config (``manifests.py``) against the reference
package's, on the CPU: ``deploy/examples`` parsed, admitted and applied
through both packages to equal objects; the YAML admission cases of the
reference's ``tests/test_admission.py`` (file and HTTP); the port's
``_SETTINGS_KEYS`` held to ``deploy/configmap.yaml`` as
``tests/test_deploy.py`` holds the reference's; and the operator's
``--config`` path.  PyYAML is imported where a document is parsed, so
``import karpenter_tpu_torch.manifests`` needs none.

Tolerance: equal.
"""

import dataclasses
import importlib
import json
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import yaml

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DEPLOY = ROOT / "deploy"
REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"
ROOTS = (REFERENCE, PORT)
MODULES = {
    "manifests": "manifests", "webhooks": "webhooks", "settings": "settings",
    "fake": "cloud.fake", "state_mod": "controllers.state",
    "clock": "utils.clock", "catalog": "models.catalog",
    "metrics": "metrics", "operator": "operator",
}
_PACKAGES: dict = {}


def package(root: str) -> SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = SimpleNamespace(root=root, **{
            alias: importlib.import_module(f"{root}.{path}")
            for alias, path in MODULES.items()})
    return _PACKAGES[root]


def plain(obj):
    """An object graph as plain data (dataclasses field by field, enums
    and classes by name) so two packages' objects compare."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, {f.name: plain(getattr(obj, f.name))
                                     for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in sorted(
            obj.items(), key=lambda kv: repr(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(repr(plain(v)) for v in obj)
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return (type(obj).__name__, {k: plain(v) for k, v in
                                     sorted(vars(obj).items())})
    return obj


def run_both(scenario, *args):
    seen = {root: scenario(package(root), *args) for root in ROOTS}
    assert seen[PORT] == seen[REFERENCE]
    return seen[PORT]


def test_manifests_import_without_pyyaml():
    probe = ("import sys\n"
             "class B:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('yaml', 'jax',"
             " 'karpenter_tpu'):\n"
             "            raise ImportError(name)\n"
             "sys.meta_path.insert(0, B())\n"
             "import karpenter_tpu_torch.manifests, "
             "karpenter_tpu_torch.operator, karpenter_tpu_torch.cli\n"
             "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_example_documents_parse_to_equal_objects():
    def scenario(k):
        docs = k.manifests.load_documents(DEPLOY / "examples")
        provs, templates, overrides, storage = \
            k.manifests.admit_documents(docs)
        return docs, plain(provs), plain(templates), plain(overrides), \
            plain(storage)

    docs, provs, templates, overrides, _storage = run_both(scenario)
    assert {p[1]["name"] for p in provs} == {"default", "spot-burst"}
    assert templates and overrides


def test_example_manifests_admit_and_apply():
    def scenario(k):
        clock = k.clock.FakeClock()
        state = k.state_mod.ClusterState(clock=clock)
        cloud = k.fake.FakeCloudProvider(
            k.catalog.generate_catalog(full=False), clock=clock)
        store = k.settings.SettingsStore()
        out = k.manifests.apply_path("deploy/examples", state=state,
                                     cloud=cloud, settings_store=store)
        assert state.provisioners["spot-burst"].taints[0].key == "burst"
        assert state.provisioners["default"].limits["memory"] == \
            4000 * 1024 ** 3
        assert cloud.templates["default"].block_devices[0].size_gib == 40.0
        assert store.current.drift_enabled is True
        return (plain(out), plain(state.provisioners),
                plain(cloud.templates), plain(store.current))

    run_both(scenario)


def _admission_error(k, fn):
    with pytest.raises(k.webhooks.AdmissionError) as exc:
        fn()
    err = exc.value
    return err.kind, err.name, err.errors


def test_invalid_documents_are_denied_with_the_reference_errors(tmp_path):
    def scenario(k):
        bad = tmp_path / k.root
        bad.mkdir()
        (bad / "bad.yaml").write_text(
            "kind: Provisioner\nmetadata: {name: bad}\nspec:\n"
            "  weight: 500\n  consolidation: {enabled: true}\n"
            "  ttlSecondsAfterEmpty: 30\n")
        out = [_admission_error(k, lambda: k.manifests.admit_documents(
            k.manifests.load_documents(bad)))]
        out.append(_admission_error(k, lambda: k.manifests.admit_documents([{
            "kind": "ConfigMap",
            "metadata": {"name": "karpenter-global-settings"},
            "data": {"batchIdleDuratoin": "1s"}}])))
        out.append(_admission_error(
            k, lambda: k.manifests.load_documents(tmp_path / "nope")))
        empty = tmp_path / f"{k.root}-empty"
        empty.mkdir()
        out.append(_admission_error(
            k, lambda: k.manifests.load_documents(empty)))
        (bad / "bad.yaml").write_text("kind: [unclosed\n")
        kind, name, errors = _admission_error(
            k, lambda: k.manifests.load_documents(bad))
        out.append((kind, name, len(errors)))
        return [(kind, str(name).replace(str(tmp_path), "<tmp>")
                 .replace(k.root, "<pkg>"), errors)
                for kind, name, errors in out]

    out = run_both(scenario)
    assert any("outside [0,100]" in e for e in out[0][2])
    assert any("unknown settings key" in e for e in out[1][2])


def test_quantities_durations_kubelet_and_storage_shapes():
    def scenario(k):
        m = k.manifests
        prov = m.parse_provisioner({
            "kind": "Provisioner", "metadata": {"name": "q"},
            "spec": {"limits": {"resources": {"cpu": "1500m",
                                              "memory": "2Gi"}},
                     "kubeletConfiguration": {"maxPods": 20,
                                              "podsPerCore": 4},
                     "taints": [{"key": "t", "value": "v",
                                 "effect": "NoSchedule"}],
                     "requirements": [{
                         "key": "karpenter.sh/capacity-type",
                         "operator": "In", "values": ["spot"]}]}})
        sc = m.parse_storage_class({
            "kind": "StorageClass", "metadata": {"name": "fast"},
            "provisioner": "ebs", "volumeBindingMode":
                "WaitForFirstConsumer",
            "allowedTopologies": [{"matchLabelExpressions": [{
                "key": "topology.kubernetes.io/zone",
                "values": ["zone-1a"]}]}]})
        pvc = m.parse_persistent_volume_claim({
            "kind": "PersistentVolumeClaim",
            "metadata": {"name": "data", "namespace": "ns"},
            "spec": {"storageClassName": "fast"}})
        return ([m.parse_duration(v) for v in ("500ms", "9.5m", "2h", 3)],
                plain(prov), plain(sc), plain(pvc),
                m.parse_settings({"data": {"tags": "{a: b}", "tags.c": "d",
                                           "batchMaxDuration": "20s"}}))

    out = run_both(scenario)
    assert out[0] == [0.5, 570.0, 7200.0, 3.0]


def test_settings_keys_match_the_deploy_configmap():
    """``tests/test_deploy.py``'s drift gate over the port's table: every
    ConfigMap data key is a port settings key and back, every ``Settings``
    field is reachable, and the shipped values parse to the defaults."""
    sys.path.insert(0, str(DEPLOY))
    try:
        from render import render_all
    finally:
        sys.path.remove(str(DEPLOY))
    rendered = {name: list(yaml.safe_load_all(text))
                for name, text in render_all(DEPLOY).items()}
    cm = next(d for docs in rendered.values() for d in docs
              if d and d["kind"] == "ConfigMap"
              and d["metadata"]["name"] == "karpenter-global-settings")
    port, ref = package(PORT), package(REFERENCE)
    keys = port.manifests._SETTINGS_KEYS
    data_keys = {k for k in cm["data"] if not k.startswith("tags")}
    assert data_keys == set(keys)
    assert sorted(keys) == sorted(ref.manifests._SETTINGS_KEYS)
    assert {f for f, _p in keys.values()} == (
        set(port.settings.Settings.__dataclass_fields__) - {"tags"})
    assert port.settings.Settings(**port.manifests.parse_settings(cm)) == \
        port.settings.Settings()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body.encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode())


HTTP_BODIES = {
    "valid_apply": ("/admission/apply",
                    "kind: Provisioner\nmetadata: {name: web}\n"
                    "spec: {weight: 7, consolidation: {enabled: true}}\n"),
    "validate_only": ("/admission/validate",
                      "kind: Provisioner\nmetadata: {name: dry}\nspec: {}\n"),
    "malformed_weight": ("/admission/validate",
                         "kind: Provisioner\nmetadata: {name: m}\n"
                         "spec: {weight: abc}\n"),
    "malformed_quantity": ("/admission/validate",
                           "kind: Provisioner\nmetadata: {name: m}\n"
                           "spec: {limits: {resources: {cpu: zz}}}\n"),
    "settings_live_store": ("/admission/apply",
                            "kind: ConfigMap\nmetadata: "
                            "{name: karpenter-global-settings}\n"
                            "data: {batchIdleDuration: \"15s\"}\n"),
    "atomic_invalid_settings": ("/admission/apply",
                                "kind: Provisioner\nmetadata: "
                                "{name: partial}\nspec: {}\n---\n"
                                "kind: ConfigMap\nmetadata: "
                                "{name: karpenter-global-settings}\n"
                                "data: {vmMemoryOverheadPercent: \"5.0\"}\n"),
    "unparseable": ("/admission/validate", "{unclosed: ["),
    "unrecognized_kind": ("/admission/validate",
                          "kind: Deployment\nmetadata: {name: x}\n"),
    "unknown_path": ("/admission/nope", "kind: Provisioner\n"),
}


@pytest.mark.parametrize("case", sorted(HTTP_BODIES))
def test_http_admission(case):
    path, body = HTTP_BODIES[case]

    def scenario(k):
        clock = k.clock.FakeClock()
        cloud = k.fake.FakeCloudProvider(
            k.catalog.generate_catalog(full=False), clock=clock)
        kw = {"device": "cpu"} if k.root == PORT else {}
        op = k.operator.Operator(cloud, clock=clock,
                                 scheduler_backend="oracle",
                                 registry=k.metrics.Registry(),
                                 metrics_port=_free_port(), **kw)
        port = op.start_http()
        try:
            op.settings.update(batch_max_duration=30.0)
            if path == "/admission/nope":
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}{path}", data=body.encode(),
                    method="POST")
                with pytest.raises(urllib.error.HTTPError) as exc:
                    urllib.request.urlopen(req, timeout=30)
                return exc.value.code
            status, resp = _post(port, path, body)
            return (status, resp, sorted(op.state.provisioners),
                    op.settings.current.batch_idle_duration)
        finally:
            op.shutdown()

    run_both(scenario)


def test_operator_config_path_through_the_demo():
    """``--config deploy/examples``: the port's demo admits the examples
    and runs on them.  The reference's demo raises there (ROADMAP C6: it
    unpacks three of ``apply_path``'s four results), so the port's lines
    are held to the reference's demo without ``--config`` on the same
    provisioners' effect: every pod placed and savings printed."""
    env = {k: v for k, v in os.environ.items() if k != "KT_SANITIZE"}
    env.update(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    args = ["demo", "--pods", "30", "--small", "--backend", "oracle",
            "--config", "deploy/examples"]
    ref = subprocess.run([sys.executable, "-m", f"{REFERENCE}.cli", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert ref.returncode != 0
    assert "too many values to unpack" in ref.stderr
    port = subprocess.run([sys.executable, "-m", f"{PORT}.cli", *args,
                           "--device", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert port.returncode == 0, port.stderr[-2000:]
    lines = port.stdout.splitlines()
    assert lines[0].startswith("manifests: 2 provisioner(s), 1 node "
                               "template(s), ")
    assert lines[0].endswith("admitted from deploy/examples")
    assert lines[-1].endswith("/hr") and "pending=0" in lines[-1]
