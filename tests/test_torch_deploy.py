"""The port's GPU-node deployment (``deploy/render_torch.py`` over
``deploy/rbac.yaml``, ``deploy/configmap.yaml`` and ``deploy/gpu/``) held
to every case of the reference's ``tests/test_deploy.py``, plus what the
GPU set adds: NVIDIA node selection and ``nvidia.com/gpu`` resources, no
``google.com/tpu`` anywhere, the solver's arguments parsed by the port's
CLI, and the shipped ConfigMap against the port's settings schema.  The
renderer's token logic is the port's own copy, held to the reference's on
the same texts.

Tolerance: equal.
"""

import importlib.util
from pathlib import Path

import pytest
import torch
import yaml

from karpenter_tpu_torch.cli import build_parser
from karpenter_tpu_torch.manifests import _SETTINGS_KEYS, parse_settings
from karpenter_tpu_torch.settings import Settings

torch.set_num_threads(1)

DEPLOY = Path(__file__).resolve().parent.parent / "deploy"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, DEPLOY / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


render = _load("render_torch")
ref_render = _load("render")
SOLVER, OPERATOR = "gpu/solver.yaml", "gpu/operator.yaml"


@pytest.fixture(scope="module")
def rendered():
    return {name: list(yaml.safe_load_all(text))
            for name, text in render.render_all(DEPLOY).items()}


def _docs(rendered):
    return [d for docs in rendered.values() for d in docs if d]


def _deployment(rendered, name):
    return next(d for d in _docs(rendered) if d["kind"] == "Deployment"
                and d["metadata"]["name"] == name)


# ---- the reference's cases over the GPU set --------------------------------


class TestRendering:
    def test_all_manifests_render_and_parse(self, rendered):
        assert set(rendered) == set(render.MANIFESTS)
        for name, docs in rendered.items():
            assert docs, f"{name} rendered to zero documents"
            for d in docs:
                assert d.get("apiVersion"), f"{name}: doc missing apiVersion"
                assert d.get("kind"), f"{name}: doc missing kind"
                assert d.get("metadata", {}).get("name"), f"{name}: unnamed doc"

    def test_values_overrides_apply_everywhere(self):
        env = {"KT_NAMESPACE": "prod", "KT_IMAGE": "repo/kt:v4",
               "KT_SOLVER_PORT": "9999", "KT_METRICS_PORT": "7070",
               "KT_OPERATOR_REPLICAS": "3", "KT_SOLVER_REPLICAS": "2",
               "KT_SOLVER_BACKEND": "tpu"}
        out = render.render_all(DEPLOY, env={**env})
        for name, text in out.items():
            assert "${" not in text, f"{name}: unrendered token"
            for d in yaml.safe_load_all(text):
                if d and "namespace" in d.get("metadata", {}):
                    assert d["metadata"]["namespace"] == "prod", name
        op = out[OPERATOR]
        assert "repo/kt:v4" in op
        assert "karpenter-tpu-solver.prod.svc:9999" in op
        assert "--metrics-port=7070" in op
        sol = out[SOLVER]
        assert '"--port=9999"' in sol and '"--backend=tpu"' in sol
        assert "repo/kt:v4" in sol

    def test_unknown_token_fails_loudly(self):
        with pytest.raises(KeyError):
            render.render_text("image: ${KT_NO_SUCH_VALUE}", env={})

    def test_split_topology_is_self_consistent(self, rendered):
        """The operator's KARPENTER_SOLVER_ADDR must dial the solver
        Service's name, namespace, and port; probes must hit the metrics
        port the operator serves."""
        by_kind = {}
        for d in _docs(rendered):
            by_kind.setdefault(d["kind"], []).append(d)
        solver_svc = next(s for s in by_kind["Service"]
                          if s["metadata"]["name"] == "karpenter-tpu-solver")
        svc_port = solver_svc["spec"]["ports"][0]["port"]
        operator = _deployment(rendered, "karpenter-tpu")
        container = operator["spec"]["template"]["spec"]["containers"][0]
        addr = next(e["value"] for e in container["env"]
                    if e["name"] == "KARPENTER_SOLVER_ADDR")
        expected = (f"karpenter-tpu-solver."
                    f"{solver_svc['metadata']['namespace']}.svc:{svc_port}")
        assert addr == expected, f"operator dials {addr}, solver serves {expected}"
        solver = _deployment(rendered, "karpenter-tpu-solver")
        sc = solver["spec"]["template"]["spec"]["containers"][0]
        assert f"--port={svc_port}" in " ".join(sc["args"])
        assert sc["ports"][0]["containerPort"] == svc_port
        mp = int(next(a for a in container["args"]
                      if a.startswith("--metrics-port=")).split("=")[1])
        assert container["ports"][0]["containerPort"] == mp
        assert container["livenessProbe"]["httpGet"]["port"] == mp


class TestSettingsDrift:
    def test_configmap_keys_match_settings_schema(self, rendered):
        """Every ConfigMap data key is a key of the port's settings schema
        and every schema key ships in the ConfigMap."""
        cm = next(d for d in _docs(rendered) if d["kind"] == "ConfigMap"
                  and d["metadata"]["name"] == "karpenter-global-settings")
        data_keys = {k for k in cm["data"] if not k.startswith("tags")}
        known = set(_SETTINGS_KEYS)
        assert data_keys - known == set(), sorted(data_keys - known)
        assert known - data_keys == set(), sorted(known - data_keys)

    def test_settings_fields_all_reachable_from_configmap(self):
        mapped = {field for field, _p in _SETTINGS_KEYS.values()}
        fields = set(Settings.__dataclass_fields__) - {"tags"}
        assert fields - mapped == set(), sorted(fields - mapped)

    def test_configmap_values_parse_to_defaults(self, rendered):
        cm = next(d for d in _docs(rendered) if d["kind"] == "ConfigMap"
                  and d["metadata"]["name"] == "karpenter-global-settings")
        assert Settings(**parse_settings(cm)) == Settings()


# ---- what the GPU set adds -------------------------------------------------


def _solver_pods(rendered):
    return [d["spec"]["template"]["spec"]
            for d in rendered[SOLVER]
            if d and d["kind"] == "Deployment"]


def test_the_gpu_set_is_the_shared_pair_then_the_gpu_pair():
    assert render.MANIFESTS == ("rbac.yaml", "configmap.yaml",
                                "gpu/solver.yaml", "gpu/operator.yaml")
    out = render.render_all(DEPLOY, env={})
    ref = ref_render.render_all(DEPLOY, env={})
    for name in ("rbac.yaml", "configmap.yaml"):
        assert out[name] == ref[name]


def test_solvers_select_nvidia_nodes_and_one_gpu(rendered):
    pods = _solver_pods(rendered)
    assert {p["containers"][0]["name"] for p in pods} == {"solver"}
    assert len(pods) == 2  # the single-replica and the fleet Deployment
    for spec in pods:
        sel = spec["nodeSelector"]
        assert sel["nvidia.com/gpu.present"] == "true"
        assert sel["nvidia.com/gpu.product"] == "NVIDIA-H100-80GB-HBM3"
        assert not any("tpu" in k for k in sel)
        assert {"key": "nvidia.com/gpu", "operator": "Exists",
                "effect": "NoSchedule"} in spec["tolerations"]
        res = spec["containers"][0]["resources"]
        assert res["requests"]["nvidia.com/gpu"] == "1"
        assert res["limits"]["nvidia.com/gpu"] == "1"


def test_no_tpu_resource_anywhere():
    for name, text in render.render_all(DEPLOY, env={}).items():
        assert "google.com/tpu" not in text, name
        assert "gke-tpu" not in text, name
    for name in ("gpu/solver.yaml", "gpu/operator.yaml"):
        assert "google.com/tpu" not in (DEPLOY / name).read_text()


def test_solvers_run_the_port_and_every_argument_parses(rendered):
    for spec in _solver_pods(rendered):
        c = spec["containers"][0]
        assert c["command"] == ["karpenter-tpu-torch", "serve"]
        args = build_parser().parse_args(["serve", *c["args"]])
        assert args.cmd == "serve" and args.warmup is True
        assert args.port == 50151 and args.obs_port == 8081
        assert args.backend == "auto"
        env = {e["name"]: e.get("value") for e in c["env"]}
        assert args.jit_cache_dir == env["KT_JIT_CACHE"]


def test_solver_flags_are_the_reference_solvers():
    ref = {d["metadata"]["name"]: d for d in yaml.safe_load_all(
        ref_render.render_all(DEPLOY, env={})["solver.yaml"])
        if d and d["kind"] == "Deployment"}
    ours = {d["metadata"]["name"]: d for d in yaml.safe_load_all(
        render.render_all(DEPLOY, env={})[SOLVER])
        if d and d["kind"] == "Deployment"}
    assert set(ours) == set(ref)
    for name, dep in ours.items():
        got = dep["spec"]["template"]["spec"]["containers"][0]["args"]
        want = ref[name]["spec"]["template"]["spec"]["containers"][0]["args"]
        assert got == want, name


def test_fleet_and_spool_claim_are_carried_over(rendered):
    kinds = {(d["kind"], d["metadata"]["name"]) for d in rendered[SOLVER]
             if d}
    assert ("PersistentVolumeClaim", "karpenter-tpu-session-spool") in kinds
    assert ("Service", "karpenter-tpu-solver-fleet") in kinds
    fleet = _deployment(rendered, "karpenter-tpu-solver-fleet")
    spec = fleet["spec"]["template"]["spec"]
    assert spec["volumes"][0]["persistentVolumeClaim"]["claimName"] == \
        "karpenter-tpu-session-spool"
    env = {e["name"]: e.get("value") for e in spec["containers"][0]["env"]}
    assert env["KT_JIT_CACHE"].startswith(env["KT_SESSION_DIR"])


def test_the_jit_cache_volume_holds_the_kernel_library(rendered):
    solver = _deployment(rendered, "karpenter-tpu-solver")
    c = solver["spec"]["template"]["spec"]["containers"][0]
    env = {e["name"]: e.get("value") for e in c["env"]}
    mounts = {m["name"]: m["mountPath"] for m in c["volumeMounts"]}
    assert mounts["jit-cache"] == env["KT_JIT_CACHE"]
    assert "nvcc" in (DEPLOY / SOLVER).read_text()


def test_operator_runs_the_port_without_a_gpu(rendered):
    op = _deployment(rendered, "karpenter-tpu")
    c = op["spec"]["template"]["spec"]["containers"][0]
    assert c["command"] == ["karpenter-tpu-torch", "demo"]
    assert "nvidia.com/gpu" not in str(c["resources"])
    args = build_parser().parse_args(["demo", *c["args"]])
    assert args.metrics_port == 8080


@pytest.mark.parametrize("text", [
    "image: ${KT_IMAGE:-a:b}", "n: ${KT_N}", "x: ${KT_A:-}/${KT_B:-c}",
    "plain text", "${KT_A:-1}${KT_A:-2}"])
def test_token_logic_is_the_reference_renderers(text):
    for env in ({}, {"KT_IMAGE": "x", "KT_N": "3", "KT_A": "z"}):
        try:
            want = ref_render.render_text(text, env)
        except KeyError:
            with pytest.raises(KeyError):
                render.render_text(text, env)
            continue
        assert render.render_text(text, env) == want


def test_render_cli_writes_one_file_per_manifest(tmp_path, capsys):
    assert render.main(["--out", str(tmp_path)]) == 0
    for name in render.MANIFESTS:
        assert (tmp_path / name).read_text() == \
            render.render_all(DEPLOY)[name]
    assert render.main([]) == 0
    out = capsys.readouterr().out
    assert "nvidia.com/gpu" in out and out.count("\n---\n") >= 3


def test_renderer_has_its_own_token_logic():
    src = (DEPLOY / "render_torch.py").read_text()
    assert "import render" not in src and "karpenter_tpu" not in src
