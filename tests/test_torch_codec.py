"""The port's wire codec against the reference package's, on the CPU:
``service/codec.py`` over the byte-identical ``service/solver_pb2.py``.

Each fixture is built twice from one seeded description (numpy), once
with each package's models: pods with labels, requests, node selectors,
OR'd required-affinity terms, tolerations, zone and hostname spreads,
affinity and anti-affinity, volume zone requirements and gang membership;
provisioners with requirements, taints, startup taints, labels, limits and
kubelet overrides; the small catalog plus ICE'd offerings; existing nodes
carrying pods; daemonsets; the delta-session and trace fields.  Every
encoding is held BYTE-EQUAL (``SerializeToString(deterministic=True)``)
to the reference's, and every decode compares equal (re-encoded bytes,
and the decoded models field by field).  Tolerance: equal.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"
MODULES = {
    "codec": "service.codec", "pb": "service.solver_pb2",
    "delta": "service.delta", "pod": "models.pod",
    "prov": "models.provisioner", "req": "models.requirements",
    "catalog": "models.catalog", "L": "models.labels",
    "types": "solver.types",
}
_PACKAGES = {}
GIB = 1024.0 ** 3


def package(root: str) -> SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = SimpleNamespace(root=root, **{
            alias: importlib.import_module(f"{root}.{path}")
            for alias, path in MODULES.items()})
    return _PACKAGES[root]


def wire(msg) -> bytes:
    return msg.SerializeToString(deterministic=True)


def test_descriptor_is_byte_identical_and_shared():
    ref, port = package(REFERENCE).pb, package(PORT).pb
    assert port.DESCRIPTOR.serialized_pb == ref.DESCRIPTOR.serialized_pb
    # both modules load one file into the default pool: one message class
    assert port.SolveRequest.DESCRIPTOR.full_name == \
        ref.SolveRequest.DESCRIPTOR.full_name
    msg = ref.SolveRequest(session_id="s", base_epoch=3)
    assert port.SolveRequest.FromString(wire(msg)) == msg


class Fixture:
    """One seeded description, realised in package ``k``."""

    def __init__(self, k, seed: int, n_pods: int = 40) -> None:
        rng = np.random.default_rng(seed)
        P, R, L = k.pod, k.req, k.L
        self.k = k

        def sel(app):
            return P.LabelSelector.of({"app": app})

        pods = []
        for i in range(n_pods):
            app = f"app{int(rng.integers(0, 5))}"
            kind = int(rng.integers(0, 8))
            pod = P.PodSpec(
                name=f"p{seed}-{i}", namespace=("default", "ns1")[i % 2],
                labels={"app": app, "tier": str(int(rng.integers(0, 3)))},
                requests={"cpu": 0.25 * int(rng.integers(1, 9)),
                          "memory": float(rng.integers(1, 8)) * GIB / 2},
                priority=int(rng.integers(0, 3)),
                deletion_cost=float(rng.integers(0, 4)) / 2,
                owner_key=app)
            if kind == 1:
                pod.node_selector = {L.ZONE: "zone-1a"}
            if kind == 2:
                pod.required_affinity_terms = [
                    [R.Requirement(L.ARCH, R.IN, ["amd64"])],
                    [R.Requirement(L.CAPACITY_TYPE, R.IN, ["spot"])]]
            if kind == 3:
                pod.tolerations = [P.Toleration(key="team", value="a",
                                                effect="NoSchedule")]
                pod.topology_spread = [P.TopologySpreadConstraint(
                    1, L.ZONE, "DoNotSchedule", sel(app))]
            if kind == 4:
                pod.topology_spread = [P.TopologySpreadConstraint(
                    2, L.HOSTNAME, "ScheduleAnyway", sel(app))]
                pod.affinity_terms = [P.PodAffinityTerm(
                    sel(app), L.HOSTNAME, anti=True)]
            if kind == 5:
                pod.affinity_terms = [P.PodAffinityTerm(sel("app0"), L.ZONE)]
            if kind == 6:
                pod.volume_zone_requirements = [
                    R.Requirement(L.ZONE, R.IN, ["zone-1b", "zone-1c"])]
            if i % 7 == 0:
                pod.gang_id, pod.gang_size = f"g{i % 3}", 4
            pods.append(pod)
        self.pods = pods
        self.provisioners = [
            k.prov.Provisioner(name="default").with_defaults(),
            k.prov.Provisioner(
                name="spot", weight=7, consolidation_enabled=True,
                requirements=[R.Requirement(L.CAPACITY_TYPE, R.IN,
                                            ["spot"])],
                taints=[P.Taint("team", "NoSchedule", "a")],
                startup_taints=[P.Taint("boot", "NoExecute")],
                labels={"team": "a"}, limits={"cpu": 100.0 + seed},
                kubelet=k.prov.KubeletConfiguration(
                    max_pods=58, system_reserved={"cpu": 0.1},
                    eviction_hard={"memory.available": "5%"})),
        ]
        self.catalog = k.catalog.generate_catalog(full=False)
        self.unavailable = {(self.catalog[0].name, "zone-1a", "spot"),
                            (self.catalog[3].name, "zone-1b", "on-demand")}
        nodes = []
        for j in range(3):
            it = self.catalog[j * 2]
            node = k.types.SimNode(
                instance_type=it.name, provisioner="default",
                zone=f"zone-1{'abc'[j]}", capacity_type="on-demand",
                price=float(it.offerings[0].price),
                allocatable=dict(it.allocatable), labels={"role": f"r{j}"},
                taints=[P.Taint("dedicated", "NoSchedule", str(j))],
                existing=True, name=f"existing-{j}")
            node.pods = [P.PodSpec(name=f"seated-{j}-{m}",
                                   requests={"cpu": 0.5}, owner_key="s")
                         for m in range(j + 1)]
            nodes.append(node)
        self.existing = nodes
        self.daemonsets = [P.PodSpec(name="ds", requests={"cpu": 0.1})]

    def request(self, **extra):
        return self.k.codec.encode_request(
            self.pods, self.provisioners, self.catalog,
            existing_nodes=self.existing, daemonsets=self.daemonsets,
            unavailable=self.unavailable, allow_new_nodes=True,
            max_new_nodes=12, **extra)

    def result(self):
        k = self.k
        nodes = []
        for j, it in enumerate(self.catalog[:4]):
            node = k.types.SimNode(
                instance_type=it.name, provisioner="default",
                zone="zone-1a", capacity_type="spot",
                price=float(it.offerings[0].price),
                allocatable=dict(it.allocatable), name=f"new-{j}")
            node.pods = self.pods[j::4]
            nodes.append(node)
        return k.types.SolveResult(
            nodes=nodes,
            assignments={p.name: f"new-{i % 4}"
                         for i, p in enumerate(self.pods[1:])},
            infeasible={self.pods[0].name: "no feasible placement"},
            solve_ms=12.5)


REQUEST_VARIANTS = {
    "classic": {},
    "admission": dict(backend="tpu", priority="critical", deadline_ms=250.0),
    "establish": dict(session_id="sess-1", catalog_epoch=3,
                      trace_id="r0-abc", parent_span="s9"),
    "delta": dict(session_id="sess-1", base_epoch=4, delta=True,
                  removed_pods=["gone-1", "gone-2"],
                  reclaimed_nodes=["existing-1"], catalog_epoch=3,
                  session_nonce="n0nce"),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("variant", list(REQUEST_VARIANTS))
def test_request_bytes_equal_reference(seed, variant):
    extra = REQUEST_VARIANTS[variant]
    ref = Fixture(package(REFERENCE), seed).request(**extra)
    port = Fixture(package(PORT), seed).request(**extra)
    assert wire(port) == wire(ref)


def pod_fields(p) -> tuple:
    return (p.name, p.namespace, p.labels, p.requests, p.node_selector,
            [[(r.key, r.operator, tuple(r.values)) for r in t]
             for t in p.required_affinity_terms],
            [(t.key, t.operator, t.value, t.effect) for t in p.tolerations],
            [(t.max_skew, t.topology_key, t.when_unsatisfiable,
              t.label_selector.match_labels) for t in p.topology_spread],
            [(t.label_selector.match_labels, t.topology_key, t.anti)
             for t in p.affinity_terms],
            [(r.key, r.operator, tuple(r.values))
             for r in p.volume_zone_requirements],
            p.priority, p.deletion_cost, p.owner_key, p.gang_id, p.gang_size)


@pytest.mark.parametrize("seed", [0, 7])
def test_request_decodes_equal_reference(seed):
    """The port decodes the reference's bytes to the models the reference
    decodes them to, and re-encodes them to the bytes the reference
    re-encodes its decode to."""
    R, T = package(REFERENCE), package(PORT)
    raw = wire(Fixture(R, seed).request(**REQUEST_VARIANTS["delta"]))
    ref_kw = R.codec.decode_request(R.pb.SolveRequest.FromString(raw))
    port_req = T.pb.SolveRequest.FromString(raw)
    port_kw = T.codec.decode_request(port_req)
    assert [pod_fields(p) for p in port_kw["pods"]] == \
        [pod_fields(p) for p in ref_kw["pods"]]
    for key in ("unavailable", "allow_new_nodes", "max_new_nodes"):
        assert port_kw[key] == ref_kw[key]
    assert [(n.name, n.instance_type, n.zone, n.price, n.allocatable,
             n.labels, [pod_fields(p) for p in n.pods])
            for n in port_kw["existing_nodes"]] == \
        [(n.name, n.instance_type, n.zone, n.price, n.allocatable,
          n.labels, [pod_fields(p) for p in n.pods])
         for n in ref_kw["existing_nodes"]]
    assert [(p.name, p.weight, p.labels, p.limits, p.kubelet is None)
            for p in port_kw["provisioners"]] == \
        [(p.name, p.weight, p.labels, p.limits, p.kubelet is None)
         for p in ref_kw["provisioners"]]
    assert [(it.name, it.capacity, it.allocatable)
            for it in port_kw["instance_types"]] == \
        [(it.name, it.capacity, it.allocatable)
         for it in ref_kw["instance_types"]]
    assert T.codec.decode_delta_fields(port_req) == \
        R.codec.decode_delta_fields(R.pb.SolveRequest.FromString(raw))
    assert T.codec.decode_trace_fields(port_req) == \
        R.codec.decode_trace_fields(R.pb.SolveRequest.FromString(raw))
    # decoding is not the identity (defaults fill in), but it is the
    # reference's: both packages re-encode their decodes to the same bytes
    again = [k.codec.encode_request(
        kw["pods"], kw["provisioners"], kw["instance_types"],
        existing_nodes=kw["existing_nodes"], daemonsets=kw["daemonsets"],
        unavailable=kw["unavailable"], allow_new_nodes=kw["allow_new_nodes"],
        max_new_nodes=kw["max_new_nodes"], **REQUEST_VARIANTS["delta"])
        for k, kw in ((T, port_kw), (R, ref_kw))]
    assert wire(again[0]) == wire(again[1])


@pytest.mark.parametrize("seed", [0, 7])
def test_response_bytes_and_decode_equal_reference(seed):
    R, T = package(REFERENCE), package(PORT)
    ref = R.codec.encode_response(Fixture(R, seed).result())
    port = T.codec.encode_response(Fixture(T, seed).result())
    assert wire(port) == wire(ref)
    a = T.codec.decode_response(port)
    b = R.codec.decode_response(ref)
    assert a.assignments == b.assignments and a.infeasible == b.infeasible
    assert a.solve_ms == b.solve_ms
    assert [(n.name, n.instance_type, n.zone, n.capacity_type, n.price,
             [p.name for p in n.pods]) for n in a.nodes] == \
        [(n.name, n.instance_type, n.zone, n.capacity_type, n.price,
          [p.name for p in n.pods]) for n in b.nodes]


@pytest.mark.parametrize("mode", ["establish", "delta", "unknown"])
def test_delta_reply_bytes_and_decode_equal_reference(mode):
    def reply(k):
        fx = Fixture(k, 3)
        res = fx.result()
        if mode == "unknown":
            return k.delta.DeltaReply(state="unknown", full=False)
        return k.delta.DeltaReply(
            state="ok", epoch=5, mode=mode, full=mode == "establish",
            assignments=dict(res.assignments), infeasible=res.infeasible,
            nodes=[n.snapshot() for n in res.nodes[:2]],
            removed_nodes=["new-3"] if mode == "delta" else [],
            solve_ms=0.75, nonce="abc123")

    R, T = package(REFERENCE), package(PORT)
    ref = R.codec.encode_delta_reply(reply(R))
    port = T.codec.encode_delta_reply(reply(T))
    assert wire(port) == wire(ref)
    a, b = T.codec.decode_delta_reply(port), R.codec.decode_delta_reply(ref)
    for f in ("state", "epoch", "mode", "full", "assignments", "infeasible",
              "removed_nodes", "solve_ms", "nonce"):
        assert getattr(a, f) == getattr(b, f)
    assert [n.name for n in a.nodes] == [n.name for n in b.nodes]


def test_warm_request_bytes_equal_reference():
    def warm(k):
        fx = Fixture(k, 5)
        return k.codec.encode_warm_request(
            fx.provisioners, fx.catalog, daemonsets=fx.daemonsets,
            existing_nodes=fx.existing, backend="auto")

    R, T = package(REFERENCE), package(PORT)
    ref, port = warm(R), warm(T)
    assert wire(port) == wire(ref)
    a = T.codec.decode_warm_request(port)
    b = R.codec.decode_warm_request(ref)
    assert [p.name for p in a["provisioners"]] == \
        [p.name for p in b["provisioners"]]
    assert len(a["instance_types"]) == len(b["instance_types"])


def test_full_catalog_bytes_equal_reference():
    R, T = package(REFERENCE), package(PORT)
    ref = [wire(R.codec.encode_instance_type(it))
           for it in R.catalog.generate_catalog(full=True)]
    port = [wire(T.codec.encode_instance_type(it))
            for it in T.catalog.generate_catalog(full=True)]
    assert port == ref
