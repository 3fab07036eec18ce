"""proto <-> model conversion for the solver service."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..models.instancetype import InstanceType, Offering, Overhead
from ..models.machine import Machine
from ..models.pod import (
    LabelSelector,
    PodAffinityTerm,
    PodSpec,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
from ..models.provisioner import KubeletConfiguration, Provisioner
from ..models.requirements import Requirement, Requirements
from ..solver.types import SimNode, SolveResult
from . import solver_pb2 as pb

# ---------------------------------------------------------------------------
# encode (model -> proto)
# ---------------------------------------------------------------------------


def _q(resource: str, value: float) -> pb.Quantity:
    return pb.Quantity(resource=resource, value=value)


def _quantities(d) -> List[pb.Quantity]:
    return [_q(k, v) for k, v in sorted(d.items())]


def _req(r: Requirement) -> pb.Requirement:
    return pb.Requirement(key=r.key, op=r.operator, values=list(r.values))


def _selector(s: LabelSelector) -> pb.LabelSelector:
    out = pb.LabelSelector()
    for k, v in s.match_labels:
        out.match_labels[k] = v
    out.match_expressions.extend(_req(r) for r in s.match_expressions)
    return out


def encode_pod(p: PodSpec) -> pb.Pod:
    out = pb.Pod(
        name=p.name, namespace=p.namespace, priority=p.priority,
        deletion_cost=p.deletion_cost, owner=p.owner_key,
        gang_id=p.gang_id, gang_size=p.gang_size,
    )
    for k, v in p.labels.items():
        out.labels[k] = v
    out.requests.extend(_quantities(p.requests))
    for k, v in p.node_selector.items():
        out.node_selector[k] = v
    for term in p.required_affinity_terms:
        out.required_affinity.append(pb.RequirementTerm(requirements=[_req(r) for r in term]))
    out.tolerations.extend(
        pb.Toleration(key=t.key, op=t.operator, value=t.value, effect=t.effect)
        for t in p.tolerations
    )
    out.spread.extend(
        pb.TopologySpread(max_skew=t.max_skew, topology_key=t.topology_key,
                          hard=t.hard, selector=_selector(t.label_selector))
        for t in p.topology_spread
    )
    out.affinity.extend(
        pb.AffinityTerm(selector=_selector(t.label_selector),
                        topology_key=t.topology_key, anti=t.anti)
        for t in p.affinity_terms
    )
    out.volume_zone_requirements.extend(_req(r) for r in p.volume_zone_requirements)
    return out


def encode_instance_type(it: InstanceType) -> pb.InstanceType:
    out = pb.InstanceType(name=it.name)
    out.requirements.extend(_req(r) for r in it.requirements.to_list())
    out.offerings.extend(
        pb.Offering(zone=o.zone, capacity_type=o.capacity_type,
                    price=o.price, available=o.available)
        for o in it.offerings
    )
    out.capacity.extend(_quantities(it.capacity))
    out.overhead.extend(_quantities(it.overhead.total()))  # legacy decoders
    out.overhead_kube.extend(_quantities(it.overhead.kube_reserved))
    out.overhead_system.extend(_quantities(it.overhead.system_reserved))
    out.overhead_eviction.extend(_quantities(it.overhead.eviction_threshold))
    out.has_overhead_components = True
    return out


def encode_provisioner(p: Provisioner) -> pb.Provisioner:
    out = pb.Provisioner(
        name=p.name, weight=p.weight, consolidation_enabled=p.consolidation_enabled,
    )
    out.requirements.extend(_req(r) for r in p.requirements)
    out.taints.extend(pb.Taint(key=t.key, value=t.value, effect=t.effect) for t in p.taints)
    out.startup_taints.extend(
        pb.Taint(key=t.key, value=t.value, effect=t.effect) for t in p.startup_taints
    )
    for k, v in p.labels.items():
        out.labels[k] = v
    out.limits.extend(_quantities(p.limits))
    if p.kubelet is not None:
        kc = p.kubelet
        out.kubelet.CopyFrom(pb.KubeletConfiguration(
            has_max_pods=kc.max_pods is not None,
            max_pods=kc.max_pods or 0,
            has_pods_per_core=kc.pods_per_core is not None,
            pods_per_core=kc.pods_per_core or 0,
        ))
        out.kubelet.system_reserved.extend(_quantities(kc.system_reserved))
        out.kubelet.kube_reserved.extend(_quantities(kc.kube_reserved))
        for k, v in kc.eviction_hard.items():
            out.kubelet.eviction_hard[k] = v
        for k, v in kc.eviction_soft.items():
            out.kubelet.eviction_soft[k] = v
    return out


def encode_node(n: SimNode) -> pb.ExistingNode:
    out = pb.ExistingNode(
        name=n.name, instance_type=n.instance_type, provisioner=n.provisioner,
        zone=n.zone, capacity_type=n.capacity_type, price=n.price,
    )
    out.allocatable.extend(_quantities(n.allocatable))
    for k, v in n.labels.items():
        out.labels[k] = v
    out.taints.extend(pb.Taint(key=t.key, value=t.value, effect=t.effect) for t in n.taints)
    out.pods.extend(encode_pod(p) for p in n.pods)
    return out


def encode_request(
    pods: Sequence[PodSpec],
    provisioners: Sequence[Provisioner],
    instance_types: Sequence[InstanceType],
    existing_nodes: Sequence[SimNode] = (),
    daemonsets: Sequence[PodSpec] = (),
    unavailable: Optional[Set[tuple]] = None,
    allow_new_nodes: bool = True,
    max_new_nodes: Optional[int] = None,
    backend: str = "",
    priority: str = "",
    deadline_ms: Optional[float] = None,
    session_id: str = "",
    base_epoch: int = 0,
    delta: bool = False,
    removed_pods: Sequence[str] = (),
    reclaimed_nodes: Sequence[str] = (),
    catalog_epoch: int = 0,
    trace_id: str = "",
    parent_span: str = "",
    session_nonce: str = "",
) -> pb.SolveRequest:
    # admission fields (docs/ADMISSION.md): "" / 0 are the backward-
    # compatible wire defaults — the server folds them into its configured
    # default class / deadline, so an old client is indistinguishable from
    # one that sent nothing.  The delta-session fields (ARCHITECTURE.md
    # round 14) default the same way: an empty session_id is a classic
    # full solve; delta=True reuses `pods` for the ADDED pods and
    # `unavailable` for the newly ICE'd offerings.  The trace context
    # defaults to "no context": the server roots locally.
    req = pb.SolveRequest(allow_new_nodes=allow_new_nodes, backend=backend,
                          priority_class=priority or "",
                          deadline_ms=float(deadline_ms or 0.0),
                          session_id=session_id or "",
                          base_epoch=int(base_epoch or 0),
                          delta=bool(delta),
                          catalog_epoch=int(catalog_epoch or 0),
                          trace_id=trace_id or "",
                          parent_span=parent_span or "",
                          session_nonce=session_nonce or "")
    req.removed_pods.extend(removed_pods)
    req.reclaimed_nodes.extend(reclaimed_nodes)
    req.pods.extend(encode_pod(p) for p in pods)
    req.provisioners.extend(encode_provisioner(p) for p in provisioners)
    req.instance_types.extend(encode_instance_type(t) for t in instance_types)
    req.existing_nodes.extend(encode_node(n) for n in existing_nodes)
    req.daemonsets.extend(encode_pod(p) for p in daemonsets)
    for (t, z, c) in sorted(unavailable or ()):
        req.unavailable.append(pb.UnavailableOffering(instance_type=t, zone=z, capacity_type=c))
    if max_new_nodes is not None:
        req.has_max_new_nodes = True
        req.max_new_nodes = max_new_nodes
    return req


def encode_warm_request(
    provisioners: Sequence[Provisioner],
    instance_types: Sequence[InstanceType],
    daemonsets: Sequence[PodSpec] = (),
    existing_nodes: Sequence[SimNode] = (),
    backend: str = "",
) -> pb.WarmRequest:
    req = pb.WarmRequest(backend=backend)
    req.provisioners.extend(encode_provisioner(p) for p in provisioners)
    req.instance_types.extend(encode_instance_type(t) for t in instance_types)
    req.daemonsets.extend(encode_pod(p) for p in daemonsets)
    req.existing_nodes.extend(encode_node(n) for n in existing_nodes)
    return req


def encode_response(result: SolveResult) -> pb.SolveResponse:
    out = pb.SolveResponse(solve_ms=result.solve_ms)
    for n in result.nodes:
        out.nodes.append(pb.NewNode(
            name=n.name, instance_type=n.instance_type, provisioner=n.provisioner,
            zone=n.zone, capacity_type=n.capacity_type, price=n.price,
            pod_names=[p.name for p in n.pods],
        ))
    for k, v in result.assignments.items():
        out.assignments[k] = v
    for k, v in result.infeasible.items():
        out.infeasible[k] = v
    return out


# ---------------------------------------------------------------------------
# decode (proto -> model)
# ---------------------------------------------------------------------------


def _qdict(qs) -> Dict[str, float]:
    return {q.resource: q.value for q in qs}


def _dreq(r: pb.Requirement) -> Requirement:
    return Requirement(r.key, r.op, list(r.values))


def _dselector(s: pb.LabelSelector) -> LabelSelector:
    return LabelSelector(
        tuple(sorted(s.match_labels.items())),
        tuple(_dreq(r) for r in s.match_expressions),
    )


def decode_pod(p: pb.Pod) -> PodSpec:
    return PodSpec(
        name=p.name,
        namespace=p.namespace or "default",
        labels=dict(p.labels),
        requests=_qdict(p.requests),
        node_selector=dict(p.node_selector),
        required_affinity_terms=[[_dreq(r) for r in t.requirements] for t in p.required_affinity],
        tolerations=[Toleration(t.key, t.op or "Equal", t.value, t.effect) for t in p.tolerations],
        topology_spread=[
            TopologySpreadConstraint(
                t.max_skew, t.topology_key,
                "DoNotSchedule" if t.hard else "ScheduleAnyway",
                _dselector(t.selector),
            )
            for t in p.spread
        ],
        affinity_terms=[
            PodAffinityTerm(_dselector(t.selector), t.topology_key, t.anti)
            for t in p.affinity
        ],
        priority=p.priority,
        deletion_cost=p.deletion_cost or 1.0,
        owner_key=p.owner,
        volume_zone_requirements=[_dreq(r) for r in p.volume_zone_requirements],
        # old wire bytes carry no gang tags and decode to ""/0 = ungrouped
        gang_id=p.gang_id,
        gang_size=p.gang_size,
    )


def decode_instance_type(it: pb.InstanceType) -> InstanceType:
    return InstanceType(
        name=it.name,
        requirements=Requirements([_dreq(r) for r in it.requirements]),
        offerings=[
            Offering(o.zone, o.capacity_type, o.price, o.available) for o in it.offerings
        ],
        capacity=_qdict(it.capacity),
        overhead=(
            Overhead(
                kube_reserved=_qdict(it.overhead_kube),
                system_reserved=_qdict(it.overhead_system),
                eviction_threshold=_qdict(it.overhead_eviction),
            )
            if it.has_overhead_components
            # older encoders: field 5 carries either the pre-summed total
            # (original wire format; fields 6/7 empty) or kube-reserved with
            # system/eviction in 6/7 — reading 6/7 here is correct for both
            # (empty lists decode to {} for the original format)
            else Overhead(
                kube_reserved=_qdict(it.overhead),
                system_reserved=_qdict(it.overhead_system),
                eviction_threshold=_qdict(it.overhead_eviction),
            )
        ),
    )


def decode_provisioner(p: pb.Provisioner) -> Provisioner:
    kubelet = None
    if p.HasField("kubelet"):
        kc = p.kubelet
        kubelet = KubeletConfiguration(
            max_pods=kc.max_pods if kc.has_max_pods else None,
            pods_per_core=kc.pods_per_core if kc.has_pods_per_core else None,
            system_reserved=_qdict(kc.system_reserved),
            kube_reserved=_qdict(kc.kube_reserved),
            eviction_hard=dict(kc.eviction_hard),
            eviction_soft=dict(kc.eviction_soft),
        )
    return Provisioner(
        name=p.name,
        requirements=[_dreq(r) for r in p.requirements],
        taints=[Taint(t.key, t.effect, t.value) for t in p.taints],
        startup_taints=[Taint(t.key, t.effect, t.value) for t in p.startup_taints],
        labels=dict(p.labels),
        limits=_qdict(p.limits),
        weight=p.weight,
        consolidation_enabled=p.consolidation_enabled,
        kubelet=kubelet,
    )


def decode_node(n: pb.ExistingNode) -> SimNode:
    return SimNode(
        instance_type=n.instance_type,
        provisioner=n.provisioner,
        zone=n.zone,
        capacity_type=n.capacity_type,
        price=n.price,
        allocatable=_qdict(n.allocatable),
        labels=dict(n.labels),
        taints=[Taint(t.key, t.effect, t.value) for t in n.taints],
        pods=[decode_pod(p) for p in n.pods],
        existing=True,
        name=n.name,
    )


def decode_request(req: pb.SolveRequest):
    return dict(
        pods=[decode_pod(p) for p in req.pods],
        provisioners=[decode_provisioner(p) for p in req.provisioners],
        instance_types=[decode_instance_type(t) for t in req.instance_types],
        existing_nodes=[decode_node(n) for n in req.existing_nodes],
        daemonsets=[decode_pod(p) for p in req.daemonsets],
        unavailable={(u.instance_type, u.zone, u.capacity_type) for u in req.unavailable},
        allow_new_nodes=req.allow_new_nodes,
        max_new_nodes=req.max_new_nodes if req.has_max_new_nodes else None,
    )


def decode_trace_fields(req: pb.SolveRequest) -> "Tuple[str, str]":
    """The wire trace context of a SolveRequest: ``(trace_id,
    parent_span)``.  ``("", "")`` — old clients, unsampled origins —
    means "no remote parent"; every server entry that reads this must
    open its trace through ``Tracer.start_remote`` (ktlint KT019), which
    maps the empty context to a plain local start."""
    return (getattr(req, "trace_id", "") or "",
            getattr(req, "parent_span", "") or "")


def decode_delta_fields(req: pb.SolveRequest) -> Optional[dict]:
    """The delta-session envelope of a SolveRequest, or None for a classic
    (sessionless) solve.  Kept OUT of :func:`decode_request`'s dict — that
    dict feeds ``scheduler.solve(**kwargs)`` verbatim, and an old decoder
    reading new-field defaults must keep behaving like a plain solve."""
    sid = getattr(req, "session_id", "")
    if not sid:
        return None
    return dict(
        session_id=sid,
        base_epoch=int(getattr(req, "base_epoch", 0)),
        delta=bool(getattr(req, "delta", False)),
        removed=list(getattr(req, "removed_pods", ())),
        reclaimed=list(getattr(req, "reclaimed_nodes", ())),
        catalog_epoch=int(getattr(req, "catalog_epoch", 0)),
        # chain-identity nonce: "" from an old
        # client is the legacy wildcard — the server's nonce check only
        # fires when BOTH sides carry one
        nonce=str(getattr(req, "session_nonce", "") or ""),
    )


def encode_delta_reply(reply) -> pb.SolveResponse:
    """service/delta.DeltaReply -> wire.  Incremental replies carry only
    the step's changes; ``session_state``/``session_epoch``/``delta_mode``
    tell the client how to merge (service/client.DeltaSession)."""
    out = pb.SolveResponse(
        solve_ms=reply.solve_ms,
        session_epoch=int(reply.epoch),
        session_state=reply.state,
        delta_mode=reply.mode,
        session_nonce=getattr(reply, "nonce", "") or "",
    )
    for n in reply.nodes:
        out.nodes.append(pb.NewNode(
            name=n.name, instance_type=n.instance_type,
            provisioner=n.provisioner, zone=n.zone,
            capacity_type=n.capacity_type, price=n.price,
            pod_names=[p.name for p in n.pods],
        ))
    for k, v in reply.assignments.items():
        out.assignments[k] = v
    for k, v in reply.infeasible.items():
        out.infeasible[k] = v
    out.removed_nodes.extend(reply.removed_nodes)
    return out


#: delta_mode values whose reply carries the WHOLE solution (the client
#: replaces its ledger wholesale instead of merging the step's changes)
FULL_REPLY_MODES = ("establish", "reseed", "full", "")


def decode_delta_reply(resp: pb.SolveResponse):
    """wire -> service/delta.DeltaReply (node pods are name-stub PodSpecs,
    like :func:`decode_response`; DeltaSession re-attaches its ledger's
    real objects)."""
    from .delta import DeltaReply

    nodes = []
    for n in resp.nodes:
        node = SimNode(
            instance_type=n.instance_type, provisioner=n.provisioner,
            zone=n.zone, capacity_type=n.capacity_type, price=n.price,
            allocatable={}, name=n.name,
        )
        node.pods = [PodSpec(name=pn) for pn in n.pod_names]
        nodes.append(node)
    mode = getattr(resp, "delta_mode", "")
    return DeltaReply(
        state=getattr(resp, "session_state", ""),
        epoch=int(getattr(resp, "session_epoch", 0)),
        mode=mode,
        full=mode in FULL_REPLY_MODES,
        assignments=dict(resp.assignments),
        infeasible=dict(resp.infeasible),
        nodes=nodes,
        removed_nodes=list(getattr(resp, "removed_nodes", ())),
        solve_ms=resp.solve_ms,
        nonce=str(getattr(resp, "session_nonce", "") or ""),
    )


def decode_warm_request(req: pb.WarmRequest):
    return dict(
        provisioners=[decode_provisioner(p) for p in req.provisioners],
        instance_types=[decode_instance_type(t) for t in req.instance_types],
        daemonsets=[decode_pod(p) for p in req.daemonsets],
        existing_nodes=[decode_node(n) for n in req.existing_nodes],
    )


def decode_response(resp: pb.SolveResponse) -> SolveResult:
    nodes = []
    for n in resp.nodes:
        node = SimNode(
            instance_type=n.instance_type, provisioner=n.provisioner, zone=n.zone,
            capacity_type=n.capacity_type, price=n.price, allocatable={},
            name=n.name,
        )
        node.pods = [PodSpec(name=pn) for pn in n.pod_names]
        nodes.append(node)
    return SolveResult(
        nodes=nodes,
        assignments=dict(resp.assignments),
        infeasible=dict(resp.infeasible),
        solve_ms=resp.solve_ms,
    )
