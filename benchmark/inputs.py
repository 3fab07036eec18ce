"""The program's side of the inputs: the benchmark's catalog records,
provisioner and pending sets turned into ``karpenter_tpu_torch`` objects,
and a returned plan turned back into plain records for the reference.

Everything here is made from the benchmark's own records: the program is
handed instance types, a provisioner and pods, and nothing of what it
derives from them is read back except the plan it returns.
"""

from __future__ import annotations

import itertools

from . import catalog as C

#: program label keys of the provisioner's requirements over a type's
#: attributes
_REQ_KEYS = {"os": C.OS, "arch": C.ARCH, "category": C.INSTANCE_CATEGORY,
             "generation": C.INSTANCE_GENERATION}

#: uids of the fresh pod copies: far above any the program mints itself
_UIDS = itertools.count(1 << 40)


def instance_types(records) -> list:
    from karpenter_tpu_torch.models.instancetype import (
        InstanceType,
        Offering,
        Overhead,
    )
    from karpenter_tpu_torch.models.requirements import (
        Requirement,
        Requirements,
    )

    out = []
    for r in records:
        reqs = Requirements([Requirement(k, op, list(v))
                             for k, op, v in r["requirements"]])
        out.append(InstanceType(
            name=r["name"], requirements=reqs,
            offerings=[Offering(zone=z, capacity_type=ct, price=p)
                       for z, ct, p in r["offerings"]],
            capacity=dict(r["capacity"]),
            overhead=Overhead(**{k: dict(v)
                                 for k, v in r["overhead"].items()})))
    return out


def provisioner(spec: dict):
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.models.requirements import Requirement

    reqs = [Requirement(_REQ_KEYS[k], op, list(v))
            for k, op, v in spec["requirements"]]
    reqs.append(Requirement(C.CAPACITY_TYPE, "In",
                            list(spec["capacity_types"])))
    return Provisioner(name=spec["name"], requirements=reqs)


def templates(pending: dict) -> list:
    """The set's pods, deployment by deployment, each with its zone
    spread on its own selector.  Templates are never handed to the
    program: it gets :func:`fresh` copies."""
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )

    pods = []
    for dep in pending["deployments"]:
        name = dep["name"]
        spread = []
        if dep["max_skew"] is not None:
            spread = [TopologySpreadConstraint(
                dep["max_skew"], C.ZONE, "DoNotSchedule",
                LabelSelector.of({"app": name}))]
        if "." in name:
            raise ValueError(f"a deployment's name has no dot: {name!r}")
        for i in range(dep["replicas"]):
            pods.append(PodSpec(
                name=f"{name}-{i}", labels={"app": name},
                requests={"cpu": dep["cpu"], "memory": dep["memory"]},
                topology_spread=spread, owner_key=name))
    return pods


def fresh(tmpl: list, tag: str) -> list:
    """New pod objects for one offer of a set, named ``<template>.<tag>``:
    what a decoder hands the scheduler for every request, so no cache of
    the program can recognise an earlier offer by identity."""
    if "." in tag:
        raise ValueError(f"a copy's tag has no dot: {tag!r}")
    out = []
    new = object.__new__
    for t in tmpl:
        p = new(type(t))
        d = t.__dict__.copy()
        d["name"] = f"{t.name}.{tag}"
        d["uid"] = next(_UIDS)
        p.__dict__ = d
        out.append(p)
    return out


def index_of(tmpl: list) -> dict:
    return {p.name: i for i, p in enumerate(tmpl)}


def plain_plan(result, index: dict, tag: str) -> dict:
    """A returned ``SolveResult`` as the reference reads plans: nodes as
    ``(type, zone, capacity type, price, pod indices)``.  A pod is the
    set's only under the name this offer gave it (``<template>.<tag>``):
    any other name, an earlier offer's of the same set too, is -1."""

    def idx(name: str) -> int:
        base, _, t = name.rpartition(".")
        return index.get(base, -1) if t == tag else -1

    nodes, pos = [], {}
    for n in result.nodes:
        pos[n.name] = len(nodes)
        nodes.append((n.instance_type, n.zone, n.capacity_type,
                      float(n.price), [idx(p.name) for p in n.pods]))
    return {
        "nodes": nodes,
        "infeasible": [idx(name) for name in result.infeasible],
        "assigned": {idx(p): pos.get(n, -1)
                     for p, n in result.assignments.items()},
    }
