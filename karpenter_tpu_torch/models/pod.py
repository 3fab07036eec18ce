"""Pod scheduling spec — the solver-facing slice of a k8s Pod.

Captures exactly the fields the reference's scheduler consumes
(website/content/en/preview/concepts/scheduling.md: resource requests :74-104,
node selectors/affinity :134-254, taints :256-301, topology spread :303-346,
pod affinity/anti-affinity :348-376) plus the priority / deletion-cost inputs
the consolidation disruption-cost formula needs
(designs/consolidation.md:25-36).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from . import labels as L
from .requirements import EXISTS, IN, Requirement, Requirements
from .resources import ResourceList

_pod_counter = itertools.count()


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"  # "Equal" | "Exists"
    value: str = ""
    effect: str = ""  # "" tolerates all effects

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclass(frozen=True)
class Taint:
    key: str
    effect: str  # NoSchedule | PreferNoSchedule | NoExecute
    value: str = ""

    def blocks(self, tolerations: Sequence[Toleration]) -> bool:
        """True if this taint prevents scheduling for a pod with ``tolerations``.

        PreferNoSchedule never hard-blocks (scheduling.md:256-301).
        """
        if self.effect == L.EFFECT_PREFER_NO_SCHEDULE:
            return False
        return not any(t.tolerates(self) for t in tolerations)


def _cached_frozen_hash(self, fields) -> int:
    """Structural hash memoized on the instance — constraint objects are
    hashed once per pod-dedup lookup (group_pods at 50k pods makes this the
    dominant tensorize cost), and deployment pods share selector/requirement
    instances, so the memo amortizes across the whole group."""
    h = self.__dict__.get("_h")
    if h is None:
        h = hash(fields)
        object.__setattr__(self, "_h", h)
    return h


@dataclass(frozen=True)
class LabelSelector:
    """matchLabels + matchExpressions over *pod* labels."""

    match_labels: Tuple[Tuple[str, str], ...] = ()
    match_expressions: Tuple[Requirement, ...] = ()

    def __hash__(self) -> int:
        return _cached_frozen_hash(self, (self.match_labels, self.match_expressions))

    @staticmethod
    def of(labels: Mapping[str, str] = (), expressions: Sequence[Requirement] = ()) -> "LabelSelector":
        return LabelSelector(tuple(sorted(dict(labels).items())), tuple(expressions))

    def matches(self, labels: Mapping[str, str]) -> bool:
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        if self.match_expressions:
            reqs = Requirements(self.match_expressions)
            return reqs.compatible(labels) is None
        return True


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str  # zone / hostname / capacity-type
    when_unsatisfiable: str  # "DoNotSchedule" | "ScheduleAnyway"
    label_selector: LabelSelector = LabelSelector()

    def __hash__(self) -> int:
        return _cached_frozen_hash(self, (
            self.max_skew, self.topology_key, self.when_unsatisfiable,
            self.label_selector))

    @property
    def hard(self) -> bool:
        return self.when_unsatisfiable == "DoNotSchedule"


@dataclass(frozen=True)
class PodAffinityTerm:
    label_selector: LabelSelector
    topology_key: str
    anti: bool = False  # True => anti-affinity

    def __hash__(self) -> int:
        return _cached_frozen_hash(self, (
            self.label_selector, self.topology_key, self.anti))

    def matches_pod(self, pod: "PodSpec") -> bool:
        return self.label_selector.matches(dict(pod.labels))


@dataclass
class PodSpec:
    """One pending pod as seen by the scheduler."""

    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    requests: ResourceList = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    # requiredDuringSchedulingIgnoredDuringExecution: OR over terms, AND within
    required_affinity_terms: List[List[Requirement]] = field(default_factory=list)
    # preferredDuringScheduling...: relaxed one at a time when unschedulable
    preferred_affinity_terms: List[List[Requirement]] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread: List[TopologySpreadConstraint] = field(default_factory=list)
    affinity_terms: List[PodAffinityTerm] = field(default_factory=list)  # pod (anti-)affinity
    priority: int = 0
    deletion_cost: float = 1.0  # pod-deletion-cost annotation analog
    owner_key: str = ""  # deployment/replicaset identity, for dedup grouping
    # persistent storage: PVC names this pod mounts (spec.volumes[].
    # persistentVolumeClaim.claimName) and the zone requirements the volume
    # topology injector derived from them (scheduling.md:378-433) — set by
    # VolumeTopology.inject before scheduling, ANDed into every term
    volume_claims: List[str] = field(default_factory=list)
    volume_zone_requirements: List[Requirement] = field(default_factory=list)
    do_not_evict: bool = False
    is_daemon: bool = False  # daemonset-owned: never blocks drain/emptiness
    # gang scheduling (docs/GANGS.md): members of one gang share a gang_id
    # and carry the gang's total size; ""/0 = ungrouped (old wire bytes
    # decode to exactly this).  A gang either FULLY places or contributes
    # zero nodes — enforced by karpenter_tpu/gang/ in the solve epilogue.
    gang_id: str = ""
    gang_size: int = 0
    uid: int = field(default_factory=lambda: next(_pod_counter))

    def __post_init__(self) -> None:
        if not self.name:
            self.name = f"pod-{self.uid}"

    # ---- requirement extraction --------------------------------------
    def scheduling_requirements(self, relax_preferred: int = 0) -> List[Requirements]:
        """The OR-list of requirement sets this pod can schedule under.

        nodeSelector ANDs into every term.  ``relax_preferred`` keeps the first
        N preferred terms as hard requirements (the reference's scheduler tries
        preferences first and relaxes on failure, scheduling.md:205-233); 0
        keeps none.
        """
        base = Requirements.from_labels(self.node_selector)
        for r in self.volume_zone_requirements:
            base.add(r)
        for term in self.preferred_affinity_terms[: relax_preferred]:
            for r in term:
                base.add(r)
        if not self.required_affinity_terms:
            return [base]
        out = []
        for term in self.required_affinity_terms:
            reqs = base.copy()
            for r in term:
                reqs.add(r)
            out.append(reqs)
        return out

    def anti_affinity_terms(self) -> List[PodAffinityTerm]:
        return [t for t in self.affinity_terms if t.anti]

    def affinity_terms_required(self) -> List[PodAffinityTerm]:
        return [t for t in self.affinity_terms if not t.anti]

    # ---- dedup key ----------------------------------------------------
    def group_key(self) -> tuple:
        """Pods with equal keys are interchangeable to the solver (same
        constraints + requests), enabling the group-dedup scan in solver/tpu.py.

        Cached: the scheduling-relevant fields are treated as immutable after
        construction (replace the pod object to change them)."""
        cached = self.__dict__.get("_group_key")
        if cached is not None:
            return cached
        key = self._compute_group_key()
        self.__dict__["_group_key"] = key
        return key

    def _compute_group_key(self) -> tuple:
        # hot at scale (called once per pod in tensorize.group_pods; 50k-pod
        # batches make this the dominant tensorize cost): avoid genexpr/sort
        # machinery for the tiny-dict common case
        labels = self.labels
        requests = self.requests
        selector = self.node_selector
        ra = self.required_affinity_terms
        pa = self.preferred_affinity_terms
        req_items = [(k, round(v, 9)) for k, v in requests.items()]
        if len(req_items) > 1:
            req_items.sort()
        return (
            self.namespace,
            (tuple(labels.items()) if len(labels) <= 1
             else tuple(sorted(labels.items()))) if labels else (),
            tuple(req_items),
            (tuple(selector.items()) if len(selector) <= 1
             else tuple(sorted(selector.items()))) if selector else (),
            tuple(map(tuple, ra)) if ra else (),
            tuple(map(tuple, pa)) if pa else (),
            tuple(self.tolerations) if self.tolerations else (),
            tuple(self.topology_spread) if self.topology_spread else (),
            tuple(self.affinity_terms) if self.affinity_terms else (),
            self.priority,
            (tuple(self.volume_zone_requirements)
             if self.volume_zone_requirements else ()),
            # gang identity splits dedup groups: two gangs with identical
            # specs must stay separately retractable (all-or-nothing is
            # judged per gang_id), and the relax/hierarchy rungs key gang
            # coupling off the group
            self.gang_id,
            self.gang_size,
        )

    def same_group_spec(self, other: "PodSpec") -> bool:
        """True where every field :meth:`group_key` reads equals
        ``other``'s, so both pods have one key without building either
        (``warmstart.build_meta``'s owner fast path; ``tensorize.group_pods``
        makes the same test inline, where a call per pod shows at 50,000
        pods).  False says nothing: keys can match after rounding.  MUST
        compare every field ``_compute_group_key`` reads."""
        return (
            self.requests == other.requests
            and self.labels == other.labels
            and self.node_selector == other.node_selector
            and self.priority == other.priority
            and self.tolerations == other.tolerations
            and self.topology_spread == other.topology_spread
            and self.affinity_terms == other.affinity_terms
            and self.required_affinity_terms == other.required_affinity_terms
            and self.preferred_affinity_terms
            == other.preferred_affinity_terms
            and self.volume_zone_requirements
            == other.volume_zone_requirements
            and self.namespace == other.namespace
            and self.gang_id == other.gang_id
            and self.gang_size == other.gang_size
        )
