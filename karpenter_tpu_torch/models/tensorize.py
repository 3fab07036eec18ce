"""Lower pods x provisioners x instance types into solver tensors.

This is the bridge between the k8s-object world (models/*) and the TPU solver
(solver/tpu.py).  Axes:

- **G** — deduplicated pod groups (pods with identical constraints+requests),
  sorted in FFD order (decreasing magnitude).  50k pods from deployments
  typically collapse to O(100) groups; heterogeneous pods degrade to G == P
  and the solver still works, just with a longer scan.
- **C** — node candidates = compatible (provisioner, instance-type) pairs.
  Provisioner requirements are folded in host-side: incompatible pairs are
  dropped, provisioner labels override type labels.
- **D** — topology domains = zone x capacity-type combos.  Hostname domains
  are *not* an axis (one per node, created during the solve — SURVEY §7 "hard
  parts"); they are handled by per-row counters in the solver.
- **R** — resource vocabulary.
- **K/W** — label keys and packed mask words (models/vocab.py).
- **S** — interned (selector, topology-key, kind) constraint slots for
  topology-spread and pod (anti-)affinity.

Everything emitted is a dense numpy array, ready to become a jnp array.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from . import labels as L
from .instancetype import InstanceType, Offering, specialize_for_kubelet
from .pod import LabelSelector, PodAffinityTerm, PodSpec, TopologySpreadConstraint
from .provisioner import Provisioner
from .requirements import Requirement, Requirements
from .vocab import ABSENT, Vocab

# Baseline resources every solve carries, in a stable order.
CORE_RESOURCES = (L.RESOURCE_CPU, L.RESOURCE_MEMORY, L.RESOURCE_EPHEMERAL_STORAGE, L.RESOURCE_PODS)

NO_SELECTOR = -1


@dataclass
class PodGroup:
    """One dedup'd slice of the pending-pod set."""

    key: tuple
    pods: List[PodSpec]
    requirements: Requirements  # pod-level (first required term; OR-terms beyond 1 split groups)
    requests: Dict[str, float]

    @property
    def count(self) -> int:
        return len(self.pods)


@dataclass
class ConstraintSlots:
    """Interned topology/affinity constraint table (the S axis)."""

    selectors: List[Tuple[LabelSelector, str, str]] = field(default_factory=list)  # (sel, topo, kind)
    index: Dict[tuple, int] = field(default_factory=dict)

    def intern(self, sel: LabelSelector, topology_key: str, kind: str) -> int:
        key = (sel, topology_key, kind)
        sid = self.index.get(key)
        if sid is None:
            sid = len(self.selectors)
            self.selectors.append((sel, topology_key, kind))
            self.index[key] = sid
        return sid

    def __len__(self) -> int:
        return len(self.selectors)


@dataclass
class SolveTensors:
    """Everything the TPU solver consumes.  See module docstring for axes."""

    vocab: Vocab
    groups: List[PodGroup]

    # group axis (FFD-sorted)
    counts: np.ndarray       # [G] int32
    requests: np.ndarray     # [G, R] f32 — per-pod requests (pods resource == 1)
    pm: np.ndarray           # [G, K, W] uint32 requirement masks
    magnitude: np.ndarray    # [G] f32 FFD sort key

    # spread / affinity per group (slot id or NO_SELECTOR)
    g_zone_spread: np.ndarray   # [G] int32 slot id
    g_zone_skew: np.ndarray     # [G] int32 maxSkew
    g_host_spread: np.ndarray   # [G] int32 (covers hostname spread AND hostname anti-affinity)
    g_host_cap: np.ndarray      # [G] int32 max matching pods per node (maxSkew; 1 for anti-affinity)
    g_zone_anti: np.ndarray     # [G] int32 zone-scoped anti-affinity slot
    g_sel_match: np.ndarray     # [S, G] bool — group's pods match selector s

    # candidate axis
    cand_names: List[Tuple[str, str]]   # (provisioner, instance type)
    cand_alloc: np.ndarray   # [C, R] f32 allocatable
    cand_cap: np.ndarray     # [C, R] f32 raw capacity (for provisioner limits)
    cand_vw: np.ndarray      # [C, K] int32 (value-id // 32)
    cand_vb: np.ndarray      # [C, K] int32 (value-id % 32)
    cand_prov: np.ndarray    # [C] int32
    cand_price: np.ndarray   # [C, D] f32 ($/hr; +inf where no offering)
    cand_avail: np.ndarray   # [C, D] bool
    key_check: np.ndarray    # [K] bool — keys checked on the C axis (zone/ct excluded)
    gp_ok: np.ndarray        # [G, P] bool — group tolerates prov taints & reqs intersect

    # provisioner axis
    prov_names: List[str]
    prov_weight: np.ndarray  # [P] f32
    prov_limits: np.ndarray  # [P, R] f32 (+inf where unset)

    # domain axis
    dom_zone: np.ndarray     # [D] int32 zone ordinal
    dom_vw: np.ndarray       # [D, 2] int32 packed word idx for (zone key, ct key)
    dom_vb: np.ndarray       # [D, 2] int32 bit idx
    zone_names: List[str]
    ct_names: List[str]      # capacity types in domain-minor order (d = z*|ct| + ct)
    n_zones: int
    # selector table backing the S axis: (LabelSelector, topology_key, kind)
    selector_defs: List[Tuple[LabelSelector, str, str]] = field(default_factory=list)
    # positive pod-affinity slots (NO_SELECTOR when absent): the solver's
    # per-group modes are (A) matching pods exist -> co-locate with them,
    # (B) none but self-matching -> seed one zone/node, (C) infeasible
    g_zone_paff: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int32))
    g_host_paff: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int32))
    # groups whose positive-affinity shape the device can't express (>1
    # positive term per topology key, or a key other than zone/hostname);
    # callers route these pods to the CPU oracle
    g_positive_affinity: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=bool))
    #: any group carries a hard capacity-type spread — such batches route to
    #: the sequential oracle wholesale (scheduler.batch_needs_oracle; the
    #: constraint couples groups through the shared ct domains and limits),
    #: and the native tier declines them (native.has_topology)
    has_ct_spread: bool = False
    # gang tag per group (docs/GANGS.md): ordinal into the batch's
    # gang roster, -1 ungrouped.  Consumed host-side only (hierarchy's
    # union-find joins equal tags so a gang is never split across blocks) —
    # the device scan never sees it, so gang-free tensors stay byte-stable
    g_gang: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int32))

    @property
    def G(self) -> int:
        return len(self.counts)

    @property
    def C(self) -> int:
        # cand_* arrays are padded to >=1 row so jit shapes stay valid; the
        # padding row is inert (avail all-False) and not a real candidate
        return len(self.cand_names)

    @property
    def D(self) -> int:
        return len(self.dom_zone)

    @property
    def R(self) -> int:
        return self.requests.shape[1]

    @property
    def S(self) -> int:
        return self.g_sel_match.shape[0]

    def capacity_row(self, instance_type: str, allocatable) -> np.ndarray:
        """Raw machine-capacity row for an existing node's type — provisioner
        limits bind on CAPACITY, not allocatable (the creation-time checks and
        the ground-truth validator both use it); falls back to the node's own
        allocatable for types outside the catalog.  Single accounting rule
        shared by the device and native solvers (the oracle applies the same
        rule over its dict representation)."""
        cache = getattr(self, "_type_cap", None)
        if cache is None:
            cache = {it: self.cand_cap[ci]
                     for ci, (_p, it) in enumerate(self.cand_names)}
            self._type_cap = cache
        row = cache.get(instance_type)
        if row is None:
            row = self.vocab.resources_to_row(allocatable)
        return np.asarray(row, dtype=np.float32)


def batch_needs_oracle(pods: Sequence[PodSpec]) -> bool:
    """A hard capacity-type spread couples the WHOLE batch to the sequential
    engine, not just its own group: ct domains are consumed through shared
    provisioner limits and through co-location on other groups' nodes (the
    reference's interleaved FFD places a ct-spread pod onto the open capacity
    an earlier group bought in the scarce ct — fuzz seed 19: a per-group
    carve-out after right-sized device packing stranded 10 pods the oracle
    seats).  Such batches solve wholesale on the oracle."""
    return any(
        tsc.hard and tsc.topology_key == L.CAPACITY_TYPE
        for p in pods for tsc in p.topology_spread
    )


def device_inexpressible(pod: PodSpec) -> bool:
    """Constraint shapes the device solver can't express (v1): more than one
    positive affinity term per topology key, an affinity key other than
    zone/hostname, or a hard topology spread over a key other than
    zone/hostname — ``karpenter.sh/capacity-type`` spread
    (scheduling.md:303-346's third supported topologyKey) is placed exactly
    by the oracle (reference.py ``_place_group_ct``); any OTHER key is
    rejected there as infeasible with a reason, mirroring the reference's
    unsupported-topology-key error.  Single source of truth — the
    scheduler's oracle carve-out and tensorize's ``g_positive_affinity``
    flag both use this."""
    for tsc in pod.topology_spread:
        if tsc.hard and tsc.topology_key not in (L.ZONE, L.HOSTNAME):
            return True
    nz = nh = 0
    for t in pod.affinity_terms:
        if t.topology_key not in (L.ZONE, L.HOSTNAME):
            # exotic (anti-)affinity keys go to the oracle's unsupported-key
            # rejection — a dropped anti-affinity term silently co-locates
            # the replicas it exists to separate
            return True
        if t.anti:
            continue
        if t.topology_key == L.ZONE:
            nz += 1
        else:
            nh += 1
    return nz > 1 or nh > 1


def pack_feasibility(feas: np.ndarray) -> np.ndarray:
    """Pack a boolean/float feasibility tensor to ``int8`` (1 feasible /
    0 not).  The hierarchical hot path (solver/hierarchy.py) streams
    ``[G, C]`` feasibility through the packed score kernel every price
    wave; int8 cuts the HBM bytes 4× vs the float32 layout the relax rung
    materializes — and on the host it quarters what the block builder
    copies per wave."""
    f = np.asarray(feas)
    if f.dtype == np.int8:
        return f
    return (f != 0).astype(np.int8)


def pack_scores(scores: np.ndarray) -> "torch.Tensor":
    """Pack a float score/price vector to a CPU ``torch.bfloat16`` tensor
    for the packed kernel.  bf16 keeps float32's exponent range while
    halving the bytes; 8 mantissa bits are plenty for ORDERING on-demand
    prices (the kernel only ever compares, and both the kernel and its
    plain version upcast to float32 the same way, so parity holds
    bit-for-bit).  The cast rounds to nearest-even, so the bytes equal
    ``ml_dtypes.bfloat16``'s — including 3.0e38, which packs to 0x7F62
    (3.0041e38): the sentinel does NOT survive exactly, and callers filter
    on ``< 1e37`` rather than on equality."""
    import torch

    f32 = np.ascontiguousarray(scores, dtype=np.float32)
    return torch.from_numpy(f32).to(torch.bfloat16)


def _ffd_magnitude(requests: Mapping[str, float]) -> float:
    """Deterministic FFD sort key: CPU cores + memory scaled at 4GiB/core +
    GPU heavily weighted.  Both solvers (oracle + TPU) share this exact key,
    per designs/bin-packing.md step 1 ("non-increasing order of resources")."""
    cpu = requests.get(L.RESOURCE_CPU, 0.0)
    mem = requests.get(L.RESOURCE_MEMORY, 0.0) / (4.0 * 1024.0**3)
    gpu = requests.get(L.RESOURCE_GPU, 0.0) * 64.0
    return cpu + mem + gpu


def group_pods(pods: Sequence[PodSpec]) -> List[PodGroup]:
    """Dedup pods into interchangeable groups, FFD-sorted (desc magnitude).

    Pods with multiple OR'd required-affinity terms use only their first term
    for grouping (v1 limitation: OR-terms beyond the first are not explored;
    the reference relaxes through terms similarly).

    Deployment-shaped batches take an owner-key fast path: a pod whose
    (namespace, owner) matches the previous pod of that owner compares
    field-for-field against the group's representative instead of building +
    hashing the full structural key (the dominant cold-tensorize cost at 50k
    pods).  Group membership and ordering are identical to the structural
    path — the fast path only short-circuits provably-equal specs.
    """
    by_key: Dict[tuple, PodGroup] = {}
    owner_cache: Dict[Tuple[str, str], PodGroup] = {}
    for p in pods:
        oc = (p.namespace, p.owner_key) if p.owner_key else None
        if oc is not None:
            grp = owner_cache.get(oc)
            if grp is not None:
                # Exact spec equality on the group_key fields, inline (the
                # function-call overhead alone is a measurable fraction of
                # the 50k-pod hot loop).  Sound fast-path test: exact
                # equality implies group-key equality (the reverse needn't
                # hold — e.g. float-noise requests that only match after
                # rounding fall through to the structural-key path and
                # still land in the right group).  MUST compare every field
                # group_key() reads.
                rep = grp.pods[0]
                if (
                    p.requests == rep.requests
                    and p.labels == rep.labels
                    and p.node_selector == rep.node_selector
                    and p.priority == rep.priority
                    and p.tolerations == rep.tolerations
                    and p.topology_spread == rep.topology_spread
                    and p.affinity_terms == rep.affinity_terms
                    and p.required_affinity_terms == rep.required_affinity_terms
                    and p.preferred_affinity_terms == rep.preferred_affinity_terms
                    and p.volume_zone_requirements == rep.volume_zone_requirements
                    and p.gang_id == rep.gang_id
                    and p.gang_size == rep.gang_size
                ):
                    grp.pods.append(p)
                    continue
        k = p.group_key()
        grp = by_key.get(k)
        if grp is None:
            reqs = p.scheduling_requirements()[0]
            grp = PodGroup(key=k, pods=[], requirements=reqs, requests=dict(p.requests))
            by_key[k] = grp
        grp.pods.append(p)
        if oc is not None:
            owner_cache[oc] = grp
    groups = list(by_key.values())
    groups.sort(key=lambda g: (-_ffd_magnitude(g.requests), g.pods[0].name))
    return groups


# kubelet-specialization memo: build_candidates runs on every solve, and a
# kc-bearing provisioner would otherwise redo the same Requirements rebuild
# for every catalog type each time.  Keyed on (id(it), kc.signature()); the
# stored strong ref to `it` both validates the id (reuse-safe) and pins it
# while cached.  Bounded LRU so long-lived processes with churning catalogs
# don't grow without bound.
_KC_MEMO: Dict[tuple, tuple] = {}
_KC_MEMO_MAX = 8192


def _specialized(it: InstanceType, kc) -> InstanceType:
    if kc is None or not kc.affects_capacity():
        return it
    key = (id(it), kc.signature())
    hit = _KC_MEMO.get(key)
    if hit is not None and hit[0] is it:
        return hit[1]
    out = specialize_for_kubelet(it, kc)
    if len(_KC_MEMO) >= _KC_MEMO_MAX:
        _KC_MEMO.pop(next(iter(_KC_MEMO)))
    _KC_MEMO[key] = (it, out)
    return out


def build_candidates(
    provisioners: Sequence[Provisioner],
    instance_types: Sequence[InstanceType],
) -> List[Tuple[int, Provisioner, InstanceType, Requirements]]:
    """Compatible (provisioner, type) pairs with merged requirements.

    Mirrors the host-side filter at cloudprovider.go:305-324 (machine
    requirements x instance type requirements x offering availability).
    Provisioners are ordered by weight desc (scheduling.md:435-525) before
    pairing so candidate order encodes provisioner priority.
    """
    out = []
    ordered = sorted(enumerate(provisioners), key=lambda ip: (-ip[1].weight, ip[1].name))
    for pi, prov in ordered:
        preqs = prov.scheduling_requirements()
        kc = prov.kubelet
        for it in instance_types:
            # per-provisioner kubeletConfiguration changes pod density and
            # reservations, so the candidate carries a specialized type
            # (reference constructs instance types per-provisioner with kc
            # threaded through — instancetype.go:50-357)
            it_p = _specialized(it, kc)
            if preqs.intersects(it_p.requirements) is not None:
                continue
            merged = it_p.requirements.copy().add(preqs)
            out.append((pi, prov, it_p, merged))
    return out


class TensorizeContext:
    """Pod-independent precompute for one (provisioners, instance_types,
    daemonsets) configuration.

    Everything here is a pure, deterministic function of the constructor
    arguments, so routing a ``tensorize`` call through a cached context is
    byte-identical to building a transient one: the candidate pairs, each
    pair's canonical requirement list (``merged.to_list()`` dominated the
    round-5 cold profile), the node-side label dicts, and the
    daemonset-adjusted allocatable dicts are computed once per configuration
    instead of once per solve.  The vocab-dependent tensor fills stay in
    ``tensorize`` — the resource/key id space depends on the pod groups."""

    def __init__(
        self,
        provisioners: Sequence[Provisioner],
        instance_types: Sequence[InstanceType],
        daemonsets: Sequence[PodSpec] = (),
    ) -> None:
        self.daemonsets = list(daemonsets)
        self.pairs = build_candidates(provisioners, instance_types)
        self.ordered_provs = sorted(
            provisioners, key=lambda p: (-p.weight, p.name))
        self.prov_reqs = {
            p.name: p.scheduling_requirements() for p in self.ordered_provs}
        self.merged_lists = [m.to_list() for _pi, _prov, _it, m in self.pairs]
        ds_reqs = [d.scheduling_requirements() for d in self.daemonsets]
        self.labels_nodeside: List[Dict[str, str]] = []
        self.labels_full: List[Dict[str, str]] = []
        self.alloc_ds: List[Dict[str, float]] = []
        for _pi, prov, it, _m in self.pairs:
            labels_nodeside = {**it.labels(), **prov.labels}
            self.labels_nodeside.append(labels_nodeside)
            self.labels_full.append(
                {**labels_nodeside, L.PROVISIONER_NAME: prov.name})
            alloc = dict(it.allocatable)
            # daemonset overhead: same filter as the oracle (tolerate
            # provisioner taints + requirements compatible with node-side
            # labels)
            for d, dreqs in zip(self.daemonsets, ds_reqs):
                if any(t.blocks(d.tolerations) for t in prov.taints):
                    continue
                if any(r.compatible(labels_nodeside) is not None
                       for r in dreqs):
                    continue
                for rname, v in d.requests.items():
                    alloc[rname] = alloc.get(rname, 0.0) - v
                alloc[L.RESOURCE_PODS] = alloc.get(L.RESOURCE_PODS, 0.0) - 1.0
            self.alloc_ds.append(alloc)


# per-object structural-signature memo for catalog entries: instance types
# are treated as immutable (same contract as _KC_MEMO); the stored strong
# ref validates the id against reuse and pins the object while cached
_IT_SIG_MEMO: Dict[int, tuple] = {}
_IT_SIG_MEMO_MAX = 16384


def _instance_type_sig(it: InstanceType) -> tuple:
    key = id(it)
    hit = _IT_SIG_MEMO.get(key)
    if hit is not None and hit[0] is it:
        return hit[1]
    sig = (
        it.name,
        it.requirements.signature(),
        tuple(it.offerings),
        tuple(sorted(it.capacity.items())),
        tuple(sorted(it.overhead.total().items())),
    )
    if len(_IT_SIG_MEMO) >= _IT_SIG_MEMO_MAX:
        _IT_SIG_MEMO.pop(next(iter(_IT_SIG_MEMO)))
    _IT_SIG_MEMO[key] = (it, sig)
    return sig


def _provisioner_sig(p: Provisioner) -> tuple:
    # computed fresh each call (provisioners are few and are the objects an
    # operator mutates in place on settings changes — identity memoization
    # here would miss exactly the invalidation that matters)
    return (
        p.name,
        p.weight,
        tuple((r.key, r.operator, tuple(r.values)) for r in p.requirements),
        tuple(p.taints),
        tuple(p.startup_taints),
        tuple(sorted(p.labels.items())),
        tuple(sorted(p.limits.items())),
        p.kubelet.signature() if p.kubelet is not None else None,
    )


def context_signature(
    provisioners: Sequence[Provisioner],
    instance_types: Sequence[InstanceType],
    daemonsets: Sequence[PodSpec] = (),
) -> tuple:
    """Structural identity of everything in a solve EXCEPT the pods: a
    change in any provisioner, catalog entry, or daemonset produces a new
    signature and therefore a cold ``TensorizeCache`` rebuild."""
    return (
        tuple(_provisioner_sig(p) for p in provisioners),
        tuple(_instance_type_sig(it) for it in instance_types),
        tuple(d.group_key() for d in daemonsets),
    )


class TensorizeCache:
    """Incremental tensorize: group-level tensors built once per batch shape
    and reused across solves.

    Production provisioning loops see the same deployment shapes solve
    after solve; steady-state tensorize should be a cache lookup plus a
    counts vector, not a 50k-row rebuild.  Three tiers, fastest first:

    - **identity** — the pod sequence is element-identical to one of the
      last :data:`MAX_IDENTITY` calls' (a C-level pointer-compare pass per
      probed entry; pods are treated as immutable after construction, the
      same contract ``PodSpec.group_key`` memoization already relies on):
      that call's ``SolveTensors`` is returned verbatim, counts included.
      An LRU, not a single slot, because the megabatch serving path
      interleaves many clients' reconcile loops through one scheduler —
      each re-offering its own pending set — and a depth-1 tier would
      thrash to the grouping pass on every request.
    - **shape** — the pods group to a key sequence seen before (same
      deployment shapes, possibly different replica counts or fresh pod
      objects): every tensor is reused by reference and only ``groups`` +
      the ``counts`` vector are rebuilt — byte-identical to a from-scratch
      build by construction, since none of the cached arrays depends on
      counts.
    - **miss** — full build, routed through the cached
      :class:`TensorizeContext` (catalog-side precompute), then stored.

    Any provisioner/catalog/daemonset change rotates ``context_signature``
    and drops everything; the ``unavailable`` ICE mask is part of every
    entry key.  Not thread-safe: callers serialize solves (the scheduler's
    existing non-reentrancy contract).
    """

    MAX_SHAPES = 128
    #: identity-tier LRU depth: one slot per concurrently-reconciling client
    #: the serving path interleaves (service/server.py --max-slots tops out
    #: at 32; the +1 absorbs a one-off extra caller)
    MAX_IDENTITY = 33

    def __init__(self) -> None:
        self._ctx: Optional[TensorizeContext] = None
        self._ctx_key: Optional[tuple] = None
        self._shapes: Dict[tuple, SolveTensors] = {}
        #: most-recent-first [(pods_list, ukey, st)]
        self._ident: List[tuple] = []
        self.hits: Dict[str, int] = {"identity": 0, "shape": 0}
        self.misses = 0

    def tensorize(
        self,
        pods: Sequence[PodSpec],
        provisioners: Sequence[Provisioner],
        instance_types: Sequence[InstanceType],
        *,
        daemonsets: Sequence[PodSpec] = (),
        unavailable: Optional[set] = None,
    ) -> Tuple[SolveTensors, str]:
        """Returns ``(tensors, tier)`` with tier in identity/shape/miss."""
        ckey = context_signature(provisioners, instance_types, daemonsets)
        if ckey != self._ctx_key:
            self._ctx = TensorizeContext(provisioners, instance_types,
                                         daemonsets)
            self._ctx_key = ckey
            self._shapes.clear()
            self._ident.clear()
        ukey = frozenset(unavailable or ())
        # snapshot the sequence: storing the caller's own list would alias
        # it, and an in-place append before the next call would then compare
        # the mutated list against itself — a false identity hit that
        # silently drops the new pods.  One C-level pointer copy.
        pods_list = list(pods)
        # identity tier: list == compares elements via the C-level identity
        # shortcut (PyObject_RichCompareBool), so a re-solve of the same pod
        # objects costs one pointer pass per probed LRU entry; fresh-but-
        # equal objects differ at their uid field and fall through after ONE
        # structural compare per entry.  Length pre-check skips the pass for
        # differently-sized clients.
        for i, (ident_pods, ident_ukey, ident_st) in enumerate(self._ident):
            if (ident_ukey == ukey and len(ident_pods) == len(pods_list)
                    and ident_pods == pods_list):
                if i:
                    self._ident.insert(0, self._ident.pop(i))
                self.hits["identity"] += 1
                return ident_st, "identity"
        groups = group_pods(pods_list)
        skey = (ukey, tuple(g.key for g in groups))
        st = self._shapes.get(skey)
        if st is not None:
            counts = np.array([g.count for g in groups], dtype=np.int32)
            st = dataclasses.replace(st, groups=groups, counts=counts)
            self.hits["shape"] += 1
            tier = "shape"
        else:
            st = tensorize(
                pods_list, provisioners, instance_types,
                daemonsets=daemonsets, unavailable=unavailable,
                groups=groups, ctx=self._ctx,
            )
            if len(self._shapes) >= self.MAX_SHAPES:
                self._shapes.pop(next(iter(self._shapes)))
            # store groups-stripped: a shape hit swaps in the fresh groups
            # anyway, and retaining them would pin up to MAX_SHAPES full
            # pod batches (millions of PodSpec objects at 50k-pod scale)
            self._shapes[skey] = dataclasses.replace(st, groups=[])
            self.misses += 1
            tier = "miss"
        self._ident.insert(0, (pods_list, ukey, st))
        del self._ident[self.MAX_IDENTITY:]
        return st, tier


def tensorize(
    pods: Sequence[PodSpec],
    provisioners: Sequence[Provisioner],
    instance_types: Sequence[InstanceType],
    *,
    daemonsets: Sequence[PodSpec] = (),
    vocab: Optional[Vocab] = None,
    unavailable: Optional[set] = None,  # {(instance_type, zone, capacity_type)} ICE-style mask
    groups: Optional[List[PodGroup]] = None,
    ctx: Optional[TensorizeContext] = None,
) -> SolveTensors:
    vocab = vocab or Vocab()
    unavailable = unavailable or set()
    if groups is None:
        groups = group_pods(pods)
    if ctx is None:
        ctx = TensorizeContext(provisioners, instance_types, daemonsets)
    pairs = ctx.pairs

    # ---- pass 1: intern everything ------------------------------------
    for r in CORE_RESOURCES:
        vocab.resource(r)
    zone_set: Dict[str, int] = {}
    ct_set: Dict[str, int] = {}
    for (_, prov, it, merged), mlist in zip(pairs, ctx.merged_lists):
        for req in mlist:
            vocab.key(req.key)  # valueless operators (Exists/DoesNotExist) too
            for v in req.values:
                vocab.value(req.key, v)
        for o in it.offerings:
            zone_set.setdefault(o.zone, len(zone_set))
            ct_set.setdefault(o.capacity_type, len(ct_set))
            vocab.value(L.ZONE, o.zone)
            vocab.value(L.CAPACITY_TYPE, o.capacity_type)
        for rname in it.capacity:
            vocab.resource(rname)
    for g in groups:
        for req in g.requirements.to_list():
            vocab.key(req.key)
            for v in req.values:
                vocab.value(req.key, v)
        for rname in g.requests:
            vocab.resource(rname)
    for d in daemonsets:
        for rname in d.requests:
            vocab.resource(rname)
    zone_key = vocab.key(L.ZONE)
    ct_key = vocab.key(L.CAPACITY_TYPE)

    # ---- constraint slots ---------------------------------------------
    slots = ConstraintSlots()
    g_zone_spread = np.full(len(groups), NO_SELECTOR, dtype=np.int32)
    g_zone_skew = np.ones(len(groups), dtype=np.int32)
    g_host_spread = np.full(len(groups), NO_SELECTOR, dtype=np.int32)
    g_host_cap = np.zeros(len(groups), dtype=np.int32)
    g_zone_anti = np.full(len(groups), NO_SELECTOR, dtype=np.int32)
    g_zone_paff = np.full(len(groups), NO_SELECTOR, dtype=np.int32)
    g_host_paff = np.full(len(groups), NO_SELECTOR, dtype=np.int32)
    g_unsupported = np.zeros(len(groups), dtype=bool)
    for gi, g in enumerate(groups):
        rep = g.pods[0]
        g_unsupported[gi] = device_inexpressible(rep)
        for term in rep.affinity_terms_required():
            if term.topology_key not in (L.ZONE, L.HOSTNAME):
                continue
            sid = slots.intern(term.label_selector, term.topology_key, "affinity")
            if term.topology_key == L.ZONE:
                g_zone_paff[gi] = sid
            else:
                g_host_paff[gi] = sid
        for tsc in rep.topology_spread:
            if not tsc.hard:
                # ScheduleAnyway reaches the solver only pre-hardened: the
                # scheduler folds soft spreads into the relaxation ladder
                # (scheduler._harden_preferences), so by the time tensors are
                # built every honored spread is DoNotSchedule; leftovers here
                # are preferences already relaxed away
                continue
            sid = slots.intern(tsc.label_selector, tsc.topology_key, "spread")
            if tsc.topology_key == L.ZONE:
                g_zone_spread[gi] = sid
                g_zone_skew[gi] = tsc.max_skew
            elif tsc.topology_key == L.HOSTNAME:
                g_host_spread[gi] = sid
                g_host_cap[gi] = tsc.max_skew
        for term in rep.anti_affinity_terms():
            sid = slots.intern(term.label_selector, term.topology_key, "anti")
            if term.topology_key == L.HOSTNAME:
                # one hostname slot per group: when both a hostname spread and
                # a hostname anti-affinity exist, keep the stricter cap
                # (anti-affinity caps at 1-if-self-match, encoded as 0 here)
                if g_host_spread[gi] == NO_SELECTOR or g_host_cap[gi] > 1:
                    g_host_spread[gi] = sid
                    g_host_cap[gi] = 0
            elif term.topology_key == L.ZONE:
                g_zone_anti[gi] = sid

    S = max(1, len(slots))
    g_sel_match = np.zeros((S, len(groups)), dtype=bool)
    for sid, (sel, _topo, _kind) in enumerate(slots.selectors):
        for gi, g in enumerate(groups):
            g_sel_match[sid, gi] = sel.matches(g.pods[0].labels)
    # hostname anti-affinity: a self-matching group gets cap 1 (one per node),
    # a non-matching group may not co-locate with matchers at all (cap enforced
    # in-solver via row counters); spread groups keep their maxSkew cap.
    for gi in range(len(groups)):
        sid = g_host_spread[gi]
        if sid != NO_SELECTOR and g_host_cap[gi] == 0:
            g_host_cap[gi] = 1 if g_sel_match[sid, gi] else 0

    vocab.frozen = True
    K, W, R = vocab.n_keys, vocab.mask_words(), vocab.n_resources

    # ---- group tensors -------------------------------------------------
    G = len(groups)
    counts = np.array([g.count for g in groups], dtype=np.int32)
    requests = np.zeros((G, R), dtype=np.float32)
    pm = np.zeros((G, K, W), dtype=np.uint32)
    magnitude = np.zeros(G, dtype=np.float32)
    for gi, g in enumerate(groups):
        req_full = dict(g.requests)
        req_full.setdefault(L.RESOURCE_PODS, 1.0)
        requests[gi] = vocab.resources_to_row(req_full).astype(np.float32)
        pm[gi] = vocab.requirements_to_mask(g.requirements)
        magnitude[gi] = _ffd_magnitude(g.requests)

    # ---- provisioner tensors -------------------------------------------
    ordered_provs = ctx.ordered_provs
    prov_index = {p.name: i for i, p in enumerate(ordered_provs)}
    P = max(1, len(ordered_provs))
    prov_weight = np.zeros(P, dtype=np.float32)
    prov_limits = np.full((P, R), np.inf, dtype=np.float32)
    for i, p in enumerate(ordered_provs):
        prov_weight[i] = p.weight
        for rname, cap in p.limits.items():
            rid = vocab.resource_id.get(rname)
            if rid is not None:
                prov_limits[i, rid] = cap

    prov_reqs = ctx.prov_reqs
    gp_ok = np.zeros((G, P), dtype=bool)
    for gi, g in enumerate(groups):
        rep = g.pods[0]
        for p in ordered_provs:
            i = prov_index[p.name]
            gp_ok[gi, i] = (
                p.tolerates(rep)
                and g.requirements.intersects(prov_reqs[p.name]) is None
            )

    # ---- domain axis ----------------------------------------------------
    zones = sorted(zone_set, key=zone_set.get)
    cts = sorted(ct_set, key=ct_set.get)
    doms = [(z, c) for z in zones for c in cts]
    D = max(1, len(doms))
    dom_zone = np.zeros(D, dtype=np.int32)
    dom_vw = np.zeros((D, 2), dtype=np.int32)
    dom_vb = np.zeros((D, 2), dtype=np.int32)
    for di, (z, c) in enumerate(doms):
        dom_zone[di] = zones.index(z)
        zvid = vocab.value_id[zone_key][z]
        cvid = vocab.value_id[ct_key][c]
        dom_vw[di] = (zvid // 32, cvid // 32)
        dom_vb[di] = (zvid % 32, cvid % 32)

    # ---- candidate tensors ----------------------------------------------
    C = len(pairs)
    cand_names: List[Tuple[str, str]] = []
    cand_alloc = np.zeros((max(1, C), R), dtype=np.float32)
    cand_cap = np.zeros((max(1, C), R), dtype=np.float32)
    candV = np.zeros((max(1, C), K), dtype=np.int32)
    cand_prov = np.zeros(max(1, C), dtype=np.int32)
    cand_price = np.full((max(1, C), D), np.inf, dtype=np.float32)
    cand_avail = np.zeros((max(1, C), D), dtype=bool)
    dom_index = {zc: i for i, zc in enumerate(doms)}
    for ci, (pi, prov, it, merged) in enumerate(pairs):
        cand_names.append((prov.name, it.name))
        # daemonset overhead was folded into ctx.alloc_ds once per
        # configuration (same filter as the oracle: tolerate provisioner
        # taints + requirements compatible with node-side labels)
        cand_alloc[ci] = vocab.resources_to_row(ctx.alloc_ds[ci]).astype(np.float32)
        cand_cap[ci] = vocab.resources_to_row(it.capacity).astype(np.float32)
        candV[ci] = vocab.labels_to_ids(ctx.labels_full[ci])
        cand_prov[ci] = prov_index[prov.name]
        preqs = prov_reqs[prov.name]
        zone_ok = preqs.get(L.ZONE)
        ct_ok = preqs.get(L.CAPACITY_TYPE)
        for o in it.offerings:
            di = dom_index.get((o.zone, o.capacity_type))
            if di is None:
                continue
            ok = (
                o.available
                and zone_ok.contains(o.zone)
                and ct_ok.contains(o.capacity_type)
                and (it.name, o.zone, o.capacity_type) not in unavailable
            )
            if ok:
                cand_avail[ci, di] = True
                cand_price[ci, di] = o.price
            elif np.isinf(cand_price[ci, di]):
                cand_price[ci, di] = o.price  # keep price for consolidation math

    key_check = np.ones(K, dtype=bool)
    key_check[zone_key] = False
    key_check[ct_key] = False

    # ---- gang tags ------------------------------------------------------
    # ordinal per distinct gang_id, first-seen order over the FFD-sorted
    # groups; group_key includes gang_id, so a gang's members can span
    # several groups (heterogeneous ranks) but a group never mixes gangs
    g_gang = np.full(G, -1, dtype=np.int32)
    gang_ord: Dict[str, int] = {}
    for gi, g in enumerate(groups):
        gid = g.pods[0].gang_id
        if gid:
            g_gang[gi] = gang_ord.setdefault(gid, len(gang_ord))

    return SolveTensors(
        vocab=vocab,
        groups=groups,
        counts=counts,
        requests=requests,
        pm=pm,
        magnitude=magnitude,
        g_zone_spread=g_zone_spread,
        g_zone_skew=g_zone_skew,
        g_host_spread=g_host_spread,
        g_host_cap=g_host_cap,
        g_zone_anti=g_zone_anti,
        g_sel_match=g_sel_match,
        cand_names=cand_names,
        cand_alloc=cand_alloc,
        cand_cap=cand_cap,
        cand_vw=candV // 32,
        cand_vb=candV % 32,
        cand_prov=cand_prov,
        cand_price=cand_price,
        cand_avail=cand_avail,
        key_check=key_check,
        gp_ok=gp_ok,
        prov_names=[p.name for p in ordered_provs],
        prov_weight=prov_weight,
        prov_limits=prov_limits,
        dom_zone=dom_zone,
        dom_vw=dom_vw,
        dom_vb=dom_vb,
        zone_names=zones,
        ct_names=cts,
        n_zones=len(zones),
        selector_defs=list(slots.selectors),
        g_zone_paff=g_zone_paff,
        g_host_paff=g_host_paff,
        g_positive_affinity=g_unsupported,
        has_ct_spread=batch_needs_oracle(g.pods[0] for g in groups),
        g_gang=g_gang,
    )
