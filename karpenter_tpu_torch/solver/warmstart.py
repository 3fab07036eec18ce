"""Warm-start delta solving — steady-state reconcile as an incremental update.

A steady-state reconcile differs from the previous solve by a handful of
pods, yet the solver always re-runs the full scan over every group
(ROADMAP open item 4).  CvxCluster (PAPERS.md) gets its 100-1000x from
exploiting exactly this perturbation structure: reuse the previous
assignment, solve only the *displaced* subproblem, and fall back to the
full solve when the perturbation is too large or couples into placements
the incremental step cannot legally keep.

Three tiers, cheapest first (``DeltaOutcome.mode``):

- **noop / host** — removals are pure bookkeeping; unconstrained added pods
  first-fit into the surviving nodes' residual capacity with a vectorized
  numpy pass (label/taint compatibility via ``node_classes`` memoization,
  resources via one ``[N, R]`` residual matrix carried incrementally across
  the delta chain).  Sub-millisecond on the CPU dev host — the steady-state
  p50 the bench gates (``measure_warmstart``).
- **scan** — displaced pods that carry their own constraints (or need new
  nodes) are solved by the regular device scan *seeded from the previous
  assignment*: the subproblem's existing-node tensors (residuals, selector
  counts, zone counters, provisioner usage) ARE the previous solution, so
  spread/affinity against already-placed pods is enforced exactly.
- **full** — the perturbation exceeds ``KT_DELTA_MAX_FRAC`` of the cluster's
  pods, or a parity guard trips: a surviving pod's spread/affinity selector
  matches a displaced pod of a *different* group (the incremental step
  cannot see that constraint), or ANY selector-watched pod is removed —
  own group included, since the remaining placements may then sit outside
  a spread band only a re-solve can restore — and the whole problem
  re-solves from the stripped base state.  Guards are deliberately
  conservative: falling back costs latency, never correctness.

Cost parity vs the from-scratch solve is pinned by ``scripts/fuzz_sweep.py
--delta`` (random add/remove/ICE chains) and gated in ``bench.py`` at the
existing ``cost_ratio <= 1.02`` ceiling.  When the perturbation is disjoint
(no displaced pod interacts with a surviving placement), untouched
assignments are byte-identical to the previous solve BY CONSTRUCTION — the
incremental step never moves a pod it did not have to.

Ownership contract: ``delta_solve`` CONSUMES ``prev`` — the surviving node
objects and the assignments dict are carried into the returned result (and
mutated) rather than copied, so a 50k-pod chain step stays sub-millisecond.
Callers that need the old result must snapshot it first.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..metrics import (
    WARMSTART_DISPLACED,
    WARMSTART_DURATION,
    WARMSTART_SOLVES,
    Registry,
    registry as default_registry,
)
from ..gang import gang_fixed
from ..models import labels as L
from ..models.pod import PodSpec
from .types import SimNode, SolveResult, node_classes

logger = logging.getLogger(__name__)

#: delta-size ceiling: a perturbation displacing/removing more than this
#: fraction of the cluster's solved pods falls back to the full solve (the
#: incremental win only exists while the delta is small; a half-rebuilt
#: cluster deserves a fresh pack)
DELTA_MAX_FRAC = float(os.environ.get("KT_DELTA_MAX_FRAC", "0.05"))

#: absolute floor under the fractional threshold: tiny clusters (tests,
#: fresh deployments) still take the incremental paths for single-digit
#: deltas instead of falling back at 5% of 20 pods
DELTA_MIN_PODS = int(os.environ.get("KT_DELTA_MIN_PODS", "8"))

#: delta modes, in escalation order — also the zero-inited label population
#: of karpenter_solver_warmstart_solves_total (KT003)
DELTA_MODES = ("noop", "host", "scan", "full")


def zero_init_metrics(registry: Registry) -> None:
    """Register the warm-start series at 0 so rate()/increase() never lose
    the first delta (KT003)."""
    for mode in DELTA_MODES:
        if not registry.counter(WARMSTART_SOLVES).has({"mode": mode}):
            registry.counter(WARMSTART_SOLVES).inc({"mode": mode}, value=0.0)
    registry.histogram(WARMSTART_DURATION)
    registry.histogram(WARMSTART_DISPLACED)


@dataclass
class DeltaOutcome:
    """One ``delta_solve`` step: the updated result plus how it was served."""

    result: SolveResult
    mode: str                 # noop | host | scan | full
    displaced: int            # pods the step had to (re-)place
    removed: int              # pods the step unseated
    total_pods: int           # solved pods after the step
    solve_ms: float           # wall time of the step
    #: node names this step created / dropped, maintained INCREMENTALLY
    #: (O(delta), never a scan of the fleet) — the delta-serving reply
    #: builder reads these instead of diffing node sets per RPC.  Empty on
    #: mode="full": the whole solution was rebuilt, deltas are meaningless.
    created_nodes: List[str] = field(default_factory=list)
    pruned_nodes: List[str] = field(default_factory=list)

    @property
    def fell_back(self) -> bool:
        return self.mode == "full"


@dataclass
class _Meta:
    """Incremental bookkeeping carried across a delta chain on the result
    object (``result._warmstart_meta``): the surviving nodes in creation
    order, their residual-capacity matrix, and the constraint selectors of
    seated pods (the coupling guard's index).  Rebuilding it is O(cluster);
    maintaining it is O(delta)."""

    nodes: List[SimNode]                  # existing nodes first, then proposals
    n_existing: int                       # split index into `nodes`
    node_idx: Dict[str, int]              # node name -> index
    res_names: List[str]                  # residual column vocabulary
    res_pos: Dict[str, int]
    residual: np.ndarray                  # [N, R] float64 remaining capacity
    #: distinct (selector, group_key) pairs over constraint-bearing seated
    #: pods — the guard that detects a surviving constraint coupling into
    #: the perturbation.  A set, not a list: a 5k-replica spread deployment
    #: contributes ONE entry, keeping the per-displaced-pod guard scan
    #: O(distinct selectors).  Removals leave stale entries (conservative:
    #: may force an unnecessary fallback, never an unsound host placement).
    sel_terms: Set[tuple] = field(default_factory=set)
    total_pods: int = 0
    #: accumulated ICE'd offerings ((instance_type, zone, capacity_type))
    unavailable: Set[tuple] = field(default_factory=set)
    #: pods a chain step failed to place (objects retained so removal /
    #: reclaim steps — the ones that free capacity or limit headroom — can
    #: re-offer them; pure adds never help an unplaced pod, so they skip
    #: the re-offer and keep the host fast path hot)
    unplaced: Dict[str, PodSpec] = field(default_factory=dict)
    #: node_classes memo per relevant-key set: (class key per node name,
    #: class representative list, per-requirement-signature ok rows)
    cls_cache: Dict[frozenset, dict] = field(default_factory=dict)
    #: pod name -> node name for pods PRE-SEATED on existing nodes (never
    #: in prev.assignments) — removals of those pods need the same
    #: bookkeeping as solver-assigned ones, not a silent no-op that
    #: diverges the chain's residual/total from the cluster
    preseated: Dict[str, str] = field(default_factory=dict)


def _pod_row(pod: PodSpec, res_pos: Dict[str, int]) -> Optional[np.ndarray]:
    """Pod requests as a residual-vocabulary row (pods column included), or
    None when the pod requests a resource outside the vocabulary."""
    row = np.zeros(len(res_pos), dtype=np.float64)
    for k, v in pod.requests.items():
        j = res_pos.get(k)
        if j is None:
            return None
        row[j] = v
    row[res_pos[L.RESOURCE_PODS]] = max(
        row[res_pos[L.RESOURCE_PODS]], 1.0)
    return row


def _constraint_sels(pod: PodSpec):
    """The selectors a seated pod's hard constraints watch (spread + pod
    (anti-)affinity) — what the coupling guard indexes."""
    for t in pod.topology_spread:
        yield t.label_selector
    for t in pod.affinity_terms:
        yield t.label_selector


def _has_constraints(pod: PodSpec) -> bool:
    return bool(pod.topology_spread or pod.affinity_terms
                or pod.preferred_affinity_terms)


def build_meta(prev: SolveResult, unavailable=None) -> _Meta:
    """O(cluster) rebuild of the chain bookkeeping from a plain result —
    paid once at chain start (or after a full fallback)."""
    nodes = list(prev.existing_nodes) + list(prev.nodes)
    res_names: List[str] = [L.RESOURCE_CPU, L.RESOURCE_MEMORY, L.RESOURCE_PODS]
    seen = set(res_names)
    for n in nodes:
        for p in n.pods:
            for k in p.requests:
                if k not in seen:
                    seen.add(k)
                    res_names.append(k)
    res_pos = {k: j for j, k in enumerate(res_names)}
    residual = np.zeros((len(nodes), len(res_names)), dtype=np.float64)
    sel_terms: Set[tuple] = set()
    preseated: Dict[str, str] = {}
    # the pods a full fallback left unplaced, retained on its result (see
    # _full): a result carries only their names, and a chain that dropped
    # the objects here would lose them at its next full re-solve
    unplaced = {n: p for n, p in getattr(prev, "_warmstart_unplaced",
                                         {}).items()
                if n in prev.infeasible}
    total = 0
    # the last constrained pod seen of each owner: a pod whose spec equals
    # it has its group key and its terms, already added
    last_of: Dict[tuple, PodSpec] = {}
    for i, n in enumerate(nodes):
        rem = n.remaining()
        for k, j in res_pos.items():
            residual[i, j] = rem.get(k, 0.0)
        for p in n.pods:
            total += 1
            if p.name not in prev.assignments:
                preseated[p.name] = n.name
            if p.topology_spread or p.affinity_terms:
                owner = (p.namespace, p.owner_key)
                rep = last_of.get(owner)
                if rep is not None and p.same_group_spec(rep):
                    continue
                last_of[owner] = p
                gk = p.group_key()
                for sel in _constraint_sels(p):
                    sel_terms.add((sel, gk))
    meta = _Meta(
        nodes=nodes, n_existing=len(prev.existing_nodes),
        node_idx={n.name: i for i, n in enumerate(nodes)},
        res_names=res_names, res_pos=res_pos, residual=residual,
        sel_terms=sel_terms, total_pods=total,
        unavailable=set(unavailable or ()),
        unplaced=unplaced,
        preseated=preseated,
    )
    return meta


def _matched_terms(meta: _Meta, pod: PodSpec) -> Tuple[bool, bool]:
    """(matched_by_own_group, matched_by_foreign_group) — whether any seated
    constraint selector watches this pod's labels."""
    own = foreign = False
    gk = None
    for sel, sel_gk in meta.sel_terms:
        if sel.matches(pod.labels):
            if gk is None:
                gk = pod.group_key()
            if sel_gk == gk:
                own = True
            else:
                foreign = True
                break
    return own, foreign


def _class_rows(meta: _Meta, pods: Sequence[PodSpec]):
    """Per-pod node-compatibility over the surviving fleet, memoized at
    (requirement signature x node class) like consolidation.compat_matrix.
    Returns ``ok[P, N]`` bool or None when any pod has OR'd terms (host path
    ineligible)."""
    relevant: Set[str] = set()
    sigs = []
    for p in pods:
        terms = p.scheduling_requirements()
        if len(terms) != 1:
            return None
        reqs = terms[0]
        sigs.append(((reqs.signature(), tuple(p.tolerations)), reqs,
                     tuple(p.tolerations)))
        relevant.update(reqs)
    rk = frozenset(relevant)
    cache = meta.cls_cache.get(rk)
    if cache is None or cache["n_nodes"] != len(meta.nodes):
        cls_idx, cls_rep = node_classes(meta.nodes, rk)
        cache = {"n_nodes": len(meta.nodes),
                 "cls_idx": np.asarray(cls_idx, dtype=np.int64),
                 "cls_rep": cls_rep, "rows": {}}
        meta.cls_cache[rk] = cache
    out = np.zeros((len(pods), len(meta.nodes)), dtype=bool)
    keys = []
    for pi, (key, reqs, tols) in enumerate(sigs):
        row = cache["rows"].get(key)
        if row is None:
            row = np.zeros(len(cache["cls_rep"]), dtype=bool)
            for c, rep in enumerate(cache["cls_rep"]):
                row[c] = (not any(t.blocks(tols) for t in rep.taints)
                          and reqs.compatible(rep.labels) is None)
            cache["rows"][key] = row
        out[pi] = row[cache["cls_idx"]]
        keys.append(key)
    return out, keys


def _drop_node(meta: _Meta, idx: int) -> None:
    """Remove a node row (reclaimed, or a proposal emptied by removals)."""
    if idx < meta.n_existing:
        meta.n_existing -= 1
    del meta.nodes[idx]
    meta.residual = np.delete(meta.residual, idx, axis=0)
    meta.node_idx = {n.name: i for i, n in enumerate(meta.nodes)}
    meta.cls_cache.clear()


def _append_node(meta: _Meta, node: SimNode) -> None:
    rem = node.remaining()
    row = np.array([rem.get(k, 0.0) for k in meta.res_names], dtype=np.float64)
    meta.nodes.append(node)
    meta.node_idx[node.name] = len(meta.nodes) - 1
    meta.residual = np.vstack([meta.residual, row[None, :]])
    meta.cls_cache.clear()


def delta_solve(
    prev: SolveResult,
    added: Sequence[PodSpec] = (),
    removed: Sequence[str] = (),
    iced: Sequence[object] = (),
    *,
    solve_displaced,
    solve_full,
    max_delta_frac: Optional[float] = None,
    registry: Optional[Registry] = None,
    unavailable=None,
    force_full: bool = False,
) -> DeltaOutcome:
    """One warm-started reconcile step.  ``added`` are new pods to place,
    ``removed`` are pod names leaving, ``iced`` entries are either
    ``(instance_type, zone, capacity_type)`` offerings newly unavailable or
    node NAMES reclaimed out from under the cluster (their pods displace).

    ``solve_displaced(pods, existing_nodes, unavailable)`` solves the
    displaced subproblem seeded by the surviving placements;
    ``solve_full(pods, existing_nodes, unavailable)`` is the fallback full
    solve against the stripped base state.  Both return a SolveResult.

    ``unavailable`` offerings accumulate onto the chain on EVERY step
    (same semantics as ``iced`` offering entries) — seeding the first
    step's bookkeeping and merging into it thereafter.

    ``force_full=True`` takes the full-fallback path unconditionally
    (after the removal/reclaim bookkeeping, so the re-solve sees the
    perturbed pod set): the delta-serving reseed path uses it when a
    catalog/price epoch bump invalidates every cost the chain was packed
    against — the re-solve from the stripped base keeps the session
    alive instead of cold-starting the client (docs/ARCHITECTURE.md
    round 14).
    """
    t0 = time.perf_counter()
    registry = registry or default_registry
    zero_init_metrics(registry)
    frac = DELTA_MAX_FRAC if max_delta_frac is None else max_delta_frac

    meta: Optional[_Meta] = getattr(prev, "_warmstart_meta", None)
    if meta is None:
        meta = build_meta(prev, unavailable=unavailable)
    elif unavailable:
        # per-call unavailability accumulates onto the chain exactly like
        # `iced` offerings — a warm-chain step must not silently ignore an
        # ICE the caller passed via the documented `unavailable=` param
        meta.unavailable.update(tuple(u) for u in unavailable)
    assignments = prev.assignments
    infeasible = prev.infeasible

    displaced: List[PodSpec] = list(added)
    reclaimed_pods: List[PodSpec] = []
    need_full = False
    created_nodes: List[str] = []
    pruned_nodes: List[str] = []

    # ---- iced: offerings and reclaimed nodes ---------------------------
    reclaim_names: List[str] = []
    for entry in iced:
        if isinstance(entry, str):
            reclaim_names.append(entry)
        else:
            meta.unavailable.add(tuple(entry))

    # ---- removals: pure bookkeeping ------------------------------------
    n_removed = 0
    maybe_emptied: Set[str] = set()  # proposal nodes that lost pods
    for name in removed:
        if name in infeasible:
            del infeasible[name]
            meta.unplaced.pop(name, None)
            continue
        # solver-assigned first, then pods PRE-SEATED on existing nodes
        # (never in assignments) — both get identical capacity/guard
        # bookkeeping, else the chain's residual silently diverges from
        # the cluster
        node_name = assignments.pop(name, None)
        if node_name is None:
            node_name = meta.preseated.pop(name, None)
        if node_name is None:
            continue
        n_removed += 1
        idx = meta.node_idx.get(node_name)
        if idx is None:
            continue
        node = meta.nodes[idx]
        for k, p in enumerate(node.pods):
            if p.name == name:
                # a constraint-watched removal breaks the incremental
                # invariant: the remaining placements may now sit outside a
                # spread band only a re-solve can restore
                if meta.sel_terms and any(
                    sel.matches(p.labels) for sel, _ in meta.sel_terms
                ):
                    need_full = True
                row = _pod_row(p, meta.res_pos)
                if row is not None:
                    meta.residual[idx] += row
                else:
                    need_full = True  # unknown resource: residual stale
                del node.pods[k]
                meta.total_pods -= 1
                if idx >= meta.n_existing and not node.pods:
                    maybe_emptied.add(node.name)
                break

    # ---- reclaimed nodes: displace their pods --------------------------
    for name in reclaim_names:
        idx = meta.node_idx.get(name)
        if idx is None:
            continue
        node = meta.nodes[idx]
        for p in node.pods:
            assignments.pop(p.name, None)
            meta.preseated.pop(p.name, None)
            meta.total_pods -= 1
            if p.is_daemon:
                # daemonsets recreate their pods wherever capacity lands;
                # the survivors' allocatable already carries the daemonset
                # overhead (same contract as the controller's what-ifs)
                continue
            if meta.sel_terms and any(
                sel.matches(p.labels) for sel, _ in meta.sel_terms
            ):
                need_full = True  # constraint-coupled displacement
            if _has_constraints(p):
                need_full = True  # its own constraints must re-solve globally
            reclaimed_pods.append(p)
        pruned_nodes.append(node.name)
        _drop_node(meta, idx)
    displaced = displaced + reclaimed_pods

    # drop proposal nodes the removals emptied (their cost is reclaimed).
    # Only nodes that LOST a pod this step can have emptied — tracked
    # above, so this stays O(delta): the delta-serving path calls this
    # per RPC and a scan of the whole proposal fleet would put an
    # O(cluster) pass under every sub-ms step.
    for name in maybe_emptied:
        idx = meta.node_idx.get(name)
        if idx is not None and idx >= meta.n_existing \
                and not meta.nodes[idx].pods:
            pruned_nodes.append(name)
            _drop_node(meta, idx)

    # removals / reclaims free capacity (and provisioner-limit headroom):
    # re-offer the pods earlier steps could not place — a full solve would
    # see them too, so skipping them here would silently under-schedule.
    # Deduped against the caller's own adds: a caller re-offering a
    # still-unplaced pod in `added` must not double it into the subproblem
    if (n_removed or reclaim_names) and meta.unplaced:
        offered = {p.name for p in displaced}
        displaced = displaced + [u for n, u in meta.unplaced.items()
                                 if n not in offered]
        meta.unplaced.clear()

    def _finish(result: SolveResult, mode: str, keep_meta: bool,
                total: Optional[int] = None) -> DeltaOutcome:
        if keep_meta:
            result._warmstart_meta = meta  # type: ignore[attr-defined]
        elif getattr(result, "_warmstart_meta", None) is not None:
            result._warmstart_meta = None  # type: ignore[attr-defined]
        ms = (time.perf_counter() - t0) * 1000.0
        registry.counter(WARMSTART_SOLVES).inc({"mode": mode})
        registry.histogram(WARMSTART_DURATION).observe(ms / 1000.0)
        registry.histogram(WARMSTART_DISPLACED).observe(len(displaced))
        return DeltaOutcome(
            result=result, mode=mode, displaced=len(displaced),
            removed=n_removed,
            total_pods=meta.total_pods if total is None else total,
            solve_ms=ms,
            created_nodes=[] if mode == "full" else created_nodes,
            pruned_nodes=[] if mode == "full" else pruned_nodes,
        )

    def _rewrap() -> SolveResult:
        """Fresh SolveResult over the (mutated, shared) chain containers."""
        return SolveResult(
            nodes=meta.nodes[meta.n_existing:],
            assignments=assignments,
            infeasible=infeasible,
            existing_nodes=meta.nodes[:meta.n_existing],
            solve_ms=0.0,
        )

    def _full() -> DeltaOutcome:
        # re-solve everything from the stripped base: original existing
        # nodes minus every solver-assigned pod, plus all solved pods —
        # including the pods earlier steps could not place (the re-offer
        # above only fires on removals; a full repack must not silently
        # drop them from the problem)
        all_pods: List[PodSpec] = list(displaced)
        seen = {p.name for p in all_pods}
        all_pods.extend(p for n, p in meta.unplaced.items() if n not in seen)
        base: List[SimNode] = []
        for i, n in enumerate(meta.nodes):
            if i < meta.n_existing:
                snap = n.snapshot()
                keep, mine = [], []
                for p in snap.pods:
                    (mine if p.name in assignments else keep).append(p)
                snap.pods = keep
                all_pods.extend(mine)
                base.append(snap)
            else:
                all_pods.extend(n.pods)
        result = solve_full(all_pods, base, set(meta.unavailable))
        # the chain restarts from this result with a rebuilt meta: keep the
        # objects of the pods it left unplaced, so the next full re-solve
        # (or a removal's re-offer) still sees them
        result._warmstart_unplaced = {  # type: ignore[attr-defined]
            p.name: p for p in all_pods if p.name in result.infeasible}
        return _finish(result, "full", keep_meta=False,
                       total=len(all_pods) - len(result.infeasible))

    # ---- threshold + coupling guards -----------------------------------
    total = meta.total_pods + len(displaced)
    if force_full or need_full or (displaced or n_removed) and (
        len(displaced) + n_removed
        > max(float(DELTA_MIN_PODS), frac * max(total, 1))
    ):
        return _full()

    if not displaced:
        return _finish(_rewrap(), "noop", keep_meta=True)

    # classify the displaced pods: host-eligible (no constraints of their
    # own, nothing watching them), scan (own constraints / own-group
    # coupling / needs a new node), or full (foreign coupling)
    host_ok = True
    for p in displaced:
        own, foreign = _matched_terms(meta, p)
        if foreign:
            return _full()
        # gang members never take the host fast path: only the scan
        # subproblem runs the gang epilogue, and the host first-fit could
        # otherwise seat an INCOMPLETE gang (short of its declared size)
        # with no all-or-nothing audit (docs/GANGS.md)
        if (own or _has_constraints(p) or p.volume_claims or p.is_daemon
                or gang_fixed(p)):
            host_ok = False

    if host_ok:
        rows = [_pod_row(p, meta.res_pos) for p in displaced]
        compat = None
        if all(r is not None for r in rows):
            compat = _class_rows(meta, displaced)
        if compat is not None:
            ok_pn, sig_keys = compat
            # group identical pods (same request row + same compat
            # signature) and place each group by one vectorized prefix
            # allocation over nodes in creation order — value-identical to
            # per-pod first-fit for interchangeable pods, one numpy pass
            # per GROUP instead of six ops per pod
            by_key: Dict[tuple, List[int]] = {}
            for i in range(len(displaced)):
                by_key.setdefault(
                    (rows[i].tobytes(), sig_keys[i]), []).append(i)
            order = sorted(
                by_key.items(),
                key=lambda kv: (-float(rows[kv[1][0]].sum()),
                                displaced[kv[1][0]].name),
            )
            res = meta.residual.copy()
            picks: List[Tuple[int, int]] = []
            fit_all = True
            for _key, idxs in order:
                row = rows[idxs[0]]
                ok = ok_pn[idxs[0]]
                pos = row > 0
                cap = np.floor(np.min(
                    np.where(pos[None, :],
                             (res + 1e-9) / np.maximum(row[None, :], 1e-12),
                             np.inf),
                    axis=1))
                cap = np.where(ok & (cap > 0), cap, 0.0)
                before = np.cumsum(cap) - cap
                take = np.clip(len(idxs) - before, 0.0, cap)
                if take.sum() < len(idxs) - 1e-9:
                    fit_all = False
                    break
                res -= row[None, :] * take[:, None]
                it = iter(idxs)
                for j in np.nonzero(take)[0]:
                    for _ in range(int(round(take[j]))):
                        picks.append((next(it), int(j)))
            if fit_all:
                meta.residual = res
                for i, j in picks:
                    pod, node = displaced[i], meta.nodes[j]
                    node.pods.append(pod)
                    assignments[pod.name] = node.name
                    infeasible.pop(pod.name, None)
                    # a caller-re-offered pod that now placed must leave
                    # the retention dict, or a later removal would
                    # re-offer (and double-seat) it again
                    meta.unplaced.pop(pod.name, None)
                meta.total_pods += len(displaced)
                return _finish(_rewrap(), "host", keep_meta=True)
            # some pod needs a new node: the scan decides which to buy

    # ---- scan: the displaced subproblem seeded from the previous
    # assignment (existing-node tensors ARE the previous solution)
    sub = solve_displaced(list(displaced), list(meta.nodes),
                          set(meta.unavailable))
    new_by_name = {n.name: n for n in sub.nodes}
    adopted: Dict[str, SimNode] = {}
    for p in displaced:
        target = sub.assignments.get(p.name)
        if target is None:
            infeasible[p.name] = sub.infeasible.get(
                p.name, "solver: no feasible placement")
            meta.unplaced[p.name] = p
            continue
        infeasible.pop(p.name, None)
        meta.unplaced.pop(p.name, None)  # placed: retention entry retired
        meta.total_pods += 1
        assignments[p.name] = target
        idx = meta.node_idx.get(target)
        if idx is not None:
            node = meta.nodes[idx]
            # by NAME, not identity: the scheduler hardens preference-
            # bearing pods (ScheduleAnyway spread, preferred affinity) via
            # copy before seating them, so the object on the node is a
            # copy of `p` — an identity check would re-append the original
            # and double-book the node
            seated = any(q.name == p.name for q in node.pods)
            if not seated:
                node.pods.append(p)
            if seated and target in adopted:
                # a node adopted THIS step got its residual row from
                # node.remaining(), which already accounts for every pod
                # the solver seated on it — subtracting again would
                # understate the node's slack for the rest of the chain
                pass
            else:
                row = _pod_row(p, meta.res_pos)
                if row is not None:
                    meta.residual[idx] -= row
                else:
                    # out-of-vocabulary resource: recompute the row exactly
                    # so a stale residual can never over-offer this node to
                    # a later host-path placement
                    rem = node.remaining()
                    meta.residual[idx] = [rem.get(k, 0.0)
                                          for k in meta.res_names]
        else:
            node = new_by_name.get(target)
            if node is not None and target not in adopted:
                adopted[target] = node
                created_nodes.append(target)
                _append_node(meta, node)
        if _has_constraints(p):
            gk = p.group_key()
            for sel in _constraint_sels(p):
                meta.sel_terms.add((sel, gk))
    result = _rewrap()
    result.solve_ms = sub.solve_ms
    return _finish(result, "scan", keep_meta=True)
