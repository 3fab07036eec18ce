"""Gang & rank-aware scheduling — all-or-nothing pod groups.

The port of the reference package's ``gang`` package, its imports pointing
into the port.  Members of one gang share a ``gang_id`` and carry the
gang's declared ``gang_size`` (old bytes decode to ""/0 = ungrouped).
The contract:

- **All-or-nothing.**  A gang either FULLY places or contributes zero
  nodes: one infeasible member retracts every comember's seat, and every
  member surfaces as unplaced with the typed :class:`GangUnplaced`
  reason.  A partial gang placement is impossible by construction.
- **Rank/topology packing.**  Fully-placed gangs are judged on a spread
  penalty (distinct zones first, distinct node classes — the rack proxy
  — second) and re-packed onto co-located capacity when the combined
  node-cost + ``KT_GANG_SPREAD_WEIGHT x spread`` objective strictly
  improves; never-worse by construction, like the relax rung.
- **One unit everywhere.**  A gang is one admission unit, one delta
  perturbation (an add places atomically or falls back to the full solve;
  a member removal retracts the gang), a hierarchy coupling component that
  is never split across blocks, a consolidation what-if unit, and
  relax-rung ineligible (members keep their scan seats as fixed boundary
  conditions, like spread-constrained pods).

This package owns every per-member gang judgement: the solver reads gang
membership only through the helpers below.

``KT_GANG=0`` kills the whole subsystem: no epilogue, no retraction, no
coupling — byte-identical to pre-gang behavior.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..metrics import (
    GANG_DURATION,
    GANG_GANGS,
    GANG_OUTCOMES,
    GANG_SPREAD_CLASSES,
    GANG_SPREAD_ZONES,
)
from ..models import labels as L
from ..models.pod import PodSpec

logger = logging.getLogger(__name__)

#: cross-node-class spread weighs a fraction of cross-zone spread: a gang
#: split across racks (node classes) inside one zone is closer than one
#: split across zones (the paper's rank-distance ordering)
CLASS_SPREAD_FRACTION = 0.1
#: co-location what-ifs attempted per spread-out gang (candidate zones,
#: best-first); bounds the epilogue at a few sequential oracle passes
MAX_PACK_CANDIDATES = 3


def gang_enabled() -> bool:
    """KT_GANG kill switch: default on; 0 restores pre-gang behavior
    byte-for-byte (no epilogue, no retraction, no coupling, no packing)."""
    return os.environ.get("KT_GANG", "1") != "0"


def spread_weight() -> float:
    """KT_GANG_SPREAD_WEIGHT: $/hr-equivalent charged per unit of gang
    spread (one unit = one extra zone; an extra node class costs
    CLASS_SPREAD_FRACTION of that).  The packing epilogue adopts a
    repack only when node-cost + weight x spread strictly improves."""
    try:
        return float(os.environ.get("KT_GANG_SPREAD_WEIGHT", "0.25"))
    except ValueError:
        return 0.25


class GangValidationError(ValueError):
    """A request's gang tagging is inconsistent (members of one gang_id
    disagree on gang_size, or a declared size is not positive).  Raised at
    the service entry point BEFORE admission — the gang is one ticket, so
    a malformed gang is refused whole (INVALID_ARGUMENT on the wire)."""


class GangUnplaced:
    """Typed unplaced reason for every member of a retracted gang.

    Stringifies into ``SolveResult.infeasible`` values (the reason dict is
    str -> str on the wire); :func:`is_gang_reason` recognizes the typed
    prefix so callers can branch without parsing prose.
    """

    PREFIX = "GangUnplaced"

    __slots__ = ("gang_id", "gang_size", "seated")

    def __init__(self, gang_id: str, gang_size: int, seated: int) -> None:
        self.gang_id = gang_id
        self.gang_size = gang_size
        self.seated = seated

    def __str__(self) -> str:
        return (
            f"{self.PREFIX}: gang '{self.gang_id}' could seat only "
            f"{self.seated}/{self.gang_size} members — all-or-nothing "
            "retracted every seat (a gang never places partially)"
        )

    @classmethod
    def is_gang_reason(cls, reason: str) -> bool:
        return isinstance(reason, str) and reason.startswith(cls.PREFIX)


def is_gang_reason(reason: str) -> bool:
    return GangUnplaced.is_gang_reason(reason)


# ---- membership helpers (the sanctioned per-member entry points) --------

def gang_of(pod: PodSpec) -> str:
    """The pod's gang id, "" for ungrouped — the one sanctioned attribute
    read serving code routes through."""
    return getattr(pod, "gang_id", "") or ""


def gang_fixed(pod: PodSpec) -> bool:
    """True when the pod's seat is a fixed boundary condition for the
    relax rung (a gang member with the subsystem enabled)."""
    return gang_enabled() and bool(gang_of(pod))


def has_gangs(pods: Iterable[PodSpec]) -> bool:
    return any(gang_of(p) for p in pods)


def gang_members(pods: Iterable[PodSpec]) -> Dict[str, List[PodSpec]]:
    """gang_id -> members present in ``pods`` (insertion-ordered)."""
    out: Dict[str, List[PodSpec]] = {}
    for p in pods:
        gid = gang_of(p)
        if gid:
            out.setdefault(gid, []).append(p)
    return out


def declared_size(members: Sequence[PodSpec]) -> int:
    """The gang's declared size: the members' gang_size (validated equal),
    floored at the member count for robustness against 0/unset sizes."""
    declared = max((int(getattr(p, "gang_size", 0) or 0) for p in members),
                   default=0)
    return max(declared, len(members))


def validate_batch(pods: Iterable[PodSpec]) -> None:
    """Service-entry gang audit: every member of one gang_id must declare
    the same positive gang_size (or leave it unset).  Raises
    :class:`GangValidationError` — the gang is one admission ticket, so a
    malformed gang refuses whole before admission ever queues it."""
    if not gang_enabled():
        return
    sizes: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    for p in pods:
        gid = gang_of(p)
        if not gid:
            continue
        size = int(getattr(p, "gang_size", 0) or 0)
        if size < 0:
            raise GangValidationError(
                f"gang '{gid}': member '{p.name}' declares negative "
                f"gang_size {size}")
        counts[gid] = counts.get(gid, 0) + 1
        if size:
            prev = sizes.setdefault(gid, size)
            if prev != size:
                raise GangValidationError(
                    f"gang '{gid}': members disagree on gang_size "
                    f"({prev} vs {size}) — a gang is judged whole and "
                    "must declare one size")
    for gid, n in counts.items():
        size = sizes.get(gid, 0)
        if size and n > size:
            raise GangValidationError(
                f"gang '{gid}': request carries {n} members but declares "
                f"gang_size {size}")


def admission_units(pods: Iterable[PodSpec]) -> int:
    """Admission-ticket count of a batch: each gang is ONE unit (classes/
    quotas judge it whole; a shed sheds the whole gang), singletons one
    each.  Pure accounting — the queue admits the request as one ticket
    either way; this is the number surfaced on traces/stats."""
    gangs: Set[str] = set()
    singles = 0
    for p in pods:
        gid = gang_of(p)
        if gid:
            gangs.add(gid)
        else:
            singles += 1
    return singles + len(gangs)


def zero_init_gang_metrics(registry) -> None:
    """The gang outcome series exist at zero from scheduler
    construction, guarded so re-construction over a shared registry never
    clobbers live counts."""
    c = registry.counter(GANG_GANGS)
    for outcome in GANG_OUTCOMES:
        if not c.has({"outcome": outcome}):
            c.inc({"outcome": outcome}, value=0.0)
    # unlabeled histograms: touching the family registers it so the
    # first real gang observation is rate()-visible
    registry.histogram(GANG_SPREAD_ZONES)
    registry.histogram(GANG_SPREAD_CLASSES)
    registry.histogram(GANG_DURATION)


# ---- placement audit ----------------------------------------------------

def _preseated_counts(result, batch_names: Set[str]) -> Dict[str, int]:
    """Members already seated on the result's nodes but NOT part of this
    batch, per gang — a delta/consolidation subproblem solves a gang
    subset while its comembers stay seated on existing capacity, and the
    all-or-nothing audit must count those seats."""
    out: Dict[str, int] = {}
    for n in list(result.existing_nodes) + list(result.nodes):
        for q in n.pods:
            gid = gang_of(q)
            if gid and q.name not in batch_names:
                out[gid] = out.get(gid, 0) + 1
    return out


def _watched(retracted: Sequence[PodSpec], result) -> bool:
    """Whether removing ``retracted`` seats could disturb someone else's
    constraint accounting: any REMAINING pod carries a spread or
    (anti-)affinity selector matching a retracted pod's labels.  When
    true, the in-place retraction is unsafe (removing a counted pod can
    strand a spread band mid-hole) and the caller re-solves instead."""
    gone = {p.name for p in retracted}
    labels = [p.labels for p in retracted]
    for n in list(result.existing_nodes) + list(result.nodes):
        for q in n.pods:
            if q.name in gone:
                continue
            for tsc in q.topology_spread:
                if any(tsc.label_selector.matches(lb) for lb in labels):
                    return True
            for term in q.affinity_terms:
                if any(term.label_selector.matches(lb) for lb in labels):
                    return True
    return False


def _retract_seats(result, members: Sequence[PodSpec]) -> None:
    """Unseat ``members`` in place: pop assignments, drop the pod objects
    from their nodes, and drop solver-proposed nodes left without a
    non-daemon pod (the gang bought them; retraction returns them)."""
    names = {p.name for p in members}
    touched: Set[str] = set()
    by_name = {n.name: n for n in list(result.nodes) + list(result.existing_nodes)}
    for p in members:
        node_name = result.assignments.pop(p.name, None)
        if node_name is None:
            continue
        node = by_name.get(node_name)
        if node is not None:
            node.pods = [q for q in node.pods if q.name not in names]
            touched.add(node.name)
    result.nodes = [
        n for n in result.nodes
        if n.name not in touched or any(not q.is_daemon for q in n.pods)
    ]


# ---- the solve epilogue -------------------------------------------------

def _gang_nodes(result, members: Sequence[PodSpec]) -> Optional[List]:
    """The node objects hosting every member, or None if any member's
    assignment points at a node the result no longer carries."""
    by_name = {n.name: n for n in list(result.nodes) + list(result.existing_nodes)}
    out = []
    for p in members:
        node = by_name.get(result.assignments.get(p.name, ""))
        if node is None:
            return None
        out.append(node)
    return out


def _spread(nodes: Sequence) -> Tuple[int, int, float]:
    """(zones, node_classes, penalty) of a fully-placed gang's seats."""
    zones = {n.zone for n in nodes}
    classes = {n.instance_type for n in nodes}
    penalty = (len(zones) - 1) + CLASS_SPREAD_FRACTION * (len(classes) - 1)
    return len(zones), len(classes), penalty


def _member_zones(members: Sequence[PodSpec], zone_names: Sequence[str]) -> List[str]:
    """Zones every member may legally land in (node_selector pin ANDed
    with volume zone requirements) — the co-location candidates."""
    allowed = list(zone_names)
    for p in members:
        pin = p.node_selector.get(L.ZONE)
        if pin is not None:
            allowed = [z for z in allowed if z == pin]
        for r in p.volume_zone_requirements:
            vs = r.value_set()
            allowed = [z for z in allowed if vs.contains(z)]
    return allowed


def _try_pack(result, gid: str, members: Sequence[PodSpec], *,
              provisioners, instance_types, daemonsets, unavailable,
              allow_new_nodes, max_new_nodes, in_band: Callable,
              old_penalty: float) -> bool:
    """One gang's co-location repack: what-if the members pinned to each
    candidate zone against everything else placed, adopt the first
    strictly-cheaper (node cost + weighted spread) answer.  Never-worse
    by construction — rejection keeps the valid incumbent."""
    from ..solver.reference import solve as oracle_solve

    w = spread_weight()
    if w <= 0.0:
        return False
    # a hard zone-spread member makes co-location ILLEGAL, not just a
    # what-if the oracle can veto: the pinned copy's selector narrows its
    # eligible-zone set to the pin (skew trivially satisfied in the
    # sub-solve), but the ORIGINAL pod restored after adoption is judged
    # over the full eligible set — packing would ship a skew violation
    if any(t.topology_key == L.ZONE and t.when_unsatisfiable == "DoNotSchedule"
           for p in members for t in p.topology_spread):
        return False
    zone_names: List[str] = []
    for it in instance_types:
        for o in it.offerings:
            if o.zone not in zone_names:
                zone_names.append(o.zone)
    allowed = _member_zones(members, zone_names)
    if not allowed:
        return False

    names = {p.name for p in members}
    base = []
    emptied_price = {}
    n_existing = len(result.existing_nodes)
    for i, n in enumerate(list(result.existing_nodes) + list(result.nodes)):
        s = n.snapshot()
        s.pods = [q for q in s.pods if q.name not in names]
        base.append(s)
        if i >= n_existing and not any(not q.is_daemon for q in s.pods):
            emptied_price[s.name] = s.price
    # candidate order: where the gang already sits (fewest moves), then by
    # free capacity proxy (node count) — bounded attempts
    seat_zone: Dict[str, int] = {}
    for p in members:
        node = next((n for n in list(result.nodes) + list(result.existing_nodes)
                     if n.name == result.assignments.get(p.name)), None)
        if node is not None:
            seat_zone[node.zone] = seat_zone.get(node.zone, 0) + 1
    candidates = sorted(
        allowed, key=lambda z: (-seat_zone.get(z, 0), z))[:MAX_PACK_CANDIDATES]

    budget = (None if max_new_nodes is None
              else max(0, max_new_nodes - len(result.nodes)))
    for z in candidates:
        pinned = []
        for p in members:
            q = copy.copy(p)
            q.node_selector = dict(p.node_selector)
            q.node_selector[L.ZONE] = z
            q.__dict__.pop("_group_key", None)
            pinned.append(q)
        try:
            sub = oracle_solve(
                pinned, provisioners, instance_types,
                existing_nodes=base, daemonsets=daemonsets,
                unavailable=unavailable, allow_new_nodes=allow_new_nodes,
                max_new_nodes=budget,
            )
        # a failed what-if keeps the valid incumbent —
        # the packing rung is strictly opportunistic
        except Exception:
            logger.debug("gang %s: co-location what-if for zone %s failed",
                         gid, z, exc_info=True)
            continue
        if sub.infeasible:
            continue
        sub_nodes = list(sub.existing_nodes) + list(sub.nodes)
        by_name = {n.name: n for n in sub_nodes}
        seats = [by_name.get(sub.assignments.get(p.name, "")) for p in members]
        if any(s is None for s in seats):
            continue
        _zs, _cs, new_penalty = _spread(seats)
        freed = sum(
            price for name, price in emptied_price.items()
            if not any(not q.is_daemon
                       for q in (by_name.get(name).pods if by_name.get(name) else ()))
        )
        gain = w * (old_penalty - new_penalty) + freed - sub.new_node_cost
        if gain <= 1e-9:
            continue
        if not in_band(members, sub, instance_types):
            continue
        # the pinned copies must not leak into the result (their synthetic
        # zone selector would over-constrain later what-ifs): seat the
        # ORIGINAL pod objects back in their place
        originals = {p.name: p for p in members}
        for n in sub_nodes:
            n.pods = [originals.get(q.name, q) for q in n.pods]
        placed = list(sub.existing_nodes)  # snapshots of base, seats applied
        result.existing_nodes = placed[:n_existing]
        kept = [
            n for n in placed[n_existing:]
            if any(not q.is_daemon for q in n.pods)
        ]
        result.nodes = kept + list(sub.nodes)
        result.assignments.update(sub.assignments)
        return True
    return False


def run_epilogue(
    result,
    pods: Sequence[PodSpec],
    *,
    registry,
    resolve: Optional[Callable[[Sequence[PodSpec]], object]] = None,
    provisioners=(),
    instance_types=(),
    daemonsets=(),
    unavailable=None,
    allow_new_nodes: bool = True,
    max_new_nodes: Optional[int] = None,
    in_band: Optional[Callable] = None,
    allow_pack: bool = True,
    trace=None,
):
    """The gang epilogue: all-or-nothing enforcement, then co-location
    packing, then metrics.  Runs once per top-level solve, after the
    relax rung (gang groups are relax-ineligible, so their scan seats are
    intact here).  Returns the (possibly re-solved) result.

    ``resolve(keep_pods)`` re-solves the batch without a doomed gang's
    members when an in-place retraction would disturb watched constraint
    accounting; without it the epilogue always retracts in place.
    """
    gangs = gang_members(pods)
    if not gangs:
        return result
    t0 = time.perf_counter()
    batch_names = {p.name for ms in gangs.values() for p in ms}
    doomed: Dict[str, GangUnplaced] = {}

    # all-or-nothing: audit, retract, repeat (a re-solve may doom another
    # gang) — bounded by the gang count
    for _ in range(len(gangs) + 1):
        preseated: Optional[Dict[str, int]] = None
        failed: Dict[str, int] = {}
        for gid, members in gangs.items():
            if gid in doomed:
                continue
            placed = sum(1 for p in members if p.name in result.assignments)
            need = declared_size(members)
            if placed == len(members) and placed >= need:
                continue  # whole gang in-batch, fully seated
            # count comembers seated OUTSIDE the batch (delta/consolidation
            # subproblems solve a gang subset against seated comembers)
            if preseated is None:
                preseated = _preseated_counts(result, batch_names)
            total = placed + preseated.get(gid, 0)
            # any unplaced batch member dooms the gang, no matter how many
            # comembers sit elsewhere — partial is partial
            if placed < len(members) or total < need:
                failed[gid] = total
        if not failed:
            break
        retracting: List[PodSpec] = []
        for gid, seated in failed.items():
            members = gangs[gid]
            doomed[gid] = GangUnplaced(gid, declared_size(members), seated)
            retracting.extend(
                p for p in members if p.name in result.assignments)
        if retracting and _watched(retracting, result) and resolve is not None:
            keep = [p for p in pods if gang_of(p) not in doomed]
            try:
                result = resolve(keep)
            # the re-solve is an optimization of the
            # retraction path; on failure fall back to in-place retraction
            # (still correct, possibly conservative for watchers)
            except Exception:
                logger.warning(
                    "gang retraction re-solve failed; retracting in place",
                    exc_info=True)
                _retract_seats(result, retracting)
        else:
            _retract_seats(result, retracting)
        for gid, reason in doomed.items():
            for p in gangs[gid]:
                result.assignments.pop(p.name, None)
                result.infeasible[p.name] = str(reason)

    # co-location packing + accounting for the survivors
    gang_counter = registry.counter(GANG_GANGS)
    zones_hist = registry.histogram(GANG_SPREAD_ZONES)
    classes_hist = registry.histogram(GANG_SPREAD_CLASSES)
    for gid, members in gangs.items():
        if gid in doomed:
            gang_counter.inc({"outcome": "retracted"})
            continue
        whole_batch = all(p.name in result.assignments for p in members)
        outcome = "placed"
        seats = _gang_nodes(result, members) if whole_batch else None
        if seats is not None:
            n_zones, n_classes, penalty = _spread(seats)
            if (allow_pack and penalty > 0.0 and in_band is not None
                    and len(members) == declared_size(members)):
                if _try_pack(
                    result, gid, members,
                    provisioners=provisioners,
                    instance_types=instance_types,
                    daemonsets=daemonsets, unavailable=unavailable,
                    allow_new_nodes=allow_new_nodes,
                    max_new_nodes=max_new_nodes, in_band=in_band,
                    old_penalty=penalty,
                ):
                    outcome = "packed"
                    seats = _gang_nodes(result, members) or seats
                    n_zones, n_classes, _ = _spread(seats)
            zones_hist.observe(float(n_zones))
            classes_hist.observe(float(n_classes))
        gang_counter.inc({"outcome": outcome})
    registry.histogram(GANG_DURATION).observe(time.perf_counter() - t0)
    if trace is not None:
        trace.annotate(
            gangs=len(gangs), gangs_retracted=len(doomed))
    return result


# ---- delta composition (scheduler.solve_delta) --------------------------

def expand_gang_removals(
    prev, removed: Sequence[str],
) -> Tuple[List[str], Dict[str, str]]:
    """A member removal retracts the gang: expand ``removed`` with every
    seated comember of any gang a removed pod belongs to.  Returns the
    expanded name list plus {comember_name: typed GangUnplaced reason} for
    the members retracted on the gang's behalf (the caller surfaces them
    as unplaced — they were not asked to leave, their gang broke)."""
    if not removed:
        return list(removed), {}
    removed_set = set(removed)
    touched: Set[str] = set()
    roster: Dict[str, List[PodSpec]] = {}
    for n in list(prev.existing_nodes) + list(prev.nodes):
        for q in n.pods:
            gid = gang_of(q)
            if not gid:
                continue
            roster.setdefault(gid, []).append(q)
            if q.name in removed_set:
                touched.add(gid)
    if not touched:
        return list(removed), {}
    out = list(removed)
    retracted: Dict[str, str] = {}
    for gid in sorted(touched):
        members = roster.get(gid, [])
        explicit = sum(1 for q in members if q.name in removed_set)
        reason = str(GangUnplaced(
            gid, declared_size(members), len(members) - explicit))
        for q in members:
            if q.name not in removed_set:
                out.append(q.name)
                retracted[q.name] = reason
    return out, retracted


def delta_needs_full(result, added: Sequence[PodSpec]) -> bool:
    """A gang add must place atomically or fall back to the full solve:
    true when any added gang ended (wholly, post-epilogue) unplaced in the
    delta step's result — the incremental tier could not seat it against
    surviving capacity, so the caller re-solves from the stripped base
    (one more chance before the typed GangUnplaced verdict stands)."""
    for gid, members in gang_members(added).items():
        if any(p.name in result.infeasible for p in members):
            return True
    return False


# ---- consolidation composition -----------------------------------------

def nodes_carry_gangs(nodes: Sequence) -> bool:
    """Whether any of ``nodes`` hosts a gang member — consolidation routes
    such candidates through the serial what-if so the gang epilogue (and
    its typed all-or-nothing verdict) judges the eviction, not the raw
    batched feasibility scan."""
    if not gang_enabled():
        return False
    return any(gang_of(q) for n in nodes for q in n.pods)
