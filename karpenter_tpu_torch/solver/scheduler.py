"""Batch scheduler facade — routes pods to the device solve, the hierarchical
solve, the native C++ tier or the CPU oracle.

The port of the reference package's ``solver/scheduler.py``.
``BatchScheduler.solve`` runs the first wave, the preference-relaxation
ladder, the OR-term waves, the residue waves, the capped-node reseat
epilogue, the convex-relaxation rung (solver/relax.py) and the gang
all-or-nothing epilogue (gang/).  ``_solve_once`` routes a wave to the
oracle (``auto`` batches of at most ``NATIVE_BATCH_LIMIT`` pods, or any
batch with a hard capacity-type spread), to the hierarchical solve
(greenfield batches at/above ``KT_HIER_THRESHOLD``), to the native C++ tier
(``backend="native"``), or to the flat device solve.  Pods the device solve
can't express are carved out and solved by the oracle against the device
result's node set.

Hang protection (solver/guard.py): under ``auto`` every device dispatch and
read runs through :class:`DeviceGuard`.  A call that hangs past
``KT_DEVICE_SOLVE_TIMEOUT_S`` latches the device tier unhealthy; that batch
and every one after it are served from a host tier (``_degraded_fallback``:
native when it can express the batch, else the oracle) until the guard's
probe answers on the scheduler's device.  The forced ``tpu`` backend stays
unguarded.

Serving entry points, under the reference's names: ``submit`` (async
dispatch: the first wave is enqueued and ``result()`` reads it back and
runs the epilogues), ``submit_many`` (the megabatch collector: first device
waves of many requests coalesce into one batched dispatch per bucket,
``bucket_key`` / ``unify_buckets`` for a coalescer), ``solve_delta`` (the
warm-start chain) and the warm API (``warm_startup``,
``precompile_buckets``, ``stop_warms``).  Eager PyTorch compiles nothing,
so the reference's compile-behind workarounds are gone: every signature is
served on the device the first time it is seen, ``served_cold`` stays
False, and a flush that meets a new slot rung is dispatched batched.  The
host tiers serve a batch of the ``auto`` policy only while the device is
latched unhealthy, never for a cold shape.

Not in this port yet: the mesh.
"""

from __future__ import annotations

import copy
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .. import gang as gangmod
from ..device import resolve_device
from ..metrics import (
    MEGABATCH_FLUSH,
    MEGABATCH_FLUSH_REASONS,
    MEGABATCH_SLOTS,
    PRECOMPILE_DURATION,
    SCHEDULING_DURATION,
    SOLVER_BACKEND_DURATION,
    SOLVER_COLD_FALLBACKS,
    SOLVER_COMPILE_DURATION,
    SOLVER_COMPILE_IN_PROGRESS,
    SOLVER_DEGRADED_SOLVES,
    SOLVER_DEVICE_HANGS,
    SOLVER_DEVICE_HEALTHY,
    TENSORIZE_CACHE_HITS,
    TENSORIZE_CACHE_MISSES,
    TENSORIZE_DURATION,
    Registry,
    registry as default_registry,
)
from ..models import labels as L
from ..models.instancetype import InstanceType
from ..models.pod import LabelSelector, PodSpec
from ..models.provisioner import Provisioner
from ..models.tensorize import (
    TensorizeCache,
    batch_needs_oracle,
    device_inexpressible,
    tensorize,
)
from ..obs import tracer_for
from ..obs.trace import NULL_TRACE, Tracer
from .guard import DeviceGuard, DeviceHang
from .reference import solve as oracle_solve
from .tpu import (
    MEGA_MAX_SLOTS,
    TpuSolver,
    mega_key_dims,
    unify_mega_keys,
)
from .types import SimNode, SolveResult

logger = logging.getLogger(__name__)

#: "auto" routes batches of at most this many pods to the CPU oracle
#: (the reference's name: the native tier once served them)
NATIVE_BATCH_LIMIT = 256
#: relaxation-ladder depth cap: at most this many retry waves per solve
MAX_RELAXATION_WAVES = 8
#: residue-convergence depth: still-infeasible pods re-solve against the
#: accumulated placed state until nothing more places (or this many waves)
MAX_RESIDUE_WAVES = 6


def _compile_behind_enabled() -> bool:
    """``KT_COMPILE_BEHIND=0`` turns the background warms off (the
    reference's knob; the port has no cold tier for it to gate)."""
    return os.environ.get("KT_COMPILE_BEHIND", "1") != "0"


def _soft_spreads(pod: PodSpec):
    return [t for t in pod.topology_spread if not t.hard]


def _n_preferences(pod: PodSpec) -> int:
    """Relaxable preferences: preferred node-affinity terms + ScheduleAnyway
    topology spreads (both sit on the same relaxation ladder, like core's
    Preferences — scheduling.md:205-233 + :303-346 ScheduleAnyway)."""
    return len(pod.preferred_affinity_terms) + len(_soft_spreads(pod))


def _harden_preferences(pod: PodSpec, keep: Optional[int] = None) -> PodSpec:
    """Fold the first ``keep`` preferences (all when None) into the hard
    constraint set: preferred affinity terms join the required set,
    ScheduleAnyway spreads become DoNotSchedule.  The ladder drops soft
    spreads first (they sort after affinity terms), then affinity terms
    last-first.  Returns the pod unchanged when it has no preferences."""
    if not pod.preferred_affinity_terms and (
        not pod.topology_spread or all(t.hard for t in pod.topology_spread)
    ):
        return pod  # no preferences (the hot path at scale)

    from ..models.pod import TopologySpreadConstraint

    prefs_aff = pod.preferred_affinity_terms
    soft = _soft_spreads(pod)
    total = len(prefs_aff) + len(soft)
    k = total if keep is None else max(0, keep)
    kept_aff = prefs_aff[: min(k, len(prefs_aff))]
    kept_soft = soft[: max(0, k - len(prefs_aff))]

    out = copy.copy(pod)
    if kept_aff:
        out.required_affinity_terms = [
            list(term) + [r for pt in kept_aff for r in pt]
            for term in (pod.required_affinity_terms or [[]])
        ]
    out.preferred_affinity_terms = []
    out.topology_spread = [t for t in pod.topology_spread if t.hard] + [
        TopologySpreadConstraint(t.max_skew, t.topology_key, "DoNotSchedule",
                                 t.label_selector)
        for t in kept_soft
    ]
    out.__dict__.pop("_group_key", None)  # hardened copy needs its own key
    return out


def _adopt_placed(prev_existing: List[SimNode], sub: SolveResult):
    """Split a wave's placed snapshots back into (existing, prior+new nodes).

    ``sub`` solved against ``prev_existing + <prior new nodes>`` in that
    order and returned its placed copies in ``sub.existing_nodes``; the
    copies replace the prior references so the next wave sees every
    placement so far — capacity bookkeeping chains across waves without
    mutating the caller's node objects.  The ONLY place this split-index
    logic lives; both _merge and _solve_tpu's staging use it."""
    ne = len(prev_existing)
    placed = list(sub.existing_nodes)
    return placed[:ne], placed[ne:] + list(sub.nodes)


def _merge(result: SolveResult, sub: SolveResult) -> None:
    """Fold a retry wave's outcome into ``result`` (shared by the preference
    ladder and the OR-term ladder so their merge semantics cannot diverge)."""
    for name in list(result.infeasible):
        if name in sub.assignments:
            del result.infeasible[name]
    result.infeasible.update(sub.infeasible)
    result.assignments.update(sub.assignments)
    result.existing_nodes, result.nodes = _adopt_placed(result.existing_nodes, sub)
    result.solve_ms += sub.solve_ms
    result.tensorize_ms += sub.tensorize_ms
    result.served_cold = result.served_cold or sub.served_cold


class _PendingWave:
    """A dispatched-but-unread first solver wave; ``finish()`` reads the
    device back and returns the wave's SolveResult.  Internal to the
    scheduler's submit/solve split."""

    __slots__ = ("finish",)

    def __init__(self, finish) -> None:
        self.finish = finish


class PendingScheduleResult:
    """Handle returned by :meth:`BatchScheduler.submit`; ``result()`` blocks
    on the device read-back plus any retry epilogues and is idempotent
    (the first caller runs them, from whichever thread)."""

    __slots__ = ("_finish", "_result", "_lock")

    def __init__(self, finish) -> None:
        self._finish = finish
        self._result: Optional[SolveResult] = None
        self._lock = threading.Lock()

    def result(self) -> SolveResult:
        with self._lock:
            if self._result is None:
                self._result = self._finish()
            return self._result


def _budget_left(result: SolveResult, max_new_nodes: Optional[int]) -> Optional[int]:
    return (None if max_new_nodes is None
            else max(0, max_new_nodes - len(result.nodes)))


class _MegaSlot:
    """One request's slot in a pending megabatch dispatch: ``result()`` is
    valid after the owning collector's ``dispatch()`` ran; the first
    resolver reads the whole group back, and the slot's own exception
    (SlotsExhausted / DeviceHang) is re-raised so the per-request ladder in
    ``_solve_tpu`` stays the single path's."""

    __slots__ = ("_collector", "_idx")

    def __init__(self, collector: "_MegaCollector", idx: int) -> None:
        self._collector = collector
        self._idx = idx

    def result(self):
        return self._collector.resolve(self._idx)


class _MegaCollector:
    """Deferred cross-request device dispatch (``BatchScheduler.submit_many``).

    During the registration phase ``_solve_tpu`` routes each request's first
    device wave here instead of dispatching it; ``dispatch()`` then enqueues
    ONE batched group loop per bucket (``solve_many_async``).  Nothing is
    read back at dispatch: the first ``resolve()`` of a group pays its one
    batch-wide read.  A flush that meets a new slot rung is dispatched
    batched (eager PyTorch has nothing to compile).  With a ``guard`` (the
    ``auto`` policy) every dispatch and read runs through it: a hang fans
    :class:`DeviceHang` to the slots it covers, and each request degrades
    on its own."""

    def __init__(self, solver: TpuSolver, guard=None, registry=None,
                 flush_reason: Optional[str] = None) -> None:
        self.solver = solver
        self.guard = guard
        self.registry = registry
        #: the coalescer's reason for this flush, or None for direct
        #: submit_many callers; when set, the collector owns the flush count
        #: and incs exactly one reason at dispatch
        self.flush_reason = flush_reason
        self.entries: List[dict] = []
        #: per-slot resolver state after dispatch():
        #: ("mega", PendingMegaSolve, pos) | ("single", PendingTpuSolve)
        #: | ("err", Exception)
        self._slots: List[tuple] = []

    def add(self, **entry) -> _MegaSlot:
        self.entries.append(entry)
        return _MegaSlot(self, len(self.entries) - 1)

    def _observe_slots(self, occupied: int) -> None:
        if self.registry is not None:
            self.registry.histogram(MEGABATCH_SLOTS).observe(occupied)

    def _guarded(self, fn):
        return self.guard.run(fn) if self.guard else fn()

    def dispatch(self) -> None:
        self._slots = [None] * len(self.entries)
        sigs: List[tuple] = []
        groups: Dict[tuple, List[int]] = {}
        for i, e in enumerate(self.entries):
            key = self.solver.mega_signature(
                e["st"], existing_nodes=e["existing_nodes"],
                max_nodes=e["max_nodes"], slots=1,
            )
            sigs.append(key)
            groups.setdefault(key, []).append(i)
        # mixed-bucket unification: merge shape buckets whose dims unify
        # (one dominates component-wise — tpu.unify_mega_keys) so the flush
        # shares one dispatch at the dominant bucket's dims; dominated
        # requests pad up via target_dims
        merged: List[list] = []  # [unified_key, idxs, n_source_buckets]
        for key, idxs in groups.items():
            for m in merged:
                u = unify_mega_keys(m[0], key)
                if u is not None:
                    m[0] = u
                    m[1].extend(idxs)
                    m[2] += 1
                    break
            else:
                merged.append([key, list(idxs), 1])
        for ukey, idxs, n_src in merged:
            idxs.sort()  # slot order == arrival order
            if len(idxs) == 1:
                self._dispatch_serial(idxs)
                continue
            reqs = [
                dict(
                    st=self.entries[i]["st"],
                    existing_nodes=self.entries[i]["existing_nodes"],
                    max_nodes=self.entries[i]["max_nodes"],
                    raise_on_exhaust=self.entries[i]["raise_on_exhaust"],
                    trace=self.entries[i]["trace"],
                )
                for i in idxs
            ]
            target = mega_key_dims(ukey) if n_src > 1 else None
            try:
                handle = self._guarded(
                    lambda reqs=reqs, target=target:
                    self.solver.solve_many_async(reqs, target_dims=target))
            except DeviceHang as err:
                # hang at dispatch: fan to every slot — each request's
                # finish degrades to a host tier
                for i in idxs:
                    self._slots[i] = ("err", err)
                continue
            # megabatch CONSTRUCTION failures (a bucket mismatch, stacking
            # errors) degrade the flush to the proven serial path — clients
            # must never fail on an optimization-layer error
            except Exception:  # noqa: BLE001
                logger.warning(
                    "megabatch dispatch failed; serving the flush "
                    "serially", exc_info=True)
                self._dispatch_serial(idxs)
                continue
            self._observe_slots(len(idxs))
            for pos, i in enumerate(idxs):
                self._slots[i] = ("mega", handle, pos)
        if self.flush_reason is not None and self.registry is not None:
            self.registry.counter(MEGABATCH_FLUSH).inc(
                {"reason": self.flush_reason})

    def _dispatch_serial(self, idxs: List[int]) -> None:
        """Per-request async dispatches: still one enqueue per request
        before any read (a lone request, or a degraded flush)."""
        for i in idxs:
            e = self.entries[i]
            self._observe_slots(1)
            try:
                pending = self._guarded(
                    lambda e=e: self.solver.solve_async(
                        e["st"], existing_nodes=e["existing_nodes"],
                        max_nodes=e["max_nodes"],
                        raise_on_exhaust=e["raise_on_exhaust"],
                        trace=e["trace"],
                    ))
            # boxed per-slot outcome, re-raised by the request's own
            # _MegaSlot.result()
            except BaseException as err:  # noqa: BLE001
                self._slots[i] = ("err", err)
                continue
            self._slots[i] = ("single", pending)

    def resolve(self, idx: int):
        """Read back and extract slot ``idx`` (the first resolver of a mega
        group reads the whole group; later ones hit the cached outputs)."""
        state = self._slots[idx]
        if state is None:
            raise RuntimeError("megabatch slot read before dispatch()")
        if state[0] == "err":
            raise state[1]
        if state[0] == "single":
            return self._guarded(state[1].result)
        _kind, handle, pos = state
        outs = self._guarded(handle.results)
        out = outs[pos]
        if isinstance(out, BaseException):
            raise out
        return out


class BatchScheduler:
    """The provisioning solve's entry point.  ``backend`` is ``"auto"``
    (oracle for small batches, device otherwise, host tiers while the
    device is latched unhealthy), ``"tpu"`` (the device solve for every
    batch, unguarded; the name is the reference's), ``"native"`` (the C++
    tier for every device-expressible batch) or ``"oracle"``.
    ``device=None`` is the CUDA card and raises without one; only an
    explicit ``device="cpu"`` runs the device path on the host."""

    #: startup-warm shape profiles: (groups, total_pods, with_zone_spread) —
    #: a provisioning wave of mixed pods, with and without topology spread
    #: (the selector-axis S rung differs between the two)
    WARM_PROFILES = ((16, 400, False), (16, 400, True))

    #: megabatch slot rungs ``precompile_buckets`` warms by default
    WARM_MEGA_SLOTS = (2, 4, 8)

    #: capability probe for a coalescer: this scheduler's submit_many
    #: accepts flush_reason= and owns the MEGABATCH_FLUSH count for it
    counts_flush_reason = True

    def __init__(
        self,
        backend: str = "auto",
        registry: Optional[Registry] = None,
        native_batch_limit: int = NATIVE_BATCH_LIMIT,
        device=None,
        mesh=None,
        compile_behind: Optional[bool] = None,  # None: KT_COMPILE_BEHIND env
        tracer: Optional[Tracer] = None,
    ) -> None:
        if backend not in ("auto", "tpu", "native", "oracle"):
            raise ValueError(f"unknown backend {backend!r}")
        if mesh is not None:
            raise NotImplementedError(
                "the device mesh is not ported to karpenter_tpu_torch yet")
        self.backend = backend
        #: the device mesh the facade contract names (always None: the
        #: port serves one device)
        self.mesh = None
        self.registry = registry or default_registry
        # held for its flight recorder: the hang and degraded-solve anomaly
        # hooks dump there
        self.tracer = (tracer if tracer is not None
                       else tracer_for(self.registry))
        self.native_batch_limit = native_batch_limit
        self.device = resolve_device(device)
        self.compile_behind = (
            _compile_behind_enabled() if compile_behind is None
            else compile_behind)
        self._tpu = TpuSolver(device=self.device)
        # incremental host tensorize: group-level tensors built once per
        # batch shape, reused across solves (KT_TENSORIZE_CACHE=0 forces
        # the from-scratch path, and turns the relax rung off)
        self._tensorize_cache: Optional[TensorizeCache] = (
            TensorizeCache()
            if os.environ.get("KT_TENSORIZE_CACHE", "1") != "0" else None
        )
        for tier in ("identity", "shape"):
            self.registry.counter(TENSORIZE_CACHE_HITS).inc(
                {"tier": tier}, value=0.0)
        self.registry.counter(TENSORIZE_CACHE_MISSES).inc(value=0.0)
        # hang protection for the auto policy's device dispatches: a wedged
        # card degrades the reconcile loop to the host tiers instead of
        # freezing it (solver/guard.py); the probe runs on this scheduler's
        # device.  Forced backends keep direct calls
        self._guard = DeviceGuard(
            on_health_change=self._device_health_changed,
            device=self.device)
        self.registry.gauge(SOLVER_DEVICE_HEALTHY).set(1)
        self.registry.counter(SOLVER_DEVICE_HANGS).inc(value=0.0)
        # both host-tier counters carry a backend label with both reachable
        # values (_cold_solve returns "native" or "oracle"); the cold-start
        # series stay at 0: the port serves every signature on the device
        for fallback_backend in ("native", "oracle"):
            self.registry.counter(SOLVER_DEGRADED_SOLVES).inc(
                {"backend": fallback_backend}, value=0.0)
            self.registry.counter(SOLVER_COLD_FALLBACKS).inc(
                {"backend": fallback_backend}, value=0.0)
        # megabatch collector: non-None only INSIDE submit_many's
        # registration phase — _solve_tpu routes first device waves through
        # it instead of dispatching
        self._mega_collect: Optional[_MegaCollector] = None
        self.registry.histogram(MEGABATCH_SLOTS)
        self.registry.histogram(PRECOMPILE_DURATION)
        for reason in MEGABATCH_FLUSH_REASONS:
            self.registry.counter(MEGABATCH_FLUSH).inc(
                {"reason": reason}, value=0.0)
        from .hierarchy import zero_init_hier_metrics
        from .relax import zero_init_metrics as relax_zero_init
        from .warmstart import zero_init_metrics

        zero_init_metrics(self.registry)
        relax_zero_init(self.registry)
        zero_init_hier_metrics(self.registry)
        # gang outcome series exist before the first ganged batch
        gangmod.zero_init_gang_metrics(self.registry)
        # hierarchical re-entrancy depth: repair solves issued from inside
        # solve_hierarchical must never route hierarchically themselves
        self._hier_depth = 0
        #: stage timings and counts of the last hierarchical solve
        #: (solve_hierarchical's ``stats``)
        self.hier_stats: dict = {}

    def _device_health_changed(self, healthy: bool) -> None:
        self.registry.gauge(SOLVER_DEVICE_HEALTHY).set(1 if healthy else 0)
        if not healthy:
            self.registry.counter(SOLVER_DEVICE_HANGS).inc()

    def solve(
        self,
        pods: Sequence[PodSpec],
        provisioners: Sequence[Provisioner],
        instance_types: Sequence[InstanceType],
        *,
        existing_nodes: Sequence[SimNode] = (),
        daemonsets: Sequence[PodSpec] = (),
        unavailable: Optional[Set[tuple]] = None,
        allow_new_nodes: bool = True,
        max_new_nodes: Optional[int] = None,
        trace=None,
        relax: Optional[bool] = None,
    ) -> SolveResult:
        """Solve with preference relaxation: pods carrying preferences are
        first solved with all preferences hardened; any that come back
        infeasible retry dropping one preference at a time, last first.
        Pods with OR'd required-affinity terms that stay infeasible under
        term[0] retry under each alternate term.  Still-infeasible pods
        then re-solve against the accumulated state (residue waves), and
        nearly-empty capped nodes are re-seated by the oracle when that is
        strictly cheaper.  Large device-tier batches then pass through the
        convex-relaxation rung, which ships min(scan, relax+round):
        ``relax=False`` skips it, ``None`` defers to ``KT_RELAX`` (default
        on).  Last, the gang epilogue holds every gang to all-or-nothing
        and re-packs spread-out gangs (gang.run_epilogue)."""
        return self._submit(
            pods, provisioners, instance_types,
            existing_nodes=existing_nodes, daemonsets=daemonsets,
            unavailable=unavailable, allow_new_nodes=allow_new_nodes,
            max_new_nodes=max_new_nodes, trace=trace, relax=relax,
            # a synchronous caller reads back at once: keep solve() on the
            # synchronous device path
            dispatch=False,
        ).result()

    def submit(
        self,
        pods: Sequence[PodSpec],
        provisioners: Sequence[Provisioner],
        instance_types: Sequence[InstanceType],
        *,
        existing_nodes: Sequence[SimNode] = (),
        daemonsets: Sequence[PodSpec] = (),
        unavailable: Optional[Set[tuple]] = None,
        allow_new_nodes: bool = True,
        max_new_nodes: Optional[int] = None,
        trace=None,
        relax: Optional[bool] = None,
    ) -> PendingScheduleResult:
        """Async entry point for pipelined callers: tensorizes and ENQUEUES
        the first solver wave on the device, then returns a handle whose
        ``result()`` reads it back and runs the (usually zero-iteration)
        relaxation/residue epilogues.  Same result semantics as
        :meth:`solve`.  Not re-entrant: submits and results come from one
        thread, results in submit order."""
        return self._submit(
            pods, provisioners, instance_types,
            existing_nodes=existing_nodes, daemonsets=daemonsets,
            unavailable=unavailable, allow_new_nodes=allow_new_nodes,
            max_new_nodes=max_new_nodes, trace=trace, relax=relax,
            dispatch=True,
        )

    def solve_delta(
        self,
        prev: SolveResult,
        added: Sequence[PodSpec] = (),
        removed: Sequence[str] = (),
        iced: Sequence[object] = (),
        *,
        provisioners: Sequence[Provisioner],
        instance_types: Sequence[InstanceType],
        daemonsets: Sequence[PodSpec] = (),
        unavailable: Optional[Set[tuple]] = None,
        max_delta_frac: Optional[float] = None,
        force_full: bool = False,
        trace=None,
    ):
        """Warm-start delta solve through the full scheduler ladder (see
        solver/warmstart.py): removals and unconstrained adds are host
        bookkeeping; displaced pods that need a real solve go through
        :meth:`solve` seeded with the surviving placements — preference
        relaxation, oracle carve-outs, residue waves and the auto-policy
        routing all apply to the subproblem as they would to a fresh
        batch.  Falls back to a full :meth:`solve` of the whole pod set
        when the perturbation exceeds ``KT_DELTA_MAX_FRAC`` or a coupling
        guard trips.  A gang member's removal retracts its whole gang, and
        a gang add that the incremental tier leaves unplaced falls back to
        the full solve.  Consumes ``prev``; returns a ``DeltaOutcome``."""
        from . import warmstart
        from .relax import relax_delta_enabled

        # the relax rung is a $-for-latency trade the delta path must not
        # pay: displaced-subproblem scans always skip it, and the FULL-solve
        # fallbacks run it only when KT_RELAX_DELTA=1
        def _solve(pods, existing, unavail, relax=False):
            return self.solve(
                pods, provisioners, instance_types,
                existing_nodes=existing, daemonsets=daemonsets,
                unavailable=unavail or None, trace=trace, relax=relax,
            )

        def _solve_full(pods, existing, unavail):
            return self.solve(
                pods, provisioners, instance_types,
                existing_nodes=existing, daemonsets=daemonsets,
                unavailable=unavail or None, trace=trace,
                relax=None if relax_delta_enabled() else False,
            )

        # a member removal retracts the WHOLE gang: seated comembers join
        # the removal set and surface as unplaced with the typed
        # GangUnplaced reason
        gang_retracted: Dict[str, str] = {}
        if gangmod.gang_enabled() and removed:
            removed, gang_retracted = gangmod.expand_gang_removals(
                prev, removed)

        out = warmstart.delta_solve(
            prev, added, removed, iced,
            solve_displaced=_solve, solve_full=_solve_full,
            max_delta_frac=max_delta_frac, registry=self.registry,
            unavailable=unavailable, force_full=force_full,
        )
        # a gang add places atomically or falls back to the FULL solve:
        # when the incremental tier left an added gang (wholly, post-
        # epilogue) unplaced, re-solve everything from the stripped base —
        # one more chance before the typed verdict stands
        if (gangmod.gang_enabled() and out.mode != "full" and added
                and gangmod.delta_needs_full(out.result, added)):
            out = warmstart.delta_solve(
                out.result, (), (), (),
                solve_displaced=_solve, solve_full=_solve_full,
                max_delta_frac=max_delta_frac, registry=self.registry,
                unavailable=unavailable, force_full=True,
            )
        for name, reason in gang_retracted.items():
            out.result.infeasible.setdefault(name, reason)
        return out

    def submit_many(
        self, requests: Sequence[dict],
        flush_reason: Optional[str] = None,
    ) -> List[PendingScheduleResult]:
        """Cross-request megabatch entry (a coalescer's flush): each request
        is a kwargs dict (``pods``, ``provisioners``, ``instance_types``
        plus the :meth:`solve` keywords).  The registration phase runs each
        request's tensorize + routing exactly like :meth:`submit`, but
        first device waves land in a :class:`_MegaCollector` instead of
        dispatching; one batched device dispatch per bucket then solves
        every slot with one read-back.  Returns per-request handles IN
        ORDER — ``result()`` runs that request's own epilogues against its
        own result only.  Same single-thread contract as :meth:`submit`.
        ``flush_reason`` transfers the MEGABATCH_FLUSH count here."""
        guarded = self.backend == "auto" and self._guard.enabled
        collector = _MegaCollector(
            self._tpu, guard=self._guard if guarded else None,
            registry=self.registry, flush_reason=flush_reason)
        self._mega_collect = collector
        try:
            pendings = [
                self._submit(
                    req["pods"], req["provisioners"], req["instance_types"],
                    **{k: v for k, v in req.items()
                       if k not in ("pods", "provisioners", "instance_types",
                                    "relax")},
                    # megabatch slots skip the relax rung: the coalesced
                    # flush is the latency path
                    relax=bool(req.get("relax", False)),
                    dispatch=True,
                )
                for req in requests
            ]
        finally:
            self._mega_collect = None
        collector.dispatch()
        return pendings

    def unify_buckets(self, held_key: tuple,
                      new_key: tuple) -> Optional[tuple]:
        """Mixed-bucket unification hook for a coalescer: the DOMINANT of two
        megabatch bucket keys when one subsumes the other
        (tpu.unify_mega_keys), else None."""
        return unify_mega_keys(held_key, new_key)

    def bucket_key(self, kwargs: dict) -> Optional[tuple]:
        """Megabatch shape bucket of one queued solve request, or None when
        it cannot ride a megabatch (non-device backend, oracle routing,
        device carve-outs, unhealthy device, cache disabled).  Every
        signature is served on the device the first time it is seen, so a
        new shape buckets like a seen one.  Single-thread, like submit: the tensorize it performs
        lands in the cache, so the real solve's tensorize is a hit."""
        if self.backend not in ("auto", "tpu"):
            return None
        if self._tensorize_cache is None:
            return None  # without cached tensorize the probe would pay a
            # full host build per queued request
        pods = list(kwargs.get("pods") or ())
        if not pods or not kwargs.get("allow_new_nodes", True):
            return None
        if self._route_small(len(pods)):
            return None
        try:
            hardened = [_harden_preferences(p) for p in pods]
            if batch_needs_oracle(hardened):
                return None
            if any(device_inexpressible(p) for p in hardened):
                return None  # oracle carve-outs couple waves; keep serial
            if (self.backend == "auto" and self._guard.enabled
                    and not self._guard.healthy):
                return None
            st, _tier = self._tensorize_cache.tensorize(
                hardened, kwargs["provisioners"], kwargs["instance_types"],
                daemonsets=kwargs.get("daemonsets") or (),
                unavailable=kwargs.get("unavailable"),
            )
            existing = list(kwargs.get("existing_nodes") or ())
            max_new = kwargs.get("max_new_nodes")
            new_budget = len(hardened) if max_new is None else max_new
            max_slots = len(existing) + new_budget
            return self._tpu.mega_signature(
                st, existing_nodes=existing, max_nodes=max_slots, slots=1)
        # the bucket probe must never fail a request — an unbucketable
        # request just solves on the single path, where a real error
        # surfaces with full context
        except Exception:
            logger.debug("bucket_key probe failed; request rides the single "
                         "path", exc_info=True)
            return None

    def _submit(
        self,
        pods: Sequence[PodSpec],
        provisioners: Sequence[Provisioner],
        instance_types: Sequence[InstanceType],
        *,
        existing_nodes: Sequence[SimNode] = (),
        daemonsets: Sequence[PodSpec] = (),
        unavailable: Optional[Set[tuple]] = None,
        allow_new_nodes: bool = True,
        max_new_nodes: Optional[int] = None,
        trace=None,
        relax: Optional[bool] = None,
        dispatch: bool = False,
    ) -> PendingScheduleResult:
        t0 = time.perf_counter()
        trace = trace or NULL_TRACE
        trace.annotate(backend=self.backend, n_pods=len(pods))
        hardened = [_harden_preferences(p) for p in pods]
        try:
            # the dispatch span covers tensorize + uploads + enqueue on the
            # async path; on the sync/oracle path the whole first wave
            with trace.span("dispatch", async_dispatch=dispatch):
                first = self._solve_once(
                    hardened, provisioners, instance_types,
                    list(existing_nodes), daemonsets, unavailable,
                    allow_new_nodes, max_new_nodes,
                    dispatch=dispatch, trace=trace,
                )
        except BaseException:
            # a synchronous failure before the finish closure exists must
            # still land in the histogram
            self.registry.histogram(SCHEDULING_DURATION).observe(
                time.perf_counter() - t0)
            raise

        def _finish() -> SolveResult:
            try:
                if isinstance(first, _PendingWave):
                    # the read-back of the async first wave
                    with trace.span("fence"):
                        res0 = first.finish()
                else:
                    res0 = first
                result = self._solve_wave(
                    pods, provisioners, instance_types, list(existing_nodes),
                    daemonsets, unavailable, allow_new_nodes, max_new_nodes,
                    first=res0, trace=trace,
                )
                with trace.span("reseat") as reseat_span:
                    waves = 0
                    # OR'd required-affinity terms beyond the first: the
                    # solvers pack under term[0] only, so still-infeasible
                    # pods retry under each alternate term in order
                    max_terms = max(
                        (len(p.required_affinity_terms) for p in pods),
                        default=0)
                    for k in range(1, max_terms):
                        alts = []
                        for p in pods:
                            if p.name in result.infeasible and len(p.required_affinity_terms) > k:
                                q = copy.copy(p)
                                q.required_affinity_terms = [p.required_affinity_terms[k]]
                                q.__dict__.pop("_group_key", None)
                                alts.append(q)
                        if not alts:
                            break
                        waves += 1
                        _merge(result, self._solve_wave(
                            alts, provisioners, instance_types,
                            list(result.existing_nodes) + result.nodes,
                            daemonsets, unavailable, allow_new_nodes,
                            _budget_left(result, max_new_nodes), trace=trace,
                        ))

                    # residue convergence: re-offer the still-infeasible
                    # pods the state every prior wave produced, until a
                    # wave places nothing new
                    for _ in range(MAX_RESIDUE_WAVES):
                        retry = [p for p in pods if p.name in result.infeasible]
                        if not retry:
                            break
                        sub = self._solve_wave(
                            retry, provisioners, instance_types,
                            list(result.existing_nodes) + result.nodes,
                            daemonsets, unavailable, allow_new_nodes,
                            _budget_left(result, max_new_nodes), trace=trace,
                        )
                        if not sub.assignments:
                            break  # no progress: the residue is genuinely infeasible
                        waves += 1
                        _merge(result, sub)
                    # ct-spread batches are already fully oracle-
                    # interleaved; the reseat epilogue buys nothing there
                    if not batch_needs_oracle(hardened):
                        self._reseat_capped(
                            result, provisioners, instance_types, daemonsets,
                            unavailable, n_pods=len(pods),
                            max_new_nodes=max_new_nodes,
                        )
                    reseat_span.annotate(repair_waves=waves)
                # convex-relaxation refinement rung (solver/relax.py):
                # re-pack the large unconstrained groups globally and ship
                # min(scan, relax+round) — never worse by construction
                result = self._maybe_relax(
                    result, hardened, provisioners, instance_types,
                    daemonsets, unavailable, allow_new_nodes, max_new_nodes,
                    relax, trace,
                )
                # gang all-or-nothing + co-location epilogue (gang/): after
                # the relax rung — gang groups are relax-ineligible, so
                # their scan seats are fixed by the time the epilogue
                # audits, retracts and packs them
                if gangmod.gang_enabled() and gangmod.has_gangs(pods):
                    with trace.span("gang") as gang_span:
                        result = gangmod.run_epilogue(
                            result, pods,
                            registry=self.registry,
                            # a retraction that would disturb watched
                            # spread/affinity accounting re-solves the
                            # keep-set from the pristine existing nodes
                            resolve=lambda keep: self._solve_wave(
                                keep, provisioners, instance_types,
                                list(existing_nodes), daemonsets, unavailable,
                                allow_new_nodes, max_new_nodes, trace=trace),
                            provisioners=provisioners,
                            instance_types=instance_types,
                            daemonsets=daemonsets,
                            unavailable=unavailable,
                            allow_new_nodes=allow_new_nodes,
                            max_new_nodes=max_new_nodes,
                            in_band=self._reseat_in_band,
                            trace=gang_span,
                        )
                trace.annotate(
                    served_cold=result.served_cold,
                    n_nodes=len(result.nodes),
                    n_infeasible=len(result.infeasible),
                    cost=round(result.new_node_cost, 4),
                    solve_ms=round(result.solve_ms, 3),
                )
                return result
            finally:
                self.registry.histogram(SCHEDULING_DURATION).observe(
                    time.perf_counter() - t0)

        return PendingScheduleResult(_finish)

    # ---- the warm API -----------------------------------------------------
    def _profile_tensors(self, provisioners, instance_types, daemonsets,
                         profiles=None):
        """Tensorized startup-warm batches, one per shape profile — the
        single source :meth:`warm_startup` (single-solve shapes) and
        :meth:`precompile_buckets` (megabatch rungs) both warm from."""
        from ..models.pod import TopologySpreadConstraint

        out = []
        for groups, total, spread in (profiles or self.WARM_PROFILES):
            pods = []
            per = max(1, total // groups)
            for gi in range(groups):
                sel = LabelSelector.of({"warmup-group": f"g{gi}"})
                constraints = (
                    [TopologySpreadConstraint(1, L.ZONE, "DoNotSchedule", sel)]
                    if spread else []
                )
                for i in range(per):
                    pods.append(PodSpec(
                        name=f"warmup-g{gi}-{i}",
                        labels={"warmup-group": f"g{gi}"},
                        requests={"cpu": 0.25 * (1 + gi % 8),
                                  "memory": float(2 ** (30 + gi % 3))},
                        topology_spread=list(constraints),
                        owner_key=f"warmup-g{gi}",
                    ))
            out.append(tensorize(pods, provisioners, instance_types,
                                 daemonsets=daemonsets))
        return out

    def warm_startup(
        self,
        provisioners,
        instance_types,
        daemonsets: Sequence[PodSpec] = (),
        existing_nodes: Sequence[SimNode] = (),
        profiles=None,
    ) -> int:
        """Run the startup shape ladder on background threads against the
        live catalog, provisioners and CLUSTER SIZE: ``existing_nodes``
        (snapshots) set the NE/NR rungs, so the shapes warmed are the ones
        the provisioning and consolidation solves will hit.  Returns the
        number of warms accepted; cheap to call again (signatures dedupe).
        The relax rung's warm comes with the serving layer.  Nothing is
        warmed while the device is latched unhealthy (a warm against a
        wedged card would hang its thread too)."""
        if (self.backend not in ("auto", "tpu") or not self.compile_behind
                or not self._guard.healthy):
            return 0
        started = 0
        for st in self._profile_tensors(provisioners, instance_types,
                                        daemonsets, profiles):
            # provisioning shape: batch solved against the current cluster
            if self._tpu.warm_async(st, existing_nodes=existing_nodes,
                                    on_done=self._warm_done):
                started += 1
            if existing_nodes:
                # consolidation what-if shape: a small repack against the
                # cluster with at most one new node
                if self._tpu.warm_async(
                    st, existing_nodes=existing_nodes,
                    max_nodes=len(existing_nodes) + 1,
                    on_done=self._warm_done,
                ):
                    started += 1
        if started:
            self.registry.gauge(SOLVER_COMPILE_IN_PROGRESS).set(
                self._tpu.compiles_in_flight())
            logger.info("startup warmup: %d solver shape warms accepted in "
                        "the background", started)
        return started

    def precompile_buckets(
        self,
        provisioners,
        instance_types,
        daemonsets: Sequence[PodSpec] = (),
        existing_nodes: Sequence[SimNode] = (),
        profiles=None,
        mega_slots: Optional[Sequence[int]] = None,
        wait: bool = False,
        timeout: float = 1800.0,
    ) -> int:
        """The bucket grid ahead of traffic: the startup single-solve ladder
        (:meth:`warm_startup`) PLUS one megabatch solve at each given slot
        rung, so both the serial and the coalesced serving paths have run
        (and primed the caching allocator) before the first request.
        ``wait=True`` blocks until every accepted warm lands and observes
        the total in ``karpenter_solver_precompile_duration_seconds``.
        Returns the number of warms accepted."""
        t0 = time.perf_counter()
        started = self.warm_startup(
            provisioners, instance_types, daemonsets=daemonsets,
            existing_nodes=existing_nodes, profiles=profiles,
        )
        if (self.backend in ("auto", "tpu") and self.compile_behind
                and self._guard.healthy):
            rungs = sorted({
                s for s in (mega_slots or self.WARM_MEGA_SLOTS)
                if 2 <= s <= MEGA_MAX_SLOTS
            })
            for st in self._profile_tensors(provisioners, instance_types,
                                            daemonsets, profiles):
                for s in rungs:
                    if self._tpu.warm_async(
                        st, existing_nodes=existing_nodes, slots=s,
                        on_done=self._warm_done,
                    ):
                        started += 1
        if wait and started:
            deadline = time.perf_counter() + timeout
            while (not self._tpu.warm_idle()
                   and time.perf_counter() < deadline):
                time.sleep(0.05)
            self.registry.histogram(PRECOMPILE_DURATION).observe(
                time.perf_counter() - t0)
            if not self._tpu.warm_idle():
                logger.warning("bucket precompile still running after %.0fs "
                               "wait budget; remaining warms finish behind",
                               timeout)
            else:
                logger.info("bucket precompile complete: %d warms in %.1fs",
                            started, time.perf_counter() - t0)
        return started

    def stop_warms(self) -> None:
        """Stop background warms (shutdown): queued warms are dropped; exit
        waits only for the warms already running.  Also stops the device
        guard's recovery probe."""
        self._tpu.stop_warms()
        self._guard.stop()

    def _warm_done(self, sig, seconds: float, err) -> None:
        # runs BEFORE the warm thread clears its own in-flight entry (so
        # watchers polling compiles_in_flight() down to 0 never miss these
        # metrics); exclude the finishing warm from the gauge
        self.registry.gauge(SOLVER_COMPILE_IN_PROGRESS).set(
            max(0, self._tpu.compiles_in_flight() - 1))
        if err is not None:
            # failed warms stay out of the duration histogram; TpuSolver
            # arms a per-signature retry backoff
            logger.warning("background solver warm failed after %.1fs: %r",
                           seconds, err)
        else:
            self.registry.histogram(SOLVER_COMPILE_DURATION).observe(seconds)
            logger.info("solver shape warmed in background (%.1fs)", seconds)

    def _reseat_capped(
        self, result: SolveResult, provisioners, instance_types, daemonsets,
        unavailable, *, n_pods: int, max_new_nodes: Optional[int] = None,
    ) -> None:
        """Cost-decreasing epilogue for nearly-empty residue nodes: the scan
        solver places group-at-a-time, so a group tail (or a per-node-capped
        group — hostname anti-affinity, spread caps) can buy dedicated
        near-empty nodes where the oracle's pod-interleaved first-fit seats
        the same pods on other groups' open capacity, or serves them from a
        cheaper right-sized node (fuzz seed 5: 7 single-pod m5.large at
        +3.3%; kubelet seed 20: a zone-spread band-top orphan riding a
        2xlarge it shares with one hostname-spread pod, where re-solving
        seats the orphan on another zone's slack and downsizes the node).
        Take the new nodes holding at most two pods, re-solve exactly those
        pods with the oracle against everything else placed, and adopt the
        answer only when every pod still places AND it is strictly cheaper —
        quality can only improve by construction.  Device backends only —
        the oracle backend (and auto's oracle-served small batches) already
        interleave."""
        if (self.backend == "oracle" or self._route_small(n_pods)
                or not result.nodes):
            return

        def _capped(p: PodSpec) -> bool:
            # per-node CAPS: hostname anti-affinity and hard hostname spread
            # — the shapes whose reseat wins are structural (they build
            # single-pod fleets with backfillable slack)
            return any(
                t.anti and t.topology_key == L.HOSTNAME
                for t in p.affinity_terms
            ) or any(
                t.hard and t.topology_key == L.HOSTNAME
                for t in p.topology_spread
            )

        waste = [n for n in result.nodes if n.pods and len(n.pods) <= 2]
        # bounded epilogue: a batch whose pods are node-sized (1-2 per node
        # by design) would otherwise re-solve nearly everything through the
        # sequential oracle and erase the device speedup.  Trim to a 64-pod
        # re-solve budget, keeping capped fleets first (the structural wins)
        # then the most expensive residue — never skip wholesale
        if sum(len(n.pods) for n in waste) > 64:
            waste.sort(key=lambda n: (
                0 if all(_capped(p) for p in n.pods) else 1, -n.price, n.name))
            trimmed, tot = [], 0
            for n in waste:
                if tot + len(n.pods) > 64:
                    continue  # overfull node; later smaller ones may still fit
                trimmed.append(n)
                tot += len(n.pods)
            waste = trimmed
        if not waste:
            return
        waste_ids = {id(n) for n in waste}
        waste_pods = [p for n in waste for p in n.pods]
        keep = [n for n in result.nodes if id(n) not in waste_ids]
        others = list(result.existing_nodes) + keep
        # fast screen before paying a sequential oracle solve on EVERY batch
        # whose pod count isn't a multiple of node capacity (almost all):
        # a win requires either free room for a waste pod somewhere else
        # (resource-only — caps/zones may still block, the oracle decides)
        # or a waste node that isn't the cheapest catalog way to host its
        # own pods.  A routine right-sized tail node fails both and skips.
        if not self._reseat_plausible(waste, others, instance_types):
            return
        # honor the caller's new-node budget: the epilogue may only spend
        # what the waste nodes gave back (max_new_nodes=1 what-ifs must not
        # come back with 2 replacements)
        budget = (None if max_new_nodes is None
                  else max(0, max_new_nodes - len(keep)))
        re = oracle_solve(
            waste_pods, provisioners, instance_types,
            existing_nodes=others, daemonsets=daemonsets,
            unavailable=unavailable, allow_new_nodes=True,
            max_new_nodes=budget,
        )
        old_cost = sum(n.price for n in waste)
        if re.infeasible or re.new_node_cost >= old_cost - 1e-9:
            return
        if not self._reseat_in_band(waste_pods, re, instance_types):
            return
        placed = list(re.existing_nodes)  # snapshots of others, pods seated
        ne = len(result.existing_nodes)
        result.existing_nodes = placed[:ne]
        result.nodes = placed[ne:] + list(re.nodes)
        result.assignments.update(re.assignments)

    @staticmethod
    def _reseat_plausible(waste, others, instance_types) -> bool:
        """Cheap necessary condition for a reseat win: some waste pod has
        resource-level room on another placed node (absorption might be
        possible), or some waste node is priced above the cheapest catalog
        type that fits its pods (downsizing might be possible)."""
        for n in waste:
            for p in n.pods:
                req = dict(p.requests)
                req.setdefault(L.RESOURCE_PODS, 1.0)
                for o in others:
                    rem = o.remaining()
                    if all(rem.get(k, 0.0) >= v - 1e-9 for k, v in req.items()):
                        return True
        for n in waste:
            total: Dict[str, float] = {}
            for p in n.pods:
                for k, v in p.requests.items():
                    total[k] = total.get(k, 0.0) + v
            total[L.RESOURCE_PODS] = float(len(n.pods))
            for it in instance_types:
                if not all(it.allocatable.get(k, 0.0) >= v - 1e-9
                           for k, v in total.items()):
                    continue
                cheapest = min(
                    (o.price for o in it.offerings if o.available),
                    default=None,
                )
                if cheapest is not None and cheapest < n.price - 1e-9:
                    return True
        return False

    @staticmethod
    def _reseat_in_band(moved, re, instance_types) -> bool:
        """Global zone-spread check on a reseat adoption candidate.

        The oracle's incremental band check (`counts[z]+1-min <= skew`)
        assumes an IN-BAND starting state; removing the waste nodes can hand
        it a mid-band hole it then legally over-fills from (fuzz seed 17:
        removing four 2-pod zone-1b nodes left {11,1,8}; per-placement-legal
        refilling ended {11,7,10} — skew 4 over a 3 band).  Re-check every
        moved pod's hard zone spread GLOBALLY over its eligible zones and
        reject the adoption on any violation — the pre-reseat result was
        valid, so rejecting preserves validity."""
        # spec key mirrors the ground-truth validator: same selector + skew
        # but different node pins are DIFFERENT spread groups with different
        # eligible-zone sets — deduping on (selector, skew) alone would let
        # a zone-pinned pod (trivially in band over its one zone) mask an
        # unpinned group's violation.  Specs come from EVERY pod in the
        # adoption candidate whose selector matches a moved pod, not just
        # the moved pods' own constraints — a kept group's spread counts
        # the moved pod too (the oracle's observe() matches by selector,
        # regardless of which pod carries the constraint)
        nodes = list(re.existing_nodes) + list(re.nodes)
        moved_labels = [p.labels for p in moved]
        specs = {}
        for n in nodes:
            for q in n.pods:
                for tsc in q.topology_spread:
                    if not (tsc.hard and tsc.topology_key == L.ZONE):
                        continue
                    if not any(tsc.label_selector.matches(lb)
                               for lb in moved_labels):
                        continue
                    key = (tsc.label_selector, tsc.max_skew,
                           tuple(sorted(q.node_selector.items())),
                           tuple(q.volume_zone_requirements))
                    specs.setdefault(key, (tsc, q))
        if specs:
            all_zones: List[str] = []
            for it in instance_types:
                for o in it.offerings:
                    if o.zone not in all_zones:
                        all_zones.append(o.zone)
            for tsc, rep in specs.values():
                eligible = [
                    z for z in all_zones
                    if rep.node_selector.get(L.ZONE, z) == z
                    and all(r.value_set().contains(z)
                            for r in rep.volume_zone_requirements)
                ]
                if not eligible:
                    continue
                counts = {z: 0 for z in eligible}
                for n in nodes:
                    if n.zone in counts:
                        counts[n.zone] += sum(
                            1 for q in n.pods
                            if tsc.label_selector.matches(q.labels)
                        )
                if max(counts.values()) - min(counts.values()) > tsc.max_skew:
                    return False
        # hostname anti-affinity is enforced by the oracle only for the
        # INCOMING pod's own terms; a moved pod with no terms could land
        # beside a kept pod whose anti selector matches it.  Re-check every
        # node that received a moved pod bidirectionally (the validator's
        # rule: a pod's hostname-anti term may match at most one co-located
        # pod — itself)
        moved_names = {p.name for p in moved}
        for n in nodes:
            if not any(q.name in moved_names for q in n.pods):
                continue
            for q in n.pods:
                for term in q.affinity_terms:
                    if term.anti and term.topology_key == L.HOSTNAME:
                        matches = sum(
                            1 for r in n.pods
                            if term.label_selector.matches(r.labels)
                        )
                        if matches > 1:
                            return False
        # same bidirectional rule at zone scope: any pod in a zone that
        # received a moved pod may carry a zone anti-affinity term the
        # moved pod violates (at most one matching pod — itself — in the
        # zone)
        moved_zones = {n.zone for n in nodes
                       if any(q.name in moved_names for q in n.pods)}
        for z in moved_zones:
            zone_pods = [q for n in nodes if n.zone == z for q in n.pods]
            for q in zone_pods:
                for term in q.affinity_terms:
                    if term.anti and term.topology_key == L.ZONE:
                        matches = sum(
                            1 for r in zone_pods
                            if term.label_selector.matches(r.labels)
                        )
                        allowed = 1 if term.label_selector.matches(q.labels) else 0
                        if matches > allowed:
                            return False
        # kept pods' POSITIVE zone-affinity toward moved pods: a kept pod
        # whose only selector-matching zone-mate was a moved pod is orphaned
        # when the reseat moves that pod to another zone.  Conservative
        # global re-check (rejecting keeps the valid pre-reseat result):
        # every pod carrying a positive zone term whose selector matches any
        # moved pod must still have a matching pod in its own zone — itself
        # only when no matcher exists anywhere else (the mode-B seed shape).
        for n in nodes:
            for q in n.pods:
                for term in q.affinity_terms:
                    if term.anti or term.topology_key != L.ZONE:
                        continue
                    if not any(term.label_selector.matches(lb)
                               for lb in moved_labels):
                        continue  # the reseat moved nothing this term matches
                    if any(term.label_selector.matches(r.labels)
                           for nn in nodes if nn.zone == n.zone
                           for r in nn.pods if r.name != q.name):
                        continue
                    if term.label_selector.matches(q.labels) and not any(
                        term.label_selector.matches(r.labels)
                        for nn in nodes if nn.zone != n.zone
                        for r in nn.pods
                    ):
                        continue  # sole matcher anywhere: valid self-seed
                    return False
        # hard hostname spread on nodes that RECEIVED a moved pod: the
        # oracle enforces the incoming pod's own constraints only, so a
        # moved pod landing beside a kept spread-bearing pod can push that
        # node's matching count past the band (per-node cap is maxSkew —
        # an empty node keeps the global hostname minimum at 0)
        for n in nodes:
            if not any(q.name in moved_names for q in n.pods):
                continue
            for q in n.pods:
                for tsc in q.topology_spread:
                    if not (tsc.hard and tsc.topology_key == L.HOSTNAME):
                        continue
                    matches = sum(1 for r in n.pods
                                  if tsc.label_selector.matches(r.labels))
                    if matches > tsc.max_skew:
                        return False
        return True

    def _maybe_relax(
        self, result: SolveResult, hardened, provisioners, instance_types,
        daemonsets, unavailable, allow_new_nodes,
        max_new_nodes: Optional[int], relax: Optional[bool], trace,
    ) -> SolveResult:
        """Route a finished device-tier solve through the convex-relaxation
        rung (solver/relax.py) and ship min(scan, relax+round).

        ``relax`` is the caller's policy: False skips unconditionally,
        None defers to ``KT_RELAX`` (default on).  The rung refines only
        device-scan results — oracle-routed small / ct-spread batches and
        the oracle backend return untouched and uncounted (the outcome
        counter partitions rung evaluations, not solves) — and only
        unbudgeted provisioning solves: consolidation what-ifs
        (``max_new_nodes`` / ``allow_new_nodes``) are judged on
        feasibility at a fixed budget, not on node cost.  The program runs
        on the scheduler's device; the port compiles nothing, so the first
        solve of a shape runs the rung."""
        from . import relax as relax_mod

        if relax is False or not relax_mod.relax_enabled():
            return result
        if self.backend not in ("auto", "tpu"):
            return result  # the rung refines the device scan only
        if not allow_new_nodes or max_new_nodes is not None:
            return result
        tpu_pods = [p for p in hardened if not device_inexpressible(p)]
        if (not tpu_pods or len(tpu_pods) <= self.native_batch_limit
                or batch_needs_oracle(hardened)):
            # small batches are oracle-grade already (and under auto the
            # oracle served them — no scan to refine)
            return result
        if self._tensorize_cache is None:
            return result  # without cached tensorize the probe would pay
            # a full host build per solve — not the rung's trade
        guarded = self.backend == "auto" and self._guard.enabled
        if result.served_cold or (guarded and not self._guard.healthy):
            relax_mod.record_outcome(self.registry, "skipped")
            return result
        try:
            # identity-tier hit: these are the same pod objects the solve
            # wave tensorized moments ago
            st, _tsec = self._tensorize(
                tpu_pods, provisioners, instance_types, daemonsets,
                unavailable, trace=trace)

            def _repair(stranded, seeds):
                # integrality repair: the scan, seeded from the rounded
                # fleet as existing-node state; never re-enters the rung
                return self.solve(
                    stranded, provisioners, instance_types,
                    existing_nodes=seeds, daemonsets=daemonsets,
                    unavailable=unavailable, allow_new_nodes=True,
                    relax=False, trace=trace)

            result, _outcome = relax_mod.refine(
                result, st, registry=self.registry, trace=trace,
                repair_solve=_repair, device=self.device)
            return result
        # the rung is an optimization layer — any routing failure ships
        # the proven scan solution as a fallback
        except Exception:
            logger.warning("relax rung routing failed; scan solution ships",
                           exc_info=True)
            relax_mod.record_outcome(self.registry, "fallback")
            return result

    def _solve_wave(
        self, pods, provisioners, instance_types, existing_nodes, daemonsets,
        unavailable, allow_new_nodes, max_new_nodes, first=None,
        trace=None,
    ) -> SolveResult:
        """One pod wave with the preference-relaxation ladder applied.
        ``first`` short-circuits the all-preferences-hardened opening solve
        when the caller already ran it."""
        result = first if first is not None else self._solve_once(
            [_harden_preferences(p) for p in pods], provisioners,
            instance_types, existing_nodes, daemonsets, unavailable,
            allow_new_nodes, max_new_nodes, trace=trace,
        )
        max_pref = min(
            max((_n_preferences(p) for p in pods), default=0),
            MAX_RELAXATION_WAVES,
        )
        for keep in range(max_pref - 1, -1, -1):
            retry = [p for p in pods if p.name in result.infeasible
                     and _n_preferences(p) > keep]
            if not retry:
                continue
            _merge(result, self._solve_once(
                [_harden_preferences(p, keep) for p in retry],
                provisioners, instance_types,
                list(result.existing_nodes) + result.nodes, daemonsets,
                unavailable, allow_new_nodes,
                _budget_left(result, max_new_nodes), trace=trace,
            ))
        return result

    def _solve_once(
        self, pods, provisioners, instance_types, existing_nodes, daemonsets,
        unavailable, allow_new_nodes, max_new_nodes, dispatch=False,
        trace=None,
    ):
        """One wave, routed.  Returns a SolveResult — or, with ``dispatch``
        on the plain flat device path, a :class:`_PendingWave` (the oracle,
        hierarchical and carve-out-first routes return a finished
        result)."""
        # a hard capacity-type spread couples the whole batch to the
        # sequential engine (batch_needs_oracle) — every backend
        if (self.backend == "oracle" or self._route_small(len(pods))
                or batch_needs_oracle(pods)):
            t0 = time.perf_counter()
            try:
                return oracle_solve(
                    pods, provisioners, instance_types,
                    existing_nodes=existing_nodes, daemonsets=daemonsets,
                    unavailable=unavailable, allow_new_nodes=allow_new_nodes,
                    max_new_nodes=max_new_nodes,
                )
            finally:
                self.registry.histogram(SOLVER_BACKEND_DURATION).observe(
                    time.perf_counter() - t0, {"backend": "oracle"}
                )
        if self._route_hier(pods, existing_nodes, allow_new_nodes,
                            max_new_nodes):
            from .hierarchy import solve_hierarchical

            self.hier_stats = {}
            result = solve_hierarchical(
                self, pods, provisioners, instance_types,
                daemonsets=daemonsets, unavailable=unavailable, trace=trace,
                stats=self.hier_stats,
            )
            if result is not None:
                return result
            # None = one coupled component: flat is the right program
        return self._solve_tpu(
            pods, provisioners, instance_types, existing_nodes, daemonsets,
            unavailable, allow_new_nodes, max_new_nodes, dispatch=dispatch,
            trace=trace,
        )

    def _route_small(self, n_pods: int) -> bool:
        """auto-policy: batches of at most ``native_batch_limit`` pods are
        served by the sequential CPU oracle (exact-parity FFD at ms
        latency for any constraint shape)."""
        return self.backend == "auto" and n_pods <= self.native_batch_limit

    def _route_hier(self, pods, existing_nodes, allow_new_nodes,
                    max_new_nodes) -> bool:
        """Hierarchical routing gate: block decomposition at/above
        ``KT_HIER_THRESHOLD`` pods — greenfield batches only (no existing
        nodes, unbounded budget), on a healthy device tier, with no
        device-inexpressible pods, and never from inside a hierarchical
        repair."""
        from .hierarchy import hier_threshold

        thr = hier_threshold()
        return (
            thr > 0
            and not self._hier_depth
            and self.backend in ("auto", "tpu")
            and len(pods) >= thr
            and not existing_nodes
            and allow_new_nodes
            and max_new_nodes is None
            and self._guard.healthy
            and not any(device_inexpressible(p) for p in pods)
        )

    def _route_native(self, st, n_pods: int) -> bool:
        """Forced native backend only: the ``auto`` policy serves small
        batches from the oracle and large ones from the device; the native
        tier serves ``auto`` batches only while the device is latched
        unhealthy (:meth:`_cold_solve`)."""
        return self.backend == "native"

    def _cold_solve(
        self, st, tpu_pods, provisioners, instance_types, all_existing,
        daemonsets, unavailable, allow_new_nodes, max_slots, max_new_nodes,
    ):
        """Serve a batch from a host tier (the reference's name): the native
        C++ tier when it can express the batch, else the CPU oracle.  The
        port reaches it only as the degraded tier."""
        from . import native as native_mod

        if native_mod.available() and not native_mod.has_topology(st):
            res = native_mod.solve_tensors_native(
                st, existing_nodes=all_existing, max_nodes=max_slots,
            )
            return res, "native"
        res = oracle_solve(
            tpu_pods, provisioners, instance_types,
            existing_nodes=all_existing, daemonsets=daemonsets,
            unavailable=unavailable, allow_new_nodes=allow_new_nodes,
            max_new_nodes=max_new_nodes,
        )
        return res, "oracle"

    def _flight_anomaly(self, reason: str, detail: str, trace) -> None:
        """Hand an anomaly (hang-guard trip, degraded solve) to the flight
        recorder with the in-flight trace, so the dump explains THIS solve.
        Best-effort: a failure to record must never fail the solve the host
        tier is about to serve."""
        try:
            flight = getattr(self.tracer, "flight", None)
            if flight is not None:
                flight.anomaly(reason, detail=detail,
                               trace=trace if trace else None)
        except Exception:  # noqa: BLE001 — observability must not fail solves
            logger.warning("flight-recorder anomaly dump failed (%s)",
                           reason, exc_info=True)

    def _tensorize(self, pods, provisioners, instance_types, daemonsets,
                   unavailable, trace=NULL_TRACE) -> Tuple["object", float]:
        """Host tensorize through the incremental cache (steady state: a
        lookup plus a counts vector — models/tensorize.TensorizeCache).
        Returns (tensors, seconds spent)."""
        t0 = time.perf_counter()
        with trace.span("tensorize") as span:
            if self._tensorize_cache is not None:
                st, tier = self._tensorize_cache.tensorize(
                    pods, provisioners, instance_types,
                    daemonsets=daemonsets, unavailable=unavailable)
            else:
                st = tensorize(pods, provisioners, instance_types,
                               daemonsets=daemonsets, unavailable=unavailable)
                tier = "off"
            span.annotate(tier=tier)
        dt = time.perf_counter() - t0
        self.registry.histogram(TENSORIZE_DURATION).observe(dt)
        if tier in ("identity", "shape"):
            self.registry.counter(TENSORIZE_CACHE_HITS).inc({"tier": tier})
        elif tier == "miss":
            self.registry.counter(TENSORIZE_CACHE_MISSES).inc()
        return st, dt

    def _solve_tpu(
        self, pods, provisioners, instance_types, existing_nodes, daemonsets,
        unavailable, allow_new_nodes, max_new_nodes, dispatch=False,
        trace=None,
    ):
        """Device-tier wave with the oracle carve-out for pods the device
        solve can't express.  Returns a SolveResult — or, when
        ``dispatch`` is set and the batch has no oracle carve-outs, a
        :class:`_PendingWave` whose ``finish`` reads the async dispatch
        back (inside ``submit_many``'s registration, the wave joins the
        megabatch collector instead of dispatching).  ``backend="native"``
        serves the wave from the C++ tier; under ``auto`` every device
        call runs through the hang guard, and a hang or an unhealthy
        device serves the wave from a host tier (``_degraded_fallback``)."""
        trace = trace or NULL_TRACE
        tpu_pods = [p for p in pods if not device_inexpressible(p)]
        cpu_pods = [p for p in pods if device_inexpressible(p)]

        # positive affinity couples the two batches: whichever side's
        # affinity selectors match the other side's pods must solve SECOND
        def _refers(src, dst):
            sels = [t.label_selector for p in src for t in p.affinity_terms
                    if not t.anti]
            return any(s.matches(q.labels) for s in sels for q in dst)

        cpu_first = bool(cpu_pods and tpu_pods
                         and _refers(tpu_pods, cpu_pods)
                         and not _refers(cpu_pods, tpu_pods))

        # placed-snapshot chaining: each stage solves against the previous
        # stage's PLACED existing snapshots (+ placed prior new nodes)
        cur_existing: List[SimNode] = list(existing_nodes)
        nodes: List[SimNode] = []
        assignments: Dict[str, str] = {}
        infeasible: Dict[str, str] = {}
        solve_ms = 0.0
        tensorize_ms = 0.0

        def chain(res: SolveResult) -> None:
            nonlocal cur_existing, nodes
            cur_existing, nodes = _adopt_placed(cur_existing, res)

        if cpu_first:
            res0 = oracle_solve(
                cpu_pods, provisioners, instance_types,
                existing_nodes=cur_existing, daemonsets=daemonsets,
                unavailable=unavailable, allow_new_nodes=allow_new_nodes,
                max_new_nodes=max_new_nodes,
            )
            chain(res0)
            assignments.update(res0.assignments)
            infeasible.update(res0.infeasible)
            solve_ms += res0.solve_ms
            cpu_pods = []
            if max_new_nodes is not None:
                max_new_nodes = max(0, max_new_nodes - len(res0.nodes))

        def _tail() -> SolveResult:
            """cpu-carve-out epilogue + result assembly — shared by the
            synchronous return and the async wave's finish."""
            nonlocal solve_ms
            if cpu_pods:
                t0c = time.perf_counter()
                res2 = oracle_solve(
                    cpu_pods, provisioners, instance_types,
                    existing_nodes=list(cur_existing) + nodes,
                    daemonsets=daemonsets, unavailable=unavailable,
                    allow_new_nodes=allow_new_nodes,
                    max_new_nodes=None if max_new_nodes is None else max(0, max_new_nodes - len(nodes)),
                )
                self.registry.histogram(SOLVER_BACKEND_DURATION).observe(
                    time.perf_counter() - t0c, {"backend": "oracle"}
                )
                chain(res2)
                assignments.update(res2.assignments)
                infeasible.update(res2.infeasible)
                solve_ms += res2.solve_ms
            return SolveResult(
                nodes=nodes,
                assignments=assignments,
                infeasible=infeasible,
                existing_nodes=cur_existing,
                solve_ms=solve_ms,
                tensorize_ms=tensorize_ms,
            )

        if not tpu_pods:
            return _tail()

        st, tsec = self._tensorize(
            tpu_pods, provisioners, instance_types, daemonsets, unavailable,
            trace=trace)
        tensorize_ms += tsec * 1000.0
        t0 = time.perf_counter()
        new_budget = len(tpu_pods) if max_new_nodes is None else max_new_nodes
        all_existing = list(cur_existing) + nodes
        max_slots = len(all_existing) + new_budget

        def _adopt_device(res: SolveResult, backend_used: str) -> SolveResult:
            """Post-device bookkeeping (metrics, what-if filtering, chain) —
            identical for the sync and async returns."""
            nonlocal solve_ms
            trace.annotate(backend_used=backend_used)
            self.registry.histogram(SOLVER_BACKEND_DURATION).observe(
                time.perf_counter() - t0, {"backend": backend_used})
            if not allow_new_nodes and res.nodes:
                # consolidation what-if with no new nodes allowed: pods that
                # needed new nodes are infeasible
                for n in res.nodes:
                    for p in n.pods:
                        infeasible[p.name] = "needs a new node (disallowed)"
                res.nodes = []
                for p in list(res.assignments):
                    if p in infeasible:
                        del res.assignments[p]
            chain(res)
            assignments.update(res.assignments)
            infeasible.update(res.infeasible)
            solve_ms += res.solve_ms
            return _tail()

        def _degraded_fallback() -> SolveResult:
            """Host-tier serve while the device tier is latched unhealthy:
            counted apart from cold-start fallbacks (the device was not
            answering) and not flagged served_cold — degraded answers
            provision real long-lived nodes, so they keep the reseat
            polish."""
            res, backend_used = self._cold_solve(
                st, tpu_pods, provisioners, instance_types, all_existing,
                daemonsets, unavailable, allow_new_nodes, max_slots,
                max_new_nodes,
            )
            self.registry.counter(SOLVER_DEGRADED_SOLVES).inc(
                {"backend": backend_used})
            trace.annotate(degraded=True)
            self._flight_anomaly(
                "degraded_solve",
                f"device tier latched unhealthy; {len(tpu_pods)}-pod batch "
                f"served by the warm {backend_used} tier", trace)
            return _adopt_device(res, backend_used)

        def _hung(where: str) -> SolveResult:
            self._flight_anomaly(
                "device_hang", f"{where} hung past the guard deadline "
                "(wedged device?)", trace)
            return _degraded_fallback()

        if self._route_native(st, len(tpu_pods)):
            from . import native as native_mod

            res = native_mod.solve_tensors_native(
                st, existing_nodes=all_existing, max_nodes=max_slots,
            )
            return _adopt_device(res, "native")

        # the port has no cold tier to serve an exhausted estimate from:
        # every path retries at the full budget inline
        guarded = self.backend == "auto" and self._guard.enabled
        if guarded and not self._guard.healthy:
            return _degraded_fallback()
        collector = self._mega_collect
        if dispatch and collector is not None:
            # megabatch registration (submit_many): the first device wave
            # joins the collector's pending batch; ONE batched dispatch
            # later serves every slot.  A hang degrades this request only
            slot = collector.add(
                st=st, existing_nodes=all_existing, max_nodes=max_slots,
                raise_on_exhaust=False, trace=trace,
            )

            def _finish_mega() -> SolveResult:
                try:
                    out = slot.result()
                except DeviceHang:
                    return _hung("megabatch device dispatch")
                return _adopt_device(out.result, "tpu")

            return _PendingWave(_finish_mega)

        def _call(fn, *args, **kwargs):
            return (self._guard.run(fn, *args, **kwargs) if guarded
                    else fn(*args, **kwargs))

        if dispatch:
            # async dispatch: enqueue without reading back; the caller does
            # other host work before finish() reads the wave.  Both halves
            # run under the guard
            try:
                pending = _call(
                    self._tpu.solve_async, st, existing_nodes=all_existing,
                    max_nodes=max_slots, trace=trace)
            except DeviceHang:
                return _hung("device dispatch")

            def _finish_wave() -> SolveResult:
                try:
                    out = _call(pending.result)
                except DeviceHang:
                    return _hung("device read-back")
                return _adopt_device(out.result, "tpu")

            return _PendingWave(_finish_wave)
        try:
            out = _call(
                self._tpu.solve, st, existing_nodes=all_existing,
                max_nodes=max_slots, trace=trace)
        except DeviceHang:
            # the guard latched the device tier unhealthy; this batch and
            # every one until the probe answers are served by a host tier
            return _hung("device solve")
        return _adopt_device(out.result, "tpu")
