"""Runtime lock-discipline sanitizer (``KT_SANITIZE=1``).

The static rules (KT004, KT012) check what annotations and the call graph
declare; this module checks what threads actually DO.  It wraps the
mutating entry points of the port's thread-sensitive serving classes in
*lock-assertion proxies* that raise :class:`SanitizerError` the moment two
threads are inside the same non-reentrant section of the same object — a
scheduler re-entrancy race (two concurrent ``Solve`` RPCs racing one
``BatchScheduler``) becomes a deterministic exception at the violation
site instead of a corrupted solve three calls later — and their declared
locks in order-asserting proxies checked against :data:`LOCK_ORDER`.

Guarded sections (one group per contract, per instance):

- ``BatchScheduler.solve`` / ``.submit`` — the scheduler is not re-entrant:
  all dispatch funnels through one thread at a time (``SolvePipeline``'s
  dispatcher in the pipelined path; ``_direct_lock`` serialization in the
  direct path).  Thread HANDOFF is legal (the pipeline is constructed on the
  RPC thread, dispatches on its own) — only *concurrent* entry raises.
- ``TensorizeCache.tensorize`` — documented "callers serialize solves".
- ``InflightQueue.push`` — single producer (the dispatcher).  ``pop_to`` is
  deliberately shared at shutdown (``SolvePipeline.stop`` drains a wedged
  dispatcher's queue; deque ops are thread-safe), so it is not wrapped.
- ``SolvePipeline._finalize`` — finalization is FIFO on the dispatcher;
  a second concurrent finalizer means two threads fencing one queue.

Enabled by exporting ``KT_SANITIZE=1`` before importing
``karpenter_tpu_torch`` or by calling :func:`install` directly (tests,
``chip_smoke.py``).  The proxies add one dict lookup per call — cheap
enough to leave on for a whole serving run — and wrapping is idempotent;
:func:`uninstall` restores the original methods.  It imports the port's
own classes, never the reference's.
"""

from __future__ import annotations

import functools
import logging
import threading
from typing import Dict, List, Tuple

logger = logging.getLogger(__name__)

#: serializes the per-object holder check; held only for the dict peek
_STATE_LOCK = threading.Lock()

_originals: Dict[Tuple[type, str], object] = {}


class SanitizerError(AssertionError):
    """Two threads entered a non-reentrant section of one object, or one
    thread acquired two tracked locks against the global order."""


#: The ONE global lock-acquisition order (outer first): a thread may
#: acquire a lock only while holding locks that appear EARLIER in this
#: tuple; the runtime watcher below raises SanitizerError on an inversion.
#: This is a linear extension of the port's KT012 static acquisition-order
#: graph (`python -m karpenter_tpu_torch.analysis --lock-order` prints the
#: derived edges; tests/test_torch_lint.py cross-validates that every
#: static edge is consistent with this table — the static pass and the
#: sanitizer check the same order from opposite sides: the pass proves
#: what the source CAN do, the watcher observes what threads actually DO,
#: including
#: the closure/callback nestings no static pass can see, e.g. the
#: admission queue's token-bucket gate running under the queue condition).
LOCK_ORDER: Tuple[str, ...] = (
    "Operator._reconcile_lock",
    "SolverService._direct_lock",
    "SolvePipeline._submit_lock",
    "SolvePipeline._sched_lock",  # held across dispatch/finalize + inline
    "AdmissionControl._lock",
    "AdmissionQueue._cond",
    "RateLimiter._lock",        # the put() gate runs under the queue cond
    "CircuitBreaker._lock",
    "DeltaSessionTable._lock",  # table dict only; never held across solves
    "BatchScheduler._mesh_serial_lock",  # a log-once flag, a leaf
    "TpuSolver._lock",
    "DeviceGuard._lock",
    "InMemoryLeaseStore._lock",
    "ThreadCoalescer._lock",
)


def _notify_flight(obj, detail: str) -> None:
    """Hand the violation to the flight recorder so the dump captures the
    traces/events leading up to it (a sanitizer error IS an anomaly — the
    black-box must survive the crash site).  Prefer the violating object's
    OWN recorder (a BatchScheduler over a private registry rings its own
    black box, not the process-global one whose ring holds unrelated
    traffic); fall back to the process default.  Best-effort: observability
    must never mask the error it is reporting."""
    try:
        from ..obs import default_flight

        flight = getattr(getattr(obj, "tracer", None), "flight", None)
        (flight or default_flight()).anomaly("sanitizer_error", detail=detail)
    except Exception:  # noqa: BLE001 — the SanitizerError must still raise
        logger.debug("sanitizer flight-recorder dump failed", exc_info=True)


def _wrap(cls: type, name: str, group: str):
    fn = cls.__dict__[name]
    slot = f"_kt_san_{group}"

    @functools.wraps(fn)
    def guarded(self, *args, **kwargs):
        me = threading.current_thread()
        with _STATE_LOCK:
            holder = getattr(self, slot, None)
            if holder is None or holder is me:
                reentrant = holder is me
                setattr(self, slot, me)
        if holder is not None and holder is not me:
            # outside _STATE_LOCK: the flight-recorder dump serializes the
            # trace ring and must not run under the sanitizer's own lock
            msg = (
                f"KT_SANITIZE: unguarded cross-thread mutation — "
                f"{cls.__name__}.{name} entered by {me.name!r} while "
                f"{holder.name!r} is still inside the {group!r} section "
                f"of the same object; this object's {group} contract is "
                "single-threaded (serialize callers or route through "
                "the pipeline dispatcher)"
            )
            _notify_flight(self, msg)
            raise SanitizerError(msg)
        try:
            return fn(self, *args, **kwargs)
        finally:
            if not reentrant:
                with _STATE_LOCK:
                    setattr(self, slot, None)

    guarded._kt_sanitized = True  # type: ignore[attr-defined]
    _originals.setdefault((cls, name), fn)
    setattr(cls, name, guarded)


# ---------------------------------------------------------------------------
# runtime lock-order confirmation (the KT012 cross-check)
# ---------------------------------------------------------------------------

#: per-thread stack of (rank, name) for currently-held tracked locks
_held = threading.local()

#: gates checking/recording only — push/pop always maintain the held
#: stack so proxies surviving an uninstall keep it truthful, while their
#: order assertions and edge recording go silent (install() re-arms them)
_watch_enabled = False

#: (outer name, inner name) pairs actually observed nested at runtime —
#: tests assert every observed edge is consistent with LOCK_ORDER, which
#: is how the dynamic side cross-validates the static table
_observed_edges: set = set()

_init_originals: Dict[type, object] = {}


def observed_lock_edges() -> set:
    """Snapshot of the (outer, inner) nestings threads actually performed."""
    with _STATE_LOCK:
        return set(_observed_edges)


class _OrderedLock:
    """Order-asserting proxy around one tracked component lock.

    ``acquire`` checks the acquiring thread's held stack against
    :data:`LOCK_ORDER` and raises :class:`SanitizerError` on an inversion
    — the deadlock's FIRST half becomes a deterministic exception at the
    acquisition site instead of a wedged process under load.  Re-acquiring
    the same proxy (RLock / Condition re-entry, condition-wait wakeups) is
    always legal.  All other attributes (``wait``, ``notify``, ...)
    delegate, so a wrapped Condition keeps its full surface."""

    def __init__(self, inner, name: str):
        self._kt_inner = inner
        self._kt_name = name
        self._kt_rank = LOCK_ORDER.index(name) if name in LOCK_ORDER \
            else len(LOCK_ORDER)

    def _kt_check(self) -> None:
        if not _watch_enabled:
            return  # uninstalled: surviving proxies delegate silently
        stack = getattr(_held, "stack", None)
        if not stack:
            return
        if any(name == self._kt_name for _rank, name in stack):
            # re-entry of an already-held lock (RLock/Condition), however
            # deep in the stack: the lock's own business, never an edge —
            # the thread cannot deadlock on a lock it already owns
            return
        # the binding constraint is the HIGHEST-ranked distinct held lock,
        # not the top of the stack: a legal re-entry of an early lock can
        # sit on top with a low rank and must not mask a real inversion
        # against a later-ranked lock still held beneath it
        top_rank, top_name = max(stack, key=lambda e: e[0])
        if top_rank > self._kt_rank:
            # raise BEFORE recording: an acquisition that raises never
            # happened, and the inverted pair must not poison the
            # observed-edge set the cross-validation tests assert over
            raise SanitizerError(
                f"KT_SANITIZE: lock-order inversion — "
                f"{threading.current_thread().name!r} acquiring "
                f"`{self._kt_name}` while holding `{top_name}`; the global "
                f"order (analysis/sanitize.py LOCK_ORDER, KT012) puts "
                f"`{self._kt_name}` BEFORE `{top_name}` — two threads "
                "taking opposite routes deadlock"
            )
        with _STATE_LOCK:
            _observed_edges.add((top_name, self._kt_name))

    def _kt_push(self) -> None:
        if not hasattr(_held, "stack"):
            _held.stack = []
        _held.stack.append((self._kt_rank, self._kt_name))

    def _kt_pop(self) -> None:
        stack = getattr(_held, "stack", None)
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][1] == self._kt_name:
                    del stack[i]
                    break

    def acquire(self, *args, **kwargs):
        self._kt_check()
        got = self._kt_inner.acquire(*args, **kwargs)
        if got:
            self._kt_push()
        return got

    def release(self):
        self._kt_pop()
        return self._kt_inner.release()

    def __enter__(self):
        self._kt_check()
        got = self._kt_inner.__enter__()
        self._kt_push()
        return got

    def __exit__(self, *exc):
        self._kt_pop()
        return self._kt_inner.__exit__(*exc)

    def __getattr__(self, name):
        return getattr(self._kt_inner, name)


def _wrap_locks(cls: type, attrs: Tuple[str, ...]) -> None:
    """Post-``__init__`` hook replacing the instance's lock attributes with
    order-asserting proxies (idempotent; uninstall restores __init__ — live
    instances keep their proxies, which is harmless: a proxy without the
    watcher installed still delegates)."""
    if cls in _init_originals:
        return
    orig = cls.__init__
    _init_originals[cls] = orig

    @functools.wraps(orig)
    def __init__(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        for attr in attrs:
            inner = getattr(self, attr, None)
            if inner is not None and not isinstance(inner, _OrderedLock):
                setattr(self, attr, _OrderedLock(
                    inner, f"{cls.__name__}.{attr}"))

    cls.__init__ = __init__


def installed() -> bool:
    return bool(_originals)


def install() -> None:
    """Wrap the solver-path classes in lock-assertion proxies and their
    declared locks in order-asserting proxies (idempotent)."""
    from ..admission import AdmissionControl, CircuitBreaker, RateLimiter
    from ..admission.queue import AdmissionQueue
    from ..batcher import InflightQueue, ThreadCoalescer
    from ..models.tensorize import TensorizeCache
    from ..solver.guard import DeviceGuard
    from ..solver.scheduler import BatchScheduler
    from ..solver.tpu import TpuSolver

    # runtime confirmation of the KT012 static lock order: every tracked
    # component lock becomes an order-asserting proxy; an acquisition that
    # inverts LOCK_ORDER raises at the site (the deadlock's first half,
    # made deterministic), and the nestings threads actually perform are
    # recorded for the cross-validation tests
    lock_plan: List[Tuple[type, Tuple[str, ...]]] = [
        (BatchScheduler, ("_mesh_serial_lock",)),
        (TpuSolver, ("_lock",)),
        (DeviceGuard, ("_lock",)),
        (AdmissionControl, ("_lock",)),
        (AdmissionQueue, ("_cond",)),
        (RateLimiter, ("_lock",)),
        (CircuitBreaker, ("_lock",)),
        (ThreadCoalescer, ("_lock",)),
    ]
    try:
        from ..service.delta import DeltaSessionTable as _DT
        from ..service.server import SolvePipeline as _SP
        from ..service.server import SolverService as _SS
    except ImportError:
        pass  # grpc-less install: the in-process locks still watched
    else:
        lock_plan.append((_SP, ("_submit_lock", "_sched_lock")))
        lock_plan.append((_SS, ("_direct_lock",)))
        lock_plan.append((_DT, ("_lock",)))
    try:
        from ..operator import InMemoryLeaseStore as _LS
        from ..operator import Operator as _Op
    except ImportError:
        pass  # keep the solver-side locks watched regardless
    else:
        lock_plan.append((_Op, ("_reconcile_lock",)))
        lock_plan.append((_LS, ("_lock",)))
    for cls, attrs in lock_plan:
        _wrap_locks(cls, attrs)
    global _watch_enabled
    _watch_enabled = True

    plan: List[Tuple[type, str, str]] = [
        (BatchScheduler, "solve", "dispatch"),
        (BatchScheduler, "submit", "dispatch"),
        # the megabatch entries share the dispatch contract: registration,
        # bucketing, and the batched dispatch all belong to ONE thread at a
        # time (the pipeline's dispatcher)
        (BatchScheduler, "submit_many", "dispatch"),
        (BatchScheduler, "bucket_key", "dispatch"),
        (TensorizeCache, "tensorize", "tensorize"),
        (InflightQueue, "push", "inflight-producer"),
    ]
    try:
        from ..service.server import SolvePipeline
    except ImportError as err:  # grpc-less install: everything else still on
        logger.warning("KT_SANITIZE: SolvePipeline proxy skipped (%r)", err)
    else:
        plan.append((SolvePipeline, "_finalize", "finalize"))
    for cls, name, group in plan:
        if not getattr(cls.__dict__[name], "_kt_sanitized", False):
            _wrap(cls, name, group)
    logger.info("KT_SANITIZE: lock-assertion proxies installed on %d "
                "methods", len(plan))


def uninstall() -> None:
    """Restore the original methods (test teardown).  Instances built while
    installed keep their _OrderedLock proxies, but with the watch disabled
    they delegate without checking or recording — sanitizer state cannot
    leak into 'sanitizer off' test phases; new instances get plain locks."""
    global _watch_enabled
    _watch_enabled = False
    for (cls, name), fn in _originals.items():
        setattr(cls, name, fn)
    _originals.clear()
    for cls, init in _init_originals.items():
        cls.__init__ = init
    _init_originals.clear()
    with _STATE_LOCK:
        _observed_edges.clear()
