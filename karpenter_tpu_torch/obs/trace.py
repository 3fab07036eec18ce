"""Per-solve span tracing.

The pipelined solver made a solve's latency a composite — batcher window,
tensorize-cache tier, H2D dispatch, device fence, reseat/repair — but the
aggregate histograms cannot explain a SINGLE slow or degraded solve after
the fact.  A :class:`Tracer` produces one :class:`Trace` per solve: a tree
of named :class:`Span`\\ s (``window`` → ``tensorize`` → ``dispatch`` →
``fence`` → ``reseat`` → ``respond``) carrying attributes (backend, cache
tier, ``served_cold``, batch size, cost), timestamped through the injectable
:class:`~karpenter_tpu_torch.utils.clock.Clock` so FakeClock tests are
deterministic (and KT002 stays clean).

Design constraints, in order:

- **Near-zero cost when sampling is off.**  ``Tracer.start`` returns the
  :data:`NULL_TRACE` singleton when disabled/unsampled; every span call on
  it is a constant no-op, so the hot path pays one attribute check.
- **Thread-crossing solves.**  A pipelined solve opens its root on the RPC
  thread, its dispatch/fence spans on the dispatcher thread, and may fence
  on the hang guard's expendable thread.  Nesting is tracked with a
  per-thread open-span stack: a span opened on a thread with no open parent
  attaches to the root.  Already-elapsed cross-thread phases (the pipeline
  queue wait) are attached with :meth:`Trace.record`, which never leaves a
  span open.
- **Lock discipline.**  The span tree is mutated from multiple threads and
  read mid-solve by the flight recorder's anomaly dumps; all tree state is
  ``# guarded-by:`` the trace lock (KT004) and ``to_dict`` snapshots under
  it.
- **Context-manager lifecycle (KT007).**  ``with tracer.start(...) as
  trace:`` / ``with trace.span(...):`` are the only blessed forms — a bare
  ``Tracer.start()`` leaks an open trace on any exception path, and ktlint
  rule KT007 flags it.
- **Collector pauses are spans.**  :func:`gc_spans` binds a request's trace
  to the calling thread for the duration of a call; a ``gc.callbacks``
  hook, installed once at import, stamps each collection that runs on that
  thread meanwhile, and the binding records them as ``gc`` spans when the
  call returns.  The hook takes no lock (a collection can fire while this
  thread holds a trace's lock) and, with no trace bound, does one
  thread-local read.
"""

from __future__ import annotations

import gc
import itertools
import logging
import os
import threading
from typing import Dict, List, Optional

from ..metrics import (
    TRACE_REMOTE_OUTCOMES,
    TRACE_REMOTE_SPANS,
    TRACE_SPAN_DURATION,
    TRACE_TRACES,
    Registry,
    registry as default_registry,
)
from ..utils.clock import Clock

#: hard per-trace span cap: a runaway retry ladder must not grow one trace
#: without bound (spans past the cap are dropped and counted on the root).
#: A 50,000-pod device solve opens a few dozen ``step.*`` spans per group
#: step; the cap holds such a request whole, its relax repair and residue
#: waves included, with room to spare
MAX_SPANS_PER_TRACE = 8192

_TRACE_IDS = itertools.count(1)


def replica_id() -> str:
    """This process's stable trace-origin identity: ``KT_REPLICA_ID`` (the
    deploy sets the pod name — the same identity the session-lease
    protocol uses) or a host-pid fallback.  Trace ids are PREFIXED with it
    (``replica-0-t000042``) so two replicas' locally-minted ids can never
    collide and a forwarded / failed-over hop joins exactly its parent's
    tree in the /fleetz merge.  Read per call, not at import: in-process
    fleet harnesses construct replicas under different env."""
    env = os.environ.get("KT_REPLICA_ID", "")
    if env:
        return env
    import socket

    return f"{socket.gethostname()}-{os.getpid()}"


class Span:
    """One timed, attributed phase of a trace.  Obtained from
    :meth:`Trace.span` (context manager) or :meth:`Trace.record`
    (pre-closed); never constructed directly by instrumentation."""

    __slots__ = ("name", "span_id", "t0", "t1", "attrs", "children",
                 "_trace")

    def __init__(self, trace: "Trace", name: str, t0: float,
                 attrs: Optional[dict] = None, span_id: str = "") -> None:
        self.name = name
        #: trace-local id (``s1`` = root, ``s2``...), carried on the wire
        #: as ``parent_span`` so a remote child hop can attach under THIS
        #: span in the /fleetz cross-replica tree
        self.span_id = span_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, object] = dict(attrs or ())
        self.children: List["Span"] = []  # guarded-by the owning trace lock
        self._trace = trace

    @property
    def done(self) -> bool:
        return self.t1 is not None

    @property
    def duration_s(self) -> float:
        return 0.0 if self.t1 is None else max(0.0, self.t1 - self.t0)

    def annotate(self, **attrs) -> "Span":
        self._trace._annotate_span(self, attrs)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self._trace._annotate_span(self, {"error": repr(exc)})
        self._trace._close_span(self)
        return False  # never swallow

    def _to_dict_locked(self) -> dict:
        """Serialize (caller holds the trace lock; see Trace.to_dict)."""
        out: dict = {
            "name": self.name,
            "span_id": self.span_id,
            "start": self.t0,
            "end": self.t1,
            "duration_ms": (None if self.t1 is None
                            else round(self.duration_s * 1000.0, 3)),
        }
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["spans"] = [c._to_dict_locked() for c in self.children]
        return out


class _NullSpan:
    """Do-nothing span: the entire cost of tracing while sampling is off."""

    __slots__ = ()

    name = ""
    span_id = ""
    attrs: dict = {}
    children: list = []
    done = True
    duration_s = 0.0

    def annotate(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _NullTrace:
    """Do-nothing trace returned by a disabled/unsampled ``Tracer.start``.
    Falsy, so instrumentation can write ``trace = trace or NULL_TRACE`` and
    branch on ``if trace:`` where it matters."""

    __slots__ = ()

    trace_id = ""
    name = ""
    duration_s = 0.0

    def __bool__(self) -> bool:
        return False

    def now(self) -> float:
        return 0.0

    def span(self, name: str, **attrs) -> _NullSpan:
        return NULL_SPAN

    def record(self, name: str, t0: float, t1: float, **attrs) -> _NullSpan:
        return NULL_SPAN

    def annotate(self, **attrs) -> None:
        return None

    def wire_context(self) -> "tuple[str, str]":
        """No context crosses the wire for an unsampled/disabled trace —
        the remote side roots locally (counted ``local``)."""
        return ("", "")

    def spans(self) -> list:
        return []

    def span_names(self) -> list:
        return []

    def to_dict(self) -> dict:
        return {}

    def __enter__(self) -> "_NullTrace":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_TRACE = _NullTrace()


class Trace:
    """One solve's span tree.  Context manager: exiting closes the root and
    hands the finished trace to the tracer (metrics + flight recorder)."""

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[dict] = None,
                 trace_id: Optional[str] = None) -> None:
        self._tracer = tracer
        self._clock = tracer.clock
        # replica-prefixed so two replicas' locally-minted ids can never
        # collide in a fleet merge; a remote-parented trace ADOPTS the
        # origin's id instead (Tracer.start_remote) — one request, one id
        self.trace_id = (trace_id
                         or f"{tracer.replica}-t{next(_TRACE_IDS):06d}")
        self.name = name
        self._lock = threading.Lock()
        self._n_spans = 1           # guarded-by: _lock
        self._n_dropped = 0         # guarded-by: _lock
        self.root = Span(self, name, self._clock.now(), attrs, span_id="s1")
        self._open = threading.local()  # per-thread open-span stack

    # ---- time -----------------------------------------------------------
    def now(self) -> float:
        """The trace's clock (so callers on other threads timestamp
        cross-thread phases consistently with the span tree)."""
        return self._clock.now()

    @property
    def duration_s(self) -> float:
        return self.root.duration_s

    # ---- span lifecycle -------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._open, "stack", None)
        if st is None:
            st = self._open.stack = []
        return st

    def span(self, name: str, **attrs):
        """Open a child span under this thread's innermost open span (the
        root when none).  Use as ``with trace.span("tensorize") as sp:``."""
        stack = self._stack()
        parent = stack[-1] if stack else self.root
        with self._lock:
            if self._n_spans >= MAX_SPANS_PER_TRACE:
                self._n_dropped += 1
                self.root.attrs["spans_dropped"] = self._n_dropped
                return NULL_SPAN
            self._n_spans += 1
            sp = Span(self, name, self._clock.now(), attrs,
                      span_id=f"s{self._n_spans}")
            parent.children.append(sp)
        stack.append(sp)
        return sp

    def record(self, name: str, t0: float, t1: float, **attrs):
        """Attach an already-elapsed span (cross-thread phases — e.g. the
        pipeline queue wait, timestamped on the RPC thread and recorded by
        the dispatcher).  The span is born closed, so no context manager is
        needed and nothing can leak."""
        with self._lock:
            if self._n_spans >= MAX_SPANS_PER_TRACE:
                self._n_dropped += 1
                self.root.attrs["spans_dropped"] = self._n_dropped
                return NULL_SPAN
            self._n_spans += 1
            sp = Span(self, name, t0, attrs, span_id=f"s{self._n_spans}")
            sp.t1 = t1
            self.root.children.append(sp)
        return sp

    def _close_span(self, span: Span) -> None:
        with self._lock:
            if span.t1 is None:
                span.t1 = self._clock.now()
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()

    def _annotate_span(self, span: Span, attrs: dict) -> None:
        with self._lock:
            span.attrs.update(attrs)

    def annotate(self, **attrs) -> None:
        """Attach attributes to the root span (backend, batch size, cost,
        served_cold, ...)."""
        self._annotate_span(self.root, attrs)

    def wire_context(self) -> "tuple[str, str]":
        """The ``(trace_id, parent_span)`` pair a wire-crossing send site
        attaches to its request (ktlint KT019 pins the discipline): the
        remote side opens its child trace under this thread's innermost
        OPEN span (the root when none), so the hop lands exactly where
        the RPC happened in the tree."""
        stack = self._stack()
        return (self.trace_id,
                stack[-1].span_id if stack else self.root.span_id)

    # ---- completion / introspection -------------------------------------
    def finish(self) -> "Trace":
        with self._lock:
            if self.root.t1 is None:
                self.root.t1 = self._clock.now()
        return self

    def spans(self) -> List[Span]:
        """Flat snapshot of every span (root first, depth-first)."""
        with self._lock:
            out: List[Span] = []
            stack = [self.root]
            while stack:
                sp = stack.pop()
                out.append(sp)
                stack.extend(reversed(sp.children))
            return out

    def span_names(self) -> List[str]:
        return [sp.name for sp in self.spans()]

    def to_dict(self) -> dict:
        """JSON-ready snapshot; safe to call mid-solve (anomaly dumps
        serialize in-flight traces — open spans carry ``end: null``)."""
        with self._lock:
            return {"trace_id": self.trace_id, **self.root._to_dict_locked()}

    def __enter__(self) -> "Trace":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.annotate(error=repr(exc))
        self._tracer._finish(self)
        return False


class Tracer:
    """Trace factory + completion sink.

    ``enabled`` defaults from ``KT_TRACE`` (``0`` disables — the hot path
    then costs one attribute check per solve); ``sample_every`` (from
    ``KT_TRACE_SAMPLE_EVERY``) keeps one trace in every N starts, for
    high-rate deployments where even ring churn matters.  Finished traces
    are counted (``karpenter_trace_traces_total``), their spans observed
    into ``karpenter_trace_span_duration_seconds{span=...}``, and handed to
    the attached :class:`~karpenter_tpu_torch.obs.recorder.FlightRecorder`.
    """

    def __init__(
        self,
        clock: Optional[Clock] = None,
        registry: Optional[Registry] = None,
        flight=None,
        enabled: Optional[bool] = None,
        sample_every: Optional[int] = None,
    ) -> None:
        self.clock = clock or Clock()
        self.registry = registry or default_registry
        self.flight = flight
        if enabled is None:
            enabled = os.environ.get("KT_TRACE", "1") != "0"
        self.enabled = enabled
        if sample_every is None:
            sample_every = int(os.environ.get("KT_TRACE_SAMPLE_EVERY", "1"))
        self.sample_every = max(1, sample_every)
        #: this tracer's trace-id prefix + the replica_id attr every
        #: adopted hop carries (captured at construction: in-process fleet
        #: harnesses build replicas under different KT_REPLICA_ID env)
        self.replica = replica_id()
        self._lock = threading.Lock()
        self._n_started = 0  # guarded-by: _lock
        #: finished-trace sinks beyond the flight recorder (the occupancy
        #: accountant subscribes here); each called with the closed trace
        self._sinks: List = []
        # zero-init so the series exists from the first scrape (KT003), and
        # register the span-duration family so the documented metric is
        # visible before the first trace completes
        self.registry.counter(TRACE_TRACES).inc(value=0.0)
        remote = self.registry.counter(TRACE_REMOTE_SPANS)
        for outcome in TRACE_REMOTE_OUTCOMES:
            remote.inc({"outcome": outcome}, value=0.0)
        self.registry.histogram(TRACE_SPAN_DURATION)

    def start(self, name: str, **attrs):
        """Begin a trace — ALWAYS as ``with tracer.start(...) as trace:``
        (ktlint KT007 flags bare starts).  Returns :data:`NULL_TRACE` when
        disabled or unsampled."""
        if not self.enabled:
            return NULL_TRACE
        with self._lock:
            self._n_started += 1
            sampled = self._n_started % self.sample_every == 0
        if not sampled:
            return NULL_TRACE
        return Trace(self, name, attrs)

    def start_remote(self, name: str, trace_id: str, parent_span: str,
                     **attrs):
        """Begin a trace that may ADOPT a remote parent — the server-entry
        facade (ktlint KT019: every entry that decodes a wire trace
        context must open its trace through here; KT007 covers the
        context-manager form).  With a non-empty ``trace_id`` the trace
        joins the remote tree: it reuses the ORIGIN's trace id (so the
        /fleetz merge groups the hops into one tree), records the parent
        span id + this replica's identity on its root, and BYPASSES
        sampling — the origin already made the sampling decision, and a
        half-sampled tree is worse than none.  With an empty ``trace_id``
        (old client, direct call, unsampled origin) this is exactly
        :meth:`start`.  Counted into
        ``karpenter_trace_remote_spans_total{outcome}`` per trace actually
        opened."""
        if not self.enabled:
            return NULL_TRACE
        if not trace_id:
            trace = self.start(name, **attrs)
            if trace:
                self.registry.counter(TRACE_REMOTE_SPANS).inc(
                    {"outcome": "local"})
            return trace
        attrs = dict(attrs)
        attrs["replica_id"] = self.replica
        if parent_span:
            attrs["remote_parent"] = parent_span
        self.registry.counter(TRACE_REMOTE_SPANS).inc(
            {"outcome": "adopted"})
        return Trace(self, name, attrs, trace_id=trace_id)

    def add_sink(self, sink) -> None:
        """Subscribe ``sink(trace)`` to every finished trace (append-only
        list read without the lock — sinks are wired at service
        construction, before traffic)."""
        self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        try:
            self._sinks.remove(sink)
        except ValueError:
            pass

    def _finish(self, trace: Trace) -> None:
        trace.finish()
        self.registry.counter(TRACE_TRACES).inc()
        hist = self.registry.histogram(TRACE_SPAN_DURATION)
        for sp in trace.spans():
            if sp.done:
                hist.observe(sp.duration_s, {"span": sp.name})
        for sink in self._sinks:
            try:
                sink(trace)
            except Exception:  # noqa: BLE001 — same contract as the flight
                # recorder below: observers never fail the solve path
                logging.getLogger(__name__).warning(
                    "trace sink failed for %s", trace.trace_id,
                    exc_info=True)
        if self.flight is not None:
            try:
                self.flight.add(trace)
            except Exception:  # noqa: BLE001 — runs in Trace.__exit__ on the
                # solve path; a recorder failure must not fail the solve
                logging.getLogger(__name__).warning(
                    "flight recorder rejected trace %s", trace.trace_id,
                    exc_info=True)


# ---------------------------------------------------------------------------
# collector pauses
# ---------------------------------------------------------------------------


class _GcSpans:
    """A request's trace bound to this thread for a call, and the
    collections stamped under it: ``(t0, t1, generation)``, this thread
    only.  A binding of the trace already bound here stays inert."""

    __slots__ = ("trace", "outer", "bound", "pauses", "t0")

    def __init__(self, trace) -> None:
        self.trace = trace
        self.outer: Optional["_GcSpans"] = None
        self.bound = False
        self.pauses: list = []
        self.t0: Optional[float] = None

    def __enter__(self) -> "_GcSpans":
        outer = getattr(_gc_bound, "b", None)
        if outer is None or outer.trace is not self.trace:
            self.outer, self.bound = outer, True
            _gc_bound.b = self
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.bound:
            # unbind first: a collection inside record() stays unstamped
            _gc_bound.b = self.outer
            for t0, t1, gen in self.pauses:
                self.trace.record("gc", t0, t1, generation=gen)
        return False


_gc_bound = threading.local()


def _gc_hook(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: stamp a collection on the calling thread's
    bound trace.  Reads the trace's clock and appends to the binding's own
    list; never takes a lock and never calls into the trace's span API."""
    b = getattr(_gc_bound, "b", None)
    if b is None:
        return
    if phase == "start":
        b.t0 = b.trace.now()
    elif b.t0 is not None:
        b.pauses.append((b.t0, b.trace.now(), info.get("generation")))
        b.t0 = None


def gc_spans(trace):
    """``with gc_spans(trace):`` around a traced request's call on this
    thread: each collection that runs on the thread meanwhile becomes a
    ``gc`` span of ``trace`` (``generation`` attribute) when the block
    exits.  Nested bindings of the same trace leave it to the outermost;
    a falsy trace binds nothing (the shared no-op span)."""
    return _GcSpans(trace) if trace else NULL_SPAN


if _gc_hook not in gc.callbacks:
    gc.callbacks.append(_gc_hook)
