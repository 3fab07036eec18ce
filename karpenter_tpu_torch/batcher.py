"""Generic request batching with idle/max windows.

Two batching layers mirror the reference:

1. ``Window`` — the provisioning pod batcher (idle 1s / max 10s,
   concepts/settings.md:41-47): accumulate items until the stream goes idle
   or the max window expires.
2. ``Coalescer`` — pkg/batcher/batcher.go:29-171 semantics: hash-bucketed
   request coalescing for cloud API calls (CreateFleet fan-out,
   DescribeInstances merge); concurrent identical requests share one backend
   call.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Generic, Hashable, List, Optional, TypeVar

from .utils.clock import Clock

T = TypeVar("T")
U = TypeVar("U")

DEFAULT_IDLE_SECONDS = 1.0
DEFAULT_MAX_SECONDS = 10.0


class Window(Generic[T]):
    """Idle/max-duration batching window."""

    def __init__(
        self,
        idle_seconds: float = DEFAULT_IDLE_SECONDS,
        max_seconds: float = DEFAULT_MAX_SECONDS,
        clock: Optional[Clock] = None,
    ) -> None:
        self.idle = idle_seconds
        self.max = max_seconds
        self.clock = clock or Clock()
        self._items: List[T] = []
        self._first_at: Optional[float] = None
        self._last_at: Optional[float] = None

    def add(self, item: T) -> None:
        now = self.clock.now()
        if self._first_at is None:
            self._first_at = now
        self._last_at = now
        self._items.append(item)

    def __len__(self) -> int:
        return len(self._items)

    @property
    def opened_at(self) -> Optional[float]:
        """When the first item of the current batch arrived (None while
        empty) — the start of the trace's "window" span: time pods spent
        waiting for the idle/max batching window to fire is part of their
        caller-visible scheduling latency."""
        return self._first_at

    def ready(self) -> bool:
        if not self._items:
            return False
        now = self.clock.now()
        if now - self._first_at >= self.max:
            return True
        return now - self._last_at >= self.idle

    def pop(self) -> List[T]:
        items, self._items = self._items, []
        self._first_at = self._last_at = None
        return items


class InflightQueue(Generic[T]):
    """Bounded FIFO of in-flight async work — the double-buffer behind the
    solver's pipelined dispatch (service/server.py SolvePipeline).

    ``push(item)`` appends and returns the items evicted past ``depth``
    (oldest first) for the caller to finalize; ``pop_to(target)`` pops down
    to ``target`` for idle drains.  Finalization itself stays with the
    caller — this class only owns the ordering and the depth bound, so a
    finalizer that blocks (a device fence) never runs under any lock here.
    ``on_depth`` fires with the new depth after every change (metrics
    gauge hook).  Single-producer: the pipeline's dispatcher thread.
    """

    def __init__(self, depth: int = 2,
                 on_depth: Optional[Callable[[int], None]] = None) -> None:
        self.depth = max(1, depth)
        self._q: "deque[T]" = deque()
        self._on_depth = on_depth

    def __len__(self) -> int:
        return len(self._q)

    def _notify(self) -> None:
        if self._on_depth is not None:
            self._on_depth(len(self._q))

    def push(self, item: T) -> List[T]:
        self._q.append(item)
        evicted: List[T] = []
        while len(self._q) > self.depth:
            try:
                evicted.append(self._q.popleft())
            except IndexError:  # lost a pop race (see pop_to); len was stale
                break
        self._notify()
        return evicted

    def pop_to(self, target: int = 0) -> List[T]:
        # len-check-then-popleft is not atomic, and the shutdown path runs
        # pop_to concurrently with a merely-slow (not wedged) dispatcher's
        # own drains (SolvePipeline.stop after its join times out).  Each
        # popleft is itself thread-safe; absorb losing the race so the
        # caller's remaining drains still run.
        out: List[T] = []
        while len(self._q) > target:
            try:
                out.append(self._q.popleft())
            except IndexError:
                break  # the racer got it; its owner resolves it
        if out:
            self._notify()
        return out


class SlotCoalescer(Generic[T]):
    """Deadline-aware request-slot coalescer — the continuous-batching front
    of the solver's cross-request megabatch path (service/server.py
    SolvePipeline drives it between the RPC queue and the device dispatch).

    Items arrive tagged with a *bucket key* (the megabatch compile-signature
    bucket; ``None`` = cannot ride a megabatch).  The key is opaque here,
    but by contract it carries everything that picks the compiled program —
    including the scheduler's MESH signature (``TpuSolver.mega_signature``):
    a meshed scheduler's sharded flushes and a single-device scheduler's
    flushes are different buckets, so requests against different device
    layouts can never coalesce into one dispatch.  Consecutive same-key
    items accumulate into one batch of up to ``max_slots``; a batch flushes
    when

    - **full** — it reached ``max_slots``,
    - **bucket** — an arriving item carries a different (or None) key,
    - **deadline** — its oldest item has waited ``max_wait`` seconds
      (``poll``/``flush``, clocked through the injectable Clock so
      FakeClock tests are deterministic).

    **Mixed-bucket unification** (ISSUE 14): an optional ``unify(held_key,
    new_key)`` hook — the scheduler's ``unify_buckets`` — may return a
    MERGED key instead of None when the two compile buckets can share one
    program (one's dims dominate the other's); the arriving item then
    JOINS the held batch under the merged key instead of forcing a
    "bucket" flush, so a host-major mesh dispatch serves both shapes in
    one flush instead of two serial ones.  ``on_unify`` fires per
    unification (metrics hook).  Slot packing stays host-major-contiguous
    by construction: items keep arrival order and the dispatch pads at
    the END, so a partially-full flush lights whole hosts first.

    Single-threaded by contract: the pipeline's dispatcher thread owns it,
    exactly like ``InflightQueue``'s producer side.  The coalescer never
    executes anything — it only decides batch boundaries; the caller
    dispatches and observes the flush metrics."""

    def __init__(
        self,
        max_slots: int = 8,
        max_wait: float = 0.0,
        clock: Optional[Clock] = None,
        unify: Optional[Callable[[Hashable, Hashable],
                                 Optional[Hashable]]] = None,
        on_unify: Optional[Callable[[], None]] = None,
    ) -> None:
        self.max_slots = max(1, max_slots)
        self.max_wait = max(0.0, max_wait)
        self.clock = clock or Clock()
        self.unify = unify
        self.on_unify = on_unify
        self._key: Optional[Hashable] = None
        self._items: List[T] = []
        self._first_at: Optional[float] = None

    def __len__(self) -> int:
        return len(self._items)

    @property
    def key(self) -> Optional[Hashable]:
        return self._key

    def deadline(self) -> Optional[float]:
        """Absolute clock time at which the held batch must flush (None
        while empty) — the dispatcher bounds its queue-poll timeout by it."""
        if not self._items:
            return None
        return self._first_at + self.max_wait

    def _take(self) -> List[T]:
        items, self._items = self._items, []
        self._key = None
        self._first_at = None
        return items

    def add(self, key: Optional[Hashable], item: T):
        """Admit one item; returns the list of ``(reason, key, items)``
        batches this admission flushed, oldest first.  A ``None`` key first
        flushes the held batch (bucket change), then flushes the item alone
        — unbatchable requests never wait behind a deadline.  A different
        non-None key first consults ``unify``: a merged key re-keys the
        held batch and the item joins it (no flush)."""
        out = []
        if self._items and (key is None or key != self._key):
            merged = None
            if key is not None and self.unify is not None:
                # the hook is a scheduler contract, but a facade's probe
                # must never fail the dispatcher (the _bucket_of idiom)
                try:
                    merged = self.unify(self._key, key)
                # ktlint: allow[KT005] unification is an optimization —
                # a failing hook just keeps the two-flush path
                except Exception:
                    merged = None
            if merged is not None:
                self._key = merged
                if self.on_unify is not None:
                    self.on_unify()
            else:
                out.append(("bucket", self._key, self._take()))
        if key is None:
            out.append(("bucket", None, [item]))
            return out
        if not self._items:
            self._key = key
            self._first_at = self.clock.now()
        self._items.append(item)
        if len(self._items) >= self.max_slots:
            out.append(("full", self._key, self._take()))
        return out

    def poll(self):
        """Deadline check — call when the inbound queue goes idle; returns
        the expired batch as ``[(\"deadline\", key, items)]`` or ``[]``."""
        if self._items and self.clock.now() >= self._first_at + self.max_wait:
            return [("deadline", self._key, self._take())]
        return []

    def flush(self, reason: str = "deadline"):
        """Unconditional flush of whatever is held (queue-idle fast path
        when no max-wait is configured, and the shutdown drain)."""
        if not self._items:
            return []
        return [(reason, self._key, self._take())]


@dataclass
class _Bucket(Generic[T, U]):
    requests: List[T] = field(default_factory=list)
    results: List[U] = field(default_factory=list)


class _Batch:
    __slots__ = ("reqs", "event", "results")

    def __init__(self) -> None:
        self.reqs: List[object] = []
        self.event = threading.Event()
        self.results = None  # List[("ok", value) | ("err", exception)]


class CoalescerTimeout(RuntimeError):
    """A follower waited past ``follower_timeout`` for its batch leader to
    publish results — the leader thread likely died between registering the
    bucket and setting the event.  The request outcome is UNKNOWN: if the
    leader was merely stalled, the batched call may still execute."""


class ThreadCoalescer:
    """Coalescer for *concurrent* callers (batcher.go:130-151 semantics with
    goroutines mapped to threads): the first requester of a bucket becomes
    the leader, sleeps the idle window while peers join, then executes once
    and publishes per-request outcomes.  Used at the cloud boundary by
    ``cloud.batched.BatchedCloud``; the synchronous ``Coalescer`` above
    covers single-threaded accumulate-then-flush callers."""

    #: generous bound on how long a follower will wait for its leader; the
    #: backend call itself is bounded well under this, so expiry means the
    #: leader died (async exception / interpreter shutdown), not a slow call
    FOLLOWER_TIMEOUT = 120.0

    def __init__(
        self,
        execute: Callable[[List[object]], List[tuple]],
        idle_seconds: float = 0.002,
        follower_timeout: float = FOLLOWER_TIMEOUT,
    ) -> None:
        self.execute = execute
        self.idle = idle_seconds
        self.follower_timeout = follower_timeout
        self._lock = threading.Lock()
        self._buckets: Dict[Hashable, _Batch] = {}  # guarded-by: _lock
        self.batch_count = 0                        # guarded-by: _lock  backend round trips
        self.requests_served = 0                    # guarded-by: _lock  total requests across batches
        self.batch_sizes = deque(maxlen=128)        # guarded-by: _lock  recent batch sizes

    def call(self, key: Hashable, req: object):
        with self._lock:
            batch = self._buckets.get(key)
            leader = batch is None
            if leader:
                batch = _Batch()
                self._buckets[key] = batch
            idx = len(batch.reqs)
            batch.reqs.append(req)
        if leader:
            if self.idle > 0:
                time.sleep(self.idle)
            with self._lock:
                # late joiners after this point start a fresh bucket
                self._buckets.pop(key, None)
                reqs = list(batch.reqs)
            try:
                outcomes = self.execute(reqs)
            # ktlint: allow[KT005] leader publishes the failure to every
            # follower as its per-request outcome; each caller re-raises
            except Exception as err:  # backend-wide failure fans out to all
                outcomes = [("err", err)] * len(reqs)
            batch.results = outcomes
            with self._lock:  # concurrent leaders of other buckets also count
                self.batch_count += 1
                self.requests_served += len(reqs)
                self.batch_sizes.append(len(reqs))
            batch.event.set()
        else:
            # measured beyond the leader's idle-window sleep, so a live leader
            # still collecting joiners can never be mistaken for a dead one
            if not batch.event.wait(self.idle + self.follower_timeout):
                with self._lock:
                    # unregister the dead batch (if still current) so the next
                    # caller can become a fresh leader instead of every future
                    # call for this key stalling on the same corpse
                    if self._buckets.get(key) is batch:
                        del self._buckets[key]
                raise CoalescerTimeout(
                    f"batch leader for bucket {key!r} did not publish results "
                    f"within {self.idle + self.follower_timeout:.0f}s; request "
                    "outcome unknown (it may still execute if the leader was "
                    "only stalled)"
                )
        kind, val = batch.results[idx]
        if kind == "err":
            raise val
        return val


class Coalescer(Generic[T, U]):
    """Coalesce identical requests into one backend call.

    ``execute(reqs) -> results`` is invoked once per distinct hash bucket per
    flush; each caller gets its own result (fan-out), mirroring
    batcher.go:130-151's one-call-per-bucket with per-requester responses.
    """

    def __init__(
        self,
        hasher: Callable[[T], Hashable],
        execute: Callable[[List[T]], List[U]],
    ) -> None:
        self.hasher = hasher
        self.execute = execute
        self._buckets: Dict[Hashable, List[T]] = {}

    def add(self, request: T) -> Hashable:
        key = self.hasher(request)
        self._buckets.setdefault(key, []).append(request)
        return key

    def flush(self) -> Dict[Hashable, List[U]]:
        out: Dict[Hashable, List[U]] = {}
        for key, reqs in self._buckets.items():
            out[key] = self.execute(reqs)
        self._buckets.clear()
        return out
