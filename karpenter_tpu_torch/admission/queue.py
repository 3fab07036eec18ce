"""Bounded, priority-ordered, deadline-aware admission queue.

Replaces the raw FIFO between the RPC threads and the
:class:`~karpenter_tpu_torch.service.server.SolvePipeline` dispatcher.  Three
properties the FIFO lacked:

- **Bounded** — per-class and total depth quotas; a full queue rejects the
  arrival (or preempts a strictly lower class) instead of growing latency
  without bound.
- **Priority-ordered** — the dispatcher pops ``(class rank, arrival seq)``,
  so within a megabatch window higher classes fill slots first and FIFO
  order is preserved within a class.
- **Deadline-aware** — every ticket carries an absolute enqueue deadline;
  the dispatcher rejects expired tickets *before* tensorize/dispatch, so
  timed-out work never burns a device round trip.

This module owns only the *mechanism*: it reports rejection reasons and
preempted tickets to the caller and never raises shed errors or touches
metrics itself — the accounting (``karpenter_admission_shed_total``) lives
with :class:`~karpenter_tpu_torch.admission.AdmissionControl`, the single layer
ktlint KT009 audits for uncounted rejections.

Multi-producer (RPC threads) / single-consumer (the pipeline dispatcher);
all state is condition-guarded.  Clocked through the injectable
:class:`~karpenter_tpu_torch.utils.clock.Clock` (KT002).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.clock import Clock
from .policy import AdmissionPolicy, rank

_SEQ = itertools.count(1)


@dataclass
class AdmissionTicket:
    """One admitted request as the queue tracks it.  ``item`` is opaque to
    the queue (the pipeline's ``(kwargs, future, ...)`` tuple)."""

    item: object
    pclass: str
    enqueued_at: float
    deadline: Optional[float]           #: absolute queue-clock time, or None
    seq: int = field(default_factory=lambda: next(_SEQ))
    shed: bool = False                  #: set under the queue lock on preempt
    released: bool = False              #: concurrency slot returned (control)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline

    def sort_key(self) -> Tuple[int, int]:
        return (rank(self.pclass), self.seq)


class AdmissionQueue:
    """See module docstring.  ``put`` returns ``(ticket, reason,
    preempted)``: ``ticket`` is None exactly when ``reason`` names the
    rejection (``"queue_full"``); ``preempted`` lists tickets this
    admission evicted (their futures are the caller's to fail)."""

    def __init__(
        self,
        policy: Optional[AdmissionPolicy] = None,
        clock: Optional[Clock] = None,
        on_depth: Optional[Callable[[str, int], None]] = None,
    ) -> None:
        self.policy = policy or AdmissionPolicy()
        self.clock = clock or Clock()
        self._on_depth = on_depth
        self._cond = threading.Condition()
        self._heap: List[Tuple[Tuple[int, int], AdmissionTicket]] = []  # guarded-by: _cond
        self._depths: Dict[str, int] = {}                               # guarded-by: _cond

    def __len__(self) -> int:
        with self._cond:
            return sum(self._depths.values())

    def depth(self, pclass: str) -> int:
        with self._cond:
            return self._depths.get(pclass, 0)

    def _bump(self, pclass: str, delta: int) -> None:
        # Condition wraps an RLock, so re-acquiring under a holding caller
        # is free — and keeps the lock discipline lexical (KT004)
        with self._cond:
            self._depths[pclass] = self._depths.get(pclass, 0) + delta
            if self._on_depth is not None:
                self._on_depth(pclass, self._depths[pclass])

    def put(
        self, item: object, pclass: str, deadline: Optional[float] = None,
        gate=None,
    ) -> Tuple[Optional[AdmissionTicket], Optional[str],
               List[AdmissionTicket]]:
        """Admit or reject one item.  ``gate()`` (optional) is the caller's
        LAST admission check — e.g. the class token bucket — consulted
        inside the critical section only after every capacity check has
        passed, so a request the queue was going to reject anyway never
        spends a token; it returns a rejection reason or None.  A victim
        is preempted only after the gate passes, for the same reason."""
        quota = self.policy.quota(pclass)
        ticket = AdmissionTicket(
            item=item, pclass=pclass, enqueued_at=self.clock.now(),
            deadline=deadline,
        )
        preempted: List[AdmissionTicket] = []
        with self._cond:
            if (quota.max_queue_depth > 0
                    and self._depths.get(pclass, 0) >= quota.max_queue_depth):
                return None, "queue_full", preempted
            victim = None
            if sum(self._depths.values()) >= self.policy.max_queue_total:
                victim = self._victim(rank(pclass))
                if victim is None:
                    return None, "queue_full", preempted
            if gate is not None:
                reason = gate()
                if reason is not None:
                    return None, reason, preempted
            if victim is not None:
                victim.shed = True          # lazily removed from the heap
                self._bump(victim.pclass, -1)
                preempted.append(victim)
            heapq.heappush(self._heap, (ticket.sort_key(), ticket))
            self._bump(pclass, +1)
            self._cond.notify()
        return ticket, None, preempted

    def _victim(self, arriving_rank: int) -> Optional[AdmissionTicket]:
        """Newest queued ticket of the LOWEST class strictly below the
        arrival.  None when nothing outranks."""
        victim: Optional[AdmissionTicket] = None
        with self._cond:
            for _key, t in self._heap:
                if t.shed or rank(t.pclass) <= arriving_rank:
                    continue
                if (victim is None or rank(t.pclass) > rank(victim.pclass)
                        or (t.pclass == victim.pclass and t.seq > victim.seq)):
                    victim = t
        return victim

    def get(self, timeout: Optional[float] = None) -> Optional[AdmissionTicket]:
        """Pop the highest-priority live ticket (FIFO within a class), or
        None after ``timeout``.  Preempted (shed) tickets are skipped —
        their futures were already failed by the preempting ``put``."""
        with self._cond:
            while True:
                while self._heap and self._heap[0][1].shed:
                    heapq.heappop(self._heap)
                if self._heap:
                    _key, ticket = heapq.heappop(self._heap)
                    self._bump(ticket.pclass, -1)
                    return ticket
                if timeout is not None and timeout <= 0:
                    return None
                if not self._cond.wait(timeout):
                    # timed out; one last sweep in case notify raced the wait
                    while self._heap and self._heap[0][1].shed:
                        heapq.heappop(self._heap)
                    if not self._heap:
                        return None

    def drain(self) -> List[AdmissionTicket]:
        """Pop everything still queued (shutdown path) — the caller fails
        each ticket's future so no RPC thread is stranded."""
        out: List[AdmissionTicket] = []
        with self._cond:
            for _key, t in self._heap:
                if not t.shed:
                    out.append(t)
                    self._bump(t.pclass, -1)
            self._heap.clear()
        out.sort(key=AdmissionTicket.sort_key)
        return out
