"""Delta serving — the session-stateful side of warm-start over the wire:
the port of the reference package's ``service/delta.py``.

``solver/warmstart.delta_solve`` makes steady-state reconcile a
sub-millisecond incremental update, but a plain gRPC ``Solve`` re-ships
the full cluster and re-solves from scratch.  This module holds the
server-side session state that closes that gap (the serving protocol
itself lives in ``service/server.py`` ``SolvePipeline``
``_dispatch_delta``; the reference's client facade ``DeltaSession`` speaks
to it unchanged):

- :class:`DeltaSessionTable` — a bounded, TTL-evicted table of live
  warm-start chains, one per client session: each :class:`SessionEntry`
  carries the previous :class:`~karpenter_tpu_torch.solver.types.SolveResult`
  (whose ``_warmstart_meta`` IS the incremental chain), the catalog the
  chain was packed against, and the epoch counter the wire protocol acks.
- :class:`DeltaReply` — the dispatcher-built, DETACHED response view: the
  session chain is mutated by the next delta the moment the dispatcher
  moves on, so everything the RPC thread encodes is snapshotted here
  first (O(delta) per incremental step; O(cluster) only on the rare
  establish/reseed/full-shaped replies).
- :class:`DeltaSessionUnknown` — the typed "no live chain for your
  (session, epoch)" outcome; the wire maps it to
  ``session_state="unknown"`` and the client re-establishes with ONE full
  solve (never a retry loop, never silent divergence).

Epoch contract: the server acks ``epoch`` after applying each step; a
client must send ``base_epoch`` equal to the last ack.  Any mismatch —
lost response, evicted session, server restart — is answered ``unknown``,
so an ambiguous outcome can only ever cost one re-establishing full
solve, never a diverged chain.

Knobs: ``KT_DELTA`` (default on; 0 disables the whole path and the wire
behaves byte-identically to pre-delta serving), ``KT_DELTA_SESSIONS``
(table capacity, default 64), ``KT_DELTA_TTL_S`` (idle TTL, default 900).
Durability: ``KT_SESSION_DIR`` spools the
chains to disk on graceful shutdown and periodically at epoch boundaries
(``KT_SESSION_SNAPSHOT_S``), so a restarted replica serves the next delta
of every surviving session WARM instead of paying one re-establishing
full solve per client; ``KT_CATALOG_EPOCH`` (optional) refuses spools
from any OTHER catalog epoch (older or newer — rollbacks too).

Meshed composition: on a mesh-configured scheduler the inline delta
shortcut keeps its latency because the displaced-subproblem solves run on
the HOST-LOCAL single-device programs (``BatchScheduler.solve_delta``
under ``_host_local``; ``KT_DELTA_LOCAL=0`` reverts) — a small step must
not pay the sharded dispatch; only the full-solve fallbacks (threshold /
guard / reseed — whole-cluster work) keep the mesh.  Session state here is
device-agnostic: chains carry host objects, never device tensors (the
spool pickles every tensor's host copy).

Fleet handoff: the spool is SESSION-ADDRESSABLE — one record
file + one ownership lease per session (``service/snapshot.py``) — so on
a SHARED volume any replica can :meth:`DeltaSessionTable.adopt` a
specific session on demand: a replica death or graceful drain hands the
warm chain to whichever sibling the client re-homes to, and the lease
protocol (claim / typed refusal / steal-after-``KT_SESSION_LEASE_S``)
guarantees exactly one adopter.  ``KT_REPLICA_ID`` names this replica as
the lease owner (the deploy sets the pod name; defaults to a stable
per-process id so in-process restarts self-renew).

Known limitation (documented, bounded): session ESTABLISHMENTS are full
solves served synchronously on the fast path (held batches are flushed
first, so other traffic proceeds between them), not coalesced into
megabatches — after a restart wipes the table, N re-establishing clients
serialize N full solves.  The cost is bounded by ``KT_DELTA_SESSIONS`` x
one full solve and paid once per restart; routing establishes through
the coalescer while seeding the table from finalization is the follow-on
if restart storms ever dominate.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .. import faults as faults_mod
from ..metrics import (
    DELTA_EVICT_REASONS,
    DELTA_EVICTIONS,
    DELTA_RPC,
    DELTA_RPC_DURATION,
    DELTA_RPC_OUTCOMES,
    DELTA_SESSIONS,
    SESSION_ADOPTION_OUTCOMES,
    SESSION_ADOPTIONS,
    SESSION_LEASES,
    SNAPSHOT_DURATION,
    SNAPSHOT_RESTORE,
    SNAPSHOT_RESTORE_OUTCOMES,
    SNAPSHOT_SESSIONS,
    SNAPSHOT_SKIP_REASONS,
    SNAPSHOT_SKIPPED,
    SNAPSHOT_WRITE_OUTCOMES,
    SNAPSHOT_WRITES,
    Registry,
    registry as default_registry,
)
from ..obs import protocol
from ..solver.types import SimNode, SolveResult, advance_node_counter
from ..utils.clock import Clock
from . import snapshot as snap

logger = logging.getLogger(__name__)

#: default live-session capacity per pipeline (KT_DELTA_SESSIONS); LRU past
#: it — an evicted session costs its client one re-establishing full solve
DEFAULT_SESSIONS = 64
#: default idle TTL, seconds (KT_DELTA_TTL_S): a reconcile loop ticks every
#: few seconds, so 15 idle minutes means the client is gone
DEFAULT_TTL_S = 900.0


def delta_enabled() -> bool:
    """KT_DELTA=0 turns delta serving off entirely: session fields on the
    wire are ignored, every Solve takes the classic full path — byte-
    identical to pre-delta behavior."""
    return os.environ.get("KT_DELTA", "1") != "0"


class DeltaSessionUnknown(Exception):
    """The server holds no live chain for the client's (session, epoch) —
    evicted, never established, epoch mismatch after a lost response, or
    a catalog-epoch bump the request did not carry the new catalog for.
    The client's contract: re-establish with ONE full solve."""


@dataclass
class SessionEntry:
    """One live warm-start chain.  Dispatcher-owned after table lookup —
    only the pipeline's single dispatcher thread ever reads or mutates the
    chain state; the table lock below guards only the table itself."""

    session_id: str
    prev: SolveResult            # carries _warmstart_meta across the chain
    epoch: int                   # acked after every applied step
    catalog_epoch: int
    provisioners: Sequence
    instance_types: Sequence
    daemonsets: Sequence = ()
    #: every offering ever ICE'd onto this chain (establishment set + each
    #: step's wire set): re-passed on every step so a guard-trip full
    #: fallback — which drops the chain meta — cannot forget an ICE
    unavailable: set = field(default_factory=set)
    last_used: float = 0.0
    #: True while a delta step is mid-mutation on this chain.  Written by
    #: the dispatcher only; read by the snapshot writer so an epoch-atomic
    #: snapshot SKIPS a half-applied chain (a SIGTERM landing mid-step
    #: must never persist it — docs/RESILIENCE.md).  Transient: never
    #: serialized.
    in_step: bool = False
    #: adoption provenance: how this
    #: entry arrived ("" established here, "adopted" free-lease claim,
    #: "stolen" expired-lease steal) and WHOSE lease guarded the record —
    #: the /statusz session block and the session_adopt/session_steal
    #: lifecycle spans read these so a failed-over chain's journey is
    #: diagnosable without grepping the spool
    adopt_how: str = ""
    adopted_from: str = ""
    #: per-incarnation identity, minted at establishment and persisted
    #: with the record.  The epoch exact-match check alone
    #: cannot survive a cross-replica re-home: a fresh table's epoch
    #: floor never saw this session's history, so a rolled-back old-
    #: incarnation record can collide with the new chain's acked epoch
    #: and pass the check — the nonce pins WHICH incarnation an epoch
    #: belongs to.  Empty = legacy (pre-nonce client/record): wildcard,
    #: semantics, so mixed-version fleets degrade instead of
    #: hard-failing.
    nonce: str = ""


@dataclass
class DeltaReply:
    """Detached response view the dispatcher hands the RPC thread.

    ``full`` replies (establish / reseed / guard-trip fallback) carry the
    whole solution; incremental replies carry ONLY the step's changes —
    (re)placed watch pods in ``assignments``/``infeasible``, nodes the
    step created in ``nodes``, proposal nodes it pruned in
    ``removed_nodes`` — and the client merges them into its ledger.
    Every container here is a copy: the session chain mutates under the
    next delta while the RPC thread is still encoding this one."""

    state: str                    # "ok" | "unknown" | "" (delta off)
    epoch: int = 0
    mode: str = ""                # noop|host|scan|full|establish|reseed
    full: bool = True             # replace-wholesale vs merge
    assignments: Dict[str, str] = field(default_factory=dict)
    infeasible: Dict[str, str] = field(default_factory=dict)
    nodes: List[SimNode] = field(default_factory=list)
    removed_nodes: List[str] = field(default_factory=list)
    solve_ms: float = 0.0
    #: the session incarnation's nonce, echoed to the client on every
    #: reply so it can present it with the next step (empty = legacy)
    nonce: str = ""


class DeltaSessionTable:
    """Bounded, TTL-evicted map of live delta sessions (one per pipeline).

    Locking: the table dict is touched from the dispatcher (every
    session-routed RPC) and shutdown (``clear``), so every ``_sessions``
    access sits under ``_lock`` — ktlint KT015 pins this discipline and
    the KT_SANITIZE runtime watcher proxies the lock into the global
    order (analysis/sanitize.py LOCK_ORDER).  Entry CONTENTS are
    dispatcher-owned and never touched under the lock: holding it across
    a solve would serialize eviction behind device work."""

    def __init__(self, registry: Optional[Registry] = None,
                 clock: Optional[Clock] = None,
                 capacity: Optional[int] = None,
                 ttl_s: Optional[float] = None,
                 faults=None,
                 spool_dir: Optional[str] = None,
                 lease_s: Optional[float] = None,
                 replica: Optional[str] = None) -> None:
        self.registry = registry or default_registry
        self.clock = clock or Clock()
        if capacity is None:
            capacity = int(os.environ.get("KT_DELTA_SESSIONS",
                                          str(DEFAULT_SESSIONS)))
        if ttl_s is None:
            ttl_s = float(os.environ.get("KT_DELTA_TTL_S",
                                         str(DEFAULT_TTL_S)))
        self.capacity = max(1, capacity)
        self.ttl_s = max(0.0, ttl_s)
        #: default spool directory for snapshot/restore/adopt (callers may
        #: still pass an explicit dir — tests do); set by the pipeline to
        #: its backend-namespaced KT_SESSION_DIR
        self.spool_dir = spool_dir or ""
        if lease_s is None:
            lease_s = float(os.environ.get(
                "KT_SESSION_LEASE_S", str(snap.DEFAULT_LEASE_S)))
        #: ownership-lease TTL (KT_SESSION_LEASE_S): a dead replica's
        #: sessions become stealable this long after its last record
        #: write — the fleet's failover-warmness window
        self.lease_s = max(0.0, lease_s)
        #: this replica's lease-owner identity (KT_REPLICA_ID or a stable
        #: per-process id — see snapshot.replica_id)
        self.replica = replica or os.environ.get(
            "KT_REPLICA_ID", "") or snap.replica_id()
        #: KT_CATALOG_EPOCH pin: when set, records from any OTHER catalog
        #: epoch are refused — by the boot restore AND by adopt-on-miss
        #: (a failed-over chain packed against stale prices must not
        #: serve warm any more than a restored one may)
        cat = os.environ.get("KT_CATALOG_EPOCH", "")
        self.expected_catalog_epoch: Optional[int] = (
            int(cat) if cat else None)
        #: sids whose spool leases this table holds  # guarded-by: _lock
        self._owned: set = set()
        # fault-injection plane (docs/RESILIENCE.md): the null no-op plane
        # unless KT_FAULTS configures a chaos schedule; the pipeline hands
        # its own plane down so one schedule covers table + delta path
        self._faults = (faults if faults is not None
                        else faults_mod.plane(self.registry))
        #: injected clock skew, seconds (fault kind ``clock_jump``):
        #: added to every TTL/LRU timestamp read, so a jump ages the whole
        #: table at once — the mass-TTL-eviction adversary
        self._skew = 0.0  # guarded-by: _lock
        self._lock = threading.Lock()
        #: LRU order: oldest first  # guarded-by: _lock
        self._sessions: "OrderedDict[str, SessionEntry]" = OrderedDict()
        #: serializes spool WRITES (the background periodic writer vs the
        #: shutdown write): whoever starts last renames last, so a slow
        #: older capture can never replace a newer spool.  Never nested
        #: inside _lock (snapshot acquires it first, then _lock briefly
        #: for the capture).
        self._spool_lock = threading.Lock()
        #: strictly above every session epoch this table has ever issued,
        #: observed, restored, or evicted  # guarded-by: _lock
        self._epoch_floor = 1
        zero_init_metrics(self.registry)

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def _gauge_locked(self) -> None:
        self.registry.gauge(DELTA_SESSIONS).set(len(self._sessions))

    def _leases_gauge_locked(self) -> None:
        self.registry.gauge(SESSION_LEASES).set(float(len(self._owned)))

    def _note_epoch_locked(self, epoch: int) -> None:
        """Every epoch that leaves the table's sight (evicted, dropped,
        cleared) or enters it (put, restore) raises the establishment
        floor past it — see :meth:`next_epoch`."""
        if epoch + 1 > self._epoch_floor:
            self._epoch_floor = epoch + 1

    def next_epoch(self) -> int:
        """Establishment epoch: strictly above every epoch this table has
        ever issued, observed, restored, or evicted.  A re-established
        session can therefore NEVER advance back onto an epoch a stale
        incarnation reached — the epoch-collision path by which a stale
        spool (or a lost reply racing an eviction) could pass the exact-
        match check and silently diverge a chain is closed by
        construction."""
        with self._lock:
            for e in self._sessions.values():
                self._note_epoch_locked(e.epoch)
            return self._epoch_floor

    def _evict_expired_locked(self, now: float) -> None:
        if self.ttl_s <= 0:
            return
        dead = [sid for sid, e in self._sessions.items()
                if now - e.last_used > self.ttl_s]
        for sid in dead:
            self._note_epoch_locked(self._sessions[sid].epoch)
            if protocol._SINK is not None:
                protocol.emit(sid, "evict:ttl", replica=self.replica)
            del self._sessions[sid]
        if dead:
            self.registry.counter(DELTA_EVICTIONS).inc(
                {"reason": "ttl"}, value=float(len(dead)))

    def _table_fault(self) -> None:
        """Fire the session-table choke point (before taking the lock —
        the wipe effect re-enters via :meth:`clear`)."""
        effect = self._faults.fire("session_table")
        if effect is None:
            return
        if effect.kind == "session_wipe":
            self.clear("fault")
        elif effect.kind == "clock_jump":
            with self._lock:
                self._skew += effect.value

    def get(self, session_id: str) -> Optional[SessionEntry]:
        """Look up a live session (touches its TTL + LRU position); expired
        entries are evicted on the way."""
        if self._faults:
            self._table_fault()
        now = self.clock.now()
        with self._lock:
            now += self._skew
            self._evict_expired_locked(now)
            entry = self._sessions.get(session_id)
            if entry is not None:
                entry.last_used = now
                self._sessions.move_to_end(session_id)
            self._gauge_locked()
            return entry

    def put(self, entry: SessionEntry) -> None:
        """Insert or replace a session; LRU-evicts past capacity."""
        if self._faults:
            self._table_fault()
        now = self.clock.now()
        with self._lock:
            now += self._skew
            entry.last_used = now
            self._note_epoch_locked(entry.epoch)
            self._evict_expired_locked(now)
            self._sessions[entry.session_id] = entry
            self._sessions.move_to_end(entry.session_id)
            evicted = 0
            while len(self._sessions) > self.capacity:
                sid, old = self._sessions.popitem(last=False)
                self._note_epoch_locked(old.epoch)
                if protocol._SINK is not None:
                    protocol.emit(sid, "evict:capacity",
                                  replica=self.replica)
                evicted += 1
            if evicted:
                self.registry.counter(DELTA_EVICTIONS).inc(
                    {"reason": "capacity"}, value=float(evicted))
            self._gauge_locked()
        if protocol._SINK is not None:
            protocol.emit(entry.session_id, "establish",
                          replica=self.replica, epoch=entry.epoch)

    def drop(self, session_id: str, reason: str = "error") -> None:
        """Evict one session.  The error path: a delta step that raised
        mid-apply leaves the chain half-mutated at an UNCHANGED epoch —
        the client's cumulative retry would pass the epoch check and
        re-apply onto a corrupted base, so the only safe outcome is
        eviction (the client re-establishes with one full solve).  An
        error-evicted session's spool RECORD dies with it: the last
        committed epoch on disk is clean, but a poisoned chain's client
        must re-establish from ground truth, not re-adopt and re-apply
        onto state the server already failed to advance once — but ONLY
        when the record is actually OURS.  The lease is re-read under
        the spool lock first (pinned by the lease model's
        ``record-owner-safety`` invariant): a zombie whose lease was
        stolen while it was wedged may still be mid-step when the step
        fails, and unconditionally removing the record here would
        destroy the ADOPTER's durability — the one file that makes the
        real owner's chain survive ITS next crash.  A ``lease_lost``
        drop touches NO spool state — the record and lease belong to
        the new owner now."""
        with self._lock:
            gone = self._sessions.pop(session_id, None)
            if gone is not None:
                self._note_epoch_locked(gone.epoch)
                self.registry.counter(DELTA_EVICTIONS).inc(
                    {"reason": reason})
            self._owned.discard(session_id)
            self._leases_gauge_locked()
            self._gauge_locked()
        if gone is not None and reason == "error" and self.spool_dir:
            # ownership re-check + removal are one _spool_lock section so
            # they cannot interleave with a concurrent adoption
            with self._spool_lock:
                try:
                    lease = snap.lease_state(self.spool_dir, session_id)
                # ktlint: allow[KT005] an unreadable lease file defaults
                # to NOT ours — keeping a stale record costs one refused
                # adoption; removing an adopter's record loses a chain
                except Exception:  # noqa: BLE001
                    lease = {"owner": ""}
                owner = str((lease or {}).get("owner", "") or "")
                if owner == self.replica:
                    snap.remove_record(self.spool_dir, session_id)
                    snap.release_lease(self.spool_dir, session_id,
                                       self.replica)
        if gone is not None and protocol._SINK is not None:
            protocol.emit(session_id, "drop:" + reason,
                          replica=self.replica, epoch=gone.epoch)

    def clear(self, reason: str = "stop") -> None:
        """Evict everything.  The graceful-shutdown path (``stop``) also
        RELEASES every owned lease — records stay on disk, so a sibling
        (or the replacement replica) adopts each surviving session
        instantly instead of waiting out the lease TTL.  The injected
        ``fault`` wipe releases nothing: a real in-memory loss would
        not."""
        with self._lock:
            n = len(self._sessions)
            cleared = list(self._sessions)
            for e in self._sessions.values():
                self._note_epoch_locked(e.epoch)
            self._sessions.clear()
            if n:
                self.registry.counter(DELTA_EVICTIONS).inc(
                    {"reason": reason}, value=float(n))
            owned = list(self._owned)
            if reason == "stop":
                self._owned.clear()
            self._leases_gauge_locked()
            self._gauge_locked()
        if reason == "stop" and self.spool_dir:
            for sid in owned:
                snap.release_lease(self.spool_dir, sid, self.replica)
        if protocol._SINK is not None:
            for sid in cleared:
                protocol.emit(sid, "clear:" + reason,
                              replica=self.replica)

    # ---- durability + fleet handoff ----
    def snapshot(self, dir_path: Optional[str] = None) -> dict:
        """Write every quiescent session chain to its own record file
        under the KT_SESSION_DIR spool (epoch-atomic: write-temp + fsync
        + rename per record), claiming/renewing this replica's ownership
        lease on each.

        Needs NO scheduler lock, so the periodic write runs on a
        background thread and no serving path ever stalls behind pickle
        + fsync: each entry is pickled INDIVIDUALLY outside the table
        lock, and any chain a delta step touched during that window is
        discarded —

        - ``in_step`` at capture -> skipped (counted ``in_step``): the
          dispatcher sets the marker BEFORE its first mutation, so a
          chain mid-mutation is never even pickled;
        - pickle failure, or ``in_step``/``epoch`` moved by the time the
          entry's bytes are done -> discarded (counted ``torn``): a step
          that STARTED during pickling flips ``in_step`` first, and one
          that started AND committed moved the epoch — either way the
          possibly-inconsistent bytes are dropped;
        - lease renewal refused (counted ``lease_lost``): a sibling stole
          this session after our lease expired — the zombie-writer guard:
          the chain is DROPPED, never served again here and never spooled
          over the new owner's record.

        A skipped/torn session just costs its client one re-establish if
        the process dies before the next snapshot — the spool never
        carries a half-applied chain.  Records owned by this replica
        whose sessions have since been evicted are swept (record removed,
        lease released).  Returns ``{"written": n, "skipped": n}``.

        Concurrent writers (the background periodic thread, the shutdown
        write, adopt/own/handoff on the serving threads) serialize on
        ``_spool_lock`` PER RECORD — each claim+write is one locked
        section with a liveness + epoch re-check, so a slow older
        capture can never replace a newer record while a serving-thread
        adoption stalls behind at most one record's write, never a whole
        table pass."""
        dir_path = dir_path or self.spool_dir
        if not dir_path:
            return {}
        # a table spools to ONE directory for its lifetime; learning it
        # from the first explicit call keeps eviction/clear lease cleanup
        # working for callers that pass the dir per call (tests, scripts)
        self.spool_dir = self.spool_dir or dir_path
        # _spool_lock is taken PER ENTRY inside (around each claim +
        # write), never across the whole pass: adopt-on-miss and
        # establishment ownership run on the SERVING threads, and a pass
        # pickling KT_DELTA_SESSIONS chains must stall them by at most
        # one record's claim+write, not the whole table's
        return self._snapshot_impl(dir_path)

    def _snapshot_impl(self, dir_path: str) -> dict:
        t0 = time.perf_counter()
        with self._lock:
            live = list(self._sessions.values())
        skipped = self.registry.counter(SNAPSHOT_SKIPPED)
        writes = self.registry.counter(SNAPSHOT_WRITES)
        written, n_skipped, errored = 0, 0, False
        lease_lost: list = []
        for e in live:
            if e.in_step:
                n_skipped += 1
                skipped.inc({"reason": "in_step"})
                continue
            epoch0 = e.epoch
            try:
                blob = snap.pack_entry(dict(
                    session_id=e.session_id, prev=e.prev,
                    epoch=int(epoch0),
                    catalog_epoch=int(e.catalog_epoch),
                    provisioners=list(e.provisioners),
                    instance_types=list(e.instance_types),
                    daemonsets=list(e.daemonsets),
                    unavailable=set(e.unavailable),
                    nonce=str(e.nonce)))
            # ktlint: allow[KT005] a chain mutating under the pickler can
            # raise anything; the entry is discarded as torn and counted
            except Exception:  # noqa: BLE001
                blob = None
            if blob is None or e.in_step or e.epoch != epoch0:
                n_skipped += 1
                skipped.inc({"reason": "torn"})
                continue
            # the slow pickle above ran lock-free; the claim + write are
            # one _spool_lock section so they can never interleave with
            # a concurrent adopt/own/handoff of the SAME session — and a
            # session that left the table while we pickled (drain
            # handoff, eviction) is not re-spooled from its stale bytes
            with self._spool_lock:
                with self._lock:
                    gone = e.session_id not in self._sessions
                if gone:
                    continue
                if e.in_step or e.epoch != epoch0:
                    # the chain moved while we pickled OR while we waited
                    # for the spool lock (a concurrent pass/handoff may
                    # have written a NEWER record) — these bytes must not
                    # land
                    n_skipped += 1
                    skipped.inc({"reason": "torn"})
                    continue
                try:
                    snap.claim_lease(dir_path, e.session_id, self.replica,
                                     self.clock.now(), self.lease_s)
                except snap.LeaseHeld:
                    # stolen after our lease expired (a wedged interval,
                    # a paused container): the session belongs to its
                    # adopter now — write NOTHING over their record.
                    # The drop itself is deferred to after the locked
                    # section: drop("lease_lost") touches no spool state,
                    # and _spool_lock must stay single-acquisition
                    # (KT012) — drop("error") re-acquires it
                    n_skipped += 1
                    skipped.inc({"reason": "lease_lost"})
                    lease_lost.append(e.session_id)
                    continue
                except OSError:
                    # a wedged lease MUTEX (a claimant died inside the
                    # critical section; self-heals after the staleness
                    # breaker) is an infrastructure failure, NOT a lost
                    # lease — the session is KEPT and this pass simply
                    # could not refresh its record
                    logger.warning("lease mutex wedged for %s; record "
                                   "not refreshed this pass",
                                   e.session_id, exc_info=True)
                    errored = True
                    faults_mod.count_recovery(self.registry,
                                              "snapshot_write", "failed")
                    continue
                try:
                    rec = snap.pack([blob],
                                    catalog_epoch=int(e.catalog_epoch))
                    # spool-byte adversary (snapshot_corrupt/_truncate):
                    # mangles AFTER the checksum — restore must detect it
                    rec = self._faults.mangle("snapshot_write", rec)
                    snap.write_record(dir_path, e.session_id, rec)
                # ktlint: allow[KT005] a failing record write must never
                # take serving down; the previous record survives,
                # outcome counted
                except Exception:  # noqa: BLE001
                    logger.warning("session record write (%s) to %s "
                                   "failed", e.session_id, dir_path,
                                   exc_info=True)
                    errored = True
                    faults_mod.count_recovery(self.registry,
                                              "snapshot_write", "failed")
                    continue
                written += 1
                with self._lock:
                    self._owned.add(e.session_id)
                    self._leases_gauge_locked()
                if protocol._SINK is not None:
                    protocol.emit(e.session_id, "spool",
                                  replica=self.replica, epoch=epoch0)
        for sid in lease_lost:
            self.drop(sid, "lease_lost")
        # sweep: owned records whose sessions are GONE (ttl/capacity/
        # wipe-evicted between passes) must not outlive them — a stale
        # record resurrected later is the divergence class restore-once
        # exists to close.  Judged against the LIVE table under _lock,
        # never the pass-start capture: a session established or adopted
        # WHILE this pass pickled is live, and releasing its fresh lease
        # would hand it back to whatever zombie incarnation own() just
        # superseded.  Drain handoffs left _owned already, so a sibling's
        # adopted record is never swept.
        with self._lock:
            stale = [sid for sid in self._owned
                     if sid not in self._sessions]
        for sid in stale:
            snap.remove_record(dir_path, sid)
            snap.release_lease(dir_path, sid, self.replica)
            with self._lock:
                self._owned.discard(sid)
                self._leases_gauge_locked()
        self._gc_orphans(dir_path)
        if errored:
            writes.inc({"outcome": "error"})
        elif not written:
            writes.inc({"outcome": "empty"})
            if not n_skipped:
                self.registry.gauge(SNAPSHOT_SESSIONS).set(0.0)
        else:
            writes.inc({"outcome": "written"})
        if written:
            self.registry.gauge(SNAPSHOT_SESSIONS).set(float(written))
            self.registry.histogram(SNAPSHOT_DURATION).observe(
                time.perf_counter() - t0)
        return {"written": written, "skipped": n_skipped}

    def _gc_orphans(self, dir_path: str) -> None:
        """Expire ORPHANED records: a replica that died uncleanly and
        whose clients never came back leaves records nobody will ever
        adopt (boot restores stop at capacity, adoption is client-driven),
        and a shared PVC must not grow without bound.  A record is
        reaped when it is not ours, its bytes have not been refreshed
        for the session idle TTL (a live sibling rewrites records every
        snapshot pass, so a stale mtime means the writer is gone), AND
        its lease is free or expired.  The session's client — if it ever
        returns — pays one re-establish, exactly what TTL
        eviction has always cost.  Disabled with the TTL (ttl_s=0)."""
        if self.ttl_s <= 0:
            return
        now = self.clock.now()
        for sid in snap.list_sessions(dir_path):
            with self._lock:
                if sid in self._owned or sid in self._sessions:
                    continue
            # the reap decision + removal are one _spool_lock section, so
            # it fully serializes against an in-flight adoption of the
            # same record (adopt holds the lock end to end); the checks
            # re-run inside
            with self._spool_lock:
                age = snap.record_age_s(dir_path, sid)
                if age is None or age <= max(self.ttl_s, self.lease_s):
                    continue
                lease = snap.lease_state(dir_path, sid)
                if lease is not None \
                        and float(lease.get("expires_at", 0.0)) > now:
                    # ANY unexpired lease — a live sibling's, or our own
                    # serving thread's in-flight adoption — is hands-off
                    continue
                snap.remove_record(dir_path, sid)
                snap.release_lease(dir_path, sid,
                                   str((lease or {}).get("owner", "")))
            if protocol._SINK is not None:
                protocol.emit(sid, "reap", replica=self.replica)
            self.registry.counter(DELTA_EVICTIONS).inc({"reason": "ttl"})
            logger.info("reaped orphaned session record %s (idle %.0fs)",
                        sid, age)

    def restore(self, dir_path: Optional[str] = None,
                expected_catalog_epoch: Optional[int] = None) -> int:
        """Rehydrate the table from the spool at startup: scan the
        session records and ADOPT each one whose lease this replica can
        claim.  Sibling-owned sessions (unexpired foreign lease) are left
        untouched — on a shared volume a boot-time restore must never
        poach a live replica's chains.  Records past this table's
        capacity are also left ON DISK with their leases unclaimed, so a
        sibling can adopt what we cannot hold (whole-file spool
        deleted capacity-evicted entries; on a shared spool that would
        destroy a sibling's sessions).  Every envelope refusal (corrupt /
        truncated / version skew / stale catalog epoch) is a counted COLD
        START for that record only — never a crash, never a diverged
        chain.  Returns the number of sessions restored."""
        dir_path = dir_path or self.spool_dir
        if dir_path:
            self.spool_dir = self.spool_dir or dir_path
        if expected_catalog_epoch is None:
            expected_catalog_epoch = self.expected_catalog_epoch
        t0 = time.perf_counter()
        sids = snap.list_sessions(dir_path) if dir_path else []
        if not sids:
            self.registry.counter(SNAPSHOT_RESTORE).inc(
                {"outcome": "missing"})
            return 0
        restored = 0
        for sid in sids:
            if len(self) >= self.capacity:
                # full: leave the remaining records (and their leases)
                # for siblings — adoption respects capacity, it never
                # adopt-then-evicts someone else's chain off the disk
                break
            if self._adopt_impl(dir_path, sid,
                                expected_catalog_epoch) is not None:
                restored += 1
        if restored:
            self.registry.counter(SNAPSHOT_RESTORE).inc(
                {"outcome": "restored"})
            self.registry.histogram(SNAPSHOT_DURATION).observe(
                time.perf_counter() - t0)
            logger.info("restored %d delta session(s) from %s", restored,
                        dir_path)
        return restored

    def adopt(self, dir_path: Optional[str] = None,
              session_id: str = "") -> Optional[SessionEntry]:
        """On-demand single-session adoption — the fleet-failover path:
        a session-routed RPC missing the table tries the shared spool
        before answering ``session_unknown``, so the replica a client
        re-homed to (replica death, graceful drain) serves the next delta
        WARM.  Exactly-one-owner is the lease protocol's job: a free
        lease is claimed, an expired one stolen (counted — the dead-
        replica path), an unexpired foreign one refuses typed (counted
        ``lease_held``; the caller answers unknown and the client pays
        exactly-one re-establish).  Returns the live entry or
        None."""
        dir_path = dir_path or self.spool_dir
        if not dir_path or not session_id:
            return None
        self.spool_dir = self.spool_dir or dir_path
        with self._spool_lock:
            return self._adopt_impl(dir_path, session_id,
                                    self.expected_catalog_epoch)

    def _adopt_impl(self, dir_path: str, session_id: str,
                    expected_catalog_epoch: Optional[int] = None,
                    ) -> Optional[SessionEntry]:
        adoptions = self.registry.counter(SESSION_ADOPTIONS)

        def _count(outcome: str) -> None:
            adoptions.inc({"outcome": outcome})

        if not snap.record_exists(dir_path, session_id):
            # the COMMON miss (a genuinely unknown session — every
            # session_unknown RPC retries this path) short-circuits to
            # one stat: the lease claim's ~6 shared-volume file ops are
            # only paid when there is actually a record to adopt.  The
            # post-claim read below still guards the consumed-between
            # race.
            _count("missing")
            return None
        # provenance BEFORE the claim rewrites it: whose lease guarded the
        # record is the "adopted_from" the lifecycle span + /statusz show
        try:
            prior = snap.lease_state(dir_path, session_id)
        # ktlint: allow[KT005] provenance is observability, not protocol —
        # an unreadable lease file must not fail the adoption
        except Exception:  # noqa: BLE001
            prior = None
        prior_owner = str((prior or {}).get("owner", "") or "")
        if self._faults:
            effect = self._faults.fire("adopt")
            if effect is not None and effect.kind == "lease_steal":
                # the contention adversary: a sibling claims the lease an
                # instant before we do — our claim below must refuse
                try:
                    snap.claim_lease(dir_path, session_id,
                                     "injected-contender",
                                     self.clock.now(), effect.value)
                except snap.LeaseHeld:
                    pass  # someone (maybe us) already holds it — fine
        try:
            how = snap.claim_lease(dir_path, session_id, self.replica,
                                   self.clock.now(), self.lease_s)
        except snap.LeaseHeld as held:
            logger.info("session %s not adopted: lease held by %s",
                        session_id, held.owner)
            _count("lease_held")
            if protocol._SINK is not None:
                protocol.emit(session_id, "adopt_refused",
                              replica=self.replica, owner=held.owner)
            return None
        except OSError:
            # wedged lease mutex: typed cold outcome (the client pays
            # the one re-establish), never an untyped dispatcher error
            logger.warning("lease mutex wedged adopting %s; serving "
                           "cold", session_id, exc_info=True)
            _count("error")
            faults_mod.count_recovery(self.registry, "snapshot_read",
                                      "cold")
            return None
        try:
            blob = snap.read_record(dir_path, session_id)
            if blob is None:
                _count("missing")
                if how != "renewed":
                    snap.release_lease(dir_path, session_id, self.replica)
                return None
            raw_entries, _epoch = snap.unpack(
                blob, expected_catalog_epoch=expected_catalog_epoch)
            d = snap.unpack_entry(raw_entries[0])
            # a restarted process's auto-name counter starts at 0: advance
            # it past every adopted node index so a fresh proposal can
            # never collide with (and silently cross-wire) a chain node
            prev = d.get("prev")
            meta = getattr(prev, "_warmstart_meta", None)
            names = [n.name for n in
                     list(getattr(prev, "nodes", ()) or ())
                     + list(getattr(prev, "existing_nodes", ()) or ())]
            if meta is not None:
                names += [n.name for n in meta.nodes]
            max_idx = -1
            for nm in names:
                if nm.startswith("node-"):
                    try:
                        max_idx = max(max_idx, int(nm[5:]))
                    except ValueError:
                        pass
            if max_idx >= 0:
                advance_node_counter(max_idx)
            now = self.clock.now()
            entry = SessionEntry(
                session_id=d["session_id"], prev=d["prev"],
                epoch=int(d["epoch"]),
                catalog_epoch=int(d["catalog_epoch"]),
                provisioners=d["provisioners"],
                instance_types=d["instance_types"],
                daemonsets=tuple(d.get("daemonsets") or ()),
                unavailable=set(d.get("unavailable") or ()),
                adopt_how="stolen" if how == "stolen" else "adopted",
                adopted_from=(prior_owner
                              if prior_owner != self.replica else ""),
                # legacy (pre-nonce) records adopt with the wildcard
                nonce=str(d.get("nonce", "") or ""),
            )
            with self._lock:
                entry.last_used = now + self._skew
                # the establishment floor clears every adopted epoch: a
                # session re-established after adoption can never advance
                # back onto an epoch its old incarnation reached (the
                # epoch-collision divergence class)
                self._note_epoch_locked(entry.epoch)
                self._sessions[entry.session_id] = entry
                self._sessions.move_to_end(entry.session_id)
                self._owned.add(entry.session_id)
                evicted = 0
                while len(self._sessions) > self.capacity:
                    _sid, old = self._sessions.popitem(last=False)
                    self._note_epoch_locked(old.epoch)
                    evicted += 1
                if evicted:
                    self.registry.counter(DELTA_EVICTIONS).inc(
                        {"reason": "capacity"}, value=float(evicted))
                self._leases_gauge_locked()
                self._gauge_locked()
            # adopt-once: the record is CONSUMED — the chain mutates from
            # here on, and a later crash that never wrote a fresh record
            # must cold-start rather than resurrect this now-stale file
            # (the stale-spool divergence class); our periodic snapshot
            # re-creates it at the next committed epoch
            snap.remove_record(dir_path, session_id)
            _count("stolen" if how == "stolen" else "adopted")
            if protocol._SINK is not None:
                protocol.emit(
                    session_id,
                    "steal" if how == "stolen" else "adopt",
                    replica=self.replica, epoch=entry.epoch,
                    adopted_from=entry.adopted_from)
            return entry
        except snap.SnapshotRefused as err:
            logger.warning("session record %s refused; serving cold: %s",
                           session_id, err)
            self.registry.counter(SNAPSHOT_RESTORE).inc(
                {"outcome": err.reason})
            _count("refused")
            faults_mod.count_recovery(self.registry, "snapshot_read",
                                      "cold")
            if how != "renewed":
                snap.release_lease(dir_path, session_id, self.replica)
            return None
        # ktlint: allow[KT005] an unexpectedly-shaped record is the same
        # outcome as a corrupt one: counted cold start, never a crash
        except Exception:  # noqa: BLE001
            logger.warning("session record %s adoption failed; serving "
                           "cold", session_id, exc_info=True)
            self.registry.counter(SNAPSHOT_RESTORE).inc(
                {"outcome": "error"})
            _count("error")
            faults_mod.count_recovery(self.registry, "snapshot_read",
                                      "cold")
            if how != "renewed":
                snap.release_lease(dir_path, session_id, self.replica)
            return None

    def handoff(self, session_id: str,
                dir_path: Optional[str] = None) -> bool:
        """Graceful-drain handoff of ONE session: spool its record at the
        current (committed) epoch, RELEASE the lease so any sibling
        adopts instantly, and drop the entry (evicted ``drain``) so this
        replica can never serve another epoch of a chain it just gave
        away.  The client saw ``session_state="draining"`` on the same
        reply and re-homes; the adopting replica restores the record and
        serves its next delta WARM.  Returns True when the chain was
        handed off."""
        dir_path = dir_path or self.spool_dir
        if not dir_path:
            return False
        lost = False
        with self._spool_lock:
            with self._lock:
                e = self._sessions.get(session_id)
                if e is None or e.in_step:
                    return False
                blob_src = dict(
                    session_id=e.session_id, prev=e.prev,
                    epoch=int(e.epoch),
                    catalog_epoch=int(e.catalog_epoch),
                    provisioners=list(e.provisioners),
                    instance_types=list(e.instance_types),
                    daemonsets=list(e.daemonsets),
                    unavailable=set(e.unavailable),
                    nonce=str(e.nonce))
                catalog_epoch = int(e.catalog_epoch)
                epoch0 = int(e.epoch)
            try:
                snap.claim_lease(dir_path, session_id, self.replica,
                                 self.clock.now(), self.lease_s)
                rec = snap.pack([snap.pack_entry(blob_src)],
                                catalog_epoch=catalog_epoch)
                rec = self._faults.mangle("snapshot_write", rec)
                snap.write_record(dir_path, session_id, rec)
            except snap.LeaseHeld:
                # a sibling already owns it (stolen while we were
                # wedged): drop without touching their spool state.  The
                # drop runs AFTER the locked section (below): _spool_lock
                # must stay single-acquisition (KT012) and drop("error")
                # re-takes it
                lost = True
            # ktlint: allow[KT005] a failing handoff write degrades to the
            # stop()-path snapshot (the session stays until shutdown);
            # counted so a drain that cannot spool is visible
            except Exception:  # noqa: BLE001
                logger.warning("drain handoff of %s failed; session kept "
                               "for the shutdown snapshot", session_id,
                               exc_info=True)
                faults_mod.count_recovery(self.registry, "snapshot_write",
                                          "failed")
                return False
            if not lost:
                snap.release_lease(dir_path, session_id, self.replica)
                with self._lock:
                    gone = self._sessions.pop(session_id, None)
                    if gone is not None:
                        self._note_epoch_locked(gone.epoch)
                        self.registry.counter(DELTA_EVICTIONS).inc(
                            {"reason": "drain"})
                    self._owned.discard(session_id)
                    self._leases_gauge_locked()
                    self._gauge_locked()
                if protocol._SINK is not None:
                    protocol.emit(session_id, "handoff",
                                  replica=self.replica, epoch=epoch0)
                return True
        self.drop(session_id, "lease_lost")
        faults_mod.count_recovery(self.registry, "snapshot_write",
                                  "skipped")
        return False

    def own(self, session_id: str,
            dir_path: Optional[str] = None) -> None:
        """Take spool ownership of a just-ESTABLISHED session: force-claim
        the lease (the client re-established HERE, so any incarnation a
        sibling's lease guarded is obsolete by the client's own
        authority) and discard the obsolete record.  Without this, a
        session re-established away from its lease holder livelocks:
        the holder renews forever over a zombie entry while the serving
        replica's every snapshot drops the live chain as lease-lost."""
        dir_path = dir_path or self.spool_dir
        if not dir_path:
            return
        with self._spool_lock:
            try:
                snap.claim_lease(dir_path, session_id, self.replica,
                                 self.clock.now(), self.lease_s,
                                 force=True)
            # ktlint: allow[KT005] a lost claim race or I/O failure just
            # defers ownership to the next snapshot pass; serving goes on
            except Exception:  # noqa: BLE001
                logger.warning("could not take spool ownership of %s",
                               session_id, exc_info=True)
                return
            snap.remove_record(dir_path, session_id)
            with self._lock:
                self._owned.add(session_id)
                self._leases_gauge_locked()
        if protocol._SINK is not None:
            protocol.emit(session_id, "claim", replica=self.replica)

    def leases_owned(self) -> int:
        with self._lock:
            return len(self._owned)

    def sessions_status(self) -> Dict[str, dict]:
        """Per-session diagnostic view for the /statusz session block:
        chain epoch, seconds since the last served delta,
        the current lease owner (this replica when we hold the spool
        lease), and — for failed-over chains — which replica it was
        adopted/stolen from, so a stuck chain is diagnosable from one
        HTTP GET instead of grepping the spool.  Reads table state only
        (no disk); entry CONTENTS are limited to scalars the dispatcher
        writes atomically, so the snapshot under ``_lock`` is safe."""
        now = self.clock.now()
        with self._lock:
            now += self._skew
            return {
                sid: {
                    "epoch": int(e.epoch),
                    "last_delta_age_s": round(max(0.0, now - e.last_used),
                                              3),
                    "lease_owner": (self.replica if sid in self._owned
                                    else ""),
                    "adopted_from": e.adopted_from,
                    "adopt_how": e.adopt_how,
                    "in_step": bool(e.in_step),
                }
                for sid, e in self._sessions.items()
            }


def zero_init_metrics(registry: Registry) -> None:
    """Register every delta-serving series at 0 from construction (KT003:
    a counter born at its first increment loses that increment to
    rate()/increase())."""
    rpc = registry.counter(DELTA_RPC)
    for outcome in DELTA_RPC_OUTCOMES:
        if not rpc.has({"outcome": outcome}):
            rpc.inc({"outcome": outcome}, value=0.0)
    evict = registry.counter(DELTA_EVICTIONS)
    for reason in DELTA_EVICT_REASONS:
        if not evict.has({"reason": reason}):
            evict.inc({"reason": reason}, value=0.0)
    gauge = registry.gauge(DELTA_SESSIONS)
    if not gauge.has():
        gauge.set(0)
    registry.histogram(DELTA_RPC_DURATION)
    # session durability families: the first snapshot write /
    # restore refusal of a replica's life must survive rate()
    writes = registry.counter(SNAPSHOT_WRITES)
    for outcome in SNAPSHOT_WRITE_OUTCOMES:
        if not writes.has({"outcome": outcome}):
            writes.inc({"outcome": outcome}, value=0.0)
    skipped = registry.counter(SNAPSHOT_SKIPPED)
    for reason in SNAPSHOT_SKIP_REASONS:
        if not skipped.has({"reason": reason}):
            skipped.inc({"reason": reason}, value=0.0)
    restore = registry.counter(SNAPSHOT_RESTORE)
    for outcome in SNAPSHOT_RESTORE_OUTCOMES:
        if not restore.has({"outcome": outcome}):
            restore.inc({"outcome": outcome}, value=0.0)
    sg = registry.gauge(SNAPSHOT_SESSIONS)
    if not sg.has():
        sg.set(0)
    registry.histogram(SNAPSHOT_DURATION)
    # fleet-handoff families: the first adoption/steal of a
    # replica's life must survive rate()
    adoptions = registry.counter(SESSION_ADOPTIONS)
    for outcome in SESSION_ADOPTION_OUTCOMES:
        if not adoptions.has({"outcome": outcome}):
            adoptions.inc({"outcome": outcome}, value=0.0)
    lg = registry.gauge(SESSION_LEASES)
    if not lg.has():
        lg.set(0)
    # recovery-outcome population (KT016's funnel is live in production —
    # organic faults count too, so the series must exist from birth)
    faults_mod.zero_init_recovery(registry)
