"""Explicit-state model checking for the serving protocols.

The serving stack carries three distributed protocols — the
delta-session epoch protocol, the lease/claim/steal/drain failover state
machine, and the spool durability rules threaded through both.  The port
speaks them unchanged (the same wire, the same spool rules), so the
models are the reference's.  Each class of race they guard against
(zombie-writer, lease livelock, unacked-removal divergence) is subtle
enough that review alone misses it.  This module checks them by machine:
hand-written MODELS of both
protocols, explored by bounded exhaustive DFS over every interleaving of
client sends, server steps, crashes, lease expiries, steals, drains and
spool rollbacks, checking the invariants the reviews enforced informally:

- **exactly-one lease winner** — a spool record is adopted at most once;
  concurrent adopters race through the lease and exactly one wins;
- **epoch monotonicity** — a table never re-issues an epoch it has ever
  seen (the ``next_epoch`` floor), and across replicas the session nonce
  refuses a superseded incarnation's state;
- **no serve from a half-mutated chain** — a mid-step chain is never
  snapshotted (``in_step`` guard) and never serves;
- **a drained session is never served by the drainer** — after a drain
  handoff the draining replica never commits another epoch of that chain
  (the client re-homes on the ``draining`` hint and fleet routing avoids
  draining replicas);
- **cumulative-retry convergence** — whatever is lost, shed, crashed or
  rolled back, an applied step is applied onto exactly the base the
  client believes in: divergence is impossible, only typed re-establishes.

Every invariant has a *seeded-violation twin*: a config flag that removes
the guard the implementation actually has (``use_nonce=False``,
``owner_checked_drop=False``, ...), under which the DFS must FIND a
counterexample — proving the checker has teeth, and pinning the two real
divergences the guards close (the cross-replica epoch-collision closed by
the session nonce, and the zombie ``drop("error")`` clobbering the
adopter's spool record).

Like the rest of ``analysis/``, this module is pure stdlib — it must
import neither torch nor numpy nor grpc, so the checker runs anywhere the
linter does (the card's host included).

Conformance (``analysis/conformance.py``) closes the loop with reality:
the implementation emits transition events (``obs/protocol.py``) and the
checker asserts every OBSERVED per-session event sequence is a path of
:data:`SESSION_AUTOMATON` — which is itself validated against the lease
model here by an edge-wise simulation relation (``simulate_automaton``),
so model, automaton and implementation stay mutually consistent.

CLI: ``python -m karpenter_tpu_torch.analysis --model [--format json]``
— prints states, transitions, invariants and (on
violation) a minimal counterexample trace; the state-space size is
published so a silently shrinking exploration is visible in review.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Violation:
    """One invariant violation with its minimal-ish counterexample: the
    action labels from the initial state to the violating state (DFS
    parent chain — not guaranteed shortest, but complete and replayable
    by hand against the model's action semantics)."""

    invariant: str
    message: str
    trace: Tuple[str, ...]

    def format(self) -> str:
        steps = "\n".join(f"  {i + 1:2d}. {a}"
                          for i, a in enumerate(self.trace))
        return (f"invariant violated: {self.invariant}\n"
                f"  {self.message}\ncounterexample "
                f"({len(self.trace)} steps):\n{steps}")


@dataclass
class Result:
    """One bounded-exhaustive exploration: how much was explored and the
    first violation found (None = every reachable state satisfies every
    invariant)."""

    model: str
    states: int
    transitions: int
    violation: Optional[Violation]
    elapsed_s: float
    truncated: bool = False  # state cap hit: NOT exhaustive

    @property
    def ok(self) -> bool:
        return self.violation is None and not self.truncated

    def to_json(self) -> dict:
        out = {
            "model": self.model,
            "states": self.states,
            "transitions": self.transitions,
            "exhaustive": not self.truncated,
            "ok": self.ok,
            "elapsed_ms": round(self.elapsed_s * 1000.0, 1),
        }
        if self.violation is not None:
            out["violation"] = {
                "invariant": self.violation.invariant,
                "message": self.violation.message,
                "trace": list(self.violation.trace),
            }
        return out


def explore(model, max_states: int = 500_000) -> Result:
    """Bounded exhaustive DFS over ``model``'s reachable state space.

    ``model`` supplies ``name``, ``init() -> state``, ``actions(state) ->
    iterable[(label, state)]`` and ``invariants: [(name, predicate)]``
    where a predicate returns an error message (violated) or None.
    States must be hashable values; the search memoizes parents for
    counterexample reconstruction.  Exceeding ``max_states`` marks the
    result truncated — callers gating on ``ok`` treat that as a failure,
    never as a silently smaller proof."""
    t0 = time.perf_counter()
    init = model.init()
    parents: Dict[object, Optional[Tuple[object, str]]] = {init: None}
    stack = [init]
    transitions = 0
    truncated = False

    def _trace(state) -> Tuple[str, ...]:
        labels: List[str] = []
        cur = state
        while True:
            link = parents[cur]
            if link is None:
                break
            cur, label = link
            labels.append(label)
        return tuple(reversed(labels))

    while stack:
        s = stack.pop()
        for inv_name, pred in model.invariants:
            msg = pred(s)
            if msg is not None:
                return Result(model.name, len(parents), transitions,
                              Violation(inv_name, msg, _trace(s)),
                              time.perf_counter() - t0, truncated)
        for label, s2 in model.actions(s):
            transitions += 1
            if s2 not in parents:
                if len(parents) >= max_states:
                    truncated = True
                    continue
                parents[s2] = (s, label)
                stack.append(s2)
    return Result(model.name, len(parents), transitions, None,
                  time.perf_counter() - t0, truncated)


# ---------------------------------------------------------------------------
# toy model — a deliberately broken protocol proving the DFS finds bugs
# ---------------------------------------------------------------------------


class BrokenCounterModel:
    """Two clients increment a shared counter read-modify-write with no
    compare-and-swap: the classic lost update.  Exists so the test suite
    can prove the ENGINE finds counterexamples — a checker that passes
    everything proves nothing."""

    name = "toy-broken-counter"

    def init(self):
        # (counter, done_writes, (c1_local, c2_local))  local=None: idle
        return (0, 0, (None, None))

    def actions(self, s):
        counter, done, locals_ = s
        for i in (0, 1):
            if locals_[i] is None and done + sum(
                    1 for v in locals_ if v is not None) < 2:
                held = list(locals_)
                held[i] = counter
                yield (f"c{i}_read", (counter, done, tuple(held)))
            elif locals_[i] is not None:
                held = list(locals_)
                held[i] = None
                yield (f"c{i}_write",
                       (locals_[i] + 1, done + 1, tuple(held)))

    invariants = (
        ("no-lost-update",
         lambda s: (None if s[0] == s[1]
                    else f"counter={s[0]} after {s[1]} completed "
                         "increments — an update was lost")),
    )


# ---------------------------------------------------------------------------
# model A — the delta-session epoch protocol (with the spool)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EpochConfig:
    """Bounds and guard switches for :class:`EpochModel`.

    The default config models the implementation AS SHIPPED (all guards
    on); each ``False`` switch removes one real guard so the matching
    invariant's seeded-violation fixture can prove the DFS finds the
    historical bug:

    - ``use_nonce=False`` — PRE-FIX wire protocol (no session nonce):
      the cross-replica epoch collision (a rolled-back spool record whose
      epoch coincides with a new incarnation's ack) silently diverges.
      The checker finds it; the nonce fields on the wire close it.
    - ``use_floor=False`` — establishment epochs restart at 1 instead of
      the ``next_epoch`` floor: epoch monotonicity per table breaks.
    - ``snapshot_guard=False`` — the spool writer ignores ``in_step``: a
      half-mutated chain lands on disk.
    """

    sends: int = 3        # client perturbations issued
    losses: int = 1       # replies the network may drop
    crashes: int = 2      # replica crashes / client re-homes (floor lost)
    rollbacks: int = 1    # PVC-restore adversary re-installing a record
    evicts: int = 1       # TTL/capacity eviction (floor kept)
    fails: int = 1        # mid-step failures (drop-with-reason-error)
    archives: int = 1     # backup copies the rollback adversary may take
    use_nonce: bool = True
    use_floor: bool = True
    snapshot_guard: bool = True


@dataclass(frozen=True)
class EpochState:
    """The composed client+server+spool state for ONE session.

    The chain's applied perturbations are a tuple of client-issued pid
    ints — equality of ``entry.applied`` and the client's ``view`` IS the
    convergence invariant.  ``wire`` is the single in-flight RPC (the
    client facade is synchronous by contract).  Flags latch an invariant
    violation at the action that commits it, so invariants stay plain
    state predicates."""

    entry: Optional[tuple]    # (epoch, nonce, applied, in_step, staged)
    record: Optional[tuple]   # (epoch, nonce, applied)
    archived: Optional[tuple]  # the PVC-backup adversary's copy: any one
                               # record version, restorable by rollback
    floor: int                # table's next_epoch floor (crash resets)
    max_issued: int           # highest epoch this table issued/observed
    ack: int
    cnonce: int
    view: tuple
    pending: tuple
    next_pid: int
    next_nonce: int
    wire: Optional[tuple]     # ("req",b,n,pids)|("ok",e,n,pids)|
                              # ("unknown",)|("error",)
    sends: int
    losses: int
    crashes: int
    rollbacks: int
    evicts: int
    fails: int
    archives: int
    diverged: str = ""
    torn: str = ""
    non_monotone: str = ""


class EpochModel:
    """Delta-session epochs: cumulative client retry, exact-match epoch
    check, ``next_epoch`` floor, epoch-atomic spool snapshot, adopt-once
    record consumption, and (post-fix) the per-incarnation session nonce.

    Establishment is modeled atomically (unknown reply -> re-established
    entry) — a full solve is idempotent from the client's ground-truth
    ledger, so interleaving its own RPC adds states without adding
    behaviors.  A crash models both a replica restart and a fleet
    re-home: either way the chain lands on a table whose in-memory epoch
    floor never saw this session's history, which is exactly the gap the
    session nonce closes."""

    name = "delta-epoch"

    #: conformance projection — which transition events (obs/protocol.py
    #: vocabulary) each action label's real counterpart emits
    EVENTS = {
        "establish": ("establish", "claim"),
        "commit": ("commit",),
        "serve_unknown": ("serve_unknown",),
        "serve_adopt_unknown": ("adopt", "serve_unknown"),
        "step_fail": ("drop:error",),
        "snapshot": ("spool",),
        "evict": ("evict:ttl",),
    }

    def __init__(self, cfg: EpochConfig = EpochConfig()):
        self.cfg = cfg
        self.invariants = (
            ("cumulative-retry-convergence",
             lambda s: s.diverged or None),
            ("no-half-mutated-snapshot",
             lambda s: s.torn or None),
            ("epoch-monotonicity",
             lambda s: s.non_monotone or None),
        )

    def init(self) -> EpochState:
        cfg = self.cfg
        # established session at epoch 1, nonce 1, empty chain
        return EpochState(
            entry=(1, 1, (), False, ()), record=None, archived=None,
            floor=2, max_issued=1, ack=1, cnonce=1, view=(), pending=(),
            next_pid=1, next_nonce=2, wire=None, sends=cfg.sends,
            losses=cfg.losses, crashes=cfg.crashes,
            rollbacks=cfg.rollbacks, evicts=cfg.evicts, fails=cfg.fails,
            archives=cfg.archives)

    # -- helpers ---------------------------------------------------------
    def _issue(self, s: EpochState, epoch: int, **kw) -> dict:
        """The ``next_epoch`` contract check: an ESTABLISHMENT epoch must
        be strictly above every epoch this table lifetime ever issued or
        observed.  (Commits may legitimately re-reach an epoch number by
        adopt-replay of the same chain after a lost reply — same lineage,
        same content — so only establishment is checked; commits and
        adoptions still RAISE the observed-epoch watermark.)"""
        out = dict(kw)
        if epoch <= s.max_issued:
            out["non_monotone"] = (
                f"establishment issued epoch {epoch} (max epoch ever "
                f"seen by this table lifetime: {s.max_issued}) — a "
                "stale exact-match check can now pass against old state")
        out["max_issued"] = max(s.max_issued, epoch)
        return out

    def actions(self, s: EpochState) -> Iterable[Tuple[str, EpochState]]:
        cfg = self.cfg
        # ---- client ----------------------------------------------------
        if s.wire is None:
            if s.sends > 0:
                pid = s.next_pid
                pend = s.pending + (pid,)
                yield (f"send(p{pid})", replace(
                    s, pending=pend, next_pid=pid + 1, sends=s.sends - 1,
                    wire=("req", s.ack, s.cnonce, pend)))
            if s.pending:
                # cumulative retry after a lost/errored reply: the SAME
                # unacked perturbation set, never a new pid
                yield ("resend", replace(
                    s, wire=("req", s.ack, s.cnonce, s.pending)))
        elif s.wire[0] == "ok":
            _, epoch, nonce, pids = s.wire
            yield ("recv_ok", replace(
                s, ack=epoch, cnonce=nonce, view=s.view + pids,
                pending=(), wire=None))
        elif s.wire[0] == "error":
            # typed step failure / transport error: session + pending
            # kept (service/client.DeltaSession._rpc contract)
            yield ("recv_error", replace(s, wire=None))
        elif s.wire[0] == "unknown":
            # exactly-one transparent re-establish: full solve from the
            # client's ground truth; own() force-claims and removes the
            # obsolete record; next_epoch() sweeps live entries into the
            # floor before issuing (delta.DeltaSessionTable.next_epoch)
            epoch0 = (max(s.floor, s.entry[0] + 1 if s.entry else 0)
                      if cfg.use_floor else 1)
            nonce = s.next_nonce
            full = s.view + s.pending
            yield ("establish", replace(
                s, entry=(epoch0, nonce, full, False, ()), record=None,
                floor=max(s.floor, epoch0 + 1), ack=epoch0, cnonce=nonce,
                view=full, pending=(), next_nonce=nonce + 1, wire=None,
                **self._issue(s, epoch0)))
        # ---- server ----------------------------------------------------
        if s.wire is not None and s.wire[0] == "req" and (
                s.entry is None or not s.entry[3]):
            _, base, rnonce, pids = s.wire
            entry, record, floor, label = s.entry, s.record, s.floor, ""
            adopted = False
            if entry is None and record is not None:
                # adopt-on-miss precedes the unknown answer, always
                # (server._serve_delta); the record is CONSUMED
                entry = (record[0], record[1], record[2], False, ())
                floor = max(floor, record[0] + 1)
                record, adopted = None, True
            nonce_ok = (not cfg.use_nonce or entry is None
                        or not (entry[1] and rnonce)
                        or entry[1] == rnonce)
            if entry is None or entry[0] != base or not nonce_ok:
                label = ("serve_adopt_unknown" if adopted
                         else "serve_unknown")
                yield (label, replace(
                    s, entry=entry, record=record, floor=floor,
                    wire=("unknown",),
                    max_issued=max(s.max_issued,
                                   entry[0] if entry else 0)))
            else:
                # epoch (and nonce) matched: begin the step.  The
                # convergence invariant latches HERE if the base the
                # server is about to mutate is not the base the client
                # believes in — the silent-divergence class every guard
                # in the protocol exists to prevent.
                div = s.diverged
                if entry[2] != s.view:
                    div = div or (
                        f"step applied onto base {entry[2]} while the "
                        f"client's view is {s.view} (epoch {base}"
                        f"{' after adopt' if adopted else ''}) — "
                        "silent divergence")
                yield (("serve_adopt_step" if adopted else "serve_step"),
                       replace(s, entry=(entry[0], entry[1], entry[2],
                                         True, pids),
                               record=record, floor=floor, diverged=div))
        if s.entry is not None and s.entry[3]:
            epoch, nonce, applied, _, staged = s.entry
            new_epoch = epoch + 1
            yield ("commit", replace(
                s, entry=(new_epoch, nonce, applied + staged, False, ()),
                wire=("ok", new_epoch, nonce, staged),
                max_issued=max(s.max_issued, new_epoch)))
            if s.fails > 0:
                # mid-step failure: drop("error") — entry evicted (its
                # epoch NOTED into the floor, like every departure) and
                # the spool record removed (poisoned chains re-establish
                # from ground truth, never re-adopt); the client sees a
                # typed error
                yield ("step_fail", replace(
                    s, entry=None, record=None, fails=s.fails - 1,
                    floor=max(s.floor, epoch + 1), wire=("error",)))
        # ---- spool + adversaries --------------------------------------
        if s.entry is not None:
            epoch, nonce, applied, in_step, staged = s.entry
            if not in_step or not cfg.snapshot_guard:
                rec = ((epoch, nonce, applied) if not in_step
                       # guard off: the writer captures a half-applied
                       # chain — applied plus a PREFIX of the staged set
                       else (epoch, nonce, applied + staged[:1]))
                if rec != s.record:
                    torn = s.torn
                    if in_step:
                        torn = torn or (
                            f"spool record captured mid-step at epoch "
                            f"{epoch} (half-applied chain on disk)")
                    yield ("snapshot", replace(s, record=rec, torn=torn))
            if s.crashes > 0:
                # crash/restart (or a fleet re-home): in-memory table
                # state AND its epoch floor are gone; an unanswered
                # request surfaces as a transport error client-side
                yield ("crash", replace(
                    s, entry=None, floor=1, max_issued=0,
                    crashes=s.crashes - 1,
                    wire=(("error",) if s.wire
                          and s.wire[0] == "req" else s.wire)))
            if s.evicts > 0 and not in_step:
                # TTL/capacity eviction: entry gone, floor NOTED (same
                # table keeps living) — the monotonicity guard's case
                yield ("evict", replace(
                    s, entry=None, floor=max(s.floor, epoch + 1),
                    evicts=s.evicts - 1))
        if s.wire is not None and s.wire[0] in ("ok", "unknown", "error") \
                and s.losses > 0:
            yield ("lose_reply", replace(
                s, wire=None, losses=s.losses - 1))
        if s.archives > 0 and s.record is not None \
                and s.record != s.archived:
            # the PVC-backup adversary copies the current record aside
            yield ("archive", replace(
                s, archived=s.record, archives=s.archives - 1))
        if s.rollbacks > 0 and s.archived is not None \
                and s.archived != s.record:
            # ... and a restore re-installs it over whatever is (or is
            # not) in the spool now
            yield (f"rollback(e{s.archived[0]})", replace(
                s, record=s.archived, rollbacks=s.rollbacks - 1))


# ---------------------------------------------------------------------------
# model B — the lease/claim/steal/drain failover protocol
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeaseConfig:
    """Bounds and guard switches for :class:`LeaseModel`.

    Guard switches (each one's ``False`` is a seeded-violation fixture):

    - ``owner_checked_drop=False`` — PRE-FIX ``drop("error")``: the spool
      record is removed without checking lease ownership, so a zombie
      replica's failing step destroys the adopter's record (the second
      real divergence the guards close).
    - ``lease_required=False`` — adoption ignores the lease and does not
      consume the record: two adopters both win.
    - ``epoch_check=False`` + ``own_removes_record=False`` — the serving
      path skips the incarnation check while establishment leaves stale
      records behind: a superseded chain commits.
    - ``respect_drain=False`` — fleet routing ignores the draining hint:
      the drainer re-adopts and serves the chain it just handed off.
    """

    replicas: int = 2
    steps: int = 2        # step_begin budget (committed epochs)
    crashes: int = 1
    expires: int = 1      # lease-expiry events (the wedged-owner window)
    errors: int = 1       # mid-step failures
    drains: int = 1
    establishes: int = 1
    rehomes: int = 2
    adopts: int = 1       # client-routed adoption attempts
    handoffs: int = 1     # drain handshakes
    contends: int = 1     # direct (non-client-routed) adoption attempts
    owner_checked_drop: bool = True
    lease_required: bool = True
    epoch_check: bool = True
    own_removes_record: bool = True
    respect_drain: bool = True


@dataclass(frozen=True)
class LeaseState:
    """One session across R replicas sharing one spool.

    ``entries[r]`` is the replica's live chain ``(incarnation, in_step)``
    or None; a single ``lease`` mirrors the one lease file per session;
    ``record`` carries ``(writer, incarnation, generation)`` — the
    generation counts record WRITES so adopt-once is checkable;
    ``consumed`` is the set of generations already adopted."""

    entries: tuple                 # per replica: None | (inc, in_step)
    lease: Optional[tuple]         # (owner, fresh)
    record: Optional[tuple]        # (writer, inc, gen)
    consumed: frozenset            # record generations already adopted
    drained: tuple                 # per replica: bool (draining)
    handed: Optional[tuple]        # last handoff (replica, inc)
    home: int
    client_inc: int
    next_inc: int
    next_gen: int
    steps: int
    crashes: int
    expires: int
    errors: int
    drains: int
    establishes: int
    rehomes: int
    adopts: int
    handoffs: int
    contends: int
    clobbered: str = ""
    double_adopt: str = ""
    stale_commit: str = ""
    drained_served: str = ""


class LeaseModel:
    """Lease/claim/steal/drain across ``cfg.replicas`` replicas and one
    shared spool, composed with the client's fleet routing (re-home on
    transport failure or the draining hint, never onto a draining
    replica).  Atomic actions model the ``_LeaseMutex`` critical section:
    each claim-check-write is one transition, exactly the serialization
    the on-disk mutex provides."""

    name = "lease-failover"

    EVENTS = {
        "establish": ("establish", "claim"),
        "commit": ("commit",),
        "serve_unknown": ("serve_unknown",),
        "adopt": ("adopt",),
        "steal": ("steal",),
        "adopt_refused": ("adopt_refused", "serve_unknown"),
        "step_error": ("drop:error",),
        "lease_lost": ("drop:lease_lost",),
        "snapshot": ("spool",),
        "snapshot_renew": ("spool",),
        "handoff": ("handoff",),
        "drain_refused": ("drain_refused",),
    }

    def __init__(self, cfg: LeaseConfig = LeaseConfig()):
        self.cfg = cfg
        self.invariants = (
            ("exactly-one-lease-winner",
             lambda s: s.double_adopt or None),
            ("record-owner-safety",
             lambda s: s.clobbered or None),
            ("no-superseded-commit",
             lambda s: s.stale_commit or None),
            ("drained-never-served-by-drainer",
             lambda s: s.drained_served or None),
        )

    def init(self) -> LeaseState:
        cfg = self.cfg
        R = cfg.replicas
        # session established on replica 0, lease held, nothing spooled
        return LeaseState(
            entries=((1, False),) + (None,) * (R - 1), lease=(0, True),
            record=None, consumed=frozenset(), drained=(False,) * R,
            handed=None, home=0, client_inc=1, next_inc=2, next_gen=1,
            steps=cfg.steps, crashes=cfg.crashes, expires=cfg.expires,
            errors=cfg.errors, drains=cfg.drains,
            establishes=cfg.establishes, rehomes=cfg.rehomes,
            adopts=cfg.adopts, handoffs=cfg.handoffs,
            contends=cfg.contends)

    # -- helpers ---------------------------------------------------------
    def _set(self, s: LeaseState, r: int, val) -> tuple:
        es = list(s.entries)
        es[r] = val
        return tuple(es)

    def _adopt_at(self, s: LeaseState, r: int, label_prefix: str):
        """The shared adopt path (client-routed serve-miss or a direct
        contend): lease claim semantics + record consumption + the
        adopt-once generation check."""
        cfg = self.cfg
        if s.record is None:
            return
        writer, inc, gen = s.record
        if not cfg.lease_required:
            # seeded violation: no claim, no consume — every adopter wins
            dbl = s.double_adopt
            if gen in s.consumed:
                dbl = dbl or (
                    f"record generation {gen} adopted twice — two "
                    "replicas now serve the same chain")
            yield (f"{label_prefix}adopt(r{r})", replace(
                s, entries=self._set(s, r, (inc, False)),
                consumed=s.consumed | {gen}, double_adopt=dbl))
            return
        if s.lease is None or s.lease[0] == r:
            how = "adopt"
        elif not s.lease[1]:
            how = "steal"
        else:
            yield (f"{label_prefix}adopt_refused(r{r})", s)
            return
        dbl = s.double_adopt
        if gen in s.consumed:
            dbl = dbl or (f"record generation {gen} adopted twice")
        yield (f"{label_prefix}{how}(r{r})", replace(
            s, entries=self._set(s, r, (inc, False)), lease=(r, True),
            record=None, consumed=s.consumed | {gen}, double_adopt=dbl))

    def actions(self, s: LeaseState) -> Iterable[Tuple[str, LeaseState]]:
        cfg = self.cfg
        R = cfg.replicas
        home = s.home
        mid_step = any(e is not None and e[1] for e in s.entries)
        # ---- client-routed serving at the home replica -----------------
        e = s.entries[home]
        if not mid_step:
            if e is None:
                if s.record is not None:
                    if s.adopts > 0:
                        for label, s2 in self._adopt_at(s, home, ""):
                            yield (label,
                                   replace(s2, adopts=s.adopts - 1))
                else:
                    yield (f"serve_unknown(r{home})", s)
                if s.establishes > 0 and not (s.drained[home]):
                    inc = s.next_inc
                    yield (f"establish(r{home})", replace(
                        s, entries=self._set(s, home, (inc, False)),
                        lease=(home, True),
                        record=(None if cfg.own_removes_record
                                else s.record),
                        client_inc=inc, next_inc=inc + 1,
                        establishes=s.establishes - 1))
                elif s.establishes > 0 and s.drained[home]:
                    yield (f"drain_refused(r{home})", s)
            elif e[0] == s.client_inc or not cfg.epoch_check:
                if s.steps > 0:
                    yield (f"step_begin(r{home})", replace(
                        s, entries=self._set(s, home, (e[0], True)),
                        steps=s.steps - 1))
            else:
                # live entry from a superseded incarnation: the epoch/
                # nonce check answers unknown, the client re-establishes
                yield (f"serve_unknown(r{home})", s)
        # ---- the one mid-step chain commits or fails -------------------
        for r in range(R):
            er = s.entries[r]
            if er is None or not er[1]:
                continue
            inc = er[0]
            stale = s.stale_commit
            if inc != s.client_inc:
                stale = stale or (
                    f"replica {r} committed incarnation {inc} while the "
                    f"client's chain is incarnation {s.client_inc} — "
                    "a superseded chain advanced")
            served = s.drained_served
            if s.handed is not None and s.handed == (r, inc):
                served = served or (
                    f"replica {r} served incarnation {inc} AFTER "
                    "handing it off in a drain — the drained chain "
                    "came back to its drainer")
            yield (f"commit(r{r})", replace(
                s, entries=self._set(s, r, (inc, False)),
                stale_commit=stale, drained_served=served))
            if s.errors > 0:
                # drop("error"): entry evicted; spool cleanup is the
                # owner-checked part — the PRE-FIX code removed the
                # record unconditionally, destroying the adopter's
                # record when a zombie's step failed
                owner = s.lease is not None and s.lease[0] == r
                record, lease, clob = s.record, s.lease, s.clobbered
                if cfg.owner_checked_drop:
                    if owner:
                        record, lease = None, None
                else:
                    if record is not None and record[0] != r \
                            and not owner:
                        clob = clob or (
                            f"replica {r} (lease lost) removed the "
                            f"record replica {record[0]} wrote — the "
                            "adopter's durability destroyed by a "
                            "zombie's failing step")
                    record = None
                    if owner:
                        lease = None
                yield (f"step_error(r{r})", replace(
                    s, entries=self._set(s, r, None), record=record,
                    lease=lease, errors=s.errors - 1, clobbered=clob))
        # ---- snapshot pass on any replica with a live chain ------------
        for r in range(R):
            er = s.entries[r]
            if er is None or er[1] or mid_step:
                continue
            inc = er[0]
            if s.lease is not None and s.lease[0] != r and s.lease[1]:
                # renewal refused: the zombie-writer guard — drop the
                # chain, write NOTHING over the new owner's record
                yield (f"lease_lost(r{r})", replace(
                    s, entries=self._set(s, r, None)))
            elif s.record is not None and s.record[:2] == (r, inc):
                # content already on disk: a re-write is protocol-noise;
                # only a lease renewal (expired -> fresh) changes state
                if s.lease != (r, True):
                    yield (f"snapshot_renew(r{r})", replace(
                        s, lease=(r, True)))
            else:
                # claim-or-renew then write: one atomic mutex section
                yield (f"snapshot(r{r})", replace(
                    s, lease=(r, True), record=(r, inc, s.next_gen),
                    next_gen=s.next_gen + 1))
        # ---- drain handshake -------------------------------------------
        for r in range(R):
            er = s.entries[r]
            if s.drains > 0 and not s.drained[r]:
                yield (f"drain(r{r})", replace(
                    s, drained=tuple(d or (i == r)
                                     for i, d in enumerate(s.drained)),
                    drains=s.drains - 1))
            if s.drained[r] and er is not None and not er[1] \
                    and s.handoffs > 0 and er[0] == s.client_inc \
                    and s.home == r:
                # handoff rides the SERVE path (server._serve_delta):
                # it fires only where the client is routed and only after
                # a successful step, i.e. at the current incarnation
                # handoff: record at the committed epoch, lease RELEASED,
                # entry dropped; the client re-homes on the hint (fleet
                # routing avoids draining replicas when respected)
                inc = er[0]
                new_home = s.home
                if cfg.respect_drain and s.home == r:
                    alive = [i for i in range(R)
                             if not s.drained[i] and i != r]
                    new_home = alive[0] if alive else s.home
                yield (f"handoff(r{r})", replace(
                    s, entries=self._set(s, r, None), lease=None,
                    record=(r, inc, s.next_gen),
                    next_gen=s.next_gen + 1, handed=(r, inc),
                    home=new_home, handoffs=s.handoffs - 1))
        # ---- adversaries + fleet routing -------------------------------
        for r in range(R):
            if s.entries[r] is not None and s.crashes > 0:
                yield (f"crash(r{r})", replace(
                    s, entries=self._set(s, r, None),
                    crashes=s.crashes - 1))
        if s.lease is not None and s.lease[1] and s.expires > 0:
            yield ("lease_expire", replace(
                s, lease=(s.lease[0], False), expires=s.expires - 1))
        if s.rehomes > 0 and not mid_step:
            for k in range(R):
                if k == s.home:
                    continue
                if cfg.respect_drain and s.drained[k]:
                    continue
                yield (f"rehome(r{k})", replace(
                    s, home=k, rehomes=s.rehomes - 1))
        if s.contends > 0 and not mid_step and s.record is not None:
            for r in range(R):
                if s.entries[r] is None and r != s.home:
                    for label, s2 in self._adopt_at(s, r, "contend_"):
                        yield (label,
                               replace(s2, contends=s.contends - 1))


# ---------------------------------------------------------------------------
# the per-session lifecycle automaton (conformance ground truth)
# ---------------------------------------------------------------------------

#: Global-per-session lifecycle states: ``live`` — some replica holds the
#: chain; ``spooled`` — no live chain but an adoptable record may exist;
#: ``cold`` — neither.  Crashes are invisible to the event stream, so
#: ``EPSILON`` lets the checker assume live->spooled (a crash with a
#: record behind) and spooled->cold (record reaped/rolled away) at any
#: point; there is deliberately NO epsilon from cold back to spooled —
#: a record resurrected after ``drop:error`` removed it (the stale-spool
#: adversary) must show up as a conformance violation, not be absorbed.
AUTOMATON_STATES = ("live", "spooled", "cold")

#: event -> tuple of (src, dst) transitions.  Events not in this table
#: are conformance violations by definition (an implementation emitting
#: a vocabulary the model never heard of is not conforming).
SESSION_AUTOMATON: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "establish": (("live", "live"), ("spooled", "live"),
                  ("cold", "live")),
    "claim": (("live", "live"),),
    "commit": (("live", "live"),),
    "adopt": (("spooled", "live"),),
    "steal": (("live", "live"), ("spooled", "live")),
    "adopt_refused": (("live", "live"), ("spooled", "spooled")),
    "serve_unknown": (("live", "live"), ("spooled", "spooled"),
                      ("cold", "cold")),
    "drain_refused": (("live", "live"), ("spooled", "spooled"),
                      ("cold", "cold")),
    # handoff normally leaves the chain only on disk (live->spooled); a
    # same-incarnation zombie at the handed-off epoch may legitimately
    # keep the session live elsewhere (live->live).  The drainer-specific
    # guarantee — the HANDING replica never serves that chain again
    # without re-acquiring it — is per-replica, so it is checked by the
    # dedicated drainer rule in conformance.py (events carry replica
    # identity), not by this global-state automaton.
    "handoff": (("live", "spooled"), ("live", "live")),
    # every spool record write is observable: the owner refreshing its
    # chain (live self-loop), or a superseded zombie that stole back an
    # expired lease re-spooling its stale chain (cold->spooled) — the
    # ONLY legal way spool state reappears without an establish/handoff,
    # which is what lets the automaton refuse silent resurrection
    "spool": (("live", "live"), ("spooled", "spooled"),
              ("cold", "spooled")),
    # drop:error from the OWNER removes record+lease (live->cold); from a
    # zombie whose lease was stolen the chain lives on at the new owner
    # (live->live), survives only as the owner's record (live->spooled),
    # or the zombie was the last remnant of a superseded incarnation
    # (spooled/cold self-loops).  Globally uninformative by necessity —
    # the conformance teeth live in handoff/adopt/commit instead.
    "drop:error": (("live", "cold"), ("live", "live"),
                   ("live", "spooled"), ("spooled", "spooled"),
                   ("cold", "cold")),
    "drop:lease_lost": (("live", "live"), ("spooled", "spooled"),
                        ("cold", "cold")),
    "evict:ttl": (("live", "spooled"),),
    "evict:capacity": (("live", "spooled"),),
    "clear:stop": (("live", "spooled"), ("live", "live")),
    "clear:fault": (("live", "spooled"), ("live", "live")),
    "reap": (("spooled", "cold"), ("live", "live")),
}

EPSILON: Tuple[Tuple[str, str], ...] = (("live", "spooled"),
                                        ("spooled", "cold"))


def epsilon_closure(states: frozenset) -> frozenset:
    out = set(states)
    changed = True
    while changed:
        changed = False
        for src, dst in EPSILON:
            if src in out and dst not in out:
                out.add(dst)
                changed = True
    return frozenset(out)


def automaton_step(states: frozenset, event: str) -> frozenset:
    """One subset-construction step: from every possible current state,
    follow ``event``; empty result = the observed sequence left the
    model's language."""
    edges = SESSION_AUTOMATON.get(event, ())
    nxt = {dst for src, dst in edges if src in states}
    return epsilon_closure(frozenset(nxt))


def accepts(events: Iterable[str]) -> Optional[int]:
    """None when the event sequence is a path of the automaton, else the
    index of the first non-conforming event."""
    cur = epsilon_closure(frozenset(AUTOMATON_STATES))
    for i, ev in enumerate(events):
        cur = automaton_step(cur, ev)
        if not cur:
            return i
    return None


def _abstract_lease(s: LeaseState) -> str:
    """The session's GLOBAL lifecycle state: live means the current
    incarnation's chain is held by some replica — superseded zombie
    entries are walking dead (their only observable events are
    self-loops) and do not count."""
    if any(e is not None and e[0] == s.client_inc for e in s.entries):
        return "live"
    if s.record is not None:
        return "spooled"
    return "cold"


def simulate_automaton(model: Optional[LeaseModel] = None,
                       max_states: int = 500_000) -> Result:
    """Edge-wise simulation relation between :class:`LeaseModel` and
    :data:`SESSION_AUTOMATON`: for every reachable model transition, the
    abstraction of the source state must be able to take the
    transition's projected events (or an epsilon path, when the action
    is invisible) and land on the abstraction of the target state.  By
    induction over paths, every event sequence the model can produce is
    then accepted by the automaton — so a conformance PASS against the
    automaton is a PASS against the model."""
    model = model or LeaseModel()

    class _Sim:
        name = "lease-automaton-simulation"
        invariants = ()

        def init(self):
            return model.init()

        def actions(self, s):
            return model.actions(s)

    base = _Sim()
    t0 = time.perf_counter()
    parents = {base.init(): None}
    stack = list(parents)
    transitions = 0
    while stack:
        s = stack.pop()
        a_src = epsilon_closure(frozenset({_abstract_lease(s)}))
        for label, s2 in base.actions(s):
            transitions += 1
            action = label.split("(")[0].replace("contend_", "")
            events = model.EVENTS.get(action, ())
            cur = a_src
            for ev in events:
                cur = automaton_step(cur, ev)
            if _abstract_lease(s2) not in cur:
                viol = Violation(
                    "automaton-simulates-model",
                    f"model action `{label}` takes abstraction "
                    f"{_abstract_lease(s)} -> {_abstract_lease(s2)} but "
                    f"the automaton (events {list(events)}) cannot",
                    ("<edge>", label))
                return Result("lease-automaton-simulation",
                              len(parents), transitions, viol,
                              time.perf_counter() - t0)
            if s2 not in parents and len(parents) < max_states:
                parents[s2] = (s, label)
                stack.append(s2)
    return Result("lease-automaton-simulation", len(parents),
                  transitions, None, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# bounded tier-1 entry points
# ---------------------------------------------------------------------------

#: the shipped configuration of each protocol model (all guards ON) —
#: tier-1 and `--model` require ZERO violations here
VERIFIED_MODELS: Tuple[Callable[[], object], ...] = (
    lambda: EpochModel(EpochConfig()),
    lambda: LeaseModel(LeaseConfig()),
)

#: invariant name -> a config under which the DFS MUST find a
#: counterexample (the guard the invariant depends on, removed).  These
#: double as regression fixtures for the two real divergences the guards
#: close: the pre-nonce epoch collision and the unchecked drop(error)
#: record removal.
SEEDED_VIOLATIONS: Dict[str, Callable[[], object]] = {
    "cumulative-retry-convergence":
        lambda: EpochModel(replace(EpochConfig(), use_nonce=False)),
    "no-half-mutated-snapshot":
        lambda: EpochModel(replace(EpochConfig(), snapshot_guard=False)),
    "epoch-monotonicity":
        lambda: EpochModel(replace(EpochConfig(), use_floor=False)),
    "exactly-one-lease-winner":
        lambda: LeaseModel(replace(LeaseConfig(), lease_required=False)),
    "record-owner-safety":
        lambda: LeaseModel(replace(LeaseConfig(),
                                   owner_checked_drop=False)),
    "no-superseded-commit":
        lambda: LeaseModel(replace(LeaseConfig(), epoch_check=False,
                                   own_removes_record=False)),
    "drained-never-served-by-drainer":
        lambda: LeaseModel(replace(LeaseConfig(), respect_drain=False)),
}


def check_all(max_states: int = 500_000) -> List[Result]:
    """The `--model` body: both shipped protocol models plus the
    automaton simulation relation, bounded-exhaustively."""
    results = [explore(mk(), max_states=max_states)
               for mk in VERIFIED_MODELS]
    results.append(simulate_automaton(max_states=max_states))
    return results


def main(fmt: str = "text", max_states: int = 500_000) -> int:
    """CLI body for ``python -m karpenter_tpu_torch.analysis --model``."""
    import json as _json

    results = check_all(max_states=max_states)
    if fmt == "json":
        print(_json.dumps({
            "models": [r.to_json() for r in results],
            "ok": all(r.ok for r in results),
        }, indent=2, sort_keys=True))
    else:
        for r in results:
            status = "ok" if r.ok else (
                "TRUNCATED" if r.truncated else "VIOLATED")
            print(f"{r.model}: {status} — {r.states} states, "
                  f"{r.transitions} transitions explored exhaustively "
                  f"in {r.elapsed_s * 1000.0:.0f} ms")
            if r.violation is not None:
                print(r.violation.format())
        if all(r.ok for r in results):
            total = sum(r.states for r in results)
            print(f"all protocol invariants hold over {total} states")
    return 0 if all(r.ok for r in results) else 1
