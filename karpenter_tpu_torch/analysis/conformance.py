"""Runtime trace conformance against the model-checked automaton.

``analysis/model.py`` proves the protocol MODELS correct; this module
closes the loop with the implementation: the serving stack emits
transition events (``obs/protocol.py``), and :func:`check_events`
asserts every observed per-session sequence is a path of
:data:`~karpenter_tpu_torch.analysis.model.SESSION_AUTOMATON` — which
the model checker itself validates against the lease model by a simulation
relation, so a conformance PASS here is transitively a PASS against the
explored state space.

Two checks run per session:

1. **Automaton membership** — subset simulation with epsilon closure
   (crashes and reaps are invisible, so the checker tracks the SET of
   lifecycle states the session could be in; an event with no outgoing
   edge from any of them is a violation).
2. **The drainer rule** — per-replica teeth the global automaton cannot
   carry: after replica R hands a session off (``handoff``), R must not
   serve that chain again (commit/claim) unless it re-acquired it
   (establish/adopt/steal at R).  A violation here is exactly the
   "drained session served by the drainer" invariant, observed live.

The port's serving stack emits the reference's events (the same
protocol), so the checker is the reference's; ``chip_smoke.py`` taps the
wire delta chain on the card with it.  Strict by default: an
unexplainable event sequence fails the run with the offending session's
full event log in the report.

Pure stdlib, imports only sibling analysis code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .model import (AUTOMATON_STATES, SESSION_AUTOMATON, automaton_step,
                    epsilon_closure)

#: events that mean "replica R is serving / has acquired this chain"
_ACQUIRE = ("establish", "adopt", "steal")
#: events that mean "replica R advanced or claimed the chain"
_SERVE = ("commit", "claim")


@dataclass(frozen=True)
class ConformanceViolation:
    session_id: str
    index: int          # offset of the offending event in the sequence
    event: str
    reason: str
    events: Tuple[str, ...]  # the full observed sequence, for the report

    def format(self) -> str:
        marked = ", ".join(
            (f">>{e}<<" if i == self.index else e)
            for i, e in enumerate(self.events))
        return (f"session {self.session_id}: {self.reason}\n"
                f"  observed: [{marked}]")


@dataclass
class ConformanceReport:
    sessions: int
    events: int
    violations: List[ConformanceViolation]

    @property
    def ok(self) -> bool:
        return not self.violations

    def format(self) -> str:
        head = (f"conformance: {self.sessions} sessions, "
                f"{self.events} events, "
                f"{len(self.violations)} violations")
        if not self.violations:
            return head + " — every observed sequence is a model path"
        return head + "\n" + "\n".join(v.format()
                                       for v in self.violations)

    def to_json(self) -> dict:
        return {
            "sessions": self.sessions,
            "events": self.events,
            "ok": self.ok,
            "violations": [
                {"session_id": v.session_id, "index": v.index,
                 "event": v.event, "reason": v.reason,
                 "events": list(v.events)}
                for v in self.violations],
        }


def _check_automaton(sid: str, events: Sequence[Tuple[str, dict]]
                     ) -> Optional[ConformanceViolation]:
    names = tuple(e for e, _ in events)
    cur = epsilon_closure(frozenset(AUTOMATON_STATES))
    for i, (ev, _attrs) in enumerate(events):
        if ev not in SESSION_AUTOMATON:
            return ConformanceViolation(
                sid, i, ev,
                f"event `{ev}` is not in the model's vocabulary",
                names)
        cur = automaton_step(cur, ev)
        if not cur:
            return ConformanceViolation(
                sid, i, ev,
                f"event `{ev}` has no transition from any lifecycle "
                "state the session could be in — the observed sequence "
                "left the model's language", names)
    return None


def _check_drainer(sid: str, events: Sequence[Tuple[str, dict]]
                   ) -> Optional[ConformanceViolation]:
    """After `handoff` from replica R, R must re-acquire before serving
    the chain again.  Events missing a replica attribute (emitted before
    the table knows its identity — none today) are skipped, never
    guessed."""
    names = tuple(e for e, _ in events)
    handed_by = None
    for i, (ev, attrs) in enumerate(events):
        replica = attrs.get("replica")
        if ev == "handoff" and replica is not None:
            handed_by = replica
        elif handed_by is not None and replica == handed_by:
            if ev in _ACQUIRE:
                handed_by = None
            elif ev in _SERVE:
                return ConformanceViolation(
                    sid, i, ev,
                    f"replica {replica} emitted `{ev}` for a chain it "
                    "handed off without re-acquiring it — a drained "
                    "session served by its drainer", names)
        elif handed_by is not None and replica is not None \
                and ev in _ACQUIRE:
            # acquired elsewhere: the handoff is resolved; the drainer
            # may later adopt it back legitimately
            handed_by = None
    return None


def check_events(events_by_session: Dict[str, List[Tuple[str, dict]]]
                 ) -> ConformanceReport:
    """Check every observed session's event sequence against the
    model-checked automaton plus the drainer rule.  Reports EVERY
    violating session (first offending event each), not just the
    first."""
    violations: List[ConformanceViolation] = []
    n_events = 0
    for sid in sorted(events_by_session):
        events = events_by_session[sid]
        n_events += len(events)
        v = _check_automaton(sid, events)
        if v is None:
            v = _check_drainer(sid, events)
        if v is not None:
            violations.append(v)
    return ConformanceReport(len(events_by_session), n_events,
                             violations)


def check_recorder(recorder) -> ConformanceReport:
    """Convenience: check a live ``obs.protocol.TransitionRecorder``."""
    return check_events(recorder.events_by_session())
