"""Protocol transition events — the conformance tap.

The delta-session table and the serving path emit one event per protocol
transition (establish, claim, adopt, steal, commit, handoff, drop:*,
evict:*, clear:*, spool, reap, serve_unknown, ...) so a checker can
assert every observed per-session sequence is a path of the model-checked
session automaton (``analysis/model.SESSION_AUTOMATON``).

Design rule: ZERO hot-path cost when nothing is listening.  The sink is
a single module global; every emission site guards with ``if
protocol._SINK is not None`` — one global load and a compare, the same
discipline the faults plane and KT_TRACE=0 tracing use.  Nothing is
installed by default: the chaos harness, the replay harness, and tests
install a recorder around the window they observe.

This module is importable from anywhere (service/, obs/, tests) and
imports nothing from either, so it can't create an import cycle.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

#: the installed sink, or None (the common case).  A sink is any object
#: with ``record(session_id, event, attrs)``.
_SINK = None


def install(sink) -> None:
    """Install ``sink`` as the process-wide transition-event tap.  Pass
    None to uninstall.  Callers own the install/uninstall window (use
    try/finally); overlapping installs last-write-win, exactly like the
    faults plane's process-global plane."""
    global _SINK
    _SINK = sink


def installed():
    return _SINK


def emit(session_id: str, event: str, **attrs) -> None:
    """Emit one protocol transition.  Callers on hot-ish paths should
    guard with ``if protocol._SINK is not None`` before building attrs so
    the disabled case stays a load+compare."""
    sink = _SINK
    if sink is not None:
        sink.record(session_id, event, attrs)


class TransitionRecorder:
    """Thread-safe per-session event log, the standard sink.

    ``events_by_session()`` returns ``{sid: [(event, attrs), ...]}`` in
    emission order — the exact input shape of
    ``analysis.conformance.check_events``.  The lock is a leaf: record()
    is called while table/serving locks are held, and nothing here calls
    back out."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: Dict[str, List[Tuple[str, dict]]] = {}

    def record(self, session_id: str, event: str, attrs: dict) -> None:
        with self._lock:
            self._events.setdefault(session_id, []).append(
                (event, dict(attrs)))

    def events_by_session(self) -> Dict[str, List[Tuple[str, dict]]]:
        with self._lock:
            return {sid: list(evs) for sid, evs in self._events.items()}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._events.values())


class recording:
    """Context manager installing a :class:`TransitionRecorder` for the
    duration of a block::

        with protocol.recording() as rec:
            ...drive traffic...
        report = conformance.check_events(rec.events_by_session())
    """

    def __init__(self, recorder: Optional[TransitionRecorder] = None):
        # explicit None check: an EMPTY recorder is falsy (__len__ == 0),
        # and `recorder or ...` would silently swap in a fresh one
        self.recorder = (recorder if recorder is not None
                         else TransitionRecorder())
        self._prev = None

    def __enter__(self) -> TransitionRecorder:
        self._prev = installed()
        install(self.recorder)
        return self.recorder

    def __exit__(self, *exc) -> None:
        install(self._prev)
