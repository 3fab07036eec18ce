"""Event recording (core ``events.Recorder`` analog, SURVEY.md §2.2).

The reference publishes k8s Events (unconsolidatable reasons, interruption
notices, etc.).  Here events accumulate in-memory with a pluggable sink so
controllers and tests can assert on them; a real deployment wires a sink to
its control plane.
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional

#: default in-memory retention; under sustained traffic an unbounded list
#: is a slow leak (every reconcile tick can publish), so the recorder keeps
#: a ring — old events fall off, the sink (control plane / flight recorder)
#: has already seen them.  Override per-recorder or via KT_EVENTS_CAPACITY.
DEFAULT_CAPACITY = 2048


@dataclass(frozen=True)
class Event:
    kind: str        # object kind: Pod | Node | Machine | Provisioner
    name: str        # object name
    reason: str      # CamelCase reason, e.g. "SpotInterrupted", "Unconsolidatable"
    message: str
    event_type: str = "Normal"  # Normal | Warning


class Recorder:
    def __init__(self, sink: Optional[Callable[[Event], None]] = None,
                 capacity: Optional[int] = None) -> None:
        if capacity is None:
            capacity = int(os.environ.get("KT_EVENTS_CAPACITY",
                                          str(DEFAULT_CAPACITY)))
        self.capacity = max(1, capacity)
        self.events: Deque[Event] = deque(maxlen=self.capacity)
        self._sink = sink

    def publish(self, event: Event) -> None:
        self.events.append(event)
        if self._sink:
            self._sink(event)

    def of(self, reason: str) -> List[Event]:
        return [e for e in self.events if e.reason == reason]

    def clear(self) -> None:
        self.events.clear()
