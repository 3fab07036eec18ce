"""Injectable clock (the reference injects a clock into every controller for
testability — SURVEY.md §2.2 operator runtime)."""

from __future__ import annotations

import time as _time


class Clock:
    def now(self) -> float:
        return _time.time()

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)


class FakeClock(Clock):
    """Manually-advanced clock for tests and simulation."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = start

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self._now += seconds

    def advance(self, seconds: float) -> None:
        self._now += seconds
