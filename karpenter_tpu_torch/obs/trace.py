"""The do-nothing trace the solver path instruments against.

A copy of the reference package's ``obs.trace.NULL_TRACE`` as far as the
solver path calls it: every span/record/annotate is a no-op, and the trace
is falsy so instrumentation can write ``trace = trace or NULL_TRACE``.
"""

from __future__ import annotations


class _NullSpan:
    """Do-nothing span: a context manager that accepts annotations."""

    __slots__ = ()

    def annotate(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _NullTrace:
    """Do-nothing trace; falsy."""

    __slots__ = ()

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


NULL_TRACE = _NullTrace()
