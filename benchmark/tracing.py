"""Spans and the device trace of a traced run.

:class:`ReqTrace` is what the harness passes as a request's ``trace``: it
records every span the program opens (``span``) or attaches already
closed (``record``) as ``(name, t0, t1)`` on ``time.perf_counter``, from
whichever thread; the harness stamps the root interval around the call.
A frozen copy of the duck-typed stage trace of
``scripts/profile_solve_torch.py``.

:func:`device_events`, :func:`union` and :func:`anchor` read a
``torch.profiler`` session that recorded the CUDA activity only: the
kernels and copies, each tied to the host time of the runtime call that
launched it, and the device-wide synchronize calls that put the host's
clock on the profiler's.  Copied from the same script.
"""

from __future__ import annotations

import bisect
import threading
import time


class _Span:
    __slots__ = ("trace", "name", "t0")

    def __init__(self, trace: "ReqTrace", name: str) -> None:
        self.trace = trace
        self.name = name
        self.t0 = 0.0

    def annotate(self, **attrs):
        return self

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.trace.add(self.name, self.t0, time.perf_counter())
        return False


class _Closed:
    def annotate(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_CLOSED = _Closed()


class ReqTrace:
    """One request's spans; truthy, so the program records into it."""

    def __init__(self) -> None:
        self.spans: list = []  # (name, t0, t1)
        self.t0 = self.t1 = 0.0
        self._lock = threading.Lock()

    def __bool__(self) -> bool:
        return True

    def now(self) -> float:
        return time.perf_counter()

    def span(self, name: str, **attrs):
        return _Span(self, name)

    def record(self, name: str, t0: float, t1: float, **attrs):
        self.add(name, t0, t1, attrs.get("occupied"))
        return _CLOSED

    def annotate(self, **attrs) -> None:
        return None

    def add(self, name: str, t0: float, t1: float, share=None) -> None:
        with self._lock:
            self.spans.append((name, t0, t1, share))


# ---------------------------------------------------------------------------
# interval arithmetic
# ---------------------------------------------------------------------------


def union(intervals) -> list:
    """Sorted disjoint ``[a, b]`` covering ``intervals``."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def covered(intervals, a: float, b: float) -> float:
    """The length of ``[a, b)`` that ``intervals`` cover."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in union(intervals))


def gaps(busy: list, a: float, b: float) -> list:
    """``[(s, e)]``: the stretches of ``[a, b)`` that the sorted disjoint
    ``busy`` leave uncovered."""
    out, cur = [], a
    for s, e in busy:
        if e <= cur:
            continue
        if s >= b:
            break
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if b > cur:
        out.append((cur, b))
    return out


def innermost(spans, t: float) -> str:
    """The name of the latest-started span open at ``t`` (``other``)."""
    best, name = None, "other"
    for nm, a, b, _ in spans:
        if a <= t < b and (best is None or a > best):
            best, name = a, nm
    return name


# ---------------------------------------------------------------------------
# the profiler's events
# ---------------------------------------------------------------------------


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def device_events(prof) -> dict:
    """The session's events on the profiler's clock (ns): ``kernels`` and
    ``copies`` as ``(start, end, name, launch)``, ``launch`` the host time
    of the runtime call of the same correlation (else the enclosing
    operation's, else the kernel's own start), and the runtime's
    device-wide synchronize calls ``[(start, end)]``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    runtime, ops, syncs, dev = {}, {}, [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start")
        if ev.device_type() == cuda:
            dev.append((start, start + _ns(ev, "duration"), name,
                        ev.correlation_id(), ev.linked_correlation_id()))
        elif name.startswith("cu"):
            runtime[ev.correlation_id()] = start
            if name == "cudaDeviceSynchronize":
                syncs.append((start, start + _ns(ev, "duration")))
        else:
            ops[ev.correlation_id()] = start
    kernels, copies = [], []
    for start, end, name, corr, linked in dev:
        launch = runtime.get(corr, ops.get(linked, start))
        row = (start, end, name, launch)
        (copies if name.startswith(("Memcpy", "Memset")) else
         kernels).append(row)
    return {"kernels": kernels, "copies": copies, "syncs": sorted(syncs)}


def anchor(syncs: list, t_sync: float, t_end: float) -> int:
    """The offset (ns) of the profiler's clock over ``perf_counter``'s:
    among the first and last few device-wide synchronize calls, the pair
    whose span best matches the host's ``t_end - t_sync``."""
    if len(syncs) < 2:
        raise RuntimeError("the profiler recorded no synchronize calls to "
                           "anchor the host's clock on")
    want = (t_end - t_sync) * 1e9
    first, _last = min(
        ((a, b) for a in syncs[:4] for b in syncs[-4:] if b[0] > a[0]),
        key=lambda ab: abs(ab[1][1] - ab[0][0] - want))
    return first[0] - int(t_sync * 1e9)


def in_any(sorted_iv: list, starts: list, t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= sorted_iv[i][1]
