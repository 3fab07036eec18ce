"""KT007 — traces/spans must be opened via a ``with`` context manager.

A ``Tracer.start()`` (or ``Trace.span()``) whose result is not immediately
the context expression of a ``with`` leaks an open trace/span on ANY
exception path between start and close: the trace never reaches the flight
recorder, its spans never land in the duration histograms, and — worse —
the per-thread open-span stack keeps nesting later spans under a corpse.
The obs API is built so the context-managed form is always available
(cross-thread phases use ``Trace.record``, which returns a span born
closed), so a bare start is a bug, not a style choice.

Scope: calls to ``.start(...)`` on a receiver whose final name segment is
``trace``/``tracer`` (e.g. ``tracer.start``, ``self._tracer.start``), and
``.span(...)`` on a ``trace``-named receiver; ``.start_span(...)`` /
``.start_trace(...)`` anywhere.  Thread/server ``.start()`` calls never
match (their receivers are threads, timers, servers).  A deliberate manual
lifecycle needs ``# ktlint: allow[KT007] <reason>``.
"""

from __future__ import annotations

import ast
from typing import List

from ..ktlint import Finding, dotted_name, file_nodes, file_parents

ID = "KT007"
TITLE = "trace/span started without a `with` context manager"
HINT = ("write `with tracer.start(...) as trace:` / `with trace.span(...)"
        " as sp:`; for cross-thread phases use `trace.record(name, t0, t1)` "
        "(born closed); a deliberate manual lifecycle needs "
        "`# ktlint: allow[KT007] <reason>`")

#: method names that always indicate a span/trace opening, any receiver
#: (start_remote is the KT019 server-entry facade — its result is a live
#: trace and leaks exactly like a bare start)
ALWAYS = {"start_span", "start_trace", "start_remote"}
#: receiver-gated method names: only when the receiver's final segment is a
#: trace/tracer (so `thread.start()` / `server.start()` never match)
GATED = {"start", "span"}


def _tracer_receiver(recv: str) -> bool:
    seg = recv.split(".")[-1].strip("_").lower()
    return seg in ("trace", "tracer") or seg.endswith("tracer") \
        or seg.endswith("_trace")


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        parents = file_parents(f)
        for n in file_nodes(f):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)):
                continue
            name = n.func.attr
            if name in ALWAYS:
                hit = True
            elif name in GATED:
                recv = dotted_name(n.func.value)
                hit = recv is not None and _tracer_receiver(recv)
            else:
                hit = False
            if not hit:
                continue
            if isinstance(parents.get(n), ast.withitem):
                continue  # `with tracer.start(...) [as x]:` — the blessed form
            out.append(Finding(
                ID, f.path, n.lineno,
                f"`{ast.unparse(n.func)}(...)` opens a trace/span outside a "
                "`with` — it leaks open on any exception path",
                hint=HINT,
            ))
    return out
