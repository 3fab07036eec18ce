"""KT019 — wire-crossing trace context: forwarded on send, adopted via
the facade on receive.

One request is ONE trace across the fleet: SolveRequest
carries ``trace_id``/``parent_span``, and every server hop adopts the
remote parent so cross-replica journeys (session failover, drain
re-homes, forwarded megabatch slots) render as one tree in ``/fleetz``.
The guarantee is only as good as its weakest hop — ONE send site that
encodes a request without the context (a new retry path, a fresh
forwarding shim) silently orphans every downstream hop, and one server
entry that decodes the context but opens its trace with a bare
``tracer.start`` drops the parent link it just read.  Both bugs are
invisible in single-replica tests, which is exactly why they are pinned
statically:

- **Send half** (``service/client.py``, ``parallel/forward.py`` — the
  wire-crossing client layer): every ``codec.encode_request(...)`` call
  must pass a ``trace_id=`` keyword.  ``encode_warm_request`` (warmup is
  fire-and-forget, never part of a request tree) is out of scope.
- **Receive half** (``service/server.py``): any function that calls
  ``decode_trace_fields(...)`` must open its trace through the
  ``Tracer.start_remote`` facade — the one place the adopt-vs-local
  decision, sampling bypass, and remote-parent stamping live.

Scripts, tests, and bench drivers are out of scope (they drive the
facades, which already comply).  Deliberate exceptions carry
``# ktlint: allow[KT019] <reason>``.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..ktlint import Finding, dotted_name, file_nodes

ID = "KT019"
TITLE = "wire-crossing send/receive without trace-context discipline"
HINT = ("send sites pass trace_id=/parent_span= (trace.wire_context()) "
        "into codec.encode_request; server entries that decode_trace_fields "
        "must open their trace via tracer.start_remote(...) — a deliberate "
        "exception needs `# ktlint: allow[KT019] <reason>`")

#: the wire-crossing CLIENT layer: every request encoded here rides a
#: transport another replica serves
SEND_SCOPE = ("service/client.py", "parallel/forward.py")
#: the serving entries that decode remote parents
SERVE_SCOPE = ("service/server.py",)
ENCODER = "encode_request"
DECODER = "decode_trace_fields"
FACADE = "start_remote"


def _ends_with(path: str, suffixes) -> bool:
    p = path.replace("\\", "/")
    return any(p.endswith(s) for s in suffixes)


def _leaf(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


def _check_send(f) -> List[Finding]:
    out: List[Finding] = []
    for n in file_nodes(f):
        if not isinstance(n, ast.Call) or _leaf(n) != ENCODER:
            continue
        if any(kw.arg == "trace_id" for kw in n.keywords):
            continue
        where = dotted_name(n.func) or ENCODER
        out.append(Finding(
            ID, f.path, n.lineno,
            f"`{where}(...)` encodes a wire-crossing request without "
            "forwarding the trace context (no trace_id= keyword) — every "
            "hop this request takes downstream becomes an orphan tree in "
            "/fleetz",
            hint=HINT,
        ))
    return out


def _check_serve(f) -> List[Finding]:
    out: List[Finding] = []
    for fn in file_nodes(f):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        decodes = [n for n in ast.walk(fn)
                   if isinstance(n, ast.Call) and _leaf(n) == DECODER]
        if not decodes:
            continue
        if any(isinstance(n, ast.Call) and _leaf(n) == FACADE
               for n in ast.walk(fn)):
            continue
        for n in decodes:
            out.append(Finding(
                ID, f.path, n.lineno,
                f"`{fn.name}` decodes a remote trace context "
                f"({DECODER}) but never opens its trace through the "
                f"Tracer.{FACADE} facade — the parent link it just read "
                "is dropped and the hop roots as an orphan",
                hint=HINT,
            ))
    return out


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if _ends_with(f.path, SEND_SCOPE):
            out.extend(_check_send(f))
        if _ends_with(f.path, SERVE_SCOPE):
            out.extend(_check_serve(f))
    return out
