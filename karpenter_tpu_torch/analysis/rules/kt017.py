"""KT017 — session-spool facade discipline (the lease API stays home).

The session spool is the FLEET's handoff medium: per-session
record files guarded by ownership leases under ``KT_SESSION_DIR``
(``service/snapshot.py``), with ``service/delta.DeltaSessionTable`` as the
one consumer (snapshot / restore / adopt / handoff / own).  The protocol's
whole guarantee — two replicas can never both adopt a chain — rests on
every record and lease operation flowing through those two files: a
drive-by ``snap.read_record(...)`` from the server layer, or an
``open()`` of a lease path from a handler, reads state the lease does not
cover (or writes state the lease protects), and the exactly-one-owner
proof quietly stops being one.

So: any call to the spool/lease primitive surface (the names in
:data:`SPOOL_PRIMITIVES`) in ``karpenter_tpu_torch/service/`` OUTSIDE
``service/snapshot.py`` (the API home) and ``service/delta.py`` (the
table facade) is a finding — the KT016 "sanctioned home" precedent.
Scripts, tests, and other packages are out of scope (the chaos harness
peeks deliberately).

Deliberate exceptions carry ``# ktlint: allow[KT017] <reason>``.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..ktlint import Finding, dotted_name, file_nodes

ID = "KT017"
TITLE = "session-spool access outside the snapshot.py lease API"
HINT = ("route record/lease operations through DeltaSessionTable "
        "(snapshot/restore/adopt/handoff/own) — service/snapshot.py owns "
        "the primitives and service/delta.py is the one facade; a "
        "deliberate exception needs `# ktlint: allow[KT017] <reason>`")

#: the scoped package (path substring)
SCOPE = ("/service/",)
#: the sanctioned homes: the primitive API itself + the table facade
HOMES = ("/service/snapshot.py", "/service/delta.py")
#: the record/lease primitive surface (service/snapshot.py) — calling any
#: of these outside the homes bypasses the exactly-one-owner protocol
SPOOL_PRIMITIVES = {
    "claim_lease", "release_lease", "lease_state", "lease_path",
    "write_record", "read_record", "remove_record", "list_sessions",
    "session_path", "spool_path", "write_atomic",
}


def _in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(s in p for s in SCOPE) and not any(h in p for h in HOMES)


def _leaf(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if not _in_scope(f.path):
            continue
        for n in file_nodes(f):
            if not isinstance(n, ast.Call):
                continue
            name = _leaf(n)
            if name not in SPOOL_PRIMITIVES:
                continue
            where = dotted_name(n.func) or name
            out.append(Finding(
                ID, f.path, n.lineno,
                f"`{where}(...)` touches the session spool/lease "
                "primitives outside service/snapshot.py's lease API — "
                "record and lease state is guarded by the exactly-one-"
                "owner protocol, and only the DeltaSessionTable facade "
                "(service/delta.py) may drive it",
                hint=HINT,
            ))
    return out
