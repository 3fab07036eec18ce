"""KT011 — layout objects constructed on the per-call serving path.

The KT008 precedent, applied to device LAYOUT: the port's ``Mesh`` and
its layout factories (``make_mesh``, ``slot_mesh``, ``slot_sharding``,
``axis_sharding``, ``replicate``) belong at scheduler-BUILD time, not
inside per-flush serving functions.  A mesh rebuilt per solve re-gathers
every rank's devices (``make_mesh`` inside a ``torch.distributed`` job is
a collective), is re-hashed into every bucket key (``mesh_signature``),
and makes it easy to drift the layout between the scheduler that warmed a
signature and the flush that dispatches it.

``parallel/`` is the sanctioned home: ``parallel/mesh.py`` owns the
constructors and the cached factories, ``parallel/distributed.py`` the
multi-process placement.  Serving code takes the scheduler's ``mesh`` and
calls those; it never constructs layout inline.

Scope: the serving-path packages (``solver/``, ``ops/``, ``service/``)
plus ``batcher.py``.  Module-level construction is fine; genuinely
per-call uses off the steady-state path (measurement branches, dry-run
validation) carry ``# ktlint: allow[KT011] <reason>``.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..ktlint import Finding, dotted_name, file_functions

ID = "KT011"
TITLE = "layout construction on the per-call serving path"
HINT = ("build layout once, at scheduler construction: take the "
        "scheduler's mesh and the factories of parallel/mesh.py instead of "
        "constructing Mesh / make_mesh / slot_sharding / axis_sharding / "
        "replicate inside a serving function")

#: serving-path scope (package-relative path prefixes / exact files);
#: parallel/ is deliberately absent — it is the sanctioned construction home
SERVING_DIRS = (
    "karpenter_tpu_torch/solver/",
    "karpenter_tpu_torch/ops/",
    "karpenter_tpu_torch/service/",
)
SERVING_FILES = ("karpenter_tpu_torch/batcher.py",)

#: the port's layout constructors and factories (parallel/mesh.py)
LAYOUT_CTORS = frozenset({
    "Mesh", "make_mesh", "slot_mesh", "slot_sharding", "axis_sharding",
    "replicate",
})


def _in_scope(path: str) -> bool:
    return (any(path.startswith(d) for d in SERVING_DIRS)
            or path in SERVING_FILES)


def _offender(node: ast.AST) -> Optional[str]:
    """The flagged callee name if ``node`` is a layout construction."""
    if not isinstance(node, ast.Call):
        return None
    name = dotted_name(node.func)
    if name is None:
        return None
    if name.rsplit(".", 1)[-1] in LAYOUT_CTORS:
        return name
    return None


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if not _in_scope(f.path):
            continue
        for qual, fn, nested in file_functions(f):
            if nested:
                continue  # closures walk with their enclosing function
            for stmt in fn.body:
                for n in ast.walk(stmt):
                    name = _offender(n)
                    if name is None:
                        continue
                    out.append(Finding(
                        ID, f.path, n.lineno,
                        f"`{name}` construction inside `{qual}` — layout "
                        "objects are rebuilt (and re-hashed) per call on "
                        "the serving path; build them once, with the "
                        "scheduler", hint=HINT))
    return out
