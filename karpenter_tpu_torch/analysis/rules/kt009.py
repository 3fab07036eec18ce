"""KT009 — RPC-path rejections must record a shed metric.

Admission control's whole value is *observable* load shedding: a request
refused under overload that never lands in
``karpenter_admission_shed_total{class,reason}`` is a silent availability
loss — dashboards show healthy traffic while callers see
RESOURCE_EXHAUSTED.  This rule pins the accounting contract statically:
in the RPC-path packages (``karpenter_tpu_torch/admission/``,
``karpenter_tpu_torch/service/``), every function that raises OR constructs a
:class:`SolveShedError` / :class:`SolveDeadlineError` (construction
covers the dispatcher resolving a future with the error instead of
raising) must, in the same function, increment the shed counter —
``<registry>.counter(ADMISSION_SHED).inc(...)`` (or the literal metric
name) or delegate to an ``AdmissionControl`` accounting helper
(``_count_shed`` / ``_shed``).

A site that genuinely must not count (e.g. the client re-mapping a shed
the SERVING side already counted) carries
``# ktlint: allow[KT009] <reason>`` — the exemption stays visible in the
diff instead of implicit in the rule.
"""

from __future__ import annotations

import ast
from typing import List

from ..ktlint import Finding, dotted_name, file_nodes, file_parents

ID = "KT009"
TITLE = "RPC-path rejection without a shed-metric increment"
HINT = ("increment karpenter_admission_shed_total{class,reason} in the "
        "same function — `registry.counter(ADMISSION_SHED).inc({...})` or "
        "the AdmissionControl._count_shed helper; a deliberate no-count "
        "site needs `# ktlint: allow[KT009] <reason>`")

#: exception names whose raise/construction marks an RPC-path rejection
SHED_ERRORS = {"SolveShedError", "SolveDeadlineError"}
#: metric identifiers accepted as "the shed counter"
SHED_METRICS = {"ADMISSION_SHED", "karpenter_admission_shed_total"}
#: accounting helpers that inc the counter on the caller's behalf
SHED_HELPERS = {"_count_shed", "_shed"}
#: scoped packages (path substrings)
SCOPE = ("/admission/", "/service/")


def _in_scope(path: str) -> bool:
    return any(s in path for s in SCOPE)


def _is_shed_ctor(call: ast.Call) -> bool:
    name = None
    if isinstance(call.func, ast.Name):
        name = call.func.id
    elif isinstance(call.func, ast.Attribute):
        name = call.func.attr
    return name in SHED_ERRORS


def _counts_shed(func: ast.AST) -> bool:
    """Does this function inc the shed counter (directly or via helper)?"""
    for n in ast.walk(func):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute):
            if n.func.attr in SHED_HELPERS:
                return True
            if n.func.attr == "inc":
                # `<expr>.counter(ADMISSION_SHED).inc(...)` — receiver is a
                # counter(...) call over one of the accepted identifiers
                recv = n.func.value
                if (isinstance(recv, ast.Call)
                        and isinstance(recv.func, ast.Attribute)
                        and recv.func.attr == "counter" and recv.args):
                    arg = recv.args[0]
                    if (isinstance(arg, ast.Name)
                            and arg.id in SHED_METRICS):
                        return True
                    if (isinstance(arg, ast.Constant)
                            and arg.value in SHED_METRICS):
                        return True
        elif isinstance(n.func, ast.Name) and n.func.id in SHED_HELPERS:
            return True
    return False


def _enclosing_function(node: ast.AST, parents):
    cur = node
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
    return None


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if not _in_scope(f.path):
            continue
        parents = file_parents(f)
        for n in file_nodes(f):
            if not (isinstance(n, ast.Call) and _is_shed_ctor(n)):
                continue
            func = _enclosing_function(n, parents)
            if func is None:
                continue  # module-level construction: not an RPC path
            if _counts_shed(func):
                continue
            where = dotted_name(n.func) or "?"
            out.append(Finding(
                ID, f.path, n.lineno,
                f"`{where}(...)` rejects an RPC here but "
                f"`{func.name}` never increments "
                "karpenter_admission_shed_total — the shed is invisible "
                "to dashboards and the overload SLO",
                hint=HINT,
            ))
    return out
