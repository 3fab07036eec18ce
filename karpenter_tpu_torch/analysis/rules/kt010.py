"""KT010 — Python-loop-of-device-dispatch on controller paths.

The repo's structural perf rule: a controller that calls the solver once
per candidate inside a Python loop pays one device round trip (dispatch +
fence + host prep) PER ITERATION — the shape the deprovisioning
controller's consolidation sweep avoids: its N what-ifs are slots of ONE
batched dispatch
(solver/consolidation.sweep_what_ifs, ``DeprovisioningController
._simulate_batch``).  Re-introducing a per-candidate ``solve`` /
``_solve_what_if`` / ``_simulate`` call inside a ``for``/``while`` — or a
comprehension/generator expression, the same N dispatches spelled on one
line — in ``controllers/`` silently regresses a reconcile pass from one
fence back to N.

Loops that are GENUINELY sequential — each iteration's input depends on
the previous iteration's solver answer (binary search, invalidate-and-
retry) — cannot batch and carry ``# ktlint: allow[KT010] <reason>`` on the
loop (or call) line, keeping the exemption visible in the diff instead of
implicit in the rule.
"""

from __future__ import annotations

import ast
from typing import List

from ..ktlint import Finding, _is_suppressed, dotted_name, file_nodes, file_parents

ID = "KT010"
TITLE = "per-candidate solver call inside a controller loop"
HINT = ("batch the candidates through one dispatch — "
        "solver/consolidation.sweep_what_ifs or "
        "DeprovisioningController._simulate_batch (one batched dispatch, "
        "one fence) — or, when iterations are sequentially dependent, "
        "annotate the loop with `# ktlint: allow[KT010] <reason>`")

#: callee names whose per-iteration invocation is a device round trip
SOLVE_CALLS = {"solve", "_solve_what_if", "_simulate"}
#: scoped package (path substring)
SCOPE = ("/controllers/",)


def _in_scope(path: str) -> bool:
    return any(s in path for s in SCOPE)


def _callee(call: ast.Call):
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


#: comprehensions are loops too — ``[self._simulate([c]) for c in cands]``
#: is the for-loop-of-dispatch spelled on one line
_LOOPS = (ast.For, ast.While,
          ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _enclosing_loop(node: ast.AST, parents):
    """The innermost loop (for/while/comprehension) containing ``node``
    (lambdas/defs between the call and the loop break containment — the
    loop body is then a deferred callable, not a per-iteration
    dispatch)."""
    cur = node
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return None
        if isinstance(cur, _LOOPS):
            return cur
    return None


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if not _in_scope(f.path):
            continue
        parents = file_parents(f)
        for n in file_nodes(f):
            if not isinstance(n, ast.Call):
                continue
            name = _callee(n)
            if name not in SOLVE_CALLS:
                continue
            loop = _enclosing_loop(n, parents)
            if loop is None:
                continue
            # the loop header is the natural annotation point: honor a
            # suppression on it (or the comment block above it) in
            # addition to the call line, which analyze_files checks —
            # probed with a synthetic finding at the loop line so the
            # shared suppression walk stays the single source of truth
            if _is_suppressed(f, Finding(ID, f.path, loop.lineno, "")):
                continue
            where = dotted_name(n.func) or name
            out.append(Finding(
                ID, f.path, n.lineno,
                f"`{where}(...)` runs once per iteration of the "
                f"enclosing loop (line {loop.lineno}) — a device round "
                "trip per candidate where one batched dispatch serves "
                "them all",
                hint=HINT,
            ))
    return out
