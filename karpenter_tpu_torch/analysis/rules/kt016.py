"""KT016 — fault-plane facade discipline + counted recovery outcomes.

A seeded fault-injection plane (``karpenter_tpu_torch/faults/``) threads
through the serving stack's choke points, and makes one observability
promise: every recovery from a faultable operation is COUNTED
(``karpenter_faults_recovered_total{site,outcome}``), injected or organic.
Two bug classes follow, both pinned here:

1. **Raw nondeterminism / fault probes in serving code.**  Serving-path
   code (``solver/``, ``service/``) may consult faults only via the
   ``FaultPlane`` facade: any stdlib ``random`` import/use outside
   ``karpenter_tpu_torch/faults/`` (the KT011 "sanctioned home" precedent —
   jitter and seeded draws belong to the facade so chaos runs replay), and
   any ``os.environ`` probe of a ``KT_FAULT``-prefixed key (a component
   that reads the schedule directly bypasses the plane's deterministic
   site counters and metric funnel).  ``numpy``'s seeded generators are
   out of scope — they are numeric tooling, not fault randomness.

2. **Uncounted recovery.**  A function in the serving scope whose ``try``
   body contains a FAULTABLE operation (a plane ``fire``/``mangle`` call,
   a transport stub call, a delta-step apply, a spool pack/unpack/write)
   and whose ``except`` handler RECOVERS (does not end in a bare
   ``raise``) must land a recovery outcome in
   ``karpenter_faults_recovered_total`` somewhere in the same function —
   ``faults.count_recovery(...)`` or a direct
   ``counter(FAULTS_RECOVERED).inc(...)``.  A recovery that vanishes from
   the partition turns every chaos run's scoreboard into fiction: the
   harness asserts "N faults injected, N recoveries observed", and an
   uncounted path is exactly where a silent divergence hides.

Deliberate exceptions carry ``# ktlint: allow[KT016] <reason>``.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..ktlint import Finding, dotted_name, file_nodes, file_parents

ID = "KT016"
TITLE = "fault-plane discipline (raw random / uncounted recovery)"
HINT = ("route randomness through karpenter_tpu_torch/faults (faults.jitter(), "
        "the plane's seeded rng) and fault probes through faults.plane(); "
        "recovering excepts on faultable paths must call "
        "faults.count_recovery(registry, site, outcome) (or inc "
        "FAULTS_RECOVERED) in the same function; a deliberate exception "
        "needs `# ktlint: allow[KT016] <reason>`")

#: serving scope (path substrings) — the dirs the plane threads through
SCOPE = ("/solver/", "/service/")
#: the one sanctioned home for serving-path randomness + fault probes
HOME = "/faults/"
#: leaf callee names that ARE the faultable operations (part 2's trigger):
#: plane choke points, the transport stub, the delta-step apply, and the
#: snapshot spool surface
FAULTABLE_CALLS = {"fire", "mangle", "_apply_delta_step", "_solve",
                   "solve_raw", "_rpc", "pack", "unpack", "write_atomic"}
#: identifiers accepted as "the recovery-outcome counter"
RECOVERY_METRICS = {"FAULTS_RECOVERED", "karpenter_faults_recovered_total"}
RECOVERY_HELPERS = {"count_recovery"}


def _in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(s in p for s in SCOPE) and HOME not in p


def _enclosing_function(node: ast.AST, parents):
    cur = node
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
    return None


def _counts_recovery(func: ast.AST) -> bool:
    """Does this function land a recovery outcome (helper or direct
    counter inc), nested defs included?"""
    for n in ast.walk(func):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute):
            if n.func.attr in RECOVERY_HELPERS:
                return True
            if n.func.attr == "inc":
                recv = n.func.value
                if (isinstance(recv, ast.Call)
                        and isinstance(recv.func, ast.Attribute)
                        and recv.func.attr == "counter" and recv.args):
                    arg = recv.args[0]
                    if isinstance(arg, ast.Name) \
                            and arg.id in RECOVERY_METRICS:
                        return True
                    if (isinstance(arg, ast.Constant)
                            and arg.value in RECOVERY_METRICS):
                        return True
        elif isinstance(n.func, ast.Name) and n.func.id in RECOVERY_HELPERS:
            return True
    return False


def _leaf(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


def _has_faultable_call(body) -> bool:
    for stmt in body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call) and _leaf(n) in FAULTABLE_CALLS:
                return True
    return False


def _handler_recovers(handler: ast.ExceptHandler) -> bool:
    """A handler that does NOT end in a bare ``raise`` recovers (it keeps
    the process on some path) — re-raise-with-bookkeeping still counts as
    recovery handling for part 2, because the bookkeeping is exactly what
    must include the recovery counter when it swallows.  Only the pure
    re-raise tail (``raise`` as the LAST statement) is exempt here when
    the body is just cleanup+raise — conservatively: exempt iff the final
    statement is a bare ``raise`` AND the handler performs no other calls
    besides logging?  Too clever; keep the simple contract: a handler
    whose last statement is a bare ``raise`` is a re-raise (the error
    still surfaces typed), anything else recovers."""
    if not handler.body:
        return False
    last = handler.body[-1]
    return not (isinstance(last, ast.Raise) and last.exc is None)


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        path = f.path.replace("\\", "/")
        if HOME in path:
            continue
        in_scope = _in_scope(f.path)
        parents = file_parents(f)
        for n in file_nodes(f):
            # ---- part 1: raw random / fault-env probes ------------------
            if in_scope and isinstance(n, ast.Import):
                for alias in n.names:
                    if alias.name == "random" or \
                            alias.name.startswith("random."):
                        out.append(Finding(
                            ID, f.path, n.lineno,
                            "stdlib `random` imported in serving-path "
                            "code — nondeterminism belongs to the "
                            "karpenter_tpu_torch/faults facade (seeded, so "
                            "chaos runs replay)",
                            hint=HINT,
                        ))
            elif in_scope and isinstance(n, ast.ImportFrom):
                if n.module == "random":
                    out.append(Finding(
                        ID, f.path, n.lineno,
                        "`from random import ...` in serving-path code — "
                        "use the faults facade (faults.jitter(), the "
                        "plane's seeded rng)",
                        hint=HINT,
                    ))
            elif in_scope and isinstance(n, ast.Call):
                name = dotted_name(n.func) or ""
                if name.startswith("random."):
                    out.append(Finding(
                        ID, f.path, n.lineno,
                        f"`{name}(...)` in serving-path code — raw "
                        "randomness breaks seeded-chaos replay; use the "
                        "faults facade",
                        hint=HINT,
                    ))
                elif name in ("os.environ.get", "os.getenv") and n.args:
                    arg = n.args[0]
                    if (isinstance(arg, ast.Constant)
                            and isinstance(arg.value, str)
                            and arg.value.startswith("KT_FAULT")):
                        out.append(Finding(
                            ID, f.path, n.lineno,
                            f"raw {arg.value} env probe in serving-path "
                            "code — consult faults.plane() so the "
                            "schedule's site counters and metric funnel "
                            "stay deterministic",
                            hint=HINT,
                        ))
            # ---- part 2: uncounted recovery -----------------------------
            if not in_scope or not isinstance(n, ast.Try):
                continue
            if not _has_faultable_call(n.body):
                continue
            recovering = [h for h in n.handlers if _handler_recovers(h)]
            if not recovering:
                continue
            func = _enclosing_function(n, parents)
            if func is None or _counts_recovery(func):
                continue
            out.append(Finding(
                ID, f.path, recovering[0].lineno,
                f"`{func.name}` recovers from a faultable operation but "
                "never lands an outcome in karpenter_faults_recovered_"
                "total — an uncounted recovery is where silent "
                "divergence hides (docs/RESILIENCE.md)",
                hint=HINT,
            ))
    return out
