"""KT015 — delta-session table discipline + counted delta-path full solves.

Delta serving holds mutable cross-RPC
state — the per-session warm-start chains in
``service/delta.DeltaSessionTable._sessions`` — behind one declared lock,
and makes one observability promise: a session-routed request that ends
up paying a FULL solve (guard trip, reseed, establishment) is never
invisible — ``karpenter_solver_delta_rpc_total{outcome}`` partitions
every session RPC.  Two bug classes follow, both pinned here:

1. **Unlocked table access.**  Any ``._sessions`` attribute access in the
   service package outside a ``with <...lock>:`` block (``__init__``
   exempt — construction is single-threaded by Python semantics).  This
   deliberately goes beyond KT004's guarded-by check: KT004 stops at the
   declaring class, while the table is reachable from the pipeline and
   the service layer too — a drive-by ``pipe._delta_tab._sessions``
   read from an RPC thread is exactly the race the lock exists for.

2. **Uncounted delta-path solve.**  A delta-path function (name contains
   ``delta``, in ``service/``) that calls a full solve or tensorize
   (``solve`` / ``solve_delta`` / ``tensorize``) without incrementing the
   delta-RPC outcome counter in the same function — the KT009 precedent:
   a fallback that never lands in
   ``karpenter_solver_delta_rpc_total{outcome="fallback_full"}`` turns
   "steady state is sub-ms" dashboards into fiction while every RPC
   quietly re-solves the cluster.

Deliberate exceptions carry ``# ktlint: allow[KT015] <reason>``.
"""

from __future__ import annotations

import ast
from typing import List

from ..ktlint import Finding, dotted_name, file_nodes, file_parents

ID = "KT015"
TITLE = "delta-session discipline (unlocked table / uncounted full solve)"
HINT = ("wrap `_sessions` access in `with self._lock:` (service/delta.py's "
        "declared lock), and make every delta-path solve/tensorize land in "
        "karpenter_solver_delta_rpc_total — "
        "`registry.counter(DELTA_RPC).inc({'outcome': ...})` (or the "
        "_counted funnel) in the same function; a deliberate exception "
        "needs `# ktlint: allow[KT015] <reason>`")

#: scoped package (path substring): the serving layer owns every session
SCOPE = ("/service/",)
#: the guarded table attribute
TABLE_ATTR = "_sessions"
#: callee names that pay a full host build / solve on the delta path
SOLVE_CALLS = {"solve", "solve_delta", "tensorize"}
#: metric identifiers accepted as "the delta-RPC outcome counter"
DELTA_METRICS = {"DELTA_RPC", "karpenter_solver_delta_rpc_total"}
#: counting funnels that inc on the caller's behalf
DELTA_HELPERS = {"_counted"}


def _in_scope(path: str) -> bool:
    return any(s in path for s in SCOPE)


def _under_lock(node: ast.AST, parents) -> bool:
    """Lexically inside ``with <something named like a lock>:`` — the
    KT004 shape, widened to any lock-ish context name so helpers that
    take the table's lock through an alias still count."""
    cur = node
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, ast.With):
            for item in cur.items:
                name = dotted_name(item.context_expr) or ""
                leaf = name.rsplit(".", 1)[-1]
                if "lock" in leaf.lower() or leaf == "_cond":
                    return True
    return False


def _enclosing_function(node: ast.AST, parents):
    cur = node
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
    return None


def _counts_delta(func: ast.AST) -> bool:
    """Does this function inc the delta-RPC counter (directly or via a
    counting funnel, nested defs included)?"""
    for n in ast.walk(func):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute):
            if n.func.attr in DELTA_HELPERS:
                return True
            if n.func.attr == "inc":
                recv = n.func.value
                if (isinstance(recv, ast.Call)
                        and isinstance(recv.func, ast.Attribute)
                        and recv.func.attr == "counter" and recv.args):
                    arg = recv.args[0]
                    if isinstance(arg, ast.Name) and arg.id in DELTA_METRICS:
                        return True
                    if (isinstance(arg, ast.Constant)
                            and arg.value in DELTA_METRICS):
                        return True
        elif isinstance(n.func, ast.Name) and n.func.id in DELTA_HELPERS:
            return True
    return False


def _callee(call: ast.Call):
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
        parents = file_parents(f)
        for n in file_nodes(f):
            # ---- part 1: unlocked session-table access ------------------
            if isinstance(n, ast.Attribute) and n.attr == TABLE_ATTR:
                func = _enclosing_function(n, parents)
                if func is not None and func.name == "__init__":
                    continue  # construction is single-threaded
                if func is not None and func.name.endswith("_locked"):
                    # the repo's caller-holds-the-lock convention: the
                    # suffix IS the contract, and every caller must sit
                    # under the `with` itself — the sanitizer's runtime
                    # watcher covers the dynamic side
                    continue
                if _under_lock(n, parents):
                    continue
                out.append(Finding(
                    ID, f.path, n.lineno,
                    f"`{dotted_name(n) or TABLE_ATTR}` accessed outside "
                    "the session table's lock — the table is shared "
                    "between the pipeline dispatcher and shutdown, and "
                    "an unlocked peek races eviction",
                    hint=HINT,
                ))
                continue
            # ---- part 2: uncounted delta-path full solve ----------------
            if not isinstance(n, ast.Call):
                continue
            name = _callee(n)
            if name not in SOLVE_CALLS:
                continue
            func = _enclosing_function(n, parents)
            if func is None or "delta" not in func.name.lower():
                continue
            if _counts_delta(func):
                continue
            where = dotted_name(n.func) or name
            out.append(Finding(
                ID, f.path, n.lineno,
                f"`{where}(...)` runs a full solve/tensorize on the "
                f"delta path but `{func.name}` never lands an outcome in "
                "karpenter_solver_delta_rpc_total — an uncounted "
                "fallback makes every steady-state dashboard lie",
                hint=HINT,
            ))
    return out
