"""KT004 — lock discipline for ``# guarded-by:``-declared attributes.

A scheduler re-entrancy race happens when shared state grows more
reader/writer threads than its lock discipline was written for.  Attributes
that ARE cross-thread are declared at their initialization site::

    self._compiling: set = set()  # guarded-by: _lock

and this rule enforces that every other read/write of ``self._compiling``
inside the declaring class sits lexically within a ``with self._lock:``
block.  ``__init__`` is exempt (construction is single-threaded by Python
semantics); every other method is assumed reachable from both the dispatcher
thread and the RPC path — reachability is not computed, because a method
that is single-threaded *today* is one refactor away from not being, which
is exactly how such a race is born.

Known limits (documented, not silent): aliasing (``q = self._queued``) and
access from outside the declaring class are not tracked — the runtime
sanitizer (``analysis/sanitize.py``, ``KT_SANITIZE=1``) covers those
dynamically.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from ..ktlint import Finding, GUARDED_RE, file_nodes, file_parents

ID = "KT004"
TITLE = "guarded-by attribute accessed outside its lock"
HINT = ("wrap the access in `with self.<lock>:` (or move it into __init__); "
        "deliberately lock-free access needs `# ktlint: allow[KT004] <why>`")

_DECL_RE = re.compile(r"self\.(?P<attr>\w+)\s*(?::[^=]*)?=")


def _declarations(f) -> List[Tuple[int, str, str]]:
    """(lineno, attr, lock) for every `self.x = ... # guarded-by: lock`."""
    out = []
    for i, line in enumerate(f.lines, 1):
        g = GUARDED_RE.search(line)
        if g is None:
            continue
        d = _DECL_RE.search(line)
        if d is not None:
            out.append((i, d.group("attr"), g.group("lock")))
    return out


def _enclosing_class(f, lineno: int) -> Optional[ast.ClassDef]:
    best = None
    for node in file_nodes(f):
        if isinstance(node, ast.ClassDef) and \
                node.lineno <= lineno <= (node.end_lineno or node.lineno):
            if best is None or node.lineno > best.lineno:  # innermost
                best = node
    return best


def _under_lock(node: ast.AST, parents, lock: str) -> bool:
    cur = node
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, ast.With):
            for item in cur.items:
                ce = item.context_expr
                if (isinstance(ce, ast.Attribute) and ce.attr == lock
                        and isinstance(ce.value, ast.Name)
                        and ce.value.id == "self"):
                    return True
    return False


def _enclosing_funcname(node: ast.AST, parents) -> Optional[str]:
    cur = node
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur.name
    return None


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        decls = _declarations(f)
        if not decls:
            continue
        by_class: Dict[ast.ClassDef, Dict[str, str]] = {}
        decl_lines = set()
        for lineno, attr, lock in decls:
            cls = _enclosing_class(f, lineno)
            if cls is None:
                continue  # module-level guarded-by: nothing to scope to
            by_class.setdefault(cls, {})[attr] = lock
            decl_lines.add((attr, lineno))
        for cls, attrs in by_class.items():
            parents = file_parents(f)
            for n in ast.walk(cls):
                if not (isinstance(n, ast.Attribute)
                        and isinstance(n.value, ast.Name)
                        and n.value.id == "self" and n.attr in attrs):
                    continue
                if (n.attr, n.lineno) in decl_lines:
                    continue  # the declaration itself
                fname = _enclosing_funcname(n, parents)
                if fname in ("__init__", "__new__"):
                    continue
                lock = attrs[n.attr]
                if _under_lock(n, parents, lock):
                    continue
                # nearest innermost method name for the message
                out.append(Finding(
                    ID, f.path, n.lineno,
                    f"`self.{n.attr}` is declared `# guarded-by: {lock}` but "
                    f"accessed outside `with self.{lock}:` in "
                    f"`{cls.name}.{fname or '?'}`",
                    hint=HINT,
                ))
    return out
