"""KT005 — broad ``except Exception`` that neither re-raises nor logs.

A reconcile loop that swallows everything hides real solver/cloud failures
behind silent retries.  Broad handlers are legitimate at fan-out boundaries
(a batch leader publishing per-request errors) and in best-effort epilogues —
but each one must either re-raise, produce a structured log/warning, or be
annotated ``# ktlint: allow[KT005] <reason>`` so the breadth is a recorded
decision, not an accident.  ``except BaseException`` and bare ``except:``
are held to the same bar.
"""

from __future__ import annotations

import ast
from typing import List

from ..ktlint import Finding, file_nodes

ID = "KT005"
TITLE = "broad except without re-raise, log, or suppression"
HINT = ("narrow the exception type, re-raise, log via logger/warnings, or "
        "annotate `# ktlint: allow[KT005] <reason>` on the except line")

BROAD_NAMES = {"Exception", "BaseException"}
LOG_METHODS = {"debug", "info", "warning", "error", "exception", "critical",
               "log", "warn"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    if isinstance(t, ast.Name) and t.id in BROAD_NAMES:
        return True
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in BROAD_NAMES
                   for e in t.elts)
    return False


def _handled(handler: ast.ExceptHandler) -> bool:
    for n in ast.walk(handler):
        if isinstance(n, ast.Raise):
            return True
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in LOG_METHODS):
            return True
    return False


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        for n in file_nodes(f):
            if not isinstance(n, ast.Try):
                continue
            for handler in n.handlers:
                if not _is_broad(handler) or _handled(handler):
                    continue
                what = (ast.unparse(handler.type)
                        if handler.type is not None else "bare except")
                out.append(Finding(
                    ID, f.path, handler.lineno,
                    f"broad `except {what}` neither re-raises nor logs",
                    hint=HINT,
                ))
    return out
