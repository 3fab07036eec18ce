"""KT003 — labeled counter series never zero-inited.

A Prometheus counter series that first appears at its first increment loses
that increment to ``rate()`` / ``increase()`` (no prior sample to diff
against) — the exact ADVICE-r5 bug: ``SOLVER_DEGRADED_SOLVES`` /
``SOLVER_COLD_FALLBACKS`` counted their first degraded/cold solve into the
void.  Generalized: any metric constant used with a labels argument via
``registry.counter(NAME).inc(labels)`` anywhere in the package must also
have a zero-init registration (``.inc(..., value=0.0)``) somewhere, so the
series exists from process start.

Series whose label *values* are runtime data (provisioner names) cannot be
pre-created; those sites carry an explicit ``ktlint allow[KT003]``
suppression with the reason, keeping the exemption visible in the diff
instead of implicit in the rule.

Known limit (by design): matching is per metric NAME, not per label set —
zero-init sites and use sites both commonly carry loop variables
(``for b in ("native", "oracle"): inc({"backend": b}, value=0.0)``), so the
exact series population is not statically decidable.  The rule catches the
"metric never zero-inited at all" class; label-set EXACTNESS (every backend,
every tier, surviving into ``expose()``) is a runtime property the
rule cannot see — deleting one backend's zero-init passes this rule.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..ktlint import Finding, file_nodes

ID = "KT003"
TITLE = "labeled counter series never zero-inited"
HINT = ("register the series at construction with "
        "`registry.counter(NAME).inc(labels, value=0.0)` — inc(0) creates "
        "the sample, merely constructing the Counter does not")


def _metric_of_counter_call(node: ast.AST) -> Optional[str]:
    """``<expr>.counter(METRIC)`` -> metric name (Name id or str const)."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "counter" and node.args):
        arg = node.args[0]
        if isinstance(arg, ast.Name):
            return arg.id
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
    return None


def _inc_call(n: ast.AST) -> Optional[Tuple[ast.Call, ast.expr]]:
    if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "inc"):
        return n, n.func.value
    return None


def _is_zero(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant)
            and isinstance(node.value, (int, float))
            and not isinstance(node.value, bool) and node.value == 0)


def check(files) -> List[Finding]:
    zero_inited: set = set()
    uses: List[Tuple[str, str, int]] = []  # (metric, path, line)
    for f in files:
        # counters bound to locals: name -> metric (file-scoped, conservative)
        varmap: Dict[str, str] = {}
        for n in file_nodes(f):
            if isinstance(n, ast.Assign):
                metric = _metric_of_counter_call(n.value)
                if metric is not None:
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            varmap[t.id] = metric
        for n in file_nodes(f):
            hit = _inc_call(n)
            if hit is None:
                continue
            call, recv = hit
            metric = _metric_of_counter_call(recv)
            if metric is None and isinstance(recv, ast.Name):
                metric = varmap.get(recv.id)
            if metric is None:
                continue
            labels = call.args[0] if call.args else None
            if labels is not None and isinstance(labels, ast.Constant) \
                    and labels.value is None:
                labels = None
            value = call.args[1] if len(call.args) > 1 else None
            for kw in call.keywords:
                if kw.arg == "labels":
                    labels = kw.value
                elif kw.arg == "value":
                    value = kw.value
            if value is not None and _is_zero(value):
                zero_inited.add(metric)
            elif labels is not None:
                uses.append((metric, f.path, n.lineno))
    return [
        Finding(
            ID, path, line,
            f"labeled counter series for `{metric}` is incremented here but "
            "the metric is never zero-inited anywhere in the package — "
            "Prometheus rate()/increase() will lose its first increment",
            hint=HINT,
        )
        for metric, path, line in uses if metric not in zero_inited
    ]
