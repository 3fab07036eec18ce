"""KT023 — metric family constructed on a Registry but missing from the
metrics INVENTORY.

``metrics.INVENTORY`` is the single source of truth for the metric
surface: exposition emits ``# HELP``/``# TYPE`` from it, and the port's
metrics reference is generated from it (``python -m
karpenter_tpu_torch.cli metrics-doc``).  A family
constructed via ``registry.counter(...)`` / ``.gauge(...)`` /
``.histogram(...)`` whose name never made it into the INVENTORY is
invisible to both — it scrapes without HELP text and misses the docs.

Resolution is conservative: the argument must be a ``karpenter_``-prefixed
string literal, a Name that resolves to one (module-level assignment in
the scanned files, or a constant on ``karpenter_tpu_torch.metrics``), or an
``<mod>.CONST`` attribute resolving on the metrics module.  A dynamic
name (loop variable over the INVENTORY itself, helper parameters) cannot
be checked statically and is skipped, not flagged.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from ..ktlint import Finding, file_nodes

ID = "KT023"
TITLE = "metric family missing from the metrics INVENTORY"
HINT = ("add the family to karpenter_tpu_torch/metrics.py INVENTORY "
        "(name -> (type, labels, help)) — exposition HELP text and the "
        "generated metrics reference (`python -m karpenter_tpu_torch.cli "
        "metrics-doc`) both walk the INVENTORY")

_CTORS = ("counter", "gauge", "histogram")


def _inventory() -> dict:
    from ... import metrics

    return metrics.INVENTORY


def _module_constants() -> Dict[str, str]:
    """Every ``karpenter_``-string constant on the real metrics module —
    the names ``from ..metrics import X`` / ``metrics.X`` resolve to."""
    from ... import metrics

    out: Dict[str, str] = {}
    for attr in dir(metrics):
        if attr.startswith("_"):
            continue
        val = getattr(metrics, attr, None)
        if isinstance(val, str) and val.startswith("karpenter_"):
            out[attr] = val
    return out


def _resolve(arg: ast.AST, assigns: Dict[str, str],
             mod_consts: Dict[str, str]) -> Optional[str]:
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value if arg.value.startswith("karpenter_") else None
    if isinstance(arg, ast.Name):
        return assigns.get(arg.id) or mod_consts.get(arg.id)
    if isinstance(arg, ast.Attribute):
        # metrics.X / M.X — the attribute name is the constant's name
        return mod_consts.get(arg.attr)
    return None


def check(files) -> List[Finding]:
    inventory = _inventory()
    mod_consts = _module_constants()
    findings: List[Finding] = []
    # module-level NAME = "karpenter_..." assigns across the scanned files
    # (metrics.py itself plus any module declaring a local family name)
    assigns: Dict[str, str] = {}
    for f in files:
        for n in file_nodes(f):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant) \
                    and isinstance(n.value.value, str) \
                    and n.value.value.startswith("karpenter_"):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        assigns[t.id] = n.value.value
    for f in files:
        for n in file_nodes(f):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in _CTORS and n.args):
                continue
            name = _resolve(n.args[0], assigns, mod_consts)
            if name is None or name in inventory:
                continue
            findings.append(Finding(
                ID, f.path, n.lineno,
                f"metric family `{name}` is constructed on a Registry "
                "here but missing from metrics.INVENTORY — it will "
                "scrape without HELP/TYPE, miss docs/METRICS.md, and "
                "escape the zero-init suite",
                hint=HINT,
            ))
    return findings
