"""KT024 — call-time knob env read outside the tuning registry.

The serving-path knobs (megabatch wait/slots, inline-delta routing,
brownout ladder, relax iterations, hierarchical threshold) live behind
the live ``karpenter_tpu_torch.tuning`` registry: the dispatcher
snapshots the registry atomically per flush/decision point, so a
controller update can never tear a megabatch flush or brownout
evaluation, and ``/tunez`` shows one authoritative value per knob.  A
serving-path function that reads the knob's env var directly at call
time re-opens the hole — it sees the construction-time env, not the
tuned value, and its read is invisible to the snapshot/trace surface.

Flagged: reads of a registry-owned env name (``tuning.knobs.KNOB_ENVS``)
via ``os.environ.get``/``os.environ[...]``/``os.getenv`` or an
``_env_*`` helper, inside a function in a serving-path file.

Exempt: construction scopes (module level, class bodies, ``__init__``/
``__new__``/``from_env``/``main``) — env values ARE the lattice
defaults there by design; the ``karpenter_tpu_torch/tuning/`` package
itself
(the registry's own from-env fallback is the one sanctioned read); and
dynamic names the rule cannot resolve (skipped, not flagged).
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..ktlint import Finding, file_nodes, file_parents

ID = "KT024"
TITLE = "call-time knob env read outside the tuning registry"
HINT = ("read the knob through karpenter_tpu_torch.tuning "
        "(`global_knobs().get(name)` for one value, `.snapshot()` at a "
        "flush/decision point) — direct env reads see the boot-time "
        "value, not the tuned one, and tear-freedom only holds through "
        "the registry's atomic snapshot")

#: package-relative path fragments that make a file serving-path
SERVING_PARTS = ("karpenter_tpu_torch/service/",
                 "karpenter_tpu_torch/admission/",
                 "karpenter_tpu_torch/solver/")
#: the registry package — its from-env fallback is the sanctioned read
EXEMPT_PARTS = ("karpenter_tpu_torch/tuning/",)
#: construction scopes: env defaults are read here by design
EXEMPT_SCOPES = ("__init__", "__new__", "from_env", "main")


def _knob_envs() -> frozenset:
    from ...tuning.knobs import KNOB_ENVS

    return KNOB_ENVS


def _in_scope(path: str) -> bool:
    if any(part in path for part in EXEMPT_PARTS):
        return False
    return any(part in path for part in SERVING_PARTS)


def _env_name(node: ast.AST) -> Optional[str]:
    """The knob env name this node reads, or None.

    Matches ``os.environ.get("KT_X", ...)``, ``os.environ["KT_X"]``,
    ``os.getenv("KT_X")``, and ``_env_*("KT_X", ...)`` helper calls
    (policy's ``_env_float``/``_env_int``/... family).  Only string
    literals resolve — a dynamic name is skipped, not flagged.
    """
    if isinstance(node, ast.Subscript):
        if (isinstance(node.value, ast.Attribute)
                and node.value.attr == "environ"
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            return node.slice.value
        return None
    if not (isinstance(node, ast.Call) and node.args):
        return None
    arg = node.args[0]
    if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
        return None
    func = node.func
    if isinstance(func, ast.Attribute):
        # os.environ.get("KT_X") / os.getenv("KT_X") / mod._env_float(...)
        if func.attr == "get" and isinstance(func.value, ast.Attribute) \
                and func.value.attr == "environ":
            return arg.value
        if func.attr == "getenv" or func.attr.startswith("_env"):
            return arg.value
        return None
    if isinstance(func, ast.Name):
        if func.id == "getenv" or func.id.startswith("_env"):
            return arg.value
    return None


def _construction_scope(node: ast.AST, parents) -> bool:
    """True when the read executes at construction time: module level,
    a class body, or the nearest enclosing function is an exempt scope."""
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur.name in EXEMPT_SCOPES
        cur = parents.get(cur)
    return True  # module level / class body


def check(files) -> List[Finding]:
    knob_envs = _knob_envs()
    findings: List[Finding] = []
    for f in files:
        if not _in_scope(f.path):
            continue
        parents = file_parents(f)
        for n in file_nodes(f):
            env = _env_name(n)
            if env is None or env not in knob_envs:
                continue
            if _construction_scope(n, parents):
                continue
            findings.append(Finding(
                ID, f.path, n.lineno,
                f"serving-path call-time read of knob env `{env}` "
                "bypasses the tuning registry — it sees the boot-time "
                "value, not the tuned one, and escapes the atomic "
                "snapshot that keeps flushes/brownout decisions untorn",
                hint=HINT,
            ))
    return findings
