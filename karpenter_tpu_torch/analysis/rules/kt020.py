"""KT020 — per-block dispatch loops / unpacked feasibility on the
hierarchical path.

The million-pod decomposition's perf contract has two
structural invariants in ``solver/hierarchy.py``:

1. **One dispatch per block wave.**  Every block solves as a SLOT of one
   batched megabatch dispatch (``solve_many_prepared``); a ``solve`` /
   ``prepare`` / ``wave`` / ``delta_solve`` call inside a ``for``/``while``
   (or a comprehension — the same N dispatches spelled on one line) pays a
   device round trip PER BLOCK, the exact shape KT010 polices on
   controller paths.  The price-ascent loop is GENUINELY sequential (each
   dual update needs the previous wave's usage) and carries
   ``# ktlint: allow[KT020] <reason>`` — the exemption stays visible in
   the diff, not implicit in the rule.

2. **Packed feasibility.**  The hot loop scores int8 feasibility with
   bf16 prices (``pack_feasibility`` / ``pack_scores`` — ~4x fewer HBM
   bytes than the float32 layout the relax rung materializes).
   Constructing a float32 feasibility tensor on this path silently
   quadruples the hot loop's memory traffic.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..ktlint import Finding, _is_suppressed, dotted_name, file_nodes, file_parents

ID = "KT020"
TITLE = "per-block dispatch loop / unpacked feasibility on the hierarchical path"
HINT = ("batch the blocks as slots of ONE solve_many_prepared dispatch and "
        "keep feasibility packed (pack_feasibility -> int8, pack_scores -> "
        "bf16); when waves are sequentially dependent (the price-ascent "
        "loop), annotate with `# ktlint: allow[KT020] <reason>`")

#: callee names whose per-iteration invocation is a device round trip on
#: the hierarchical path (``wave`` is hierarchy.py's dispatch wrapper)
SOLVE_CALLS = {"solve", "prepare", "solve_many_prepared", "wave",
               "delta_solve", "_solve_once"}
#: scoped file (path substring — the decomposition lives in one module)
SCOPE = ("solver/hierarchy.py",)

#: dtype spellings that mark an UNPACKED feasibility tensor
_F32_NAMES = {"float32"}
#: numpy/jnp constructors whose ``dtype=float32`` builds the tensor wide
_CTORS = {"zeros", "ones", "empty", "full", "asarray", "array"}


def _in_scope(path: str) -> bool:
    return any(s in path for s in SCOPE)


def _callee(call: ast.Call):
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


#: comprehensions are loops too — ``[wave([e]) for e in entries]`` is the
#: for-loop-of-dispatch spelled on one line
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


def _is_f32(node: Optional[ast.AST]) -> bool:
    """``np.float32`` / ``jnp.float32`` / ``"float32"`` / bare float32."""
    if node is None:
        return False
    if isinstance(node, ast.Constant):
        return node.value in _F32_NAMES
    name = dotted_name(node)
    return bool(name) and name.split(".")[-1] in _F32_NAMES


def _mentions_feas(node: ast.AST) -> bool:
    """Any Name/Attribute/callee in the subtree naming feasibility."""
    for n in ast.walk(node):
        ident = None
        if isinstance(n, ast.Name):
            ident = n.id
        elif isinstance(n, ast.Attribute):
            ident = n.attr
        if ident and "feas" in ident.lower():
            return True
    return False


def _f32_construction(call: ast.Call) -> bool:
    """Does this call BUILD a float32 array?  Either ``x.astype(float32)``
    or a numpy/jnp constructor with ``dtype=float32``."""
    name = _callee(call)
    if name == "astype":
        return any(_is_f32(a) for a in call.args) or any(
            kw.arg == "dtype" and _is_f32(kw.value) for kw in call.keywords)
    if name in _CTORS:
        return any(kw.arg == "dtype" and _is_f32(kw.value)
                   for kw in call.keywords)
    return False


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
            # ---- (1) per-block dispatch inside a Python loop -----------
            if name in SOLVE_CALLS:
                loop = _enclosing_loop(n, parents)
                if loop is None:
                    continue
                # honor a suppression on the loop header (or the comment
                # block above it) in addition to the call line, which
                # analyze_files checks — probed with a synthetic finding
                # at the loop line so the shared suppression walk stays
                # the single source of truth
                if _is_suppressed(f, Finding(ID, f.path, loop.lineno, "")):
                    continue
                where = dotted_name(n.func) or name
                out.append(Finding(
                    ID, f.path, n.lineno,
                    f"`{where}(...)` runs once per iteration of the "
                    f"enclosing loop (line {loop.lineno}) — a device "
                    "dispatch per block where one block-wave slot batch "
                    "serves them all",
                    hint=HINT,
                ))
                continue
            # ---- (2) unpacked float32 feasibility tensor ---------------
            # feasibility is named either in the expression itself
            # (``_host_feasibility(st).astype(np.float32)``) or on the
            # assignment target (``feas = np.zeros(..., dtype=float32)``)
            feasy = _mentions_feas(n)
            if not feasy:
                parent = parents.get(n)
                if isinstance(parent, ast.Assign):
                    feasy = any(_mentions_feas(t) for t in parent.targets)
                elif isinstance(parent, ast.AnnAssign):
                    feasy = _mentions_feas(parent.target)
            if _f32_construction(n) and feasy:
                out.append(Finding(
                    ID, f.path, n.lineno,
                    "float32 feasibility tensor on the hierarchical path "
                    "— the packed hot loop scores int8 feasibility "
                    "(pack_feasibility), 4x fewer HBM bytes",
                    hint=HINT,
                ))
    return out
