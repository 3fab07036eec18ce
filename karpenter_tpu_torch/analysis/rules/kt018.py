"""KT018 — whole-batch readback of a mesh-sharded megabatch carry.

Megabatch fences are PER-HOST: on a multi-process mesh each serving
process reads back only the slot blocks its rank owns
(``solver/tpu.read_slot_rows`` — the sanctioned accessor, ``local_only``)
and demuxes exactly the slots it owns; a foreign slot comes back as a
typed ``SlotNotOwned`` for the forwarding shim.  The bug class this rule
pins is a ``.results()`` / extraction path reading the slot-stacked carry
directly — ``np.asarray`` / ``np.array`` of it, or ``.cpu()`` /
``.numpy()`` / ``.tolist()`` on it: on a multi-process mesh that is a
WHOLE-batch device-to-host read, so every rank pays the gather (and the
memory) for slots it does not own, and a :class:`ShardedArray` with
shards on other ranks has no local tensor to read at all.

Mechanics (a lexical convention rule, the KT002/KT016 precedent): in the
serving-path files, any readback whose argument or receiver references
the stacked-carry naming convention — ``carry_b`` / ``ys_b`` (names,
attributes, or subscripts of either) — is a finding, except inside
``read_slot_rows`` itself (the accessor owns its raw reads).  The
single-solve ``carry`` (no ``_b``) is out of scope: its result is
genuinely global.

Deliberate exceptions carry ``# ktlint: allow[KT018] <reason>``.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..ktlint import Finding, dotted_name

ID = "KT018"
TITLE = "whole-batch readback of a mesh-sharded megabatch carry"
HINT = ("route stacked-carry reads through solver/tpu.read_slot_rows "
        "(the per-host accessor): a raw np.asarray / .cpu() / .tolist() "
        "on carry_b/ys_b reads the WHOLE batch — every rank pays for "
        "slots it does not own; a deliberate exception needs "
        "`# ktlint: allow[KT018] <reason>`")

#: serving-path scope (the KT011 file set: where megabatch carries live)
SCOPE_FILES = (
    "solver/tpu.py", "solver/scheduler.py", "solver/consolidation.py",
    "service/server.py", "batcher.py",
)
#: the readback functions (``np.asarray(carry_b)``)
READBACKS = {"asarray", "array"}
#: the readback methods (``carry_b[0].cpu()``)
READ_METHODS = {"cpu", "numpy", "tolist"}
#: the slot-stacked carry naming convention (dim 0 = request slot)
STACKED_NAMES = {"carry_b", "ys_b"}
#: the sanctioned accessor — its own raw reads are the implementation
ACCESSOR = "read_slot_rows"


def _in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(p.endswith(s) for s in SCOPE_FILES)


def _leaf(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


def _mentions_stacked(node: ast.AST, aliases=frozenset()) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and (n.id in STACKED_NAMES
                                        or n.id in aliases):
            return True
        if isinstance(n, ast.Attribute) and n.attr in STACKED_NAMES:
            return True
    return False


def _loop_aliases(tree: ast.AST) -> Set[str]:
    """Names a ``for`` loop or comprehension binds from a stacked carry:
    ``[x.cpu() for x in self.carry_b]`` reads it just as whole."""
    out: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, (ast.For, ast.comprehension)) \
                and _mentions_stacked(n.iter):
            for t in ast.walk(n.target):
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _walk_outside_accessor(tree: ast.AST):
    """Yield Call nodes, skipping the body of the accessor function."""
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == ACCESSOR:
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if not _in_scope(f.path):
            continue
        aliases = frozenset(_loop_aliases(f.tree))
        for call in _walk_outside_accessor(f.tree):
            name = _leaf(call)
            if name in READBACKS:
                if not any(_mentions_stacked(a, aliases) for a in call.args):
                    continue
            elif name in READ_METHODS \
                    and isinstance(call.func, ast.Attribute):
                if not _mentions_stacked(call.func.value, aliases):
                    continue
            else:
                continue
            where = dotted_name(call.func) or name
            out.append(Finding(
                ID, f.path, call.lineno,
                f"`{where}(...)` reads a slot-stacked megabatch carry "
                "(carry_b/ys_b) whole — on a multi-process mesh every "
                "rank pays for the slots it does not own (and a shard on "
                "another rank has nothing to read); use the per-host "
                "accessor read_slot_rows",
                hint=HINT,
            ))
    return out
