"""KT006 — float64 / host ``random`` nondeterminism in device programs.

The port's parity contracts with the reference are bit-honest only while
its device programs stay float32 and deterministic: a float64 constant or
``.double()`` silently upcasts a lattice of intermediates (and doubles the
card's bytes and halves its FLOP rate on them), and Python / numpy
``random`` or torch's global generator inside a program makes two runs of
one signature disagree.  Scope — the functions that run on the card:

- the kernel library files, every function scan-body code: ``ops/``
  (``ops/masks.py``, ``ops/feasibility.py``) and ``kernels.py``;
- the device programs :data:`PROGRAMS` — ``_run_scan`` (the group step),
  ``_relax_program`` and ``_screen_program`` — together with the
  module-level helpers of their own file that they call, transitively.

Flagged: ``float64`` / ``torch.double`` / ``.double()``; ``random.*``,
``np.random`` / ``numpy.random``; and torch's sampling functions
(``torch.rand``, ``torch.randn``, ...) called without an explicit
``generator=`` (a seeded generator is deterministic by construction).

**The relax program's float64 is deliberate.**  It reproduces the
reference CPU program's float32 bits with exact float64 accumulation
(``solver/relax.py``: the FMA chains and the round-to-odd step): a
float32 product is exact in float64, and the one rounding to float32
happens in ``_round32``.  Each such site carries a KT006 suppression
with that reason and is never "fixed" — ``tests/test_torch_relax.py``
holds the bits.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from ..ktlint import Finding, dotted_name, file_nodes

ID = "KT006"
TITLE = "float64/random nondeterminism in device programs"
HINT = ("keep device programs float32 and deterministic (the parity tests "
        "compare bits against the reference); thread a seeded "
        "torch.Generator instead of host or global randomness; a "
        "deliberate exact-arithmetic site needs `# ktlint: allow[KT006] "
        "<reason>`")

#: files whose every function is device-program code: the kernel wrappers
#: and every module of ``ops/``
KERNEL_SUFFIXES = ("kernels.py",)
KERNEL_DIRS = ("/ops/",)
#: the device programs, by name, with their same-file helpers
PROGRAMS = frozenset({"_run_scan", "_relax_program", "_screen_program"})
#: torch's global-generator sampling functions
TORCH_SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson",
})


def _program_scopes(f) -> List[ast.AST]:
    """The program functions of ``f`` and every module-level function of
    ``f`` they call by name, transitively."""
    top: Dict[str, ast.AST] = {
        n.name: n for n in ast.iter_child_nodes(f.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    todo = [name for name in top if name in PROGRAMS]
    seen: Set[str] = set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for n in ast.walk(top[name]):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id in top:
                todo.append(n.func.id)
    return [top[name] for name in sorted(seen)]


def _scan_scope(nodes, f, seen: set, out: List[Finding]) -> None:
    for n in nodes:
        key = None
        if isinstance(n, ast.Attribute):
            d = dotted_name(n)
            if n.attr == "float64" or d in ("torch.double",):
                key = (n.lineno, "float64")
                msg = "float64 dtype in a device program"
            elif d is not None and (
                d.startswith("random.") or "np.random" in d
                or "numpy.random" in d
            ):
                key = (n.lineno, "random")
                msg = (f"host randomness `{d}` in a device program "
                       "(differs run to run)")
        elif isinstance(n, ast.Constant) and n.value == "float64":
            key = (n.lineno, "float64")
            msg = "float64 dtype in a device program"
        elif isinstance(n, ast.Call):
            d = dotted_name(n.func)
            if isinstance(n.func, ast.Attribute) and n.func.attr == "double" \
                    and not n.args:
                key = (n.lineno, "float64")
                msg = "`.double()` in a device program"
            elif d is not None and d.startswith("torch.") \
                    and d.split(".")[-1] in TORCH_SAMPLERS \
                    and not any(kw.arg == "generator" for kw in n.keywords):
                key = (n.lineno, "random")
                msg = (f"`{d}` on torch's global generator in a device "
                       "program (pass a seeded generator=)")
        if key is not None and key not in seen:
            seen.add(key)
            out.append(Finding(ID, f.path, key[0], msg, hint=HINT))


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        seen: set = set()
        if any(f.path.endswith(s) for s in KERNEL_SUFFIXES) \
                or any(d in f.path for d in KERNEL_DIRS):
            _scan_scope(file_nodes(f), f, seen, out)
            continue
        for scope in _program_scopes(f):
            _scan_scope(ast.walk(scope), f, seen, out)
    return out
