"""KT008 — compiled or captured callables on the serving path.

The port's serving contract is eager: PyTorch compiles nothing, so a new
shape is served on the card the moment it is seen, never cold (the warm
API only runs a signature once to prime the caching allocator).  Two
constructions silently break that contract, both caught here:

1. **Compiled callables** — ``torch.compile(...)`` and ``torch.jit.*``
   (``script``, ``trace``, ...), applied or used as a decorator anywhere in
   the serving packages: each new input shape (or guard failure) then
   recompiles on the request's thread, the exact stall the eager port
   exists to avoid.  A compiled path belongs to a measured change with its
   own warm, not to a drive-by.
2. **Per-call graph capture** — a ``torch.cuda.CUDAGraph()`` or a
   ``torch.cuda.graph(...)`` capture built inside a function body that is
   not memoized (``functools.lru_cache`` / ``functools.cache``): the graph
   is re-captured on every call — a capture costs more than the launches
   it replays, and the private memory pool it pins is rebuilt each time.
   This is the per-call-wrapper shape; ROADMAP B2 (one graph per solve
   signature) must keep its graphs in a signature-keyed cache.

Scope: the serving-path packages (``solver/``, ``ops/``, ``parallel/``,
``service/``).  Suppress a genuinely off-path use with
``# ktlint: allow[KT008] <reason>``.
"""

from __future__ import annotations

import ast
from typing import List

from ..callgraph import compile_call
from ..ktlint import Finding, dotted_name, file_functions, file_nodes

ID = "KT008"
TITLE = "compiled or per-call captured callable on the serving path"
HINT = ("serve eagerly: no torch.compile / torch.jit on the serving path; "
        "build a CUDA graph once per signature and keep it in a "
        "signature-keyed cache (or a functools.lru_cache'd factory), never "
        "per call")

#: serving-path file prefixes (package-relative paths)
SERVING_DIRS = (
    "karpenter_tpu_torch/solver/",
    "karpenter_tpu_torch/ops/",
    "karpenter_tpu_torch/parallel/",
    "karpenter_tpu_torch/service/",
)

#: graph-capture constructors (``torch.cuda.graph`` is the capture
#: context manager, ``CUDAGraph`` the object it records into)
CAPTURE_CALLS = frozenset({"torch.cuda.CUDAGraph", "torch.cuda.graph",
                           "torch.cuda.make_graphed_callables"})
#: decorators that memoize a factory: a capture inside one runs once per key
MEMOIZERS = frozenset({"lru_cache", "cache"})


def _memoized(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        d = dotted_name(target)
        if d is not None and d.split(".")[-1] in MEMOIZERS:
            return True
    return False


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if not any(f.path.startswith(d) for d in SERVING_DIRS):
            continue
        # (1) compiled callables anywhere in the file
        for n in file_nodes(f):
            target = None
            if isinstance(n, ast.Call):
                target = n.func
            elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in n.decorator_list:
                    t = dec.func if isinstance(dec, ast.Call) else dec
                    name = compile_call(t)
                    if name is not None:
                        out.append(Finding(
                            ID, f.path, dec.lineno,
                            f"`@{name}` on `{n.name}` — a compiled callable "
                            "recompiles on the request's thread at every "
                            "new shape; the serving path is eager",
                            hint=HINT))
                continue
            name = compile_call(target) if target is not None else None
            if name is not None:
                out.append(Finding(
                    ID, f.path, n.lineno,
                    f"`{name}(...)` on the serving path — a compiled "
                    "callable recompiles on the request's thread at every "
                    "new shape; the serving path is eager", hint=HINT))
        # (2) graph capture inside a non-memoized function body
        for qual, fn, nested in file_functions(f):
            if nested or _memoized(fn):
                continue  # closures walk with their enclosing function
            for stmt in fn.body:
                for n in ast.walk(stmt):
                    if isinstance(n, ast.Call) \
                            and dotted_name(n.func) in CAPTURE_CALLS:
                        out.append(Finding(
                            ID, f.path, n.lineno,
                            f"`{dotted_name(n.func)}(...)` inside `{qual}` "
                            "— the graph is re-captured on every call; "
                            "capture once per signature and cache it",
                            hint=HINT))
    return out
