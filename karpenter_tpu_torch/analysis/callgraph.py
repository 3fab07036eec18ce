"""Project-wide symbol table + call graph for whole-program ktlint passes.

The function-local rules (KT001-KT011) encode invariants a single ``def``
can witness; the three invariants the serving stack actually lives and dies
by are *interprocedural*:

- "no host<->device sync reachable from a hot path except through a fence"
  (KT013) needs every call chain from the serving entry points;
- "locks are always acquired in one global order" (KT012) needs lock-held
  sets propagated across call edges;
- "every solve signature constructible at runtime is warmed" (KT014)
  needs the rung vocabulary cross-referenced between modules.

This module builds what those passes share: a per-file :class:`FileSummary`
(functions, calls, lock acquisitions, sync constructs, attribute types) and
a linked :class:`Project` (symbol table, resolved call graph, lock/sync
indexes).  Like ktlint core it is pure stdlib ``ast`` — importing it must
never pull torch, so the lint stays fast and runs anywhere.

Resolution is deliberately *best-effort*: anything the resolver cannot
follow (dynamic dispatch, ``getattr`` facades, callbacks) becomes an entry
in ``Project.unresolved`` and NO edge — whole-program passes degrade to
their function-local approximations instead of crashing or crying wolf
(tests/test_torch_lint.py pins the graceful-degradation paths).  A
callable handed to a call (``guard.run(self._tpu.solve)``,
``Thread(target=self._loop)``) links as a closure edge, and a bare-name
call resolves to a nested def of the calling function.  What static
resolution cannot see (futures' done-callbacks, dynamic dispatch), the
runtime sanitizer (``analysis/sanitize.py``, KT_SANITIZE=1) cross-checks.

Summaries are JSON-serializable and cached per file keyed on the content
hash (:class:`SummaryCache`), so a warm whole-package run skips the
extraction walk entirely.  The port's cache lives in its own file
(``karpenter-ktlint-torch/``), so the two packages' analyzers never share
one.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .ktlint import SourceFile, dotted_name, file_nodes

#: bump when the summary format changes — stale caches are discarded, never
#: migrated (the extraction is cheap; correctness of the cache is not)
SUMMARY_VERSION = 4  # v4: the port's torch sync vocabulary (KT001/KT013)

#: parameter names treated as device-resident by convention (KT001's taint):
#: the scan's carry and per-group takes
TAINT_PARAMS = {"carry", "ys"}

#: calls whose result lives on the card: the group-step scan, the
#: packed-score kernel entries and the device programs
DEVICE_CALLS = frozenset({
    "_run_scan", "packed_scan_scores", "price_step_scores",
    "_relax_program", "_screen_program",
})

#: tensor methods that copy a device value to the host (and block on it)
HOST_READS = frozenset({"item", "tolist", "cpu", "numpy", "nonzero"})
#: builtins that read a device scalar to the host
HOST_BUILTINS = frozenset({"float", "int", "bool"})
#: numpy constructors that read a device value to the host
HOST_NUMPY = frozenset({"asarray", "array"})
#: calls that wait for the card whatever their receiver: the device-wide
#: ``torch.cuda.synchronize()``, ``Event``/``Stream.synchronize()`` and
#: ``Event.elapsed_time`` (which needs both events complete)
BLOCKING = frozenset({"synchronize", "elapsed_time"})
#: tensor metadata: host values, reading them never waits for the card
META_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda"})
META_CALLS = frozenset({"size", "numel", "dim", "element_size",
                        "data_ptr", "is_contiguous", "stride"})
#: ``torch.<dtype>`` names: ``.to(torch.float32)`` stays where it is
TORCH_DTYPES = frozenset({
    "float16", "float32", "float64", "bfloat16", "half", "float", "double",
    "int8", "uint8", "int16", "int32", "int64", "long", "int", "bool",
})

#: lock constructor names -> reentrancy.  threading.Condition wraps an RLock
#: by default, so re-acquiring under a holding caller is legal (the
#: admission queue's ``_bump`` depends on exactly that).
LOCK_KINDS = {"Lock": False, "RLock": True, "Condition": True}


# ---------------------------------------------------------------------------
# per-file summary (JSON-able, cacheable)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FuncSummary:
    """One function as the whole-program passes see it."""

    qual: str                 #: "Class.method" | "func" | "outer.inner"
    cls: Optional[str]        #: declaring class name, None for module funcs
    lineno: int
    end_lineno: int
    fence: bool               #: carries `# ktlint: fence <why>`
    nested: bool              #: defined inside another function
    #: [(lineno, dotted, in_closure)] — every call with a nameable callee;
    #: in_closure marks calls inside nested defs/lambdas (they do NOT
    #: execute at their lexical position, so lock propagation skips them)
    calls: List[Tuple[int, str, bool]] = dataclasses.field(default_factory=list)
    #: [(lineno, dotted)] — callables passed as call arguments
    #: (``guard.run(self._tpu.solve, ...)``, ``Thread(target=self._loop)``):
    #: the callee runs them, so they link as closure edges
    refs: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    #: [(lineno, end_lineno, ref)] — `with <ref>:` acquisitions; ref is
    #: "self._lock"-style or a bare module-global name.  Closure bodies are
    #: excluded (same reason as above).
    locks: List[Tuple[int, int, str]] = dataclasses.field(default_factory=list)
    #: [(lineno, kind)] — blocking host<->device sync constructs
    syncs: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    #: local var name -> [raw type exprs] (constructor calls / annotations)
    local_types: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    #: parameter name -> raw annotation expr
    param_types: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ClassSummary:
    name: str
    lineno: int
    bases: List[str] = dataclasses.field(default_factory=list)
    methods: List[str] = dataclasses.field(default_factory=list)
    #: self attribute -> [raw type exprs seen assigned to it]
    attr_types: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    #: self attribute -> lock kind name ("Lock"/"RLock"/"Condition")
    locks: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FileSummary:
    path: str
    module: str               #: dotted module name derived from the path
    #: local name -> absolute dotted target ("pkg.mod" or "pkg.mod.symbol")
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    functions: List[FuncSummary] = dataclasses.field(default_factory=list)
    classes: Dict[str, ClassSummary] = dataclasses.field(default_factory=dict)
    #: module-level lock name -> kind
    module_locks: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: module-level names bound to compiled callables (KT013's taint needs
    #: "np.asarray(compiled(...))" to count as a device read)
    jitted: List[str] = dataclasses.field(default_factory=list)
    #: [(lineno, pattern)] — every ``KT_*`` environment read in the file
    #: (KT022); dynamically-suffixed keys (f-strings) become ``KT_FOO_*``
    #: wildcard patterns
    env_reads: List[Tuple[int, str]] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "FileSummary":
        funcs = [FuncSummary(**{**f, "calls": [tuple(c) for c in f["calls"]],
                                "refs": [tuple(r) for r in f["refs"]],
                                "locks": [tuple(x) for x in f["locks"]],
                                "syncs": [tuple(s) for s in f["syncs"]]})
                 for f in d["functions"]]
        classes = {k: ClassSummary(**v) for k, v in d["classes"].items()}
        return cls(path=d["path"], module=d["module"], imports=d["imports"],
                   functions=funcs, classes=classes,
                   module_locks=d["module_locks"], jitted=d["jitted"],
                   env_reads=[tuple(e) for e in d.get("env_reads", [])])


def module_name(path: str) -> str:
    """Dotted module name for a slash-normalized .py path."""
    parts = path.replace("\\", "/").lstrip("/").split("/")
    parts[-1] = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(p for p in parts if p)


def _is_pkg(path: str) -> bool:
    return path.endswith("__init__.py")


# ---- extraction ----------------------------------------------------------


def _ann_types(node: Optional[ast.AST]) -> List[str]:
    """Raw class-name strings named by a type annotation: unwraps
    ``Optional[X]``, string annotations, and ``Union``-style subscripts."""
    if node is None:
        return []
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return []
    if isinstance(node, (ast.Name, ast.Attribute)):
        d = dotted_name(node)
        return [d] if d else []
    if isinstance(node, ast.Subscript):
        head = dotted_name(node.value) or ""
        if head.split(".")[-1] in ("Optional", "Union"):
            inner = node.slice
            elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
            out: List[str] = []
            for e in elts:
                out.extend(_ann_types(e))
            return out
    return []


def _value_types(node: ast.AST, param_types: Dict[str, str]) -> List[str]:
    """Raw type strings for an assigned value: constructor calls (possibly
    behind ``or`` / ``if-else`` defaulting) and annotated-parameter
    passthrough (``self.x = scheduler`` with ``scheduler: BatchScheduler``)."""
    out: List[str] = []
    if isinstance(node, ast.Call):
        d = dotted_name(node.func)
        if d and d.split(".")[-1][:1].isupper():
            out.append(d)
    elif isinstance(node, ast.Name) and node.id in param_types:
        out.append(param_types[node.id])
    elif isinstance(node, ast.BoolOp):
        for v in node.values:
            out.extend(_value_types(v, param_types))
    elif isinstance(node, ast.IfExp):
        out.extend(_value_types(node.body, param_types))
        out.extend(_value_types(node.orelse, param_types))
    return out


def _lock_ctor(node: ast.AST) -> Optional[str]:
    """``threading.Lock()`` / ``Lock()`` / RLock / Condition -> kind name."""
    if isinstance(node, ast.Call):
        d = dotted_name(node.func)
        if d is not None and d.split(".")[-1] in LOCK_KINDS:
            return d.split(".")[-1]
    return None


def _compiled_bound_names(tree: ast.AST) -> Set[str]:
    """Module-level names bound to compiled callables: ``f =
    torch.compile(g)``, ``f = torch.jit.script(g)`` / ``trace``, and
    ``@torch.compile`` / ``@torch.jit.script``-decorated defs.  Calling
    one returns device values like any program (KT013's taint)."""
    out: Set[str] = set()
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and compile_call(node.value.func):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in node.decorator_list:
                target = d.func if isinstance(d, ast.Call) else d
                if compile_call(target):
                    out.add(node.name)
    return out


def compile_call(func: ast.AST) -> Optional[str]:
    """The dotted name when ``func`` is ``torch.compile`` or one of
    ``torch.jit.*`` (``script``, ``trace``, ...), else None."""
    d = dotted_name(func)
    if d is None:
        return None
    if d == "torch.compile" or d.startswith("torch.jit."):
        return d
    return None


def _is_dtype(node: ast.AST) -> bool:
    """``torch.float32`` / ``torch.int8`` / ... — a ``.to()`` argument
    that converts the dtype and leaves the tensor where it is."""
    d = dotted_name(node)
    return d is not None and d.split(".")[0] == "torch" \
        and d.split(".")[-1] in TORCH_DTYPES


class _TaintScan:
    """KT001's light device taint, shared with KT013.

    A name is device-resident when it is bound from a device value: a
    ``torch.*`` constructor given ``device=``, ``.to(<device>)`` or
    ``.cuda()``, a call of :data:`DEVICE_CALLS` (the group-step scan, the
    packed-score kernel entries, the device programs) or of a module-level
    compiled callable, a parameter named in :data:`TAINT_PARAMS`, or any
    expression over such a name.  Metadata reads (``.shape``, ``.dtype``,
    ``.device``, ``.size()``, ``len()``) and the results of the host reads
    themselves (``.cpu()``, ``.item()``, ``np.asarray(t)``, ...) are host
    values.  Host numpy (``np.asarray(st.counts)``) stays untainted, so the
    rule does not cry wolf on tensorize code."""

    def __init__(self, fn: ast.AST, jitted: Set[str]):
        self.jitted = jitted
        self.tainted: Set[str] = set()
        # the convention holds for the closures too: the scan's group
        # step is ``def step(carry, g)`` inside ``_run_scan``
        for n in ast.walk(fn):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                for arg in n.args.args:
                    if arg.arg in TAINT_PARAMS:
                        self.tainted.add(arg.arg)
        changed = True
        while changed:
            changed = False
            for n in ast.walk(fn):
                if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    value = n.value
                    targets = n.targets if isinstance(n, ast.Assign) \
                        else [n.target]
                elif isinstance(n, (ast.For, ast.comprehension)):
                    value, targets = n.iter, [n.target]
                else:
                    continue
                if value is None or not self.expr(value):
                    continue
                for nm in _bound_names(targets):
                    if nm not in self.tainted:
                        self.tainted.add(nm)
                        changed = True

    def expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in META_ATTRS:
                return False
            return self.expr(node.value)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, (ast.Lambda, ast.Constant)):
            return False
        return any(self.expr(c) for c in ast.iter_child_nodes(node))

    def _call(self, n: ast.Call) -> bool:
        func = n.func
        d = dotted_name(func)
        leaf = d.split(".")[-1] if d is not None else None
        if isinstance(func, ast.Attribute):
            if func.attr in HOST_READS or func.attr in META_CALLS:
                return False  # the read's result is a host value
            if func.attr == "cuda":
                return True
            if func.attr == "to":
                if any(kw.arg == "device" for kw in n.keywords):
                    return True
                if n.args and not _is_dtype(n.args[0]):
                    return True
            if d is not None and d.split(".")[0] in ("np", "numpy") \
                    and leaf in HOST_NUMPY:
                return False
        elif isinstance(func, ast.Name) and func.id in (
                HOST_BUILTINS | {"len"}):
            return False
        if leaf in DEVICE_CALLS or d in self.jitted or leaf in self.jitted:
            return True
        if d is not None and d.startswith("torch.") and any(
                kw.arg == "device" and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value in (None, "cpu"))
                for kw in n.keywords):
            return True
        return any(self.expr(c) for c in ast.iter_child_nodes(n))


def _bound_names(targets) -> List[str]:
    """Names an assignment binds: plain names and tuple/list/starred
    unpacking.  ``self.x = <device>`` binds an attribute, not ``self``."""
    out: List[str] = []
    stack = list(targets)
    while stack:
        t = stack.pop()
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
    return out


def _scan_syncs(fn: ast.AST, taint: _TaintScan, fence_lines: set,
                skip_defs: bool) -> List[Tuple[int, str]]:
    """Blocking sync constructs in ``fn``.  Closure bodies are INCLUDED
    (KT001 precedent: closures scan with their enclosing method) unless the
    nested def itself is fence-annotated; when ``skip_defs`` the scan stops
    at nested defs entirely (they are separate FuncSummary entries)."""
    out: List[Tuple[int, str]] = []

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if skip_defs or child.lineno in fence_lines:
                    continue
            kind = None
            if isinstance(child, ast.Call):
                kind = sync_kind(child, taint)
            elif isinstance(child, (ast.If, ast.While, ast.IfExp,
                                    ast.Assert)):
                kind = _truth_test(child.test, taint)
            if kind is not None:
                out.append((child.lineno, kind))
            visit(child)

    visit(fn)
    return out


def _truth_test(test: ast.AST, taint: _TaintScan) -> Optional[str]:
    """``if t.any():`` / ``while t.all():`` on a device value: the branch
    needs the value on the host."""
    if isinstance(test, ast.UnaryOp):
        test = test.operand
    if isinstance(test, ast.Call) and isinstance(test.func, ast.Attribute) \
            and test.func.attr in ("any", "all") \
            and taint.expr(test.func.value):
        return f"`if t.{test.func.attr}()` on a device value"
    return None


def sync_kind(n: ast.Call, taint: _TaintScan) -> Optional[str]:
    """What host<->device sync the call ``n`` is, or None.  The card-wide
    waits (``torch.cuda.synchronize()``, ``Event``/``Stream``
    ``.synchronize()``, ``Event.elapsed_time``) always are; the reads
    (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.nonzero()``,
    ``float/int/bool(t)``, ``np.asarray/np.array(t)``) are on a device
    value."""
    func = n.func
    if isinstance(func, ast.Attribute):
        if func.attr in BLOCKING:
            return f"`.{func.attr}()`"
        if func.attr in HOST_READS and taint.expr(func.value):
            return f"`.{func.attr}()` on a device value"
        if func.attr in HOST_NUMPY:
            root = dotted_name(func.value)
            if root in ("np", "numpy") and n.args and taint.expr(n.args[0]):
                return f"`np.{func.attr}()` on a device value"
    elif (isinstance(func, ast.Name) and func.id in HOST_BUILTINS
          and n.args and taint.expr(n.args[0])):
        return f"`{func.id}()` on a device value"
    return None


def _with_lock_ref(item: ast.withitem) -> Optional[str]:
    ctx = item.context_expr
    d = dotted_name(ctx)
    if d is None:
        return None
    parts = d.split(".")
    if parts[0] == "self" and len(parts) >= 2:
        return d
    if len(parts) == 1 and (parts[0].isupper() or parts[0].startswith("_")):
        # module-global lock convention (_STATE_LOCK, _defaults_lock)
        return d
    return None


def _env_reads(f: SourceFile) -> List[Tuple[int, str]]:
    """Every ``KT_*`` environment-variable READ in the file (KT022).

    Matched shapes (the package's actual idioms — validated against every
    knob in the tree, not a grep):

    - ``os.environ.get("KT_X")`` / ``os.getenv("KT_X")`` /
      ``os.environ.setdefault("KT_X", ...)``
    - ``os.environ["KT_X"]`` in Load context (Store/Del are writes)
    - one-hop module-constant indirection: ``NAME = "KT_X"`` then
      ``environ.get(NAME)`` (admission/policy.py's DEFAULT_CLASS_ENV)
    - wrapper helpers whose name mentions ``env`` called with a literal
      key (``_env_int("KT_X", 4)``)
    - registry declarations binding an env key through an ``env=``
      keyword (``KnobSpec(..., env="KT_X", ...)`` — the tuning
      registry's knobs are READ through the spec's ``from_env``, whose
      dynamic ``self.env`` lookup is invisible to the shapes above)
    - f-string keys with a literal ``KT_`` head become WILDCARD patterns
      (``f"KT_QUOTA_{cls}"`` -> ``KT_QUOTA_*``) — the README documents
      those as a family row
    """
    consts: Dict[str, str] = {}
    for node in ast.iter_child_nodes(f.tree):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str) \
                and node.value.value.startswith("KT_"):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    consts[t.id] = node.value.value

    def key_of(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value if node.value.startswith("KT_") else None
        if isinstance(node, ast.Name):
            return consts.get(node.id)
        if isinstance(node, ast.JoinedStr) and node.values:
            head = node.values[0]
            if isinstance(head, ast.Constant) \
                    and isinstance(head.value, str) \
                    and head.value.startswith("KT_"):
                return head.value + "*"
        return None

    out: List[Tuple[int, str]] = []
    for n in file_nodes(f):
        if isinstance(n, ast.Call):
            for kw in n.keywords:
                if kw.arg == "env":
                    key = key_of(kw.value)
                    if key is not None:
                        out.append((n.lineno, key))
            d = dotted_name(n.func)
            if d is None or not n.args:
                continue
            base = d.split(".")[-1]
            direct = (base == "getenv" or d.endswith("environ.get")
                      or d.endswith("environ.setdefault"))
            wrapper = not direct and "env" in base.lower()
            if direct or wrapper:
                key = key_of(n.args[0])
                if key is not None:
                    out.append((n.lineno, key))
        elif isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Load):
            d = dotted_name(n.value)
            if d is not None and d.endswith("environ"):
                key = key_of(n.slice)
                if key is not None:
                    out.append((n.lineno, key))
    return out


def summarize(f: SourceFile) -> FileSummary:
    """Extract the whole-program facts for one parsed file."""
    mod = module_name(f.path)
    summ = FileSummary(path=f.path, module=mod)
    summ.env_reads = _env_reads(f)
    pkg_parts = mod.split(".") if _is_pkg(f.path) else mod.split(".")[:-1]

    # imports
    for node in file_nodes(f):
        if isinstance(node, ast.Import):
            for a in node.names:
                summ.imports[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
            else:
                base = []
            src = ".".join(base + ([node.module] if node.module else []))
            for a in node.names:
                if a.name == "*":
                    continue
                summ.imports[a.asname or a.name] = (
                    f"{src}.{a.name}" if src else a.name)

    # module-level locks + jitted names
    for node in ast.iter_child_nodes(f.tree):
        if isinstance(node, ast.Assign):
            kind = _lock_ctor(node.value)
            if kind is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        summ.module_locks[t.id] = kind
    jitted = _compiled_bound_names(f.tree)
    summ.jitted = sorted(jitted)

    # classes + functions
    def visit(node: ast.AST, cls: Optional[ast.ClassDef], prefix: str,
              in_func: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                cs = ClassSummary(
                    name=child.name, lineno=child.lineno,
                    bases=[b for b in (dotted_name(x) for x in child.bases)
                           if b],
                )
                summ.classes[child.name] = cs
                visit(child, child, f"{child.name}.", in_func)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _summarize_func(summ, f, child, cls, prefix, in_func, jitted)
                visit(child, cls, f"{prefix}{child.name}.", True)
            else:
                visit(child, cls, prefix, in_func)

    visit(f.tree, None, "", False)
    return summ


def _summarize_func(summ: FileSummary, f: SourceFile, fn: ast.AST,
                    cls: Optional[ast.ClassDef], prefix: str, nested: bool,
                    jitted: Set[str]) -> None:
    qual = f"{prefix}{fn.name}"
    fs = FuncSummary(
        qual=qual, cls=cls.name if cls is not None else None,
        lineno=fn.lineno, end_lineno=getattr(fn, "end_lineno", fn.lineno),
        fence=fn.lineno in f.fence_lines, nested=nested,
    )
    if cls is not None and not nested:
        summ.classes[cls.name].methods.append(fn.name)

    for arg in list(fn.args.args) + list(fn.args.kwonlyargs):
        types = _ann_types(arg.annotation)
        if types:
            fs.param_types[arg.arg] = types[0]

    taint = _TaintScan(fn, jitted)
    fs.syncs = _scan_syncs(fn, taint, f.fence_lines, skip_defs=False)

    # calls / locks / assignments: stop at nested defs (their own summary)
    # and mark lambda bodies in_closure (they do not run where they appear)
    def visit(node: ast.AST, in_closure: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            closure = in_closure or isinstance(child, ast.Lambda)
            if isinstance(child, ast.Call):
                d = dotted_name(child.func)
                if d is not None:
                    fs.calls.append((child.lineno, d, closure))
                for arg in list(child.args) + [k.value
                                               for k in child.keywords]:
                    if isinstance(arg, (ast.Name, ast.Attribute)):
                        ref = dotted_name(arg)
                        if ref is not None:
                            fs.refs.append((child.lineno, ref))
            if isinstance(child, ast.With) and not closure:
                for item in child.items:
                    ref = _with_lock_ref(item)
                    if ref is not None:
                        fs.locks.append((
                            child.lineno,
                            getattr(child, "end_lineno", child.lineno), ref))
            if isinstance(child, ast.Assign) and not closure:
                types = _value_types(child.value, fs.param_types)
                for t in child.targets:
                    self_attr = _self_attr(t)
                    if self_attr is not None and cls is not None:
                        entry = summ.classes[cls.name].attr_types.setdefault(
                            self_attr, [])
                        for ty in types:
                            if ty not in entry:
                                entry.append(ty)
                        kind = _lock_ctor(child.value)
                        if kind is not None:
                            summ.classes[cls.name].locks[self_attr] = kind
                    elif isinstance(t, ast.Name) and types:
                        entry = fs.local_types.setdefault(t.id, [])
                        for ty in types:
                            if ty not in entry:
                                entry.append(ty)
            if isinstance(child, ast.AnnAssign) and not closure:
                self_attr = _self_attr(child.target)
                types = _ann_types(child.annotation)
                if not types and child.value is not None:
                    types = _value_types(child.value, fs.param_types)
                if self_attr is not None and cls is not None and types:
                    entry = summ.classes[cls.name].attr_types.setdefault(
                        self_attr, [])
                    for ty in types:
                        if ty not in entry:
                            entry.append(ty)
                elif isinstance(child.target, ast.Name) and types:
                    fs.local_types.setdefault(child.target.id, []).extend(
                        t for t in types
                        if t not in fs.local_types.get(child.target.id, []))
            visit(child, closure)

    visit(fn, False)
    summ.functions.append(fs)


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


# ---------------------------------------------------------------------------
# summary cache
# ---------------------------------------------------------------------------


class SummaryCache:
    """Per-file summary cache keyed on content hash.

    ``path=None`` keeps the cache in-memory only (tests); otherwise it
    persists as one JSON file (default: under the user's cache dir —
    ``$XDG_CACHE_HOME``/``~/.cache`` — NEVER the world-shared temp dir,
    where another local user could pre-create the file the lint gate
    trusts; override with ``KT_LINT_CACHE``, ``0`` disables).  A stale or
    corrupt cache file is discarded wholesale — the cache is an
    accelerator, never a source of truth."""

    def __init__(self, path: Optional[Path] = None):
        self.path = path
        self.hits = 0
        self.misses = 0
        self._entries: Dict[str, dict] = {}
        if path is not None and Path(path).exists():
            try:
                data = json.loads(Path(path).read_text())
                if data.get("version") == SUMMARY_VERSION:
                    self._entries = data.get("entries", {})
            except (OSError, ValueError):
                self._entries = {}

    @classmethod
    def default(cls) -> "SummaryCache":
        env = os.environ.get("KT_LINT_CACHE")
        if env == "0":
            return cls(path=None)
        if env:
            return cls(path=Path(env))
        base = Path(os.environ.get("XDG_CACHE_HOME")
                    or Path.home() / ".cache") / "karpenter-ktlint-torch"
        try:
            base.mkdir(parents=True, exist_ok=True)
        except OSError:
            return cls(path=None)  # no writable cache dir: run uncached
        return cls(path=base / "cache.json")

    def get(self, f: SourceFile) -> FileSummary:
        # keyed by (derived module, content hash), not raw path: an
        # explicit-path run (`ktlint karpenter_tpu_torch`) and the package run
        # see the same file and must share one entry.  The module part
        # matters — relative-import resolution in the summary depends on
        # the path-derived module, so identical text seen under a
        # different package spelling must NOT hit.
        sha = hashlib.sha256(f.text.encode()).hexdigest()
        key = f"{module_name(f.path)}:{sha}"
        entry = self._entries.get(key)
        if entry is not None:
            try:
                summ = FileSummary.from_json(entry["summary"])
            except (KeyError, TypeError):
                pass  # format drift inside one entry: re-extract
            else:
                summ.path = f.path  # the caller's spelling of the path
                self.hits += 1
                return summ
        self.misses += 1
        summ = summarize(f)
        self._entries[key] = {"summary": summ.to_json()}
        return summ

    def save(self) -> None:
        if self.path is None or self.misses == 0:
            return
        try:
            tmp = Path(f"{self.path}.tmp.{os.getpid()}")
            tmp.write_text(json.dumps(
                {"version": SUMMARY_VERSION, "entries": self._entries}))
            tmp.replace(self.path)
        except OSError:
            pass  # cache is best-effort; the run already has its summaries


# ---------------------------------------------------------------------------
# the linked project
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FuncNode:
    """One function in the linked graph.  ``fid`` is ``module:qual``."""

    fid: str
    summary: FuncSummary
    path: str
    module: str
    #: resolved callees: [(lineno, callee fid, in_closure)]
    edges: List[Tuple[int, str, bool]] = dataclasses.field(default_factory=list)


class Project:
    """Symbol table + resolved call graph over a set of summaries."""

    def __init__(self, summaries: Sequence[FileSummary]):
        self.summaries = list(summaries)
        self.modules: Dict[str, FileSummary] = {s.module: s for s in summaries}
        self.funcs: Dict[str, FuncNode] = {}
        #: class id ("module:Class") -> ClassSummary
        self.classes: Dict[str, ClassSummary] = {}
        self._class_by_name: Dict[str, List[str]] = {}
        self._func_index: Dict[str, FuncSummary] = {}
        self.unresolved: List[Tuple[str, int, str]] = []  # (fid, line, name)
        for s in summaries:
            for cname, cs in s.classes.items():
                cid = f"{s.module}:{cname}"
                self.classes[cid] = cs
                self._class_by_name.setdefault(cname, []).append(cid)
            for fn in s.functions:
                fid = f"{s.module}:{fn.qual}"
                self.funcs[fid] = FuncNode(
                    fid=fid, summary=fn, path=s.path, module=s.module)
        self._link()

    @classmethod
    def build(cls, files: Sequence[SourceFile],
              cache: Optional[SummaryCache] = None) -> "Project":
        cache = cache if cache is not None else SummaryCache(path=None)
        project = cls([cache.get(f) for f in files])
        cache.save()
        return project

    # ---- symbol resolution ---------------------------------------------

    def resolve_class(self, module: str, raw: str) -> Optional[str]:
        """Class id for a raw type string as seen from ``module``."""
        if not raw:
            return None
        parts = raw.split(".")
        summ = self.modules.get(module)
        # same-module class
        if summ is not None and parts[0] in summ.classes and len(parts) == 1:
            return f"{module}:{parts[0]}"
        # through the import table
        if summ is not None and parts[0] in summ.imports:
            target = summ.imports[parts[0]]
            return self._class_at(".".join([target] + parts[1:]))
        # unique bare-name fallback (facade params annotated with a class
        # the module only imports under TYPE_CHECKING, doc examples, etc.)
        if len(parts) == 1:
            cands = self._class_by_name.get(parts[0], [])
            if len(cands) == 1:
                return cands[0]
        return None

    def _class_at(self, dotted: str) -> Optional[str]:
        """Class id for an absolute dotted path ``pkg.mod.Class``."""
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:i])
            if mod in self.modules and parts[i] in self.modules[mod].classes:
                if i == len(parts) - 1:
                    return f"{mod}:{parts[i]}"
        return None

    def _func_at(self, dotted: str,
                 _seen: Optional[Set[str]] = None) -> Optional[str]:
        """fid for an absolute dotted path ``pkg.mod.func``.  ``_seen``
        bounds re-export chains: a circular ``from . import f`` alias pair
        must resolve to None, never recurse the lint run to death."""
        seen = _seen if _seen is not None else set()
        if dotted in seen:
            return None
        seen.add(dotted)
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:i])
            if mod not in self.modules:
                continue
            qual = ".".join(parts[i:])
            fid = f"{mod}:{qual}"
            if fid in self.funcs:
                return fid
            # pkg re-export: from .sub import f in __init__
            summ = self.modules[mod]
            if parts[i] in summ.imports and i == len(parts) - 1:
                return self._func_at(summ.imports[parts[i]], seen)
        return None

    def method_on(self, cid: str, name: str,
                  _seen: Optional[Set[str]] = None) -> Optional[str]:
        """fid of ``name`` on class ``cid``, walking project-local bases."""
        seen = _seen or set()
        if cid in seen:
            return None
        seen.add(cid)
        cs = self.classes.get(cid)
        if cs is None:
            return None
        module = cid.split(":", 1)[0]
        if name in cs.methods:
            return f"{module}:{cs.name}.{name}"
        for base in cs.bases:
            base_cid = self.resolve_class(module, base)
            if base_cid is not None:
                found = self.method_on(base_cid, name, seen)
                if found is not None:
                    return found
        return None

    def attr_class(self, cid: str, attr: str) -> Optional[str]:
        """Class id of ``self.<attr>`` on ``cid`` (first resolvable type)."""
        cs = self.classes.get(cid)
        if cs is None:
            return None
        module = cid.split(":", 1)[0]
        for raw in cs.attr_types.get(attr, []):
            got = self.resolve_class(module, raw)
            if got is not None:
                return got
        return None

    # ---- call resolution -----------------------------------------------

    def _resolve_call(self, node: FuncNode, dotted: str) -> Optional[str]:
        summ = self.modules.get(node.module)
        fn = node.summary
        parts = dotted.split(".")

        def chain_method(start_cid: Optional[str],
                         chain: List[str]) -> Optional[str]:
            cid = start_cid
            for attr in chain[:-1]:
                if cid is None:
                    return None
                cid = self.attr_class(cid, attr)
            if cid is None:
                return None
            return self.method_on(cid, chain[-1])

        if parts[0] == "self" and fn.cls is not None and len(parts) >= 2:
            return chain_method(f"{node.module}:{fn.cls}", parts[1:])

        root = parts[0]
        # locally-typed variable / annotated parameter receiver
        raw_types = list(fn.local_types.get(root, []))
        if root in fn.param_types:
            raw_types.append(fn.param_types[root])
        for raw in raw_types:
            cid = self.resolve_class(node.module, raw)
            if cid is not None and len(parts) >= 2:
                got = chain_method(cid, parts[1:])
                if got is not None:
                    return got

        if len(parts) == 1:
            # a nested def of this function or of an enclosing one: the
            # port's dispatch wraps its device calls in local closures
            # (``_call`` / ``_hung`` in ``_solve_tpu``), called by name
            scope = fn.qual
            while True:
                fid = f"{node.module}:{scope}.{root}"
                if fid in self.funcs and self.funcs[fid].summary.nested:
                    return fid
                if "." not in scope:
                    break
                scope = scope.rsplit(".", 1)[0]
                if f"{node.module}:{scope}" not in self.funcs:
                    break  # reached the class: methods never bind bare
            # same-module function (methods never bind bare), constructor,
            # or imported symbol
            fid = f"{node.module}:{root}"
            if fid in self.funcs and self.funcs[fid].summary.cls is None:
                return fid
            if summ is not None and root in summ.classes:
                return self.method_on(f"{node.module}:{root}", "__init__")
            if summ is not None and root in summ.imports:
                target = summ.imports[root]
                got = self._func_at(target)
                if got is not None:
                    return got
                cid = self._class_at(target)
                if cid is not None:
                    return self.method_on(cid, "__init__")
            return None

        # dotted root: imported module / imported or local class
        if summ is not None and root in summ.imports:
            target = ".".join([summ.imports[root]] + parts[1:])
            got = self._func_at(target)
            if got is not None:
                return got
            cid = self._class_at(target)
            if cid is not None:
                return self.method_on(cid, "__init__")
            # Class.method through an imported class
            cid = self._class_at(".".join([summ.imports[root]] + parts[1:-1]))
            if cid is not None:
                return self.method_on(cid, parts[-1])
        if summ is not None and root in summ.classes and len(parts) == 2:
            return self.method_on(f"{node.module}:{root}", parts[1])
        return None

    def _link(self) -> None:
        for node in self.funcs.values():
            for lineno, dotted, in_closure in node.summary.calls:
                fid = self._resolve_call(node, dotted)
                if fid is not None:
                    node.edges.append((lineno, fid, in_closure))
                else:
                    self.unresolved.append((node.fid, lineno, dotted))
            for lineno, dotted in node.summary.refs:
                # most arguments are data, not callables: only a reference
                # that resolves to a function links, and nothing else is
                # recorded as unresolved
                fid = self._resolve_call(node, dotted)
                if fid is not None and not fid.endswith(".__init__"):
                    node.edges.append((lineno, fid, True))

    # ---- shared queries -------------------------------------------------

    def find_function(self, path_suffix: str, qual: str) -> Optional[str]:
        """fid of ``qual`` in the file whose path ends with ``path_suffix``."""
        for s in self.summaries:
            if s.path.endswith(path_suffix):
                fid = f"{s.module}:{qual}"
                if fid in self.funcs:
                    return fid
        return None

    def lock_id(self, node: FuncNode, ref: str) -> Optional[str]:
        """Canonical lock name for an acquisition ref in ``node``:
        ``ClassName._lock`` for instance locks, ``mod._NAME`` for module
        globals.  None when the ref resolves to no declared lock (the
        acquisition still counts; kind is then unknown)."""
        fn = node.summary
        parts = ref.split(".")
        if parts[0] == "self" and fn.cls is not None:
            cid: Optional[str] = f"{node.module}:{fn.cls}"
            for attr in parts[1:-1]:
                cid = self.attr_class(cid, attr) if cid else None
            if cid is not None:
                owner = cid.split(":", 1)[1]
                return f"{owner}.{parts[-1]}"
            return f"{fn.cls}.{parts[-1]}" if len(parts) == 2 else None
        summ = self.modules.get(node.module)
        if summ is not None and ref in summ.module_locks:
            return f"{node.module.split('.')[-1]}.{ref}"
        return None

    def lock_kind(self, node: FuncNode, ref: str) -> Optional[str]:
        fn = node.summary
        parts = ref.split(".")
        if parts[0] == "self" and fn.cls is not None and len(parts) == 2:
            cs = self.modules[node.module].classes.get(fn.cls)
            # fall back through bases for inherited locks
            cid: Optional[str] = f"{node.module}:{fn.cls}"
            while cid is not None:
                cs = self.classes.get(cid)
                if cs is None:
                    break
                if parts[1] in cs.locks:
                    return cs.locks[parts[1]]
                module = cid.split(":", 1)[0]
                cid = None
                for base in cs.bases:
                    got = self.resolve_class(module, base)
                    if got is not None:
                        cid = got
                        break
            return None
        summ = self.modules.get(node.module)
        if summ is not None and ref in summ.module_locks:
            return summ.module_locks[ref]
        return None


def build_project(files: Sequence[SourceFile],
                  cache: Optional[SummaryCache] = None) -> Project:
    """Module-level convenience used by the rule modules and the CLI."""
    return Project.build(files, cache=cache)
