"""ktlint — AST-level solver-invariant analyzer for karpenter_tpu_torch.

The port's serving stack is threaded (``SolvePipeline``'s dispatcher, the
guard's call threads, admission, the delta table, the ranks of a
multi-process job) and asynchronous on the card (enqueue now, read back
later).  The invariants it relies on — one global lock order, no stray
host<->device sync outside the fences, labeled metric series zero-inited,
the eager no-compile serving contract — are encoded here as rules, checked
by ``python -m karpenter_tpu_torch.analysis`` and tests/test_torch_lint.py.

Rules live in ``analysis/rules/kt0NN.py`` (KT001-KT025; the catalog and
the annotation grammar are the reference's, docs/ANALYSIS.md).  The rules
about device idiom speak the port's vocabulary: a sync is ``.item()`` /
``.cpu()`` / ``torch.cuda.synchronize()`` (KT001, KT013), a compiled
callable is ``torch.compile`` / ``torch.jit`` or a per-call CUDA graph
(KT008), a layout object is the port's ``Mesh`` and its factories
(KT011), and the megabatch readback is ``read_slot_rows`` (KT018).

Annotation grammar (shared by the rules):

- suppression — ``# ktlint: allow[KT0NN] <reason>`` on the finding line or
  anywhere in the contiguous pure-comment block directly above it.  The
  reason is mandatory; a bare ``allow[...]`` is itself reported (KT000) and
  does not suppress.
- fence — ``# ktlint: fence <why>`` on a ``def`` line (or anywhere in the
  contiguous pure-comment block directly above it) marks the function as an
  allowlisted host<->device sync point for KT001 / KT013.
- guarded-by — ``self._attr = ...  # guarded-by: _lock`` in a class body
  declares that ``self._attr`` may only be touched inside
  ``with self._lock:`` (KT004).

This module is pure stdlib (``ast`` + ``re``) — importing it must never
pull torch, numpy or grpc, so the lint runs anywhere, the card's host
included.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*ktlint:\s*allow\[(?P<rule>KT\d{3})\](?:\s+(?P<reason>\S.*))?"
)
FENCE_RE = re.compile(r"#\s*ktlint:\s*fence\b")
GUARDED_RE = re.compile(r"#\s*guarded-by:\s*(?P<lock>\w+)")

#: generated files are not ours to lint
EXCLUDED_SUFFIXES = ("_pb2.py",)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    hint: str = ""

    def format(self) -> str:
        out = f"{self.path}:{self.line}: {self.rule} {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_json(self) -> dict:
        """The ``--format json`` shape (schema: docs/ANALYSIS.md)."""
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint}


@dataclasses.dataclass
class SourceFile:
    """One parsed source file plus its ktlint annotations."""

    path: str                  # slash-normalized, package-relative
    text: str
    lines: List[str]
    tree: ast.AST
    #: line -> {rule: reason} for well-formed suppressions
    suppressions: Dict[int, Dict[str, str]]
    #: lines carrying a malformed (reason-less) suppression
    malformed: List[int]
    #: ``def`` linenos annotated as KT001 fences
    fence_lines: set
    #: lazily cached whole-tree artifacts (file_nodes/file_parents): every
    #: rule iterates the package's ASTs, and 20+ rules each re-running
    #: ``ast.walk``/``parents_map`` over every file would dominate the
    #: package lint's wall
    _nodes: Optional[List[ast.AST]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _parents: Optional[Dict[ast.AST, ast.AST]] = dataclasses.field(
        default=None, repr=False, compare=False)


def load_source(text: str, path: str) -> SourceFile:
    tree = ast.parse(text, filename=path)
    lines = text.splitlines()
    suppressions: Dict[int, Dict[str, str]] = {}
    malformed: List[int] = []
    fence_comment_lines = set()
    for i, line in enumerate(lines, 1):
        m = SUPPRESS_RE.search(line)
        if m:
            if m.group("reason"):
                suppressions.setdefault(i, {})[m.group("rule")] = m.group("reason")
            else:
                malformed.append(i)
        if FENCE_RE.search(line):
            fence_comment_lines.add(i)
    # resolve fence comments to the def they annotate: same line as the def,
    # or anywhere in the contiguous pure-comment block directly above it
    # (fence reasons routinely wrap onto a second line)
    fence_lines = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.lineno in fence_comment_lines:
                fence_lines.add(node.lineno)
                continue
            line = node.lineno - 1
            while _comment_only(lines, line):
                if line in fence_comment_lines:
                    fence_lines.add(node.lineno)
                    break
                line -= 1
    return SourceFile(
        path=path.replace("\\", "/"), text=text, lines=lines, tree=tree,
        suppressions=suppressions, malformed=malformed,
        fence_lines=fence_lines,
    )


def _comment_only(lines: List[str], lineno: int) -> bool:
    if not 1 <= lineno <= len(lines):
        return False
    return lines[lineno - 1].lstrip().startswith("#")


# ---- shared AST utilities ------------------------------------------------

def parents_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def file_nodes(f: SourceFile) -> List[ast.AST]:
    """The file's whole-tree preorder walk, computed once and shared by
    every rule (use instead of ``ast.walk(f.tree)`` for root walks;
    subtree walks still call ``ast.walk`` directly)."""
    if f._nodes is None:
        f._nodes = list(ast.walk(f.tree))
    return f._nodes


def file_parents(f: SourceFile) -> Dict[ast.AST, ast.AST]:
    """The file's child->parent map, computed once and shared by every
    rule (use instead of ``parents_map(f.tree)``)."""
    if f._parents is None:
        parents: Dict[ast.AST, ast.AST] = {}
        for node in file_nodes(f):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        f._parents = parents
    return f._parents


def file_functions(f: SourceFile):
    """Cached :func:`iter_functions` over the file's whole tree."""
    funcs = getattr(f, "_functions", None)
    if funcs is None:
        funcs = f._functions = iter_functions(f.tree)
    return funcs


def iter_functions(tree: ast.AST):
    """Yield ``(qualname, node, nested)`` for every function; ``nested`` is
    True when the function is defined inside another function (closures
    belong to their enclosing method's scan)."""
    out = []

    def visit(node: ast.AST, prefix: str, in_func: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out.append((q, child, in_func))
                visit(child, q + ".", True)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", in_func)
            else:
                visit(child, prefix, in_func)

    visit(tree, "", False)
    return out


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ---- driver --------------------------------------------------------------

def all_rules():
    from .rules import ALL_RULES

    return ALL_RULES


def analyze_files(
    files: Sequence[SourceFile], rules=None, cache=None, project=None,
) -> Tuple[List[Finding], List[Finding]]:
    """Run every rule over ``files``; returns ``(active, suppressed)``.

    Whole-program rules (``WHOLE_PROGRAM = True``) share ONE linked
    :class:`~karpenter_tpu_torch.analysis.callgraph.Project`, built lazily and —
    when ``cache`` is a :class:`~karpenter_tpu_torch.analysis.callgraph
    .SummaryCache` — from content-hash-cached per-file summaries.  A
    caller that already built a project for the same files (the
    ``--lock-order`` driver path, tests) passes it in; no second walk."""
    raw: List[Finding] = []
    for rule in rules if rules is not None else all_rules():
        if getattr(rule, "WHOLE_PROGRAM", False):
            if project is None:
                from .callgraph import Project

                project = Project.build(files, cache=cache)
            raw.extend(rule.check(files, project=project))
        else:
            raw.extend(rule.check(files))
    by_path = {f.path: f for f in files}
    for f in files:
        for line in f.malformed:
            raw.append(Finding(
                "KT000", f.path, line,
                "malformed suppression: `# ktlint: allow[KT00X]` requires a "
                "reason and does not suppress without one",
                hint="write `# ktlint: allow[KT00X] <reason>`",
            ))
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for fi in raw:
        f = by_path.get(fi.path)
        (suppressed if f is not None and _is_suppressed(f, fi) else
         active).append(fi)
    key = lambda fi: (fi.path, fi.line, fi.rule)  # noqa: E731
    return sorted(active, key=key), sorted(suppressed, key=key)


def _is_suppressed(f: SourceFile, finding: Finding) -> bool:
    if finding.rule == "KT000":
        return False  # the malformed-suppression report is not suppressible
    if finding.rule in f.suppressions.get(finding.line, {}):
        return True
    # or anywhere in the contiguous pure-comment block directly above
    line = finding.line - 1
    while _comment_only(f.lines, line):
        if finding.rule in f.suppressions.get(line, {}):
            return True
        line -= 1
    return False


def analyze_source(text: str, path: str, rules=None) -> List[Finding]:
    """Fixture/test helper: analyze one in-memory source; active findings."""
    active, _ = analyze_files([load_source(text, path)], rules=rules)
    return active


def package_root() -> Path:
    return Path(__file__).resolve().parents[1]


def collect_package_files(root: Optional[Path] = None) -> List[SourceFile]:
    root = Path(root) if root is not None else package_root()
    files: List[SourceFile] = []
    for p in sorted(root.rglob("*.py")):
        if "__pycache__" in p.parts:
            continue
        if any(str(p).endswith(s) for s in EXCLUDED_SUFFIXES):
            continue
        rel = f"{root.name}/{p.relative_to(root).as_posix()}"
        files.append(load_source(p.read_text(), rel))
    return files


def analyze_package(
    root: Optional[Path] = None, rules=None, cache=None,
) -> Tuple[List[Finding], List[Finding], int]:
    """Analyze the whole package; ``(active, suppressed, n_files)``.

    Package runs default to the persistent summary cache (``KT_LINT_CACHE``
    to relocate, ``KT_LINT_CACHE=0`` to disable), so a warm whole-program
    run skips the extraction walk."""
    if cache is None:
        from .callgraph import SummaryCache

        cache = SummaryCache.default()
    files = collect_package_files(root)
    active, suppressed = analyze_files(files, rules=rules, cache=cache)
    return active, suppressed, len(files)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="ktlint",
        description="repo-specific AST analyzer (rule catalog: docs/ANALYSIS.md)",
    )
    parser.add_argument("paths", nargs="*",
                        help="files or directories (default: the package)")
    parser.add_argument("--select", action="append", default=None,
                        metavar="KT00X", help="run only these rule IDs")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also print suppressed findings")
    parser.add_argument("--format", choices=["text", "json"], default="text",
                        help="output format (json schema: docs/ANALYSIS.md)")
    parser.add_argument("--lock-order", action="store_true",
                        help="print the KT012-derived global lock-"
                             "acquisition order and exit")
    parser.add_argument("--model", action="store_true",
                        help="model-check the delta-epoch and lease-"
                             "failover protocols (bounded exhaustive "
                             "exploration; exits 1 on violation)")
    parser.add_argument("--max-states", type=int, default=500_000,
                        help="state budget per model for --model")
    parser.add_argument("--proto-golden", action="store_true",
                        help="refresh the KT021 golden descriptor snapshot "
                             "from the live solver.proto and exit")
    args = parser.parse_args(argv)

    if args.proto_golden:
        from .rules import kt021

        out = kt021.write_golden()
        print(f"wrote {out}")
        return 0

    if args.model:
        from . import model

        return model.main(fmt=args.format, max_states=args.max_states)

    rules = all_rules()
    if args.select:
        want = set(args.select)
        rules = [r for r in rules if r.ID in want]
        unknown = want - {r.ID for r in rules}
        if unknown:
            parser.error(f"unknown rule id(s): {sorted(unknown)}")

    if args.paths:
        files = []
        for raw in args.paths:
            p = Path(raw)
            if p.is_dir():
                files.extend(collect_package_files(p))
            else:
                files.append(load_source(p.read_text(), str(p)))
    else:
        files = collect_package_files()

    # ONE summary cache and ONE project build per invocation: the
    # whole-program rules (KT012/KT013/KT014/KT022) and the --lock-order
    # path all share it — explicit-path runs included, now that cache
    # entries are keyed on (module, content-hash) rather than raw path.
    from .callgraph import Project, SummaryCache

    cache = SummaryCache.default()
    project = None
    if args.lock_order or any(getattr(r, "WHOLE_PROGRAM", False)
                              for r in rules):
        project = Project.build(files, cache=cache)

    if args.lock_order:
        from .rules import kt012

        graph = kt012.lock_graph(files, project)
        _nodes, edges, kinds = graph
        order = kt012.lock_order(files, project, graph=graph)
        if args.format == "json":
            import json

            print(json.dumps({
                "order": order,
                "kinds": {k: v for k, v in sorted(kinds.items())},
                "edges": sorted(f"{s} -> {d}" for (s, d) in edges),
            }, indent=2))
        else:
            print("global lock-acquisition order (outer first; "
                  "sanitize.LOCK_ORDER must stay a linear extension):")
            for i, lock in enumerate(order, 1):
                print(f"  {i:2d}. {lock}  [{kinds.get(lock) or 'unknown'}]")
            for (s, d), e in sorted(edges.items()):
                print(f"  edge {s} -> {d}: {e.witness()}")
        return 0

    active, suppressed = analyze_files(files, rules=rules, cache=cache,
                                       project=project)
    n_files = len(files)

    if args.format == "json":
        import json

        print(json.dumps({
            "findings": [fi.to_json() for fi in active],
            "suppressed": [fi.to_json() for fi in suppressed],
            "files": n_files,
        }, indent=2))
        return 1 if active else 0
    for fi in active:
        print(fi.format())
    if args.show_suppressed:
        for fi in suppressed:
            print(f"[suppressed] {fi.format()}")
    print(f"ktlint: {len(active)} finding(s), {len(suppressed)} suppressed, "
          f"{n_files} file(s)")
    return 1 if active else 0
