"""KT022 — knob-inventory drift between code and the README knob table.

The port's knob table — the first markdown table with an ``env`` column
under README's ``## The PyTorch/CUDA port`` heading — is the port's
complete operator surface: every ``KT_*`` the port reads.  (The
reference package's table, higher in the README, documents the
reference and is not this rule's to read.)  It drifts in both
directions:

- a PR adds a ``KT_*`` read and forgets the row: the knob exists, ships,
  and nobody can discover it;
- a PR renames or deletes a read and leaves the row: operators set an
  env var the code no longer looks at, silently.

The rule extracts every ``KT_*`` environment READ package-wide from the
call-graph summaries (``FileSummary.env_reads`` — direct
``environ.get``/``getenv``/``setdefault`` calls, Load-context
subscripts, one-hop module-constant indirection, ``env``-named wrapper
helpers, and f-string keys as ``KT_FOO_*`` wildcard patterns) and diffs
the set against the README table's env column.  Matching is
wildcard-aware in both directions (``fnmatch``): a documented
``KT_ADMIT_*`` family row covers every per-class quota read, and a
wildcard READ pattern is covered by any documented member.

Whole-program: the extraction rides the same cached
:class:`~karpenter_tpu_torch.analysis.callgraph.Project` build every other
interprocedural pass shares — no second AST walk.
"""

from __future__ import annotations

from fnmatch import fnmatchcase
from typing import Dict, List, Optional, Tuple

from ..ktlint import Finding, package_root

ID = "KT022"
TITLE = "KT_* knob read/documentation drift against the README knob table"
HINT = ("every KT_* env read needs a row in README.md's knob table (env "
        "column; `KT_FOO_*` family rows cover dynamic keys), and every "
        "documented knob needs a live read — delete stale rows when a "
        "knob is removed")

WHOLE_PROGRAM = True

_TABLE_HEADER_TOKEN = "env"

#: the README section that holds the port's knob table
PORT_HEADING = "## The PyTorch/CUDA port"


def readme_knobs(text: str) -> List[Tuple[int, str]]:
    """``(lineno, env_name)`` for every ``KT_*`` token in the env column
    of the port's knob table: the first markdown table whose header names
    an ``env`` column, read from the :data:`PORT_HEADING` section up to
    the next ``## `` heading.  A text without that heading (a fixture) is
    read whole.  Compound cells (``KT_RPC_RETRIES / KT_RPC_BACKOFF_MS``)
    yield one entry per token."""
    out: List[Tuple[int, str]] = []
    env_col: Optional[int] = None
    lines = text.splitlines()
    first, last, sectioned = 0, len(lines), False
    for i, line in enumerate(lines):
        if line.startswith(PORT_HEADING):
            first, sectioned = i, True
            for j in range(i + 1, len(lines)):
                if lines[j].startswith("## "):
                    last = j
                    break
            break
    done = False
    for i in range(first + 1, last + 1):
        line = lines[i - 1]
        stripped = line.strip()
        if not stripped.startswith("|"):
            if env_col is not None and sectioned:
                done = True  # the port's table ended: one table only
            env_col = None
            continue
        if done:
            break
        cells = [c.strip() for c in stripped.strip("|").split("|")]
        if env_col is None:
            heads = [c.strip("`* ").lower() for c in cells]
            if _TABLE_HEADER_TOKEN in heads:
                env_col = heads.index(_TABLE_HEADER_TOKEN)
            continue
        if all(set(c) <= {"-", ":", " "} for c in cells):
            continue  # the |---|---| separator row
        if env_col >= len(cells):
            continue
        for token in cells[env_col].replace("/", " ").split():
            token = token.strip("`,")
            if token.startswith("KT_"):
                out.append((i, token))
    return out


def _covered(pattern: str, others) -> bool:
    return any(fnmatchcase(pattern, o) or fnmatchcase(o, pattern)
               for o in others)


def check(files, project=None, readme: Optional[str] = None,
          ) -> List[Finding]:
    if project is None:
        from ..callgraph import build_project

        project = build_project(files)
    reads: Dict[str, Tuple[str, int]] = {}  # pattern -> first site
    for summ in project.summaries:
        for lineno, pattern in summ.env_reads:
            if pattern not in reads:
                reads[pattern] = (summ.path, lineno)
    # the documented-not-read direction needs the WHOLE package's read
    # set: a fixture run over a handful of files (or one file with a
    # stray env read) must not accuse every documented knob of being
    # dead.  Explicitly-passed readme text (the rule's own fixtures)
    # always diffs both ways.
    whole_package = readme is not None or len(files) > 20
    if readme is None:
        readme_path = package_root().parent / "README.md"
        try:
            readme = readme_path.read_text()
        except OSError:
            return []  # no README (vendored subset): nothing to diff
    knobs = readme_knobs(readme)
    documented = [k for _, k in knobs]
    out: List[Finding] = []
    for pattern in sorted(reads):
        if not _covered(pattern, documented):
            path, lineno = reads[pattern]
            out.append(Finding(
                ID, path, lineno,
                f"`{pattern}` is read here but has no row in the README "
                "knob table — the knob is undiscoverable",
                hint=HINT,
            ))
    if not whole_package:
        return out
    read_patterns = list(reads)
    seen = set()
    for lineno, knob in knobs:
        if knob in seen:
            continue
        seen.add(knob)
        if not _covered(knob, read_patterns):
            out.append(Finding(
                ID, "README.md", lineno,
                f"`{knob}` is documented in the knob table but no code "
                "reads it — operators setting it change nothing",
                hint=HINT,
            ))
    return out
