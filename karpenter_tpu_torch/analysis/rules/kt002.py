"""KT002 — raw wall/monotonic clock reads outside ``utils/clock.py``.

Every controller takes an injectable
:class:`karpenter_tpu_torch.utils.clock.Clock` (a clock injected
everywhere for testability); a raw
``time.time()`` / ``time.monotonic()`` bypasses it, making the behavior
untestable with ``FakeClock`` — the warm-failure backoff in ``solver/tpu.py``
was exactly this (untestable without sleeping out a 300 s backoff).
``time.perf_counter()`` is exempt: duration *measurement* is not scheduling
*time* and fake-advancing it would falsify metrics.

Aliases are tracked, not pattern-matched: ``import time as t`` flags
``t.time()``, and ``from time import monotonic`` is flagged AT THE IMPORT —
once the bare name is loose in the module every call site looks like any
other function call, so the import line is where the leak is stopped.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..ktlint import Finding, file_nodes

ID = "KT002"
TITLE = "raw time.time()/time.monotonic() outside utils/clock.py"
HINT = ("inject karpenter_tpu_torch.utils.clock.Clock and call clock.now() "
        "(tests drive it with FakeClock)")

EXEMPT_SUFFIX = "utils/clock.py"
CLOCK_CALLS = {"time", "monotonic"}


def _time_aliases(f) -> Set[str]:
    """Every name the ``time`` module is bound to in this file."""
    aliases: Set[str] = set()
    for n in file_nodes(f):
        if isinstance(n, ast.Import):
            for alias in n.names:
                if alias.name == "time":
                    aliases.add(alias.asname or "time")
    return aliases


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if f.path.endswith(EXEMPT_SUFFIX):
            continue
        aliases = _time_aliases(f)
        for n in file_nodes(f):
            if (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in CLOCK_CALLS
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id in aliases):
                out.append(Finding(
                    ID, f.path, n.lineno,
                    f"raw `{n.func.value.id}.{n.func.attr}()` outside "
                    "utils/clock.py",
                    hint=HINT,
                ))
            elif isinstance(n, ast.ImportFrom) and n.module == "time":
                for alias in n.names:
                    if alias.name in CLOCK_CALLS:
                        out.append(Finding(
                            ID, f.path, n.lineno,
                            f"`from time import {alias.name}` smuggles a raw "
                            "clock read past the injectable Clock (flagged "
                            "at the import: call sites are indistinguishable "
                            "once the bare name is bound)",
                            hint=HINT,
                        ))
    return out
