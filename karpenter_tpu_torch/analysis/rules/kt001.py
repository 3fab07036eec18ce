"""KT001 — implicit host↔device sync in solver hot paths.

CUDA launches are asynchronous: the serving path (``submit``, the
megabatch collector, ``SolvePipeline``) depends on the host staying free
between enqueue and read-back, so request N+1 tensorizes and enqueues
while request N runs on the card.  A stray ``.item()`` / ``.cpu()`` /
``float(t)`` / ``np.asarray(t)`` / ``if t.any():`` on a device tensor, or
a ``torch.cuda.synchronize()``, silently re-serializes the pipeline: the
host waits for the whole queue of the stream.  Sync constructs in the
hot-path files are therefore only allowed inside the *fence set*: the
functions whose job is to read back (``TpuSolver._read_back``,
``PendingTpuSolve.result``, ``read_slot_rows``, the guard's probe), each
annotated ``# ktlint: fence <why>`` on its ``def`` line.

The vocabulary is the port's (``analysis/callgraph.py`` holds it, shared
with KT013):

- **device values** (a light intra-function taint): names bound from a
  ``torch.*`` constructor given ``device=``, from ``.to(<device>)`` /
  ``.cuda()``, from the scan ``_run_scan``, the packed-score kernel
  entries or the device programs, plus parameters named ``carry`` / ``ys``
  (the solver's device carry convention);
- **reads** on a device value: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.nonzero()``, ``float/int/bool(t)``,
  ``np.asarray/np.array(t)`` and ``if t.any():`` / ``.all()``;
- **waits** that fire whatever the receiver: ``torch.cuda.synchronize()``,
  ``Event.synchronize()`` / ``Stream.synchronize()`` and
  ``Event.elapsed_time``.

Host numpy (``np.asarray(st.counts)``) and tensor metadata (``.shape``)
stay untainted, so the rule does not cry wolf on tensorize code.  The
fence set lives IN THE SOURCE, not here, so the exemption and its reason
sit next to the code they exempt and cannot go stale when a method is
renamed or split.
"""

from __future__ import annotations

from typing import List

from ..callgraph import _scan_syncs, _TaintScan
from ..ktlint import Finding, file_functions

ID = "KT001"
TITLE = "implicit host↔device sync outside the fence set"
HINT = ("move the sync into a fence function, or annotate the def with "
        "`# ktlint: fence <why>` if its body IS the sync point")

#: files whose functions are solver hot paths (package-relative suffixes)
HOT_SUFFIXES = ("solver/tpu.py", "solver/scheduler.py")


def _hot_suffix(path: str):
    for s in HOT_SUFFIXES:
        if path.endswith(s):
            return s
    return None


def check(files) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if _hot_suffix(f.path) is None:
            continue
        for _qual, fn, nested in file_functions(f):
            if nested:
                continue  # closures scan with their enclosing method
            if fn.lineno in f.fence_lines:
                continue
            taint = _TaintScan(fn, set())
            for lineno, kind in _scan_syncs(fn, taint, f.fence_lines,
                                            skip_defs=False):
                out.append(Finding(
                    ID, f.path, lineno,
                    f"{kind} is an implicit host↔device sync in a solver "
                    "hot path outside the fence set", hint=HINT,
                ))
    return out
