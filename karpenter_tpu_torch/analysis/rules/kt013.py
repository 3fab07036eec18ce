"""KT013 — interprocedural fence reachability from the serving entry points.

KT001 checks sync discipline *per function* in the two hot-path files; this
pass upgrades the invariant to what the pipeline actually needs: **every
call path from a serving entry point that reaches a blocking host<->device
sync must pass through a ``# ktlint: fence``-annotated function.**  A sync
two facades away from ``SolverService.Solve`` re-serializes the pipeline
exactly as hard as one written inline — sync-point drift is a whole-program
property.

Mechanism: walk the project call graph (``analysis/callgraph.py``) from
:data:`ENTRY_POINTS`.  Fence-annotated functions are *absorbing* — the
walk does not descend into them (their body IS the sanctioned sync point,
and everything they call executes inside the fence's latency budget by
declaration).  Constructors (``__init__``) are skipped: serving-path
construction is lazy one-time setup, not steady-state.  The graph follows
callables handed to a call (``guard.run(self._tpu.solve, ...)``) and the
local closures a dispatch wraps its device calls in.  Any visited
function containing a blocking sync is a finding, anchored at the sync
line, with the full offending call chain in the message.

Sync constructs (the port's vocabulary, ``analysis/callgraph.py``):
``torch.cuda.synchronize()`` / ``Event.synchronize()`` /
``Stream.synchronize()`` / ``Event.elapsed_time`` always; ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``.nonzero()``, ``float/int/
bool(t)``, ``np.asarray/np.array(t)`` and ``if t.any()`` only on
device-tainted values (KT001's taint, extended so a call to a
module-level compiled callable taints).  Host-side numpy therefore stays
quiet, exactly like KT001.  Uploads from pageable host memory are not in
the vocabulary: they wait for the copy, not for the queue of the stream.

An entry point that no longer resolves is itself a finding: a renamed
entry would otherwise silently shrink the audited surface to nothing.
Unresolvable *calls* (dynamic dispatch, callbacks) contribute no edge —
graceful degradation, pinned by tests/test_torch_lint.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..callgraph import Project, build_project
from ..ktlint import Finding

ID = "KT013"
TITLE = "blocking sync reachable from a serving entry point without a fence"
WHOLE_PROGRAM = True
HINT = ("route the sync through a `# ktlint: fence <why>`-annotated "
        "function (the fence set lives in the source, next to the code it "
        "exempts), or break the call edge; allow[KT013] on the sync line "
        "only with a reason that names why this path tolerates the stall")

#: the serving surface: (path suffix, qualname).  These are the functions
#: whose latency the system promises to bound — RPC entry, the pipeline
#: dispatcher (covers _flush/_dispatch_single/_finalize/_finalize_mega),
#: the scheduler's dispatch entries, and the controller ticks the operator
#: loop drives.
ENTRY_POINTS: Tuple[Tuple[str, str], ...] = (
    ("service/server.py", "SolverService.Solve"),
    ("service/server.py", "SolvePipeline.solve"),
    ("service/server.py", "SolvePipeline._loop"),
    ("solver/scheduler.py", "BatchScheduler.solve"),
    ("solver/scheduler.py", "BatchScheduler.submit"),
    ("solver/scheduler.py", "BatchScheduler.submit_many"),
    ("solver/scheduler.py", "BatchScheduler.solve_delta"),
    ("controllers/provisioning.py", "ProvisioningController.reconcile"),
    ("controllers/deprovisioning.py", "DeprovisioningController.reconcile"),
    ("controllers/garbagecollect.py", "GarbageCollectController.reconcile"),
    ("controllers/interruption.py", "InterruptionController.reconcile"),
    ("controllers/termination.py", "TerminationController.reconcile"),
    ("operator.py", "Operator.tick"),
)


def _reachable(project: Project, roots: List[str]) -> Dict[str, List[str]]:
    """fid -> call chain (entry ... fid) for every function reachable from
    ``roots`` without passing through a fence.  BFS, so the recorded chain
    is a shortest one; cycles terminate via the visited set."""
    chains: Dict[str, List[str]] = {}
    queue: List[str] = []
    for fid in roots:
        if fid not in chains:
            chains[fid] = [project.funcs[fid].summary.qual]
            queue.append(fid)
    while queue:
        fid = queue.pop(0)
        node = project.funcs[fid]
        for _line, callee, _closure in node.edges:
            if callee in chains:
                continue
            target = project.funcs.get(callee)
            if target is None:
                continue
            if target.summary.fence:
                continue  # absorbing: the fence owns everything below it
            if target.summary.qual.split(".")[-1] == "__init__":
                continue  # lazy construction is not the steady state
            chains[callee] = chains[fid] + [target.summary.qual]
            queue.append(callee)
    return chains


def check(files, project: Optional[Project] = None) -> List[Finding]:
    project = project if project is not None else build_project(files)
    out: List[Finding] = []
    roots: List[str] = []
    by_suffix_present = {s.path for s in project.summaries}
    for suffix, qual in ENTRY_POINTS:
        if not any(p.endswith(suffix) for p in by_suffix_present):
            continue  # file not in this run (single-file CLI, fixtures)
        fid = project.find_function(suffix, qual)
        if fid is None:
            # staleness guard: fire only when the declaring CLASS is there
            # but NONE of its listed entries resolve (a rename under the
            # rule's feet).  A file that lacks the class entirely — or a
            # fixture that carries only one of a class's entries — stays
            # quiet; tests/test_torch_lint.py separately pins that every entry
            # resolves against the real package, so neither a class-level
            # rename nor a partial one can silently shrink the audited
            # surface.
            cls = qual.split(".")[0] if "." in qual else None
            owner = None
            for s in project.summaries:
                if s.path.endswith(suffix) and cls in s.classes:
                    owner = s
                    break
            if owner is None:
                continue
            siblings_resolve = any(
                project.find_function(sfx, q) is not None
                for sfx, q in ENTRY_POINTS
                if sfx == suffix and q.split(".")[0] == cls)
            if siblings_resolve:
                continue
            out.append(Finding(
                ID, owner.path, owner.classes[cls].lineno,
                f"serving entry point `{qual}` not found in {suffix} — "
                "KT013's audited surface went stale (renamed or moved "
                "entry); update ENTRY_POINTS in analysis/rules/kt013.py",
                hint="the entry-point list must track the serving surface",
            ))
            continue
        if not project.funcs[fid].summary.fence:
            roots.append(fid)
    seen: set = set()
    for fid, chain in sorted(_reachable(project, roots).items()):
        node = project.funcs[fid]
        for lineno, kind in node.summary.syncs:
            key = (node.path, lineno)
            if key in seen:
                continue
            seen.add(key)
            out.append(Finding(
                ID, node.path, lineno,
                f"{kind} reachable from serving entry `{chain[0]}` with no "
                "fence on the path — the sync re-serializes the pipeline "
                "for every request behind it; call chain: "
                + " -> ".join(chain),
                hint=HINT,
            ))
    return out
