"""KT012 — whole-program lock-order deadlock detection.

The serving stack holds ~10 declared locks (batcher, admission
queue/breaker/facade, SolvePipeline, SolverService, scheduler, solver,
guard, operator).  Two threads acquiring two locks in opposite orders is a
deadlock waiting for load to find it — and the nesting that creates the
order is usually *interprocedural*: a method holds its own lock while
calling through a facade into a component that takes another.

This pass extracts every ``with <lock>:`` nesting, propagates lock-held
sets across the project call graph (``analysis/callgraph.py``), and builds
the global lock-acquisition-order graph:

- edge ``A -> B``: some path acquires ``B`` while holding ``A`` — either
  lexically (``with A: with B:``) or through a call chain (``with A:
  f()`` where ``f`` transitively acquires ``B``).
- **any cycle is a finding**, reported once with the witness path for each
  edge in the cycle (file:line of the outer acquisition plus the call
  chain that reaches the inner one).
- a **self-edge on a non-reentrant lock** (``threading.Lock``) is also a
  finding: the same thread re-acquiring it is a self-deadlock.  RLock /
  Condition self-edges are legal and skipped (the admission queue's
  ``_bump`` re-acquires its own Condition by design).

Known limits (by design, covered dynamically by the sanitizer's runtime
lock-order watcher — analysis/sanitize.py, KT_SANITIZE=1): acquisitions
inside closures/lambdas run where they are *called*, not where they are
written, so closure bodies contribute no static edges; callback
indirection (future done-callbacks, ``on_*`` hooks) is invisible here.
The acquisition order the pass derives is exported via :func:`lock_graph`
/ :func:`lock_order`; ``sanitize.LOCK_ORDER`` must stay a linear extension
of it (tests/test_torch_lint.py cross-validates the two).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..callgraph import Project, build_project
from ..ktlint import Finding

ID = "KT012"
TITLE = "lock-order deadlock (cycle in the global acquisition-order graph)"
#: the driver builds ONE Project per run and hands it to every
#: whole-program rule (KT012-KT014) instead of each re-linking the world
WHOLE_PROGRAM = True
HINT = ("pick ONE global order for the locks in the cycle and acquire them "
        "in it everywhere (docs/ANALYSIS.md holds the current table), or "
        "restructure so the inner acquisition happens outside the outer "
        "critical section; allow[KT012] only with a reason that names why "
        "the inversion cannot deadlock")


class _Edge:
    __slots__ = ("src", "dst", "path", "line", "chain")

    def __init__(self, src: str, dst: str, path: str, line: int,
                 chain: List[str]):
        self.src = src          #: held lock
        self.dst = dst          #: acquired lock
        self.path = path        #: file of the outer acquisition
        self.line = line        #: line of the outer acquisition
        self.chain = chain      #: call chain from holder to acquirer

    def witness(self) -> str:
        via = " -> ".join(self.chain)
        route = f" via {via}" if via else " (lexical nesting)"
        return (f"`{self.src}` held at {self.path}:{self.line}, "
                f"`{self.dst}` acquired{route}")


def _direct_acquisitions(
    project: Project,
) -> Dict[str, List[Tuple[str, Optional[str], int, int, int]]]:
    """fid -> [(lock id, kind, with-line, span start, span end)]."""
    out: Dict[str, List[Tuple[str, Optional[str], int, int, int]]] = {}
    for fid, node in project.funcs.items():
        acq = []
        for lineno, end, ref in node.summary.locks:
            lock = project.lock_id(node, ref)
            if lock is None:
                continue  # unresolvable receiver: no node, no edge
            acq.append((lock, project.lock_kind(node, ref), lineno, lineno,
                        end))
        if acq:
            out[fid] = acq
    return out


def _transitive_locks(
    project: Project,
    direct: Dict[str, List[Tuple[str, Optional[str], int, int, int]]],
) -> Dict[str, Dict[str, Tuple[str, int, Optional[str]]]]:
    """fid -> {lock id: how it is first reached}.

    The "how" is ``("direct", line, None)`` for an own acquisition or
    ``("call", line, callee fid)`` for one reached through a call edge —
    enough to reconstruct a witness chain without storing every path.
    Fixpoint iteration, so recursion (direct or mutual) terminates."""
    acq: Dict[str, Dict[str, Tuple[str, int, Optional[str]]]] = {}
    for fid, node in project.funcs.items():
        acq[fid] = {}
        for lock, _kind, line, _s, _e in direct.get(fid, []):
            acq[fid].setdefault(lock, ("direct", line, None))
    changed = True
    while changed:
        changed = False
        for fid, node in project.funcs.items():
            mine = acq[fid]
            for line, callee, in_closure in node.edges:
                if in_closure or callee == fid:
                    continue
                for lock in acq.get(callee, ()):
                    if lock not in mine:
                        mine[lock] = ("call", line, callee)
                        changed = True
    return acq


def _chain_to(project: Project, acq, fid: str, lock: str,
              limit: int = 12) -> List[str]:
    """Reconstruct one call chain from ``fid`` to the function that
    directly acquires ``lock`` by following the "how" pointers."""
    chain: List[str] = []
    seen: Set[str] = set()
    cur = fid
    while cur is not None and cur not in seen and len(chain) < limit:
        seen.add(cur)
        chain.append(_pretty(project, cur))
        how = acq.get(cur, {}).get(lock)
        if how is None or how[0] == "direct":
            break
        cur = how[2]
    return chain


def _pretty(project: Project, fid: str) -> str:
    node = project.funcs[fid]
    return node.summary.qual


def lock_graph(files, project: Optional[Project] = None):
    """The global lock-acquisition-order graph over ``files``.

    Returns ``(nodes, edges, kinds)``: ``nodes`` is the sorted set of lock
    ids seen acquired, ``edges`` a dict ``(src, dst) -> _Edge`` holding one
    witness per ordered pair, ``kinds`` a dict ``lock id -> kind name`` (or
    None when the declaration was not found)."""
    project = project if project is not None else build_project(files)
    direct = _direct_acquisitions(project)
    trans = _transitive_locks(project, direct)
    nodes: Set[str] = set()
    kinds: Dict[str, Optional[str]] = {}
    edges: Dict[Tuple[str, str], _Edge] = {}

    for fid, acqs in direct.items():
        node = project.funcs[fid]
        for lock, kind, line, _s, _e in acqs:
            nodes.add(lock)
            if kinds.get(lock) is None:
                kinds[lock] = kind

    def add_edge(src: str, dst: str, path: str, line: int,
                 chain: List[str]) -> None:
        key = (src, dst)
        if key not in edges:
            edges[key] = _Edge(src, dst, path, line, chain)

    for fid, acqs in direct.items():
        node = project.funcs[fid]
        for i, (lock, _kind, line, start, end) in enumerate(acqs):
            # lexical nesting: a later acquisition inside this with-span.
            # Same-line entries (`with self._a, self._b:`, one-line nested
            # withs) share start/end; extraction order is source order, so
            # a later list index at the same line is the INNER acquisition.
            for j, (lock2, _k2, line2, _s2, _e2) in enumerate(acqs):
                if start < line2 <= end or (line2 == start and j > i):
                    add_edge(lock, lock2, node.path, line,
                             [_pretty(project, fid)])
            # call-propagated: every lock a callee transitively acquires.
            # `start <= cline` (not <): a one-line body `with self._lock:
            # self.callee()` puts the call on the with's own line.
            for cline, callee, in_closure in node.edges:
                if in_closure or not (start <= cline <= end):
                    continue
                for lock2 in trans.get(callee, ()):
                    chain = [_pretty(project, fid)] + _chain_to(
                        project, trans, callee, lock2)
                    add_edge(lock, lock2, node.path, line, chain)

    return sorted(nodes), edges, kinds


def lock_order(files, project: Optional[Project] = None,
               graph=None) -> List[str]:
    """One global acquisition order consistent with every observed edge
    (topological order of the graph; cycles — which are findings — are
    broken arbitrarily so the table stays printable).  Pass ``graph`` (a
    prior :func:`lock_graph` result) to skip recomputing it."""
    nodes, edges, _kinds = graph if graph is not None \
        else lock_graph(files, project)
    out_edges: Dict[str, Set[str]] = {n: set() for n in nodes}
    indeg: Dict[str, int] = {n: 0 for n in nodes}
    for (src, dst) in edges:
        if src != dst and dst not in out_edges[src]:
            out_edges[src].add(dst)
            indeg[dst] += 1
    order: List[str] = []
    ready = sorted(n for n in nodes if indeg[n] == 0)
    while ready:
        n = ready.pop(0)
        order.append(n)
        for m in sorted(out_edges[n]):
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)
        ready.sort()
    for n in nodes:  # cycle remnants: append so the table is total
        if n not in order:
            order.append(n)
    return order


def _find_cycles(nodes: List[str],
                 edges: Dict[Tuple[str, str], _Edge]) -> List[List[str]]:
    """Elementary cycles, deduped by node set (one finding per deadlock,
    not one per rotation)."""
    adj: Dict[str, List[str]] = {n: [] for n in nodes}
    for (src, dst) in edges:
        if src != dst:
            adj[src].append(dst)
    cycles: List[List[str]] = []
    seen_sets: Set[frozenset] = set()

    def dfs(start: str, cur: str, path: List[str], visited: Set[str]) -> None:
        for nxt in sorted(adj.get(cur, ())):
            if nxt == start and len(path) >= 2:
                key = frozenset(path)
                if key not in seen_sets:
                    seen_sets.add(key)
                    cycles.append(list(path))
            elif nxt not in visited and nxt > start:
                # only walk nodes ordered after start: each cycle is found
                # exactly once, from its smallest node
                visited.add(nxt)
                dfs(start, nxt, path + [nxt], visited)
                visited.discard(nxt)

    for n in sorted(nodes):
        dfs(n, n, [n], {n})
    return cycles


def check(files, project: Optional[Project] = None) -> List[Finding]:
    project = project if project is not None else build_project(files)
    nodes, edges, kinds = lock_graph(files, project)
    out: List[Finding] = []

    # self-deadlock: nested acquisition of a non-reentrant lock
    for (src, dst), edge in sorted(edges.items()):
        if src == dst and kinds.get(src) == "Lock":
            out.append(Finding(
                ID, edge.path, edge.line,
                f"nested acquisition of non-reentrant lock `{src}`: the "
                "holding thread re-acquiring a threading.Lock deadlocks "
                f"itself ({edge.witness()})",
                hint="use threading.RLock if re-entry is intended, or lift "
                     "the inner acquisition out of the critical section",
            ))

    for cycle in _find_cycles(nodes, edges):
        pairs = [(cycle[i], cycle[(i + 1) % len(cycle)])
                 for i in range(len(cycle))]
        witnesses = "; ".join(
            f"witness {edges[p].src} -> {edges[p].dst}: {edges[p].witness()}"
            for p in pairs if p in edges)
        anchor = edges[pairs[0]]
        out.append(Finding(
            ID, anchor.path, anchor.line,
            "lock-order cycle "
            + " -> ".join(f"`{n}`" for n in cycle + [cycle[0]])
            + f" — two threads taking opposite routes deadlock; {witnesses}",
            hint=HINT,
        ))
    return out
