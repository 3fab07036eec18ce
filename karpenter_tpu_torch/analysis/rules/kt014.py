"""KT014 — compile-surface audit: runtime-constructible signatures must be
a subset of what the warm API warms.

Eager PyTorch compiles nothing, so in the port a "warm" is a signature's
first run: ``warm_startup`` / ``precompile_buckets`` run one solve per
shape and megabatch slot rung on background threads, which uploads the
constants, primes the caching allocator and marks the signature ready
(``TpuSolver._ready``: bucket keys only bucket ready signatures).  The
signature vocabulary the runtime can *construct* — the ``solve_dims``
single-solve ladder (``solver/tpu.py``), the ``_mega_rung`` megabatch slot
rungs (including the sharded mesh entry-count floor), the
``_mega_key_tail`` key suffix with the ``mesh_signature`` fingerprint
(``parallel/mesh.py``), the ``sweep_dims`` fine rungs
(``solver/consolidation.py``) — and the set the warm API *warms* live in
different modules and drift independently.  This pass proves the subset
relation statically, cross-module:

1. **signature vocabulary** — the dict keys ``solve_dims`` returns must
   be exactly :data:`SIGNATURE_KEYS`, and the names ``_mega_key_tail``
   emits exactly :data:`TAIL_KEYS` (plus the conditional ``"mesh"``): a
   new axis without a registry entry is a signature no warm targets, a
   stale entry hides a recycled name.
2. **megabatch rung coverage** — for every shardable device-count floor,
   the slot rungs constructible under ``DEFAULT_MAX_SLOTS`` (through the
   ``_mega_rung`` ladder: floor at the device count, double to
   ``MEGA_MAX_SLOTS``) must be covered by the rungs ``WARM_MEGA_SLOTS``
   resolves to; dead warm entries (outside the ladder) are flagged too.
   The rule mirrors the ladder math; tests/test_torch_lint.py pins the
   mirror against the real ``_mega_rung`` over the whole domain.
3. **single-source key tail** — the ``("mega_slots", ...)`` tail may only
   be constructed by ``_mega_key_tail``, which must take the mesh
   fingerprint from ``mesh_signature``; the signature builders
   (``mega_signature``, ``_dispatch_prepared``) must call it.
4. **plumbing** — ``precompile_buckets`` must run the single-solve ladder
   through ``warm_startup`` and bound its rung filter by
   ``MEGA_MAX_SLOTS`` (not a literal that can rot); ``sweep_dims`` must
   delegate to ``solve_dims`` (its fine rungs override axes, never invent
   keys); the ``serve --warmup`` blocking precompile must pass an explicit
   ``mega_slots`` grid, so a configured ``--max-slots`` above the default
   is warmed, not met cold at the first full flush.

Left out: the reference's relax and sweep warms (``relax_signature`` /
``warm_relax``, ``sweep_signature`` / ``_warm_sweep``).  The port has no
counterpart for them until a captured CUDA graph per signature (ROADMAP
B2) gives warming those programs a meaning; B2 restores that half here.

Every check degrades gracefully: it runs only when the module owning its
anchor is in the analyzed set, and an anchor that has *moved* (function
renamed, constant no longer a literal) is itself a finding — the audit
surface must never silently shrink.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..callgraph import Project
from ..ktlint import Finding, SourceFile, file_nodes

ID = "KT014"
TITLE = "runtime-constructible signature not covered by the warm API"
WHOLE_PROGRAM = True
HINT = ("the runtime vocabulary (solve_dims keys, _mega_rung slot rungs, "
        "_mega_key_tail) and the warmed set (precompile_buckets, "
        "warm_startup, WARM_MEGA_SLOTS, SIGNATURE_KEYS) must move "
        "together — extend the warm grid / registry in the same change "
        "that extends the ladder")

#: the registered signature axes: exactly the dims keys ``solver/tpu.py
#: solve_dims`` emits (the single source of the rung-bucketing math); a
#: signature is ``sorted(dims.items())`` plus the megabatch tail
SIGNATURE_KEYS = frozenset({
    "G", "C", "NR", "NE_pad", "S", "P", "D", "R", "Z", "K", "W",
    "track", "a", "b",
})
#: the names ``_mega_key_tail`` appends: slot rung, zone / capacity-type
#: vocab positions, and (meshed only) the mesh fingerprint
TAIL_KEYS = frozenset({"mega_slots", "zk", "ck", "mesh"})

TPU = "solver/tpu.py"
SCHED = "solver/scheduler.py"
SERVER = "service/server.py"
SWEEP = "solver/consolidation.py"
MESH = "parallel/mesh.py"


def mega_rung(n: int, n_dev: int, cap: int) -> int:
    """Mirror of ``solver/tpu.py _mega_rung`` with the cap explicit.
    tests/test_torch_lint.py pins this mirror against the real function
    over the whole (n, n_dev) domain — the audit must never model a ladder
    the solver does not climb."""
    r = max(1, n_dev)
    while r < min(max(1, n), cap) and r * 2 <= cap:
        r *= 2
    return r


# ---- tiny AST extractors -------------------------------------------------


def _file(files, suffix: str) -> Optional[SourceFile]:
    for f in files:
        if f.path.endswith(suffix):
            return f
    return None


def _func_def(tree: ast.AST, name: str) -> Optional[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _int_const(tree: ast.AST, name: str) -> Optional[Tuple[int, int]]:
    """(value, lineno) of a module/class-level ``NAME = <int>``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name \
                        and isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, int):
                    return node.value.value, node.lineno
    return None


def _int_tuple(tree: ast.AST, name: str) -> Optional[Tuple[Tuple[int, ...], int]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name \
                        and isinstance(node.value, (ast.Tuple, ast.List)):
                    vals = []
                    for el in node.value.elts:
                        if not (isinstance(el, ast.Constant)
                                and isinstance(el.value, int)):
                            return None
                        vals.append(el.value)
                    return tuple(vals), node.lineno
    return None


def _dict_return_keys(fn: ast.AST) -> Optional[Tuple[Set[str], int]]:
    """Keys of a ``return dict(...)`` (keyword form) inside ``fn``."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Call):
            call = node.value
            if isinstance(call.func, ast.Name) and call.func.id == "dict":
                keys = {kw.arg for kw in call.keywords if kw.arg is not None}
                if keys:
                    return keys, node.lineno
    return None


def _calls_name(fn: ast.AST, name: str) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id == name:
                return True
            if isinstance(f, ast.Attribute) and f.attr == name:
                return True
    return False


def _uses_name(fn: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(fn))


def _tail_names(fn: ast.AST) -> Set[str]:
    """The string names of the ``(name, value)`` pairs a tail builder
    emits."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Tuple) and len(node.elts) == 2 \
                and isinstance(node.elts[0], ast.Constant) \
                and isinstance(node.elts[0].value, str):
            out.add(node.elts[0].value)
    return out


def _moved(out: List[Finding], path: str, what: str) -> None:
    out.append(Finding(
        ID, path, 1,
        f"compile-surface audit anchor {what} not found — the surface "
        "this rule proves moved; update analysis/rules/kt014.py in the "
        "same change so the subset proof keeps covering the serving path",
        hint=HINT,
    ))


# ---- the checks ----------------------------------------------------------


def check(files, project: Optional[Project] = None) -> List[Finding]:
    out: List[Finding] = []
    tpu = _file(files, TPU)
    sched = _file(files, SCHED)
    server = _file(files, SERVER)
    sweep = _file(files, SWEEP)
    mesh = _file(files, MESH)

    dims_keys: Optional[Set[str]] = None
    mega_max: Optional[int] = None

    # staleness guard vs fixture tolerance: a file with NONE of its anchors
    # is a test fixture or partial run and is skipped wholesale; a file
    # with SOME anchors is the real one, and each missing anchor is a
    # finding (the audit surface moved under the rule).  The package gate
    # in tests/test_torch_lint.py separately pins that the real tree yields
    # every anchor, so wholesale renames cannot silently shrink the audit.
    if tpu is not None:
        fn = _func_def(tpu.tree, "solve_dims")
        mm = _int_const(tpu.tree, "MEGA_MAX_SLOTS")
        tailfn = _func_def(tpu.tree, "_mega_key_tail")
        rungfn = _func_def(tpu.tree, "_mega_rung")
        if fn is None and mm is None and tailfn is None and rungfn is None:
            tpu = None
    if tpu is not None:
        got = _dict_return_keys(fn) if fn is not None else None
        if got is None:
            _moved(out, tpu.path, "`solve_dims` returning `dict(...)`")
        else:
            dims_keys, dims_line = got
            # (1) signature vocabulary, both directions
            for key in sorted(dims_keys - SIGNATURE_KEYS):
                out.append(Finding(
                    ID, tpu.path, dims_line,
                    f"solve_dims emits dims key `{key}` that KT014's "
                    "SIGNATURE_KEYS does not register — a signature axis "
                    "no warm targets",
                    hint=HINT,
                ))
            for key in sorted(SIGNATURE_KEYS - dims_keys):
                out.append(Finding(
                    ID, tpu.path, dims_line,
                    f"SIGNATURE_KEYS entry `{key}` matches no solve_dims "
                    "key — a stale registry entry lets a recycled name "
                    "hide an unwarmed axis",
                    hint=HINT,
                ))
        if mm is None:
            _moved(out, tpu.path, "`MEGA_MAX_SLOTS` as an int literal")
        else:
            mega_max = mm[0]
        if rungfn is None:
            _moved(out, tpu.path, "`_mega_rung`")
        if tailfn is None:
            _moved(out, tpu.path, "`_mega_key_tail`")
        else:
            names = _tail_names(tailfn)
            if names != set(TAIL_KEYS):
                out.append(Finding(
                    ID, tpu.path, tailfn.lineno,
                    f"`_mega_key_tail` emits {sorted(names)} but the "
                    f"audit registry models {sorted(TAIL_KEYS)} — update "
                    "TAIL_KEYS in the same change the tail changes",
                    hint=HINT,
                ))
            if not _calls_name(tailfn, "mesh_signature"):
                out.append(Finding(
                    ID, tpu.path, tailfn.lineno,
                    "`_mega_key_tail` does not take the mesh fingerprint "
                    "from `mesh_signature` — two spellings of a mesh's "
                    "key drift apart the day one changes",
                    hint=HINT,
                ))
        # (3) single-source key tail: "mega_slots" literal outside
        # _mega_key_tail anywhere in the tree
        for f in files:
            if f.path.endswith(("kt014.py", "test_torch_lint.py")):
                continue
            for node in file_nodes(f):
                if isinstance(node, ast.Constant) \
                        and node.value == "mega_slots":
                    if f is tpu and tailfn is not None \
                            and tailfn.lineno <= node.lineno \
                            <= getattr(tailfn, "end_lineno", tailfn.lineno):
                        continue
                    out.append(Finding(
                        ID, f.path, node.lineno,
                        "`\"mega_slots\"` signature tail constructed "
                        "outside `_mega_key_tail` — two construction sites "
                        "drift apart the day one spec changes (the tail is "
                        "single-source by contract)",
                        hint=HINT,
                    ))
        # (3b) the signature builders must route through _mega_key_tail
        for fname in ("mega_signature", "_dispatch_prepared"):
            f2 = _func_def(tpu.tree, fname)
            if f2 is None:
                _moved(out, tpu.path, f"`{fname}`")
            elif not _calls_name(f2, "_mega_key_tail"):
                out.append(Finding(
                    ID, tpu.path, f2.lineno,
                    f"`{fname}` does not call `_mega_key_tail` — its "
                    "signature can drift from what readiness/warm "
                    "bookkeeping tracks",
                    hint=HINT,
                ))

    if mesh is not None and tpu is not None \
            and _func_def(mesh.tree, "mesh_signature") is None:
        _moved(out, mesh.path, "`mesh_signature`")

    warm_slots: Optional[Tuple[int, ...]] = None
    warm_line = 1
    if sched is not None:
        ws = _int_tuple(sched.tree, "WARM_MEGA_SLOTS")
        pcb = _func_def(sched.tree, "precompile_buckets")
        if ws is None and pcb is None:
            sched = None
    if sched is not None:
        if ws is None:
            _moved(out, sched.path, "`WARM_MEGA_SLOTS` as an int tuple")
        else:
            warm_slots, warm_line = ws
        if pcb is None:
            _moved(out, sched.path, "`precompile_buckets`")
        else:
            if not _uses_name(pcb, "MEGA_MAX_SLOTS"):
                out.append(Finding(
                    ID, sched.path, pcb.lineno,
                    "`precompile_buckets` does not bound its slot-rung "
                    "filter by `MEGA_MAX_SLOTS` — a literal bound rots the "
                    "day the ladder cap moves",
                    hint=HINT,
                ))
            if not _calls_name(pcb, "warm_startup"):
                out.append(Finding(
                    ID, sched.path, pcb.lineno,
                    "`precompile_buckets` does not run the single-solve "
                    "ladder through `warm_startup` — the two warm grids "
                    "fork",
                    hint=HINT,
                ))

    default_max: Optional[int] = None
    if server is not None:
        dm = _int_const(server.tree, "DEFAULT_MAX_SLOTS")
        has_pcb_call = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "precompile_buckets"
            for n in ast.walk(server.tree))
        if dm is None and not has_pcb_call:
            server = None
    if server is not None:
        if dm is None:
            _moved(out, server.path, "`DEFAULT_MAX_SLOTS` as an int literal")
        else:
            default_max = dm[0]
        # (4) serve --warmup: the blocking precompile must name its grid
        for node in ast.walk(server.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "precompile_buckets":
                kwargs = {kw.arg for kw in node.keywords}
                blocking = any(
                    kw.arg == "wait" and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True for kw in node.keywords)
                if blocking and "mega_slots" not in kwargs:
                    out.append(Finding(
                        ID, server.path, node.lineno,
                        "blocking `precompile_buckets(wait=True)` without "
                        "an explicit `mega_slots` grid — a configured "
                        "--max-slots above the default warms nothing past "
                        "the default rungs, and the first full flush meets "
                        "its signature cold",
                        hint=HINT,
                    ))

    # (2) megabatch rung coverage over every shardable device-count floor
    if mega_max is not None and warm_slots is not None \
            and default_max is not None:
        live = [s for s in warm_slots if 2 <= s <= mega_max]
        for s in warm_slots:
            if not 2 <= s <= mega_max:
                out.append(Finding(
                    ID, sched.path, warm_line,
                    f"WARM_MEGA_SLOTS entry {s} is outside the megabatch "
                    f"ladder [2, {mega_max}] — precompile_buckets filters "
                    "it out, so it warms nothing (dead config)",
                    hint=HINT,
                ))
        for n_dev in range(1, mega_max + 1):
            warm_rungs = {mega_rung(s, n_dev, mega_max) for s in live}
            eff_cap = min(max(default_max, n_dev),
                          mega_rung(mega_max, n_dev, mega_max))
            runtime_rungs = {mega_rung(n, n_dev, mega_max)
                             for n in range(2, eff_cap + 1)}
            missing = sorted(runtime_rungs - warm_rungs)
            if missing:
                out.append(Finding(
                    ID, sched.path, warm_line,
                    f"megabatch slot rung(s) {missing} are constructible "
                    f"at runtime (device floor {n_dev}, slot cap "
                    f"{eff_cap}) but WARM_MEGA_SLOTS={tuple(live)} never "
                    "warms them — the first flush at that occupancy meets "
                    "its signature cold on the serving path",
                    hint=HINT,
                ))
                break  # one floor's witness is enough; don't spam 32 rows

    # (4b) sweep_dims: fine rungs may override axes, never invent keys
    sd = _func_def(sweep.tree, "sweep_dims") if sweep is not None else None
    if sd is not None:
        if not _calls_name(sd, "solve_dims"):
            out.append(Finding(
                ID, sweep.path, sd.lineno,
                "`sweep_dims` does not delegate to `solve_dims` — the "
                "sweep's signatures would fork from the single source of "
                "the bucketing math",
                hint=HINT,
            ))
        if dims_keys is not None:
            for node in ast.walk(sd):
                if isinstance(node, ast.Assign) and node.targets \
                        and isinstance(node.targets[0], ast.Subscript):
                    sub = node.targets[0]
                    if isinstance(sub.slice, ast.Constant) \
                            and isinstance(sub.slice.value, str) \
                            and sub.slice.value not in dims_keys:
                        out.append(Finding(
                            ID, sweep.path, node.lineno,
                            f"`sweep_dims` writes dims key "
                            f"`{sub.slice.value}` that `solve_dims` never "
                            "emits — an invented key is a signature axis "
                            "no rung ladder bounds",
                            hint=HINT,
                        ))
    return out


def surface(files) -> Dict[str, object]:
    """The two sides of the subset proof as data, for human diffing when
    the ladder changes."""
    tpu = _file(files, TPU)
    sched = _file(files, SCHED)
    server = _file(files, SERVER)
    out: Dict[str, object] = {
        "signature_keys": sorted(SIGNATURE_KEYS),
        "tail_keys": sorted(TAIL_KEYS),
    }
    if tpu is not None:
        fn = _func_def(tpu.tree, "solve_dims")
        got = _dict_return_keys(fn) if fn is not None else None
        out["solve_dims_keys"] = sorted(got[0]) if got else None
        mm = _int_const(tpu.tree, "MEGA_MAX_SLOTS")
        out["mega_max_slots"] = mm[0] if mm else None
    ws = _int_tuple(sched.tree, "WARM_MEGA_SLOTS") if sched is not None \
        else None
    dm = _int_const(server.tree, "DEFAULT_MAX_SLOTS") if server is not None \
        else None
    out["warm_mega_slots"] = list(ws[0]) if ws else None
    out["default_max_slots"] = dm[0] if dm else None
    mega_max = out.get("mega_max_slots")
    if mega_max and ws and dm:
        rungs: Dict[str, Dict[str, List[int]]] = {}
        for n_dev in range(1, int(mega_max) + 1):
            warm = sorted({mega_rung(s, n_dev, int(mega_max))
                           for s in ws[0] if 2 <= s <= int(mega_max)})
            eff_cap = min(max(dm[0], n_dev),
                          mega_rung(int(mega_max), n_dev, int(mega_max)))
            runtime = sorted({mega_rung(n, n_dev, int(mega_max))
                              for n in range(2, eff_cap + 1)})
            rungs[str(n_dev)] = {"warmed": warm, "runtime": runtime}
        out["mega_rungs_by_device_floor"] = rungs
    return out
