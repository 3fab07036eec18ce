"""ctypes binding for the native FFD core (the repository's ``native/ffd.cpp``).

The port of the reference package's ``solver/native.py``: host C++, no
device code.  The low-latency host tier — ``backend="native"`` solves
every batch here, and the ``auto`` policy serves a batch here while the
device tier is latched unhealthy (``BatchScheduler._cold_solve``) when the
batch has no topology the tier cannot express.  Feasibility is computed
with numpy using the exact packed-bitmask semantics of the device path
(models/vocab.py).

The source sits at the repository root, outside both packages: the port
compiles it with ``g++`` at first use into ``karpenter_tpu_torch/_build/``
(one library per source content hash and flags), never at import.
"""

from __future__ import annotations

import ctypes
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..models import labels as L
from ..models.tensorize import SolveTensors
from .types import SimNode, SolveResult, node_classes

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG.parent / "native" / "ffd.cpp"
_BUILD = _PKG / "_build"

_lib = None
#: seconds the ``g++`` build took in this process (None: loaded a library
#: an earlier process built, or not loaded yet)
build_s: Optional[float] = None

#: kt_ffd_solve arity: 9 dims + 30 arrays (23 inputs, 7 outputs).  Declared
#: so a source/binding mismatch fails loudly (ctypes arity check) instead of
#: corrupting the stack.
_N_DIMS = 9
_N_ARRAYS = 30


_CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-Wall", "-std=c++17")


def _so_path() -> Path:
    """Build artifact keyed on the source content hash and the compile
    flags: an edited ffd.cpp or a flags change always compiles its own
    binary; stale binaries from other source revisions are never loaded."""
    import hashlib

    h = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_CXX_FLAGS).encode()
    ).hexdigest()[:12]
    return _BUILD / f"libktffd_{h}.so"


def _load():
    global _lib, build_s
    if _lib is not None:
        return _lib
    so = _so_path()
    if not so.exists():
        # compile to a private temp path, then atomically publish:
        # concurrent processes must never CDLL a half-written ELF
        import os
        import tempfile

        _BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(_BUILD))
        os.close(fd)
        try:
            t0 = time.perf_counter()
            subprocess.run(
                ["g++", *_CXX_FLAGS, "-o", tmp, str(_SRC)],
                check=True,
                capture_output=True,
            )
            build_s = time.perf_counter() - t0
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so))
    lib.kt_ffd_solve.restype = ctypes.c_int
    lib.kt_ffd_solve.argtypes = (
        [ctypes.c_int] * _N_DIMS + [ctypes.c_void_p] * _N_ARRAYS
    )
    lib.kt_version.restype = ctypes.c_char_p
    _lib = lib
    return lib


def available() -> bool:
    # the real failure shapes: g++ or the source missing / CDLL of a bad
    # ELF (OSError, incl. FileNotFoundError), a failed compile
    # (CalledProcessError), and a compiled .so whose exported symbols don't
    # match this binding (AttributeError from ctypes symbol lookup)
    try:
        return _load() is not None
    except (OSError, subprocess.CalledProcessError, AttributeError):
        return False


def version() -> str:
    return _load().kt_version().decode()


# ---------------------------------------------------------------------------
# numpy feasibility (mirrors solver.tpu.compute_feasibility bit-for-bit)
# ---------------------------------------------------------------------------


def feasibility_numpy(st: SolveTensors):
    G, C = st.G, max(1, st.C)
    K = st.pm.shape[1]
    zone_key = st.vocab.key_id[L.ZONE]
    ct_key = st.vocab.key_id[L.CAPACITY_TYPE]

    lab = np.ones((G, C), dtype=bool)
    for k in range(K):
        if not st.key_check[k]:
            continue
        words = st.pm[:, k, :][:, st.cand_vw[:, k]]          # [G, C]
        bits = (words >> st.cand_vb[None, :, k].astype(np.uint32)) & 1
        lab &= bits.astype(bool)
    fit = np.all(
        (st.requests[:, None, :] <= st.cand_alloc[None, :, :] + 1e-6)
        | (st.requests[:, None, :] <= 0),
        axis=2,
    )
    gp = st.gp_ok[np.arange(st.G)[:, None], st.cand_prov[None, :]]
    F = lab & fit & gp

    zw = st.pm[:, zone_key, :][:, st.dom_vw[:, 0]]
    zok = ((zw >> st.dom_vb[None, :, 0].astype(np.uint32)) & 1).astype(bool)
    cw = st.pm[:, ct_key, :][:, st.dom_vw[:, 1]]
    cok = ((cw >> st.dom_vb[None, :, 1].astype(np.uint32)) & 1).astype(bool)
    return F, (zok & cok)


def has_topology(st: SolveTensors) -> bool:
    """Groups the native tier can't express: positive pod-affinity (modes
    A/B/C live on the device / oracle) and capacity-type spread (routes the
    whole batch to the oracle — scheduler.batch_needs_oracle).  Zone/hostname
    spread and anti-affinity ARE handled natively (ffd.cpp place_constrained)
    — the binding marshals ex_zone/ex_selcnt/zc0 so the constrained path sees
    real existing-cluster topology state."""
    import numpy as _np

    return bool(
        _np.any(st.g_zone_paff >= 0)
        or _np.any(st.g_host_paff >= 0)
        or st.has_ct_spread
    )


def existing_compat(
    st: SolveTensors, existing_nodes: Sequence[SimNode]
) -> np.ndarray:
    """[G, NE] uint8 — may pods of group g run on existing node n
    (tolerations vs taints + merged requirements vs labels)?

    Two-level memo, the same scheme as consolidation.compat_matrix: a
    group's side of the answer is its merged requirements + tolerations; a
    node's side is its taints plus only the label keys any group's
    requirements reference — a per-node hostname label must not split a
    uniform fleet into NE classes when nothing selects on hostname.  The
    naive O(G x NE) requirement-algebra walk was ~15 s per consolidation
    what-if at 4k groups x 1k nodes; the memo answers once per
    (signature, class) pair."""
    G, NE = st.G, len(existing_nodes)
    g_sig_idx = np.empty(G, dtype=np.int64)
    sig_rep: List[int] = []  # representative group index per signature
    sig_of: Dict[tuple, int] = {}
    relevant_keys: set = set()
    for gi, g in enumerate(st.groups):
        key = (g.requirements.signature(), tuple(g.pods[0].tolerations))
        si = sig_of.get(key)
        if si is None:
            si = sig_of[key] = len(sig_rep)
            sig_rep.append(gi)
            relevant_keys.update(g.requirements)
        g_sig_idx[gi] = si
    cls_idx, cls_rep = node_classes(existing_nodes, relevant_keys)
    n_cls_idx = np.asarray(cls_idx, dtype=np.int64)
    table = np.zeros((len(sig_rep), len(cls_rep)), dtype=np.uint8)
    for si, gi in enumerate(sig_rep):
        g = st.groups[gi]
        rep = g.pods[0]
        for ci, node in enumerate(cls_rep):
            table[si, ci] = (
                not any(t.blocks(rep.tolerations) for t in node.taints)
                and g.requirements.compatible(node.labels) is None
            )
    return table[g_sig_idx[:, None], n_cls_idx[None, :]]


# ---------------------------------------------------------------------------
# solve
# ---------------------------------------------------------------------------


def solve_tensors_native(
    st: SolveTensors,
    existing_nodes: Sequence[SimNode] = (),
    max_nodes: Optional[int] = None,
) -> SolveResult:
    lib = _load()
    t0 = time.perf_counter()
    G, C, D, R = st.G, max(1, st.C), st.D, st.R
    S = st.S
    Z = max(1, st.n_zones)
    P = st.prov_limits.shape[0]
    NE = len(existing_nodes)
    NR = max(1, NE, (max_nodes if max_nodes is not None else NE + int(st.counts.sum())))

    F, dom_ok = feasibility_numpy(st)
    F = np.ascontiguousarray(F, dtype=np.uint8)
    dom_ok = np.ascontiguousarray(dom_ok, dtype=np.uint8)

    # ---- existing-node state (same semantics as TpuSolver.prepare) ------
    zone_index = {z: i for i, z in enumerate(st.zone_names)}
    prov_index = {n: i for i, n in enumerate(st.prov_names)}
    ex_res = np.zeros((max(1, NE), R), dtype=np.float32)
    ex_zone = np.zeros(max(1, NE), dtype=np.int32)
    ex_selcnt = np.zeros((max(1, NE), S), dtype=np.int32)
    ex_ok = np.zeros((G, max(1, NE)), dtype=np.uint8)
    zc0 = np.zeros((S, Z), dtype=np.int32)
    prov_used0 = np.zeros((P, R), dtype=np.float32)
    # limits bind on raw machine CAPACITY (st.capacity_row) — same accounting
    # as the device solver and the oracle (fuzz seed 23)
    for ni, node in enumerate(existing_nodes):
        ex_res[ni] = st.vocab.resources_to_row(node.remaining()).astype(np.float32)
        ex_zone[ni] = zone_index.get(node.zone, 0)
        pi = prov_index.get(node.provisioner)
        if pi is not None:
            prov_used0[pi] += st.capacity_row(node.instance_type,
                                              node.allocatable)
    if NE and G:
        ex_ok[:, :] = existing_compat(st, existing_nodes)
    for si, (sel, _topo, _kind) in enumerate(st.selector_defs):
        for ni, node in enumerate(existing_nodes):
            n_match = sum(1 for p in node.pods if sel.matches(p.labels))
            ex_selcnt[ni, si] = n_match
            zc0[si, zone_index.get(node.zone, 0)] += n_match

    price = np.where(np.isinf(st.cand_price), np.float32(3.0e38), st.cand_price)
    price = np.ascontiguousarray(price, dtype=np.float32)
    avail = np.ascontiguousarray(st.cand_avail, dtype=np.uint8)
    req = np.ascontiguousarray(st.requests, dtype=np.float32)
    counts = np.ascontiguousarray(st.counts, dtype=np.int32)
    alloc = np.ascontiguousarray(st.cand_alloc, dtype=np.float32)
    g_zone_spread = np.ascontiguousarray(st.g_zone_spread, dtype=np.int32)
    g_zone_skew = np.ascontiguousarray(st.g_zone_skew, dtype=np.int32)
    g_host_spread = np.ascontiguousarray(st.g_host_spread, dtype=np.int32)
    g_host_cap = np.ascontiguousarray(st.g_host_cap, dtype=np.int32)
    g_zone_anti = np.ascontiguousarray(st.g_zone_anti, dtype=np.int32)
    sel_match = np.ascontiguousarray(st.g_sel_match, dtype=np.uint8)
    dom_zone = np.ascontiguousarray(st.dom_zone, dtype=np.int32)
    cand_prov = np.ascontiguousarray(st.cand_prov, dtype=np.int32)
    cand_cap = np.ascontiguousarray(st.cand_cap, dtype=np.float32)
    prov_limits = np.ascontiguousarray(st.prov_limits, dtype=np.float32)

    slot_res = np.zeros((NR, R), dtype=np.float32)
    slot_cand = np.zeros(NR, dtype=np.int32)
    slot_dom = np.zeros(NR, dtype=np.int32)
    slot_price = np.zeros(NR, dtype=np.float32)
    takes = np.zeros((G, NR), dtype=np.int32)
    n_used = np.zeros(1, dtype=np.int32)
    infeasible = np.zeros(G, dtype=np.int32)

    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.kt_ffd_solve(
        G, C, D, R, NE, NR, S, Z, P,
        c(req), c(counts), c(F), c(dom_ok), c(alloc), c(price), c(avail),
        c(ex_res), c(ex_ok), c(ex_zone), c(ex_selcnt),
        c(g_zone_spread), c(g_zone_skew), c(g_host_spread), c(g_host_cap),
        c(g_zone_anti), c(sel_match), c(dom_zone), c(zc0),
        c(cand_prov), c(cand_cap), c(prov_limits), c(prov_used0),
        c(slot_res), c(slot_cand), c(slot_dom), c(slot_price), c(takes),
        c(n_used), c(infeasible),
    )

    # ---- extraction (same shape as TpuSolver._extract) -----------------
    nused = int(n_used[0])
    nodes: List[SimNode] = []
    slot_to_node: Dict[int, SimNode] = {}
    # snapshots: placements must not leak into the caller's node objects;
    # the placed snapshots are returned (existing_nodes) so retry waves can
    # chain on them without double-booking capacity
    snap_existing = [n.snapshot() for n in existing_nodes]
    for ni, node in enumerate(snap_existing):
        slot_to_node[ni] = node
    n_ct = max(1, len(st.ct_names))
    for s in range(NE, nused):
        ci = int(slot_cand[s])
        if ci < 0:
            continue
        prov_name, type_name = st.cand_names[ci]
        di = int(slot_dom[s])
        node = SimNode(
            instance_type=type_name,
            provisioner=prov_name,
            zone=st.zone_names[di // n_ct] if st.zone_names else "",
            capacity_type=st.ct_names[di % n_ct] if st.ct_names else "",
            price=float(slot_price[s]),
            allocatable={
                st.vocab.resources[r]: float(st.cand_alloc[ci, r]) for r in range(R)
            },
        )
        node.stamp_labels()
        nodes.append(node)
        slot_to_node[s] = node

    assignments: Dict[str, str] = {}
    infeasible_map: Dict[str, str] = {}
    node_groups: Dict[int, set] = {}
    for gi, g in enumerate(st.groups):
        gp = g.pods
        base = 0
        for s in np.nonzero(takes[gi])[0]:
            take = int(takes[gi, s])
            chunk = gp[base:base + take]
            base += len(chunk)
            node = slot_to_node.get(int(s))
            if node is not None:
                node_groups.setdefault(id(node), set()).add(gi)
                node.pods.extend(chunk)
                nn = node.name
                for pod in chunk:
                    assignments[pod.name] = nn
            else:
                for pod in chunk:
                    assignments[pod.name] = f"slot-{int(s)}"
        for pod in gp[base:]:
            infeasible_map[pod.name] = "native solver: no feasible placement"

    # cost-neutral coalescing, same pass as the device tier (the cold-start
    # answer should match the warm tier's node-count quality — before this
    # the native tier served 20 nodes where the device tier served 16 on
    # bench config 1)
    from .coalesce import apply_coalesce

    used_rows = {}
    for s, node in slot_to_node.items():
        if s >= NE:  # slots >= NE are exactly the new nodes
            ci = int(slot_cand[s])
            used_rows[id(node)] = (
                np.asarray(st.cand_alloc[ci], dtype=np.float64)
                - np.asarray(slot_res[s], dtype=np.float64)
            )
    nodes = apply_coalesce(st, nodes, used_rows, node_groups, assignments)

    return SolveResult(
        nodes=nodes,
        assignments=assignments,
        infeasible=infeasible_map,
        existing_nodes=snap_existing,
        solve_ms=(time.perf_counter() - t0) * 1000.0,
    )
