"""Batched consolidation what-ifs on the card.

The port of the reference package's ``solver/consolidation.py``.  Two
questions the deprovisioning controller asks of every candidate at once:

- **The deletability screen** (:func:`screen_subset_deletes`,
  :func:`screen_delete_candidates`): for each candidate subset of nodes,
  does a greedy first-fit place every pod of the members (largest first,
  the solvers' FFD key) onto the non-members' residual capacity,
  honouring per-(source, target) label/taint compatibility?  One
  PyTorch program on the device, vectorised over the K subsets and
  looping over the pod slots, with a ``[K, N, R]`` residual.  Resource +
  compatibility only: topology is not evaluated, so the controller
  confirms every hit with the exact what-if.
- **The what-if sweep** (:func:`sweep_what_ifs`): every candidate's
  "delete these nodes; do their pods fit on the rest plus at most
  ``max_new`` new nodes?" as slots of ONE batched device solve
  (``TpuSolver.solve_many_prepared``) derived from one shared host build
  of the base cluster.  A slot whose answer is anything but a clean "all
  pods fit on the survivors, no new node" re-solves through the serial
  scheduler path, so decisions equal the sequential what-if loop's.

The reference compiles the sweep's program behind and serves a shape's
first sweep serially; the port compiles nothing, so every eligible chunk
dispatches on the first sweep.  The host parts are copied from the
reference.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import ProgramRuns, resolve_device
from ..gang import nodes_carry_gangs
from ..metrics import (
    CONSOLIDATION_SWEEP_DURATION,
    CONSOLIDATION_SWEEP_SLOTS,
    CONSOLIDATION_SWEEPS,
    Registry,
)
from ..models import labels as L
from ..obs.trace import NULL_TRACE
from .types import SimNode, SolveResult, node_classes

logger = logging.getLogger(__name__)

_RESOURCES = (L.RESOURCE_CPU, L.RESOURCE_MEMORY, L.RESOURCE_PODS)

#: device runs of the screen program, per device type
SCREEN_PROGRAM = ProgramRuns("screen_program")


@dataclass
class DeleteScreenResult:
    deletable: np.ndarray        # [N] bool — pods fit on other nodes
    n_candidates: int
    eval_ms: float
    compile_ms: float


@dataclass
class SubsetScreenResult:
    deletable: np.ndarray        # [K] bool — subset's pods fit on non-members
    n_subsets: int
    eval_ms: float
    compile_ms: float


def _ffd_key(p) -> float:
    return -(p.requests.get(L.RESOURCE_CPU, 0.0)
             + p.requests.get(L.RESOURCE_MEMORY, 0.0) / (4 * 1024.0**3))


def _screen_program(residual: torch.Tensor, member: torch.Tensor,
                    pods: torch.Tensor, src: torch.Tensor,
                    compat: torch.Tensor) -> torch.Tensor:
    """[K] bool: per subset, does a greedy first-fit place every pod of the
    member nodes onto compatible non-member residuals?

    ``residual[N, R]`` float32, ``member[K, N]`` bool, ``pods[K, P, R]``
    float32 (a zero row is padding), ``src[K, P]`` int64 source node of
    each pod, ``compat[N, N]`` bool; all on one device.  Vectorised over
    the K subsets, one step per pod slot, never reading the device: a pod
    fits a row iff ``res + 1e-6 >= pod`` on every resource and the row is a
    compatible non-member; it takes the FIRST fitting row, which is
    debited only when the pod is real and something fits; a padding pod
    counts as placed."""
    K, N = member.shape
    dev = residual.device
    res = torch.where(member[:, :, None], 0.0, residual[None])  # [K, N, R]
    open_rows = ~member
    cols = torch.arange(N, device=dev)
    rows = torch.arange(K, device=dev)
    ok = torch.ones(K, dtype=torch.bool, device=dev)
    for j in range(pods.shape[1]):
        pod = pods[:, j, :]                                     # [K, R]
        fits = torch.all(res + 1e-6 >= pod[:, None, :], dim=2) \
            & compat[src[:, j]] & open_rows                     # [K, N]
        any_fit = fits.any(dim=1)
        # the first fitting row (row 0 when none fits: nothing is debited)
        idx = torch.where(fits, cols, N).amin(dim=1)
        idx = torch.where(any_fit, idx, 0)
        is_real = (pod > 0).any(dim=1)
        deduct = torch.where((is_real & any_fit)[:, None], pod, 0.0)
        res[rows, idx] = res[rows, idx] + (-deduct)
        ok &= torch.where(is_real, any_fit, True)
    return ok


# ktlint: fence the screen IS the sync point — one dispatch + one
# device-to-host read (plus the timed re-runs of the measure branch)
def screen_subset_deletes(
    nodes: Sequence[SimNode],
    subsets: Sequence[Sequence[int]],   # K subsets of node indices
    compat: Optional[np.ndarray] = None,
    pmax_total: int = 128,
    measure: bool = False,
    device=None,
) -> SubsetScreenResult:
    """One device call: for every candidate subset, can the union of its
    members' pods fit on the non-members' residual capacity?

    Pods carry their source-node index so ``compat`` stays per-(source,
    target).  Subsets whose pod union exceeds ``pmax_total`` are
    conservatively marked undeletable.  The program runs on ``device``
    (``None``: the CUDA card, raising without one).  ``measure=True``
    times three more runs on perturbed residuals and reports their median
    as ``eval_ms`` and the first run as ``compile_ms``; the default single
    run is what control loops want.  Both times end with the result on
    the host.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    N = len(nodes)
    K = len(subsets)
    R = len(_RESOURCES)

    residual = np.zeros((N, R), dtype=np.float32)
    for i, n in enumerate(nodes):
        rem = n.remaining()
        residual[i] = [max(0.0, rem.get(r, 0.0)) for r in _RESOURCES]

    member = np.zeros((K, N), dtype=bool)
    pods_mat = np.zeros((K, pmax_total, R), dtype=np.float32)
    pods_src = np.zeros((K, pmax_total), dtype=np.int64)
    overflow = np.zeros(K, dtype=bool)
    pods_ridx = _RESOURCES.index(L.RESOURCE_PODS)
    slots = 0
    for k, subset in enumerate(subsets):
        member[k, list(subset)] = True
        entries = [(_ffd_key(p), i, p) for i in subset for p in nodes[i].pods]
        if len(entries) > pmax_total:
            overflow[k] = True
            continue
        slots = max(slots, len(entries))
        entries.sort(key=lambda e: e[0])
        for j, (_, i, p) in enumerate(entries):
            for r, name in enumerate(_RESOURCES):
                pods_mat[k, j, r] = p.requests.get(name, 0.0)
            pods_mat[k, j, pods_ridx] = 1.0
            pods_src[k, j] = i

    cm = np.ones((N, N), dtype=bool) if compat is None else np.asarray(
        compat, dtype=bool)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # slots past the fullest subset are padding for every subset: no-ops
    args = (put(residual), put(member), put(pods_mat[:, :slots]),
            put(pods_src[:, :slots]), put(cm))
    SCREEN_PROGRAM.add(dev)
    out_host = _screen_program(*args).cpu().numpy()
    first_ms = (time.perf_counter() - t0) * 1000.0
    if measure:
        # median of 3 timed runs on per-run perturbed residuals (outputs
        # discarded), each ending with its result on the host
        rng = np.random.default_rng(0)
        times = []
        for _ in range(3):
            res_i = residual + rng.uniform(
                0.0, 1e-5, residual.shape).astype(np.float32)
            args_i = (put(res_i),) + args[1:]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            SCREEN_PROGRAM.add(dev)
            _screen_program(*args_i).cpu()
            times.append((time.perf_counter() - t1) * 1000.0)
        eval_ms = sorted(times)[1]
        compile_ms = first_ms
    else:
        eval_ms, compile_ms = first_ms, 0.0

    return SubsetScreenResult(
        deletable=out_host & ~overflow,
        n_subsets=K, eval_ms=eval_ms, compile_ms=compile_ms,
    )


def screen_delete_candidates(
    nodes: Sequence[SimNode],
    compat: Optional[np.ndarray] = None,
    pmax: int = 64,
    measure: bool = False,
    device=None,
) -> DeleteScreenResult:
    """Single-node screen = the subset screen over all singletons.  A
    candidate's own capacity never counts (it is the deleted node)."""
    if compat is not None:
        compat = compat.copy()
        np.fill_diagonal(compat, False)
    else:
        compat = ~np.eye(len(nodes), dtype=bool)
    res = screen_subset_deletes(
        nodes, [[i] for i in range(len(nodes))], compat,
        pmax_total=pmax, measure=measure, device=device,
    )
    return DeleteScreenResult(
        deletable=res.deletable, n_candidates=len(nodes),
        eval_ms=res.eval_ms, compile_ms=res.compile_ms,
    )


def compat_matrix(
    nodes: Sequence[SimNode],
    sources: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Host-side label/taint compatibility: pods of node i can run on node j.

    ``sources`` limits the computed rows to those node indices (the screen
    only reads rows for member/candidate nodes) — O(|sources| * N) string
    work instead of O(N^2); uncomputed rows stay False.  Conservative: every
    pod of i must tolerate j's taints and have its node-selector satisfied by
    j's labels (full requirement algebra — the exact sequential what-if
    re-verifies anything the screen admits).
    """
    N = len(nodes)
    src = range(N) if sources is None else sources
    out = np.zeros((N, N), dtype=bool)

    # The naive O(|sources| x N x pods) requirement-algebra walk repeats
    # the same few questions millions of times at fleet scale.  Two-level
    # memo instead:
    #  - a POD SIGNATURE is exactly what node-compat depends on — the pod's
    #    effective requirement set (node_selector + required affinity term
    #    0) plus its tolerations.  Requests/labels/owner do NOT widen it.
    #  - a DESTINATION CLASS is the node's taints plus only the label keys
    #    any source pod's requirements actually reference — a unique
    #    per-node hostname label must not split an otherwise uniform fleet
    #    into N classes when nothing selects on hostname.
    pod_sig: Dict[int, tuple] = {}        # id(pod) -> signature
    sig_reqs: Dict[tuple, object] = {}    # signature -> Requirements
    relevant_keys: set = set()
    for i in src:
        for p in nodes[i].pods:
            reqs = p.scheduling_requirements()[0]
            # Requirements.signature() is the lossless structural key
            # (to_list()'s canonical operator form would collide
            # [Exists(k), NotIn(k,{x})] with [NotIn(k,{x})])
            key = (reqs.signature(), tuple(p.tolerations))
            pod_sig[id(p)] = key
            if key not in sig_reqs:
                sig_reqs[key] = reqs
                relevant_keys.update(reqs)

    cls_idx, class_rep = node_classes(nodes, relevant_keys)
    dst_class = np.asarray(cls_idx, dtype=np.int64)
    n_cls = len(class_rep)

    sig_cls_ok: Dict[tuple, np.ndarray] = {}  # signature -> [n_cls] bool

    def sig_ok_row(key: tuple) -> np.ndarray:
        row = sig_cls_ok.get(key)
        if row is None:
            reqs = sig_reqs[key]
            tols = key[1]  # the signature's second element IS the tolerations
            row = np.zeros(n_cls, dtype=bool)
            for c, dst in enumerate(class_rep):
                row[c] = (
                    not any(t.blocks(tols) for t in dst.taints)
                    and reqs.compatible(dst.labels) is None
                )
            sig_cls_ok[key] = row
        return row

    for i in src:
        node_i = nodes[i]
        if not node_i.pods:
            out[i, :] = True
            out[i, i] = False
            continue
        ok_cls = np.ones(n_cls, dtype=bool)
        for p in node_i.pods:
            ok_cls &= sig_ok_row(pod_sig[id(p)])
            if not ok_cls.any():
                break
        out[i] = ok_cls[dst_class]
        out[i, i] = False
    return out

# ---------------------------------------------------------------------------
# one-dispatch consolidation what-if sweeps
# ---------------------------------------------------------------------------
#
# Every candidate's what-if is a PERTURBATION of one base solution (the
# cluster with all nodes active): same catalog tensors, same existing-node
# state, only the member rows and the displaced pods differ.  The sweep
# builds the base cluster's host arrays once, derives each candidate's
# entry (deactivate the member rows, subtract their selector/limit
# contributions, swap in the candidate's counts), and solves the entries as
# slots of ONE batched device dispatch with one read back
# (TpuSolver.solve_many_prepared).
#
# Exactness contract: a slot whose device answer is anything but a clean
# "all pods fit on the survivors, no new node" is re-solved through the
# serial scheduler path (full relaxation/residue/reseat ladder), so sweep
# decisions are identical to the sequential what-if loop; a failed
# dispatch serves its chunk serially, and a candidate's own failure is
# returned in its slot.

#: sweep candidates per batched dispatch (chunked above this)
SWEEP_MAX_SLOTS = 16


@dataclass
class SweepOutcome:
    """One consolidation what-if sweep: per-candidate results IN ORDER —
    a SolveResult, the Exception that candidate alone raised, or None for
    slots past a ``stop_on`` early exit (never evaluated)."""

    results: List[object]
    path: str                # "batched" | "serial" | "mixed"
    wall_ms: float
    n_batched: int = 0
    n_serial: int = 0
    dispatches: int = 0      # batched device dispatches paid


#: sweep execution paths — the zero-initialised label population of
#: karpenter_solver_consolidation_sweeps_total
SWEEP_PATHS = ("batched", "mixed", "serial")


def zero_init_sweep_metrics(registry: Registry) -> None:
    """Register the sweep series at 0."""
    for path in SWEEP_PATHS:
        if not registry.counter(CONSOLIDATION_SWEEPS).has({"path": path}):
            registry.counter(CONSOLIDATION_SWEEPS).inc(
                {"path": path}, value=0.0)
    registry.histogram(CONSOLIDATION_SWEEP_SLOTS)
    registry.histogram(CONSOLIDATION_SWEEP_DURATION)


def sweep_dims(st, NE: int, node_budget: int, track: bool = False) -> dict:
    """What-if-sized padded dims: the standard :func:`tpu.solve_dims`
    bucketing with FINE small-solve rungs on the G and NR axes.  A what-if
    places a handful of groups against a known node count; the serving-path
    rungs (G quantum 16, NR floor 512) would run the scan at 4-8x the
    state the sweep needs."""
    from .tpu import _rung, solve_dims

    dims = solve_dims(st, NE=NE, node_budget=node_budget, track=track,
                      full_nr=True)
    if st.G <= 16:
        dims["G"] = _rung(st.G, 4, 16)
    if node_budget <= 512:
        dims["NR"] = _rung(max(1, node_budget), 64, 512)
    return dims


def build_sweep_entries(
    solver,
    sts: Sequence[object],
    all_nodes: Sequence[SimNode],
    members: Sequence[Sequence[int]],
    dims: dict,
    node_budget: int,
) -> List[dict]:
    """Derive one megabatch entry per candidate from ONE shared base build.

    Every candidate's what-if shares the base cluster's host arrays
    (residuals, compat, selector counts, provisioner usage over ALL nodes);
    a candidate differs only by (a) its member node rows being deactivated
    — an inactive row can never receive pods, which is exactly "this node
    is deleted" — (b) its members' selector/zone/provisioner contributions
    subtracted from the seeded counters, and (c) its own pods' counts
    tensors.  All ``sts`` must share one group structure (the shape-tier
    tensorize guarantee the caller groups by) and one ``dims`` bucket.
    """
    from .tpu import host_count_arrays

    st0 = sts[0]
    N = len(all_nodes)
    track = bool(dims["track"])
    np_consts0, feas0, np_init0, _ = solver._host_arrays(
        st0, all_nodes, node_budget=node_budget,
        track_assignments=track, full_nr=True, dims=dims,
    )
    (ex_res, ex_zone, row_dom, row_cand, ex_price, ex_sel, active0,
     n_used0, zc0, tot0, prov_used0, infeas0) = np_init0
    pad_g = dims["G"] - st0.G
    Z = dims["Z"]
    prov_index = {n: i for i, n in enumerate(st0.prov_names)}

    entries: List[dict] = []
    for st_k, member in zip(sts, members):
        counts, _req, suffix_res, suffix_cnt = host_count_arrays(
            st_k, pad_g, Z)
        consts_k = dict(np_consts0, counts=counts, suffix_res=suffix_res,
                        suffix_cnt=suffix_cnt)
        active = active0.copy()
        zc = zc0.copy()
        tot = tot0.copy()
        prov_used = prov_used0.copy()
        for idx in member:
            active[idx] = False
            sel_row = ex_sel[idx]
            if sel_row.size:
                zc[:, ex_zone[idx]] -= sel_row
                tot -= sel_row
            node = all_nodes[idx]
            pi = prov_index.get(node.provisioner)
            if pi is not None:
                prov_used[pi] = prov_used[pi] - st0.capacity_row(
                    node.instance_type, node.allocatable)
        init_k = (ex_res, ex_zone, row_dom, row_cand, ex_price, ex_sel,
                  active, n_used0, zc, tot, prov_used, infeas0)
        entries.append(dict(
            r=dict(st=st_k, existing_nodes=(), max_nodes=node_budget,
                   track_assignments=track),
            np_consts=consts_k, feas=feas0, np_init=init_k, dims=dims, NE=N,
        ))
    return entries


def sweep_what_ifs(
    scheduler,
    all_nodes: Sequence[SimNode],
    candidates: Sequence[Sequence[int]],
    *,
    provisioners,
    instance_types,
    daemonsets: Sequence = (),
    unavailable=None,
    max_new: int = 1,
    registry: Optional[Registry] = None,
    trace=None,
    stop_on=None,
) -> SweepOutcome:
    """Evaluate every candidate's what-if ("delete these nodes; do their
    pods fit on the rest plus at most ``max_new`` new nodes?") — batched as
    slots of one device dispatch on ``scheduler``'s device, serially
    through ``scheduler.solve`` where a candidate cannot batch.
    ``candidates`` are node-index subsets of ``all_nodes``.  Results are in
    candidate order; decisions are identical to the sequential what-if
    loop by construction (non-clean slots re-solve serially).

    ``stop_on(k, result)`` — optional early exit for the SERIAL fill, for
    callers that take the first confirming candidate in order: evaluated
    on every slot in candidate order — batched and serial alike — and once
    it returns True the remaining unresolved slots stay ``None`` instead
    of paying a full what-if solve each.  Batched slots themselves always
    resolve (they arrive together in the one dispatch, already paid for)."""
    t0 = time.perf_counter()
    registry = registry or scheduler.registry
    zero_init_sweep_metrics(registry)
    trace = trace or NULL_TRACE
    from ..models.tensorize import batch_needs_oracle, device_inexpressible
    from .scheduler import _harden_preferences
    from .tpu import _dims_key

    K = len(candidates)
    results: List[object] = [None] * K
    n_batched = n_serial = dispatches = 0

    def serial_one(k: int) -> object:
        member = set(candidates[k])
        others = [n for j, n in enumerate(all_nodes) if j not in member]
        pods = [p for idx in candidates[k]
                for p in all_nodes[idx].pods if not p.is_daemon]
        try:
            return scheduler.solve(
                pods, provisioners, instance_types, existing_nodes=others,
                daemonsets=daemonsets, unavailable=unavailable,
                allow_new_nodes=True, max_new_nodes=max_new,
                trace=trace,
            )
        # ktlint: allow[KT005] per-candidate boxed outcome: one poisoned
        # what-if must not fail the sweep's batchmates; the caller re-raises
        # or skips per candidate
        except Exception as err:  # noqa: BLE001
            return err

    # whole-sweep device eligibility; per-candidate carve-outs below.  A
    # meshed scheduler sweeps SHARDED (the chunk's slot axis over the
    # mesh's entries, one dispatch + one read back, like one device); only
    # a mesh with more entries than the slot-rung ladder keeps the serial
    # path (path="serial")
    from .tpu import mesh_shardable

    mesh = getattr(scheduler, "mesh", None)
    device_ok = (scheduler.backend in ("auto", "tpu")
                 and mesh_shardable(mesh)
                 and scheduler._tensorize_cache is not None)

    N = len(all_nodes)
    node_budget = N + (max_new if max_new is not None else 0)
    buckets: Dict[tuple, List[int]] = {}
    prepared: Dict[int, tuple] = {}   # k -> (st, dims, skey)
    if device_ok:
        for k in range(K):
            pods = [p for idx in candidates[k]
                    for p in all_nodes[idx].pods if not p.is_daemon]
            if not pods:
                # empty candidate: trivially deletable, same as the serial
                # scheduler.solve([]) answer
                results[k] = SolveResult(nodes=[], assignments={},
                                         infeasible={})
                continue
            if nodes_carry_gangs([all_nodes[i] for i in candidates[k]]):
                # gang what-ifs must re-seat the whole gang: only the
                # serial path judges that
                continue
            try:
                hardened = [_harden_preferences(p) for p in pods]
                if (batch_needs_oracle(hardened)
                        or any(device_inexpressible(p) for p in hardened)):
                    continue  # oracle-coupled shapes: serial path
                st, _tier = scheduler._tensorize_cache.tensorize(
                    hardened, provisioners, instance_types,
                    daemonsets=daemonsets, unavailable=unavailable,
                )
                dims = sweep_dims(st, N, node_budget)
                skey = tuple(g.key for g in st.groups)
                bkey = (_dims_key(dims), st.vocab.key_id[L.ZONE],
                        st.vocab.key_id[L.CAPACITY_TYPE])
                prepared[k] = (st, dims, skey)
                buckets.setdefault(bkey, []).append(k)
            # an unbatchable candidate just solves on the serial path,
            # where a real error surfaces with context
            except Exception:  # noqa: BLE001
                logger.debug("sweep candidate %d not batchable; serial",
                             k, exc_info=True)

    solver = scheduler._tpu if device_ok else None
    for idxs in buckets.values():
        for lo in range(0, len(idxs), SWEEP_MAX_SLOTS):
            chunk = idxs[lo:lo + SWEEP_MAX_SLOTS]
            try:
                # one base build per group structure within the chunk
                by_skey: Dict[tuple, List[int]] = {}
                for k in chunk:
                    by_skey.setdefault(prepared[k][2], []).append(k)
                entry_of: Dict[int, dict] = {}
                for ks in by_skey.values():
                    entries = build_sweep_entries(
                        solver, [prepared[k][0] for k in ks], all_nodes,
                        [candidates[k] for k in ks], prepared[ks[0]][1],
                        node_budget,
                    )
                    for k, e in zip(ks, entries):
                        entry_of[k] = e
                mesh_kw = ({} if mesh is None
                           else dict(min_slots=len(chunk), mesh=mesh,
                                     registry=registry))
                with trace.span("sweep_dispatch", slots=len(chunk)):
                    outs = solver.solve_many_prepared(
                        [entry_of[k] for k in chunk], **mesh_kw)
            # a failed sweep dispatch degrades the whole chunk to the
            # proven serial path (decisions unchanged)
            except Exception:  # noqa: BLE001
                logger.warning("sweep dispatch failed; chunk served "
                               "serially", exc_info=True)
                continue
            dispatches += 1
            registry.histogram(CONSOLIDATION_SWEEP_SLOTS).observe(len(chunk))
            for k, out in zip(chunk, outs):
                if isinstance(out, BaseException):
                    continue  # serial below (boxed per-slot outcome)
                res = out.result
                if res.infeasible or res.nodes:
                    # not a clean "fits on the survivors" answer: the
                    # serial path's repair ladder (residue waves, reseat,
                    # replacement sizing) must judge it — exact parity
                    continue
                results[k] = res
                n_batched += 1

    for k in range(K):
        if results[k] is None:
            results[k] = serial_one(k)
            n_serial += 1
        # evaluated on EVERY slot in candidate order — batched slots too,
        # so a dispatch-confirmed early candidate stops the serial fill
        # before it pays for later unbatchable ones the caller won't read
        if stop_on is not None and stop_on(k, results[k]):
            break

    wall_ms = (time.perf_counter() - t0) * 1000.0
    # "serial" means serial FALLBACKS ran — a sweep resolved entirely by
    # pre-dispatch shortcuts (no solve on either path) stays "batched" so
    # the serial-fallback rate only counts real degradation
    path = ("serial" if n_serial and not n_batched
            else "mixed" if n_serial else "batched")
    registry.counter(CONSOLIDATION_SWEEPS).inc({"path": path})
    registry.histogram(CONSOLIDATION_SWEEP_DURATION).observe(wall_ms / 1000.0)
    return SweepOutcome(results=results, path=path, wall_ms=wall_ms,
                        n_batched=n_batched, n_serial=n_serial,
                        dispatches=dispatches)
