"""Hierarchical solving of very large batches: block decomposition + dual
reconciliation, on the port's batched device solve.

The port of the reference package's ``solver/hierarchy.py``:

1. **Partition** — union-find over the coupling guard's constraint
   reachability (a selector slot couples every group that CARRIES a hard
   constraint watching it with every group the selector MATCHES).
   Components are LPT-packed by pod count into at most ``MEGA_MAX_SLOTS``
   blocks; a component is never split.
2. **Block solve** — every block is one slot of ONE batched dispatch
   (``TpuSolver.solve_many_prepared``) built from one shared base.
3. **Price loop** — blocks contend for provisioner limits.  A
   fixed-iteration dual ascent on the mirror-descent schedule prices
   over-subscribed provisioners up; each price wave scores every pod group
   through the fused packed-score kernel (:func:`price_step_scores`) to find
   the groups that would buy from a hot provisioner, and the contending
   blocks re-solve against the adjusted prices — again one dispatch per
   wave.
4. **Repair** — the host enforces limits exactly and re-seats stragglers
   through the warm-start path (``warmstart.delta_solve``); a cross-block
   tail pass then repacks each block's underfull tail node, shipping the
   cheaper of before/after.

The price loop's score runs PACKED: int8 feasibility and bf16 prices.  Both
entries of the hand-written kernel (``csrc/packed_score.cu``) launch on
CUDA tensors or raise, and take their plain PyTorch versions only for CPU
tensors: :func:`packed_scan_scores` (the reference kernel's function, a
bf16 price row in) and :func:`price_step_scores` (the price loop's step:
feasibility, base prices and owners resident on the device, the adjusted
bf16 row built by the kernel from ``exp(lam)``, one ``[2, G]`` buffer out).

Every block wave runs through the scheduler's device hang guard with
``1 / (1 + KT_HIER_PRICE_ITERS)`` of its deadline, so a wedged device
latches in the time of one flat solve.  A wave that trips the guard counts
``fallback_degraded`` and hands the batch back to the scheduler, whose flat
path serves it from a host tier while the device is latched unhealthy.
Unlike the reference, no other wave failure is caught here: there is no
compile to wait for, so a fault surfaces to the caller.

A traced request names the hierarchical solve's parts on its trace: ``hier.partition``
(components, block packing, budgets), ``hier.entries`` (every block-entry
build), ``hier.wave`` (every block wave: the dispatch's ``device_execute``
with the group step's ``step.*`` parts, and one ``extract`` per block),
``hier.price`` (each price iteration's dual bookkeeping and score step),
``hier.merge`` (the merge and the exact limit enforcement), ``hier.repair``
(the straggler re-seat) and ``hier.tail`` (the cross-block tail repack).
The re-seats' flat solves open their own spans inside the last two.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..gang import gang_enabled
from ..metrics import (
    HIER_BLOCKS,
    HIER_DURATION,
    HIER_PATHS,
    HIER_PRICE_ITERATIONS,
    HIER_REPAIR_PODS,
    HIER_SOLVES,
    Registry,
)
from ..obs.trace import NULL_TRACE, gc_spans
from .types import SimNode, SolveResult

logger = logging.getLogger(__name__)

#: infeasible-cost sentinel, shared with the scan program's padding value
_BIG = float(np.float32(3.0e38))

DEFAULT_HIER_THRESHOLD = 100_000
DEFAULT_PRICE_ITERS = 4


def hier_threshold() -> int:
    """Pod count at/above which the scheduler routes hierarchically
    (default 100k; 0 disables the path).  Read through the knob registry
    (tuning/knobs.py): a tuned override wins, else the registry falls back
    to ``KT_HIER_THRESHOLD``/the default at call time."""
    from ..tuning.knobs import global_knobs

    try:
        return int(global_knobs().get("hier_threshold"))
    except (TypeError, ValueError):
        return DEFAULT_HIER_THRESHOLD


def hier_price_iters() -> int:
    """Fixed price-ascent wave budget (``KT_HIER_PRICE_ITERS``)."""
    try:
        return max(0, int(os.environ.get("KT_HIER_PRICE_ITERS",
                                         DEFAULT_PRICE_ITERS)))
    except ValueError:
        return DEFAULT_PRICE_ITERS


def zero_init_hier_metrics(registry: Registry) -> None:
    """Register the hierarchical series at 0."""
    for path in HIER_PATHS:
        if not registry.counter(HIER_SOLVES).has({"path": path}):
            registry.counter(HIER_SOLVES).inc({"path": path}, value=0.0)
    registry.histogram(HIER_BLOCKS)
    registry.histogram(HIER_PRICE_ITERATIONS)
    registry.histogram(HIER_REPAIR_PODS)
    registry.histogram(HIER_DURATION)


# ---------------------------------------------------------------------------
# partition: constraint-reachability components -> LPT blocks
# ---------------------------------------------------------------------------


class _UnionFind:
    def __init__(self, n: int) -> None:
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def coupling_components(st) -> List[List[int]]:
    """Connected components of the group-coupling graph, in first-group
    order.  Two groups couple iff some selector slot reaches both (a group
    whose hard constraint CARRIES the slot, or a group the selector
    MATCHES); groups carrying the same gang tag join one component."""
    G = st.G
    uf = _UnionFind(G)
    S = st.S
    if S:
        sel_match = np.asarray(st.g_sel_match)  # [S, G]
        reach: List[List[int]] = [[] for _ in range(S)]
        for arr in (st.g_zone_spread, st.g_host_spread, st.g_zone_anti,
                    st.g_zone_paff, st.g_host_paff):
            a = np.asarray(arr)
            for gi in np.nonzero(a >= 0)[0]:
                reach[int(a[gi])].append(int(gi))
        for sid in range(S):
            members = set(reach[sid])
            members.update(int(g) for g in np.nonzero(sel_match[sid])[0])
            it = iter(sorted(members))
            first = next(it, None)
            if first is None:
                continue
            for g in it:
                uf.union(first, g)
    g_gang = np.asarray(getattr(st, "g_gang", np.zeros(0, dtype=np.int32)))
    if g_gang.size and gang_enabled():
        first_of: Dict[int, int] = {}
        for gi in np.nonzero(g_gang >= 0)[0]:
            tag = int(g_gang[gi])
            anchor = first_of.setdefault(tag, int(gi))
            if anchor != int(gi):
                uf.union(anchor, int(gi))
    comps: Dict[int, List[int]] = {}
    for gi in range(G):
        comps.setdefault(uf.find(gi), []).append(gi)
    return sorted(comps.values(), key=lambda c: c[0])


def partition_blocks(
    st, components: Sequence[Sequence[int]], max_blocks: int,
) -> List[np.ndarray]:
    """LPT-pack components (weight = pod count) into at most ``max_blocks``
    bins; returns one boolean group mask ``[G]`` per non-empty block.  A
    component is NEVER split."""
    counts = np.asarray(st.counts)
    B = max(1, min(int(max_blocks), len(components)))
    weights = [(int(sum(counts[g] for g in comp)), ci)
               for ci, comp in enumerate(components)]
    weights.sort(key=lambda t: (-t[0], t[1]))
    loads = [0] * B
    bins: List[List[int]] = [[] for _ in range(B)]
    for w, ci in weights:
        b = min(range(B), key=lambda i: (loads[i], i))
        loads[b] += w
        bins[b].append(ci)
    masks: List[np.ndarray] = []
    for b in range(B):
        if not bins[b]:
            continue
        mask = np.zeros(st.G, dtype=bool)
        for ci in bins[b]:
            for gi in components[ci]:
                mask[gi] = True
        masks.append(mask)
    return masks


def block_budgets(st, masks: Sequence[np.ndarray]) -> List[int]:
    """Per-block node budget: the block's pod count — the exact worst case
    (one node per pod), so a block solve can never exhaust its slots."""
    counts = np.asarray(st.counts)
    return [max(1, int(counts[m].sum())) for m in masks]


# ---------------------------------------------------------------------------
# block entries: one shared base build, per-block masked counts
# ---------------------------------------------------------------------------


def hier_dims(st, node_budget: int) -> dict:
    """Shared dims bucket for every block slot: :func:`tpu.solve_dims` at
    the WORST block's node budget with the full-NR axis."""
    from .tpu import solve_dims

    return solve_dims(st, NE=0, node_budget=node_budget, track=True,
                      full_nr=True)


def build_block_entries(
    solver,
    st,
    masks: Sequence[np.ndarray],
    budgets: Sequence[int],
    dims: dict,
    *,
    base=None,
    cand_price: Optional[np.ndarray] = None,
    trace=None,
) -> Tuple[List[dict], tuple]:
    """One megabatch entry per block from ONE shared base build.  A block
    differs from the base only by its counts vector masked to member
    groups, the matching per-zone suffix backfill projection, its node
    budget, and — on price waves — the dual-adjusted candidate prices.
    Everything else is the SAME array object across entries, which the
    dispatch transfers once."""
    from .tpu import suffix_projection, zone_share_matrix

    if base is None:
        base = solver._host_arrays(
            st, (), node_budget=max(budgets), track_assignments=True,
            full_nr=True, dims=dims,
        )
    np_consts0, feas0, np_init0, _ = base
    pad_g = dims["G"] - st.G
    Z = dims["Z"]
    np_requests = np_consts0["requests"]
    zone_share = zone_share_matrix(st, pad_g, Z)
    counts_full = np.asarray(st.counts)

    entries: List[dict] = []
    for mask, budget in zip(masks, budgets):
        counts = np.pad(counts_full * mask, (0, pad_g), constant_values=0)
        demand = (counts[:, None] * np_requests).astype(np.float32)
        demand_z = demand[:, None, :] * zone_share[:, :, None]
        count_z = counts[:, None].astype(np.float32) * zone_share
        suffix_res, suffix_cnt = suffix_projection(demand_z, count_z)
        consts = dict(np_consts0, counts=counts, suffix_res=suffix_res,
                      suffix_cnt=suffix_cnt,
                      node_budget=np.int32(budget))
        if cand_price is not None:
            consts["cand_price"] = cand_price
        entries.append(dict(
            r=dict(st=st, existing_nodes=(), max_nodes=int(budget),
                   track_assignments=True, trace=trace or NULL_TRACE,
                   groups=np.nonzero(mask)[0]),
            np_consts=consts, feas=feas0, np_init=np_init0, dims=dims, NE=0,
        ))
    return entries, base


# ---------------------------------------------------------------------------
# packed feasibility+score hot path (int8 / bf16): the CUDA kernel
# ---------------------------------------------------------------------------


def packed_scan_scores_plain(
    f_packed: torch.Tensor, price_packed: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the packed score: ``(best_cost[G] f32,
    best_idx[G] i32)`` — cheapest feasible candidate per row over int8
    feasibility ``[G, C]`` and bf16 prices ``[C]`` (upcast to float32 for
    the compare); infeasible cells score 3.0e38, so an all-infeasible row
    returns (3.0e38, 0).  The index is the min of the columns attaining the
    min: the first minimum."""
    C = f_packed.shape[1]
    cost = torch.where(f_packed > 0,
                       price_packed.to(torch.float32)[None, :], _BIG)
    best = cost.amin(dim=1)
    col = torch.arange(C, dtype=torch.int32, device=cost.device)
    hit = torch.where(cost == best[:, None], col, C)
    return best, hit.amin(dim=1).to(torch.int32)


def packed_scan_scores(
    f_packed: torch.Tensor, price_packed: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(best_cost[G] f32, best_idx[G] i32)`` of :func:`packed_scan_scores_plain`.

    On CUDA tensors this launches the hand-written kernel
    (``csrc/packed_score.cu``) on the current stream, or raises; only CPU
    tensors take the plain version."""
    if f_packed.device.type == "cpu" and price_packed.device.type == "cpu":
        return packed_scan_scores_plain(f_packed, price_packed)
    from ..kernels import PACKED_SCORE

    if f_packed.device.type != "cuda" or price_packed.device != f_packed.device:
        raise ValueError(
            f"packed_scan_scores: f on {f_packed.device}, price on "
            f"{price_packed.device}; both must be on one CUDA device")
    if f_packed.dtype != torch.int8 or price_packed.dtype != torch.bfloat16:
        raise TypeError(
            f"packed_scan_scores takes int8 f and bf16 price, got "
            f"{f_packed.dtype} and {price_packed.dtype}")
    if (f_packed.dim() != 2 or price_packed.dim() != 1
            or price_packed.shape[0] != f_packed.shape[1]):
        raise ValueError(
            f"packed_scan_scores shapes: f {tuple(f_packed.shape)}, "
            f"price {tuple(price_packed.shape)}")
    if not (f_packed.is_contiguous() and price_packed.is_contiguous()):
        raise ValueError("packed_scan_scores takes contiguous tensors")
    G, C = f_packed.shape
    cost = torch.empty(G, dtype=torch.float32, device=f_packed.device)
    idx = torch.empty(G, dtype=torch.int32, device=f_packed.device)
    stream = torch.cuda.current_stream(f_packed.device).cuda_stream
    with torch.cuda.device(f_packed.device):
        rc = PACKED_SCORE.launcher()(
            f_packed.data_ptr(), price_packed.data_ptr(), cost.data_ptr(),
            idx.data_ptr(), G, C, stream)
    if rc != 0:
        raise RuntimeError(f"packed_score launch failed: CUDA error {rc}")
    PACKED_SCORE.count_launch()
    return cost, idx


def split_scores(out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cost f32 [G], idx i32 [G])`` views of a :func:`price_step_scores`
    buffer (row 0 holds the cost's bits, row 1 the index)."""
    return out[0].view(torch.float32), out[1]


def price_step_scores_plain(
    f_packed: torch.Tensor, cand_price: torch.Tensor,
    cand_prov: torch.Tensor, mult: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of the price loop's score step: the candidate
    prices under the multipliers ``mult[P]`` (``price_adjusted``: 3.0e38/inf
    rows stay put), the cheapest domain per candidate, packed to bf16
    (round to nearest even, as ``pack_scores``), then
    :func:`packed_scan_scores_plain`.
    Returns one int32 ``[2, G]`` buffer: the cost's f32 bits, then the
    index (see :func:`split_scores`)."""
    m = mult[cand_prov.to(torch.int64)][:, None]
    adj = torch.where(cand_price >= 1e37, cand_price, cand_price * m)
    row = adj.amin(dim=1).to(torch.bfloat16)
    cost, idx = packed_scan_scores_plain(f_packed, row)
    return torch.stack([cost.view(torch.int32), idx])


def price_step_scores(
    f_packed: torch.Tensor, cand_price: torch.Tensor,
    cand_prov: torch.Tensor, mult: torch.Tensor,
) -> torch.Tensor:
    """The price loop's score step, :func:`price_step_scores_plain`'s
    function: int8 feasibility ``[G, C]``, base candidate prices f32
    ``[C, D]`` (3.0e38 or inf where a candidate has no offering), owning
    provisioner int32 ``[C]`` (each in ``[0, P)``) and ``exp(lam)`` f32
    ``[P]``.  Returns the int32 ``[2, G]`` buffer of :func:`split_scores`.

    On CUDA tensors this launches the fused kernel (``csrc/packed_score.cu``,
    ``price_step_score_launch``) once on the current stream, or raises;
    only CPU tensors take the plain version."""
    args = (f_packed, cand_price, cand_prov, mult)
    if all(t.device.type == "cpu" for t in args):
        return price_step_scores_plain(*args)
    from ..kernels import PRICE_STEP_SCORE

    dev = f_packed.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError(
            "price_step_scores: tensors on "
            f"{[str(t.device) for t in args]}; all must be on one CUDA "
            "device")
    want = (torch.int8, torch.float32, torch.int32, torch.float32)
    if tuple(t.dtype for t in args) != want:
        raise TypeError(
            "price_step_scores takes int8 f, f32 cand_price, int32 "
            f"cand_prov and f32 mult, got {[t.dtype for t in args]}")
    if (f_packed.dim() != 2 or cand_price.dim() != 2 or cand_prov.dim() != 1
            or mult.dim() != 1 or cand_price.shape[0] != f_packed.shape[1]
            or cand_prov.shape[0] != f_packed.shape[1]
            or f_packed.shape[1] == 0 or cand_price.shape[1] == 0
            or mult.shape[0] == 0):
        raise ValueError(
            "price_step_scores shapes: f "
            f"{tuple(f_packed.shape)}, cand_price {tuple(cand_price.shape)}, "
            f"cand_prov {tuple(cand_prov.shape)}, mult {tuple(mult.shape)}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("price_step_scores takes contiguous tensors")
    G, C = f_packed.shape
    out = torch.empty((2, G), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = PRICE_STEP_SCORE.launcher()(
            f_packed.data_ptr(), cand_price.data_ptr(), cand_prov.data_ptr(),
            mult.data_ptr(), out.data_ptr(), out.data_ptr() + 4 * G, G, C,
            cand_price.shape[1], stream)
    if rc != 0:  # also a C past the shared-memory price row's cap
        raise RuntimeError(
            f"price_step_score launch failed: CUDA error {rc}")
    PRICE_STEP_SCORE.count_launch()
    return out


def score_inputs(st, base) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The price loop's score inputs on the host: int8 feasibility
    ``[G, C]``, the first ``C`` rows of the padded base ``cand_price`` (f32
    ``[C, D]``, the no-offering cells at the 3.0e38 sentinel) and
    ``cand_prov`` (int32 ``[C]``, checked to lie in ``[0, P)``)."""
    from ..models.tensorize import pack_feasibility
    from .relax import _host_feasibility

    C = st.C
    prov = np.ascontiguousarray(base[0]["cand_prov"][:C], dtype=np.int32)
    if C and not 0 <= int(prov.min()) <= int(prov.max()) < len(st.prov_names):
        raise ValueError("cand_prov holds a provisioner index out of range")
    return (pack_feasibility(_host_feasibility(st)),
            np.ascontiguousarray(base[0]["cand_price"][:C], dtype=np.float32),
            prov)


class ScoreStep:
    """The price loop's score step on inputs resident on ``device``:
    feasibility, base prices and owners are uploaded once, here.  Each call
    writes ``exp(lam)`` into a reused host buffer, copies it up, launches
    :func:`price_step_scores` once and copies its ``[2, G]`` buffer back
    once; on CUDA the host buffers are pinned, both copies are asynchronous
    and the call waits once, for the stream."""

    def __init__(self, f: np.ndarray, cand_price: np.ndarray,
                 cand_prov: np.ndarray, n_prov: int, device) -> None:
        dev = torch.device(device)
        pin = dev.type == "cuda"
        self.device = dev
        self.inputs = tuple(torch.from_numpy(a).to(dev)
                            for a in (f, cand_price, cand_prov))
        self.mult = torch.empty(n_prov, dtype=torch.float32, device=dev)
        self.mult_host = torch.empty(n_prov, dtype=torch.float32,
                                     pin_memory=pin)
        self.out_host = torch.empty((2, f.shape[0]), dtype=torch.int32,
                                    pin_memory=pin)
        self._mult_np = self.mult_host.numpy()

    # ktlint: fence the price loop's one wait per iteration: the next dual
    # update needs these scores on the host
    def __call__(self, lam: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``(cost f32 [G], idx i32 [G])`` on the host under duals ``lam``."""
        self._mult_np[:] = np.exp(lam)  # float64 -> float32, as astype
        self.mult.copy_(self.mult_host, non_blocking=True)
        self.out_host.copy_(price_step_scores(*self.inputs, self.mult),
                            non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        cost, idx = split_scores(self.out_host)
        return cost.numpy().copy(), idx.numpy().copy()


# ---------------------------------------------------------------------------
# price loop helpers (host-side dual bookkeeping)
# ---------------------------------------------------------------------------


def _prov_usage(st, nodes: Sequence[SimNode], P: int) -> np.ndarray:
    """[P, R] capacity bought per provisioner (``capacity_row``)."""
    R = st.R
    usage = np.zeros((P, R), dtype=np.float64)
    index = {name: i for i, name in enumerate(st.prov_names)}
    for n in nodes:
        pi = index.get(n.provisioner)
        if pi is not None:
            usage[pi] += st.capacity_row(n.instance_type, n.allocatable)
    return usage


def _limit_violation(usage: np.ndarray, limits: np.ndarray) -> np.ndarray:
    """[P] worst usage/limit ratio over FINITE limit resources (1.0 = at
    the limit; the 3.0e38 padding sentinel counts as unlimited)."""
    finite = limits < 1e37
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(finite, usage / np.maximum(limits, 1e-9), 0.0)
    return ratio.max(axis=1) if ratio.size else np.zeros(usage.shape[0])


def price_adjusted(cand_price: np.ndarray, cand_prov: np.ndarray,
                   lam: np.ndarray) -> np.ndarray:
    """Candidate prices under duals ``lam[P]``: multiply by ``exp(lam)`` of
    the owning provisioner, leaving the 3.0e38/inf no-offering sentinels
    alone.  ``cand_price`` is the solver's ``[C, D]`` layout (or any array
    whose leading axis is candidates)."""
    base = np.asarray(cand_price, dtype=np.float32)
    m = np.exp(lam).astype(np.float32)[np.asarray(cand_prov)]
    m = m.reshape(m.shape + (1,) * (base.ndim - 1))
    with np.errstate(over="ignore"):  # sentinel rows overflow, then drop
        return np.where(base >= 1e37, base, base * m).astype(np.float32)


#: a block tail node below this peak-resource fill is a candidate for the
#: cross-block repack — fuller nodes have nothing left to merge
_TAIL_FILL = 0.9


def _node_fill(n: SimNode) -> float:
    """Peak fill fraction across resources (1.0 = some resource full)."""
    fill = 0.0
    alloc = n.allocatable
    for k, v in n.used().items():
        cap = alloc.get(k, 0.0)
        if cap > 0.0:
            fill = max(fill, v / cap)
    return fill


# ---------------------------------------------------------------------------
# the hierarchical solve
# ---------------------------------------------------------------------------


def _record(registry, path: str) -> None:
    registry.counter(HIER_SOLVES).inc({"path": path})


def solve_hierarchical(
    scheduler,
    pods,
    provisioners,
    instance_types,
    daemonsets=(),
    unavailable=None,
    trace=None,
    registry: Optional[Registry] = None,
    stats: Optional[dict] = None,
) -> Optional[SolveResult]:
    """Partition -> one-dispatch block waves -> price ascent -> repair.
    Returns ``None`` when the batch is one coupled component (flat is the
    right program; the scheduler falls through).  ``stats``, when given,
    receives per-stage timings and dispatch counts.

    Repair re-seats stragglers through ``scheduler._solve_once``; the depth
    counter pins every nested solve to the flat path."""
    scheduler._hier_depth = getattr(scheduler, "_hier_depth", 0) + 1
    try:
        return _solve_hierarchical(
            scheduler, pods, provisioners, instance_types,
            daemonsets=daemonsets, unavailable=unavailable, trace=trace,
            registry=registry, stats=stats,
        )
    finally:
        scheduler._hier_depth -= 1


def _solve_hierarchical(
    scheduler,
    pods,
    provisioners,
    instance_types,
    daemonsets=(),
    unavailable=None,
    trace=None,
    registry: Optional[Registry] = None,
    stats: Optional[dict] = None,
) -> Optional[SolveResult]:
    from .relax import mirror_eta
    from .tpu import MEGA_MAX_SLOTS, max_mega_slots

    t0 = time.perf_counter()
    registry = registry or scheduler.registry
    zero_init_hier_metrics(registry)
    trace = trace or NULL_TRACE
    st_out = stats if stats is not None else {}

    st, tensorize_s = scheduler._tensorize(
        pods, provisioners, instance_types, daemonsets, unavailable,
        trace=trace,
    )
    t_part0 = time.perf_counter()
    with trace.span("hier.partition"):
        comps = coupling_components(st)
        # a meshed scheduler's block waves are slot-sharded megabatches: at
        # most as many blocks as the mesh's sharded rung ladder holds
        mesh = scheduler.mesh
        max_blocks = (MEGA_MAX_SLOTS if mesh is None
                      else max_mega_slots(mesh))
        masks = (partition_blocks(st, comps, max_blocks)
                 if len(comps) >= 2 and max_blocks >= 2 else [])
        if len(masks) < 2:
            _record(registry, "fallback_structure")
            return None
        budgets = block_budgets(st, masks)
    partition_ms = (time.perf_counter() - t_part0) * 1000.0

    # ---- entries ---------------------------------------------------------
    t_ent0 = time.perf_counter()
    solver = scheduler._tpu
    with trace.span("hier.entries"):
        dims = hier_dims(st, max(budgets))
        entries, base = build_block_entries(
            solver, st, masks, budgets, dims, trace=trace)
    entries_ms = (time.perf_counter() - t_ent0) * 1000.0

    # ---- block waves ----------------------------------------------------
    # each wave runs under the hang guard with its share of the deadline
    guard = getattr(scheduler, "_guard", None)
    price_budget = hier_price_iters()
    wave_frac = 1.0 / (1.0 + price_budget)
    dispatches = 0
    wave_ms: List[float] = []
    score_ms: List[float] = []

    # meshed waves pad to the first wave's slot rung and shard its slot
    # axis over the mesh (one block of blocks per mesh entry)
    mesh_kw = ({} if mesh is None
               else dict(min_slots=len(masks), mesh=mesh, registry=registry))

    def bound(*args, **kwargs):
        # the guard's call thread stamps its collections on the trace
        with gc_spans(trace):
            return solver.solve_many_prepared(*args, **kwargs)

    def wave(wave_entries):
        nonlocal dispatches
        tw = time.perf_counter()
        with trace.span("hier.wave", blocks=len(wave_entries)):
            if guard is not None and guard.enabled:
                outs = guard.run_budgeted(bound, wave_entries,
                                          budget_frac=wave_frac, trace=trace,
                                          **mesh_kw)
            else:
                outs = solver.solve_many_prepared(wave_entries, trace=trace,
                                                  **mesh_kw)
        dispatches += 1
        wave_ms.append((time.perf_counter() - tw) * 1000.0)
        for o in outs:
            if isinstance(o, Exception):
                raise o
        return outs

    from .guard import DeviceHang

    P = len(st.prov_names)
    limits = np.asarray(st.prov_limits, dtype=np.float64)
    iters_run = 0
    dev = solver.device
    lam = np.zeros(P, dtype=np.float64)
    step: Optional[ScoreStep] = None
    score_setup_ms = 0.0
    try:
        outs = wave(entries)

        # ---- price ascent (fixed budget, mirror-descent schedule) ------
        # ktlint: allow[KT020] price waves are sequentially dependent —
        # each dual update needs the PREVIOUS wave's usage; every wave is
        # still ONE batched dispatch over all contending blocks
        for t in range(price_budget):
            with trace.span("hier.price"):
                usage = np.zeros((len(masks), P, st.R), dtype=np.float64)
                for bi, out in enumerate(outs):
                    usage[bi] = _prov_usage(st, out.result.nodes, P)
                v = _limit_violation(usage.sum(axis=0), limits)
                hot = v > 1.0 + 1e-6
                if not hot.any():
                    break
                iters_run += 1
                eta = float(mirror_eta(np.float32(t)))
                lam = np.minimum(np.where(hot, lam + eta * (v - 1.0),
                                          lam * 0.5), 8.0)
                want_hot = np.zeros(st.G, dtype=bool)
                if st.C:
                    # packed hot path: which provisioner each group would
                    # buy NOW, under the adjusted prices — one fused launch
                    # on resident feasibility / base prices / owners (the
                    # card builds the adjusted bf16 price row), exp(lam)
                    # up, one buffer back
                    if step is None:
                        tsu = time.perf_counter()
                        step = ScoreStep(*score_inputs(st, base), P, dev)
                        score_setup_ms = (time.perf_counter() - tsu) * 1000.0
                    ts = time.perf_counter()
                    _cost, best = step(lam)
                    score_ms.append((time.perf_counter() - ts) * 1000.0)
                    prov_of_best = np.asarray(st.cand_prov)[best]
                    want_hot = hot[prov_of_best] & (_cost < 1e37)
                contending = [
                    bi for bi in range(len(masks))
                    if usage[bi][hot].any() or want_hot[masks[bi]].any()
                ]
                if not contending:
                    break
                # the re-solve takes the PADDED adjusted prices (3.0e38
                # rows stay)
                adj_padded = price_adjusted(base[0]["cand_price"],
                                            base[0]["cand_prov"], lam)
            with trace.span("hier.entries"):
                sub_entries, _ = build_block_entries(
                    solver, st, [masks[bi] for bi in contending],
                    [budgets[bi] for bi in contending], dims, base=base,
                    cand_price=adj_padded, trace=trace,
                )
            sub_outs = wave(sub_entries)
            for bi, out in zip(contending, sub_outs):
                outs[bi] = out
    except DeviceHang:
        logger.warning("hierarchical block wave hit the hang guard; "
                       "flat degradation ladder serves this batch")
        _record(registry, "fallback_degraded")
        return None

    # ---- merge + exact limit enforcement --------------------------------
    t_rep0 = time.perf_counter()
    with trace.span("hier.merge"):
        member_names: List[set] = []
        for mask in masks:
            names = set()
            for gi in np.nonzero(mask)[0]:
                names.update(p.name for p in st.groups[gi].pods)
            member_names.append(names)

        nodes: List[SimNode] = []
        assignments: Dict[str, str] = {}
        straggler_names: set = set()
        block_of: Dict[str, int] = {}  # node name -> owning block
        for bi, out in enumerate(outs):
            res = out.result
            members = member_names[bi]
            nodes.extend(res.nodes)
            for n in res.nodes:
                block_of[n.name] = bi
            for pn, nn in res.assignments.items():
                if pn in members:
                    assignments[pn] = nn
            # a block's extract reports its member groups' pods only
            straggler_names.update(pn for pn in res.infeasible
                                   if pn in members)

        # exact limit enforcement: evict the dearest nodes of an over-limit
        # provisioner until it fits; their pods join the stragglers
        usage_all = _prov_usage(st, nodes, P)
        v = _limit_violation(usage_all, limits)
        evicted: List[SimNode] = []
        for pi in np.nonzero(v > 1.0 + 1e-6)[0]:
            prov = st.prov_names[pi]
            mine = sorted((n for n in nodes if n.provisioner == prov),
                          key=lambda n: (-n.price, n.name))
            for n in mine:
                if _limit_violation(usage_all[pi:pi + 1],
                                    limits[pi:pi + 1])[0] <= 1.0 + 1e-6:
                    break
                usage_all[pi] -= st.capacity_row(n.instance_type,
                                                 n.allocatable)
                evicted.append(n)
        if evicted:
            gone = {id(n) for n in evicted}
            nodes = [n for n in nodes if id(n) not in gone]
            for n in evicted:
                straggler_names.update(p.name for p in n.pods)
            assignments = {pn: nn for pn, nn in assignments.items()
                           if pn not in straggler_names}

        pods_by_name = {p.name: p for p in pods}
        stragglers = [pods_by_name[pn] for pn in sorted(straggler_names)
                      if pn in pods_by_name]
        n_repair = len(stragglers)
        infeasible: Dict[str, str] = {}

    def _repair_solve(rp, existing, unav):
        return scheduler._solve_once(
            list(rp), provisioners, instance_types, list(existing),
            daemonsets, unav, True, None, trace=trace,
        )

    # ---- warm-start repair of the stragglers ----------------------------
    with trace.span("hier.repair", pods=n_repair):
        if stragglers:
            from .warmstart import delta_solve

            merged = SolveResult(nodes=nodes, assignments=assignments,
                                 infeasible={}, existing_nodes=[])
            outcome = delta_solve(
                merged, added=stragglers,
                solve_displaced=_repair_solve, solve_full=_repair_solve,
                registry=registry, unavailable=unavailable,
            )
            repaired = outcome.result
            nodes = list(repaired.existing_nodes) + list(repaired.nodes)
            assignments = dict(repaired.assignments)
            infeasible = dict(repaired.infeasible)

    # ---- cross-block tail consolidation ---------------------------------
    # evict each block's least-filled node (under _TAIL_FILL peak fill),
    # re-seat those pods jointly through the same warm-start path, and ship
    # the cheaper of before/after; delta_solve mutates its inputs, so the
    # candidate runs against copies of the kept nodes
    n_tail = 0
    with trace.span("hier.tail"):
        if len(masks) > 1 and nodes:
            tails: List[SimNode] = []
            by_block: Dict[int, List[SimNode]] = {}
            for n in nodes:
                bi = block_of.get(n.name)
                if bi is not None and n.pods:
                    by_block.setdefault(bi, []).append(n)
            for mine in by_block.values():
                cand = min(mine, key=_node_fill)
                if _node_fill(cand) < _TAIL_FILL:
                    tails.append(cand)
            # only tails that could actually co-reside merge: a tail whose
            # zone no OTHER block's tail shares has nothing to merge with
            zone_counts: Dict[str, int] = {}
            for n in tails:
                zone_counts[n.zone] = zone_counts.get(n.zone, 0) + 1
            tails = [n for n in tails if zone_counts[n.zone] > 1]
            tail_pods = [pods_by_name[p.name] for n in tails for p in n.pods
                         if p.name in pods_by_name]
            if len(tails) > 1 and tail_pods:
                from dataclasses import replace

                from .warmstart import delta_solve

                gone = {n.name for n in tails}
                kept = [replace(n, pods=list(n.pods),
                                allocatable=dict(n.allocatable))
                        for n in nodes if n.name not in gone]
                alt = SolveResult(
                    nodes=kept,
                    assignments={pn: nn for pn, nn in assignments.items()
                                 if nn not in gone},
                    infeasible={}, existing_nodes=[])
                outcome = delta_solve(
                    alt, added=tail_pods,
                    solve_displaced=_repair_solve, solve_full=_repair_solve,
                    registry=registry, unavailable=unavailable,
                )
                r2 = outcome.result
                nodes2 = list(r2.existing_nodes) + list(r2.nodes)
                if (not r2.infeasible
                        and sum(n.price for n in nodes2)
                        < sum(n.price for n in nodes) - 1e-9):
                    n_tail = len(tail_pods)
                    nodes = nodes2
                    assignments = dict(r2.assignments)
    repair_ms = (time.perf_counter() - t_rep0) * 1000.0

    elapsed_ms = (time.perf_counter() - t0) * 1000.0
    registry.histogram(HIER_BLOCKS).observe(float(len(masks)))
    registry.histogram(HIER_PRICE_ITERATIONS).observe(float(iters_run))
    registry.histogram(HIER_REPAIR_PODS).observe(float(n_repair))
    registry.histogram(HIER_DURATION).observe(elapsed_ms / 1000.0)
    _record(registry, "hierarchical")
    trace.annotate(hier_blocks=len(masks), hier_price_iters=iters_run,
                   hier_repair_pods=n_repair)
    st_out.update(
        blocks=len(masks), components=len(comps), waves=1 + iters_run,
        price_iters=iters_run, dispatches=dispatches,
        repair_pods=n_repair, tail_repack_pods=n_tail,
        tensorize_ms=tensorize_s * 1000.0,
        partition_ms=partition_ms, entries_ms=entries_ms,
        wave_ms=wave_ms, score_ms=score_ms, score_setup_ms=score_setup_ms,
        price_lam=lam.tolist(),
        repair_ms=repair_ms, total_ms=elapsed_ms,
        n_pods=len(pods),
    )
    logger.info(
        "hierarchical solve: %d pods, %d components -> %d blocks, "
        "%d price wave(s), %d repaired, %.1f ms",
        len(pods), len(comps), len(masks), iters_run, n_repair, elapsed_ms,
    )
    return SolveResult(
        nodes=nodes, assignments=assignments, infeasible=infeasible,
        existing_nodes=[], solve_ms=elapsed_ms,
        tensorize_ms=tensorize_s * 1000.0,
    )


# ---------------------------------------------------------------------------
# scale model
# ---------------------------------------------------------------------------


def scale_model(measured: dict, n_pods: int) -> dict:
    """Project the hierarchical wall at ``n_pods`` from one measured run —
    pure host math, the reference's model with one difference: the device
    per-pod rate ``measured['device_per_pod_us']`` is required (a missing
    one raises ``KeyError``).  The reference falls back to a 50k-pods-in-
    24-ms constant taken from a JAX-on-CPU run; the port projects only from
    a rate measured on its own device.

    Stage scaling: partition/entry build and repair are host-linear in the
    pod count; a block wave is ONE batched dispatch whose per-slot scan
    state is the block's share ``n_pods / blocks``, so device wave time
    scales with the BLOCK size, not the batch."""
    n0 = max(1, int(measured.get("n_pods", 1)))
    blocks = max(1, int(measured.get("blocks", 1)))
    waves = max(1, int(measured.get("waves", 1)))
    s = n_pods / n0
    host_ms = (float(measured.get("partition_ms", 0.0))
               + float(measured.get("entries_ms", 0.0))) * s
    per_pod_us = float(measured["device_per_pod_us"])
    dispatch_ms = float(measured.get("dispatch_overhead_ms", 2.0))
    wave_ms = per_pod_us * (n_pods / blocks) / 1000.0 + dispatch_ms
    repair_ms = float(measured.get("repair_ms", 0.0)) * s
    total = host_ms + waves * wave_ms + repair_ms
    return {
        "n_pods": int(n_pods), "blocks": blocks, "waves": waves,
        "host_ms": round(host_ms, 2), "wave_ms": round(wave_ms, 2),
        "repair_ms": round(repair_ms, 2), "total_ms": round(total, 2),
    }
