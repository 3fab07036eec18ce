"""Device batch solver — vectorized FFD bin-packing as a PyTorch program.

The port of the reference package's ``solver/tpu.py``: karpenter-core's
first-fit-decreasing loop re-expressed as dense tensor math over
(pod groups x node candidates x topology domains).

- **Feasibility is tensor algebra.**  ``F[g, c] = label_ok & fit_ok &
  prov_ok`` from packed-bitmask gathers (or one bf16 matmul at large G) and
  broadcast resource compares; zone/capacity-type feasibility joins per
  domain.
- **The pack is a loop over pod *groups*, not pods.**  Identical pods
  collapse into one step; within a step every placement decision is
  closed-form vector math over node slots (prefix-sum first fit, integer
  water-fill over zones, lexicographic argmin over (candidate x domain)).
- **Node state is slot-per-node**, existing nodes first, then creation
  order, so "first fit in creation order" is array order.
- **Every solve is a megabatch.**  The step carries a leading request-slot
  axis ``B`` from the start (the reference vmaps the same step); a solo
  solve is one slot.  The reference's ``lax.cond`` sites become a select
  between both branches per slot; a branch is skipped outright when no
  slot can take it — that is decided from the constant group tensors on
  the host, so the loop needs no device-to-host read per step.

``lax.scan`` over groups is a Python loop over groups; ``.at[...]``
scatters become masked selects, ``scatter_reduce`` for max/min, and an
in-order (``cumsum``) one-hot sum where the reference adds floats per zone.

Serving entry points (the reference's names): ``solve_async`` and
``solve_many_async`` split a dispatch into an enqueue half (uploads,
feasibility, the group loop) and a read-back half (the pending handles),
megabatch flushes pad the slot axis to ``_mega_rung`` with copies of
request 0, bucket keys come from ``signature`` / ``mega_signature``, and
``solve_delta`` runs the warm-start chain.  Eager PyTorch compiles
nothing, so the warm API keeps the reference's meaning without the stall:
a signature is ``ready`` once this process has run it, a warm runs it on a
background thread, and a cold signature is served on the device.

On the card the group loop of a recurring signature is replayed from a
CUDA graph (``scan_graphs.py``): the loop runs eagerly the first time its
signature is seen, is captured once its eager runs have cost what a
capture costs, and is replayed after, one graph launch in place of tens
of thousands of operations issued from Python.  Host tensors always run
the loop eagerly.

The fault plane (``faults``, ``KT_FAULTS``) fires at the reference's two
choke points: ``dispatch`` before every enqueue (``_enqueue_entries``) and
``fence`` before every device-to-host read (``_read_back``; a
``slow_fence`` effect is slept there).  Unset, the plane is falsy and
costs one bool check.

The mesh (parallel/mesh.py): a meshed solve pads G and C (and NR) to the
mesh's axis divisors like the reference and computes feasibility block by
block, each (pods, types) block of ``F`` and of ``dom_ok`` on its own mesh
device, assembled on the device of the scan.  The scan itself runs
replicated on that device: the reference also shards the scan's node-slot
axis, which in eager PyTorch would put collectives inside a group loop
that already makes thousands of launches per step — sharding is a layout,
not a semantic, and the plans are the reference's.  A meshed megabatch
splits the padded slot axis into one contiguous block per mesh entry
(``slot_mesh``), each device's run of entries enqueued as one block on its
own stream (so virtual shards of one card cost one group loop, while k
cards cost k group loops issued from one thread); in a multi-process job
a rank enqueues and reads back only the blocks it owns (the per-host
fence) and types the others :class:`SlotNotOwned`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import faults as faults_mod
from ..device import resolve_device
from ..models import labels as L
from ..models.tensorize import SolveTensors
from ..obs.trace import NULL_TRACE
from ..ops.masks import (
    BIG,
    gather_pm_bits,
    lex_argmin,
    prefix_allocate,
    skew_band_fill,
    water_fill,
)
from ..utils.clock import Clock
from .scan_graphs import ScanGraphs, scan_key
from .types import SimNode, SolveResult

BIGN = float(np.float32(1e9))  # "unbounded" node/pod counts

#: megabatch request-slot cap: one dispatch solves at most this many
#: independent solve requests
MEGA_MAX_SLOTS = 32


def _mesh_divs(mesh) -> Tuple[int, int]:
    """The (pods, types) axis divisors a meshed solve pads G / NR and C to."""
    if mesh is None:
        return 1, 1
    from ..parallel.mesh import POD_AXIS, TYPE_AXIS

    return mesh.shape[POD_AXIS], mesh.shape[TYPE_AXIS]


def _mega_rung(n: int, n_dev: int = 1) -> int:
    """Pad the request-slot axis to a power-of-two rung (1, 2, 4, ..., 32):
    bucket keys, ``MEGABATCH_SLOTS`` and the padding-isolation contract
    stay the reference's.  ``n_dev`` > 1 is the sharded megabatch: the
    ladder floors at the mesh's entry count and doubles from there, so the
    slot axis always divides evenly over the entries, and never passes
    MEGA_MAX_SLOTS (24 entries -> {24}; 6 -> {6, 12, 24})."""
    r = max(1, n_dev)
    while r < min(max(1, n), MEGA_MAX_SLOTS) and r * 2 <= MEGA_MAX_SLOTS:
        r *= 2
    return r


def _mesh_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.devices.size)


def mesh_shardable(mesh) -> bool:
    """True when the megabatch slot axis can shard over ``mesh``: the entry
    count must fit inside the slot-rung ladder (a 64-entry mesh cannot pad
    a <= 32-slot batch to one block per entry — such schedulers keep the
    sharded single solve and count mesh_serial flushes)."""
    return _mesh_size(mesh) <= MEGA_MAX_SLOTS


def max_mega_slots(mesh) -> int:
    """Largest megabatch flush this mesh can serve on the sharded rung
    ladder (MEGA_MAX_SLOTS when unmeshed or the entries divide it evenly;
    smaller for awkward counts — 24 entries cap flushes at 24), or 0 for an
    unshardable mesh."""
    if not mesh_shardable(mesh):
        return 0
    return _mega_rung(MEGA_MAX_SLOTS, _mesh_size(mesh))


def _mega_key_tail(slots: int, zone_key: int, ct_key: int, mesh) -> tuple:
    """The megabatch bucket-key suffix: slot rung + zone/ct vocab positions
    (+ the mesh fingerprint when sharded).  The single source of this
    format — ``mega_signature`` and ``_dispatch_prepared`` both append
    exactly this."""
    tail = (
        ("mega_slots", _mega_rung(slots, _mesh_size(mesh))),
        ("zk", zone_key),
        ("ck", ct_key),
    )
    if mesh is not None:
        from ..parallel.mesh import mesh_signature

        tail += (("mesh", mesh_signature(mesh)),)
    return tail


#: the megabatch bucket-key components that are PADDED axis rungs — two
#: buckets differing only here can share one dispatch when one dominates
UNIFIABLE_DIMS = ("G", "C", "NR", "NE_pad", "S", "P")
#: the non-dims tail components ``_mega_key_tail`` appends (plus the mesh
#: fingerprint it conditionally adds)
_MEGA_TAIL_NAMES = tuple(
    k for k, _ in _mega_key_tail(1, 0, 0, None)) + ("mesh",)


def unify_mega_keys(a: tuple, b: tuple) -> Optional[tuple]:
    """The DOMINANT of two megabatch bucket keys when one subsumes the
    other, else None: a flush holding bucket A can admit a bucket-B request
    iff every axis rung of one key >= the other's and everything else
    (vocab key positions, track, slot rung) matches exactly; the dominated
    requests then build their tensors at the dominant dims
    (``solve_many_async(target_dims=...)``)."""
    if a == b:
        return a
    da, db = dict(a), dict(b)
    if set(da) != set(db):
        return None
    a_dom = b_dom = True
    for k, va in da.items():
        vb = db[k]
        if va == vb:
            continue
        if k not in UNIFIABLE_DIMS:
            return None
        if va < vb:
            a_dom = False
        else:
            b_dom = False
    if a_dom:
        return a
    if b_dom:
        return b
    return None


def mega_key_dims(key: tuple) -> dict:
    """The solve_dims dict embedded in a megabatch bucket key (everything
    but the ``_mega_key_tail`` components)."""
    return {k: v for k, v in dict(key).items() if k not in _MEGA_TAIL_NAMES}


def mega_key_at_slots(key: tuple, slots: int, mesh) -> tuple:
    """Re-key a slots=1 megabatch bucket key at a real flush size: the
    dims part stays, the tail is re-derived for ``slots``."""
    d = dict(key)
    dims_part = tuple(sorted(
        (k, v) for k, v in d.items() if k not in _MEGA_TAIL_NAMES))
    return dims_part + _mega_key_tail(slots, d["zk"], d["ck"], mesh)


def multihost_fence_enabled() -> bool:
    """Per-host megabatch fences (read back only the slot blocks this rank
    owns) — default on; ``KT_MULTIHOST=0`` forces the whole-batch read."""
    import os

    return os.environ.get("KT_MULTIHOST", "1") != "0"


# ktlint: fence the per-host fence's one accessor: a megabatch's
# device-to-host read of the slots this rank owns
def read_slot_rows(arrays, *, local_only: bool = False):
    """Read back the leading (request-slot) axis of stacked megabatch
    arrays — the one accessor of the per-host fence.  Each array is a
    tensor or a :class:`~karpenter_tpu_torch.parallel.mesh.ShardedArray`.

    ``local_only`` reads ONLY this rank's shards of a sharded array (each
    on the stream that produced it); otherwise one whole-array read per
    array, gathering foreign shards from their ranks.  Returns ``(rows,
    bytes_read, bytes_total)`` where ``rows[k][s]`` is slot ``s`` of array
    ``k`` — only locally owned slots are present under ``local_only`` in a
    multi-process job."""
    from ..parallel.mesh import ShardedArray

    rows: List[dict] = []
    bytes_read = 0
    bytes_total = 0
    for arr in arrays:
        per: Dict[int, np.ndarray] = {}
        if isinstance(arr, ShardedArray):
            bytes_total += arr.nbytes
            if local_only:
                for shard in arr.addressable_shards:
                    with _on_stream(shard.stream):
                        data = shard.data.cpu().numpy()
                    start = shard.index[0].start or 0
                    for j in range(data.shape[0]):
                        per[start + j] = data[j]
                    bytes_read += int(data.nbytes)
                rows.append(per)
                continue
            from ..parallel.distributed import replicate_for_host

            a = replicate_for_host(None, arr)
        else:
            bytes_total += int(arr.numel() * arr.element_size())
            a = arr.cpu().numpy()
        for s in range(a.shape[0]):
            per[s] = a[s]
        bytes_read += int(a.nbytes)
        rows.append(per)
    return rows, bytes_read, bytes_total


def _rung(n: int, quantum: int, linear_max: int, ratio: float = 1.5,
          axis_div: int = 1) -> int:
    """Bucket ``n`` up to a small, stable rung ladder: linear multiples of
    ``quantum`` up to ``linear_max``, then a geometric x``ratio`` ladder
    (each rung rounded to the quantum).  ``axis_div`` keeps the rung
    divisible by a mesh axis."""
    q = max(quantum, axis_div)
    q = ((q + axis_div - 1) // axis_div) * axis_div

    def up(m: int) -> int:
        return max(((m + q - 1) // q) * q, axis_div)

    if n <= linear_max:
        return up(n)
    rung = up(linear_max)
    while rung < n:
        rung = up(int(rung * ratio))
    return rung


def _nr_estimate(st: SolveTensors, NE: int, node_budget: int) -> int:
    """Optimistic-but-padded node-slot count for the scan's NR axis: per
    group, the node count if packing hit the best resource-only
    pods-per-node any candidate offers, summed, doubled, plus slack.  When
    the estimate is genuinely short the solve detects slot exhaustion and
    retries once at the full budget (:meth:`TpuSolver.solve`)."""
    if node_budget <= 2048:  # min rung: estimate can't help
        return node_budget
    cache = getattr(st, "_nr_est_cache", None)
    key = (NE, node_budget)
    if cache is not None and cache[0] == key:
        return cache[1]
    req = np.asarray(st.requests, dtype=np.float32)      # [G, R]
    alloc = np.asarray(st.cand_alloc, dtype=np.float32)  # [C, R]
    if alloc.shape[0] == 0 or req.shape[0] == 0:
        return node_budget
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = np.floor(alloc[None, :, :] / np.maximum(req[:, None, :], 1e-9))
    ratios = np.where(req[:, None, :] > 1e-12, ratios, np.inf)  # [G, C, R]
    ppn = ratios.min(axis=2)                                    # [G, C]
    best = np.maximum(ppn.max(axis=1), 1.0)                     # [G]
    best = np.where(np.isfinite(best), best, 1.0)
    nodes = np.ceil(np.asarray(st.counts, dtype=np.float64) / best)
    est = NE + int(2.0 * nodes.sum()) + 128
    out = int(min(max(est, 1), node_budget))
    st._nr_est_cache = (key, out)
    return out


def solve_dims(st: SolveTensors, *, NE: int, node_budget: int,
               a: int = 1, b: int = 1, track: bool = True,
               full_nr: bool = False) -> dict:
    """The padded tensor dimensions of a solve of ``st`` against ``NE``
    existing nodes with ``node_budget`` max node slots — the same rung
    bucketing as the reference, so both packages pad a batch identically.
    ``a``/``b`` are the mesh's (pods, types) axis divisors (1 unmeshed);
    ``full_nr`` forces the worst-case NR axis (the slot-exhaustion
    retry)."""
    G_pad = _rung(st.G, 16, 128, axis_div=a)
    C_pad = _rung(max(1, st.C), 64, 512, axis_div=b)
    nr_slots = node_budget if full_nr else _nr_estimate(st, NE, node_budget)
    NR = _rung(max(1, nr_slots), 512, 2048, axis_div=a)
    NE_pad = _rung(max(1, NE), 16, 64)
    S_pad = _rung(st.S, 8, 32) if st.S else 0
    P_pad = _rung(max(1, len(st.prov_names)), 4, 8)
    K, W = st.pm.shape[1], st.pm.shape[2]
    return dict(
        G=G_pad, C=C_pad, NR=NR, NE_pad=NE_pad, S=S_pad, P=P_pad,
        D=st.D, R=st.R, Z=max(1, st.n_zones), K=K, W=W, track=bool(track),
        a=a, b=b,
    )


def _dims_key(dims: dict) -> tuple:
    return tuple(sorted(dims.items()))


# ---------------------------------------------------------------------------
# feasibility
# ---------------------------------------------------------------------------


def compute_feasibility(
    pm: torch.Tensor,          # [G, K, W] int64 (uint32 words)
    requests: torch.Tensor,    # [G, R]
    gp_ok: torch.Tensor,       # [G, P]
    cand_vw: torch.Tensor,     # [C, K]
    cand_vb: torch.Tensor,     # [C, K]
    cand_alloc: torch.Tensor,  # [C, R]
    cand_prov: torch.Tensor,   # [C]
    key_check: torch.Tensor,   # [K]
    dom_vw: torch.Tensor,      # [D, 2]
    dom_vb: torch.Tensor,      # [D, 2]
    zone_key: int,
    ct_key: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (F[G, C] candidate feasibility, dom_ok[G, D] zone&ct allowed)."""
    from ..ops.feasibility import (
        MATMUL_MIN_G,
        candidate_selector,
        label_feasibility_matmul,
    )

    G = pm.shape[0]

    def fit(req):  # [g, R] -> [g, C]
        return torch.all(
            (req[:, None, :] <= cand_alloc[None, :, :] + 1e-6)
            | (req[:, None, :] <= 0), dim=2)

    if G >= MATMUL_MIN_G:
        sel = candidate_selector(cand_vw, cand_vb, key_check, pm.shape[2])
        F = label_feasibility_matmul(pm, sel, key_check) & fit(requests)
    else:
        # chunked over groups: bounds the [chunk, C, K] gather intermediate
        outs = []
        for i in range(0, G, 512):
            bits = gather_pm_bits(pm[i:i + 512], cand_vw, cand_vb)  # [g, C, K]
            lab = torch.all(bits | ~key_check[None, None, :], dim=2)
            outs.append(lab & fit(requests[i:i + 512]))
        F = torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
    F = F & gp_ok[:, cand_prov.to(torch.int64)]

    # domain allowance from the zone / capacity-type keys of each group's mask
    def bit(key, col):
        words = pm[:, key, :][:, dom_vw[:, col].to(torch.int64)]    # [G, D]
        return ((words >> dom_vb[:, col].to(torch.int64)) & 1).to(torch.bool)

    dom_ok = bit(zone_key, 0) & bit(ct_key, 1)
    return F, dom_ok


# ---------------------------------------------------------------------------
# the scan: one step per pod group, batched over request slots
# ---------------------------------------------------------------------------


def _sel_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for x [B, N, ...], idx [B]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _sel_many(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, m]]`` for x [B, N, ...], idx [B, M] -> [B, M, ...]."""
    ar = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[ar, idx]


def _col(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, :, idx[b]]`` for x [B, N, S], idx [B] -> [B, N]."""
    B, N = x.shape[0], x.shape[1]
    return torch.gather(x, 2, idx.view(B, 1, 1).expand(B, N, 1)).squeeze(2)


def _zone_sum(vals: torch.Tensor, zone1h: torch.Tensor) -> torch.Tensor:
    """Per-zone sum of ``vals`` [B, N] over one-hot ``zone1h`` [B, N, Z], in
    slot order (the reference's scatter-add adds updates in index order; a
    running sum keeps that association on the host)."""
    masked = torch.where(zone1h, vals[..., None], 0.0)
    return torch.cumsum(masked, dim=1)[:, -1]


def _select(cond: torch.Tensor, a, b):
    """Per-slot select between two tuples of [B, ...] tensors."""
    out = []
    for x, y in zip(a, b):
        c = cond.view(cond.shape[0], *([1] * (x.dim() - 1)))
        out.append(torch.where(c, x, y))
    return tuple(out)


def _run_scan(consts: dict, init: tuple, NR: int, Z: int, track: bool,
              flags: dict, trace=NULL_TRACE):
    """Run every group step over all slots.  ``consts`` and ``init`` are
    [B, ...] tensors; ``flags`` holds host booleans per group (``zoned_any``,
    ``zoned_all``, ``zpa_any``, ``hpa_any``) that let a step skip a branch
    no slot takes.  Returns (carry, ys[B, G, NR] int32 or None).

    ``trace`` gets a span around each contiguous part of a step, so the
    host time that makes a step's launches is named by the code making
    them: ``step.rows`` (per-slot feasibility, affinity modes, backfill
    state), ``step.caps`` (zone-level caps, new-node scoring),
    ``step.seed`` (the zone-seed and host-seed flows, where taken),
    ``step.alloc`` (the zone allocation, holding a ``step.fill`` per
    ``skew_band_fill`` / ``water_fill`` call), ``step.place`` (the
    creation rounds, holding a ``step.pick`` per ``pick`` and a
    ``step.write`` per ``write_block``) and ``step.count`` (the
    counters).  A fixed number of spans per step, none per kernel."""
    counts = consts["counts"]          # [B, G]
    suffix_res = consts["suffix_res"]  # [B, G, Z, R]
    suffix_cnt = consts["suffix_cnt"]  # [B, G, Z]
    requests = consts["requests"]      # [B, G, R]
    F = consts["F"]                    # [B, G, C]
    dom_ok = consts["dom_ok"]          # [B, G, D]
    g_zone_spread = consts["g_zone_spread"]
    g_zone_skew = consts["g_zone_skew"]
    g_host_spread = consts["g_host_spread"]
    g_host_cap = consts["g_host_cap"]
    g_zone_anti = consts["g_zone_anti"]
    g_zone_paff = consts["g_zone_paff"]
    g_host_paff = consts["g_host_paff"]
    g_sel_match = consts["g_sel_match"]  # [B, S, G]
    cand_alloc = consts["cand_alloc"]  # [B, C, R]
    cand_cap = consts["cand_cap"]      # [B, C, R]
    cand_prov = consts["cand_prov"]    # [B, C]
    cand_price = consts["cand_price"]  # [B, C, D]
    cand_avail = consts["cand_avail"]  # [B, C, D]
    prov_limits = consts["prov_limits"]  # [B, P, R]
    dom_zone = consts["dom_zone"]      # [B, D]
    ex_ok = consts["ex_ok"]            # [B, G, NE_pad]
    node_budget = consts["node_budget"]  # [B] semantic max_nodes cap

    dev = counts.device
    B, G = counts.shape
    C, D = cand_price.shape[1], cand_price.shape[2]
    R = requests.shape[2]
    P = prov_limits.shape[1]
    NE_pad = ex_ok.shape[2]
    ar = torch.arange(B, device=dev)
    slot_idx = torch.arange(NR, device=dev)
    slot_f = slot_idx.to(torch.float32)
    zone_ar = torch.arange(Z, device=dev)
    zone_f = zone_ar.to(torch.float32)
    ex_slot = torch.clamp(slot_idx, max=NE_pad - 1)
    ci_key = torch.arange(C, device=dev, dtype=torch.float32)[:, None].expand(C, D)
    di_key = torch.arange(D, device=dev, dtype=torch.float32)[None, :].expand(C, D)
    cd_key = (ci_key * D + di_key).expand(B, C, D)
    prov_c = cand_prov[..., None].expand(B, C, R)
    lim_c = torch.gather(prov_limits, 1, prov_c)                 # [B, C, R]
    dz1h = dom_zone[..., None] == zone_ar                         # [B, D, Z]
    prov1h = cand_prov[..., None] == torch.arange(P, device=dev)  # [B, C, P]
    budget_nr = torch.clamp(node_budget, max=NR)                  # [B]
    cap_nodes_f = torch.clamp(cand_cap, min=1e-9)

    def per_zone_max(x_bd: torch.Tensor) -> torch.Tensor:
        """``zeros(Z).at[dom_zone].max(x)`` for bool x [B, D]."""
        return torch.any(dz1h & x_bd[..., None], dim=1)

    def step(carry, g: int):
        (res, row_zone, row_dom, row_cand, row_price, selcnt, active,
         n_used, zc, tot, prov_used, infeasible) = carry

        with trace.span("step.rows"):
            req_g = requests[:, g]                     # [B, R]
            cnt = counts[:, g].to(torch.float32)       # [B]
            Fg = F[:, g]                               # [B, C]
            dok = dom_ok[:, g]                         # [B, D]
            Fd_g = Fg[:, :, None] & cand_avail & dok[:, None, :]    # [B, C, D]
            zone_safe = torch.clamp(row_zone, min=0)
            zone1h = row_zone[..., None] == zone_ar                # [B, NR, Z]
            zone1h_safe = zone_safe[..., None] == zone_ar

            # ---- per-slot feasibility & capacity -------------------------
            safe_cand = torch.clamp(row_cand, min=0)
            safe_dom = torch.clamp(row_dom, min=0)
            rf_cand = Fd_g[ar[:, None], safe_cand, safe_dom]          # [B, NR]
            exv = ex_ok[:, g][:, ex_slot]
            rf = active & torch.where(row_cand >= 0, rf_cand, exv)

            # ---- positive pod-affinity modes A/B/C -----------------------
            zpa = g_zone_paff[:, g]
            zpa_on = zpa >= 0
            zpa_i = torch.clamp(zpa, min=0)
            ztot = _sel_rows(tot, zpa_i) > 0
            zself = g_sel_match[ar, zpa_i, g]
            zone_seed = zpa_on & ~ztot & zself
            zdead = zpa_on & ~ztot & ~zself

            hpa = g_host_paff[:, g]
            hpa_on = hpa >= 0
            hpa_i = torch.clamp(hpa, min=0)
            htot = _sel_rows(tot, hpa_i) > 0
            hhave = _col(selcnt, hpa_i) > 0                           # [B, NR]
            hself = g_sel_match[ar, hpa_i, g]
            host_seed = hpa_on & ~htot & hself
            host_gated = hpa_on & htot
            hdead = hpa_on & ~htot & ~hself

            rf = (rf & (~host_gated[:, None] | hhave)
                  & ~hdead[:, None] & ~zdead[:, None])
            # an empty node never satisfies mode-A/C hostname affinity
            new_allowed = ~host_gated & ~hdead & ~zdead               # [B]

            # step-entry PER-ZONE net-backfill state for pick()
            sc_g = suffix_cnt[:, g]                                   # [B, Z]
            cnt_z_safe = torch.where(sc_g > 0, sc_g, 1.0)
            avg_req_z = suffix_res[:, g] / cnt_z_safe[..., None]    # [B, Z, R]
            row_avg = _sel_many(avg_req_z, zone_safe)              # [B, NR, R]
            per_row_absorb = torch.where(
                row_avg > 0,
                torch.clamp(res, min=0.0) / torch.clamp(row_avg, min=1e-9),
                BIGN,
            ).amin(dim=2)                                             # [B, NR]
            rows_absorb_z = _zone_sum(
                torch.where(active, per_row_absorb, 0.0), zone1h_safe)  # [B, Z]
            net_backfill_frac_z = torch.clamp(
                (sc_g - rows_absorb_z) / cnt_z_safe, 0.0, 1.0)       # [B, Z]
            req_pos = req_g > 0                                       # [B, R]
            req_safe = torch.clamp(req_g, min=1e-9)
            backfill_eq_z = torch.where(
                req_pos[:, None, :],
                suffix_res[:, g] / req_safe[:, None, :],
                BIGN,
            ).amin(dim=2)                                             # [B, Z]

            ratios = torch.where(
                req_pos[:, None, :],
                torch.floor((res + 1e-6) / req_safe[:, None, :]),
                BIGN)
            cap = ratios.amin(dim=2)                                  # [B, NR]

            sh = g_host_spread[:, g]
            hk = g_host_cap[:, g].to(torch.float32)
            selrow = _col(selcnt, torch.clamp(sh, min=0)).to(torch.float32)
            hcap = torch.where(hk[:, None] > 0, hk[:, None] - selrow,
                               torch.where(selrow > 0, 0.0, BIGN))
            cap = torch.where(sh[:, None] >= 0, torch.minimum(cap, hcap), cap)
            cap = torch.clamp(cap, min=0.0) * rf

        # ---- zone-level caps ------------------------------------------
        with trace.span("step.caps"):
            zsp = g_zone_spread[:, g]
            za = g_zone_anti[:, g]
            skew_g = g_zone_skew[:, g].to(torch.float32)

            el = per_zone_max(dok)                                    # [B, Z]
            zcpa = _sel_rows(zc, zpa_i) > 0                           # [B, Z]
            el = (el & (~(zpa_on & ztot)[:, None] | zcpa)
                  & ~zdead[:, None])
            za_i = torch.clamp(za, min=0)
            zc_an = _sel_rows(zc, za_i).to(torch.float32)             # [B, Z]
            self_match = g_sel_match[ar, za_i, g]
            anti_cap = torch.where(
                self_match[:, None], torch.clamp(1.0 - zc_an, min=0.0),
                torch.where(zc_an > 0, 0.0, BIGN))
            anti_cap = torch.where(za[:, None] >= 0, anti_cap, BIGN)  # [B, Z]

            rowcap_z = _zone_sum(torch.where(active, cap, 0.0), zone1h_safe)

            zc_sp = torch.where(
                zsp[:, None] >= 0, _sel_rows(zc, torch.clamp(zsp, min=0)),
                0).to(torch.float32)                                  # [B, Z]
            min_sp = torch.where(el, zc_sp, BIGN).amin(dim=1)         # [B]
            spread_cap = torch.where(
                zsp[:, None] >= 0, (skew_g + min_sp)[:, None] - zc_sp, BIGN)
            zone_budget = torch.minimum(anti_cap, torch.clamp(spread_cap, min=0.0))

            # ---- new-node candidate scoring ------------------------------
            nr_ratios = torch.where(
                req_pos[:, None, :],
                torch.floor((cand_alloc + 1e-6) / req_safe[:, None, :]),
                BIGN)
            ppn = nr_ratios.amin(dim=2)                               # [B, C]
            hcap_new = torch.where((sh >= 0) & (hk > 0), hk, BIGN)
            take_pn = torch.minimum(ppn, hcap_new[:, None])           # [B, C]
            take_ok = take_pn[..., None] >= 1.0

            def lim_ok_cur(prov_used_cur):
                used_c = torch.gather(prov_used_cur, 1, prov_c)
                return torch.all(used_c + cand_cap <= lim_c + 1e-6, dim=2)

            def head_nodes_cur(prov_used_cur):
                used_c = torch.gather(prov_used_cur, 1, prov_c)
                return torch.floor((lim_c - used_c + 1e-6) / cap_nodes_f).amin(dim=2)

            lim_ok = lim_ok_cur(prov_used)
            new_ok = (Fd_g & take_ok & lim_ok[..., None]
                      & new_allowed[:, None, None])                 # [B, C, D]
            new_ok_nolim = Fd_g & take_ok & new_allowed[:, None, None]
            bfz_d = torch.gather(backfill_eq_z, 1, dom_zone)          # [B, D]
            nbf_d = torch.gather(net_backfill_frac_z, 1, dom_zone)    # [B, D]

        def pick(rem, dom_mask, prov_used_cur, tail_rem=None,
                 size_tiebreak=True, pool_rem=None):
            """argmin over (C, D & dom_mask) of price / min(fill, rem),
            where fill is the backfill-aware effective pods-per-node;
            limit feasibility from the CURRENT provisioner usage."""
            with trace.span("step.pick"):
                ok_cd = (new_ok_nolim & lim_ok_cur(prov_used_cur)[..., None]
                         & dom_mask[:, None, :])
                head_nodes = head_nodes_cur(prov_used_cur)            # [B, C]
                est_rem = rem if pool_rem is None else pool_rem
                n_nodes_est = torch.clamp(
                    torch.minimum(est_rem[:, None] / torch.clamp(take_pn, min=1.0),
                                  torch.clamp(head_nodes, 0.0, BIGN)),
                    1.0, BIGN)                                        # [B, C]
                per_node_backfill = bfz_d[:, None, :] / n_nodes_est[..., None]
                fill = torch.minimum(ppn[..., None],
                                     take_pn[..., None] + per_node_backfill)
                denom = torch.clamp(
                    torch.minimum(fill, torch.clamp(rem, min=1.0)[:, None, None]),
                    min=1.0)
                pnb_net = per_node_backfill * nbf_d[:, None, :]
                if tail_rem is not None:
                    denom = torch.clamp(
                        torch.minimum(
                            denom,
                            torch.clamp(tail_rem, min=1.0)[:, None, None] + pnb_net),
                        min=1.0)
                score = torch.where(ok_cd, cand_price / denom, BIG)
                guard_rem = torch.clamp(rem if tail_rem is None else tail_rem,
                                        min=1.0)[:, None, None]
                if size_tiebreak:
                    full_take = torch.where(take_pn[..., None] <= guard_rem,
                                            take_pn[..., None], 0.0)
                else:
                    full_take = torch.zeros_like(score)
                size_key = torch.where(ok_cd, -full_take, BIG)
                pk = torch.where(ok_cd, cand_price, BIG)
                flat = lex_argmin(score, size_key, pk, cd_key, batch_dims=1)
                bc = torch.div(flat, D, rounding_mode="floor")
                bd = flat % D
                ok = score.reshape(B, -1)[ar, flat] < BIG
                return bc, bd, ok

        # ---- zone-seed (mode B): the whole group lands in ONE zone -----
        if flags["zpa_any"][g]:
            with trace.span("step.seed"):
                elb = el & (zone_budget >= 1.0)
                ok_slots0 = rf & (cap >= 1.0) & _sel_many(elb, zone_safe)
                has0 = torch.any(ok_slots0, dim=1)
                free_z = _zone_sum(torch.where(ok_slots0, cap, 0.0), zone1h_safe)
                budget_z = torch.where(elb, zone_budget, 0.0)
                place_z = torch.minimum(torch.minimum(free_z, budget_z), cnt[:, None])
                paid_z = torch.clamp(
                    torch.minimum(cnt[:, None], budget_z) - place_z, min=0.0)
                elb_d = torch.gather(elb, 1, dom_zone)                # [B, D]
                ok_cd0 = (new_ok_nolim & lim_ok_cur(prov_used)[..., None]
                          & elb_d[:, None, :])
                paid_d = torch.gather(paid_z, 1, dom_zone)
                ppp_cd = torch.where(
                    ok_cd0,
                    cand_price / torch.clamp(
                        torch.minimum(take_pn[..., None], paid_d[:, None, :]),
                        min=1.0),
                    BIG)
                ppp_d = ppp_cd.amin(dim=1)                            # [B, D]
                ppp_z = torch.where(dz1h, ppp_d[..., None], BIG).amin(dim=1)
                purch_z = torch.where(ppp_z < BIG, paid_z, 0.0)
                unplaced_z = torch.clamp(cnt[:, None] - place_z - purch_z, min=0.0)
                cost_z = torch.where(
                    elb, torch.clamp(purch_z * ppp_z, max=BIG), BIG)
                first_slot = torch.where(
                    ok_slots0[..., None] & zone1h, slot_f[None, :, None],
                    BIGN).amin(dim=1)                                 # [B, Z]
                z_best = lex_argmin(
                    torch.where(elb, unplaced_z, BIGN), cost_z, first_slot,
                    zone_f.expand(B, Z), batch_dims=1)
                _bc0, bd0, okp0 = pick(cnt, elb_d, prov_used)
                z_star = torch.where(
                    has0, z_best,
                    torch.where(okp0, _sel_rows(dom_zone, bd0), -1))
                z_star = torch.where(zone_seed, z_star, -1)
                el = torch.where(zone_seed[:, None],
                                 el & (zone_ar == z_star[:, None]), el)

        with trace.span("step.caps"):
            new_ok_z = per_zone_max(torch.any(new_ok, dim=1))         # [B, Z]
            cap_z = torch.minimum(rowcap_z + torch.where(new_ok_z, BIGN, 0.0),
                                  anti_cap)
            cap_z = torch.where(el, cap_z, 0.0)

        # ---- allocation: rows then new nodes ---------------------------
        def zoned_alloc():
            head_c = head_nodes_cur(prov_used)                    # [B, C]
            c_ok = torch.any(new_ok_nolim, dim=2)
            per_c = torch.where(
                c_ok, torch.clamp(head_c, 0.0, BIGN) * take_pn, 0.0)
            per_p = torch.zeros(B, P, device=dev).scatter_reduce(
                1, cand_prov, per_c, reduce="amax", include_self=True)
            fundable_new = torch.clamp(per_p.sum(dim=1), max=BIGN)
            rows_z = torch.where(el, rowcap_z, 0.0)
            skew_eff = torch.where(zsp >= 0, skew_g, BIGN)
            with trace.span("step.fill"):
                alloc0 = skew_band_fill(
                    zc_sp, rows_z, cap_z, cnt, skew_eff, el).to(torch.float32)
            need_new = torch.clamp(
                alloc0 - torch.minimum(rows_z, alloc0), min=0.0)
            with trace.span("step.fill"):
                funded_new = water_fill(
                    torch.zeros_like(need_new), need_new, fundable_new,
                    el & (need_new > 0)).to(torch.float32)
            cap_f = torch.where(
                el, torch.minimum(rows_z + funded_new, cap_z), 0.0)
            with trace.span("step.fill"):
                alloc1 = skew_band_fill(
                    zc_sp, torch.minimum(rows_z, cap_f), cap_f, cnt, skew_eff,
                    el).to(torch.float32)
            lvl_min = torch.where(el, zc_sp + alloc1, BIGN).amin(dim=1)
            skew_cap = torch.where(
                zsp[:, None] >= 0, (lvl_min + skew_g)[:, None] - zc_sp, BIGN)
            cap_z2 = torch.minimum(cap_f, torch.clamp(skew_cap, min=0.0))
            with trace.span("step.fill"):
                alloc_z = skew_band_fill(
                    zc_sp, torch.minimum(rows_z, cap_z2), cap_z2, cnt,
                    skew_eff, el).to(torch.float32)               # [B, Z]
            # per-zone prefix allocation over slots in creation order
            capz_slots = torch.where(zone1h, cap[..., None], 0.0)  # [B, NR, Z]
            before = torch.cumsum(capz_slots, dim=1) - capz_slots
            take_slots = torch.minimum(
                torch.clamp(alloc_z[:, None, :] - before, min=0.0), capz_slots)
            masked = torch.where(zone1h, take_slots, 0.0)
            take = masked.sum(dim=2)
            taken_z = masked.sum(dim=1)
            rem_z = torch.clamp(alloc_z - taken_z, min=0.0)
            return take, rem_z

        def simple_alloc():
            take = prefix_allocate(cap, cnt)
            rem = cnt - take.sum(dim=1)
            return take, torch.where(zone_ar == 0, rem[:, None], 0.0)

        state0 = (res, row_zone, row_dom, row_cand, row_price, active,
                  prov_used, torch.zeros(B, NR, device=dev), n_used)

        def write_block(state, n_nodes, per_node, last_extra, bc, bd):
            """Append n_nodes slots of candidate bc/domain bd; each takes
            per_node pods except the last which takes last_extra.  Returns
            (state, pods actually placed)."""
            with trace.span("step.write"):
                (res, row_zone, row_dom, row_cand, row_price, active, prov_used,
                 new_take, cursor) = state
                n_req = n_nodes
                n_nodes = torch.clamp(
                    torch.minimum(n_nodes, budget_nr - cursor), min=0)
                in_block = ((slot_idx >= cursor[:, None])
                            & (slot_idx < (cursor + n_nodes)[:, None]))
                is_last = slot_idx == (cursor + n_nodes - 1)[:, None]
                last_take = torch.where(n_nodes >= n_req, last_extra, per_node)
                blk = torch.where(
                    in_block,
                    torch.where(is_last, last_take[:, None], per_node[:, None]),
                    0.0)
                new_take = new_take + blk
                res = torch.where(in_block[..., None],
                                  _sel_rows(cand_alloc, bc)[:, None, :], res)
                row_zone = torch.where(in_block, _sel_rows(dom_zone, bd)[:, None],
                                       row_zone)
                row_dom = torch.where(in_block, bd[:, None], row_dom)
                row_cand = torch.where(in_block, bc[:, None], row_cand)
                row_price = torch.where(
                    in_block, cand_price[ar, bc, bd][:, None], row_price)
                active = active | in_block
                add = _sel_rows(cand_cap, bc) * n_nodes.to(torch.float32)[:, None]
                p1h = _sel_rows(prov1h, bc)                           # [B, P]
                prov_used = torch.where(p1h[..., None],
                                        prov_used + add[:, None, :], prov_used)
                state = (res, row_zone, row_dom, row_cand, row_price, active,
                         prov_used, new_take, cursor + n_nodes)
                return state, blk.sum(dim=1)

        def limit_headroom(prov_used_cur, bc):
            """Max nodes of candidate bc before its provisioner limit binds."""
            p = _sel_rows(cand_prov, bc)
            head = _sel_rows(prov_limits, p) - _sel_rows(prov_used_cur, p)
            cap_row = _sel_rows(cand_cap, bc)
            per = torch.where(
                cap_row > 0,
                torch.floor((head + 1e-6) / torch.clamp(cap_row, min=1e-9)),
                BIGN)
            return torch.clamp(per.amin(dim=1), 0.0, BIGN)

        def stage_pair(state, rem, dom_mask, score_rem):
            """One (bulk, tail) creation round; returns leftover pods."""
            bc, bd, ok = pick(score_rem, dom_mask, state[6], pool_rem=rem)
            ppn_b = torch.clamp(_sel_rows(take_pn, bc), min=1.0)
            n_bulk_f = torch.where(ok, torch.floor(rem / ppn_b), 0.0)
            n_bulk = torch.minimum(
                n_bulk_f, limit_headroom(state[6], bc)).to(torch.int32)
            state, took_b = write_block(state, n_bulk, ppn_b, ppn_b, bc, bd)
            rem_t = torch.clamp(rem - took_b, min=0.0)
            score_t = torch.maximum(score_rem - took_b, rem_t)
            ct_, dt_, ok_t = pick(score_t, dom_mask, state[6], tail_rem=rem_t,
                                  pool_rem=rem_t)
            ppn_t = torch.clamp(_sel_rows(take_pn, ct_), min=1.0)
            n_tail_f = torch.where(ok_t & (rem_t > 0),
                                   torch.ceil(rem_t / ppn_t), 0.0)
            n_tail = torch.minimum(
                n_tail_f, limit_headroom(state[6], ct_)).to(torch.int32)
            last = rem_t - (n_tail.to(torch.float32) - 1.0) * ppn_t
            state, took_t = write_block(
                state, n_tail, ppn_t, torch.minimum(
                    torch.clamp(last, min=0.0), ppn_t), ct_, dt_)
            return state, torch.clamp(rem_t - took_t, min=0.0)

        def two_stage(state, rem, dom_mask, score_rem=None):
            # round 2 only places pods when a provisioner limit (or slot
            # budget) clamped round 1
            if score_rem is None:
                score_rem = rem
            state, left = stage_pair(state, rem, dom_mask, score_rem)
            state, _ = stage_pair(state, left, dom_mask,
                                  torch.maximum(score_rem - (rem - left), left))
            return state

        zoned_any = flags["zoned_any"][g]
        zoned_all = flags["zoned_all"][g]
        zoned = (zsp >= 0) | (za >= 0) | zpa_on

        def normal_flow(state):
            with trace.span("step.alloc"):
                if zoned_all:
                    take, rem_z = zoned_alloc()
                elif not zoned_any:
                    take, rem_z = simple_alloc()
                else:
                    take, rem_z = _select(zoned, zoned_alloc(),
                                          simple_alloc())
            with trace.span("step.place"):
                return place(state, take, rem_z)

        def place(state, take, rem_z):
            out_z = out_s = None
            if zoned_any:
                # every zone's bulk pick scores against the group's FULL
                # new-node demand (the sequential oracle interleaves zones)
                total = rem_z.sum(dim=1)
                out_z = state
                for z in range(Z):
                    out_z = two_stage(out_z, rem_z[:, z], dom_zone == z,
                                      score_rem=total)
            if not zoned_all:
                out_s = two_stage(state, rem_z.sum(dim=1),
                                  torch.ones(B, D, dtype=torch.bool,
                                             device=dev))
            if out_z is None:
                return out_s, take
            if out_s is None:
                return out_z, take
            return _select(zoned, out_z, out_s), take

        def host_seed_flow(state):
            # mode-B hostname affinity: every pod of the group lands on the
            # SAME node — first-fit the earliest compatible open slot, else
            # create one node; the un-fitting remainder is infeasible
            elb = el & (zone_budget >= 1.0)
            ok_slots = rf & (cap >= 1.0) & _sel_many(elb, zone_safe)
            has = torch.any(ok_slots, dim=1)
            first = torch.argmax(ok_slots.to(torch.uint8), dim=1)
            z_first = torch.clamp(_sel_rows(row_zone, first), min=0)
            val = torch.where(
                has,
                torch.minimum(torch.minimum(cnt, _sel_rows(cap, first)),
                              _sel_rows(zone_budget, z_first)),
                0.0)
            take = torch.where(slot_idx == first[:, None], val[:, None], 0.0)
            elb_d = torch.gather(elb, 1, dom_zone)
            bc, bd, okp = pick(cnt, elb_d, state[6], size_tiebreak=False)
            n_new = torch.where(~has & okp, 1, 0).to(torch.int32)
            per = torch.minimum(
                torch.minimum(cnt, torch.clamp(_sel_rows(take_pn, bc), min=1.0)),
                torch.clamp(_sel_rows(zone_budget, _sel_rows(dom_zone, bd)),
                            min=0.0))
            state, _ = write_block(state, n_new, per, per, bc, bd)
            return state, take

        state, take = normal_flow(state0)
        if flags["hpa_any"][g]:
            with trace.span("step.seed"):
                hstate, htake = host_seed_flow(state0)
                state = _select(host_seed, hstate, state)
                take = torch.where(host_seed[:, None], htake, take)
        (res, row_zone, row_dom, row_cand, row_price, active, prov_used,
         new_take, n_used) = state

        # ---- counters -----------------------------------------------------
        with trace.span("step.count"):
            total_take = take + new_take                          # [B, NR]
            res = res - total_take[..., None] * req_g[:, None, :]
            match_g = g_sel_match[:, :, g].to(torch.float32)      # [B, S]
            selcnt = selcnt + (total_take[..., None]
                               * match_g[:, None, :]).to(torch.int32)
            zone1h_safe = torch.clamp(row_zone, min=0)[..., None] == zone_ar
            placed_z = _zone_sum(torch.where(active, total_take, 0.0),
                                 zone1h_safe)                     # [B, Z]
            zc = zc + (match_g[..., None]
                       * placed_z[:, None, :]).to(torch.int32)
            placed = total_take.sum(dim=1)
            tot = tot + (match_g * placed[:, None]).to(torch.int32)
            infeasible = infeasible.clone()
            infeasible[:, g] = torch.round(cnt - placed).to(torch.int32)

        carry = (res, row_zone, row_dom, row_cand, row_price, selcnt, active,
                 n_used, zc, tot, prov_used, infeasible)
        ys = total_take.to(torch.int32) if track else None
        return carry, ys

    carry = init
    ys_all = []
    for g in range(G):
        carry, ys = step(carry, g)
        if track:
            ys_all.append(ys)
    ys_b = torch.stack(ys_all, dim=1) if track and ys_all else None
    return carry, ys_b


def _branch_flags(np_consts_b: Dict[str, np.ndarray]) -> dict:
    """Host booleans per group: which step branches any slot can take.
    Static in the constant tensors (spread/anti/affinity slot ids), so the
    step skips a branch without reading the device."""
    zsp = np_consts_b["g_zone_spread"]
    za = np_consts_b["g_zone_anti"]
    zpa = np_consts_b["g_zone_paff"]
    hpa = np_consts_b["g_host_paff"]
    zoned = (zsp >= 0) | (za >= 0) | (zpa >= 0)                   # [B, G]
    return dict(
        zoned_any=[bool(v) for v in zoned.any(axis=0)],
        zoned_all=[bool(v) for v in zoned.all(axis=0)],
        zpa_any=[bool(v) for v in (zpa >= 0).any(axis=0)],
        hpa_any=[bool(v) for v in (hpa >= 0).any(axis=0)],
    )


# ---------------------------------------------------------------------------
# host-facing API
# ---------------------------------------------------------------------------


@dataclass
class TpuSolveOutput:
    result: SolveResult
    takes: Optional[np.ndarray]  # [G, NR] pods placed per slot per group step
    n_used: int
    solve_ms: float
    #: wall of the solve's first execution (prepare, dispatch, read-back).
    #: The port compiles nothing: this is what a shape pays the first time
    #: it runs (allocator growth, first-use library loads).  ``None`` at
    #: construction means the first execution is the one ``solve_ms`` timed
    compile_ms: Optional[float] = None

    def __post_init__(self) -> None:
        if self.compile_ms is None:
            self.compile_ms = self.solve_ms


class SlotsExhausted(Exception):
    """The optimistic NR axis ran out of node slots, the full-budget
    signature has not run in this process yet, and the caller asked not to
    retry there (``raise_on_exhaust``)."""

    def __init__(self, full_sig: tuple) -> None:
        super().__init__("node-slot estimate exhausted; full signature cold")
        self.full_sig = full_sig


class MegaBucketMismatch(ValueError):
    """A megabatch flush's requests do not share one bucket (or a caller
    over-filled the slots).  The collector degrades the flush to serial
    per-request dispatches — clients never see this."""


def _node_budget(st: SolveTensors, NE: int, max_nodes: Optional[int]) -> int:
    if max_nodes is None:
        max_nodes = NE + int(st.counts.sum())  # worst case: one pod per node
    return max(1, max_nodes)


def zone_share_matrix(st: SolveTensors, pad_g: int, Z: int) -> np.ndarray:
    """``[G+pad, Z]`` even split over each group's eligible zones — the
    counts-independent factor of :func:`host_count_arrays`, memoized on the
    tensors."""
    cache = getattr(st, "_zone_share_cache", None)
    key = (pad_g, Z)
    if cache is not None and cache[0] == key:
        return cache[1]
    G = st.G
    zone_share = np.zeros((G + pad_g, Z), dtype=np.float32)
    for gi, grp in enumerate(st.groups):
        vs = grp.requirements.get(L.ZONE)
        ok = np.zeros(Z, dtype=bool)
        for zi, zname in enumerate(st.zone_names):
            ok[zi] = vs.contains(zname)
        if not ok.any():
            ok[:] = True
        zone_share[gi] = ok.astype(np.float32) / float(ok.sum())
    st._zone_share_cache = (key, zone_share)
    return zone_share


def suffix_projection(demand_z: np.ndarray, count_z: np.ndarray):
    """``(suffix_res[G, Z, R], suffix_cnt[G, Z])`` — the later-group
    backfill suffix sums of per-zone demand."""
    suffix_res = np.concatenate(
        [np.cumsum(demand_z[::-1], axis=0)[::-1][1:],
         np.zeros((1,) + demand_z.shape[1:])]
    ).astype(np.float32)
    suffix_cnt = np.concatenate(
        [np.cumsum(count_z[::-1], axis=0)[::-1][1:],
         np.zeros((1, count_z.shape[1]))]
    ).astype(np.float32)
    return suffix_res, suffix_cnt


def host_count_arrays(st: SolveTensors, pad_g: int, Z: int):
    """The counts-dependent host tensors of one solve: padded counts +
    requests and the PER-ZONE suffix projection of later-group demand."""
    np_counts = np.pad(st.counts, (0, pad_g), constant_values=0)
    np_requests = np.pad(st.requests, ((0, pad_g), (0, 0)),
                         constant_values=0)
    demand = (np_counts[:, None] * np_requests).astype(np.float32)   # [G, R]
    zone_share = zone_share_matrix(st, pad_g, Z)
    demand_z = demand[:, None, :] * zone_share[:, :, None]           # [G, Z, R]
    count_z = np_counts[:, None].astype(np.float32) * zone_share     # [G, Z]
    np_suffix_res, np_suffix_cnt = suffix_projection(demand_z, count_z)
    return np_counts, np_requests, np_suffix_res, np_suffix_cnt


#: the array fields of :class:`SolveTensors` that carry tensorized state
_ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(SolveTensors)
    if f.name not in ("vocab", "groups", "cand_names", "prov_names",
                      "zone_names", "ct_names", "n_zones", "selector_defs",
                      "has_ct_spread"))


def tensors_from_reference(fields: Dict[str, np.ndarray], *,
                           like: SolveTensors) -> SolveTensors:
    """Carry another package's tensorized state into the port: every array
    field of ``fields`` (e.g. the reference's ``SolveTensors`` as numpy
    arrays) replaces the same field of ``like``, the port's own tensorize
    of the same batch, which supplies the host-side objects (groups, vocab,
    names).  Shapes and dtypes must agree field by field."""
    repl = {}
    for name in _ARRAY_FIELDS:
        if name not in fields:
            continue
        src = np.asarray(fields[name])
        own = np.asarray(getattr(like, name))
        if src.shape != own.shape or src.dtype != own.dtype:
            raise ValueError(
                f"field {name}: {src.shape}/{src.dtype} does not match the "
                f"port's {own.shape}/{own.dtype}")
        repl[name] = np.array(src, copy=True)
    return dataclasses.replace(like, **repl)


#: integer consts the step indexes with (moved to the device as int64)
_INDEX_CONSTS = ("g_zone_spread", "g_host_spread", "g_zone_anti",
                 "g_zone_paff", "g_host_paff", "cand_prov", "dom_zone")


class TpuSolver:
    """Builds the padded tensors of a solve, runs the batched group loop on
    ``device`` and extracts node plans.  ``device=None`` is the CUDA card
    and raises without one; the tests pass ``device="cpu"``.

    Readiness is tracked per signature (the padded-dims key of
    ``solve_dims``, plus the slot-rung tail for a megabatch) with the
    reference's meaning: a signature is ``ready`` once this process has run
    it.  Eager PyTorch compiles nothing, so a cold signature is served on
    the device like a warm one; ``warm_async`` runs a signature on a
    background thread (the callers' warmup), on the reference's warm
    machinery: a concurrency cap, a bounded FIFO queue and a failure
    backoff."""

    #: at most this many concurrent background warms; extras queue (FIFO,
    #: bounded) and start as slots free up
    MAX_CONCURRENT_WARMS = 2
    MAX_QUEUED_WARMS = 8
    #: group-loop signatures kept as captured CUDA graphs, and as many kept
    #: as seen but not captured (``ScanGraphs``); least recently used go
    #: first
    MAX_SCAN_GRAPHS = 16
    #: a signature whose background warm failed is not retried for this long
    WARM_FAILURE_BACKOFF = 300.0

    def __init__(self, device=None, clock: Optional[Clock] = None,
                 registry=None) -> None:
        self.device = resolve_device(device)
        # injectable clock for the warm-failure backoff
        self._clock = clock or Clock()
        # fault-injection plane: null and falsy unless KT_FAULTS configures
        # a chaos schedule — the dispatch/fence choke points guard with one
        # truthiness check
        self._faults = faults_mod.plane()
        self._lock = threading.Lock()
        self._ready: set = set()                     # guarded-by: _lock
        self._compiling: set = set()                 # guarded-by: _lock
        self._queued: list = []                      # guarded-by: _lock
        self._failed_until: Dict[tuple, float] = {}  # guarded-by: _lock
        self._stopped = False                        # guarded-by: _lock
        # shape families whose optimistic NR estimate exhausted once: their
        # signature resolves to the full-budget dims from then on
        self._nr_exhausted: set = set()              # guarded-by: _lock
        # per-(device, block) streams of sharded megabatch dispatches
        self._streams: Dict[tuple, object] = {}      # guarded-by: _lock
        # the group loop's CUDA graphs, one per signature; ``registry``
        # receives their replay histogram
        self._scan_graphs = ScanGraphs(self.MAX_SCAN_GRAPHS,
                                       torch.cuda.CUDAGraph, registry)

    # ---- signatures and readiness ----------------------------------------
    def signature(
        self,
        st: SolveTensors,
        *,
        existing_nodes: Sequence[SimNode] = (),
        max_nodes: Optional[int] = None,
        track_assignments: bool = True,
        mesh=None,
    ) -> tuple:
        """The padded-dims key of this solve (the reference's tuple on the
        same inputs, ``mesh`` setting its axis divisors); the full-budget
        dims once the family exhausted."""
        NE = len(existing_nodes)
        a, b = _mesh_divs(mesh)
        node_budget = _node_budget(st, NE, max_nodes)
        dims = solve_dims(st, NE=NE, node_budget=node_budget, a=a, b=b,
                          track=track_assignments)
        key = _dims_key(dims)
        with self._lock:
            exhausted = key in self._nr_exhausted
        if exhausted:
            key = _dims_key(solve_dims(
                st, NE=NE, node_budget=node_budget, a=a, b=b,
                track=track_assignments, full_nr=True))
        return key

    def mega_signature(
        self,
        st: SolveTensors,
        *,
        existing_nodes: Sequence[SimNode] = (),
        max_nodes: Optional[int] = None,
        track_assignments: bool = True,
        slots: int = 2,
        mesh=None,
    ) -> tuple:
        """Bucket key of the megabatch that would serve a ``slots``-request
        batch of this shape: the single-solve key plus the padded slot rung
        and the vocab positions of the zone/ct keys (two catalogs interning
        the keys differently are different buckets).  ``mesh`` is the
        sharded megabatch: per-slot dims stay the single-device ones (the
        slot axis, not the tensor axes, is what shards), the rung floors
        at the mesh's entry count and the mesh fingerprint joins the key."""
        base = self.signature(
            st, existing_nodes=existing_nodes, max_nodes=max_nodes,
            track_assignments=track_assignments,
        )
        return base + _mega_key_tail(
            slots, st.vocab.key_id[L.ZONE], st.vocab.key_id[L.CAPACITY_TYPE],
            mesh,
        )

    def ready(self, sig: tuple) -> bool:
        with self._lock:
            return sig in self._ready

    def compiling(self, sig: tuple) -> bool:
        with self._lock:
            return sig in self._compiling

    def warm_pending(self, sig: tuple) -> bool:
        """A warm for ``sig`` is running, queued, or in its failure backoff
        — admitting another would be refused."""
        with self._lock:
            return (sig in self._compiling
                    or any(s == sig for s, _ in self._queued)
                    or self._clock.now() < self._failed_until.get(sig, 0.0))

    def compiles_in_flight(self) -> int:
        with self._lock:
            return len(self._compiling)

    def warm_idle(self) -> bool:
        """No background warm running or queued."""
        with self._lock:
            return not self._compiling and not self._queued

    def stop_warms(self) -> None:
        """Drop all queued warms and stop the drain (shutdown): exit then
        waits only for the warms already running, never the queue."""
        with self._lock:
            self._stopped = True
            self._queued.clear()

    def _mark_ready(self, sig: tuple) -> None:
        # deliberately does NOT discard the sig from _compiling: a warm
        # thread for it may still be running, and "compiles_in_flight() ==
        # 0 implies every on_done ran" requires the warm thread itself to
        # clear its entry AFTER its on_done callback
        with self._lock:
            self._ready.add(sig)

    def warm_async(
        self,
        st: SolveTensors,
        *,
        existing_nodes: Sequence[SimNode] = (),
        max_nodes: Optional[int] = None,
        track_assignments: bool = True,
        mesh=None,
        on_done=None,
        slots: Optional[int] = None,
    ) -> bool:
        """Run this solve's signature on a background thread (the full
        solve, result discarded).  Returns True when the warm was accepted
        (started or queued), False when the signature is already ready /
        running / queued, is in its failure backoff, or the queue is full.
        ``on_done(sig, seconds, error)`` fires from the worker thread when
        the warm ends.  ``slots`` > 1 warms the megabatch at that slot
        rung instead of the single solve."""
        if slots and slots > 1:
            sig = self.mega_signature(
                st, existing_nodes=existing_nodes, max_nodes=max_nodes,
                track_assignments=track_assignments, slots=slots, mesh=mesh,
            )
        else:
            slots = None
            sig = self.signature(
                st, existing_nodes=existing_nodes, max_nodes=max_nodes,
                track_assignments=track_assignments, mesh=mesh,
            )
        kwargs = dict(
            st=st, existing_nodes=existing_nodes, max_nodes=max_nodes,
            track_assignments=track_assignments, mesh=mesh, on_done=on_done,
            slots=slots,
        )
        return self._admit_warm(sig, kwargs)

    def warm_custom(self, sig, thunk, on_done=None) -> bool:
        """Run an arbitrary prepared device program on the warm machinery
        (concurrency cap, bounded queue, failure backoff): ``thunk()`` must
        run — and ``_mark_ready`` — the program ``sig`` names."""
        return self._admit_warm(sig, dict(on_done=on_done, thunk=thunk))

    def _admit_warm(self, sig: tuple, kwargs: dict) -> bool:
        with self._lock:
            if self._stopped:
                return False
            if sig in self._ready or sig in self._compiling:
                return False
            if any(s == sig for s, _ in self._queued):
                return False
            if self._clock.now() < self._failed_until.get(sig, 0.0):
                return False  # recent warm failure: back off
            if len(self._compiling) >= self.MAX_CONCURRENT_WARMS:
                if len(self._queued) >= self.MAX_QUEUED_WARMS:
                    return False
                self._queued.append((sig, kwargs))
                return True
            self._compiling.add(sig)
        self._spawn_warm(sig, kwargs)
        return True

    def _spawn_warm(self, sig: tuple, kwargs: dict) -> None:
        on_done = kwargs.pop("on_done")
        slots = kwargs.pop("slots", None)
        thunk = kwargs.pop("thunk", None)

        def work():
            t0 = time.perf_counter()
            err = None
            try:
                if thunk is not None:
                    thunk()
                elif slots:
                    # megabatch warm: one request padded up to the slot
                    # rung runs exactly the batch a full flush will
                    req = dict(kwargs)
                    mesh = req.pop("mesh")
                    outs = self.solve_many([req], min_slots=slots, mesh=mesh)
                    if isinstance(outs[0], Exception):
                        raise outs[0]
                else:
                    self.solve(**kwargs)
            # ktlint: allow[KT005] a warm failure is surfaced through
            # on_done (the scheduler's callback logs it) and arms the retry
            # backoff
            except Exception as e:
                err = e
                with self._lock:
                    self._failed_until[sig] = (self._clock.now()
                                               + self.WARM_FAILURE_BACKOFF)
            try:
                if on_done is not None:
                    on_done(sig, time.perf_counter() - t0, err)
            except Exception:  # a throwing callback must not wedge the tier
                logging.getLogger(__name__).warning(
                    "warm on_done callback raised", exc_info=True)
            finally:
                # clear the in-flight entry only AFTER on_done: watchers
                # poll compiles_in_flight() down to 0 and then read the
                # metrics the callback records
                with self._lock:
                    self._compiling.discard(sig)
            # drain: start the next queued warm that is still cold — unless
            # the process is exiting or stop_warms() ran
            while True:
                with self._lock:
                    if (self._stopped
                            or not threading.main_thread().is_alive()
                            or not self._queued
                            or len(self._compiling)
                            >= self.MAX_CONCURRENT_WARMS):
                        return
                    next_sig, next_kwargs = self._queued.pop(0)
                    if next_sig in self._ready:
                        continue  # run by a direct solve meanwhile
                    self._compiling.add(next_sig)
                self._spawn_warm(next_sig, next_kwargs)
                return

        # NON-daemon: interpreter exit waits for a running warm instead of
        # killing a thread in the middle of device work
        threading.Thread(target=work, name="tpu-solver-warm").start()

    def _host_arrays(
        self,
        st: SolveTensors,
        existing_nodes: Sequence[SimNode],
        *,
        node_budget: int,
        track_assignments: bool,
        full_nr: bool,
        dims: Optional[dict] = None,
        a: int = 1,
        b: int = 1,
    ):
        """Pure-host (numpy) build of one solve's padded tensors: returns
        ``(np_consts, feas, np_init, dims)`` — the same padding/bucketing
        as the reference, so both packages build identical arrays."""
        G, C, D, R = st.G, max(1, st.C), st.D, st.R
        S, Z = st.S, max(1, st.n_zones)
        NE = len(existing_nodes)

        if dims is None:
            dims = solve_dims(st, NE=NE, node_budget=node_budget, a=a, b=b,
                              track=track_assignments, full_nr=full_nr)
        pad_g = dims["G"] - G
        pad_c = dims["C"] - C
        pad_s = dims["S"] - S
        NR = dims["NR"]

        def _pad(arr, n, axis, value):
            if n == 0:
                return arr
            widths = [(0, 0)] * arr.ndim
            widths[axis] = (0, n)
            return np.pad(arr, widths, constant_values=value)

        np_counts, np_requests, np_suffix_res, np_suffix_cnt = (
            host_count_arrays(st, pad_g, Z))
        np_pm = _pad(st.pm, pad_g, 0, 0)
        np_gzs = _pad(st.g_zone_spread, pad_g, 0, -1)
        np_gzk = _pad(st.g_zone_skew, pad_g, 0, 1)
        np_ghs = _pad(st.g_host_spread, pad_g, 0, -1)
        np_ghc = _pad(st.g_host_cap, pad_g, 0, 0)
        np_gza = _pad(st.g_zone_anti, pad_g, 0, -1)
        np_gzp = _pad(st.g_zone_paff, pad_g, 0, -1)
        np_ghp = _pad(st.g_host_paff, pad_g, 0, -1)
        np_gsm = _pad(_pad(st.g_sel_match, pad_g, 1, False), pad_s, 0, False)
        np_gp_ok = _pad(st.gp_ok, pad_g, 0, False)
        np_cvw = _pad(st.cand_vw, pad_c, 0, 0)
        np_cvb = _pad(st.cand_vb, pad_c, 0, 0)
        np_calloc = _pad(st.cand_alloc, pad_c, 0, 0)
        np_ccap = _pad(st.cand_cap, pad_c, 0, 0)
        np_cprov = _pad(st.cand_prov, pad_c, 0, 0)
        np_cprice = _pad(st.cand_price, pad_c, 0, np.float32(3.0e38))
        np_cavail = _pad(st.cand_avail, pad_c, 0, False)
        G = G + pad_g
        S = S + pad_s

        # ---- existing-node tensors (host-side compat precompute) -------
        NE_pad = dims["NE_pad"]
        P_pad = dims["P"]
        ex_res = np.zeros((NR, R), dtype=np.float32)
        ex_zone = np.zeros(NR, dtype=np.int32)
        ex_sel = np.zeros((NR, S), dtype=np.int32)
        ex_ok = np.zeros((G, NE_pad), dtype=bool)
        ex_price = np.zeros(NR, dtype=np.float32)
        zone_index = {z: i for i, z in enumerate(st.zone_names)}
        zc0 = np.zeros((S, Z), dtype=np.int32)
        tot0 = np.zeros(S, dtype=np.int32)
        prov_used0 = np.zeros((P_pad, R), dtype=np.float32)
        prov_index = {n: i for i, n in enumerate(st.prov_names)}

        # limits bind on raw machine CAPACITY (st.capacity_row)
        for ni, node in enumerate(existing_nodes):
            ex_res[ni] = st.vocab.resources_to_row(node.remaining()).astype(np.float32)
            ex_zone[ni] = zone_index.get(node.zone, 0)
            ex_price[ni] = node.price
            pi = prov_index.get(node.provisioner)
            if pi is not None:
                prov_used0[pi] += st.capacity_row(node.instance_type,
                                                  node.allocatable)
            for gi, g in enumerate(st.groups):
                rep = g.pods[0]
                ex_ok[gi, ni] = (
                    not any(t.blocks(rep.tolerations) for t in node.taints)
                    and g.requirements.compatible(node.labels) is None
                )
        # selector counts on existing nodes + zone counters: a node's pods
        # are counted by their labels, and each distinct label set matched
        # once per selector (a deployment's pods all carry one)
        if st.selector_defs:
            for ni, node in enumerate(existing_nodes):
                by_labels: Dict[tuple, list] = {}
                for p in node.pods:
                    key = tuple(p.labels.items())
                    seen = by_labels.get(key)
                    if seen is None:
                        by_labels[key] = [p.labels, 1]
                    else:
                        seen[1] += 1
                zi = zone_index.get(node.zone, 0)
                for si, (sel, _topo, _kind) in enumerate(st.selector_defs):
                    n_match = sum(n for labels, n in by_labels.values()
                                  if sel.matches(labels))
                    ex_sel[ni, si] = n_match
                    zc0[si, zi] += n_match
                    tot0[si] += n_match

        np_consts = dict(
            counts=np_counts,
            suffix_res=np_suffix_res,
            suffix_cnt=np_suffix_cnt,
            requests=np_requests,
            g_zone_spread=np_gzs,
            g_zone_skew=np_gzk,
            g_host_spread=np_ghs,
            g_host_cap=np_ghc,
            g_zone_anti=np_gza,
            g_zone_paff=np_gzp,
            g_host_paff=np_ghp,
            g_sel_match=np_gsm,
            cand_alloc=np_calloc,
            cand_cap=np_ccap,
            cand_prov=np_cprov,
            cand_price=np.where(np.isinf(np_cprice), np.float32(3.0e38),
                                np_cprice).astype(np.float32),
            cand_avail=np_cavail,
            prov_limits=_pad(
                np.where(np.isinf(st.prov_limits), np.float32(3.0e38),
                         st.prov_limits).astype(np.float32),
                P_pad - st.prov_limits.shape[0], 0, np.float32(3.0e38),
            ),
            dom_zone=st.dom_zone,
            ex_ok=ex_ok,
            node_budget=np.int32(node_budget),
        )
        feas = dict(
            pm=np_pm,
            gp_ok=np_gp_ok,
            cand_vw=np_cvw,
            cand_vb=np_cvb,
            key_check=st.key_check,
            dom_vw=st.dom_vw,
            dom_vb=st.dom_vb,
        )
        np_init = (
            ex_res,                                  # res
            ex_zone,                                 # row_zone
            np.full(NR, -1, dtype=np.int32),         # row_dom
            np.full(NR, -1, dtype=np.int32),         # row_cand
            ex_price,                                # row_price
            ex_sel,                                  # selcnt
            np.arange(NR) < NE,                      # active
            np.int32(NE),                            # n_used
            zc0,                                     # zc
            tot0,                                    # tot
            prov_used0,                              # prov_used
            np.zeros(G, dtype=np.int32),             # infeasible
        )
        return np_consts, feas, np_init, dims

    # ---- host -> device ------------------------------------------------
    @staticmethod
    def _stack(vals: List[np.ndarray], device, dtype=None) -> torch.Tensor:
        """Stack per-slot host arrays on ``device``; slots sharing one
        array object (a shared base build) transfer it once and expand."""
        first = vals[0]
        if all(v is first for v in vals[1:]):
            a = np.asarray(first)
            if not a.flags.c_contiguous:
                a = np.ascontiguousarray(a)
            t = torch.from_numpy(a).to(device)
            if dtype is not None:
                t = t.to(dtype)
            return t.unsqueeze(0).expand(len(vals), *t.shape)
        t = torch.from_numpy(np.stack(vals)).to(device)
        return t.to(dtype) if dtype is not None else t

    @staticmethod
    def _feasibility(feas: dict, np_consts: dict, zone_key: int,
                     ct_key: int, device, rows=slice(None),
                     cols=slice(None)):
        """Feasibility of one solve on ``device``; ``rows`` / ``cols``
        select a (pods, types) block of ``F`` (and the rows of
        ``dom_ok``)."""
        def t(a, dtype=None):
            out = torch.from_numpy(np.ascontiguousarray(a)).to(device)
            return out.to(dtype) if dtype is not None else out

        return compute_feasibility(
            t(feas["pm"][rows], torch.int64), t(np_consts["requests"][rows]),
            t(feas["gp_ok"][rows]), t(feas["cand_vw"][cols], torch.int64),
            t(feas["cand_vb"][cols], torch.int64),
            t(np_consts["cand_alloc"][cols]),
            t(np_consts["cand_prov"][cols], torch.int64),
            t(feas["key_check"]),
            t(feas["dom_vw"], torch.int64), t(feas["dom_vb"], torch.int64),
            zone_key, ct_key,
        )

    def _sharded_feasibility(self, feas: dict, np_consts: dict,
                             zone_key: int, ct_key: int, mesh):
        """``F`` and ``dom_ok`` computed block by block over the mesh's
        (pods, types) layout (``feasibility_shardings``), each block on its
        own entry's device, then assembled on the solver's device.  In a
        multi-process job a rank computes only its own blocks and gathers
        the rest from their ranks (``torch.distributed``)."""
        from ..parallel.distributed import gather_blocks
        from ..parallel.mesh import _rank, feasibility_shardings, multihost

        _ins, (f_sh, d_sh) = feasibility_shardings(mesh)
        G = feas["pm"].shape[0]
        C = feas["cand_vw"].shape[0]
        D = feas["dom_vw"].shape[0]
        me = _rank()
        f_blocks, d_blocks = [], []
        for (_p, dev, proc, (rs, cs)), (_q, _d, _pp, (rd, _all)) in zip(
                f_sh.shard_indices((G, C)), d_sh.shard_indices((G, D))):
            if proc != me:
                continue
            F_b, dom_b = self._feasibility(feas, np_consts, zone_key, ct_key,
                                           dev, rows=rs, cols=cs)
            f_blocks.append(((rs, cs), F_b))
            d_blocks.append(((rd,), dom_b))
        F = gather_blocks(f_blocks, (G, C), torch.bool, self.device,
                          complete=not multihost(mesh))
        dom_ok = gather_blocks(d_blocks, (G, D), torch.bool, self.device,
                               complete=not multihost(mesh))
        return F, dom_ok

    def _enqueue_entries(self, entries: Sequence[dict], zone_key: int,
                         ct_key: int, device=None, trace=NULL_TRACE):
        """The enqueue half of one dispatch over prepared entries (all at
        one dims bucket) on ``device`` (the solver's by default): uploads,
        feasibility per distinct input set, then the batched group loop
        (:meth:`_scan`), whose step parts ``trace`` names
        (``_run_scan``).  Returns the device ``(carry, ys)`` with a
        leading slot axis; nothing here reads the device back."""
        if self._faults:
            self._faults.fire("dispatch")  # dispatch_exc raises here
        dev = self.device if device is None else torch.device(device)
        dims0 = entries[0]["dims"]
        if not all(e["dims"] == dims0 for e in entries):
            raise MegaBucketMismatch("megabatch entries span dims buckets")
        NR, Z = dims0["NR"], dims0["Z"]
        track = entries[0]["r"]["track_assignments"]
        keys = list(entries[0]["np_consts"])

        # feasibility: slots built from one base (and padding copies of
        # request 0) share their inputs — compute once per distinct set
        # (identity), as the reference's vmapped program computes the same
        # values per slot
        memo: Dict[tuple, tuple] = {}
        Fs, DOs = [], []
        for e in entries:
            fk = tuple(id(v) for v in e["feas"].values()) + (
                id(e["np_consts"]["requests"]),
                id(e["np_consts"]["cand_alloc"]),
                id(e["np_consts"]["cand_prov"]))
            if fk not in memo:
                # a meshed solve brings its blockwise feasibility along
                memo[fk] = e.get("feas_out") or self._feasibility(
                    e["feas"], e["np_consts"], zone_key, ct_key, dev)
            Fs.append(memo[fk][0])
            DOs.append(memo[fk][1])
        consts = {}
        for k in keys:
            vals = [e["np_consts"][k] for e in entries]
            dtype = torch.int64 if k in _INDEX_CONSTS else None
            consts[k] = self._stack(vals, dev, dtype)
        if consts["g_sel_match"].shape[1] == 0:
            # no selectors: one inert all-False slot keeps the clamped
            # selector gathers in range (every slot id is -1 anyway)
            consts["g_sel_match"] = torch.zeros(
                len(entries), 1, dims0["G"], dtype=torch.bool, device=dev)
        consts["node_budget"] = consts["node_budget"].to(torch.int64)
        consts["F"] = torch.stack(Fs) if len(set(map(id, Fs))) > 1 else \
            Fs[0].unsqueeze(0).expand(len(entries), *Fs[0].shape)
        consts["dom_ok"] = torch.stack(DOs) if len(set(map(id, DOs))) > 1 \
            else DOs[0].unsqueeze(0).expand(len(entries), *DOs[0].shape)

        init_dtypes = (None, torch.int64, torch.int64, torch.int64, None,
                       None, None, torch.int64, None, None, None, None)
        init = []
        for i, dt in enumerate(init_dtypes):
            vals = [np.asarray(e["np_init"][i]) for e in entries]
            init.append(self._stack(vals, dev, dt).clone())
        if init[5].shape[2] == 0:
            B = len(entries)
            init[5] = torch.zeros(B, NR, 1, dtype=torch.int32, device=dev)
            init[8] = torch.zeros(B, 1, Z, dtype=torch.int32, device=dev)
            init[9] = torch.zeros(B, 1, dtype=torch.int32, device=dev)

        flags = _branch_flags({
            k: np.stack([np.asarray(e["np_consts"][k]) for e in entries])
            for k in ("g_zone_spread", "g_zone_anti", "g_zone_paff",
                      "g_host_paff")})
        return self._scan(consts, tuple(init), NR, Z, track, flags, trace)

    def _scan(self, consts: dict, init: tuple, NR: int, Z: int, track: bool,
              flags: dict, trace=NULL_TRACE):
        """The group loop: ``_run_scan`` itself on host tensors; on a CUDA
        device through its signature's graph (``ScanGraphs``: eager until
        its eager runs pay for a capture, replayed after), inside a
        ``scan.capture`` or ``scan.replay`` span where it is not eager."""
        def scan(c, i):
            return _run_scan(c, i, NR, Z, track, flags, trace)

        if consts["counts"].device.type != "cuda":
            return scan(consts, init)
        return self._scan_graphs.run(scan_key(consts, init, track, flags),
                                     consts, init, scan, trace)

    def _fence(self) -> None:
        """The ``fence`` fault site, fired before every device-to-host read
        (``device_hang`` raises here; a ``slow_fence`` sleeps)."""
        if self._faults:
            effect = self._faults.fire("fence")
            if effect is not None and effect.kind == "slow_fence":
                self._faults.sleep(effect)

    # ktlint: fence the one device-to-host read of a dispatch, behind the
    # fence fault site — every serving path reads back through here
    def _read_back(self, carry, ys):
        """The read-back half: the one device-to-host read of a dispatch,
        behind the ``fence`` fault site."""
        self._fence()
        carry_np = [x.cpu().numpy() for x in carry]
        ys_np = ys.cpu().numpy() if ys is not None else None
        return carry_np, ys_np

    # ---- dispatch preamble ----------------------------------------------
    def prepare(
        self,
        st: SolveTensors,
        *,
        existing_nodes: Sequence[SimNode] = (),
        max_nodes: Optional[int] = None,
        track_assignments: bool = True,
        mesh=None,
        full_nr: bool = False,
    ):
        """Build ``(run, entry, NE)``: ``entry`` holds the solve's padded
        host arrays and ``run(entry, trace=NULL_TRACE)`` enqueues the
        one-slot group loop, returning the device ``(carry, ys)`` unread.  ``mesh`` pads to the
        mesh's axis divisors and computes feasibility block by block over
        its (pods, types) layout, assembled on the solver's device where
        the scan runs replicated (module docstring)."""
        NE = len(existing_nodes)
        node_budget = _node_budget(st, NE, max_nodes)
        a, b = _mesh_divs(mesh)
        np_consts, feas, np_init, dims = self._host_arrays(
            st, existing_nodes, node_budget=node_budget,
            track_assignments=track_assignments, full_nr=full_nr, a=a, b=b)
        entry = dict(
            r=dict(st=st, existing_nodes=existing_nodes, max_nodes=max_nodes,
                   track_assignments=track_assignments),
            np_consts=np_consts, feas=feas, np_init=np_init, dims=dims, NE=NE)
        zone_key = st.vocab.key_id[L.ZONE]
        ct_key = st.vocab.key_id[L.CAPACITY_TYPE]
        if mesh is not None:
            entry["feas_out"] = self._sharded_feasibility(
                feas, np_consts, zone_key, ct_key, mesh)

        def run(entry, trace=NULL_TRACE):
            return self._enqueue_entries([entry], zone_key, ct_key,
                                         trace=trace)

        return run, entry, NE

    def _prepare_dispatch(
        self, st: SolveTensors, existing_nodes, max_nodes,
        track_assignments: bool, mesh, full_nr: bool,
    ):
        """Shared dispatch preamble of ``solve`` and ``solve_async`` — the
        single source of the dims / exhausted-promotion steps, so the
        synchronous and the async paths can never run different batches.
        Returns ``(run, entry, NE, est_dims, full_dims, full_nr)``;
        ``run(entry)`` has NOT been called."""
        a, b = _mesh_divs(mesh)
        NE0 = len(existing_nodes)
        node_budget = _node_budget(st, NE0, max_nodes)
        est_dims = solve_dims(st, NE=NE0, node_budget=node_budget, a=a, b=b,
                              track=track_assignments)
        full_dims = solve_dims(st, NE=NE0, node_budget=node_budget, a=a, b=b,
                               track=track_assignments, full_nr=True)
        if not full_nr:
            # families that exhausted the optimistic NR go straight to the
            # full-budget axis
            with self._lock:
                full_nr = _dims_key(est_dims) in self._nr_exhausted
        run, entry, NE = self.prepare(
            st, existing_nodes=existing_nodes, max_nodes=max_nodes,
            track_assignments=track_assignments, mesh=mesh, full_nr=full_nr,
        )
        return run, entry, NE, est_dims, full_dims, full_nr

    def _maybe_retry_exhausted(
        self, carry_np, est_dims: dict, full_dims: dict, full_nr: bool,
        raise_on_exhaust: bool, retry,
    ) -> Optional["TpuSolveOutput"]:
        """Slot-exhaustion epilogue shared by ``solve`` and both pending
        handles: when the optimistic NR axis ran out of node slots AND left
        pods unplaced, remember the family (``_nr_exhausted``), raise
        :class:`SlotsExhausted` under ``raise_on_exhaust`` while the
        full-budget signature has not run yet, else run ``retry()`` (a
        full-budget re-solve).  Returns None when the solve stands.
        ``carry_np`` is one slot's host carry (the rows ``_read_back``
        returned)."""
        if full_nr or est_dims["NR"] >= full_dims["NR"]:
            return None
        if (int(carry_np[7]) < est_dims["NR"]
                or int(carry_np[11].sum()) <= 0):
            return None
        full_key = _dims_key(full_dims)
        with self._lock:
            self._nr_exhausted.add(_dims_key(est_dims))
            full_ready = full_key in self._ready
        if raise_on_exhaust and not full_ready:
            raise SlotsExhausted(full_key)
        return retry()

    # ---- solves ---------------------------------------------------------
    def solve(
        self,
        st: SolveTensors,
        *,
        existing_nodes: Sequence[SimNode] = (),
        max_nodes: Optional[int] = None,
        track_assignments: bool = True,
        mesh=None,
        measure: bool = False,
        full_nr: bool = False,
        raise_on_exhaust: bool = False,
        trace=None,
    ) -> TpuSolveOutput:
        """One device solve (a one-slot megabatch).  When the optimistic NR
        axis ran out of node slots with pods left unplaced, the solve is
        retried once at the full budget — or, with ``raise_on_exhaust`` and
        the full-budget signature not run yet, :class:`SlotsExhausted` is
        raised instead.

        The first execution's wall (prepare, dispatch, read-back) is
        ``compile_ms``; the port compiles nothing, so it is what the shape
        pays the first time it runs.  ``measure=True`` (benchmarks only:
        production solves pay one execution) runs the prepared dispatch a
        second time, results discarded, and reports that run's wall, from
        enqueue to its read-back, as ``solve_ms``.

        ``device_execute`` holds ``device_enqueue`` (uploads, feasibility
        and the group loop: its launches named by part where it runs
        eagerly or is captured, ``scan.replay`` where its graph is
        replayed) and ``device_readback`` (the fence and the
        device-to-host copies: the host blocked on the device)."""
        t0 = time.perf_counter()
        trace = trace or NULL_TRACE
        with trace.span("device_prepare"):
            run, entry, NE, est_dims, full_dims, full_nr = \
                self._prepare_dispatch(st, existing_nodes, max_nodes,
                                       track_assignments, mesh, full_nr)
        with trace.span("device_execute", full_nr=full_nr):
            with trace.span("device_enqueue"):
                carry, ys = run(entry, trace)
            with trace.span("device_readback"):
                carry_np, ys_np = self._read_back(carry, ys)
        compile_ms = solve_ms = (time.perf_counter() - t0) * 1000.0
        # mark ready the key of the batch that ACTUALLY ran
        self._mark_ready(_dims_key(full_dims if full_nr else est_dims))
        carry = tuple(x[0] for x in carry_np)
        retried = self._maybe_retry_exhausted(
            carry, est_dims, full_dims, full_nr, raise_on_exhaust,
            lambda: self.solve(
                st, existing_nodes=existing_nodes, max_nodes=max_nodes,
                track_assignments=track_assignments, mesh=mesh,
                measure=measure, full_nr=True, trace=trace),
        )
        if retried is not None:
            return retried
        if measure:
            t1 = time.perf_counter()
            self._read_back(*run(entry))
            solve_ms = (time.perf_counter() - t1) * 1000.0
        with trace.span("extract"):
            out = self._extract(
                st, carry, ys_np[0] if ys_np is not None else None,
                existing_nodes, NE, solve_ms)
        out.compile_ms = compile_ms
        return out

    def solve_async(
        self,
        st: SolveTensors,
        *,
        existing_nodes: Sequence[SimNode] = (),
        max_nodes: Optional[int] = None,
        track_assignments: bool = True,
        mesh=None,
        raise_on_exhaust: bool = False,
        trace=None,
    ) -> "PendingTpuSolve":
        """Dispatch one device solve WITHOUT reading it back: the uploads
        and the group loop are enqueued on the calling thread's current
        stream, and :meth:`PendingTpuSolve.result` reads back and extracts.
        An eager group loop is issued from Python, so its enqueue costs
        about as much host time as the solve; a replayed one is one graph
        launch, whose outputs are copies no later replay overwrites."""
        t0 = time.perf_counter()
        trace = trace or NULL_TRACE
        with trace.span("device_dispatch"):
            run, entry, NE, est_dims, full_dims, full_nr = \
                self._prepare_dispatch(st, existing_nodes, max_nodes,
                                       track_assignments, mesh, False)
            with trace.span("device_enqueue"):
                carry, ys = run(entry, trace)  # enqueued, not read
        return PendingTpuSolve(
            solver=self, st=st, existing_nodes=existing_nodes, NE=NE,
            carry=carry, ys=ys, t0=t0, track=track_assignments,
            est_dims=est_dims, full_dims=full_dims, full_nr=full_nr,
            raise_on_exhaust=raise_on_exhaust,
            solve_kwargs=dict(
                existing_nodes=existing_nodes, max_nodes=max_nodes,
                track_assignments=track_assignments, mesh=mesh,
            ),
            trace=trace,
        )

    def solve_many_async(
        self,
        requests: Sequence[dict],
        *,
        min_slots: Optional[int] = None,
        mesh=None,
        target_dims: Optional[dict] = None,
        registry=None,
    ) -> "PendingMegaSolve":
        """Dispatch B independent, bucket-compatible solve requests as ONE
        batched group loop over padded request slots, WITHOUT reading back;
        :meth:`PendingMegaSolve.results` is the one batch-wide read.

        Each request is a dict with ``st`` (required) and optionally
        ``existing_nodes``, ``max_nodes``, ``track_assignments``,
        ``raise_on_exhaust``, ``trace``; every request must resolve to the
        same :meth:`mega_signature` bucket.  The slot axis pads up to the
        power-of-two rung (``_mega_rung``; ``min_slots`` forces a larger
        rung) with copies of request 0 that share its arrays, and their
        outputs are discarded — slots never interact, so padding cannot
        leak into a real request's result.  ``target_dims`` builds every
        request at caller-chosen padded dims (a unified mixed-bucket flush,
        :func:`unify_mega_keys`).

        ``mesh`` serves the batch SHARDED: the padded slot axis splits into
        one contiguous block per mesh entry (``slot_mesh``), each device's
        run of entries enqueued as one block on its own stream; per-slot
        programs are the single-device ones, so results equal unmeshed
        serial solves.  In a multi-process job each rank enqueues and reads
        back only its own blocks (the per-host fence).  ``registry`` observes the fence's
        byte and ownership counters."""
        if not requests:
            raise MegaBucketMismatch("empty megabatch")
        if len(requests) > MEGA_MAX_SLOTS:
            raise MegaBucketMismatch(
                f"{len(requests)} requests exceed MEGA_MAX_SLOTS="
                f"{MEGA_MAX_SLOTS}")
        t0 = time.perf_counter()
        defaults = dict(
            existing_nodes=(), max_nodes=None, track_assignments=True,
            raise_on_exhaust=False, trace=NULL_TRACE,
        )
        reqs = [{**defaults, **r} for r in requests]
        n_slots = max(len(reqs), min_slots or 1)
        # ONE snapshot of the exhausted families for the whole call: a warm
        # thread flipping _nr_exhausted mid-flush must not make the
        # per-request dims diverge
        with self._lock:
            exhausted = set(self._nr_exhausted)
        track = reqs[0]["track_assignments"]
        zone_key = reqs[0]["st"].vocab.key_id[L.ZONE]
        ct_key = reqs[0]["st"].vocab.key_id[L.CAPACITY_TYPE]

        entries = []
        for r in reqs:
            st = r["st"]
            NE = len(r["existing_nodes"])
            nb = _node_budget(st, NE, r["max_nodes"])
            est_dims = solve_dims(st, NE=NE, node_budget=nb, track=track)
            full_dims = solve_dims(st, NE=NE, node_budget=nb, track=track,
                                   full_nr=True)
            full_nr = _dims_key(est_dims) in exhausted
            np_consts, feas, np_init, dims = self._host_arrays(
                st, r["existing_nodes"], node_budget=nb,
                track_assignments=track, full_nr=full_nr,
                dims=dict(target_dims) if target_dims is not None else None,
            )
            entries.append(dict(
                r=r, np_consts=np_consts, feas=feas, np_init=np_init,
                dims=dims, est_dims=est_dims, full_dims=full_dims,
                full_nr=full_nr, NE=NE,
            ))
        return self._dispatch_prepared(entries, n_slots=n_slots, track=track,
                                       zone_key=zone_key, ct_key=ct_key,
                                       t0=t0, mesh=mesh, registry=registry)

    def solve_many_prepared(self, entries: Sequence[dict], *,
                            min_slots: Optional[int] = None, mesh=None,
                            registry=None, trace=None) -> List[object]:
        """Solve PRE-BUILT entries (each with ``r``, ``np_consts``, ``feas``,
        ``np_init``, ``dims``, ``NE``; all at one dims bucket, full NR) as
        ONE batched dispatch; one output per entry, in order.  The
        hierarchical solve and the consolidation sweep derive every entry
        from one shared base build.  Unmeshed, the batch runs unpadded and
        every output is a :class:`TpuSolveOutput`.  ``mesh`` runs it as the
        sharded megabatch of :meth:`solve_many_async` (padded to the rung
        of ``min_slots``), whose outputs may also be a slot's exception
        (:class:`SlotNotOwned` for another rank's slot).

        Unmeshed, ``trace`` names the dispatch as :meth:`solve` does:
        ``device_execute`` holding ``device_enqueue`` (with the group
        step's ``step.*`` parts) and ``device_readback``, then one
        ``extract`` per entry.  A meshed dispatch records each entry's
        ``megabatch`` and ``extract`` spans on the entry's own trace."""
        if not entries:
            raise MegaBucketMismatch("empty megabatch")
        if len(entries) > MEGA_MAX_SLOTS:
            raise MegaBucketMismatch(
                f"{len(entries)} entries exceed MEGA_MAX_SLOTS="
                f"{MEGA_MAX_SLOTS}")
        t0 = time.perf_counter()
        st0 = entries[0]["r"]["st"]
        zone_key = st0.vocab.key_id[L.ZONE]
        ct_key = st0.vocab.key_id[L.CAPACITY_TYPE]
        if mesh is not None:
            return self._dispatch_prepared(
                entries, n_slots=max(len(entries), min_slots or 1),
                track=entries[0]["r"]["track_assignments"],
                zone_key=zone_key, ct_key=ct_key, t0=t0, mesh=mesh,
                registry=registry).results()
        trace = trace or NULL_TRACE
        with trace.span("device_execute", slots=len(entries)):
            with trace.span("device_enqueue"):
                carry, ys = self._enqueue_entries(entries, zone_key, ct_key,
                                                  trace=trace)
            with trace.span("device_readback"):
                carry_np, ys_np = self._read_back(carry, ys)
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        outs = []
        for i, e in enumerate(entries):
            r = e["r"]
            with trace.span("extract", slot=i):
                outs.append(self._extract(
                    r["st"], tuple(x[i] for x in carry_np),
                    ys_np[i] if ys_np is not None else None,
                    r["existing_nodes"], e["NE"], elapsed_ms,
                    groups=r.get("groups")))
        return outs

    def _dispatch_prepared(
        self, entries, *, n_slots: int, track: bool, zone_key: int,
        ct_key: int, t0: float, mesh=None, registry=None,
    ) -> "PendingMegaSolve":
        """Pad + enqueue prepared entries; validates the one-bucket
        invariant (a typed :class:`MegaBucketMismatch` the collector
        degrades to serial dispatches on)."""
        reqs = [e["r"] for e in entries]
        dims0 = entries[0]["dims"]
        if not all(e["dims"] == dims0 for e in entries) or any(
            r["st"].vocab.key_id[L.ZONE] != zone_key
            or r["st"].vocab.key_id[L.CAPACITY_TYPE] != ct_key
            or r["track_assignments"] != track
            for r in reqs
        ):
            raise MegaBucketMismatch("requests span megabatch buckets")
        n_dev = _mesh_size(mesh)
        if not mesh_shardable(mesh):
            # one block per entry would pad past the rung ladder; the
            # scheduler gates these meshes onto the serial path
            # (mesh_serial), so only a direct caller lands here
            raise MegaBucketMismatch(
                f"{n_dev}-device mesh exceeds MEGA_MAX_SLOTS="
                f"{MEGA_MAX_SLOTS}; sharded megabatch unavailable")
        mega_key = _dims_key(dims0) + _mega_key_tail(
            n_slots, zone_key, ct_key, mesh)
        B = len(entries)
        B_pad = _mega_rung(n_slots, n_dev)
        if B > B_pad:
            # an awkward entry count's largest in-ladder rung can sit below
            # the caller's flush size (24 entries cap at 24 slots)
            raise MegaBucketMismatch(
                f"{B} entries exceed the {B_pad}-slot sharded rung of a "
                f"{n_dev}-device mesh")
        # padding slots are request 0's entry itself: they share its
        # arrays, so its uploads and feasibility are reused, never rebuilt
        padded = list(entries) + [entries[0]] * (B_pad - B)
        # per-request trace stamps: the shared device phase is recorded on
        # every request's trace as a pre-closed "megabatch" span
        t_starts = [(e["r"].get("trace") or NULL_TRACE).now()
                    for e in entries]
        if mesh is None:
            carry_b, ys_b = self._enqueue_entries(padded, zone_key, ct_key)
        else:
            carry_b, ys_b = self._enqueue_sharded(
                padded, zone_key, ct_key, mesh)
        return PendingMegaSolve(
            solver=self, entries=entries, carry_b=carry_b, ys_b=ys_b,
            t0=t0, t_starts=t_starts, track=track, B=B, B_pad=B_pad,
            mega_key=mega_key, mesh=mesh, registry=registry,
        )

    def _block_stream(self, device, k: int, n_local: int):
        """The stream slot block ``k`` of a sharded dispatch is enqueued
        and read back on: the current stream when this rank holds one
        block, else a stream of its own per (device, block)."""
        if device.type != "cuda":
            return None
        current = torch.cuda.current_stream(device)
        if n_local == 1:
            return current
        with self._lock:
            stream = self._streams.get((str(device), k))
            if stream is None:
                stream = torch.cuda.Stream(device=device)
                self._streams[(str(device), k)] = stream
        stream.wait_stream(current)
        return stream

    def _enqueue_sharded(self, padded: Sequence[dict], zone_key: int,
                         ct_key: int, mesh):
        """Enqueue this rank's contiguous slot blocks of a padded megabatch
        (``slot_sharding``: one block per mesh entry), each on its entry's
        device and stream.  Consecutive entries on one device (virtual
        shards of one card) run as ONE block: a group loop's launches do
        not depend on its slot count, so a block per entry would multiply
        the host's launches by the shard count for no device work.  A mesh
        over k cards still issues k group loops from this thread.  Returns
        the carry and ys as :class:`ShardedArray` over the slot axis (None
        for a rank holding no entry)."""
        from ..parallel.mesh import Shard, ShardedArray, _rank, slot_sharding

        # ktlint: allow[KT011] slot_sharding is memoized per mesh (an
        # lru_cache in parallel/mesh.py): a per-flush lookup of the layout
        # built once, not a construction
        sh = slot_sharding(mesh)
        me = _rank()
        runs: List[list] = []  # [device, start, stop] per run of entries
        for _pos, dev, proc, idx in sh.shard_indices((len(padded),)):
            if proc != me:
                continue
            if runs and runs[-1][0] == dev and runs[-1][2] == idx[0].start:
                runs[-1][2] = idx[0].stop
            else:
                runs.append([dev, idx[0].start, idx[0].stop])
        blocks = []
        for k, (dev, start, stop) in enumerate(runs):
            stream = self._block_stream(dev, k, len(runs))
            with _on_stream(stream):
                carry, ys = self._enqueue_entries(
                    padded[start:stop], zone_key, ct_key, device=dev)
            blocks.append(((slice(start, stop),), dev, stream, carry, ys))
        if not blocks:
            return None, None

        def sharded(pick):
            t0 = pick(blocks[0])
            shards = [Shard(b[0], b[1], pick(b), b[2]) for b in blocks]
            return ShardedArray((len(padded),) + tuple(t0.shape[1:]),
                                t0.dtype, sh, shards)

        n_carry = len(blocks[0][3])
        carry_b = tuple(sharded(lambda b, k=k: b[3][k])
                        for k in range(n_carry))
        ys_b = (sharded(lambda b: b[4]) if blocks[0][4] is not None
                else None)
        return carry_b, ys_b

    def solve_many(
        self,
        requests: Sequence[dict],
        *,
        min_slots: Optional[int] = None,
        mesh=None,
    ) -> List[object]:
        """Synchronous megabatch: :meth:`solve_many_async` + the one
        batch-wide read.  Returns one entry per request IN ORDER: a
        :class:`TpuSolveOutput`, or the Exception that request alone hit —
        a bad slot must not poison its batchmates.  Per-request
        ``solve_ms`` is the megabatch wall time (dispatch to read-back)."""
        if not requests:
            return []
        return self.solve_many_async(
            requests, min_slots=min_slots, mesh=mesh).results()

    def solve_delta(
        self,
        prev: SolveResult,
        added: Sequence = (),
        removed: Sequence[str] = (),
        iced: Sequence[object] = (),
        *,
        provisioners,
        instance_types,
        daemonsets: Sequence = (),
        unavailable=None,
        max_delta_frac: Optional[float] = None,
        force_full: bool = False,
        tensorize_cache=None,
        registry=None,
        trace=None,
    ):
        """Warm-start delta solve: reuse ``prev``'s assignment and solve only
        the displaced subproblem (solver/warmstart.py has the tiering and
        guards).  ``added`` are new pods, ``removed`` pod names leaving,
        ``iced`` newly unavailable offerings or reclaimed node names.  The
        displaced subproblem is seeded from the surviving nodes (their
        residual capacity, selector counts, zone counters and provisioner
        usage); a ``TensorizeCache`` reuses its catalog-side context
        across the chain.  Consumes ``prev``; returns a ``DeltaOutcome``.
        Device-expressible batches only — :meth:`BatchScheduler.solve_delta`
        brings the full fallback ladder."""
        from ..models.tensorize import tensorize as _tensorize
        from . import warmstart

        def _tz(pods, unavail):
            if tensorize_cache is not None:
                st, _tier = tensorize_cache.tensorize(
                    pods, provisioners, instance_types,
                    daemonsets=daemonsets, unavailable=unavail,
                )
                return st
            return _tensorize(pods, provisioners, instance_types,
                              daemonsets=daemonsets, unavailable=unavail)

        def _solve(pods, existing, unavail):
            st = _tz(pods, unavail)
            out = self.solve(
                st, existing_nodes=existing,
                max_nodes=len(existing) + len(pods), trace=trace,
            )
            return out.result

        return warmstart.delta_solve(
            prev, added, removed, iced,
            solve_displaced=_solve, solve_full=_solve,
            max_delta_frac=max_delta_frac, registry=registry,
            unavailable=unavailable, force_full=force_full,
        )

    # ---- result extraction ---------------------------------------------
    def _extract(
        self, st, carry_np, ys_np, existing_nodes, NE, solve_ms, groups=None
    ) -> TpuSolveOutput:
        """The plan of one solve's carry.  ``groups``, where given, are the
        only groups the solve was asked to place (a hierarchical block's
        members): the other groups' pods are left out of the result
        instead of being reported infeasible."""
        (res, row_zone, row_dom, row_cand, row_price, selcnt, active,
         n_used, zc, tot, prov_used, infeasible) = [
            np.asarray(x) for x in carry_np]
        n_used = int(n_used)

        new_nodes: List[SimNode] = []
        slot_to_node: Dict[int, SimNode] = {}
        for si in range(NE, n_used):
            ci = int(row_cand[si])
            if ci < 0 or not active[si]:
                continue
            prov_name, type_name = st.cand_names[ci]
            zone = st.zone_names[int(row_zone[si])] if st.zone_names else ""
            node = SimNode(
                instance_type=type_name,
                provisioner=prov_name,
                zone=zone,
                capacity_type=self._ct_of_dom(st, int(row_dom[si])),
                price=float(row_price[si]),
                allocatable={
                    st.vocab.resources[r]: float(st.cand_alloc[ci, r])
                    for r in range(st.cand_alloc.shape[1])
                },
                existing=False,
            )
            node.stamp_labels()
            new_nodes.append(node)
            slot_to_node[si] = node

        # snapshots: placements must not leak into the caller's node objects
        snap_existing = [n.snapshot() for n in existing_nodes]
        for ni, node in enumerate(snap_existing):
            slot_to_node[ni] = node

        assignments: Dict[str, str] = {}
        infeasible_map: Dict[str, str] = {}
        node_groups: Optional[Dict[int, set]] = None
        solved = (range(len(st.groups)) if groups is None
                  else [int(gi) for gi in groups])
        if ys_np is not None:
            takes = np.asarray(ys_np)  # [G, NR]
            node_groups = {}
            for gi in solved:
                g = st.groups[gi]
                placed_slots = np.nonzero(takes[gi])[0]
                pod_iter = iter(g.pods)
                for si in placed_slots:
                    node = slot_to_node.get(int(si))
                    if node is not None:
                        node_groups.setdefault(id(node), set()).add(gi)
                    for _ in range(int(takes[gi, si])):
                        try:
                            pod = next(pod_iter)
                        except StopIteration:
                            break
                        assignments[pod.name] = node.name if node else f"slot-{si}"
                        if node is not None:
                            node.pods.append(pod)
                for pod in pod_iter:
                    infeasible_map[pod.name] = "solver: no feasible placement"
        else:
            takes = None
            for gi in solved:
                g = st.groups[gi]
                k = int(infeasible[gi])
                for pod in g.pods[len(g.pods) - k:]:
                    infeasible_map[pod.name] = "solver: no feasible placement"

        # cost-neutral coalescing: merge small new nodes into larger types at
        # <= the same price (solver/coalesce.py)
        from .coalesce import apply_coalesce

        used_rows = {}
        for si, node in slot_to_node.items():
            if si >= NE:  # slots >= NE are exactly the new_nodes entries
                ci = int(row_cand[si])
                used_rows[id(node)] = (
                    np.asarray(st.cand_alloc[ci], dtype=np.float64)
                    - np.asarray(res[si], dtype=np.float64)
                )
        new_nodes = apply_coalesce(st, new_nodes, used_rows, node_groups,
                                   assignments)

        result = SolveResult(
            nodes=new_nodes,
            assignments=assignments,
            infeasible=infeasible_map,
            existing_nodes=snap_existing,
            solve_ms=solve_ms,
        )
        return TpuSolveOutput(
            result=result, takes=takes, n_used=n_used, solve_ms=solve_ms,
        )

    @staticmethod
    def _ct_of_dom(st, di: int) -> str:
        # tensorize builds domains zone-major: d = z * |ct| + ct_index
        n_ct = max(1, len(st.ct_names))
        if di < 0:
            return ""
        return st.ct_names[di % n_ct]


def _dispatch_stream(device):
    """The stream a dispatch was enqueued on (None on the host): the
    read-back runs on it, whichever thread resolves the handle, so every
    dispatch keeps one stream from upload to read."""
    if device.type != "cuda":
        return None
    return torch.cuda.current_stream(device)


def _on_stream(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class PendingTpuSolve:
    """Handle for an async-dispatched device solve (``TpuSolver.solve_async``).

    ``result()`` reads back (the one device-to-host read of the dispatch)
    and extracts; its ``solve_ms`` spans dispatch start to read-back
    completion.  Idempotent and safe to call from any thread; the
    slot-exhaustion retry matches ``solve``."""

    def __init__(self, solver, st, existing_nodes, NE, carry, ys, t0, track,
                 est_dims, full_dims, full_nr, raise_on_exhaust,
                 solve_kwargs, trace=NULL_TRACE) -> None:
        self.solver = solver
        self.trace = trace
        self.st = st
        self.existing_nodes = existing_nodes
        self.NE = NE
        self.carry = carry
        self.ys = ys
        self.t0 = t0
        self.track = track
        self.est_dims = est_dims
        self.full_dims = full_dims
        self.full_nr = full_nr
        self.raise_on_exhaust = raise_on_exhaust
        self.solve_kwargs = solve_kwargs
        self.stream = _dispatch_stream(solver.device)
        self._lock = threading.Lock()
        self._out: Optional[TpuSolveOutput] = None

    # ktlint: fence result() IS the async handle's one device-to-host read
    def result(self) -> TpuSolveOutput:
        with self._lock:
            if self._out is None:
                self._out = self._resolve()
            return self._out

    def _resolve(self) -> TpuSolveOutput:
        s = self.solver
        with self.trace.span("device_fence"), _on_stream(self.stream):
            with self.trace.span("device_readback"):
                carry_np, ys_np = s._read_back(self.carry, self.ys)
        elapsed_ms = (time.perf_counter() - self.t0) * 1000.0
        s._mark_ready(_dims_key(self.full_dims if self.full_nr
                                else self.est_dims))
        carry = tuple(x[0] for x in carry_np)
        retried = s._maybe_retry_exhausted(
            carry, self.est_dims, self.full_dims, self.full_nr,
            self.raise_on_exhaust,
            lambda: s.solve(self.st, full_nr=True, **self.solve_kwargs),
        )
        if retried is not None:
            return retried
        with self.trace.span("extract"):
            return s._extract(
                self.st, carry,
                ys_np[0] if self.track and ys_np is not None else None,
                self.existing_nodes, self.NE, elapsed_ms)


class PendingMegaSolve:
    """Handle for an async-dispatched megabatch (``solve_many_async``):
    ``results()`` is the ONE batch-wide device-to-host read, then per-slot
    extraction; one output per real request, in order (a
    :class:`TpuSolveOutput`, or the exception that slot alone hit).

    On a meshed dispatch in a multi-process job the read is a per-host
    fence: only this rank's slot blocks are read back
    (:func:`read_slot_rows`), and slots another rank owns resolve to a
    typed :class:`~karpenter_tpu_torch.parallel.forward.SlotNotOwned`
    naming the owner; ``owned_slots``, ``fence_bytes_read`` and
    ``fence_bytes_total`` record what was read.  Idempotent and safe to
    call from any thread: the first caller reads, later ones get the
    cached outputs; per-slot slot-exhaustion semantics match
    ``solve_many`` (an exhausted slot re-solves on the meshed program)."""

    def __init__(self, solver, entries, carry_b, ys_b, t0, t_starts, track,
                 B, B_pad, mega_key, mesh=None,
                 registry=None) -> None:
        self.solver = solver
        self.entries = entries
        self.carry_b = carry_b
        self.ys_b = ys_b
        self.t0 = t0
        self.t_starts = t_starts
        self.track = track
        self.B = B
        self.B_pad = B_pad
        self.mega_key = mega_key
        self.mesh = mesh
        self.registry = registry
        #: per-host fence accounting, set by results(): bytes this rank
        #: read vs what a whole-batch read would have, and the
        #: [start, stop) slot range it owns
        self.fence_bytes_read = 0
        self.fence_bytes_total = 0
        self.owned_slots: Tuple[int, int] = (0, B_pad)
        self.stream = _dispatch_stream(solver.device)
        self._lock = threading.Lock()
        self._outputs: Optional[List[object]] = None

    # ktlint: fence the megabatch handle's one device-to-host read completes
    # ALL slots of the dispatch
    def results(self) -> List[object]:
        with self._lock:
            if self._outputs is None:
                self._outputs = self._resolve()
            return self._outputs

    def _resolve(self) -> List[object]:
        from ..parallel.forward import SlotNotOwned

        s = self.solver
        # per-host fence: a meshed dispatch reads only this rank's slot
        # blocks (a single-process mesh owns them all); KT_MULTIHOST=0
        # forces the whole-batch read
        per_host = self.mesh is not None and multihost_fence_enabled()
        owners: Optional[tuple] = None
        if per_host:
            from ..parallel.mesh import local_slot_range, multihost, slot_hosts

            if multihost(self.mesh):
                owners = slot_hosts(self.mesh, self.B_pad)
                self.owned_slots = local_slot_range(self.mesh, self.B_pad)
        carry_rows: List[dict] = [{} for _ in range(12)]
        ys_rows = None
        if self.carry_b is not None:
            arrays = list(self.carry_b)
            if self.track:
                arrays.append(self.ys_b)
            s._fence()
            with _on_stream(self.stream):
                rows, self.fence_bytes_read, self.fence_bytes_total = \
                    read_slot_rows(arrays, local_only=per_host)
            carry_rows = rows[:len(self.carry_b)]
            ys_rows = rows[-1] if self.track else None
        elapsed_ms = (time.perf_counter() - self.t0) * 1000.0
        s._mark_ready(self.mega_key)
        if per_host and self.registry is not None:
            from ..metrics import MULTIHOST_FENCE_BYTES

            c = self.registry.counter(MULTIHOST_FENCE_BYTES)
            c.inc({"scope": "read"}, value=float(self.fence_bytes_read))
            c.inc({"scope": "whole"}, value=float(self.fence_bytes_total))
        lo, hi = self.owned_slots
        outputs: List[object] = []
        for i, e in enumerate(self.entries):
            r = e["r"]
            trace = r.get("trace") or NULL_TRACE
            trace.record(
                "megabatch", self.t_starts[i], trace.now(),
                slot=i, slots=self.B_pad, occupied=self.B,
            )
            if not (lo <= i < hi):
                # another rank's slot: this process read none of it — a
                # typed per-slot outcome the serving layer's forwarding
                # shim (parallel/forward.py) routes to the owner
                outputs.append(SlotNotOwned(i, owners[i] if owners else -1))
                continue
            carry_i = tuple(x[i] for x in carry_rows)
            ys_i = ys_rows[i] if ys_rows is not None else None
            try:
                retried = None
                if "est_dims" in e:
                    retried = s._maybe_retry_exhausted(
                        carry_i, e["est_dims"], e["full_dims"], e["full_nr"],
                        r.get("raise_on_exhaust", False),
                        lambda r=r: s.solve(
                            r["st"], existing_nodes=r["existing_nodes"],
                            max_nodes=r["max_nodes"],
                            track_assignments=r["track_assignments"],
                            mesh=self.mesh, full_nr=True,
                        ),
                    )
            # ktlint: allow[KT005] per-slot boxed outcome: the exhausted
            # slot's exception is returned in its slot so batchmates still
            # get their results; the caller re-raises per request
            except Exception as err:
                outputs.append(err)
                continue
            if retried is not None:
                outputs.append(retried)
                continue
            with trace.span("extract", slot=i):
                outputs.append(s._extract(
                    r["st"], carry_i, ys_i, r["existing_nodes"], e["NE"],
                    elapsed_ms, groups=r.get("groups"),
                ))
        if owners is not None and self.registry is not None:
            from ..metrics import MULTIHOST_SLOTS

            n_foreign = sum(1 for o in outputs
                            if isinstance(o, SlotNotOwned))
            slots_c = self.registry.counter(MULTIHOST_SLOTS)
            slots_c.inc({"ownership": "foreign"}, value=float(n_foreign))
            slots_c.inc({"ownership": "owned"},
                        value=float(len(outputs) - n_foreign))
        return outputs


def solve_tensors(st: SolveTensors, *, device=None, **kw) -> TpuSolveOutput:
    """One solve on a fresh solver: ``device=None`` is the CUDA card; the
    keywords (``measure`` among them) are :meth:`TpuSolver.solve`'s."""
    return TpuSolver(device=device).solve(st, **kw)
