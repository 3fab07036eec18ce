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

Left out of this port for now: the mesh, compile-behind warming, the fault
plane and the multi-host fence.  Eager PyTorch compiles nothing, so there
is no cold program to serve around.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
from .types import SimNode, SolveResult

BIGN = float(np.float32(1e9))  # "unbounded" node/pod counts

#: megabatch request-slot cap: one dispatch solves at most this many
#: independent solve requests
MEGA_MAX_SLOTS = 32


def _rung(n: int, quantum: int, linear_max: int, ratio: float = 1.5) -> int:
    """Bucket ``n`` up to a small, stable rung ladder: linear multiples of
    ``quantum`` up to ``linear_max``, then a geometric x``ratio`` ladder
    (each rung rounded to the quantum)."""
    q = quantum

    def up(m: int) -> int:
        return max(((m + q - 1) // q) * q, 1)

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
               track: bool = True, full_nr: bool = False) -> dict:
    """The padded tensor dimensions of a solve of ``st`` against ``NE``
    existing nodes with ``node_budget`` max node slots — the same rung
    bucketing as the reference, so both packages pad a batch identically.
    ``full_nr`` forces the worst-case NR axis (the slot-exhaustion retry)."""
    G_pad = _rung(st.G, 16, 128)
    C_pad = _rung(max(1, st.C), 64, 512)
    nr_slots = node_budget if full_nr else _nr_estimate(st, NE, node_budget)
    NR = _rung(max(1, nr_slots), 512, 2048)
    NE_pad = _rung(max(1, NE), 16, 64)
    S_pad = _rung(st.S, 8, 32) if st.S else 0
    P_pad = _rung(max(1, len(st.prov_names)), 4, 8)
    K, W = st.pm.shape[1], st.pm.shape[2]
    return dict(
        G=G_pad, C=C_pad, NR=NR, NE_pad=NE_pad, S=S_pad, P=P_pad,
        D=st.D, R=st.R, Z=max(1, st.n_zones), K=K, W=W, track=bool(track),
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
              flags: dict):
    """Run every group step over all slots.  ``consts`` and ``init`` are
    [B, ...] tensors; ``flags`` holds host booleans per group (``zoned_any``,
    ``zoned_all``, ``zpa_any``, ``hpa_any``) that let a step skip a branch
    no slot takes.  Returns (carry, ys[B, G, NR] int32 or None)."""
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

        req_g = requests[:, g]                     # [B, R]
        cnt = counts[:, g].to(torch.float32)       # [B]
        Fg = F[:, g]                               # [B, C]
        dok = dom_ok[:, g]                         # [B, D]
        Fd_g = Fg[:, :, None] & cand_avail & dok[:, None, :]     # [B, C, D]
        zone_safe = torch.clamp(row_zone, min=0)
        zone1h = row_zone[..., None] == zone_ar                  # [B, NR, Z]
        zone1h_safe = zone_safe[..., None] == zone_ar

        # ---- per-slot feasibility & capacity --------------------------
        safe_cand = torch.clamp(row_cand, min=0)
        safe_dom = torch.clamp(row_dom, min=0)
        rf_cand = Fd_g[ar[:, None], safe_cand, safe_dom]          # [B, NR]
        exv = ex_ok[:, g][:, ex_slot]
        rf = active & torch.where(row_cand >= 0, rf_cand, exv)

        # ---- positive pod-affinity modes A/B/C --------------------------
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
        avg_req_z = suffix_res[:, g] / cnt_z_safe[..., None]      # [B, Z, R]
        row_avg = _sel_many(avg_req_z, zone_safe)                 # [B, NR, R]
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

        # ---- new-node candidate scoring --------------------------------
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
                  & new_allowed[:, None, None])                   # [B, C, D]
        new_ok_nolim = Fd_g & take_ok & new_allowed[:, None, None]
        bfz_d = torch.gather(backfill_eq_z, 1, dom_zone)          # [B, D]
        nbf_d = torch.gather(net_backfill_frac_z, 1, dom_zone)    # [B, D]

        def pick(rem, dom_mask, prov_used_cur, tail_rem=None,
                 size_tiebreak=True, pool_rem=None):
            """argmin over (C, D & dom_mask) of price / min(fill, rem),
            where fill is the backfill-aware effective pods-per-node;
            limit feasibility from the CURRENT provisioner usage."""
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
            alloc0 = skew_band_fill(
                zc_sp, rows_z, cap_z, cnt, skew_eff, el).to(torch.float32)
            need_new = torch.clamp(
                alloc0 - torch.minimum(rows_z, alloc0), min=0.0)
            funded_new = water_fill(
                torch.zeros_like(need_new), need_new, fundable_new,
                el & (need_new > 0)).to(torch.float32)
            cap_f = torch.where(
                el, torch.minimum(rows_z + funded_new, cap_z), 0.0)
            alloc1 = skew_band_fill(
                zc_sp, torch.minimum(rows_z, cap_f), cap_f, cnt, skew_eff,
                el).to(torch.float32)
            lvl_min = torch.where(el, zc_sp + alloc1, BIGN).amin(dim=1)
            skew_cap = torch.where(
                zsp[:, None] >= 0, (lvl_min + skew_g)[:, None] - zc_sp, BIGN)
            cap_z2 = torch.minimum(cap_f, torch.clamp(skew_cap, min=0.0))
            alloc_z = skew_band_fill(
                zc_sp, torch.minimum(rows_z, cap_z2), cap_z2, cnt, skew_eff,
                el).to(torch.float32)                             # [B, Z]
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
            if zoned_all:
                take, rem_z = zoned_alloc()
            elif not zoned_any:
                take, rem_z = simple_alloc()
            else:
                take, rem_z = _select(zoned, zoned_alloc(), simple_alloc())
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
            hstate, htake = host_seed_flow(state0)
            state = _select(host_seed, hstate, state)
            take = torch.where(host_seed[:, None], htake, take)
        (res, row_zone, row_dom, row_cand, row_price, active, prov_used,
         new_take, n_used) = state

        total_take = take + new_take                              # [B, NR]
        res = res - total_take[..., None] * req_g[:, None, :]

        # ---- counters -----------------------------------------------------
        match_g = g_sel_match[:, :, g].to(torch.float32)          # [B, S]
        selcnt = selcnt + (total_take[..., None]
                           * match_g[:, None, :]).to(torch.int32)
        zone1h_safe = torch.clamp(row_zone, min=0)[..., None] == zone_ar
        placed_z = _zone_sum(torch.where(active, total_take, 0.0),
                             zone1h_safe)                         # [B, Z]
        zc = zc + (match_g[..., None] * placed_z[:, None, :]).to(torch.int32)
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


class SlotsExhausted(Exception):
    """The optimistic NR axis ran out of node slots and the caller asked not
    to retry at the full budget (``raise_on_exhaust``)."""

    def __init__(self, full_dims: tuple) -> None:
        super().__init__("node-slot estimate exhausted")
        self.full_dims = full_dims


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
    and raises without one; the tests pass ``device="cpu"``."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        # shape families whose optimistic NR estimate exhausted once: later
        # solves of the family go straight to the full-budget axis
        self._nr_exhausted: set = set()

    def _host_arrays(
        self,
        st: SolveTensors,
        existing_nodes: Sequence[SimNode],
        *,
        node_budget: int,
        track_assignments: bool,
        full_nr: bool,
        dims: Optional[dict] = None,
    ):
        """Pure-host (numpy) build of one solve's padded tensors: returns
        ``(np_consts, feas, np_init, dims)`` — the same padding/bucketing
        as the reference, so both packages build identical arrays."""
        G, C, D, R = st.G, max(1, st.C), st.D, st.R
        S, Z = st.S, max(1, st.n_zones)
        NE = len(existing_nodes)

        if dims is None:
            dims = solve_dims(st, NE=NE, node_budget=node_budget,
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
        # selector counts on existing nodes + zone counters
        for si, (sel, topo, kind) in enumerate(st.selector_defs):
            for ni, node in enumerate(existing_nodes):
                n_match = sum(1 for p in node.pods if sel.matches(p.labels))
                ex_sel[ni, si] = n_match
                zc0[si, zone_index.get(node.zone, 0)] += n_match
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
    def _stack(self, vals: List[np.ndarray], dtype=None) -> torch.Tensor:
        """Stack per-slot host arrays on the device; slots sharing one
        array object (a shared base build) transfer it once and expand."""
        first = vals[0]
        if all(v is first for v in vals[1:]):
            a = np.asarray(first)
            if not a.flags.c_contiguous:
                a = np.ascontiguousarray(a)
            t = torch.from_numpy(a).to(self.device)
            if dtype is not None:
                t = t.to(dtype)
            return t.unsqueeze(0).expand(len(vals), *t.shape)
        t = torch.from_numpy(np.stack(vals)).to(self.device)
        return t.to(dtype) if dtype is not None else t

    def _feasibility(self, feas: dict, np_consts: dict, zone_key: int,
                     ct_key: int):
        dev = self.device

        def t(a, dtype=None):
            out = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return out.to(dtype) if dtype is not None else out

        return compute_feasibility(
            t(feas["pm"], torch.int64), t(np_consts["requests"]),
            t(feas["gp_ok"]), t(feas["cand_vw"], torch.int64),
            t(feas["cand_vb"], torch.int64), t(np_consts["cand_alloc"]),
            t(np_consts["cand_prov"], torch.int64), t(feas["key_check"]),
            t(feas["dom_vw"], torch.int64), t(feas["dom_vb"], torch.int64),
            zone_key, ct_key,
        )

    def _run_entries(self, entries: Sequence[dict], zone_key: int,
                     ct_key: int):
        """One dispatch over prepared entries (all at one dims bucket):
        feasibility per distinct input set, then the batched group loop.
        Returns host (carry rows, ys rows)."""
        dims0 = entries[0]["dims"]
        if not all(e["dims"] == dims0 for e in entries):
            raise ValueError("megabatch entries span dims buckets")
        NR, Z = dims0["NR"], dims0["Z"]
        track = entries[0]["r"]["track_assignments"]
        keys = list(entries[0]["np_consts"])

        # feasibility: slots built from one base share their inputs —
        # compute once per distinct set (identity), as the reference's
        # vmapped program computes the same values per slot
        memo: Dict[tuple, tuple] = {}
        Fs, DOs = [], []
        for e in entries:
            fk = tuple(id(v) for v in e["feas"].values()) + (
                id(e["np_consts"]["requests"]),
                id(e["np_consts"]["cand_alloc"]),
                id(e["np_consts"]["cand_prov"]))
            if fk not in memo:
                memo[fk] = self._feasibility(e["feas"], e["np_consts"],
                                             zone_key, ct_key)
            Fs.append(memo[fk][0])
            DOs.append(memo[fk][1])
        consts = {}
        for k in keys:
            vals = [e["np_consts"][k] for e in entries]
            dtype = torch.int64 if k in _INDEX_CONSTS else None
            consts[k] = self._stack(vals, dtype)
        if consts["g_sel_match"].shape[1] == 0:
            # no selectors: one inert all-False slot keeps the clamped
            # selector gathers in range (every slot id is -1 anyway)
            consts["g_sel_match"] = torch.zeros(
                len(entries), 1, dims0["G"], dtype=torch.bool,
                device=self.device)
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
            init.append(self._stack(vals, dt).clone())
        if init[5].shape[2] == 0:
            B = len(entries)
            init[5] = torch.zeros(B, NR, 1, dtype=torch.int32, device=self.device)
            init[8] = torch.zeros(B, 1, Z, dtype=torch.int32, device=self.device)
            init[9] = torch.zeros(B, 1, dtype=torch.int32, device=self.device)

        flags = _branch_flags({
            k: np.stack([np.asarray(e["np_consts"][k]) for e in entries])
            for k in ("g_zone_spread", "g_zone_anti", "g_zone_paff",
                      "g_host_paff")})
        carry, ys = _run_scan(consts, tuple(init), NR, Z, track, flags)
        # the one device-to-host read of the dispatch
        carry_np = [x.cpu().numpy() for x in carry]
        ys_np = ys.cpu().numpy() if ys is not None else None
        return carry_np, ys_np

    # ---- solves ---------------------------------------------------------
    def solve(
        self,
        st: SolveTensors,
        *,
        existing_nodes: Sequence[SimNode] = (),
        max_nodes: Optional[int] = None,
        track_assignments: bool = True,
        full_nr: bool = False,
        raise_on_exhaust: bool = False,
        trace=None,
    ) -> TpuSolveOutput:
        """One device solve (a one-slot megabatch).  When the optimistic NR
        axis ran out of node slots with pods left unplaced, the solve is
        retried once at the full budget — or, with ``raise_on_exhaust``,
        :class:`SlotsExhausted` is raised instead."""
        t0 = time.perf_counter()
        trace = trace or NULL_TRACE
        NE = len(existing_nodes)
        node_budget = _node_budget(st, NE, max_nodes)
        est_dims = solve_dims(st, NE=NE, node_budget=node_budget,
                              track=track_assignments)
        full_dims = solve_dims(st, NE=NE, node_budget=node_budget,
                               track=track_assignments, full_nr=True)
        if not full_nr:
            full_nr = _dims_key(est_dims) in self._nr_exhausted
        with trace.span("device_prepare"):
            np_consts, feas, np_init, dims = self._host_arrays(
                st, existing_nodes, node_budget=node_budget,
                track_assignments=track_assignments, full_nr=full_nr)
        entry = dict(
            r=dict(st=st, existing_nodes=existing_nodes, max_nodes=max_nodes,
                   track_assignments=track_assignments),
            np_consts=np_consts, feas=feas, np_init=np_init, dims=dims)
        with trace.span("device_execute", full_nr=full_nr):
            carry_np, ys_np = self._run_entries(
                [entry], st.vocab.key_id[L.ZONE],
                st.vocab.key_id[L.CAPACITY_TYPE])
        solve_ms = (time.perf_counter() - t0) * 1000.0
        carry = tuple(x[0] for x in carry_np)

        if (not full_nr and est_dims["NR"] < full_dims["NR"]
                and int(carry[7]) >= est_dims["NR"]
                and int(carry[11].sum()) > 0):
            # slot exhaustion: remember the family, retry at full budget
            self._nr_exhausted.add(_dims_key(est_dims))
            if raise_on_exhaust:
                raise SlotsExhausted(_dims_key(full_dims))
            return self.solve(
                st, existing_nodes=existing_nodes, max_nodes=max_nodes,
                track_assignments=track_assignments, full_nr=True,
                trace=trace)

        with trace.span("extract"):
            return self._extract(
                st, carry, ys_np[0] if ys_np is not None else None,
                existing_nodes, NE, solve_ms)

    def solve_many_prepared(self, entries: Sequence[dict]) -> List[TpuSolveOutput]:
        """Solve PRE-BUILT entries (each with ``r``, ``np_consts``, ``feas``,
        ``np_init``, ``dims``, ``NE``; all at one dims bucket, full NR) as
        ONE batched dispatch; one output per entry, in order.  The
        hierarchical solve derives every block's entry from one shared base
        build (solver/hierarchy.py build_block_entries)."""
        if not entries:
            raise ValueError("empty megabatch")
        if len(entries) > MEGA_MAX_SLOTS:
            raise ValueError(
                f"{len(entries)} entries exceed MEGA_MAX_SLOTS={MEGA_MAX_SLOTS}")
        t0 = time.perf_counter()
        st0 = entries[0]["r"]["st"]
        carry_np, ys_np = self._run_entries(
            entries, st0.vocab.key_id[L.ZONE],
            st0.vocab.key_id[L.CAPACITY_TYPE])
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        outs = []
        for i, e in enumerate(entries):
            r = e["r"]
            outs.append(self._extract(
                r["st"], tuple(x[i] for x in carry_np),
                ys_np[i] if ys_np is not None else None,
                r["existing_nodes"], e["NE"], elapsed_ms))
        return outs

    # ---- result extraction ---------------------------------------------
    def _extract(
        self, st, carry, ys, existing_nodes, NE, solve_ms
    ) -> TpuSolveOutput:
        (res, row_zone, row_dom, row_cand, row_price, selcnt, active,
         n_used, zc, tot, prov_used, infeasible) = [np.asarray(x) for x in carry]
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
        if ys is not None:
            takes = np.asarray(ys)  # [G, NR]
            node_groups = {}
            for gi, g in enumerate(st.groups):
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
            for gi, g in enumerate(st.groups):
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


def solve_tensors(st: SolveTensors, *, device=None, **kw) -> TpuSolveOutput:
    """One solve on a fresh solver: ``device=None`` is the CUDA card."""
    return TpuSolver(device=device).solve(st, **kw)
