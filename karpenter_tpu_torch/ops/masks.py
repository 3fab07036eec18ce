"""Small tensor ops shared by the solvers, in PyTorch.

The building blocks the device solve composes: packed-bitmask requirement
tests, lexicographic argmin (deterministic tie-breaking that mirrors the
oracle's (score, price, candidate, offering) ordering), integer
water-filling for topology-spread balancing, and first-fit prefix
allocation.  Every op takes any number of leading batch axes (the solve's
request-slot axis) and works along its LAST axis; per-row scalars
(``total``, ``quota``, ``skew``) carry the leading axes only.

Counterparts of the reference package's ``ops/masks.py`` with the same
constants: 40 bisection rounds in :func:`water_fill`, 48 in
:func:`skew_band_fill`, and the ``BIG = 3.4e38`` float32 sentinel.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = float(np.float32(3.4e38))


def gather_pm_bits(pm_g: torch.Tensor, vw: torch.Tensor,
                   vb: torch.Tensor) -> torch.Tensor:
    """pm_g: [..., K, W] packed words (int64 holding uint32 values);
    vw/vb: [C, K] word/bit index -> [..., C, K] bool bit tests."""
    lead = pm_g.shape[:-2]
    K = pm_g.shape[-2]
    C = vw.shape[0]
    idx = vw.t().to(torch.int64).expand(*lead, K, C)
    words = torch.gather(pm_g, -1, idx)                  # [..., K, C]
    bits = (words >> vb.t().to(torch.int64)) & 1
    return bits.to(torch.bool).transpose(-1, -2)         # [..., C, K]


def lex_argmin(*keys: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """Index of the lexicographic minimum across equally-shaped float keys,
    over every axis after the first ``batch_dims`` (flattened, row-major).

    Mirrors Python tuple-comparison ordering; later keys break ties.  Ties
    remaining after the last key resolve to the lowest index (the first
    ``True`` of the surviving mask)."""
    lead = keys[0].shape[:batch_dims]
    flat = [k.reshape(*lead, -1).to(torch.float32) for k in keys]
    mask = torch.ones_like(flat[0], dtype=torch.bool)
    for k in flat:
        cur = torch.where(mask, k, BIG)
        m = cur.amin(dim=-1, keepdim=True)
        mask = mask & (cur <= m)
    return torch.argmax(mask.to(torch.uint8), dim=-1)  # first True


def water_fill(current: torch.Tensor, cap: torch.Tensor, total: torch.Tensor,
               eligible: torch.Tensor) -> torch.Tensor:
    """Integer water-fill: allocate ``total`` units across zones, raising the
    lowest ``current`` counts first (sequential min-count placement in closed
    form), bounded by per-zone ``cap``; ineligible zones get 0.

    Returns alloc [..., Z] int32 with sum(alloc) <= total (shortfall means
    capacity ran out).  40 rounds of bisection on the common level."""
    totalf = total.to(torch.float32)
    tot_z = totalf.unsqueeze(-1)
    cur = torch.where(eligible, current.to(torch.float32), BIG)
    capf = torch.where(eligible, cap.to(torch.float32), 0.0)
    hi = torch.where(eligible, cur, 0.0).amax(dim=-1) + totalf + 1.0
    lo = torch.zeros_like(hi)

    def alloc_at(level):
        return torch.minimum(capf, torch.clamp(level.unsqueeze(-1) - cur, min=0.0))

    for _ in range(40):
        mid = 0.5 * (lo + hi)
        done = alloc_at(mid).sum(dim=-1) >= totalf
        lo, hi = torch.where(done, lo, mid), torch.where(done, mid, hi)
    alloc = torch.floor(alloc_at(hi))
    # floor() may overshoot/undershoot by < Z units; trim deterministically
    # (highest zone index first), then top up zones with slack
    excess = torch.clamp(alloc.sum(dim=-1, keepdim=True) - tot_z, min=0.0)
    rev = alloc.flip(-1)
    pos = torch.where(rev > 0, 1.0, 0.0)
    trim = torch.cumsum(pos, dim=-1)
    take_back = torch.where(trim <= excess, pos, 0.0)
    alloc = (rev - take_back).flip(-1)
    shortfall = torch.clamp(tot_z - alloc.sum(dim=-1, keepdim=True), min=0.0)
    slack = torch.where(capf - alloc > 0, 1.0, 0.0)
    fill = torch.cumsum(slack, dim=-1)
    alloc = alloc + torch.where(fill <= shortfall, slack, 0.0)
    return torch.clamp(alloc, min=0.0).to(torch.int32)


def skew_band_fill(current: torch.Tensor, rows: torch.Tensor, cap: torch.Tensor,
                   total: torch.Tensor, skew: torch.Tensor,
                   eligible: torch.Tensor) -> torch.Tensor:
    """Skew-banded allocation that prefers FREE capacity.

    ``current`` [..., Z] pods of the selector already in each zone, ``rows``
    [..., Z] free capacity on open rows, ``cap`` [..., Z] total per-zone
    capacity (rows + new nodes), ``total`` [...] pods to place, ``skew``
    [...] max final (max-min) count skew (BIG = none).

    Final counts live in a band [t, t+skew] (capacity permitting); each
    zone's count is pushed toward ``current+rows`` WITHIN the band, and t
    is bisected (48 rounds) so the allocation sums to ``total``.  Leftover
    units level across the remaining band headroom via :func:`water_fill`."""
    cur = current.to(torch.float32)
    capf = torch.where(eligible, cap.to(torch.float32), 0.0)
    rowsf = torch.minimum(torch.where(eligible, rows.to(torch.float32), 0.0), capf)
    totalf = total.to(torch.float32)
    # f32 ulp at 1e9 is ~64, which would destroy integer precision in the
    # t+skew arithmetic below; counts never approach 1e6, so clamp there
    skewf = torch.clamp(skew.to(torch.float32), max=1e6)
    skew_z = skewf.unsqueeze(-1)
    fmax = cur + capf

    def f_of(t):
        t = t.unsqueeze(-1)
        lower = torch.minimum(torch.maximum(t, cur), fmax)
        upper = torch.minimum(torch.maximum(t + skew_z, cur), fmax)
        pref = torch.minimum(torch.maximum(cur + rowsf, lower), upper)
        return torch.where(eligible, pref, cur)

    def used(t):
        return torch.where(eligible, f_of(t) - cur, 0.0).sum(dim=-1)

    lo = -(skewf + totalf + 1.0)
    hi = torch.where(eligible, cur, 0.0).amax(dim=-1) + totalf + 1.0
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        ok = used(mid) <= totalf
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    alloc = torch.minimum(
        torch.floor(torch.clamp(f_of(lo) - cur, min=0.0) + 1e-4), capf)
    # integer remainder levels across the band's remaining headroom
    upper = torch.minimum(torch.maximum(lo.unsqueeze(-1) + skew_z, cur), fmax)
    headroom = torch.clamp(upper - (cur + alloc), min=0.0)
    rem = torch.clamp(totalf - alloc.sum(dim=-1), min=0.0)
    alloc = alloc + water_fill(cur + alloc, headroom, rem, eligible)
    return torch.clamp(alloc, min=0.0).to(torch.int32)


def prefix_allocate(cap: torch.Tensor, quota: torch.Tensor) -> torch.Tensor:
    """First-fit allocation along the last (ordered) axis: take as much as
    possible from each slot in order until ``quota`` [...] is exhausted.
    Returns take [..., N] with sum(take) == min(quota, sum(cap))."""
    before = torch.cumsum(cap, dim=-1) - cap
    return torch.minimum(
        torch.clamp(quota.unsqueeze(-1) - before, min=0.0), cap)
