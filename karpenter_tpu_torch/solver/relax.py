"""Convex-relaxation refinement rung — better-than-FFD node cost, on the card.

The port of the reference package's ``solver/relax.py``.  The flat scan
(solver/tpu.py) is sequential first-fit-decreasing over pod groups: it
commits each group to its locally-cheapest candidate and never
re-decides, so a cpu-heavy and a memory-heavy group each buy their own
density-optimal fleet where sharing a balanced node type would be
cheaper.  The rung re-packs the large unconstrained groups globally and
ships whichever of {scan, relax+round} costs strictly less.

- **The relaxation is a fixed-iteration device program** (``_relax_program``,
  plain PyTorch on the scheduler's device).  Variables ``x[g, c]`` —
  fractional pods of group ``g`` on candidate ``c`` — minimize the
  fractional node cost ``sum_c price_c * max_r(load_cr / alloc_cr)`` by
  entropic mirror descent on the per-group scaled simplexes:
  multiplicative weights with a range-normalised subgradient, the
  ``max_r`` smoothed by a softmax of sharpness ``_TAU``, the best
  true-cost iterate tracked on the device.  One Python loop of
  ``relax_iters`` steps with no host read inside; one copy back of
  ``(best_x, best_cost)`` at the end (``_run_relax``).  Shapes pad to the
  scan's own ``solve_dims`` G/C rungs (``relax_dims``).
- **Rounding reaches integrality on the host, repair seeds the scan.**
  Largest-remainder integerisation per group, proportional group mixes
  per bought node, first-fit of stranded pods into open rounded
  capacity, and any remainder through the caller's ``repair_solve``
  hook: the scheduler's own solve, seeded with the rounded fleet as
  existing nodes.
- **Never worse by construction.**  Only unconstrained, unwatched,
  unpinned, non-gang groups fully seated on solver-proposed nodes are
  lifted; constraint-bearing pods keep their scan seats.  The rounded
  fleet is self-validated before repair, and the scan's plan ships
  unless the rung's costs strictly less:
  ``karpenter_solver_relax_total{outcome=improved|tied|fallback|skipped}``
  counts every evaluation.

Knobs: ``KT_RELAX`` (default on) gates the rung, ``KT_RELAX_ITERS``
(default 64, bucketed up to ``RELAX_ITER_RUNGS``) sets the descent
budget, ``KT_RELAX_DELTA`` (default off) is the reference's delta-chain
opt-in (the port has no delta chain yet).  The reference's compile-behind
bookkeeping (``relax_signature``, ``warm_relax``) has no counterpart
here: the port compiles nothing, so the first solve of a shape runs the
rung.  The host parts are numpy, copied from the reference.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..device import ProgramRuns, resolve_device
from ..gang import gang_fixed
from ..metrics import (
    RELAX_DURATION,
    RELAX_IMPROVEMENT,
    RELAX_OUTCOMES,
    RELAX_TOTAL,
    Registry,
    registry as default_registry,
)
from ..models import labels as L
from ..obs.trace import NULL_TRACE
from .types import SimNode, SolveResult

logger = logging.getLogger(__name__)

#: iteration-count rungs: KT_RELAX_ITERS buckets UP onto this ladder
#: (smallest rung >= the ask; the top rung caps it)
RELAX_ITER_RUNGS = (32, 64, 128, 256)
DEFAULT_RELAX_ITERS = 64

#: softmax sharpness smoothing the per-candidate max_r bottleneck; the
#: best-TRUE-cost iterate tracking makes the smoothing a descent aid,
#: never a correctness input
_TAU = 64.0
#: mirror-descent step on the range-normalized subgradient
_ETA = np.float32(1.0)

#: device runs of the relax program, per device type
RELAX_PROGRAM = ProgramRuns("relax_program")


def mirror_eta(t) -> np.float32:
    """Step size η/√(1+t/8) of the mirror-descent ladder at iteration ``t``,
    in float32 (the reference evaluates it on a float32 scalar).  The relax
    descent and the hierarchical price ascent share it."""
    t = np.float32(t)
    return np.float32(_ETA / np.sqrt(np.float32(1.0) + t / np.float32(8.0)))


def relax_enabled() -> bool:
    return os.environ.get("KT_RELAX", "1") != "0"


def relax_delta_enabled() -> bool:
    """Whether delta-chain FULL-solve boundaries run the rung (default
    off: a delta chain is the latency path; KT_RELAX_DELTA=1 opts in)."""
    return os.environ.get("KT_RELAX_DELTA", "0") == "1"


def configured_iters() -> int:
    """The live iteration budget, read through the knob registry
    (tuning/knobs.py): a tuned override wins, else the registry falls back
    to ``KT_RELAX_ITERS``/the default at call time, so env workflows are
    untouched until something moves the knob."""
    from ..tuning.knobs import global_knobs

    try:
        return int(global_knobs().get("relax_iters"))
    except (TypeError, ValueError):
        return DEFAULT_RELAX_ITERS


def iter_rung(n: int) -> int:
    """Bucket an iteration ask UP onto RELAX_ITER_RUNGS (top rung caps)."""
    for r in RELAX_ITER_RUNGS:
        if n <= r:
            return r
    return RELAX_ITER_RUNGS[-1]


def relax_dims(st) -> dict:
    """The relax program's padded dims: the G/C rungs of the scan's own
    ``solve_dims`` bucketing (delegated) plus the resource width."""
    from .tpu import solve_dims

    # NE/node_budget only shape the NR axis, which the relax program does
    # not carry; the minimal budget keeps the delegate's estimate cheap
    dims = solve_dims(st, NE=0, node_budget=1)
    return dict(G=dims["G"], C=dims["C"], R=dims["R"])


def zero_init_metrics(registry: Registry) -> None:
    """Register the relax series at 0 so the first evaluation is never
    lost to a rate()."""
    for outcome in RELAX_OUTCOMES:
        if not registry.counter(RELAX_TOTAL).has({"outcome": outcome}):
            registry.counter(RELAX_TOTAL).inc({"outcome": outcome},
                                              value=0.0)
    registry.histogram(RELAX_DURATION)
    if not registry.gauge(RELAX_IMPROVEMENT).has():
        # 1.0 = parity (no comparison yet)
        registry.gauge(RELAX_IMPROVEMENT).set(1.0)


def record_outcome(registry: Registry, outcome: str,
                   seconds: Optional[float] = None,
                   ratio: Optional[float] = None) -> None:
    registry.counter(RELAX_TOTAL).inc({"outcome": outcome})
    if seconds is not None:
        registry.histogram(RELAX_DURATION).observe(seconds)
    if ratio is not None:
        registry.gauge(RELAX_IMPROVEMENT).set(ratio)


# ---------------------------------------------------------------------------
# the device program
# ---------------------------------------------------------------------------
#
# The descent is chaotic in float32: the sharp softmax and the
# multiplicative step amplify a one-ulp difference into a different
# iterate within a few dozen steps, so a plain PyTorch transcription of
# the reference's program (library matmul, softmax and exp) drifts away
# from it and from itself on another device.  So the program below
# reproduces, with elementwise PyTorch operations only, the float32
# arithmetic the reference's program performs on an x86-64 CPU: the same
# operation order and rounding, dot products as sequential fused
# multiply-adds, sums over the candidate axis in windows of 32, exp as the
# reference's polynomial, subnormal results flushed to zero.  It gives
# the same bits on the CPU and on a CUDA card (no library reduction,
# whose order differs by device).

def _f32(bits: int) -> float:
    """The float32 with IEEE bit pattern ``bits``, as a Python float."""
    return float(np.array([bits], dtype=np.uint32).view(np.float32)[0])


#: η/√(1+t/8) for t = 0..255 as the reference's compiled program evaluates
#: it on x86-64 (hardware reciprocal-square-root estimate and two Newton
#: steps; some entries are one ulp off the correctly rounded float32).
#: Covers every iteration of the top rung of RELAX_ITER_RUNGS.
_ETA_BITS = (
    0x3F800000, 0x3F715BEF, 0x3F64F92E, 0x3F5A514A, 0x3F5105EC, 0x3F48D2AB,
    0x3F41848F, 0x3F3AF4BA, 0x3F3504F3, 0x3F2F9D53, 0x3F2AAAAB, 0x3F261D5F,
    0x3F21E89B, 0x3F1E01B2, 0x3F1A5FB2, 0x3F16FB06, 0x3F13CD3A, 0x3F10D0C3,
    0x3F0E00D5, 0x3F0B5948, 0x3F08D677, 0x3F067531, 0x3F0432A5, 0x3F020C52,
    0x3F000000, 0x3EFC1764, 0x3EF85B42, 0x3EF4C867, 0x3EF15BEF, 0x3EEE133E,
    0x3EEAEBF5, 0x3EE7E3ED, 0x3EE4F92E, 0x3EE229ED, 0x3EDF7483, 0x3EDCD76E,
    0x3EDA514A, 0x3ED7E0CF, 0x3ED584CD, 0x3ED33C2E, 0x3ED105EC, 0x3ECEE116,
    0x3ECCCCCD, 0x3ECAC83F, 0x3EC8D2AB, 0x3EC6EB5A, 0x3EC511A3, 0x3EC344E6,
    0x3EC1848F, 0x3EBFD012, 0x3EBE26EB, 0x3EBC889F, 0x3EBAF4BA, 0x3EB96ACE,
    0x3EB7EA74, 0x3EB67349, 0x3EB504F3, 0x3EB39F1A, 0x3EB2416A, 0x3EB0EB96,
    0x3EAF9D53, 0x3EAE565C, 0x3EAD166C, 0x3EABDD46, 0x3EAAAAAB, 0x3EA97E62,
    0x3EA85835, 0x3EA737F0, 0x3EA61D5F, 0x3EA50855, 0x3EA3F8A3, 0x3EA2EE1D,
    0x3EA1E89B, 0x3EA0E7F5, 0x3E9FEC04, 0x3E9EF4A4, 0x3E9E01B2, 0x3E9D130E,
    0x3E9C2896, 0x3E9B422C, 0x3E9A5FB2, 0x3E99810C, 0x3E98A61F, 0x3E97CED0,
    0x3E96FB06, 0x3E962AA9, 0x3E955DA2, 0x3E9493D9, 0x3E93CD3A, 0x3E9309AF,
    0x3E924925, 0x3E918B87, 0x3E90D0C3, 0x3E9018C7, 0x3E8F6381, 0x3E8EB0E0,
    0x3E8E00D5, 0x3E8D534F, 0x3E8CA840, 0x3E8BFF97, 0x3E8B5948, 0x3E8AB544,
    0x3E8A137D, 0x3E8973E8, 0x3E88D677, 0x3E883B1E, 0x3E87A1D2, 0x3E870A87,
    0x3E867531, 0x3E85E1C7, 0x3E85503E, 0x3E84C08B, 0x3E8432A5, 0x3E83A682,
    0x3E831C19, 0x3E829362, 0x3E820C52, 0x3E8186E3, 0x3E81030A, 0x3E8080C1,
    0x3E800000, 0x3E7F017E, 0x3E7E05ED, 0x3E7D0D3E, 0x3E7C1764, 0x3E7B2452,
    0x3E7A33F9, 0x3E79464E, 0x3E785B42, 0x3E7772CB, 0x3E768CDC, 0x3E75A969,
    0x3E74C867, 0x3E73E9CB, 0x3E730D8A, 0x3E723399, 0x3E715BEF, 0x3E708681,
    0x3E6FB345, 0x3E6EE232, 0x3E6E133E, 0x3E6D4661, 0x3E6C7B90, 0x3E6BB2C4,
    0x3E6AEBF5, 0x3E6A271A, 0x3E696429, 0x3E68A31D, 0x3E67E3ED, 0x3E672691,
    0x3E666B02, 0x3E65B139, 0x3E64F92E, 0x3E6442DB, 0x3E638E39, 0x3E62DB41,
    0x3E6229ED, 0x3E617A36, 0x3E60CC15, 0x3E601F87, 0x3E5F7483, 0x3E5ECB04,
    0x3E5E2304, 0x3E5D7C7F, 0x3E5CD76E, 0x3E5C33CC, 0x3E5B9193, 0x3E5AF0BF,
    0x3E5A514A, 0x3E59B330, 0x3E59166B, 0x3E587AF7, 0x3E57E0CF, 0x3E5747EF,
    0x3E56B051, 0x3E5619F2, 0x3E5584CD, 0x3E54F0DF, 0x3E545E22, 0x3E53CC93,
    0x3E533C2E, 0x3E52ACEE, 0x3E521ED1, 0x3E5191D1, 0x3E5105EC, 0x3E507B1D,
    0x3E4FF161, 0x3E4F68B6, 0x3E4EE116, 0x3E4E5A7F, 0x3E4DD4ED, 0x3E4D505E,
    0x3E4CCCCD, 0x3E4C4A38, 0x3E4BC89B, 0x3E4B47F4, 0x3E4AC83F, 0x3E4A497A,
    0x3E49CBA1, 0x3E494EB3, 0x3E48D2AB, 0x3E485787, 0x3E47DD45, 0x3E4763E2,
    0x3E46EB5A, 0x3E4673AC, 0x3E45FCD6, 0x3E4586D3, 0x3E4511A3, 0x3E449D42,
    0x3E4429AF, 0x3E43B6E6, 0x3E4344E6, 0x3E42D3AD, 0x3E426337, 0x3E41F383,
    0x3E41848F, 0x3E411659, 0x3E40A8DE, 0x3E403C1C, 0x3E3FD012, 0x3E3F64BD,
    0x3E3EFA1C, 0x3E3E902C, 0x3E3E26EB, 0x3E3DBE58, 0x3E3D5672, 0x3E3CEF34,
    0x3E3C889F, 0x3E3C22B1, 0x3E3BBD67, 0x3E3B58C0, 0x3E3AF4BA, 0x3E3A9154,
    0x3E3A2E8C, 0x3E39CC60, 0x3E396ACE, 0x3E3909D6, 0x3E38A975, 0x3E3849AA,
    0x3E37EA74, 0x3E378BD1, 0x3E372DBE, 0x3E36D03D, 0x3E367349, 0x3E3616E4,
    0x3E35BB09, 0x3E355FBA, 0x3E3504F3, 0x3E34AAB4, 0x3E3450FC, 0x3E33F7C9,
    0x3E339F1A, 0x3E3346ED, 0x3E32EF41, 0x3E329816,
)
_ETA_TABLE = tuple(_f32(b) for b in _ETA_BITS)

#: float32 constants of the reference's exp: input clamp, log2(e), ln(2)
#: in two parts, and the polynomial's coefficients
_EXP_LO, _EXP_HI = _f32(0xC2AF999A), _f32(0x42B1999A)
_LOG2E = _f32(0x3FB8AA3B)
_LN2_HI, _LN2_LO = _f32(0x3F318000), _f32(0xB95E8083)
_EXP_P = tuple(_f32(b) for b in (0x39506967, 0x3AB743CE, 0x3C088908,
                                 0x3D2AA9C1, 0x3E2AAAAA)) + (0.5,)
#: smallest normal float32: smaller magnitudes flush to zero
_TINY = 2.0 ** -126


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """Flush subnormal values to zero."""
    return t.masked_fill(t.abs() < _TINY, 0.0)


def _round32(s: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """float32 rounding of the exact value ``s + err`` (float64 ``s`` and
    its rounding error ``err``): ``s`` is first moved to its odd float64
    neighbour toward the exact value when inexact (round to odd), so the
    one rounding to float32 is correct even where ``s`` fell on a float32
    midpoint."""
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(even & (err.abs() > 0), torch.nextafter(s, toward),
                       s).float()


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding.  The product of two float32
    is exact in float64; the float64 sum's rounding error comes from
    Knuth's two-sum, and :func:`_round32` rounds the exact sum."""
    # ktlint: allow[KT006] the float32 product is exact in float64: the
    # bits of the reference CPU program's FMA (tests/test_torch_relax.py)
    p = a.double() * b
    # ktlint: allow[KT006] the exact sum, rounded once by _round32
    return _sum_round32(p, c.double() if torch.is_tensor(c) else c)


def _sum_round32(p: torch.Tensor, c) -> torch.Tensor:
    """float32 rounding of the exact sum of float64 ``p`` and ``c``."""
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    return _round32(s, err)


def _exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as the reference program computes it: clamp to
    [-87.8, 88.8], split off m = floor(x·log2(e) + 1/2), a degree-6
    polynomial in the remainder, scale by 2^m built from its bits, flush
    a subnormal result."""
    x = torch.where(x >= _EXP_LO, x, _EXP_LO)
    x = torch.where(x <= _EXP_HI, x, _EXP_HI)
    m = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(m, -_LN2_HI, x)
    r = _fma(m, -_LN2_LO, r)
    p = _fma(r, _EXP_P[0], _EXP_P[1])
    for coef in _EXP_P[2:]:
        p = _fma(p, r, coef)
    y = _fma(p, r * r, r) + 1.0
    two_m = ((m.to(torch.int32) + 127) << 23).view(torch.float32)
    return _ftz(y * two_m)


def _seq_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right from 0."""
    acc = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
    for i in range(t.shape[-1]):
        acc = acc + t[..., i]
    return acc


def _window_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as the reference's CPU reduction does: above
    32 elements, zero-pad evenly on both sides to a multiple of 32, sum
    each window of 32 left to right, and sum the window sums the same way."""
    n = t.shape[-1]
    if n <= 32:
        return _seq_sum(t)
    k = (n + 31) // 32
    pad = 32 * k - n
    t = torch.nn.functional.pad(t, (pad // 2, pad - pad // 2))
    return _window_sum(_seq_sum(t.reshape(*t.shape[:-1], k, 32)))


def _fma_chain(products: torch.Tensor) -> torch.Tensor:
    """Sequential fused multiply-add over the leading axis of exact
    float64 ``products``: acc = fl32(acc + p_k), from 0."""
    acc = torch.zeros(products.shape[1:], dtype=torch.float32,
                      device=products.device)
    for k in range(products.shape[0]):
        # ktlint: allow[KT006] float64 accumulator, rounded to float32 once
        # per step: the reference program's FMA chain, bit for bit
        acc = _sum_round32(products[k], acc.double())
    return _ftz(acc)


def _relax_program(req: torch.Tensor, counts: torch.Tensor,
                   feas: torch.Tensor, alloc_inv: torch.Tensor,
                   price: torch.Tensor, x0: torch.Tensor,
                   relax_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entropic mirror descent on the fractional allocation relaxation.

    ``req[G, R]`` per-pod requests, ``counts[G]`` pods per group (0 for
    ineligible/padding rows), ``feas[G, C]`` bool feasibility,
    ``alloc_inv[C, R]`` reciprocal candidate allocatable (0 where the
    candidate lacks the resource), ``price[C]`` effective $/hr, ``x0[G, C]``
    warm start (the scan's own solution); all float32 except ``feas``, all
    on one device.  Objective ``f(x) = sum_c price_c * max_r(load_cr *
    alloc_inv_cr)`` (convex), minimized over the per-group scaled
    simplexes by multiplicative-weights updates with a softmax of
    sharpness ``_TAU`` for the max.  Returns ``(best_x, best_cost)`` on the
    device — the best TRUE-objective iterate, so the smoothing can never
    report worse than the warm start.  The loop never reads the device;
    the best iterate is kept with ``torch.where``.  Arithmetic as the
    reference's program on a CPU (see above)."""
    if relax_iters > len(_ETA_TABLE):
        raise ValueError(f"relax_iters {relax_iters} exceeds the step "
                         f"table ({len(_ETA_TABLE)})")
    feas_f = feas.to(torch.float32)
    # ktlint: allow[KT006] exact float64 products for the FMA chains: the
    # reference CPU program's float32 bits (tests/test_torch_relax.py)
    req64 = req.double()
    price_col = price[:, None]

    def renorm(y):                                 # rows of y scaled to counts
        s = _window_sum(y)[:, None]
        d = _ftz(y / torch.clamp(s, min=1e-30))
        return torch.where(s > 1e-30, d, 0.0) * counts[:, None]

    def util(x):                                   # [C, R]
        # ktlint: allow[KT006] exact float64 products (see req64 above)
        load = _fma_chain(x.double()[:, :, None] * req64[:, None, :])
        return _ftz(load * alloc_inv)

    def cost(u):
        return _window_sum(_ftz(price * torch.amax(u, dim=1)))

    def grad(u):                                   # [G, C]
        v = u * _TAU
        e = _exp(v - torch.amax(v, dim=1, keepdim=True))
        w = _ftz(e / _seq_sum(e)[:, None])         # bottleneck mix
        m = _ftz(_ftz(price_col * w) * alloc_inv)  # [C, R]
        # ktlint: allow[KT006] exact float64 products (see req64 above)
        return _fma_chain(req64.T[:, :, None] * m.double().T[:, None, :])

    x = renorm(torch.where(feas, x0, 0.0))
    u = util(x)
    bx, bf = x, cost(u)
    for t in range(relax_iters):
        g = grad(u)
        gmin = torch.amin(torch.where(feas, g, torch.inf), dim=1,
                          keepdim=True)
        gmax = torch.amax(torch.where(feas, g, -torch.inf), dim=1,
                          keepdim=True)
        spread = torch.clamp(gmax - gmin, min=1e-12)
        step = _exp((-_ETA_TABLE[t]) * (g - gmin) / spread)
        x = renorm(_ftz(x * step) * feas_f)
        u = util(x)
        f = cost(u)
        better = f < bf
        bx = torch.where(better, x, bx)
        bf = torch.where(better, f, bf)
    return bx, bf


# ktlint: fence the relax rung's one device-to-host read — the
# refinement program's result, read once per rung
def _run_relax(req, counts, feas, alloc_inv, price, x0, relax_iters: int,
               device) -> Tuple[np.ndarray, float]:
    """Upload the numpy inputs, run the program on ``device``, and read
    ``(best_x, best_cost)`` back — the rung's one device-to-host read."""
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    RELAX_PROGRAM.add(dev)
    bx, bf = _relax_program(t(req), t(counts), t(feas), t(alloc_inv),
                            t(price), t(x0), relax_iters)
    return bx.cpu().numpy(), float(bf.cpu())


# ---------------------------------------------------------------------------
# host-side eligibility + feasibility
# ---------------------------------------------------------------------------


def _host_feasibility(st) -> np.ndarray:
    """Numpy mirror of the device feasibility (labels & fit & provisioner)
    — the same semantics as ops/feasibility's gather path, at group
    granularity ([G, C, K] bit gathers)."""
    G, C = st.G, st.C
    if G == 0 or C == 0:
        return np.zeros((G, C), dtype=bool)
    K = st.pm.shape[1]
    vw = np.asarray(st.cand_vw)                      # [C, K]
    vb = np.asarray(st.cand_vb).astype(np.uint32)
    g_idx = np.arange(G)[:, None, None]              # [G, 1, 1]
    k_idx = np.arange(K)[None, None, :]              # [1, 1, K]
    words = np.asarray(st.pm)[g_idx, k_idx, vw[None, :, :]]  # [G, C, K]
    bits = ((words >> vb[None, :, :]) & np.uint32(1)).astype(bool)
    lab = np.all(bits | ~np.asarray(st.key_check)[None, None, :], axis=2)
    req = np.asarray(st.requests, dtype=np.float32)  # [G, R]
    alloc = np.asarray(st.cand_alloc, dtype=np.float32)
    fit = np.all((req[:, None, :] <= alloc[None, :, :] + 1e-6)
                 | (req[:, None, :] <= 0), axis=2)
    gp = np.asarray(st.gp_ok)[np.arange(G)[:, None],
                              np.asarray(st.cand_prov)[None, :]]
    return lab & fit & gp


def _host_dom_ok(st) -> np.ndarray:
    """Numpy mirror of the device per-group domain allowance [G, D]."""
    zone_key = st.vocab.key_id[L.ZONE]
    ct_key = st.vocab.key_id[L.CAPACITY_TYPE]
    pm = np.asarray(st.pm)
    dom_vw = np.asarray(st.dom_vw)
    dom_vb = np.asarray(st.dom_vb).astype(np.uint32)
    zw = pm[:, zone_key, :][:, dom_vw[:, 0]]         # [G, D]
    zok = ((zw >> dom_vb[None, :, 0]) & np.uint32(1)).astype(bool)
    cw = pm[:, ct_key, :][:, dom_vw[:, 1]]
    cok = ((cw >> dom_vb[None, :, 1]) & np.uint32(1)).astype(bool)
    return zok & cok


def eligible_partition(st, result: SolveResult):
    """Partition the solved batch for the rung.

    Returns ``(elig, freed, lifted, seats)``: the group indexes with
    lifted pods, the freed solver-proposed node names the rung may
    re-pack, ``lifted[gi] -> [pods]`` — exactly the pods the rung
    re-seats — and ``seats[node] -> {gi: pods}`` over the freed nodes
    (the scan-solution warm start ``x0`` derives from it).

    A group is STATICALLY eligible iff it is unconstrained (no spread /
    hostname cap / (anti-)affinity slots, no volume or daemonset
    coupling, every available zone+capacity-type domain allowed — no
    pinning) and UNWATCHED (no constraint selector of any group matches
    its pods — re-seating a watched pod silently changes someone else's
    spread count).  A node is freed
    iff EVERY pod seated on it belongs to a statically-eligible group (a
    mixed node stays whole — its constrained pods are boundary conditions
    and lifting only its unconstrained pods would strand slack the cost
    compare can't win back).  The rung lifts exactly the pods on freed
    nodes: eligible pods backfilled onto constrained or existing nodes
    keep their seats, so constraint-bearing placements are never
    disturbed and partial lifts stay sound by construction."""
    G = st.G
    pod_group: Dict[str, int] = {}
    for gi, g in enumerate(st.groups):
        for p in g.pods:
            pod_group[p.name] = gi

    watched = (np.asarray(st.g_sel_match).any(axis=0)
               if st.S else np.zeros(G, dtype=bool))
    dom_ok = _host_dom_ok(st)
    avail_dom = np.asarray(st.cand_avail).any(axis=0)  # [D]

    static_ok = np.zeros(G, dtype=bool)
    for gi, g in enumerate(st.groups):
        rep = g.pods[0]
        if (st.g_zone_spread[gi] >= 0 or st.g_host_spread[gi] >= 0
                or st.g_zone_anti[gi] >= 0 or st.g_zone_paff[gi] >= 0
                or st.g_host_paff[gi] >= 0 or bool(watched[gi])):
            continue
        if rep.volume_claims or rep.volume_zone_requirements or rep.is_daemon:
            continue
        if gang_fixed(rep):
            # gang members are relax-INELIGIBLE: their scan
            # seats are fixed boundary conditions the gang epilogue audits
            # and packs — the rung must not move them out from under it
            continue
        if not bool(np.all(dom_ok[gi] | ~avail_dom)):
            continue  # zone/ct pinning: the node's domain choice couples
        static_ok[gi] = True

    freed: Set[str] = set()
    lifted: Dict[int, List] = {}
    seats: Dict[str, Dict[int, int]] = {}  # freed node -> {gi: pods}
    for n in result.nodes:
        gis = []
        ok = True
        for q in n.pods:
            gi = pod_group.get(q.name)
            if gi is None or not static_ok[gi]:
                ok = False  # carve-out or constrained pod pins the node
                break
            gis.append(gi)
        if not ok:
            continue
        freed.add(n.name)
        cnt: Dict[int, int] = {}
        for gi, q in zip(gis, n.pods):
            lifted.setdefault(gi, []).append(q)
            cnt[gi] = cnt.get(gi, 0) + 1
        seats[n.name] = cnt
    return set(lifted), freed, lifted, seats


# ---------------------------------------------------------------------------
# rounding + repair
# ---------------------------------------------------------------------------


def _largest_remainder(row: np.ndarray, total: int) -> np.ndarray:
    """Integerize a non-negative row to the exact total, largest
    fractional parts first."""
    base = np.floor(row).astype(np.int64)
    delta = total - int(base.sum())
    if delta > 0:
        frac = row - base
        for i in np.argsort(-frac)[:delta]:
            base[i] += 1
    elif delta < 0:
        frac = row - base
        order = [i for i in np.argsort(frac) if base[i] > 0]
        for i in order[: -delta]:
            base[i] -= 1
    return base


def _prefix_fit(res_mat: np.ndarray, req: np.ndarray, k: int):
    """First-fit ``k`` identical pods with request ``req`` into the node
    residual rows ``res_mat`` in order (the warm-start host tier's
    vectorized prefix allocation).  Returns (takes[N], placed)."""
    if not len(res_mat) or k <= 0:
        return np.zeros(len(res_mat), dtype=np.int64), 0
    pos = req > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        cap = np.floor(np.min(
            np.where(pos[None, :],
                     (res_mat + 1e-9) / np.maximum(req[None, :], 1e-12),
                     np.inf),
            axis=1))
    cap = np.where(np.isfinite(cap), np.maximum(cap, 0.0), float(k))
    before = np.cumsum(cap) - cap
    takes = np.clip(k - before, 0.0, cap).astype(np.int64)
    return takes, int(takes.sum())


class _Rounding:
    """Mutable state of the integral build: the open node fleet (one
    residual row per node), assignments, and provisioner-limit usage."""

    def __init__(self, st, prov_used: np.ndarray) -> None:
        self.st = st
        self.prov_used = prov_used                  # [P, R] mutable
        self.node_cand: List[int] = []              # candidate per node
        self.node_res: List[np.ndarray] = []        # residual per node
        self.takes: List[Tuple[int, int, int]] = []  # (gi, node_idx, k)
        self.cost = 0.0

    def limit_headroom(self, ci: int) -> int:
        p = int(self.st.cand_prov[ci])
        cap_row = np.asarray(self.st.cand_cap[ci], dtype=np.float64)
        head = np.asarray(self.st.prov_limits[p], dtype=np.float64) \
            - self.prov_used[p]
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(cap_row > 0,
                           np.floor((head + 1e-6) / np.maximum(cap_row, 1e-12)),
                           np.inf)
        n = np.min(per)
        return int(n) if np.isfinite(n) else (1 << 30)

    def buy(self, ci: int, n: int, price: float) -> List[int]:
        p = int(self.st.cand_prov[ci])
        self.prov_used[p] += np.asarray(self.st.cand_cap[ci],
                                        dtype=np.float64) * n
        idxs = []
        alloc = np.asarray(self.st.cand_alloc[ci], dtype=np.float64)
        for _ in range(n):
            idxs.append(len(self.node_res))
            self.node_cand.append(ci)
            self.node_res.append(alloc.copy())
        self.cost += price * n
        return idxs

    def fill(self, gi: int, node_idxs: Sequence[int], k: int) -> int:
        """First-fit k pods of group gi into the given nodes; returns the
        number placed."""
        if not node_idxs or k <= 0:
            return 0
        req = np.asarray(self.st.requests[gi], dtype=np.float64)
        res_mat = np.stack([self.node_res[i] for i in node_idxs])
        takes, placed = _prefix_fit(res_mat, req, k)
        for j, ni in enumerate(node_idxs):
            if takes[j] > 0:
                self.node_res[ni] = res_mat[j] - req * takes[j]
                self.takes.append((gi, ni, int(takes[j])))
        return placed


def _sparsify(x: np.ndarray, counts: np.ndarray, feas: np.ndarray,
              req: np.ndarray, alloc_inv: np.ndarray,
              frac: float = 0.05, rounds: int = 3) -> np.ndarray:
    """Concentrate the descent's interior point before integerizing.

    Entropic mirror descent converges to interior points that smear a few
    percent of every group across many near-optimal candidates; rounded
    literally, every touched candidate pays a partial last node and the
    integral cost explodes.  Two alternating prunes, renormalizing after
    each: (a) per GROUP, drop allocations under ``frac`` of the group
    (keeping its largest), (b) per CANDIDATE, drop candidates carrying
    less than ~one node's worth of total bottleneck load.  Each prune can
    only move mass onto candidates the descent already ranked higher, and
    the never-worse select downstream makes aggressiveness safe."""
    x = x.copy()
    for _ in range(rounds):
        keep = x >= frac * np.maximum(counts[:, None], 1.0)
        amax = x.argmax(axis=1)
        keep[np.arange(len(x)), amax] = True
        x = np.where(keep & feas, x, 0.0)
        y = ((x.T @ req) * alloc_inv).max(axis=1)    # fractional node count
        col_keep = y >= 0.9
        col_keep[x.argmax(axis=1)] = True            # every row keeps a home
        x = np.where(col_keep[None, :], x, 0.0)
        s = x.sum(axis=1, keepdims=True)
        x = np.where(s > 0, x / np.maximum(s, 1e-30), 0.0) * counts[:, None]
    return x


def _round_solution(st, x: np.ndarray, lift_counts: Dict[int, int],
                    prov_used: np.ndarray, F: np.ndarray):
    """Integral build from the fractional solution.

    Per group: largest-remainder split over its candidates.  Per
    candidate: buy the integral bottleneck node count and fill each node
    with the PROPORTIONAL group mix — node ``j`` takes
    ``round((j+1)*n_gc/N) - round(j*n_gc/N)`` pods of group ``g`` — which
    is what realizes the relaxation's complementary-resource pairing
    (group-sequential first-fit would exhaust one resource before the
    complementary group arrives and re-fragment into per-group fleets).
    Per-node integer jitter that overflows capacity is re-fit within the
    candidate, then stranded pods backfill cross-candidate.  Returns
    ``(rounding, leftovers{gi: count})``; None when a group has no
    purchasable candidate at all."""
    G, C = st.G, st.C
    x = np.maximum(np.asarray(x[:G, :C], dtype=np.float64), 0.0)

    pr = np.where(np.asarray(st.cand_avail), np.asarray(st.cand_price),
                  np.inf)
    p_c = pr.min(axis=1)                             # effective $/node

    n_alloc = np.zeros((G, C), dtype=np.int64)
    for gi in sorted(lift_counts):
        row = np.where(F[gi] & np.isfinite(p_c), x[gi], 0.0)
        total = int(lift_counts[gi])
        s = row.sum()
        if s <= 0:
            # descent starved the row (all-infeasible numerics): fall back
            # to the cheapest-density feasible candidate for the group
            ok = F[gi] & np.isfinite(p_c)
            if not ok.any():
                return None, {gi: total}
            req = np.asarray(st.requests[gi], dtype=np.float64)
            alloc = np.asarray(st.cand_alloc, dtype=np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                ppn = np.min(np.where(req[None, :] > 0,
                                      np.floor(alloc / np.maximum(req[None, :],
                                                                  1e-12)),
                                      np.inf), axis=1)
            dens = np.where(ok & (ppn >= 1), p_c / np.maximum(ppn, 1.0),
                            np.inf)
            row = np.zeros(C)
            row[int(np.argmin(dens))] = 1.0
            s = 1.0
        n_alloc[gi] = _largest_remainder(row * (total / s), total)

    rounding = _Rounding(st, prov_used)
    leftovers: Dict[int, int] = {}
    order = [int(g) for g in np.argsort(-np.asarray(st.magnitude))]
    requests = np.asarray(st.requests, dtype=np.float64)
    for ci in range(C):
        col = n_alloc[:, ci]
        if col.sum() == 0:
            continue
        if not np.isfinite(p_c[ci]):
            for gi in np.nonzero(col)[0]:
                leftovers[gi] = leftovers.get(gi, 0) + int(col[gi])
            continue
        alloc_c = np.asarray(st.cand_alloc[ci], dtype=np.float64)
        load = requests.T @ col                       # [R]
        with np.errstate(divide="ignore", invalid="ignore"):
            per_r = np.where(alloc_c > 1e-9,
                             load / np.maximum(alloc_c, 1e-9), np.inf)
            per_r = np.where(load > 1e-9, per_r, 0.0)
        bottleneck = float(np.max(per_r))
        if not np.isfinite(bottleneck):
            for gi in np.nonzero(col)[0]:
                leftovers[gi] = leftovers.get(gi, 0) + int(col[gi])
            continue
        n_nodes = max(int(np.ceil(bottleneck)), 1)
        buy = min(n_nodes, rounding.limit_headroom(ci))
        cand_nodes = rounding.buy(ci, buy, float(p_c[ci])) if buy else []
        overflow: Dict[int, int] = {}
        placed_col = np.zeros(G, dtype=np.int64)
        if buy:
            # vectorized proportional quotas: node j of the fleet takes
            # round((j+1)*n_g/buy) - round(j*n_g/buy) pods of group g —
            # telescopes to exactly n_g, never more than ±1 off the real-
            # valued per-node mix the bottleneck guarantees fits
            used_g = np.nonzero(col)[0]
            n_g = col[used_g].astype(np.float64)
            steps = np.arange(buy + 1, dtype=np.float64)[:, None]
            cum = np.rint(steps * n_g[None, :] / buy)
            quota = (cum[1:] - cum[:-1]).astype(np.int64)   # [buy, |used|]
            load = quota @ requests[used_g]                 # [buy, R]
            fits = np.all(load <= alloc_c[None, :] + 1e-9, axis=1)
            for j in np.nonzero(~fits)[0]:
                # integer jitter overflowed this node: sequential re-take
                # in FFD-magnitude order, overflow re-queued below
                res = alloc_c.copy()
                for oi in sorted(range(len(used_g)),
                                 key=lambda i: order.index(int(used_g[i]))):
                    t = int(quota[j, oi])
                    if t <= 0:
                        continue
                    req_g = requests[used_g[oi]]
                    pos = req_g > 0
                    with np.errstate(divide="ignore", invalid="ignore"):
                        cap = np.min(np.where(
                            pos, (res + 1e-9) / np.maximum(req_g, 1e-12),
                            np.inf))
                    take = int(min(t, max(int(cap), 0)))
                    quota[j, oi] = take
                    res -= req_g * take
                load[j] = quota[j] @ requests[used_g]
            for j, ni in enumerate(cand_nodes):
                rounding.node_res[ni] = alloc_c - load[j]
            nz_j, nz_i = np.nonzero(quota)
            for j, oi in zip(nz_j.tolist(), nz_i.tolist()):
                gi = int(used_g[oi])
                k = int(quota[j, oi])
                rounding.takes.append((gi, cand_nodes[j], k))
                placed_col[gi] += k
        for gi in np.nonzero(col)[0]:
            short = int(col[gi]) - int(placed_col[gi])
            if short > 0:
                overflow[int(gi)] = overflow.get(int(gi), 0) + short
        # re-fit integer jitter within the candidate's own fleet first,
        # then fund the straggler tail with extra whole nodes (the ceil
        # bottleneck is exact in aggregate; ±1-pod-per-group-per-node
        # jitter can exceed it by a node or two at scale)
        for gi in list(overflow):
            placed = rounding.fill(gi, cand_nodes, overflow[gi])
            overflow[gi] -= placed
            k = overflow[gi]
            if k > 0:
                req_g = requests[gi]
                pos = req_g > 0
                with np.errstate(divide="ignore", invalid="ignore"):
                    ppn = np.min(np.where(pos, np.floor(
                        (alloc_c + 1e-6) / np.maximum(req_g, 1e-12)),
                        np.inf))
                if np.isfinite(ppn) and ppn >= 1:
                    extra = min(int(np.ceil(k / ppn)),
                                rounding.limit_headroom(ci))
                    if extra > 0:
                        new_idxs = rounding.buy(ci, extra, float(p_c[ci]))
                        cand_nodes.extend(new_idxs)
                        k -= rounding.fill(gi, new_idxs, k)
            if k > 0:
                leftovers[gi] = leftovers.get(gi, 0) + k

    # cross-candidate backfill: stranded pods take any open rounded
    # capacity on a candidate their group is feasible for
    if leftovers and rounding.node_res:
        for gi in sorted(leftovers):
            ok_nodes = [i for i, ci in enumerate(rounding.node_cand)
                        if F[gi, ci]]
            placed = rounding.fill(gi, ok_nodes, leftovers[gi])
            leftovers[gi] -= placed
        leftovers = {gi: k for gi, k in leftovers.items() if k > 0}
    return rounding, leftovers


def _materialize(st, rounding: _Rounding,
                 lifted: Dict[int, List]) -> Tuple[List[SimNode],
                                                   Dict[str, str]]:
    """SimNodes + assignments from the rounded build (same construction
    as the scan's extraction, solver/tpu.py _extract).  Pods come from
    the partition's lifted pools — the exact pods taken off the freed
    nodes, never a group-mate that kept its seat."""
    pr = np.where(np.asarray(st.cand_avail), np.asarray(st.cand_price),
                  np.inf)
    d_c = pr.argmin(axis=1)
    n_ct = max(1, len(st.ct_names))
    nodes: List[SimNode] = []
    for ci in rounding.node_cand:
        prov_name, type_name = st.cand_names[ci]
        di = int(d_c[ci])
        zone = st.zone_names[int(st.dom_zone[di])] if st.zone_names else ""
        node = SimNode(
            instance_type=type_name,
            provisioner=prov_name,
            zone=zone,
            capacity_type=st.ct_names[di % n_ct] if st.ct_names else "",
            price=float(pr[ci, di]),
            allocatable={
                st.vocab.resources[r]: float(st.cand_alloc[ci, r])
                for r in range(st.cand_alloc.shape[1])
            },
            existing=False,
        )
        node.stamp_labels()
        nodes.append(node)

    per_group: Dict[int, List[Tuple[int, int]]] = {}
    for gi, ni, k in rounding.takes:
        per_group.setdefault(gi, []).append((ni, k))
    assignments: Dict[str, str] = {}
    for gi, picks in per_group.items():
        pods = lifted[gi]
        pos = 0
        for ni, k in picks:
            chunk = pods[pos:pos + k]
            pos += k
            name = nodes[ni].name
            nodes[ni].pods.extend(chunk)
            assignments.update((p.name, name) for p in chunk)
    return nodes, assignments


def _self_validate(st, lift_counts: Dict[int, int], rounding: _Rounding,
                   leftovers: Optional[Dict[int, int]] = None) -> bool:
    """Cheap integrality/capacity audit of the rounded fleet, at group
    granularity (no per-pod walk): every lifted pod placed exactly once
    OR accounted in ``leftovers`` (the repair hook's input), and every
    rounded node's take-derived load within its candidate allocatable.
    Runs BEFORE repair — an overloaded rounded node handed to the repair
    solve as a seed would ship (the scan sees negative residual and just
    places nothing more there).  A failed audit falls back to the scan —
    never ships."""
    G = st.G
    leftovers = leftovers or {}
    placed = np.zeros(G, dtype=np.int64)
    load = np.zeros((len(rounding.node_res), st.requests.shape[1]),
                    dtype=np.float64)
    requests = np.asarray(st.requests, dtype=np.float64)
    for gi, ni, k in rounding.takes:
        placed[gi] += k
        load[ni] += requests[gi] * k
    for gi in range(G):
        want = int(lift_counts.get(gi, 0)) - int(leftovers.get(gi, 0))
        if placed[gi] != want:
            return False
    alloc = np.asarray(st.cand_alloc, dtype=np.float64)
    for ni, ci in enumerate(rounding.node_cand):
        if np.any(load[ni] > alloc[ci] + 1e-6):
            return False
    return True



# ---------------------------------------------------------------------------
# the rung
# ---------------------------------------------------------------------------


def refine(
    result: SolveResult,
    st,
    *,
    registry: Optional[Registry] = None,
    trace=None,
    repair_solve=None,
    relax_iters: Optional[int] = None,
    device=None,
) -> Tuple[SolveResult, str]:
    """Run the relaxation rung over a scan result and ship the cheaper of
    {scan, relax+round}.  Returns ``(result, outcome)`` with outcome in
    RELAX_OUTCOMES; on every outcome except "improved" the input result is
    returned unchanged.  ``repair_solve(pods, seed_nodes)`` (optional) is
    the integrality repair hook: a full scheduler re-solve of the stranded
    pods SEEDED with the rounded fleet as existing-node state.  The
    program runs on ``device`` (``None``: the CUDA card, raising without
    one).  The caller owns policy routing; this function owns the math
    and the never-worse select."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    registry = registry or default_registry
    trace = trace or NULL_TRACE
    iters = iter_rung(configured_iters() if relax_iters is None
                      else relax_iters)
    with trace.span("relax") as span:
        try:
            out, outcome, ratio = _refine_inner(
                result, st, repair_solve=repair_solve, iters=iters,
                device=device)
        # the rung is an optimization layer: any failure ships the proven
        # scan solution and counts as fallback
        except Exception:
            logger.warning("relax rung failed; scan solution ships",
                           exc_info=True)
            out, outcome, ratio = result, "fallback", None
        span.annotate(outcome=outcome,
                      ratio=None if ratio is None else round(ratio, 4))
    record_outcome(registry, outcome,
                   seconds=time.perf_counter() - t0, ratio=ratio)
    return out, outcome


def relax_inputs(st, result: SolveResult, lifted: Dict[int, List],
                 seats: Dict[str, Dict[int, int]], freed: Set[str],
                 F: np.ndarray) -> Tuple[np.ndarray, ...]:
    """The relax program's padded numpy inputs ``(req, counts, feas,
    alloc_inv, price, x0)`` for a partition of ``result`` (see
    :func:`eligible_partition`) and the host feasibility ``F``."""
    dims = relax_dims(st)
    Gp, Cp, R = dims["G"], dims["C"], dims["R"]
    G, C = st.G, st.C

    req = np.zeros((Gp, R), dtype=np.float32)
    req[:G] = st.requests
    counts = np.zeros(Gp, dtype=np.float32)
    for gi, pods in lifted.items():
        counts[gi] = float(len(pods))
    elig_mask = counts[:G] > 0

    pr = np.where(np.asarray(st.cand_avail), np.asarray(st.cand_price),
                  np.inf)
    p_c = pr.min(axis=1)
    feas = np.zeros((Gp, Cp), dtype=bool)
    feas[:G, :C] = F & elig_mask[:, None] & np.isfinite(p_c)[None, :]
    price = np.zeros(Cp, dtype=np.float32)
    price[:C] = np.where(np.isfinite(p_c), p_c, 0.0).astype(np.float32)

    alloc = np.asarray(st.cand_alloc, dtype=np.float32)
    alloc_inv = np.zeros((Cp, R), dtype=np.float32)
    with np.errstate(divide="ignore"):
        alloc_inv[:C] = np.where(alloc > 1e-9, 1.0 / np.maximum(alloc, 1e-9),
                                 0.0)

    # warm start from the scan's own solution (the freed nodes' seated
    # counts from the partition pass; + a uniform escape term so the
    # descent can leave the scan's vertex)
    cand_index = {pair: ci for ci, pair in enumerate(st.cand_names)}
    node_cand = {n.name: cand_index.get((n.provisioner, n.instance_type))
                 for n in result.nodes if n.name in freed}
    x0 = np.zeros((Gp, Cp), dtype=np.float32)
    for name, cnt in seats.items():
        ci = node_cand.get(name)
        if ci is None:
            continue
        for gi, k in cnt.items():
            if feas[gi, ci]:
                x0[gi, ci] += float(k)
    uni = feas[:G].astype(np.float32)
    usum = uni.sum(axis=1, keepdims=True)
    uni = np.where(usum > 0, uni / np.maximum(usum, 1.0), 0.0) \
        * counts[:G, None]
    x0[:G] = 0.7 * x0[:G] + 0.3 * uni
    return req, counts, feas, alloc_inv, price, x0


def _refine_inner(result: SolveResult, st, *, repair_solve, iters: int,
                  device):
    elig, freed, lifted, seats = eligible_partition(st, result)
    if not elig or not freed:
        return result, "skipped", None

    F = _host_feasibility(st)
    lift_counts = {gi: len(pods) for gi, pods in lifted.items()}
    req, counts, feas, alloc_inv, price, x0 = relax_inputs(
        st, result, lifted, seats, freed, F)
    bx, _bf = _run_relax(req, counts, feas, alloc_inv, price, x0, iters,
                         device)
    bx = _sparsify(np.asarray(bx, dtype=np.float64),
                   counts.astype(np.float64), feas,
                   req.astype(np.float64), alloc_inv.astype(np.float64))

    # kept fleet + provisioner usage base (limits bind on raw capacity,
    # matching the scan and the ground-truth validator)
    kept_new = [n for n in result.nodes if n.name not in freed]
    P = len(st.prov_names)
    prov_index = {n: i for i, n in enumerate(st.prov_names)}
    prov_used = np.zeros((P, st.prov_limits.shape[1]), dtype=np.float64)
    for node in list(result.existing_nodes) + kept_new:
        pi = prov_index.get(node.provisioner)
        if pi is not None:
            prov_used[pi] += st.capacity_row(node.instance_type,
                                             node.allocatable)

    rounding, leftovers = _round_solution(st, bx, lift_counts, prov_used, F)
    if rounding is None:
        return result, "fallback", None
    if not _self_validate(st, lift_counts, rounding, leftovers):
        return result, "fallback", None
    nodes_new, assignments_new = _materialize(st, rounding, lifted)

    scan_cost = sum(n.price for n in result.nodes)
    repair_nodes: List[SimNode] = []
    repair_existing: Optional[List[SimNode]] = None
    if leftovers:
        if repair_solve is None:
            return result, "fallback", None
        # integrality repair: re-solve the stranded pods through the
        # existing scan, SEEDED from the rounded solution (the
        # warm-start shape: rounded + kept nodes are the existing-node
        # state, so the repair packs against everything already placed)
        stranded: List = []
        assigned_names = set(assignments_new)
        for gi, k in leftovers.items():
            pool = [p for p in lifted[gi] if p.name not in assigned_names]
            stranded.extend(pool[:k])
        seeds = list(result.existing_nodes) + kept_new + nodes_new
        sub = repair_solve(stranded, seeds)
        if sub is None or sub.infeasible:
            return result, "fallback", None
        placed = list(sub.existing_nodes)
        ne = len(result.existing_nodes)
        nk = len(kept_new)
        repair_existing = placed[:ne]
        kept_new = placed[ne:ne + nk]
        nodes_new = placed[ne + nk:]
        repair_nodes = list(sub.nodes)
        assignments_new.update(sub.assignments)

    relax_cost = (sum(n.price for n in kept_new)
                  + sum(n.price for n in nodes_new)
                  + sum(n.price for n in repair_nodes))
    ratio = relax_cost / scan_cost if scan_cost > 0 else 1.0
    if relax_cost >= scan_cost - 1e-9:
        return result, ("tied" if relax_cost <= scan_cost + 1e-9
                        else "fallback"), ratio

    # adopt: the rung's fleet replaces the freed nodes
    if repair_existing is not None:
        result.existing_nodes = repair_existing
    result.nodes = kept_new + nodes_new + repair_nodes
    result.assignments.update(assignments_new)
    logger.info(
        "relax rung improved the solve: %d eligible pods re-packed, "
        "node cost %.4f -> %.4f (%.2f%%)",
        sum(lift_counts.values()), scan_cost, relax_cost,
        100.0 * (1.0 - ratio))
    return result, "improved", ratio

