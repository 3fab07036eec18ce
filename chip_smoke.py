#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``karpenter_tpu_torch``) on one NVIDIA GPU and
check it end to end.  Run from the repository root: ``python3 chip_smoke.py``.

Phases, each printing one JSON line (any failure exits non-zero and prints
no result):

1. device — ``nvidia-smi`` name and power limit, torch/CUDA versions;
2. build — every kernel compiled from ``karpenter_tpu_torch/csrc`` with
   nvcc for ``sm_90a`` (one nvcc per source, started together);
3. kernel — both entries of the packed-score kernel (``packed_scan_scores``
   on a bf16 price row, ``price_step_scores`` fused with the price math)
   against their plain PyTorch versions on the card and on the host,
   byte-equal, on every case of :func:`step_cases` (ties, all-infeasible
   rows, sentinel and +inf prices, 1 and 3 provisioners, duals up to the
   8.0 cap, a hot provisioner that moves the argmin, tile / slice / large
   shapes up to 65,536 x 1,024);
4. slice — the main path: ``BatchScheduler(backend="auto").solve`` of a
   100,000-pod scale-up (40 zone-spread deployments x 2,500 pods against
   the full catalog) under a provisioner ``limits.cpu`` at 99% of the
   unconstrained buy.  It must route hierarchically, run price iterations
   that launch the fused entry once each (and the price-row entry never),
   keep the shipped cpu within the limit and leave every pod seated or
   typed infeasible.  Launch counts are zeroed just before this run and
   read just after;
5. timing — each entry, its plain version and, where one exists, a
   one-call PyTorch yardstick at the main path's inputs (CUDA graph +
   events), beside the bound; the price-row entry also at 4,096 x 1,024
   and at 65,536 x 1,024 (two buffers in turn, beyond L2); the price
   loop's score step as the host pays it, fused and through the host
   price chain with the price-row entry;
6. parity — a smaller hierarchical batch with a binding limit solved on
   ``cuda`` and on ``cpu``: the node plans must agree;
7. relax — the relax rung on the flat path: 50,000 pods in 20
   complementary unconstrained deployments, and a 5,000-pod batch whose
   first 10 deployments carry a zone spread, each solved on ``cuda`` with
   ``relax=False`` (the scan) and at the default (the rung).  The shipped
   plan must cost no more than the scan's, seat every pod exactly once,
   hold node capacity and provisioner limits, count no ``fallback``, run
   the relax program on the card, and equal the ``device="cpu"`` solve;
   the program is also timed alone on the 50,000-pod inputs;
8. consolidation — the deletability screen of a 5,000-node fleet on
   ``cuda`` and on ``cpu`` (equal vectors), and a 16-candidate what-if
   sweep over a 300-node cluster, batched in one dispatch, against the
   serial loop of what-if solves (equal decisions);
9. controllers — (a) the slice's 100,000-pod batch provisioned through
   ``ProvisioningController`` (pods added to a ``ClusterState`` under the
   slice's provisioner, the batching window passed, machines created on
   the fake cloud, pods bound): hierarchical routing, one
   ``price_step_scores`` launch per price iteration, the slice's plan
   (equal or ``placements_tie``), every pod bound to a node that exists,
   the limit held; (b) on the config-4 repack fleet: the consolidation
   evaluation's screen step at 5,000 nodes (compat rows, one screen of
   every single and structured subset on the card), one full
   deprovisioning reconcile at 300 nodes (the screen on the card, a
   proposed action executed, the fleet settled, a warm reconcile), and
   the ladder driven to convergence at 200 nodes (no pod pending, every
   pod bound once, no node over its allocatable, a lower cost); (c) a
   100-node fleet driven to convergence on ``cuda`` and on ``cpu``: equal
   actions, final cluster and bindings.  The sizes are cut from the
   reference bench's 5,000 and 2,000 nodes to fit the time
   (:data:`REPACK_SIZES`).

Launch counts (the hand-written kernels', and the relax and screen
programs' runs) are zeroed just before each path is driven and read just
after; no hand-written kernel is on the relax, consolidation or repack
path, so their kernel counts read 0 there.  The last two lines are the kernel table (``{"kernels": [...]}``) and
``{"ok": true, "device": {...}}``; the ``nvidia-smi`` line precedes them.
Everything is also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
#: non-tensor-core float32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

GIB = 1024.0 ** 3
ZONE = "topology.kubernetes.io/zone"

RECORD: dict = {}


class SmokeFailure(Exception):
    pass


class _Faults(logging.Handler):
    """Collects the warnings the port logs where it catches a failure and
    falls back (the relax rung shipping the scan after an exception, a
    sweep dispatch served serially): a device fault must not pass as a
    fallback."""

    def __init__(self) -> None:
        super().__init__(level=logging.WARNING)
        self.records: list = []

    def emit(self, record) -> None:
        self.records.append(f"{record.name}: {record.getMessage()}")


FAULTS = _Faults()


def emit(phase: str, **fields) -> None:
    RECORD[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# scenario
# ---------------------------------------------------------------------------


def deployments(nd: int, per: int, tag: str = "h"):
    """``nd`` deployments of ``per`` pods, each zone-spread (maxSkew 1,
    DoNotSchedule) against its own app selector — one coupling component
    per deployment (the shape of the reference bench's hierarchical
    scenario)."""
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )

    pods = []
    for d in range(nd):
        sel = LabelSelector.of({"app": f"{tag}{d}"})
        for i in range(per):
            pods.append(PodSpec(
                name=f"{tag}{d}-{i}", labels={"app": f"{tag}{d}"},
                requests={"cpu": 0.25 * (1 + d % 8),
                          "memory": (0.5 + (d % 6)) * GIB},
                topology_spread=[TopologySpreadConstraint(
                    1, ZONE, "DoNotSchedule", sel)],
                owner_key=f"{tag}{d}"))
    return pods


def provisioner(cpu_limit=None):
    from karpenter_tpu_torch.models.provisioner import Provisioner

    p = Provisioner(name="default").with_defaults()
    if cpu_limit is not None:
        p.limits = {"cpu": cpu_limit}
    return p


def cpu_bought(st, nodes) -> float:
    return sum(float(st.capacity_row(n.instance_type, n.allocatable)[0])
               for n in nodes)


def plan(result):
    return sorted(
        (n.instance_type, n.zone, n.capacity_type, round(n.price, 6),
         tuple(sorted(p.name for p in n.pods)))
        for n in result.nodes)


def placements_tie(a, b) -> bool:
    return (set(a.assignments) == set(b.assignments)
            and set(a.infeasible) == set(b.infeasible)
            and np.float32(sum(n.price for n in a.nodes)).tobytes()
            == np.float32(sum(n.price for n in b.nodes)).tobytes())


def limited_solve(device, pods, catalog):
    """Unconstrained solve, then the solve under a cpu limit at 99% of what
    it bought.  Returns (scheduler, tensors, limit, free, limited, stats,
    limited-solve wall ms, launches per kernel in the limited solve)."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics import HIER_SOLVES, RELAX_DURATION
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    sched = BatchScheduler(backend="auto", device=device)
    free = sched.solve(pods, [provisioner()], catalog)
    check(bool(sched.hier_stats), "unconstrained solve did not route "
          "hierarchically")
    st, _ = sched._tensorize(pods, [provisioner()], catalog, (), None)
    limit = round(cpu_bought(st, free.nodes) * 0.99, 1)

    hier_before = sched.registry.counter(HIER_SOLVES).get(
        {"path": "hierarchical"})
    relax_before = _outcomes(sched.registry)
    relax_s0 = _hist_sum(sched.registry, RELAX_DURATION)
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = sched.solve(pods, [provisioner(limit)], catalog)
    if sched.device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    launches = {k.name: k.launches for k in kernels.ALL}
    check(sched.registry.counter(HIER_SOLVES).get({"path": "hierarchical"})
          == hier_before + 1, "limited solve did not route hierarchically")
    stats = dict(sched.hier_stats)
    # every deployment carries a zone spread: the relax rung has nothing
    # to lift and counts one skip (its partition pass is relax_ms)
    stats["relax_outcomes"] = {o: v - relax_before[o] for o, v in
                               _outcomes(sched.registry).items()}
    stats["relax_ms"] = (_hist_sum(sched.registry, RELAX_DURATION)
                         - relax_s0) * 1000.0
    check(stats["relax_outcomes"]["skipped"] == 1
          and sum(stats["relax_outcomes"].values()) == 1,
          "the limited solve's relax rung did not skip")
    check(stats.get("price_iters", 0) >= 1, "no price iteration ran")
    shipped = cpu_bought(st, res.nodes)
    check(shipped <= limit * (1.0 + 1e-6),
          f"shipped cpu {shipped} exceeds the limit {limit}")
    names = {p.name for p in pods}
    check(set(res.assignments) | set(res.infeasible) == names,
          "a pod is neither seated nor typed infeasible")
    check(all(np.isfinite(n.price) and n.price > 0 for n in res.nodes),
          "a node has a non-finite price")
    return sched, st, limit, free, res, stats, wall_ms, launches, shipped


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)))
    return line


def phase_build():
    from karpenter_tpu_torch import kernels

    t0 = time.perf_counter()
    per = kernels.build(kernels.ALL)
    emit("build", seconds=time.perf_counter() - t0, per_kernel_s=per,
         flags=list(kernels.NVCC_FLAGS),
         entries=[k.name for k in kernels.ALL],
         sources=[lib.repo_path for lib in kernels.libraries()],
         libraries=[lib.library_path().name for lib in kernels.libraries()])


def _score_case(G, C, seed, p=0.6, ties=True):
    """A price-row case as a price-step case: one domain, one provisioner,
    zero duals (so the adjusted row is the price row)."""
    rng = np.random.default_rng(seed)
    feas = rng.random((G, C)) < p
    price = rng.uniform(0.1, 9.0, size=C).astype(np.float32)
    if ties:
        price[C // 2:] = price[: C - C // 2]
    return feas, price[:, None], np.zeros(C, dtype=np.int32), np.zeros(1)


def step_case(G, C, D, P, lam_kind, seed):
    """Feasibility, base prices ``[C, D]``, owners and duals from one numpy
    seed.  Row 0 of f is all-infeasible; candidate 1 is priced at the
    3.0e38 sentinel in every domain, candidate 2 at +inf; about a fifth of
    the other cells have no offering (+inf); the second half of the
    candidates repeats the first half's prices (ties)."""
    rng = np.random.default_rng(seed)
    feas = rng.random((G, C)) < 0.4
    feas[0] = False
    base = rng.uniform(0.05, 12.0, size=(C, D)).astype(np.float32)
    base[C // 2:] = base[: C - C // 2]
    base[rng.random((C, D)) < 0.2] = np.inf
    base[1] = np.float32(3.0e38)
    base[2] = np.inf
    prov = rng.integers(0, P, size=C).astype(np.int32)
    lam = {"zero": np.zeros(P), "mid": rng.uniform(0.05, 1.5, size=P),
           "cap": np.full(P, 8.0)}[lam_kind]
    return feas, base, prov, lam


def step_cases(large: bool = False) -> dict:
    """Every kernel case: ``name -> (feas, base [C, D], prov [C], lam [P])``.
    The price-row entry takes the host chain's row of the same inputs."""
    cases = {}
    for name, (G, C, D) in (("slice_40x425_d6", (40, 425, 6)),
                            ("small_5x7_d2", (5, 7, 2))):
        for P in (1, 3):
            for lam_kind in ("zero", "mid", "cap"):
                cases[f"{name}_p{P}_{lam_kind}"] = step_case(
                    G, C, D, P, lam_kind, seed=G + C + P)
    cases["sentinel_inf_only_row"] = (
        np.array([[0, 1, 1, 0], [1, 1, 1, 1]], dtype=bool),
        np.array([[2.0], [3.0e38], [np.inf], [2.0]], dtype=np.float32),
        np.zeros(4, dtype=np.int32), np.array([0.3]))
    for lam0 in (0.0, 0.6):  # provisioner 0 hot enough to lose the argmin
        cases[f"hot_flip_lam{lam0}"] = (
            np.ones((3, 2), dtype=bool),
            np.array([[1.0, 1.25], [1.5, 1.75]], dtype=np.float32),
            np.array([0, 1], dtype=np.int32), np.array([lam0, 0.0]))
    cases["ties_5x7"] = _score_case(5, 7, 3)
    cases["tile_32x128"] = _score_case(32, 128, 9)
    cases["slice_40x425"] = _score_case(40, 425, 5, p=0.3)
    cases["large_4096x1024"] = _score_case(4096, 1024, 13, ties=False)
    cases["all_infeasible"] = (
        np.array([[0, 0, 0], [1, 0, 1]], dtype=bool),
        np.array([[1.0], [2.0], [0.5]], dtype=np.float32),
        np.zeros(3, dtype=np.int32), np.zeros(1))
    cases["sentinel_prices"] = (
        np.array([[1, 0, 1]], dtype=bool),
        np.full((3, 1), 3.0e38, dtype=np.float32),
        np.zeros(3, dtype=np.int32), np.zeros(1))
    if large:
        cases["hbm_65536x1024"] = _score_case(65536, 1024, 17, p=0.5,
                                              ties=False)
    return cases


def host_row(base, prov, lam):
    """The reference's host chain: adjusted prices, cheapest domain, bf16."""
    from karpenter_tpu_torch.models.tensorize import pack_scores
    from karpenter_tpu_torch.solver.hierarchy import price_adjusted

    return pack_scores(price_adjusted(base, prov, lam).min(axis=1))


def _same(*outs) -> bool:
    raw = [np.ascontiguousarray(o.cpu().numpy()).tobytes() for o in outs]
    return all(r == raw[0] for r in raw)


def check_packed_entry(f, row) -> float:
    """``packed_scan_scores`` on the card (one launch) against its plain
    version on the card and on the host; returns the max abs cost error,
    fails unless byte-equal."""
    import torch

    from karpenter_tpu_torch.kernels import PACKED_SCORE
    from karpenter_tpu_torch.solver.hierarchy import (
        packed_scan_scores,
        packed_scan_scores_plain,
    )

    before = PACKED_SCORE.launches
    c_k, i_k = packed_scan_scores(f, row.to(f.device))
    torch.cuda.synchronize()
    check(PACKED_SCORE.launches == before + 1, "packed_score did not launch")
    c_p, i_p = packed_scan_scores_plain(f, row.to(f.device))
    c_h, i_h = packed_scan_scores_plain(f.cpu(), row)
    check(_same(c_k, c_p, c_h) and _same(i_k, i_p, i_h),
          f"packed_score differs from its plain version at {tuple(f.shape)}")
    return float((c_k - c_p).abs().max().item()) if c_k.numel() else 0.0


def check_step_entry(f, base, prov, lam) -> float:
    """``price_step_scores`` on the card (one launch) against its plain
    version on the card and on the host, and against the price-row plain
    version on the host chain's row; returns the max abs cost error, fails
    unless byte-equal."""
    import torch

    from karpenter_tpu_torch.kernels import PRICE_STEP_SCORE
    from karpenter_tpu_torch.solver.hierarchy import (
        packed_scan_scores_plain,
        price_step_scores,
        price_step_scores_plain,
        split_scores,
    )

    args = (torch.from_numpy(np.ascontiguousarray(base)),
            torch.from_numpy(np.ascontiguousarray(prov)),
            torch.from_numpy(np.exp(lam).astype(np.float32)))
    dev_args = [a.to(f.device) for a in args]
    before = PRICE_STEP_SCORE.launches
    out_k = price_step_scores(f, *dev_args)
    torch.cuda.synchronize()
    check(PRICE_STEP_SCORE.launches == before + 1,
          "price_step_score did not launch")
    out_p = price_step_scores_plain(f, *dev_args)
    out_h = price_step_scores_plain(f.cpu(), *args)
    c_r, i_r = packed_scan_scores_plain(f.cpu(), host_row(base, prov, lam))
    out_r = torch.stack([c_r.view(torch.int32), i_r])
    check(_same(out_k, out_p, out_h, out_r),
          f"price_step_score differs from its plain version at "
          f"{tuple(f.shape)}")
    c_k, c_p = split_scores(out_k)[0], split_scores(out_p)[0]
    return float((c_k - c_p).abs().max().item()) if c_k.numel() else 0.0


def phase_kernel():
    """Both entries vs their plain versions on the card, byte-equal, on
    every case."""
    import torch

    from karpenter_tpu_torch.models.tensorize import pack_feasibility

    out = {}
    max_err = {"packed_score": 0.0, "price_step_score": 0.0}
    for name, (feas, base, prov, lam) in step_cases(large=True).items():
        f = torch.from_numpy(pack_feasibility(feas)).cuda()
        e1 = check_packed_entry(f, host_row(base, prov, lam))
        e2 = check_step_entry(f, base, prov, lam)
        max_err["packed_score"] = max(max_err["packed_score"], e1)
        max_err["price_step_score"] = max(max_err["price_step_score"], e2)
        out[name] = dict(shape=list(feas.shape) + [base.shape[1]],
                         P=len(lam), byte_equal=True,
                         max_abs_err=max(e1, e2))
        del f
    emit("kernel", cases=out, max_abs_err=max_err)
    return max_err


def _time(fn, reps=21, inner=20):
    """Median ms per EAGER call over ``reps`` CUDA-event windows of
    ``inner`` calls: what a caller pays per call, host launch included
    (a tiny kernel's window is bound by the host's launch rate)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _time_graph(fn, reps=21, inner=50):
    """Median DEVICE ms per call: ``inner`` calls captured into one CUDA
    graph, replayed ``reps`` times between CUDA events — no host launch
    cost between the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def phase_slice(nd: int, per: int):
    import torch

    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=True)
    pods = deployments(nd, per)
    t0 = time.perf_counter()
    (sched, st, limit, free, res, stats, wall_ms, launches,
     shipped) = limited_solve(None, pods, catalog)
    check(launches["price_step_score"] >= 1,
          "the main path launched the price_step_score kernel no time")
    check(launches["price_step_score"] == stats["price_iters"],
          "price_step_score launches != price iterations")
    check(launches["packed_score"] == 0,
          "the main path launched the price-row entry")
    emit("slice", pods=len(pods), groups=st.G, candidates=st.C,
         domains=int(st.cand_price.shape[1]), provisioners=len(st.prov_names),
         zones=st.n_zones, blocks=stats["blocks"], waves=stats["waves"],
         price_iters=stats["price_iters"], dispatches=stats["dispatches"],
         wall_ms=wall_ms, tensorize_ms=stats["tensorize_ms"],
         partition_ms=stats["partition_ms"], entries_ms=stats["entries_ms"],
         wave_ms=stats["wave_ms"], score_ms=stats["score_ms"],
         score_setup_ms=stats["score_setup_ms"], price_lam=stats["price_lam"],
         repair_ms=stats["repair_ms"], repair_pods=stats["repair_pods"],
         hier_total_ms=stats["total_ms"],
         relax_outcomes=stats["relax_outcomes"], relax_ms=stats["relax_ms"],
         nodes=len(res.nodes), cost=res.new_node_cost,
         infeasible=len(res.infeasible), cpu_limit=limit,
         cpu_shipped=shipped, free_nodes=len(free.nodes),
         free_cost=free.new_node_cost, launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / GIB,
         phase_s=time.perf_counter() - t0)
    return st, stats, launches, limit, res


def _bound(bytes_moved: int, ops: int) -> dict:
    """The least time for the work: bytes over HBM rate, operations over
    the float32 peak, the larger of the two."""
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1000.0
    bound_ops = ops / F32_FLOPS * 1000.0
    return dict(bytes=bytes_moved, ops=ops,
                bound_ms=max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops else "operations")


def _time_fns(fns: dict) -> dict:
    """Graph-replayed device ms and eager per-call ms of each function, in
    two turns (forward order, then reversed); medians."""
    runs = {k: [] for k in fns}
    calls = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            runs[k].append(_time_graph(fns[k]))
            calls[k].append(_time(fns[k]))
    out = {f"{k}_ms": statistics.median(v) for k, v in runs.items()}
    out.update(call_ms={k: statistics.median(v) for k, v in calls.items()},
               runs=runs)
    return out


def _time_packed(fs, price) -> dict:
    """The price-row entry, its plain version and the one-call yardstick
    on the buffers ``fs`` in turn (two buffers keep a large f out of L2)."""
    import itertools

    import torch

    from karpenter_tpu_torch.solver.hierarchy import (
        _BIG,
        packed_scan_scores,
        packed_scan_scores_plain,
    )

    G, C = fs[0].shape
    nxt = itertools.cycle(fs).__next__
    out = _time_fns({
        "plain": lambda: packed_scan_scores_plain(nxt(), price),
        "kernel": lambda: packed_scan_scores(nxt(), price),
        "library": lambda: torch.min(
            torch.where(nxt() > 0, price.float()[None, :], _BIG), dim=1),
    })
    # one select + one compare per cell
    out.update(shape=[G, C], buffers=len(fs),
               **_bound(G * C + 2 * C + 8 * G, 2 * G * C))
    return out


def _time_step(f, base, prov, mult) -> dict:
    """The fused entry and its plain version (no one PyTorch call computes
    the same function: no library yardstick)."""
    from karpenter_tpu_torch.solver.hierarchy import (
        price_step_scores,
        price_step_scores_plain,
    )

    G, C = f.shape
    D, P = base.shape[1], mult.shape[0]
    out = _time_fns({
        "plain": lambda: price_step_scores_plain(f, base, prov, mult),
        "kernel": lambda: price_step_scores(f, base, prov, mult),
    })
    # f read once, base prices, owners and multipliers once, [2, G] out;
    # a multiply and a min per price cell, a select and a compare per f cell
    out.update(shape=[G, C, D], P=P, library_ms=None,
               **_bound(G * C + 4 * C * D + 4 * C + 4 * P + 8 * G,
                        2 * G * C + 2 * C * D))
    return out


def _time_host_step(f_np, base_np, prov_np, lam) -> dict:
    """The price loop's score step as the host pays it (host clock, ends
    with the result on the host), median ms in two turns: ``fused`` is
    ``ScoreStep`` as the loop runs it (exp(lam) up, one launch, one buffer
    back) and ``host_chain`` the host price chain (host price math, bf16
    packing, price row up, the price-row entry, two copies back);
    ``bare_copy`` (one 4-byte copy back from the card) is the floor any
    step that ends on the host pays.  Each runs back to back (``warm``),
    after 20 ms of host-only Python work (``after_host_work``, as between
    the solve's price iterations) and after 20 ms idle (``after_idle``)."""
    import torch

    from karpenter_tpu_torch.models.tensorize import pack_scores
    from karpenter_tpu_torch.solver.hierarchy import (
        ScoreStep,
        packed_scan_scores,
        price_adjusted,
    )

    step = ScoreStep(f_np, base_np, prov_np, len(lam), "cuda")
    f = step.inputs[0]

    def host_chain():
        adj = price_adjusted(base_np, prov_np, lam).min(axis=1)
        cost, idx = packed_scan_scores(f, pack_scores(adj).to(f.device))
        return cost.cpu().numpy(), idx.cpu().numpy()

    def host_work():
        t_end = time.perf_counter() + 0.02
        while time.perf_counter() < t_end:
            sum(range(1000))

    one = torch.zeros(1, device="cuda")
    fns = {"fused": lambda: step(lam), "host_chain": host_chain,
           "bare_copy": lambda: one.cpu()}
    (ca, ia), (cb, ib) = fns["fused"](), host_chain()
    check(ca.tobytes() == cb.tobytes() and ia.tobytes() == ib.tobytes(),
          "the fused score step and the host chain disagree")
    out = {}
    for cond, before, reps in (
            ("warm", None, 100),
            ("after_host_work", host_work, 30),
            ("after_idle", lambda: time.sleep(0.02), 30)):
        times = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                for _ in range(5):
                    fns[k]()
                for _ in range(reps):
                    if before is not None:
                        before()
                    t0 = time.perf_counter()
                    fns[k]()
                    times[k].append((time.perf_counter() - t0) * 1000.0)
        out[cond] = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    return out


def phase_timing(st, stats):
    """Both entries at the main path's inputs (the slice's feasibility, base
    prices, owners and last duals), the score step as the host pays it,
    and the price-row entry at 4,096 x 1,024 and at 65,536 x 1,024 (64 MiB
    of f in each of two buffers, used in turn, so the 50 MB L2 does not
    hold the next call's f)."""
    import torch

    from karpenter_tpu_torch.models.tensorize import pack_feasibility
    from karpenter_tpu_torch.solver.relax import _host_feasibility

    f_np = pack_feasibility(_host_feasibility(st))
    f = torch.from_numpy(f_np).cuda()
    # the padded base's first C rows: no-offering cells at the sentinel
    base_np = np.where(np.isinf(st.cand_price), np.float32(3.0e38),
                       st.cand_price).astype(np.float32)
    prov_np = np.asarray(st.cand_prov, dtype=np.int32)
    lam = np.asarray(stats["price_lam"], dtype=np.float64)
    base, prov = torch.from_numpy(base_np).cuda(), torch.from_numpy(
        prov_np).cuda()
    mult = torch.from_numpy(np.exp(lam).astype(np.float32)).cuda()
    out = dict(
        packed=_time_packed([f], host_row(base_np, prov_np, lam).cuda()),
        step=_time_step(f, base, prov, mult),
        host_step=_time_host_step(f_np, base_np, prov_np, lam),
    )
    feas, base_l, _, _ = _score_case(4096, 1024, 13, ties=False)
    out["packed_4096x1024"] = _time_packed(
        [torch.from_numpy(pack_feasibility(feas)).cuda()],
        host_row(base_l, np.zeros(1024, dtype=np.int32), np.zeros(1)).cuda())
    fs = []
    for seed in (17, 18):
        feas, base_h, _, _ = _score_case(65536, 1024, seed, ties=False)
        fs.append(torch.from_numpy(pack_feasibility(feas)).cuda())
        del feas
    out["packed_65536x1024"] = _time_packed(
        fs, host_row(base_h, np.zeros(1024, dtype=np.int32),
                     np.zeros(1)).cuda())
    emit("timing", **out)
    return out


def phase_parity(nd: int, per: int):
    """The same limited hierarchical solve on cuda and on cpu."""
    import torch

    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=True)
    pods = deployments(nd, per, tag="p")
    old = os.environ.get("KT_HIER_THRESHOLD")
    os.environ["KT_HIER_THRESHOLD"] = str(len(pods))
    try:
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            (_s, _st, limit, _free, res, stats, _w, _l,
             _shipped) = limited_solve(dev, pods, catalog)
            runs[dev] = (limit, res, stats, time.perf_counter() - t0)
    finally:
        if old is None:
            os.environ.pop("KT_HIER_THRESHOLD", None)
        else:
            os.environ["KT_HIER_THRESHOLD"] = old
    (lg, rg, sg, tg), (lc, rc, sc, tc) = runs["cuda"], runs["cpu"]
    equal = plan(rg) == plan(rc)
    tie = placements_tie(rg, rc)
    check(lg == lc, f"cuda and cpu bought differently unconstrained "
          f"(limits {lg} vs {lc})")
    check(equal or tie, "cuda and cpu node plans disagree")
    emit("parity", pods=len(pods), cpu_limit=lg, plans_equal=equal,
         placements_tie=tie, price_iters=[sg["price_iters"],
                                          sc["price_iters"]],
         nodes=[len(rg.nodes), len(rc.nodes)],
         cost=[rg.new_node_cost, rc.new_node_cost], seconds=[tg, tc],
         torch_threads=torch.get_num_threads())


# ---------------------------------------------------------------------------
# relax and consolidation scenarios
# ---------------------------------------------------------------------------


def relax_pods(n_per: int, n_dep: int = 20, spread_deps: int = 0,
               tag: str = "rx"):
    """Complementary-resource deployments cycling cpu-heavy (1.0–2.5 cpu,
    0.25 GiB), memory-heavy (0.1–0.25 cpu, 6–10 GiB) and balanced
    (0.5–1.5 cpu, 2–4 GiB) — the batch where a global packing beats
    per-group first-fit.  The first ``spread_deps`` deployments carry a
    hard zone spread (the reference bench's ``_relax_pods``)."""
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )

    pods = []
    for d in range(n_dep):
        kind = d % 3
        if kind == 0:
            cpu, mem = 1.0 + (d % 4) * 0.5, 0.25 * GIB
        elif kind == 1:
            cpu, mem = 0.1 + 0.05 * (d % 4), (6.0 + 2 * (d % 3)) * GIB
        else:
            cpu, mem = 0.5 * (1 + d % 3), 2.0 * GIB * (1 + d % 2)
        sel = LabelSelector.of({"app": f"{tag}{d}"})
        tsc = ([TopologySpreadConstraint(1, ZONE, "DoNotSchedule", sel)]
               if d < spread_deps else [])
        for i in range(n_per):
            pods.append(PodSpec(
                name=f"{tag}{d}-{i}", labels={"app": f"{tag}{d}"},
                requests={"cpu": cpu, "memory": mem},
                topology_spread=list(tsc), owner_key=f"{tag}{d}"))
    return pods


def check_plan(pods, res, provisioners, st) -> None:
    """Every pod seated exactly once, no node over its allocatable, every
    provisioner within its limits."""
    names = [p.name for p in pods]
    seated = [q.name for n in res.nodes for q in n.pods]
    check(not res.infeasible, f"{len(res.infeasible)} pods left infeasible")
    check(sorted(seated) == sorted(names) and set(res.assignments)
          == set(names), "a pod is not seated exactly once")
    check(all(v >= -1e-6 for n in res.nodes for v in n.remaining().values()),
          "a node is over its allocatable")
    for prov in provisioners:
        for r, limit in (prov.limits or {}).items():
            used = sum(float(st.capacity_row(n.instance_type, n.allocatable)[
                st.vocab.resources.index(r)])
                for n in res.nodes if n.provisioner == prov.name)
            check(used <= limit * (1 + 1e-6),
                  f"provisioner {prov.name} over its {r} limit")


def _outcomes(registry) -> dict:
    from karpenter_tpu_torch.metrics import RELAX_OUTCOMES, RELAX_TOTAL

    return {o: registry.counter(RELAX_TOTAL).get({"outcome": o})
            for o in RELAX_OUTCOMES}


def _hist_sum(registry, name) -> float:
    return sum(registry.histogram(name).sums.values())


def _synced_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1000.0


def count_launches(fn):
    """CUDA kernel launches of one call of ``fn`` (torch.profiler's
    ``cudaLaunchKernel`` runtime calls); None when the profiler records
    none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.key.startswith("cudaLaunchKernel"))
    return n or None


def _first_diff(a, b):
    """The first differing entry of two node plans, by type, zone, price
    and pod count (None when the plans are equal)."""
    for x, y in zip(plan(a), plan(b)):
        if x != y:
            return [list(x[:4]) + [len(x[4])], list(y[:4]) + [len(y[4])],
                    sorted(set(x[4]) ^ set(y[4]))[:4]]
    return None if plan(a) == plan(b) else "node counts differ"


def relax_case(pods, catalog):
    """The scan and the default solve of ``pods`` on the card, then the
    default solve on the host; checks and numbers of the rung."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics import RELAX_DURATION, Registry
    from karpenter_tpu_torch.solver import relax
    from karpenter_tpu_torch.solver.relax import RELAX_PROGRAM
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    provs = [provisioner()]
    reg = Registry()
    sched = BatchScheduler(backend="tpu", registry=reg)
    scan, scan_ms = _synced_ms(lambda: sched.solve(pods, provs, catalog,
                                                   relax=False))
    before = _outcomes(reg)
    relax_s0 = _hist_sum(reg, RELAX_DURATION)
    RELAX_PROGRAM.reset()
    kernels.reset_counts()
    shipped, shipped_ms = _synced_ms(lambda: sched.solve(pods, provs,
                                                         catalog))
    runs = dict(RELAX_PROGRAM.runs)
    launches = {k.name: k.launches for k in kernels.ALL}
    outcomes = {o: v - before[o] for o, v in _outcomes(reg).items()}
    st, _ = sched._tensorize(pods, provs, catalog, (), None)
    # 'fallback' also counts a rounding that came out costlier than the
    # scan (the scan ships); a fallback from an exception logs a warning
    check(not FAULTS.records, f"the port fell back: {FAULTS.records}")
    check(sum(outcomes.values()) == 1, "the rung was not evaluated once")
    check(runs.get("cuda", 0) >= 1 or outcomes["skipped"] == 1,
          "the relax program did not run on the card")
    check(runs.get("cpu", 0) == 0, "the relax program ran on the host")
    check(shipped.new_node_cost <= scan.new_node_cost + 1e-9,
          "the rung shipped a costlier plan than the scan")
    check_plan(pods, scan, provs, st)
    check_plan(pods, shipped, provs, st)
    t0 = time.perf_counter()
    host_reg = Registry()
    host = BatchScheduler(backend="tpu", device="cpu",
                          registry=host_reg).solve(pods, provs, catalog)
    cpu_s = time.perf_counter() - t0
    equal = plan(host) == plan(shipped)
    check(equal or placements_tie(host, shipped),
          "the cuda and cpu default solves seat different pods or cost "
          "differently")
    check(_outcomes(host_reg) == outcomes,
          "the cuda and cpu solves counted different relax outcomes")
    program_equal = None
    if runs.get("cuda"):
        # the program's bits on both devices, on the card scan's inputs
        _e, freed, lifted, seats = relax.eligible_partition(st, scan)
        inputs = relax.relax_inputs(st, scan, lifted, seats, freed,
                                    relax._host_feasibility(st))
        iters = relax.iter_rung(relax.configured_iters())
        bx_g, bf_g = relax._run_relax(*inputs, iters, "cuda")
        bx_c, bf_c = relax._run_relax(*inputs, iters, "cpu")
        program_equal = bx_g.tobytes() == bx_c.tobytes() and bf_g == bf_c
        check(program_equal, "the relax program's bits differ on cuda "
              "and cpu")
    return sched, scan, dict(
        pods=len(pods), groups=st.G, candidates=st.C, scan_ms=scan_ms,
        shipped_ms=shipped_ms,
        relax_ms=(_hist_sum(reg, RELAX_DURATION) - relax_s0) * 1000.0,
        outcomes=outcomes, program_runs=runs, kernel_launches=launches,
        scan_cost=scan.new_node_cost, shipped_cost=shipped.new_node_cost,
        cost_ratio=shipped.new_node_cost / scan.new_node_cost,
        scan_nodes=len(scan.nodes), shipped_nodes=len(shipped.nodes),
        cpu_plan_equal=equal, cpu_placements_tie=placements_tie(host, shipped),
        cpu_first_diff=_first_diff(shipped, host),
        program_bits_equal_cpu=program_equal, cpu_solve_s=cpu_s)


def time_relax_program(sched, scan, pods, catalog) -> dict:
    """The relax program alone on the 50,000-pod inputs (the scan's
    partition): device ms per call (CUDA events around one call, median
    of three), wall ms per call, kernel launches per call."""
    import torch

    from karpenter_tpu_torch.solver import relax

    st, _ = sched._tensorize(pods, [provisioner()], catalog, (), None)
    elig, freed, lifted, seats = relax.eligible_partition(st, scan)
    inputs = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
              for a in relax.relax_inputs(st, scan, lifted, seats, freed,
                                          relax._host_feasibility(st))]
    iters = relax.iter_rung(relax.configured_iters())

    def call():
        return relax._relax_program(*inputs, iters)

    call()
    dev_ms, wall_ms = [], []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        call()
        b.record()
        b.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1000.0)
        dev_ms.append(a.elapsed_time(b))
    return dict(shape=[list(x.shape) for x in inputs[:1] + inputs[2:3]],
                iters=iters, device_ms=statistics.median(dev_ms),
                wall_ms=statistics.median(wall_ms),
                launches_per_call=count_launches(call))


def phase_relax():
    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=True)
    t0 = time.perf_counter()
    pods = relax_pods(2500)
    sched, scan, big = relax_case(pods, catalog)
    check(big["outcomes"]["improved"] == 1 and big["outcomes"]["fallback"] == 0,
          "the rung did not improve the 50,000-pod unconstrained batch")
    program = time_relax_program(sched, scan, pods, catalog)
    _s, _scan, mixed = relax_case(relax_pods(250, spread_deps=10), catalog)
    emit("relax", unconstrained_50k=big, mixed_5k=mixed, program=program,
         phase_s=time.perf_counter() - t0)


def config4_fleet(n: int):
    """``n`` 16-cpu nodes, each holding 1–4 pods of 0.5/1/2 cpu
    (``RandomState(7)``): an under-utilised fleet."""
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.solver.types import SimNode

    rng = np.random.RandomState(7)
    nodes = []
    for i in range(n):
        node = SimNode(
            instance_type="m5.xlarge", provisioner="default", zone="zone-1a",
            capacity_type="on-demand", price=0.192,
            allocatable={"cpu": 16.0, "memory": 64 * GIB, "pods": 50.0},
            labels={ZONE: "zone-1a"}, name=f"n{i}")
        for j, c in enumerate(rng.choice([0.5, 1.0, 2.0],
                                         size=rng.randint(1, 5))):
            node.pods.append(PodSpec(name=f"n{i}-p{j}",
                                     requests={"cpu": float(c)}))
        nodes.append(node)
    return nodes


def sweep_cluster(n_nodes: int = 300, npods: int = 28):
    """``n_nodes`` existing m5.4xlarge nodes, each holding ``npods`` pods
    of 6 deployments (0.25–0.75 cpu, 0.5–3.5 GiB)."""
    from karpenter_tpu_torch.models.pod import PodSpec
    from karpenter_tpu_torch.solver.types import SimNode

    nodes = []
    for i in range(n_nodes):
        node = SimNode(
            instance_type="m5.4xlarge", provisioner="default",
            zone="zone-1a", capacity_type="on-demand", price=0.768,
            allocatable={"cpu": 16.0, "memory": 64 * GIB, "pods": 110.0},
            existing=True, name=f"sw{i}")
        node.stamp_labels()
        for j in range(npods):
            g = j % 6
            node.pods.append(PodSpec(
                name=f"sw{i}-p{j}",
                requests={"cpu": 0.25 * (1 + g % 3),
                          "memory": (0.5 + g % 4) * GIB},
                owner_key=f"d{g}"))
        nodes.append(node)
    return nodes


def _decision(res):
    return (not res.infeasible, len(res.nodes), round(res.new_node_cost, 9))


def time_screen_program(nodes) -> dict:
    """The screen program alone on the single-node screen's device inputs
    (pmax 8): device ms per call (CUDA events around one call, median of
    three), wall ms per call (ending with the result on the host), kernel
    launches per call."""
    import torch

    from karpenter_tpu_torch.solver import consolidation as cons

    captured = {}
    real = cons._screen_program

    def spy(*args):
        captured["args"] = args
        return real(*args)

    cons._screen_program = spy
    try:
        cons.screen_delete_candidates(nodes, pmax=8, device="cuda")
    finally:
        cons._screen_program = real
    args = captured["args"]

    def call():
        return real(*args)

    call()
    dev_ms, wall_ms = [], []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        out = call()
        b.record()
        out.cpu()
        wall_ms.append((time.perf_counter() - t0) * 1000.0)
        dev_ms.append(a.elapsed_time(b))
    return dict(shape=[list(t.shape) for t in args],
                device_ms=statistics.median(dev_ms),
                wall_ms=statistics.median(wall_ms),
                launches_per_call=count_launches(call))


def phase_consolidation():
    import torch

    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.solver import consolidation as cons
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    t0 = time.perf_counter()
    nodes = config4_fleet(5000)
    torch.cuda.reset_peak_memory_stats()
    cons.SCREEN_PROGRAM.reset()
    kernels.reset_counts()
    gpu = cons.screen_delete_candidates(nodes, pmax=8, measure=True,
                                        device="cuda")
    screen_runs = dict(cons.SCREEN_PROGRAM.runs)
    screen_launches = {k.name: k.launches for k in kernels.ALL}
    peak = torch.cuda.max_memory_allocated() / GIB
    check(screen_runs.get("cuda", 0) >= 1 and not screen_runs.get("cpu"),
          "the screen did not run on the card")
    t1 = time.perf_counter()
    host = cons.screen_delete_candidates(nodes, pmax=8, device="cpu")
    cpu_s = time.perf_counter() - t1
    check(gpu.deletable.tolist() == host.deletable.tolist(),
          "the cuda and cpu screens disagree")
    check(gpu.deletable.mean() > 0.5,
          "the under-utilised fleet is not mostly deletable")
    program = time_screen_program(nodes)
    screen = dict(nodes=len(nodes), deletable_frac=float(gpu.deletable.mean()),
                  eval_ms=gpu.eval_ms, first_ms=gpu.compile_ms,
                  program_runs=screen_runs, kernel_launches=screen_launches,
                  program=program,
                  peak_mem_gib=peak, cpu_s=cpu_s)

    catalog = generate_catalog(full=False)
    cluster = sweep_cluster()
    cands = [[i] for i in range(16)]
    prov = provisioner()
    sched = BatchScheduler(backend="tpu")
    kernels.reset_counts()
    sweep, sweep_ms = _synced_ms(lambda: cons.sweep_what_ifs(
        sched, cluster, cands, provisioners=[prov], instance_types=catalog,
        max_new=1))
    sweep_kernel_launches = {k.name: k.launches for k in kernels.ALL}
    check(not FAULTS.records, f"the port fell back: {FAULTS.records}")
    check(sweep.path == "batched" and sweep.n_serial == 0
          and sweep.dispatches == 1,
          f"the sweep was not one batched dispatch ({sweep.path}, "
          f"{sweep.n_serial} serial, {sweep.dispatches} dispatches)")

    def serial():
        out = []
        for k in range(len(cands)):
            others = [n for j, n in enumerate(cluster) if j != k]
            out.append(sched.solve(
                [p for p in cluster[k].pods if not p.is_daemon], [prov],
                catalog, existing_nodes=others, allow_new_nodes=True,
                max_new_nodes=1))
        return out

    serial_res, serial_ms = _synced_ms(serial)
    check([_decision(r) for r in sweep.results]
          == [_decision(r) for r in serial_res],
          "sweep decisions differ from the serial what-if loop")
    sweep_launches = count_launches(lambda: cons.sweep_what_ifs(
        sched, cluster, cands, provisioners=[prov], instance_types=catalog,
        max_new=1))
    emit("consolidation", screen=screen, sweep=dict(
        nodes=len(cluster), candidates=len(cands), path=sweep.path,
        dispatches=sweep.dispatches, n_batched=sweep.n_batched,
        n_serial=sweep.n_serial, sweep_ms=sweep_ms,
        sweep_wall_ms=sweep.wall_ms, serial_ms=serial_ms,
        sweep_launches=sweep_launches,
        kernel_launches=sweep_kernel_launches,
        deletable=sum(1 for r in sweep.results if not r.infeasible
                      and not r.nodes)),
        phase_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 9: the controllers
# ---------------------------------------------------------------------------


#: fleet sizes of the repack runs.  The reference bench's config 4 runs
#: one reconcile at 5,000 nodes and the ladder to convergence at 2,000; on
#: the card the port's what-if solves are launch-bound (about 10 s for a
#: what-if over 240 of 300 nodes), so a full evaluation at 5,000 nodes
#: does not fit this script's time: the screen step runs at 5,000, the
#: rest at these sizes (PERF.md §4)
REPACK_SIZES = {"screen": 5000, "reconcile": 300, "converge": 200,
                "parity": 100}


def provision_through_controller(catalog, limit, pods):
    """The slice's batch through ``ProvisioningController``: pods added to
    a ``ClusterState`` under the slice's provisioner, reconcile, the
    batching window passed, reconcile again.  Returns the state, the
    cloud, the scheduler, the result, the controller wall ms and the
    launch counts of that run."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.cloud.fake import FakeCloudProvider
    from karpenter_tpu_torch.controllers.provisioning import (
        ProvisioningController,
    )
    from karpenter_tpu_torch.controllers.state import ClusterState
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.utils.clock import FakeClock

    clock = FakeClock()
    state = ClusterState(clock=clock)
    state.apply_provisioner(provisioner(limit))
    cloud = FakeCloudProvider(catalog, clock=clock)
    reg = Registry()
    sched = BatchScheduler(backend="auto", registry=reg)
    ctrl = ProvisioningController(state, cloud, scheduler=sched,
                                  registry=reg, clock=clock)
    for p in pods:
        state.add_pod(p)
    kernels.reset_counts()
    t0 = time.perf_counter()
    first = ctrl.reconcile()
    clock.advance(1.5)
    res = ctrl.reconcile()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    launches = {k.name: k.launches for k in kernels.ALL}
    check(first is None, "the controller solved before its window closed")
    check(res is not None, "the controller did not solve the batch")
    return state, cloud, sched, res, wall_ms, launches


def phase_controllers(slice_limit, slice_res, pods):
    """(a) the slice's batch ``pods`` provisioned through the controller
    under the slice's limit, against the slice's plan; on the repack
    fleet at the sizes of :data:`REPACK_SIZES`, (b) the consolidation
    evaluation's screen step, one full reconcile and the ladder to
    convergence, and (c) a fleet driven to convergence on ``cuda`` and on
    ``cpu``, equal decisions."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.metrics import (
        HIER_SOLVES,
        PROVISIONER_USAGE,
        SCHEDULING_DURATION,
    )
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.repack import (
        cluster_faults,
        cluster_plan,
        one_reconcile_at,
        repack_to_convergence,
        reset_name_counters,
        screen_at,
    )
    from karpenter_tpu_torch.solver import consolidation as cons

    catalog = generate_catalog(full=True)
    t_phase = time.perf_counter()

    # (a) provisioning through the controller
    state, cloud, sched, res, wall_ms, launches = \
        provision_through_controller(catalog, slice_limit, pods)
    reg = sched.registry
    stats = dict(sched.hier_stats)
    check(reg.counter(HIER_SOLVES).get({"path": "hierarchical"}) == 1,
          "the controller's solve did not route hierarchically")
    check(launches["price_step_score"] >= 1
          and launches["price_step_score"] == stats["price_iters"],
          "price_step_score launches != price iterations in the "
          "controller's solve")
    check(launches["packed_score"] == 0,
          "the controller's solve launched the price-row entry")
    equal = plan(res) == plan(slice_res)
    tie = placements_tie(res, slice_res)
    check(equal or tie, "the controller's plan differs from the slice's")
    # every pod of the plan bound to a node that exists (the slice's plan
    # leaves none infeasible; a smaller batch may)
    faults = cluster_faults(state, cloud, unbound_ok=res.infeasible)
    check(not faults, f"the provisioned cluster is unsound: {faults[:5]}")
    raw_cap = {it.name: it.capacity for it in catalog}
    shipped = sum(raw_cap[ns.node.instance_type]["cpu"]
                  for ns in state.nodes.values())
    check(shipped <= slice_limit * (1.0 + 1e-6),
          f"shipped cpu {shipped} exceeds the limit {slice_limit}")
    usage = reg.gauge(PROVISIONER_USAGE).get(
        {"provisioner": "default", "resource_type": "cpu"})
    check(abs(usage - shipped) <= 1e-6 * shipped,
          f"the usage gauge ({usage}) disagrees with the launched nodes")
    provision = dict(
        pods=len(pods), nodes=len(state.nodes), cost=res.new_node_cost,
        infeasible=len(res.infeasible), bound=len(state.bindings),
        cpu_limit=slice_limit, cpu_shipped=shipped, plan_equal=equal,
        placements_tie=tie, controller_wall_ms=wall_ms,
        solve_wall_ms=_hist_sum(reg, SCHEDULING_DURATION) * 1000.0,
        hier_total_ms=stats.get("total_ms"),
        price_iters=stats.get("price_iters"), launches=launches)
    del state, cloud, sched, res
    emit("controllers_provision", **provision)

    # (b) the evaluation's screen step at config-4 width, one full
    # reconcile, then the ladder to convergence
    reset_name_counters()
    kernels.reset_counts()
    screen = screen_at(catalog, REPACK_SIZES["screen"], None)
    screen["kernel_launches"] = {k.name: k.launches for k in kernels.ALL}
    check(screen["screen_program_runs"] == {"cuda": 1},
          "the controller's screen step did not run once on the card")
    check(screen["singles_deletable"] > screen["candidates"] // 2,
          "the under-utilised fleet is not mostly deletable")
    check(not any(screen["kernel_launches"].values()),
          "a hand-written kernel launched on the screen step")
    emit("controllers_screen", **screen)

    reset_name_counters()
    _state, reconcile = one_reconcile_at(catalog, REPACK_SIZES["reconcile"],
                                         None)
    check(reconcile["screen_program_runs"].get("cuda", 0) >= 1
          and not reconcile["screen_program_runs"].get("cpu"),
          "the reconcile's screen did not run on the card")
    check(reconcile["proposed"] is not None,
          "the full reconcile proposed no action")
    check(not any(reconcile["kernel_launches"].values()),
          "a hand-written kernel launched on the consolidation path")
    check(not reconcile["settled_faults"],
          f"the settled cluster is unsound: {reconcile['settled_faults']}")
    del _state
    emit("controllers_reconcile", **reconcile)

    reset_name_counters()
    cons.SCREEN_PROGRAM.reset()
    kernels.reset_counts()
    state, repack, _keys = repack_to_convergence(
        catalog, REPACK_SIZES["converge"], "auto", None)
    repack["kernel_launches"] = {k.name: k.launches for k in kernels.ALL}
    check(not any(repack["kernel_launches"].values()),
          "a hand-written kernel launched on the repack path")
    check(repack["pending_end"] == 0, "pods left pending after the repack")
    faults = cluster_faults(state)
    check(not faults, f"the repacked cluster is unsound: {faults[:5]}")
    check(repack["final_cost"] < repack["initial_cost"],
          "the repack did not lower the fleet's cost")
    repack["screen_program_runs"] = dict(cons.SCREEN_PROGRAM.runs)
    check(repack["screen_program_runs"].get("cuda", 0) >= 1
          and not repack["screen_program_runs"].get("cpu"),
          "the repack's screens did not run on the card")
    del state
    emit("controllers_repack", **repack)

    # (c) the same decisions on cuda and on cpu
    runs = {}
    for dev in ("cuda", "cpu"):
        reset_name_counters()
        cons.SCREEN_PROGRAM.reset()
        t0 = time.perf_counter()
        st, info, keys = repack_to_convergence(
            catalog, REPACK_SIZES["parity"], "auto", dev)
        runs[dev] = (keys, cluster_plan(st), dict(st.bindings), info,
                     time.perf_counter() - t0)
        faults = cluster_faults(st)
        check(not faults, f"the {dev} parity cluster is unsound: "
              f"{faults[:5]}")
        check(set(cons.SCREEN_PROGRAM.runs) == {dev},
              f"the {dev} parity run screened on {cons.SCREEN_PROGRAM.runs}")
    (kg, pg, bg, ig, tg), (kc, pc, bc, ic, tc) = runs["cuda"], runs["cpu"]
    check(kg == kc, f"cuda and cpu decided differently: {kg} vs {kc}")
    check(pg == pc and bg == bc,
          "cuda and cpu converged to different clusters")
    check(ig["final_cost"] < ig["initial_cost"] and ig["pending_end"] == 0,
          "the parity fleet did not converge")
    check(not FAULTS.records, f"the port fell back: {FAULTS.records}")
    emit("controllers_parity", nodes=REPACK_SIZES["parity"], actions=len(kg),
         action_nodes=ig["action_nodes"], decisions_equal=True,
         final_plan_equal=True, nodes_end=ig["nodes_end"],
         final_cost=ig["final_cost"], cuda_s=tg, cpu_s=tc,
         cuda_phase_s=ig["phase_s"], cpu_phase_s=ic["phase_s"])
    emit("controllers", phase_s=time.perf_counter() - t_phase)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on "
              "the GPU and has nothing to do here", file=sys.stderr)
        return 2
    try:
        import karpenter_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: karpenter_tpu_torch is not importable; run "
              "from the repository root", file=sys.stderr)
        return 2
    from karpenter_tpu_torch import kernels

    logging.getLogger("karpenter_tpu_torch").addHandler(FAULTS)
    try:
        smi = phase_device()
        phase_build()
        max_err = phase_kernel()
        st, stats, launches, limit, slice_res = phase_slice(40, 2500)
        timing = phase_timing(st, stats)
        phase_parity(8, 250)
        phase_relax()
        phase_consolidation()
        phase_controllers(limit, slice_res, deployments(40, 2500))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    replaces = "karpenter_tpu/solver/hierarchy.py:388"
    table = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": kernel.repo_path,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": max_err[name],
        "ms": timing[key]["kernel_ms"],
        "plain_ms": timing[key]["plain_ms"],
        "bound_ms": timing[key]["bound_ms"],
        "bound_by": timing[key]["bound_by"],
        "library_ms": timing[key]["library_ms"],
        "parity": "byte-equal",
    } for name, kernel, key in (
        ("packed_score", kernels.PACKED_SCORE, "packed"),
        ("price_step_score", kernels.PRICE_STEP_SCORE, "step"))]}
    RECORD["kernels"] = table["kernels"]
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    print(smi)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
