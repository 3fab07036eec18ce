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
   ``cuda`` and on ``cpu``: the node plans must agree.

The last two lines are the kernel table (``{"kernels": [...]}``) and
``{"ok": true, "device": {...}}``; the ``nvidia-smi`` line precedes them.
Everything is also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
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
    from karpenter_tpu_torch.metrics import HIER_SOLVES
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    sched = BatchScheduler(backend="auto", device=device)
    free = sched.solve(pods, [provisioner()], catalog)
    check(bool(sched.hier_stats), "unconstrained solve did not route "
          "hierarchically")
    st, _ = sched._tensorize(pods, [provisioner()], catalog, (), None)
    limit = round(cpu_bought(st, free.nodes) * 0.99, 1)

    hier_before = sched.registry.counter(HIER_SOLVES).get(
        {"path": "hierarchical"})
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
         nodes=len(res.nodes), cost=res.new_node_cost,
         infeasible=len(res.infeasible), cpu_limit=limit,
         cpu_shipped=shipped, free_nodes=len(free.nodes),
         free_cost=free.new_node_cost, launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / GIB,
         phase_s=time.perf_counter() - t0)
    return st, stats, launches


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

    try:
        smi = phase_device()
        phase_build()
        max_err = phase_kernel()
        st, stats, launches = phase_slice(40, 2500)
        timing = phase_timing(st, stats)
        phase_parity(8, 250)
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
