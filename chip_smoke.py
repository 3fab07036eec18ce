#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``karpenter_tpu_torch``) on one NVIDIA GPU and
check it end to end.  Run from the repository root: ``python3 chip_smoke.py``.

Phases, each printing one JSON line (any failure exits non-zero and prints
no result):

1. device — ``nvidia-smi`` name and power limit, torch/CUDA versions;
2. build — every kernel compiled from ``karpenter_tpu_torch/csrc`` with
   nvcc for ``sm_90a`` (one nvcc per source, started together);
3. kernel — each kernel's wrapper against its plain PyTorch version on
   the card, byte-equal, on tie / all-infeasible / tile / large cases;
4. slice — the main path: ``BatchScheduler(backend="auto").solve`` of a
   100,000-pod scale-up (40 zone-spread deployments x 2,500 pods against
   the full catalog) under a provisioner ``limits.cpu`` at 99% of the
   unconstrained buy.  It must route hierarchically, run price iterations
   that launch the packed-score kernel, keep the shipped cpu within the
   limit and leave every pod seated or typed infeasible.  Launch counts
   are zeroed just before this run and read just after;
5. timing — each kernel, its plain version and a one-call PyTorch
   yardstick at the main path's shapes (CUDA events), beside the bound;
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
         sources=[k.repo_path for k in kernels.ALL],
         libraries=[k.library_path().name for k in kernels.ALL])


def _score_case(G, C, seed, p=0.6, ties=True):
    from karpenter_tpu_torch.models.tensorize import (
        pack_feasibility,
        pack_scores,
    )

    rng = np.random.default_rng(seed)
    feas = rng.random((G, C)) < p
    price = rng.uniform(0.1, 9.0, size=C).astype(np.float32)
    if ties:
        price[C // 2:] = price[: C - C // 2]
    return pack_feasibility(feas), pack_scores(price)


def phase_kernel():
    """Kernel vs plain version on the card, byte-equal, per case."""
    import torch

    from karpenter_tpu_torch.models.tensorize import (
        pack_feasibility,
        pack_scores,
    )
    from karpenter_tpu_torch.solver.hierarchy import (
        packed_scan_scores,
        packed_scan_scores_plain,
    )

    cases = {
        "ties_5x7": _score_case(5, 7, 3),
        "tile_32x128": _score_case(32, 128, 9),
        "slice_40x425": _score_case(40, 425, 5, p=0.3),
        "large_4096x1024": _score_case(4096, 1024, 13, ties=False),
        "all_infeasible": (
            pack_feasibility(np.array([[0, 0, 0], [1, 0, 1]], dtype=bool)),
            pack_scores(np.array([1.0, 2.0, 0.5], dtype=np.float32))),
        "sentinel_prices": (
            pack_feasibility(np.array([[1, 0, 1]], dtype=bool)),
            pack_scores(np.full(3, 3.0e38, dtype=np.float32))),
    }
    out = {}
    max_err = 0.0
    for name, (f_np, p_cpu) in cases.items():
        f = torch.from_numpy(f_np).cuda()
        p = p_cpu.cuda()
        c_k, i_k = packed_scan_scores(f, p)
        c_p, i_p = packed_scan_scores_plain(f, p)
        torch.cuda.synchronize()
        c_cpu, i_cpu = packed_scan_scores_plain(torch.from_numpy(f_np), p_cpu)
        same = (c_k.cpu().numpy().tobytes() == c_p.cpu().numpy().tobytes()
                and i_k.cpu().numpy().tobytes() == i_p.cpu().numpy().tobytes()
                and c_k.cpu().numpy().tobytes() == c_cpu.numpy().tobytes()
                and i_k.cpu().numpy().tobytes() == i_cpu.numpy().tobytes())
        err = float((c_k - c_p).abs().max().item())
        max_err = max(max_err, err)
        out[name] = dict(shape=list(f_np.shape), byte_equal=same,
                         max_abs_err=err)
        check(same, f"packed_score kernel differs from its plain version "
              f"on {name}")
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
    check(launches["packed_score"] >= 1,
          "the main path launched the packed_score kernel no time")
    check(launches["packed_score"] == stats["price_iters"],
          "packed_score launches != price iterations")
    emit("slice", pods=len(pods), groups=st.G, candidates=st.C,
         zones=st.n_zones, blocks=stats["blocks"], waves=stats["waves"],
         price_iters=stats["price_iters"], dispatches=stats["dispatches"],
         wall_ms=wall_ms, tensorize_ms=stats["tensorize_ms"],
         partition_ms=stats["partition_ms"], entries_ms=stats["entries_ms"],
         wave_ms=stats["wave_ms"], score_ms=stats["score_ms"],
         repair_ms=stats["repair_ms"], repair_pods=stats["repair_pods"],
         hier_total_ms=stats["total_ms"],
         nodes=len(res.nodes), cost=res.new_node_cost,
         infeasible=len(res.infeasible), cpu_limit=limit,
         cpu_shipped=shipped, free_nodes=len(free.nodes),
         free_cost=free.new_node_cost, launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / GIB,
         phase_s=time.perf_counter() - t0)
    return st, launches


def _time_score(f, price) -> dict:
    """Kernel, plain version and one-call yardstick on ``f``/``price``
    (CUDA tensors), in turns, beside the bound for this shape."""
    import torch

    from karpenter_tpu_torch.solver.hierarchy import (
        _BIG,
        packed_scan_scores,
        packed_scan_scores_plain,
    )

    G, C = f.shape

    def library():
        return torch.min(torch.where(f > 0, price.float()[None, :], _BIG),
                         dim=1)

    fns = {"kernel": lambda: packed_scan_scores(f, price),
           "plain": lambda: packed_scan_scores_plain(f, price),
           "library": library}
    runs = {k: [] for k in fns}
    calls = {k: [] for k in fns}
    for order in (("plain", "kernel", "library"),
                  ("library", "kernel", "plain")):
        for k in order:
            runs[k].append(_time_graph(fns[k]))
            calls[k].append(_time(fns[k]))
    bytes_moved = G * C + 2 * C + 8 * G
    ops = 2 * G * C  # one select + one compare per cell
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1000.0
    bound_ops = ops / F32_FLOPS * 1000.0
    return dict(shape=[G, C], kernel_ms=statistics.median(runs["kernel"]),
                plain_ms=statistics.median(runs["plain"]),
                library_ms=statistics.median(runs["library"]),
                call_ms={k: statistics.median(v) for k, v in calls.items()},
                runs=runs, bytes=bytes_moved, ops=ops,
                bound_ms=max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops else "operations")


def phase_timing(st):
    """Timing at the main path's score inputs (the slice's feasibility and
    base prices), and at a large 4096 x 1024 case for the kernel's
    bandwidth behaviour."""
    import torch

    from karpenter_tpu_torch.models.tensorize import (
        pack_feasibility,
        pack_scores,
    )
    from karpenter_tpu_torch.solver.relax import _host_feasibility

    f = torch.from_numpy(pack_feasibility(_host_feasibility(st))).cuda()
    price = pack_scores(
        np.asarray(st.cand_price, dtype=np.float32).min(axis=1)).cuda()
    out = _time_score(f, price)
    f_l, p_l = _score_case(4096, 1024, 13, ties=False)
    out["large"] = _time_score(torch.from_numpy(f_l).cuda(), p_l.cuda())
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
        st, launches = phase_slice(40, 2500)
        timing = phase_timing(st)
        phase_parity(8, 250)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    table = {"kernels": [{
        "name": "packed_score",
        "route": "cuda",
        "source": kernels.PACKED_SCORE.repo_path,
        "replaces": "karpenter_tpu/solver/hierarchy.py:388",
        "launches": launches["packed_score"],
        "max_abs_err": max_err,
        "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "parity": "byte-equal",
    }]}
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
