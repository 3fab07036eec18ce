"""Profile one hierarchical block wave of the port on the CUDA card.

    python -m karpenter_tpu_torch.profile_wave [--deployments 40] [--per 2500]

Builds the 100k-pod slice batch (zone-spread deployments against the full
catalog, as ``chip_smoke.py`` does), partitions it into blocks, runs one
warm block wave, then traces a second one with ``torch.profiler`` (CPU +
CUDA activities).  Prints one JSON line — wave wall ms on the host clock,
device kernel launches and their summed device time, the device busy
share of the wave, launches per group step, and the top kernels by device
time — and writes it to ``chiprun_out/profile_wave.json``.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path


def _slice_pods(nd: int, per: int):
    from .models.pod import LabelSelector, PodSpec, TopologySpreadConstraint

    gib = 1024.0 ** 3
    pods = []
    for d in range(nd):
        sel = LabelSelector.of({"app": f"h{d}"})
        for i in range(per):
            pods.append(PodSpec(
                name=f"h{d}-{i}", labels={"app": f"h{d}"},
                requests={"cpu": 0.25 * (1 + d % 8),
                          "memory": (0.5 + (d % 6)) * gib},
                topology_spread=[TopologySpreadConstraint(
                    1, "topology.kubernetes.io/zone", "DoNotSchedule", sel)],
                owner_key=f"h{d}"))
    return pods


def profile_wave(nd: int, per: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .models.catalog import generate_catalog
    from .models.provisioner import Provisioner
    from .solver import hierarchy as hier
    from .solver.scheduler import BatchScheduler
    from .solver.tpu import MEGA_MAX_SLOTS

    sched = BatchScheduler(backend="auto")
    pods = _slice_pods(nd, per)
    provs = [Provisioner(name="default").with_defaults()]
    st, _ = sched._tensorize(pods, provs, generate_catalog(full=True), (),
                             None)
    masks = hier.partition_blocks(st, hier.coupling_components(st),
                                  MEGA_MAX_SLOTS)
    budgets = hier.block_budgets(st, masks)
    dims = hier.hier_dims(st, max(budgets))
    entries, _ = hier.build_block_entries(sched._tpu, st, masks, budgets, dims)

    sched._tpu.solve_many_prepared(entries)  # warm: allocator, libraries
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched._tpu.solve_many_prepared(entries)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0

    kernels = defaultdict(lambda: [0, 0.0])
    spans = []
    n_copy = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = (e.time_range.end - e.time_range.start) / 1000.0  # ms
        if e.name.startswith(("Memcpy", "Memset")):
            n_copy += 1
            continue
        kernels[e.name][0] += 1
        kernels[e.name][1] += dur
        spans.append((e.time_range.start, e.time_range.end))
    busy = 0.0
    end = None
    for a, b in sorted(spans):  # union of kernel intervals, us
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    n_launch = sum(c for c, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return dict(
        device=torch.cuda.get_device_name(0), pods=len(pods),
        blocks=len(masks), dims=dict(G=dims["G"], C=dims["C"],
                                     NR=dims["NR"], Z=dims["Z"]),
        wave_wall_ms=wall_ms, kernel_launches=n_launch, copies=n_copy,
        launches_per_group_step=n_launch / dims["G"],
        device_kernel_ms=sum(t for _, t in kernels.values()),
        device_busy_ms=busy / 1000.0,
        device_busy_share=(busy / 1000.0) / wall_ms if wall_ms else None,
        top_kernels=[dict(name=k[:80], launches=c, ms=t)
                     for k, (c, t) in top],
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--deployments", type=int, default=40)
    ap.add_argument("--per", type=int, default=2500)
    args = ap.parse_args()
    out = profile_wave(args.deployments, args.per)
    line = json.dumps(out)
    print(line)
    dest = Path("chiprun_out")
    dest.mkdir(exist_ok=True)
    (dest / "profile_wave.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
