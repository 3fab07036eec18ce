#!/usr/bin/env python3
"""Time the port's meshed 100k-pod hierarchical solve against the unmeshed
one on the card(s), in one process.

Runs ``chip_smoke.py``'s device, build and slice phases (phase 4: the
limited 100k-pod solve of slice1-hier-100k), then the same limited solve
again from phase 4's node-name counter through
``BatchScheduler(backend="auto")`` and through
``BatchScheduler(backend="auto", mesh=make_mesh(n))`` for each ``n`` of
``--cards``, in a mirrored order (plain, meshes, meshes reversed, plain)
so that a drift over the run shows as a difference between the two
readings of one arm.  Every run must give phase 4's plan.  Each run
records its wall, the hierarchy's wave and repair times, the
``price_step_scores`` launches and the megabatch blocks it enqueued on
each card.  Then ``chip_smoke.py``'s phase 14(b) (eight virtual shards on
``cuda:0``) runs once.

    python3 scripts/mesh_probe_torch.py                # --cards 1
    python3 scripts/mesh_probe_torch.py --cards 1 4    # a 4-card machine

Prints one ``MESHPROBE {...}`` JSON line and writes it to
``chiprun_out/mesh_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _sync_all() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, nargs="+", default=[1])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.parallel.mesh import make_mesh
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.solver.tpu import TpuSolver

    logging.getLogger("karpenter_tpu_torch").addHandler(cs.FAULTS)
    t_start = time.perf_counter()
    smi = cs.phase_device()
    cs.phase_build()
    _st, stats, _l, limit, slice_res = cs.phase_slice(40, 2500)

    catalog = generate_catalog(full=True)
    pods = cs.deployments(40, 2500)
    provs = [cs.provisioner(limit)]
    scheds = {"plain": BatchScheduler(backend="auto")}
    for n in args.cards:
        scheds[f"mesh{n}"] = BatchScheduler(backend="auto",
                                            mesh=make_mesh(n))
    arms = list(scheds)
    order = arms + arms[1:][::-1] + arms[:1]

    blocks: Counter = Counter()
    real = TpuSolver._enqueue_entries

    def spy(self, entries, *a, device=None, **kw):
        blocks[str(self.device if device is None else device)] += 1
        return real(self, entries, *a, device=device, **kw)

    TpuSolver._enqueue_entries = spy
    runs = []
    try:
        for arm in order:
            sched = scheds[arm]
            cs.names_from(stats["names_at"])
            kernels.reset_counts()
            blocks.clear()
            _sync_all()
            t0 = time.perf_counter()
            res = sched.solve(pods, provs, catalog)
            _sync_all()
            wall_ms = (time.perf_counter() - t0) * 1000.0
            hs = dict(sched.hier_stats)
            cs.check(cs.plan(res) == cs.plan(slice_res),
                     f"the {arm} run's plan differs from phase 4's")
            runs.append(dict(
                arm=arm, wall_ms=wall_ms, wave_ms=hs["wave_ms"],
                repair_ms=hs["repair_ms"], waves=hs["waves"],
                dispatches=hs["dispatches"], blocks_per_device=dict(blocks),
                price_step_score={k.name: k.launches for k in kernels.ALL}[
                    "price_step_score"],
                nodes=len(res.nodes), cost=res.new_node_cost,
                infeasible=len(res.infeasible)))
            print("MESHRUN " + json.dumps(runs[-1]), flush=True)
    finally:
        TpuSolver._enqueue_entries = real

    virtual = cs.mesh_virtual_8()
    out = dict(nvidia_smi=smi, cards=torch.cuda.device_count(),
               slice_wall_ms=cs.RECORD["slice"]["wall_ms"], runs=runs,
               virtual_8=virtual, seconds=time.perf_counter() - t_start)
    line = json.dumps(out, default=str)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "mesh_probe.json"), "w") as f:
        f.write(line + "\n")
    print("MESHPROBE " + line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
