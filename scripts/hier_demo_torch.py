#!/usr/bin/env python
"""The million-pod hierarchical walk on the PyTorch/CUDA port.

The port of ``scripts/hier_demo.py`` over ``karpenter_tpu_torch``: the
same three acts, the same batches, the same output lines and the same
exit rule, on the CUDA card.

1. Partition the real 1M-pod group shape (400 deployments, carried by
   25-pod proxies): constraint-reachability components -> LPT-packed
   megabatch blocks.
2. A real hierarchical solve on ``BatchScheduler(backend="tpu")``: the
   free 8 x 1,250 batch twice (the second run's stats are the steady
   state the model projects from), then the same batch under a cpu limit
   at 99% of the unconstrained buy, so the blocks contend and the dual
   price loop runs.  Each price iteration launches the packed-score
   kernel's ``price_step_scores`` entry once.  Prints blocks, waves,
   dispatches, price iterations, repaired and tail-repacked pods, the
   wall, nodes and infeasible pods.
3. The scale model seeded with the free run's stats and this run's own
   per-pod wave rate: the projected 1M wall against the 250 ms budget.

Exits 0 when the projection is under the budget, 1 otherwise (the
reference's rule).  The port's group loop is launch-bound on the card, so
the projection is expected to FAIL there.

    python scripts/hier_demo_torch.py                # on the card
    python scripts/hier_demo_torch.py --device cpu   # on the host

Without ``--device`` it raises on a machine without a card.  ``run``
returns every figure the lines print, the plans and the kernel launches
of the contended solve, and the node-name counter that solve started
from, so a caller can replay it on another device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GIB = 1024 ** 3
HIER_BUDGET_MS = 250.0


def deployments(nd: int, per: int, tag: str = "hd"):
    """``nd`` zone-spread deployments of ``per`` pods (the reference
    demo's shapes: cpu 0.25-2.0, memory 0.5-5.5 GiB, one selector and
    owner per deployment)."""
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )

    pods = []
    for d in range(nd):
        sel = LabelSelector.of({"app": f"{tag}{d}"})
        pods.extend(
            PodSpec(
                name=f"{tag}{d}-{i}",
                labels={"app": f"{tag}{d}"},
                requests={"cpu": 0.25 * (1 + d % 8),
                          "memory": (0.5 + (d % 6)) * GIB},
                topology_spread=[TopologySpreadConstraint(
                    1, L.ZONE, "DoNotSchedule", sel)],
                owner_key=f"{tag}{d}",
            )
            for i in range(per)
        )
    return pods


def partition(catalog, provs, nd: int = 400, per: int = 25) -> dict:
    """Act 1: the 1M group shape (``nd`` deployments as ``per``-pod
    proxies) through coupling components, LPT block packing and block
    budgets; the budget is scaled to 1M real pods."""
    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.solver import hierarchy as hier

    proxy = deployments(nd, per)
    st = tensorize(proxy, provs, catalog)
    t0 = time.perf_counter()
    comps = hier.coupling_components(st)
    masks = hier.partition_blocks(st, comps, 32)
    budgets = hier.block_budgets(st, masks)
    part_ms = (time.perf_counter() - t0) * 1000.0
    scale = 1_000_000 / len(proxy)
    return {"groups": st.G, "components": len(comps), "blocks": len(masks),
            "max_budget": int(round(max(budgets) * scale)),
            "part_ms": part_ms}


def bought_cpu(sched, pods, provs, catalog, nodes) -> float:
    """The cpu capacity of ``nodes``, as the tensorized batch counts it."""
    st = sched._tensorize(pods, provs, catalog, (), ())[0]
    return sum(float(st.capacity_row(n.instance_type, n.allocatable)[0])
               for n in nodes)


def limited(cpu: float):
    """The default provisioner with ``limits.cpu`` at ``cpu``."""
    from karpenter_tpu_torch.models.provisioner import Provisioner

    lim = Provisioner(name="default").with_defaults()
    lim.limits = {"cpu": cpu}
    return lim


def node_counter() -> int:
    from karpenter_tpu_torch.solver import types

    with types._node_lock:
        return types._node_next


def run(device=None, backend: str = "tpu", nd: int = 8, per: int = 1250,
        catalog=None, verbose: bool = True) -> dict:
    """The three acts on ``device`` (``None``: the card, raising without
    one).  Prints the reference's lines when ``verbose``.  Returns the
    partition, the free and contended stats and results, the limit, the
    contended solve's kernel launches and starting node-name counter, the
    model and the verdict."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.solver import hierarchy as hier
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    say = print if verbose else (lambda *a, **k: None)
    catalog = catalog if catalog is not None else generate_catalog(full=False)
    sched = BatchScheduler(backend=backend, compile_behind=False,
                           device=device)
    out = {"device": str(sched.device)}
    say(f"== 1M-pod hierarchical walk ({sched.device}) ==")

    # ---- act 1: partition the real 1M group shape ----------------------
    provs = [Provisioner(name="default").with_defaults()]
    part = partition(catalog, provs)
    out["partition"] = part
    say(f"partition: {part['groups']} groups -> {part['components']} "
        f"components -> {part['blocks']} blocks (max budget "
        f"{part['max_budget']}) in {part['part_ms']:.1f} ms")

    # ---- act 2: a real hierarchical solve ------------------------------
    pods = deployments(nd, per, tag="hw")
    out["pods"] = pods
    # the first run pays the allocator's growth and the kernel library's
    # load; the second run's stats are the steady state the model
    # projects from
    hier.solve_hierarchical(sched, pods, provs, catalog, stats={})
    stats_free: dict = {}
    free = hier.solve_hierarchical(sched, pods, provs, catalog,
                                   stats=stats_free)
    if free is None:
        say("hierarchical solve fell back to flat — demo aborted")
        return dict(out, aborted=True, verdict=None)
    # a provisioner limit just under the unconstrained buy makes the
    # blocks contend for shared capacity, so the dual price loop runs
    bought = bought_cpu(sched, pods, provs, catalog, free.nodes)
    lim = limited(round(bought * 0.99, 1))
    say(f"unconstrained buy: {len(free.nodes)} nodes, "
        f"{bought:.0f} cpu capacity; limiting cpu to "
        f"{lim.limits['cpu']:.0f} to force cross-block contention")
    stats: dict = {}
    names_at = node_counter()
    before = kernels.counts()
    res = hier.solve_hierarchical(sched, pods, [lim], catalog, stats=stats)
    launches = {k: n - before[k] for k, n in kernels.counts().items()}
    out.update(free=free, stats_free=stats_free, bought=bought,
               limit_cpu=lim.limits["cpu"], names_at=names_at, result=res,
               stats=stats, launches=launches)
    if res is None:
        say("hierarchical solve fell back to flat — demo aborted")
        return dict(out, aborted=True, verdict=None)
    say(f"measured {len(pods)}-pod contended solve: "
        f"{stats['blocks']} blocks, {stats['waves']} wave(s) "
        f"({stats['dispatches']} dispatches, 1 per wave), "
        f"{stats['price_iters']} price iteration(s), "
        f"{stats['repair_pods']} repaired, "
        f"{stats['tail_repack_pods']} tail-repacked, "
        f"{stats['total_ms']:.0f} ms wall "
        f"({len(res.nodes)} nodes, {len(res.infeasible)} infeasible)")

    # ---- act 3: the 1M projection --------------------------------------
    # seeded from the UNCONTENDED stats, as the reference does; the device
    # per-pod rate is this run's own last free wave (the port's
    # scale_model takes no constant from another machine)
    block_pods = stats_free["n_pods"] / max(1, stats_free["blocks"])
    model = hier.scale_model(
        {"n_pods": 1_000_000, "blocks": part["blocks"],
         "waves": stats_free["waves"], "partition_ms": part["part_ms"],
         "entries_ms": stats_free["entries_ms"]
         * (part["groups"] / max(1, part["blocks"])),
         "repair_ms": stats_free["repair_ms"],
         "device_per_pod_us": stats_free["wave_ms"][-1] * 1000.0
         / max(block_pods, 1.0)},
        1_000_000)
    verdict = "PASS" if model["total_ms"] < HIER_BUDGET_MS else "FAIL"
    say(f"modeled 1M wall: host {model['host_ms']:.1f} ms + "
        f"{model['waves']} wave(s) x {model['wave_ms']:.1f} ms + "
        f"repair {model['repair_ms']:.1f} ms -> "
        f"{model['total_ms']:.1f} ms  "
        f"[{verdict}: budget {HIER_BUDGET_MS:.0f} ms]")
    out.update(model=model, verdict=verdict, aborted=False)
    return out


def contended(device, pods, limit_cpu: float, names_at: int,
              backend: str = "tpu", catalog=None):
    """The contended solve alone on ``device``, from node-name counter
    ``names_at``: the replay of :func:`run`'s act 2 on another device.
    Returns ``(result, stats)``."""
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.solver import hierarchy as hier
    from karpenter_tpu_torch.solver import types
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    catalog = catalog if catalog is not None else generate_catalog(full=False)
    sched = BatchScheduler(backend=backend, compile_behind=False,
                           device=device)
    with types._node_lock:
        types._node_next = names_at
    stats: dict = {}
    res = hier.solve_hierarchical(sched, pods, [limited(limit_cpu)], catalog,
                                  stats=stats)
    return res, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default the CUDA card, raising "
                         "without one; 'cpu' runs on the host)")
    ap.add_argument("--backend", default="tpu", choices=["tpu", "auto"],
                    help="the scheduler's backend (the reference fixes tpu)")
    args = ap.parse_args(argv)
    out = run(device=args.device, backend=args.backend)
    if out["verdict"] is None:
        return 1
    return 0 if out["verdict"] == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
