#!/usr/bin/env python3
"""Compare the PyTorch port with the JAX reference on the CPU, at full size.

    JAX_PLATFORMS=cpu python3 port_parity.py [--deployments 40] [--per 2500]

The hierarchical case builds the same batch with each package's models
(``--deployments`` zone-spread deployments of ``--per`` pods against the
full catalog), runs each package's ``BatchScheduler`` unconstrained and
then under a cpu limit at 99% of what the reference bought (``relax=False``
on the reference, whose relax program would otherwise be cold on the
first solve; every deployment is spread, so the rung skips anyway).
The relax case: 20 complementary unconstrained deployments of 250 pods
(the reference bench's ``_relax_pods``), solved by both packages at the
default ``relax``, the reference's relax program compiled first.
Prints one JSON line: node counts, costs, infeasible counts, price
iterations, relax outcomes, and whether the node plans are equal or meet
``placements_tie``.  The port runs with ``device="cpu"``; the numbers are
a correctness check, not device timings.
"""

from __future__ import annotations

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--deployments", type=int, default=40)
    ap.add_argument("--per", type=int, default=2500)
    args = ap.parse_args()
    out: dict = {}
    ok = hier_case(args, out) & relax_case(out)
    print(json.dumps(out))
    return 0 if ok else 1


def hier_case(args, out) -> bool:
    import chip_smoke as cs
    from karpenter_tpu.metrics import HIER_SOLVES as REF_HIER_SOLVES
    from karpenter_tpu.models import labels as RL
    from karpenter_tpu.models.catalog import generate_catalog as ref_catalog
    from karpenter_tpu.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )
    from karpenter_tpu.models.provisioner import Provisioner as RefProv
    from karpenter_tpu.solver.scheduler import BatchScheduler as RefSched
    from karpenter_tpu_torch.models.catalog import generate_catalog

    gib = 1024.0 ** 3
    ref_pods = [
        PodSpec(name=f"h{d}-{i}", labels={"app": f"h{d}"},
                requests={"cpu": 0.25 * (1 + d % 8),
                          "memory": (0.5 + (d % 6)) * gib},
                topology_spread=[TopologySpreadConstraint(
                    1, RL.ZONE, "DoNotSchedule",
                    LabelSelector.of({"app": f"h{d}"}))],
                owner_key=f"h{d}")
        for d in range(args.deployments) for i in range(args.per)]
    ref_cat = ref_catalog(full=True)

    def ref_prov(limit=None):
        p = RefProv(name="default").with_defaults()
        if limit is not None:
            p.limits = {"cpu": limit}
        return p

    sched = RefSched(backend="tpu", compile_behind=False)
    t0 = time.perf_counter()
    ref_free = sched.solve(ref_pods, [ref_prov()], ref_cat, relax=False)
    st_ref = sched._tensorize(ref_pods, [ref_prov()], ref_cat, (), None)[0]
    limit = round(cs.cpu_bought(st_ref, ref_free.nodes) * 0.99, 1)
    hier0 = sched.registry.counter(REF_HIER_SOLVES).get(
        {"path": "hierarchical"})
    ref_lim = sched.solve(ref_pods, [ref_prov(limit)], ref_cat, relax=False)
    out["ref_s"] = time.perf_counter() - t0
    out["ref_limited_routed_hierarchically"] = (
        sched.registry.counter(REF_HIER_SOLVES).get({"path": "hierarchical"})
        == hier0 + 1)

    t0 = time.perf_counter()
    (_s, _st, port_limit, free, lim, stats, _w, _l,
     _shipped) = cs.limited_solve("cpu", cs.deployments(args.deployments,
                                                        args.per),
                                  generate_catalog(full=True))
    out["port_s"] = time.perf_counter() - t0
    out.update(
        pods=len(ref_pods), cpu_limit=[limit, port_limit],
        free_nodes=[len(ref_free.nodes), len(free.nodes)],
        free_cost=[ref_free.new_node_cost, free.new_node_cost],
        free_plans_equal=cs.plan(ref_free) == cs.plan(free),
        limited_nodes=[len(ref_lim.nodes), len(lim.nodes)],
        limited_cost=[ref_lim.new_node_cost, lim.new_node_cost],
        limited_infeasible=[len(ref_lim.infeasible), len(lim.infeasible)],
        port_price_iters=stats["price_iters"],
        port_repair_pods=stats["repair_pods"],
        limited_plans_equal=cs.plan(ref_lim) == cs.plan(lim),
        limited_placements_tie=cs.placements_tie(ref_lim, lim),
    )
    return out["free_plans_equal"] and (
        out["limited_plans_equal"] or out["limited_placements_tie"])


def relax_case(out) -> bool:
    import bench
    import karpenter_tpu.solver.relax as ref_relax
    from karpenter_tpu.metrics import RELAX_TOTAL as REF_RELAX_TOTAL
    from karpenter_tpu.metrics import Registry as RefRegistry
    from karpenter_tpu.models.catalog import generate_catalog as ref_catalog
    from karpenter_tpu.models.provisioner import Provisioner as RefProv
    from karpenter_tpu.solver.scheduler import BatchScheduler as RefSched

    import chip_smoke as cs
    from karpenter_tpu_torch.metrics import RELAX_OUTCOMES, RELAX_TOTAL
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    ref_pods = bench._relax_pods(250)
    ref_cat = ref_catalog(full=True)
    ref_provs = [RefProv(name="default").with_defaults()]
    ref_reg = RefRegistry()
    sched = RefSched(backend="tpu", registry=ref_reg, compile_behind=False)
    t0 = time.perf_counter()
    ref_scan = sched.solve(ref_pods, ref_provs, ref_cat, relax=False)
    st, _ = sched._tensorize(ref_pods, ref_provs, ref_cat, (), None)
    ref_relax.warm_relax(sched._tpu, st)
    while not sched._tpu.warm_idle():
        time.sleep(0.05)
    ref = sched.solve(ref_pods, ref_provs, ref_cat)
    out["relax_ref_s"] = time.perf_counter() - t0

    pods = cs.relax_pods(250)
    reg = Registry()
    port = BatchScheduler(backend="tpu", device="cpu", registry=reg)
    t0 = time.perf_counter()
    scan = port.solve(pods, [cs.provisioner()], generate_catalog(full=True),
                      relax=False)
    got = port.solve(pods, [cs.provisioner()], generate_catalog(full=True))
    out["relax_port_s"] = time.perf_counter() - t0
    outcomes = [{o: r.counter(total).get({"outcome": o})
                 for o in RELAX_OUTCOMES if r.counter(total).get(
                     {"outcome": o})}
                for r, total in ((ref_reg, REF_RELAX_TOTAL),
                                 (reg, RELAX_TOTAL))]
    out.update(
        relax_pods=len(pods), relax_outcomes=outcomes,
        relax_scan_cost=[ref_scan.new_node_cost, scan.new_node_cost],
        relax_cost=[ref.new_node_cost, got.new_node_cost],
        relax_nodes=[len(ref.nodes), len(got.nodes)],
        relax_plans_equal=cs.plan(ref) == cs.plan(got),
        relax_placements_tie=cs.placements_tie(ref, got),
    )
    return outcomes[0] == outcomes[1] and (
        out["relax_plans_equal"] or out["relax_placements_tie"])


if __name__ == "__main__":
    raise SystemExit(main())
