"""The control of ``correct``: the reference put in the program's place
with one guarantee of the configuration broken, so the check must fail.

The configurations state a hard zone spread (maxSkew 1, DoNotSchedule)
and no numeric precision, so the control is the reference's planner with
the spread dropped: the step a later change could be tempted by, since a
spread costs nodes.  Its plans go through the same check as the
program's; ``plan_faults`` must come out above the limit.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed: the control's ``plan_faults`` over the
run's pending sets, with the faults by kind, and the reference's own
(which must be 0).  It runs on the host and needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def plain(pending: dict, nodes: list, cand) -> dict:
    """The reference's ``(type, zone, [(deployment, pods)])`` nodes as a
    plan of pod indices, bought on demand at the catalog's price."""
    starts, n = [], 0
    for d in pending["deployments"]:
        starts.append(n)
        n += d["replicas"]
    nxt = list(starts)
    out, assigned = [], {}
    for pos, (itype, zone, loads) in enumerate(nodes):
        pods = []
        for d, k in loads:
            pods += range(nxt[d], nxt[d] + k)
            nxt[d] += k
        for p in pods:
            assigned[p] = pos
        out.append((itype, zone, "on-demand",
                    cand.offer[(itype, zone, "on-demand")], pods))
    return {"nodes": out, "infeasible": [], "assigned": assigned}


def readings(c: dict, seed: int) -> dict:
    from . import catalog, reference, workload

    cand = reference.Candidates(
        catalog.generate(full=c["config"]["catalog"]["full"]),
        c["config"]["provisioner"], catalog.ZONES)
    out = {"seed": seed, "control": 0, "reference": 0, "kinds": {}}
    for pending in workload.pending_sets(c["config"], c["traffic"], seed):
        for key, spread in (("control", False), ("reference", True)):
            _cost, nodes = reference.ffd(pending, cand, spread=spread)
            faults = reference.check(pending, plain(pending, nodes, cand),
                                     cand)
            out[key] += sum(faults.values())
            if key == "control":
                for k, v in faults.items():
                    if v:
                        out["kinds"][k] = out["kinds"].get(k, 0) + v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from benchmark import control, harness

    c = harness.cell(harness.manifest(root), args.workload, root)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **control.readings(c, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
