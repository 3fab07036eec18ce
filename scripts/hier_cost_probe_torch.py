#!/usr/bin/env python3
"""Time the port's limited hierarchical solve by batch shape, and before and
after a ``torch.profiler`` session with and without CUPTI teardown.

Two questions about ``chip_smoke.py``'s wall, each answered in fresh child
processes on the card:

* ``shapes`` — what a limited hierarchical solve (``chip_smoke.
  limited_solve``: the unconstrained solve, then the solve under a cpu
  limit at a fraction of its buy) costs as the deployments and the pods per
  deployment change: 40 x 2,500 (the slice), 40 x 625 (a quarter of the
  pods over the same deployments) and ``chip_smoke.LATER_HIER`` (10 x
  2,500, at its own limit);
* ``teardown`` — whether one profiler session slows the solves after it:
  ``LATER_HIER``'s limited solve from a fresh scheduler twice, one
  ``torch.profiler`` session (``chip_smoke.count_launches`` on ten small
  kernels), the solve twice more; once with ``TEARDOWN_CUPTI=0`` and once
  with ``TEARDOWN_CUPTI=1``.

    python3 scripts/hier_cost_probe_torch.py            # on the card
    python3 scripts/hier_cost_probe_torch.py --device cpu --small  # a dry run

Prints one ``HIERCOST {...}`` JSON line and writes it to
``chiprun_out/hier_cost_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: (deployments, pods each, limit as a fraction of the unconstrained buy)
SHAPES = ((40, 2500, 0.99), (40, 625, 0.99), (10, 2500, 1.0))
#: the dry run's shapes: small enough for a host
SMALL = ((8, 250, 0.99), (8, 63, 0.99), (2, 250, 1.0))


def _sync(device: str) -> None:
    if device != "cpu":
        import torch

        torch.cuda.synchronize()


def _limited(device, nd, per, frac, catalog) -> dict:
    import chip_smoke as cs

    pods = cs.deployments(nd, per)
    cs.names_from()
    with cs.hier_at(len(pods)):
        (_s, _st, limit, _free, res, stats, wall_ms, launches,
         _shipped) = cs.limited_solve(device, pods, catalog, frac)
    return dict(deployments=nd, per=per, pods=len(pods), limit_frac=frac,
                cpu_limit=limit, limited_ms=wall_ms, blocks=stats["blocks"],
                waves=stats["waves"], wave_ms=stats["wave_ms"],
                repair_ms=stats["repair_ms"], nodes=len(res.nodes),
                infeasible=len(res.infeasible), launches=launches)


def _fresh(device, pods, limit, catalog) -> float:
    """One limited solve of ``pods`` from a fresh scheduler, in ms."""
    import chip_smoke as cs
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    sched = BatchScheduler(backend="auto", device=device)
    cs.names_from()
    _sync(device)
    t0 = time.perf_counter()
    sched.solve(pods, [cs.provisioner(limit)], catalog)
    _sync(device)
    return (time.perf_counter() - t0) * 1000.0


def child(what: str, device: str, small: bool) -> dict:
    import chip_smoke as cs
    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=True)
    shapes = SMALL if small else SHAPES
    if what == "shapes":
        return dict(shapes=[_limited(device, nd, per, frac, catalog)
                            for nd, per, frac in shapes])
    import torch

    nd, per, frac = shapes[-1]
    first = _limited(device, nd, per, frac, catalog)
    pods = cs.deployments(nd, per)
    with cs.hier_at(len(pods)):
        before = [_fresh(device, pods, first["cpu_limit"], catalog)
                  for _ in range(2)]
        x = torch.ones(1024, device=device)
        if device == "cpu":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU]):
                for _ in range(10):
                    x.add_(1)
            session = None
        else:
            session = cs.count_launches(
                lambda: [x.add_(1) for _ in range(10)])
        after = [_fresh(device, pods, first["cpu_limit"], catalog)
                 for _ in range(2)]
    return dict(teardown_cupti=os.environ.get("TEARDOWN_CUPTI"),
                pods=len(pods), before_ms=before, after_ms=after,
                session_launches=session,
                after_over_before=sum(after) / sum(before))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="the dry run's shapes (a host's size)")
    ap.add_argument("--child", choices=("shapes", "teardown"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            print("hier_cost_probe: no CUDA device; pass --device cpu for "
                  "a dry run", file=sys.stderr)
            return 2
    if args.child:
        print("CHILD " + json.dumps(child(args.child, args.device,
                                          args.small)), flush=True)
        return 0
    t0 = time.perf_counter()
    out: dict = {"device": args.device}
    if args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        out["gpu"] = smi.stdout.strip()
    runs = [("shapes", "1"), ("teardown", "0"), ("teardown", "1")]
    for what, teardown in runs:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", what,
               "--device", args.device] + (["--small"] if args.small else [])
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              env={**os.environ, "TEARDOWN_CUPTI": teardown},
                              timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("CHILD ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"hier_cost_probe: the {what} child failed "
                  f"(rc {proc.returncode})", file=sys.stderr)
            return 1
        rec = json.loads(lines[-1][len("CHILD "):])
        if what == "shapes":
            out["shapes"] = rec["shapes"]
        else:
            out[f"teardown_{teardown}"] = rec
    out["wall_s"] = time.perf_counter() - t0
    line = json.dumps(out)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "hier_cost_probe.json"),
              "w") as f:
        f.write(line + "\n")
    print("HIERCOST " + line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
