"""``karpenter-tpu-torch`` command line interface: the port of the reference
package's ``cli.py``.

Subcommands (the reference ships a single controller binary; this framework
adds the operational entry points around it):

- ``demo``         run the full controller loop against the fake cloud
- ``solve``        one-shot batch solve of a scenario JSON (or a generated one)
- ``serve``        start the gRPC solver sidecar
- ``bench``        refused: the benchmark is the JAX package's ``bench_all.py``
- ``metrics-doc``  print the metric inventory as a Markdown table
- ``version``      print the package version

The port's differences: ``--device`` on demo/solve/serve names the torch
device the in-process scheduler (or the sidecar) runs on — the CUDA card by
default, raising without one; ``cpu`` runs the plain PyTorch path on the
host.  ``--profile-port`` (the reference's JAX profiler server) is refused
when non-zero: the port's device profile is ``python -m
karpenter_tpu_torch.profile_wave``.  ``--jit-cache-dir`` is accepted, since
deployments pass it, and says in one line that the port has no compile
cache.  ``metrics-doc`` writes to stdout or ``--out``, never over the
reference's ``docs/METRICS.md``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from . import __version__

#: the reference's generated metrics page, which this CLI never writes
_REFERENCE_METRICS_DOC = (
    Path(__file__).resolve().parent.parent / "docs" / "METRICS.md")


def _refuse_profile(port: int) -> bool:
    """True (after saying why) when a profiler port was asked for: the
    reference starts JAX's profiler server there, which the port has not."""
    if port:
        print("--profile-port: the port has no profiler server; profile a "
              "block wave on the card with `python -m "
              "karpenter_tpu_torch.profile_wave`", file=sys.stderr)
        return True
    return False


def _note_jit_cache(cache_dir: str) -> None:
    if cache_dir:
        print(f"--jit-cache-dir {cache_dir}: the port compiles no programs "
              f"and keeps no compile cache; nothing is written there",
              file=sys.stderr)


def cmd_demo(args) -> int:
    from .operator import main as op_main

    if _refuse_profile(args.profile_port):
        return 2
    _note_jit_cache(args.jit_cache_dir)
    argv = ["--demo", "--pods", str(args.pods), "--backend", args.backend]
    if args.small:
        argv.append("--small")
    if args.metrics_port:
        argv += ["--metrics-port", str(args.metrics_port)]
    if args.config:
        argv += ["--config", args.config]
    if args.solver_address:
        argv += ["--solver-address", args.solver_address]
    if args.device:
        argv += ["--device", args.device]
    if args.tracez:
        argv.append("--tracez")
    return op_main(argv)


def cmd_solve(args) -> int:
    _note_jit_cache(args.jit_cache_dir)

    from .models.catalog import generate_catalog
    from .models.pod import PodSpec
    from .models.provisioner import Provisioner
    from .solver.scheduler import BatchScheduler

    catalog = generate_catalog(full=not args.small)
    if args.scenario:
        with open(args.scenario) as f:
            doc = json.load(f)
        pods = [PodSpec(name=p["name"], requests=p.get("requests", {}),
                        labels=p.get("labels", {}),
                        node_selector=p.get("node_selector", {}))
                for p in doc["pods"]]
        provs = [Provisioner(name=p["name"], weight=p.get("weight", 0),
                             limits=p.get("limits", {})).with_defaults()
                 for p in doc.get("provisioners", [{"name": "default"}])]
    else:
        pods = [PodSpec(name=f"p{i}", requests={"cpu": 1.0}, owner_key="cli")
                for i in range(args.pods)]
        provs = [Provisioner(name="default").with_defaults()]
    res = BatchScheduler(
        backend=args.backend, compile_behind=False, device=args.device,
    ).solve(pods, provs, catalog)
    out = {
        "scheduled": res.n_scheduled,
        "infeasible": len(res.infeasible),
        "new_nodes": len(res.nodes),
        "node_cost_per_hr": round(res.new_node_cost, 4),
        "solve_ms": round(res.solve_ms, 3),
        "nodes": [
            {"name": n.name, "instance_type": n.instance_type, "zone": n.zone,
             "capacity_type": n.capacity_type, "price": n.price,
             "pods": len(n.pods)}
            for n in res.nodes
        ],
    }
    if args.assignments:
        out["assignments"] = res.assignments
        out["infeasible_reasons"] = res.infeasible
    print(json.dumps(out, indent=None if args.compact else 2))
    return 0 if not res.infeasible else 3


def cmd_serve(args) -> int:
    from .service.server import main as serve_main

    if _refuse_profile(args.profile_port):
        return 2
    _note_jit_cache(args.jit_cache_dir)
    argv = ["--port", str(args.port), "--backend", args.backend,
            "--obs-port", str(args.obs_port)]
    if args.device:
        argv += ["--device", args.device]
    if args.max_slots is not None:
        argv += ["--max-slots", str(args.max_slots)]
    if args.max_wait_ms is not None:
        argv += ["--max-wait-ms", str(args.max_wait_ms)]
    if args.admission is not None:
        argv += ["--admission", args.admission]
    if args.default_priority is not None:
        argv += ["--default-priority", args.default_priority]
    if args.default_deadline_ms is not None:
        argv += ["--default-deadline-ms", str(args.default_deadline_ms)]
    if args.session_dir is not None:
        argv += ["--session-dir", args.session_dir]
    if args.warmup:
        argv.append("--warmup")
    if args.small:
        argv.append("--small")
    return serve_main(argv)


def cmd_bench(args) -> int:
    print("bench: the benchmark (bench_all.py) drives the JAX package and is "
          "not ported; on the card run `python3 chip_smoke.py`",
          file=sys.stderr)
    return 2


def cmd_metrics_doc(args) -> int:
    from .metrics import INVENTORY

    lines = [
        "# Metrics",
        "",
        "Prometheus metrics exposed on the `/metrics` endpoints of the port",
        "(`karpenter_tpu_torch/metrics.py`; names mirror the reference's",
        "`concepts/metrics.md`).  Generated by `karpenter-tpu-torch",
        "metrics-doc` — do not edit by hand.",
        "",
        "| Name | Type | Labels | Description |",
        "|---|---|---|---|",
    ]
    for name, (kind, labels, help_) in sorted(INVENTORY.items()):
        lab = ", ".join(labels) if labels else "—"
        lines.append(f"| `{name}` | {kind} | {lab} | {help_} |")
    text = "\n".join(lines) + "\n"
    if args.out and Path(args.out).resolve() == _REFERENCE_METRICS_DOC:
        print(f"{args.out} is the reference package's page; write the "
              "port's inventory elsewhere", file=sys.stderr)
        return 2
    if args.check:
        if not args.out:
            print("--check needs --out FILE", file=sys.stderr)
            return 2
        try:
            with open(args.out) as f:
                current = f.read()
        except FileNotFoundError:
            current = None  # missing counts as stale
        if current != text:
            print(f"{args.out} is stale; run `karpenter-tpu-torch "
                  f"metrics-doc --out {args.out}`", file=sys.stderr)
            return 1
        return 0
    if not args.out:
        sys.stdout.write(text)
        return 0
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}")
    return 0


def _device_arg(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device to solve on (default the CUDA "
                             "card, refusing to start without one; 'cpu' "
                             "runs the plain PyTorch path on the host)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="karpenter-tpu-torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="run the controller loop on the fake cloud")
    d.add_argument("--pods", type=int, default=200)
    d.add_argument("--small", action="store_true")
    d.add_argument("--backend", default="auto", choices=["auto", "tpu", "oracle"])
    d.add_argument("--metrics-port", type=int, default=0)
    d.add_argument("--profile-port", type=int, default=0,
                   help="refused when non-zero (see profile_wave)")
    d.add_argument("--jit-cache-dir", default=os.environ.get("KT_JIT_CACHE_DIR", ""),
                   help="accepted for deployments that pass it; the port "
                        "keeps no compile cache")
    d.add_argument("--solver-address",
                   default=os.environ.get("KARPENTER_SOLVER_ADDR", ""),
                   help="host:port of a solver sidecar (serve); empty "
                        "solves in-process; defaults from "
                        "KARPENTER_SOLVER_ADDR (deploy/operator.yaml).  The "
                        "remote operator needs no card")
    d.add_argument("--config", default="",
                   help="YAML manifest file/dir loaded through admission")
    d.add_argument("--tracez", action="store_true",
                   help="print a /tracez + /statusz snapshot after the demo")
    _device_arg(d)
    d.set_defaults(fn=cmd_demo)

    s = sub.add_parser("solve", help="one-shot batch solve")
    s.add_argument("--scenario", help="scenario JSON file (pods/provisioners)")
    s.add_argument("--pods", type=int, default=100)
    s.add_argument("--small", action="store_true")
    s.add_argument("--backend", default="auto", choices=["auto", "tpu", "native", "oracle"])
    s.add_argument("--assignments", action="store_true", help="include per-pod assignments")
    s.add_argument("--compact", action="store_true")
    s.add_argument("--jit-cache-dir", default=os.environ.get("KT_JIT_CACHE_DIR", ""),
                   help="accepted; the port keeps no compile cache")
    _device_arg(s)
    s.set_defaults(fn=cmd_solve)

    v = sub.add_parser("serve", help="gRPC solver sidecar")
    v.add_argument("--port", type=int, default=50151)
    v.add_argument("--backend", default="auto", choices=["auto", "tpu", "oracle"])
    v.add_argument("--obs-port", type=int, default=0,
                   help="observability HTTP port (/tracez, /statusz, /sloz, "
                        "/tunez, /fleetz, /metrics); 0 disables")
    v.add_argument("--profile-port", type=int, default=0,
                   help="refused when non-zero (see profile_wave)")
    v.add_argument("--jit-cache-dir", default=os.environ.get("KT_JIT_CACHE_DIR", ""),
                   help="accepted for deployments that pass it; the port "
                        "keeps no compile cache")
    v.add_argument("--max-slots", type=int, default=None,
                   help="megabatch request slots per coalescer flush "
                        "(KT_MAX_SLOTS; 1 disables cross-request batching)")
    v.add_argument("--max-wait-ms", type=float, default=None,
                   help="max hold before a partial megabatch flushes "
                        "(KT_MAX_WAIT_MS; 0 = flush on queue idle)")
    v.add_argument("--admission", choices=["on", "off"], default=None,
                   help="admission control & overload protection "
                        "(docs/ADMISSION.md; KT_ADMISSION, default on)")
    v.add_argument("--default-priority", default=None,
                   choices=["critical", "batch", "best_effort"],
                   help="priority class for requests carrying none "
                        "(KT_DEFAULT_PRIORITY_CLASS; default batch)")
    v.add_argument("--default-deadline-ms", type=float, default=None,
                   help="enqueue deadline when the RPC carries none "
                        "(KT_DEFAULT_DEADLINE_MS; 0 = no deadline)")
    v.add_argument("--session-dir", default=None,
                   help="delta-session snapshot spool (KT_SESSION_DIR): "
                        "restored at startup, written on graceful "
                        "shutdown + every KT_SESSION_SNAPSHOT_S "
                        "(docs/RESILIENCE.md)")
    v.add_argument("--warmup", action="store_true",
                   help="block startup on the bucket-grid warm (single "
                        "ladder + megabatch rungs)")
    v.add_argument("--small", action="store_true",
                   help="--warmup against the 20-type catalog")
    _device_arg(v)
    v.set_defaults(fn=cmd_serve)

    b = sub.add_parser("bench", help="refused: the benchmark is not ported")
    b.add_argument("--configs", default="1,2,3,4,5,6")
    b.set_defaults(fn=cmd_bench)

    m = sub.add_parser("metrics-doc",
                       help="print the metric inventory as Markdown")
    m.add_argument("--out", default="",
                   help="write here instead of stdout (never the "
                        "reference's docs/METRICS.md)")
    m.add_argument("--check", action="store_true",
                   help="exit 1 when --out differs from the inventory")
    m.set_defaults(fn=cmd_metrics_doc)

    ver = sub.add_parser("version", help="print version")
    ver.set_defaults(fn=lambda a: (print(f"karpenter-tpu {__version__}"), 0)[1])

    args = p.parse_args(argv)
    rc = args.fn(args)
    # exit joins non-daemon warm threads; bound that wait so a warm hung on
    # a wedged device cannot pin the process forever
    from .operator import drain_warm_threads

    drain_warm_threads(rc)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
