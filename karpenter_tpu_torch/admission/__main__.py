"""``python -m karpenter_tpu_torch.admission`` — the overload demo.

Drives a 4x closed-loop overdrive (mixed critical / best_effort clients)
through a real ``SolvePipeline`` over the oracle backend with tight
admission quotas, then prints the admission scoreboard: per-class
admitted/shed counts, p50/p99 latency, breaker state and brownout level.
The fast way to SEE the subsystem work.  The port of the reference
package's ``admission/__main__.py``: ``--device`` names the scheduler's
torch device (default the CUDA card; ``cpu`` on a host without one).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Dict, List

from ..metrics import Registry
from ..models.catalog import generate_catalog
from ..models.instancetype import GIB
from ..models.pod import PodSpec
from ..models.provisioner import Provisioner
from ..solver.scheduler import BatchScheduler
from . import BEST_EFFORT, CRITICAL, AdmissionControl, AdmissionPolicy, \
    ClassQuota, PRIORITY_CLASSES, SolveShedError


def _pods(client: int, n: int = 60) -> List[PodSpec]:
    return [
        PodSpec(name=f"c{client}-p{i}", labels={"app": f"c{client}"},
                requests={"cpu": 0.25 * (1 + (i + client) % 4),
                          "memory": float(1 + (i + client) % 3) * GIB},
                owner_key=f"c{client}")
        for i in range(n)
    ]


def _percentile(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(q * (len(vals) - 1) + 0.5))]


def main(argv=None) -> int:
    from ..service.server import SolvePipeline

    parser = argparse.ArgumentParser(prog="karpenter-tpu-torch-overload-demo")
    parser.add_argument("--duration", type=float, default=4.0)
    parser.add_argument("--critical", type=int, default=2)
    parser.add_argument("--best-effort", type=int, default=10)
    parser.add_argument("--queue-total", type=int, default=6)
    parser.add_argument("--deadline-ms", type=float, default=400.0)
    parser.add_argument("--device", default=None,
                        help="torch device of the scheduler (default the "
                             "CUDA card; 'cpu' runs on the host)")
    args = parser.parse_args(argv)

    catalog = generate_catalog(full=False)
    provs = [Provisioner(name="default").with_defaults()]
    reg = Registry()
    sched = BatchScheduler(backend="oracle", registry=reg, device=args.device)
    policy = AdmissionPolicy(
        quotas={BEST_EFFORT: ClassQuota(max_queue_depth=3)},
        max_queue_total=args.queue_total,
    )
    adm = AdmissionControl(policy=policy, registry=reg)
    pipe = SolvePipeline(sched, registry=reg, admission=adm)
    latencies: Dict[str, List[float]] = {c: [] for c in PRIORITY_CLASSES}
    sheds: Dict[str, int] = {c: 0 for c in PRIORITY_CLASSES}
    stop_at = time.perf_counter() + args.duration
    lock = threading.Lock()

    def client(ci: int, pclass: str) -> None:
        pods = _pods(ci)
        while time.perf_counter() < stop_at:
            t0 = time.perf_counter()
            try:
                pipe.solve(dict(pods=pods, provisioners=provs,
                                instance_types=catalog),
                           pclass=pclass, deadline_s=args.deadline_ms / 1e3)
            except SolveShedError:
                with lock:
                    sheds[pclass] += 1
                time.sleep(0.02)  # the typed error means BACK OFF
                continue
            with lock:
                latencies[pclass].append((time.perf_counter() - t0) * 1e3)

    threads = (
        [threading.Thread(target=client, args=(i, CRITICAL))
         for i in range(args.critical)]
        + [threading.Thread(target=client, args=(100 + i, BEST_EFFORT))
           for i in range(args.best_effort)]
    )
    print(f"overload demo: {args.critical} critical + "
          f"{args.best_effort} best_effort closed-loop clients, "
          f"{args.duration:.0f}s, queue bound {args.queue_total}, "
          f"deadline {args.deadline_ms:.0f}ms ...")
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    pipe.stop()
    out = {
        "stats": adm.stats(),
        "served": {c: len(latencies[c]) for c in PRIORITY_CLASSES},
        "shed_errors_seen": sheds,
        "p50_ms": {c: round(_percentile(latencies[c], 0.5), 1)
                   for c in PRIORITY_CLASSES if latencies[c]},
        "p99_ms": {c: round(_percentile(latencies[c], 0.99), 1)
                   for c in PRIORITY_CLASSES if latencies[c]},
    }
    print(json.dumps(out, indent=2))
    crit_ok = sheds[CRITICAL] == 0 and out["stats"]["shed"][CRITICAL] == {}
    print(f"\ncritical protected: {crit_ok}; best_effort absorbed "
          f"{sheds[BEST_EFFORT]} sheds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
