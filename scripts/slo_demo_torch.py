"""SLO burn-rate demo on the PyTorch/CUDA port.

The port of ``scripts/slo_demo.py`` over ``karpenter_tpu_torch``: the same
knobs (:data:`KNOBS`, set while the replica runs) and the same capture.
An in-process replica is overdriven with a mixed-class capture while
best_effort admission is throttled to a trickle: best_effort traffic
sheds and burns its availability budget to breach, while critical rides
its reserved quota.  Prints the per-class verdict table the ``/sloz``
document carries, then each class's verdict per objective (availability,
latency) and critical's requests over the latency target beside its
p99:

    python scripts/slo_demo_torch.py                     # on the card
    python scripts/slo_demo_torch.py --backend oracle --device cpu

The replica's scheduler runs ``--backend`` (default ``tpu``: every
request solved on the card) on ``--device`` (default the CUDA card,
raising without one); ``--backend oracle`` is the reference's run.
Exits 0 when the demo shows the reference's expected split (best_effort
burning, critical not breached).  On the card the critical class's
unloaded p99 can exceed the latency objective (``KT_SLO_P99_MS``, 250 ms),
so critical may breach on latency while the admission split holds; the
objective lines say which objective breached.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the reference's knobs: throttle best_effort to a trickle (rate 2/s,
#: burst 2) while critical/batch stay effectively unthrottled, and
#: overdrive the sampler so the short replay accrues windowed history.
#: Each applies where the environment does not set it, while the replica
#: is built and runs (the admission control and the sampler read them at
#: construction), and is taken back after
KNOBS = {"KT_ADMIT_BEST_EFFORT_RATE": "2", "KT_ADMIT_BEST_EFFORT_BURST": "2",
         "KT_TS_INTERVAL_S": "0.25"}

#: an objective with no traffic: alone beside another it adds nothing to
#: the verdict ladder
_NO_DATA = {"lifetime": {"total": 0, "bad": 0}, "budget_remaining": 1.0,
            "windows": {}}


def objective_verdict(objective: dict, fast_burn: float) -> str:
    """One objective's verdict on the engine's own ladder."""
    from karpenter_tpu_torch.obs.slo import SloEngine

    return SloEngine._verdict(
        {"availability": objective, "latency": _NO_DATA}, fast_burn)


@contextlib.contextmanager
def knobs():
    """:data:`KNOBS` in the environment where it does not set them."""
    added = [k for k in KNOBS if k not in os.environ]
    os.environ.update({k: KNOBS[k] for k in added})
    try:
        yield
    finally:
        for k in added:
            os.environ.pop(k, None)


def run(backend: str = "tpu", device=None):
    """Replay the capture through an in-process replica on ``backend`` /
    ``device``.  Returns ``(report, doc)``: the replayer's report and the
    ``/sloz`` document."""
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.obs import replay
    from karpenter_tpu_torch.service.server import SolverService, make_server
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    records = replay.synthesize(
        n=160, shape="bursty", seed=11, mean_rate=120.0, n_pods=24,
        class_mix={"critical": 0.3, "batch": 0.2, "best_effort": 0.5})
    with knobs():
        reg = Registry()
        sched = BatchScheduler(backend=backend, registry=reg, device=device)
        service = SolverService(sched, registry=reg)
        target = (f"unix:{tempfile.mkdtemp(prefix='kt-slo-demo-')}"
                  "/solver.sock")
        srv, _ = make_server(service, host=target)
        try:
            report = replay.Replayer(target).run(records, speedup=4.0)
            service.sampler.tick()  # flush the last interval into the rings
            doc = service.sloz()
        finally:
            srv.stop(grace=None)
            service.close()
            sched.stop_warms()
    return report, doc


def split_holds(doc: dict) -> bool:
    """The reference's verdict: best_effort burning, critical not
    breached."""
    be = doc["classes"]["best_effort"]
    crit = doc["classes"]["critical"]
    return (be["availability"]["lifetime"]["bad"] > 0
            and be["verdict"] in ("warn", "breach")
            and crit["verdict"] != "breach")


def critical_p99_ms(report: dict):
    """The served critical requests' p99 wall, ms (``None`` without
    any)."""
    from karpenter_tpu_torch.obs.recorder import _percentile

    walls = sorted(report["by_class"].get("critical", {}).get("wall_ms", []))
    return _percentile(walls, 0.99) if walls else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="tpu",
                    choices=["tpu", "auto", "oracle"],
                    help="the replica's scheduler backend (the reference "
                         "runs oracle)")
    ap.add_argument("--device", default=None,
                    help="torch device (default the CUDA card, raising "
                         "without one; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    report, doc = run(args.backend, args.device)

    print("== slo-demo: overdriven mixed-class replay ==")
    print(f"sent={report['n']} outcomes={report['outcomes']}")
    print(f"targets: avail={doc['config']['avail_target']} "
          f"latency={doc['config']['latency_target']} "
          f"p99<={doc['config']['p99_ms']}ms "
          f"fast_burn={doc['config']['fast_burn']}x")
    print(f"{'class':<12} {'verdict':<8} {'requests':>8} {'shed+err':>8} "
          f"{'avail_budget':>12} {'burn_5m':>8} {'burn_1h':>8}")
    for cls, info in doc["classes"].items():
        avail = info["availability"]
        burns = []
        for win in ("5m", "1h"):
            w = avail["windows"].get(win)
            burns.append("-" if not w or w["burn_rate"] is None
                         else f"{w['burn_rate']:.2f}")
        print(f"{cls:<12} {info['verdict']:<8} "
              f"{avail['lifetime']['total']:>8.0f} "
              f"{avail['lifetime']['bad']:>8.0f} "
              f"{avail['budget_remaining']:>+12.3f} "
              f"{burns[0]:>8} {burns[1]:>8}")
    occ = doc["occupancy"]
    print(f"occupancy: device_busy={occ['device_busy_share']:.3f} "
          f"slot_fill={occ['megabatch_slot_fill']:.2f} "
          f"delta_inline={occ['delta_inline_fraction']:.2f}")
    fast = doc["config"]["fast_burn"]
    for cls, info in doc["classes"].items():
        print(f"{cls:<12} availability="
              f"{objective_verdict(info['availability'], fast):<8} "
              f"latency={objective_verdict(info['latency'], fast)}")
    p99 = critical_p99_ms(report)
    lat = doc["classes"]["critical"]["latency"]["lifetime"]
    print(f"critical latency: {lat['bad']:.0f} of {lat['total']:.0f} over "
          f"{doc['config']['p99_ms']}ms, replay p99 "
          f"{'-' if p99 is None else f'{p99:.1f}'}ms "
          f"({args.backend} on {args.device or 'the card'})")
    print(json.dumps({"verdicts": {c: i["verdict"]
                                   for c, i in doc["classes"].items()}}))

    ok = split_holds(doc)
    if not ok:
        print("demo FAILED: expected best_effort burning while critical "
              "stays green", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
