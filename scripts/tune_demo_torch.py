"""Self-tuning demo on the PyTorch/CUDA port.

The port of ``scripts/tune_demo.py`` over ``karpenter_tpu_torch``; it loads
``bench_torch.py`` where the reference loads ``bench.py`` (the never-worse
gates' constants).  Replays a seeded bursty capture against three
in-process replicas — static (env-default knobs), learning (``KT_TUNE=1``
on a fast cadence so the compressed capture spans many decision windows),
and judged (a fresh replica pinned to the learned posture, controller
off) — then prints the before/after knob table and the throughput /
critical p99 scoreboard, and exits non-zero if the learned posture breaks
the never-worse contract ``bench_torch.py`` gates in ``check_budgets``.

The replicas are oracle schedulers by default, as the reference's are and
as ``bench_torch.measure_tuning`` runs them: they measure the knob loop
and the harness.  ``--backend tpu`` solves every request on the card.
``--device`` defaults to the CUDA card and raises without one.

Per-run tail ratios on a shared host swing severalfold from GC and
scheduler blips alone, so the verdict uses the bench's refutation idiom:
the triple runs ``--pairs`` times and a regression only counts when
EVERY pair reproduces it (one confirm re-run before a breach stands).

    python scripts/tune_demo_torch.py                 # replicas on the card's host
    python scripts/tune_demo_torch.py --device cpu --pairs 1 --json
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_spec = importlib.util.spec_from_file_location(
    "benchmod_tune_demo_torch", str(ROOT / "bench_torch.py"))
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)

_TUNE_ENVS = ("KT_TS_INTERVAL_S", "KT_TUNE", "KT_TUNE_INTERVAL_S")


def run_once(records, mode: str, speedup: float, learned=None,
             backend: str = "oracle", device=None) -> dict:
    """One replay replica in the given posture; see
    ``bench_torch.measure_tuning``."""
    from karpenter_tpu_torch.metrics import (
        TUNING_STEP_DURATION,
        TUNING_STEPS,
        Registry,
    )
    from karpenter_tpu_torch.obs import replay
    from karpenter_tpu_torch.service.server import SolverService, make_server
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler
    from karpenter_tpu_torch.tuning.knobs import Knobs

    saved = {k: os.environ.get(k) for k in _TUNE_ENVS}
    os.environ["KT_TS_INTERVAL_S"] = "0.1"
    if mode == "learn":
        os.environ["KT_TUNE"] = "1"
        os.environ["KT_TUNE_INTERVAL_S"] = "0.25"
    else:
        os.environ.pop("KT_TUNE", None)
    try:
        reg = Registry()
        sched = BatchScheduler(backend=backend, registry=reg,
                               compile_behind=False, device=device)
        knobs = Knobs(frozen=frozenset())
        if learned:
            knobs.update(**learned)
        baseline = dict(knobs.snapshot().values)
        service = SolverService(sched, registry=reg, knobs=knobs)
        sock = (f"unix:{tempfile.mkdtemp(prefix='kt-tune-demo-')}"
                "/solver.sock")
        srv, _port = make_server(service, host=sock)
        try:
            rp = replay.Replayer(sock, registry=Registry())
            t0 = time.perf_counter()
            report = rp.run(records, speedup=speedup)
            wall_s = time.perf_counter() - t0
        finally:
            srv.stop(grace=None)
            service.close()
            sched.stop_warms()
        out_learned = {}
        if mode == "learn" and service.tuner is not None:
            probe = service.tuner.tunez().get("probe")
            if probe:
                # an in-flight probe the replay ended before judging is
                # not a learned setting — roll it back
                service.knobs.set(probe["knob"], probe["from"])
            snap = service.knobs.snapshot()
            out_learned = {name: snap.values[name]
                           for name in snap.overridden}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    crit = report["by_class"].get("critical", {})
    return {
        "thr": report["outcomes"].get("ok", 0) / max(wall_s, 1e-9),
        "crit_ms": list(crit.get("wall_ms", [])),
        "sheds": crit.get("outcomes", {}).get("shed", 0),
        "errors": report["outcomes"].get("error", 0),
        "wall_s": wall_s,
        "ctrl_s": sum(reg.histogram(TUNING_STEP_DURATION).sums.values()),
        "steps": sum(reg.counter(TUNING_STEPS).values.values()),
        "learned": out_learned,
        "baseline": baseline,
    }


def _p99(samples):
    from karpenter_tpu_torch.obs.recorder import _percentile

    return _percentile(sorted(samples), 0.99) if samples else None


def run_pairs(records, pairs: int, speedup: float, backend: str = "oracle",
              device=None):
    """Refutation estimators over ``pairs`` static/learn/judged triples."""
    thr_ratios, p99_ratios, pair_sheds = [], [], []
    agg = {"ctrl_s": 0.0, "wall_s": 0.0, "steps": 0, "errors": 0,
           "learned": {}, "baseline": {},
           "static_thr": [], "judged_thr": [],
           "static_p99": [], "judged_p99": []}
    kw = dict(backend=backend, device=device)
    for k in range(pairs):
        # alternate within-pair order so monotone host drift biases
        # half the pairs each way instead of one posture's
        if k % 2 == 0:
            static = run_once(records, "static", speedup, **kw)
            learn = run_once(records, "learn", speedup, **kw)
        else:
            learn = run_once(records, "learn", speedup, **kw)
            static = run_once(records, "static", speedup, **kw)
        judged = run_once(records, "judged", speedup,
                          learned=learn["learned"], **kw)
        thr_ratios.append(judged["thr"] / max(static["thr"], 1e-9))
        sp, jp = _p99(static["crit_ms"]), _p99(judged["crit_ms"])
        if sp is not None and jp is not None:
            p99_ratios.append(jp / max(sp, 1e-9))
            agg["static_p99"].append(sp)
            agg["judged_p99"].append(jp)
        pair_sheds.append(max(0, judged["sheds"] - static["sheds"]))
        agg["ctrl_s"] += learn["ctrl_s"]
        agg["wall_s"] += learn["wall_s"]
        agg["steps"] += int(learn["steps"])
        agg["errors"] += (static["errors"] + learn["errors"]
                          + judged["errors"])
        agg["learned"].update(learn["learned"])
        agg["baseline"] = learn["baseline"]
        agg["static_thr"].append(static["thr"])
        agg["judged_thr"].append(judged["thr"])
    return (max(thr_ratios),
            min(p99_ratios) if p99_ratios else None,
            min(pair_sheds),
            agg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tune-demo")
    ap.add_argument("--shape", default="bursty",
                    choices=["bursty", "diurnal", "uniform", "burst-train"])
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--rate", type=float, default=40.0)
    ap.add_argument("--speedup", type=float, default=4.0)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line instead of the tables")
    ap.add_argument("--backend", default="oracle",
                    choices=["oracle", "tpu", "auto"],
                    help="the replicas' scheduler backend (the reference "
                         "fixes oracle)")
    ap.add_argument("--device", default=None,
                    help="torch device (default the CUDA card, raising "
                         "without one; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    from karpenter_tpu_torch.obs import replay

    records = replay.synthesize(
        n=args.n, shape=args.shape, seed=args.seed, mean_rate=args.rate,
        n_pods=96, churn=4, sessions=4,
        class_mix={"batch": 0.5, "critical": 0.35, "best_effort": 0.15})

    kw = dict(backend=args.backend, device=args.device)
    thr, p99r, sheds, agg = run_pairs(records, args.pairs, args.speedup,
                                      **kw)
    breach = (thr < bench.TUNING_THROUGHPUT_FLOOR or sheds
              or (p99r is not None
                  and p99r > bench.TUNING_CRITICAL_P99_SLACK))
    if breach:
        # confirm idiom: a real regression reproduces on a fresh pair
        # set; a host blip does not
        thr2, p99r2, sheds2, agg2 = run_pairs(
            records, args.pairs, args.speedup, **kw)
        thr = max(thr, thr2)
        sheds = min(sheds, sheds2)
        if p99r is not None and p99r2 is not None:
            p99r = min(p99r, p99r2)
        for key in ("ctrl_s", "wall_s", "steps", "errors"):
            agg[key] += agg2[key]
        agg["learned"] = agg2["learned"] or agg["learned"]

    overhead_pct = 100.0 * agg["ctrl_s"] / max(agg["wall_s"], 1e-9)
    ok = (thr >= bench.TUNING_THROUGHPUT_FLOOR and not sheds
          and (p99r is None or p99r <= bench.TUNING_CRITICAL_P99_SLACK)
          and overhead_pct <= bench.TUNING_OVERHEAD_BUDGET_PCT
          and not agg["errors"])

    if args.json:
        print(json.dumps({
            "shape": args.shape, "pairs": args.pairs,
            "tuning_throughput_ratio": round(thr, 3),
            "tuning_critical_p99_ratio": (
                None if p99r is None else round(p99r, 3)),
            "tuning_new_critical_sheds": sheds,
            "tuning_overhead_pct": round(overhead_pct, 2),
            "tuning_steps": agg["steps"],
            "tuning_replay_errors": agg["errors"],
            "learned": agg["learned"], "ok": ok}))
        return 0 if ok else 1

    print(f"self-tuning demo: {args.shape} capture, {args.n} requests, "
          f"{args.pairs} pair(s), speedup {args.speedup:g}x")
    print()
    print("learned knob posture (controller on, then rolled-back probe "
          "discarded):")
    print(f"  {'knob':<16} {'default':>10} {'learned':>10}")
    if agg["learned"]:
        for name, val in sorted(agg["learned"].items()):
            print(f"  {name:<16} {agg['baseline'].get(name, '?')!s:>10} "
                  f"{val!s:>10}")
    else:
        print("  (none — the defaults already won every probe)")
    print()
    mean = lambda xs: sum(xs) / len(xs) if xs else float("nan")  # noqa: E731
    print("scoreboard (best pair judges the never-worse contract):")
    print(f"  throughput   static {mean(agg['static_thr']):8.1f}/s   "
          f"tuned {mean(agg['judged_thr']):8.1f}/s   "
          f"ratio {thr:.3f} (floor {bench.TUNING_THROUGHPUT_FLOOR:g})")
    if p99r is not None:
        print(f"  critical p99 static {mean(agg['static_p99']):8.1f}ms   "
              f"tuned {mean(agg['judged_p99']):8.1f}ms   "
              f"ratio {p99r:.3f} (slack "
              f"{bench.TUNING_CRITICAL_P99_SLACK:g}x)")
    print(f"  new critical sheds {sheds}   replay errors {agg['errors']}")
    print(f"  controller: {agg['steps']} decision(s), "
          f"{overhead_pct:.2f}% of the learning runs' wall "
          f"(budget {bench.TUNING_OVERHEAD_BUDGET_PCT:g}%)")
    print()
    print("verdict:", "never-worse holds"
          if ok else "BREACH — the learned posture lost to the defaults")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
