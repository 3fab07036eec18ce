"""Trace-replay driver for the PyTorch/CUDA port: the CLI of
``scripts/replay_traffic.py`` over ``karpenter_tpu_torch.obs.replay``.

Record, synthesize, and replay request-shape captures through the real
gRPC stack at programmable speedup:

    # synthesize a bursty capture
    python scripts/replay_traffic_torch.py --synthesize /tmp/burst.jsonl \
        --shape bursty --n 200 --rate 20

    # record a capture from a live replica's /tracez
    python scripts/replay_traffic_torch.py --record /tmp/live.jsonl \
        --tracez http://127.0.0.1:9101/tracez

    # replay against a live endpoint, or omit --target for an in-process
    # replica on a unix socket: on the CUDA card by default (raising
    # without one), on the host with --device cpu
    python scripts/replay_traffic_torch.py --replay /tmp/burst.jsonl \
        --speedup 4 --target 127.0.0.1:50151
    python scripts/replay_traffic_torch.py --replay /tmp/burst.jsonl \
        --device cpu

Prints one JSON line with the reference CLI's keys: the replay report +
fidelity verdict (the numbers ``bench_torch.py``'s
``measure_replay_fidelity`` gates).  The in-process replica is a
``BatchScheduler`` on ``--backend`` (default ``tpu``, the device path) and
``--device``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _record_from_tracez(url: str):
    import urllib.request

    from karpenter_tpu_torch.obs import replay

    with urllib.request.urlopen(url, timeout=5.0) as resp:  # noqa: S310
        doc = json.loads(resp.read().decode())
    return replay.capture_from_traces(doc.get("traces") or ())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="replay-traffic")
    ap.add_argument("--synthesize", metavar="PATH",
                    help="write a synthetic capture to PATH")
    ap.add_argument("--record", metavar="PATH",
                    help="write a capture recorded from --tracez to PATH")
    ap.add_argument("--tracez", default="http://127.0.0.1:9101/tracez",
                    help="the /tracez URL --record reads")
    ap.add_argument("--replay", metavar="PATH",
                    help="replay the capture at PATH")
    ap.add_argument("--shape", default="bursty",
                    choices=["bursty", "diurnal", "uniform", "burst-train"])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="mean request rate, 1/s (synthesize)")
    ap.add_argument("--period", type=float, default=None,
                    help="burst/diurnal cycle length, s (default: one "
                         "cycle over the capture span)")
    ap.add_argument("--amplitude", type=float, default=None,
                    help="peak-rate multiplier for bursty / burst-train "
                         "/ diurnal (default 8)")
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--pods", type=int, default=40)
    ap.add_argument("--churn", type=int, default=4)
    ap.add_argument("--speedup", type=float, default=1.0)
    ap.add_argument("--target", default="",
                    help="solver endpoint; empty spins an in-process "
                         "replica on a unix socket")
    ap.add_argument("--backend", default="tpu",
                    choices=["tpu", "auto", "oracle"],
                    help="the in-process replica's scheduler backend")
    ap.add_argument("--device", default=None,
                    help="the in-process replica's torch device (default "
                         "the CUDA card, raising without one; 'cpu' runs "
                         "on the host)")
    args = ap.parse_args(argv)

    from karpenter_tpu_torch.obs import replay

    if args.synthesize:
        recs = replay.synthesize(
            n=args.n, shape=args.shape, seed=args.seed,
            mean_rate=args.rate, n_pods=args.pods, churn=args.churn,
            sessions=args.sessions, period=args.period,
            amplitude=args.amplitude)
        replay.save_capture(args.synthesize, recs,
                            source=f"synthetic:{args.shape}",
                            meta={"seed": args.seed, "rate": args.rate,
                                  "period": args.period,
                                  "amplitude": args.amplitude})
        print(json.dumps({"written": args.synthesize, "records": len(recs),
                          "shape": args.shape}))
        return 0
    if args.record:
        recs = _record_from_tracez(args.tracez)
        if not recs:
            print(json.dumps({"error": f"no request traces at "
                                       f"{args.tracez}"}))
            return 1
        replay.save_capture(args.record, recs, source=args.tracez)
        print(json.dumps({"written": args.record, "records": len(recs)}))
        return 0
    if not args.replay:
        ap.error("one of --synthesize / --record / --replay is required")

    records, header = replay.load_capture(args.replay)
    srv = service = None
    target = args.target
    if not target:
        import os
        import tempfile

        from karpenter_tpu_torch.metrics import Registry
        from karpenter_tpu_torch.service.server import SolverService, make_server
        from karpenter_tpu_torch.solver.scheduler import BatchScheduler

        # overdrive the time-series sampler so even a short replay
        # accrues enough ring history for windowed burn rates (the SLO
        # verdict below); an explicit env still wins
        os.environ.setdefault("KT_TS_INTERVAL_S", "0.5")
        reg = Registry()
        service = SolverService(
            BatchScheduler(backend=args.backend, registry=reg,
                           device=args.device), registry=reg)
        target = f"unix:{tempfile.mkdtemp(prefix='kt-replay-')}/solver.sock"
        srv, _ = make_server(service, host=target)
    try:
        rp = replay.Replayer(target)
        if service is not None:
            # in-process replica: tap its protocol transitions for the
            # duration of the replay and conformance-check every
            # session's observed sequence against the model automaton.  A remote --target's server-side events are
            # not visible from this process.
            from karpenter_tpu_torch.analysis import conformance
            from karpenter_tpu_torch.obs import protocol

            with protocol.recording() as rec:
                report = rp.run(records, speedup=args.speedup)
            conf = conformance.check_events(rec.events_by_session())
            conf_json = conf.to_json()
        else:
            report = rp.run(records, speedup=args.speedup)
            conf, conf_json = None, None
        fid = replay.fidelity(records, report)
        slo_json = slo_ok = None
        if service is not None:
            # SLO verdict: one final sampler tick flushes the
            # replay's last interval into the rings, then the burn-rate
            # evaluation judges the replayed capture per class — the
            # objective a self-tuning controller optimizes against
            service.sampler.tick()
            slo_doc = service.sloz()
            slo_json = {
                "verdicts": {cls: info["verdict"]
                             for cls, info in slo_doc["classes"].items()},
                "burn_5m": {
                    cls: {obj: (info[obj]["windows"].get("5m") or {}
                                ).get("burn_rate")
                          for obj in ("availability", "latency")}
                    for cls, info in slo_doc["classes"].items()},
                "occupancy": slo_doc["occupancy"],
            }
            slo_ok = all(info["verdict"] != "breach"
                         for info in slo_doc["classes"].values())
        print(json.dumps({
            "capture": {"path": args.replay,
                        "source": header.get("source", "")},
            "target": target, "speedup": args.speedup,
            "outcomes": report["outcomes"],
            **({"conformance": conf_json} if conf_json is not None
               else {}),
            **({"slo": slo_json} if slo_json is not None else {}),
            **{k: v for k, v in fid.items()},
        }, default=str))
        ok = fid["class_mix_match"] and not fid["errors"] \
            and (conf is None or conf.ok) \
            and (slo_ok is None or slo_ok)
        return 0 if ok else 1
    finally:
        if srv is not None:
            srv.stop(grace=None)
        if service is not None:
            service.close()
            service.scheduler.stop_warms()


if __name__ == "__main__":
    raise SystemExit(main())
