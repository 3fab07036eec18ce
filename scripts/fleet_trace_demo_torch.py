"""Fleet-tracing demo on the PyTorch/CUDA port.

The port of ``scripts/fleet_trace_demo.py`` over ``karpenter_tpu_torch``.
Three in-process solver replicas on unix sockets share one session spool,
each serving its own observability HTTP endpoint (``/statusz`` with the
session block, ``/tracez``, ``/fleetz`` with the peer fan-out).  A delta
session establishes on its rendezvous home, churns, the home is
HARD-KILLED mid-chain, and the session continues WARM on a steal-adopting
sibling — then the merged ``/fleetz`` view is fetched over real HTTP from
a surviving replica and printed, with the session's cross-replica trace
timeline: ONE tree, establishment rooted on the dead replica, the
surviving deltas linked under it, the ``session_steal`` lifecycle span
naming where the chain came from.

The victim's gRPC plane dies but its obs endpoint stays up — the
post-mortem topology: an obs sidecar outliving its serving process is
exactly when the fleet view must still assemble the dead replica's hops.

The replicas come from ``scripts/chaos_drive_torch.py`` (``_build_replica``,
``_hard_kill``, ``_settle_spool``) on ``--backend`` (default ``tpu``; the
reference's replicas are oracle schedulers) and ``--device`` (default the
CUDA card, raising without one):

    python scripts/fleet_trace_demo_torch.py                 # on the card
    python scripts/fleet_trace_demo_torch.py --device cpu

Exits 0 when the journey is one tree of at least 3 hops over at least 2
replicas with every later hop's ``parent_hop`` 0.
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
import urllib.request

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


#: the reference's session knobs (and the peer list ``run`` sets)
ENV = {"KT_SESSION_SNAPSHOT_S": "0.0001", "KT_SESSION_LEASE_S": "0.4",
       "KT_OBS_PEERS": ""}


def _chaos_drive():
    spec = importlib.util.spec_from_file_location(
        "chaos_drive_torch", str(ROOT / "scripts" / "chaos_drive_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def journey_holds(journey) -> bool:
    """One journey of at least 3 hops over at least 2 replicas, every
    later hop linked under the first."""
    return (journey is not None and journey["n_hops"] >= 3
            and len({h["replica"] for h in journey["hops"]}) >= 2
            and all(h["parent_hop"] == 0 for h in journey["hops"][1:]))


def run(backend: str = "tpu", device=None, verbose: bool = True) -> dict:
    """The demo on ``backend`` / ``device``.  Returns the fetched
    ``/fleetz`` document, the session's journey, the verdict, the
    replicas' device and the survivors' view of the session."""
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.obs.export import serve as obs_serve
    from karpenter_tpu_torch.obs.fleet import render_fleetz
    from karpenter_tpu_torch.service.client import DeltaSession, FleetClient

    say = print if verbose else (lambda *a, **k: None)
    chaos = _chaos_drive()
    tmp = tempfile.mkdtemp(prefix="kt-fleet-demo-")
    spool = f"{tmp}/spool"
    say("== obs-fleet-demo: 3 replicas, one spool, kill-one mid-chain ==")
    # the reference's session knobs where the environment does not set
    # them, and the peer list below, taken back at the end
    saved = {k: os.environ.get(k) for k in ENV}
    for k, v in ENV.items():
        os.environ.setdefault(k, v)
    reps, obs_servers, obs_urls = [], [], []
    sess = fc = None
    try:
        for i in range(3):
            reps.append(chaos._build_replica(
                f"unix:{tmp}/r{i}.sock", spool, f"replica-{i}", 0.4, 0.0001,
                backend=backend, device=device))
        for rep in reps:
            flight = rep["service"].tracer.flight
            srv, port = obs_serve(rep["reg"], flight, port=0,
                                  extra=rep["service"].statusz_extra)
            obs_servers.append(srv)
            obs_urls.append(f"http://127.0.0.1:{port}")
        # every replica fans /fleetz out to the full peer list (itself
        # included — the merge dedupes by replica_id)
        os.environ["KT_OBS_PEERS"] = ",".join(obs_urls)

        provs = [Provisioner(name="default").with_defaults()]
        catalog = generate_catalog(full=False)
        socks = [r["sock"] for r in reps]
        fc = FleetClient(socks, timeout=60.0, retries=0, backoff_s=0.01)
        sess = DeltaSession(socks[0], timeout=60.0, client=fc)
        say(f"establishing session {sess.session_id[:12]} "
            f"(journey trace {sess._trace_id}) ...")
        sess.solve(chaos.make_pods(150, "fd"), provs, catalog)
        for k in range(2):
            sess.solve_delta(added=chaos.make_pods(2, f"fd{k}"))
        say(f"  served by {sess.last_replica}, epoch {sess.epoch}")
        chaos._settle_spool(reps)
        home = fc.endpoint_for(sess.session_id)
        victim = next(r for r in reps if r["sock"] == home)
        say(f"hard-killing {victim['replica']} (no drain, no lease "
            "release) ...")
        chaos._hard_kill(victim)
        time.sleep(0.7)  # past the lease TTL: the chain becomes stealable
        sess.solve_delta(added=chaos.make_pods(2, "fdpost"))
        say(f"  next delta served WARM by {sess.last_replica} "
            f"(epoch {sess.epoch}, full re-establishes: "
            f"{sess.full_resends - 1})")

        # the merged view, over real HTTP from a SURVIVING replica
        survivor_url = next(u for u, r in zip(obs_urls, reps)
                            if r is not victim)
        with urllib.request.urlopen(f"{survivor_url}/fleetz",
                                    timeout=10.0) as resp:
            doc = json.loads(resp.read().decode())
        say()
        say(render_fleetz(doc))
        journey = next((t for t in doc.get("traces", ())
                        if t.get("session_id") == sess.session_id), None)
        ok = journey_holds(journey)
        verdict = ("ONE cross-replica tree, remote-parent linked — OK"
                   if ok else "FAILED to assemble")
        say()
        say(f"journey: {verdict}")
        return {"ok": ok, "doc": doc, "journey": journey,
                "victim": victim["replica"],
                "served_after_kill": sess.last_replica,
                "full_resends": sess.full_resends,
                "device": str(reps[0]["device"])}
    finally:
        if sess is not None:
            sess.close()
        if fc is not None:
            fc.close()
        for srv in obs_servers:
            srv.shutdown()
        for rep in reps:
            # the killed replica's server is already stopped; its service
            # and scheduler threads still go
            rep["srv"].stop(grace=None)
            chaos._close_service(rep["service"])
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="tpu",
                    choices=["tpu", "auto", "oracle"],
                    help="the replicas' scheduler backend (the reference "
                         "runs oracle)")
    ap.add_argument("--device", default=None,
                    help="torch device (default the CUDA card, raising "
                         "without one; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    return 0 if run(args.backend, args.device)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
