"""The port's observability exports against the reference package's, on
the CPU: ``obs/export.py`` (``statusz``, ``tracez``, ``render_tracez``,
``serve`` and its ``/metrics`` exposition), ``obs/fleet.py`` (the
``/fleetz`` merge) and ``obs/replay.py`` (capture, synthesis, replay,
fidelity).

Every scenario is one function over a package namespace ``k``, run over
the reference and over the port with the same inputs: the same metric
operations on a fresh ``Registry``, traces cut by a ``Tracer`` on each
package's ``FakeClock`` under one ``KT_REPLICA_ID``, the same injected
peer documents, the same seeds.  The documents must be equal in keys and
values; where a value is a wall-clock reading (a served solve's latency,
an age) the keys and the counts are compared instead.

Tolerance: equal.
"""

import importlib
import itertools
import json
import socket
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)

REFERENCE, PORT = "karpenter_tpu", "karpenter_tpu_torch"
ROOTS = (REFERENCE, PORT)
MODULES = {
    "export": "obs.export", "fleet": "obs.fleet", "replay": "obs.replay",
    "recorder": "obs.recorder", "trace": "obs.trace", "metrics": "metrics",
    "clock": "utils.clock", "server": "service.server",
    "client": "service.client", "scheduler": "solver.scheduler",
    "types": "solver.types", "catalog": "models.catalog",
}
_PACKAGES: dict = {}


def package(root: str) -> SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = SimpleNamespace(root=root, **{
            alias: importlib.import_module(f"{root}.{path}")
            for alias, path in MODULES.items()})
    return _PACKAGES[root]


def run_both(scenario, *args):
    seen = {}
    for root in ROOTS:
        k = package(root)
        with k.types._node_lock:
            k.types._node_next = 0
        # trace ids number the process's traces: restart both packages'
        k.trace._TRACE_IDS = itertools.count(1)
        seen[root] = scenario(k, *args)
    assert seen[PORT] == seen[REFERENCE]
    return seen[PORT]


def shape(doc):
    """The key structure of a JSON document (values dropped)."""
    if isinstance(doc, dict):
        return {key: shape(v) for key, v in sorted(doc.items())}
    if isinstance(doc, list):
        return [shape(v) for v in doc[:1]]
    return type(doc).__name__


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in ("KT_OBS_PEERS", "KT_FAULTS", "KT_SESSION_DIR", "KT_TRACE",
                 "KT_TRACE_SAMPLE_EVERY", "KT_FLIGHT_DIR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KT_REPLICA_ID", "replica-t")
    monkeypatch.setenv("KT_TS_INTERVAL_S", "0")


def populate(k):
    """One registry and flight recorder driven through the same metric
    operations and three FakeClock-timed traces."""
    M = k.metrics
    reg = M.Registry()
    clock = k.clock.FakeClock(start=100.0)
    flight = k.recorder.FlightRecorder(registry=reg, clock=clock)
    tracer = k.trace.Tracer(registry=reg, clock=clock, flight=flight)
    reg.counter(M.TENSORIZE_CACHE_HITS).inc({"tier": "identity"}, 3)
    reg.counter(M.TENSORIZE_CACHE_HITS).inc({"tier": "shape"})
    reg.counter(M.TENSORIZE_CACHE_MISSES).inc(value=2)
    reg.gauge(M.SOLVER_DEVICE_HEALTHY).set(1.0)
    reg.gauge(M.INFLIGHT_DEPTH).set(2.0, {"backend": "tpu"})
    reg.counter(M.SOLVER_DEGRADED_SOLVES).inc({"backend": "native"}, 0.0)
    reg.gauge(M.REMOTE_DEGRADED).set(0)
    reg.counter(M.ADMISSION_SHED).inc({"class": "best_effort",
                                       "reason": "queue_full"}, 4)
    reg.gauge(M.ADMISSION_QUEUE_DEPTH).set(1.0, {"class": "critical"})
    reg.counter(M.ADMISSION_ADMITTED).inc({"class": "critical"}, 7)
    reg.gauge(M.ADMISSION_BREAKER_STATE).set(2.0)
    reg.counter(M.FAULTS_INJECTED).inc({"kind": "device_hang",
                                        "site": "fence"})
    reg.counter(M.FAULTS_RECOVERED).inc({"site": "fence",
                                         "outcome": "fallback"})
    reg.counter(M.SNAPSHOT_WRITES).inc({"outcome": "written"}, 2)
    reg.counter(M.SNAPSHOT_RESTORE).inc({"outcome": "restored"})
    reg.gauge(M.SNAPSHOT_SESSIONS).set(3.0)
    reg.counter(M.DELTA_RPC).inc({"outcome": "delta"}, 9)
    reg.counter(M.SESSION_ADOPTIONS).inc({"outcome": "stolen"})
    reg.gauge(M.SESSION_LEASES).set(1.0)
    reg.gauge(M.DELTA_SESSIONS).set(2.0)
    fc = k.client.FleetClient(["unix:/tmp/a.sock", "unix:/tmp/b.sock"],
                              registry=reg)
    fc.close()
    for i, (name, n) in enumerate((("solve", 40), ("solve", 4),
                                   ("deprovision", 0))):
        with tracer.start(name, n_pods=n) as tr:
            with tr.span("window"):
                clock.advance(0.25 * (i + 1))
            with tr.span("dispatch", slots=i + 1):
                clock.advance(0.5)
    flight.add_event({"kind": "Node", "reason": "Launched"})
    return reg, flight


def test_statusz_over_the_same_registry():
    def scenario(k):
        reg, flight = populate(k)
        extra = {"sessions": {"abc": {"epoch": 3}}, "replica_id": "x"}
        return (k.export.statusz(reg, flight),
                k.export.statusz(reg, None),
                k.export.statusz(reg, flight, extra=lambda: extra),
                k.export.statusz(reg, flight, extra=lambda: 1 / 0))

    docs = run_both(scenario)
    assert docs[0]["admission"]["breaker"] == "open"
    assert docs[0]["fleet"]["endpoints"]["known"] == 2.0
    assert docs[3]["extra_error"] == "statusz extra provider raised"


def test_tracez_and_its_terminal_render():
    def scenario(k):
        _reg, flight = populate(k)
        return (k.export.tracez(flight), k.export.tracez(flight, limit=1),
                k.export.render_tracez(flight),
                k.export.render_tracez(flight, limit=2))

    docs = run_both(scenario)
    assert docs[0]["count"] == 3 and set(docs[0]["spans"]) >= {
        "window", "dispatch"}


def test_metrics_exposition_is_the_reference_text():
    def scenario(k):
        M = k.metrics
        reg = M.Registry()
        reg.counter(M.REMOTE_FALLBACK_SOLVES).inc(value=0.0)
        reg.counter(M.FLEET_FAILOVERS).inc({"reason": "death"})
        reg.counter(M.NODES_CREATED).inc({"provisioner": "default"}, 3)
        reg.gauge(M.REMOTE_DEGRADED).set(1)
        reg.gauge(M.FLEET_ENDPOINTS).set(2.0, {"state": "known"})
        for v in (0.003, 0.2, 7.0, 1e6):
            reg.histogram("kt_test_seconds").observe(v, {"stage": "a"})
        reg.histogram(M.REPLAY_LAG).observe(0.02)
        return reg.expose()

    text = run_both(scenario)
    assert 'kt_test_seconds_bucket{stage="a",le="+Inf"} 4' in text
    assert "# HELP karpenter_solver_remote_fallback_solves_total" in text


def _service(k):
    reg = k.metrics.Registry()
    sched = (k.scheduler.BatchScheduler(backend="oracle", registry=reg,
                                        compile_behind=False)
             if k.root == REFERENCE else k.scheduler.BatchScheduler(
                 backend="oracle", registry=reg, device="cpu"))
    return k.server.SolverService(sched, registry=reg), reg


def http(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.headers.get("Content-Type"), \
                resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read().decode()


def test_serve_answers_every_path_like_the_reference():
    """``serve`` over a live service after the same solves: each path's
    status and content type, the JSON documents' key structure, and the
    counts in them; ``/sloz`` and ``/tunez`` 404 without a provider."""

    def scenario(k):
        pod = importlib.import_module(f"{k.root}.models.pod")
        prov = importlib.import_module(f"{k.root}.models.provisioner")
        service, reg = _service(k)
        pipe_pods = [pod.PodSpec(name=f"p{i}", requests={"cpu": 1.0},
                                 owner_key="d") for i in range(12)]
        provs = [prov.Provisioner(name="default").with_defaults()]
        catalog = k.catalog.generate_catalog(full=False)
        for _ in range(2):
            service._pipeline_for(service.scheduler).solve(dict(
                pods=pipe_pods, provisioners=provs, instance_types=catalog))
        flight = service.tracer.flight
        out = {}
        for wired in (True, False):
            kw = dict(extra=service.statusz_extra, sloz=service.sloz,
                      tunez=service.tunez) if wired else {}
            srv, port = k.export.serve(reg, flight, port=0, **kw)
            try:
                for path in ("tracez", "statusz", "sloz", "tunez",
                             "fleetz", "metrics", "nope"):
                    code, ctype, body = http(f"http://127.0.0.1:{port}/"
                                             f"{path}")
                    doc = None
                    if ctype == "application/json" and code == 200:
                        doc = json.loads(body)
                    out[(wired, path)] = (code, ctype,
                                          shape(doc) if doc else None)
                    if path == "statusz" and doc:
                        out[(wired, "admitted")] = doc["admission"][
                            "admitted"]
                    if path == "tracez" and doc:
                        out[(wired, "traces")] = doc["count"]
                    if path == "metrics":
                        out[(wired, "fetch")] = sorted(
                            ln for ln in body.splitlines()
                            if ln.startswith("karpenter_fleet_peer_fetch"))
            finally:
                srv.shutdown()
        service.close()
        return out

    out = run_both(scenario)
    assert out[(True, "sloz")][0] == 200 and out[(False, "sloz")][0] == 404
    assert out[(False, "tunez")][0] == 404 and out[(True, "nope")][0] == 404
    assert out[(True, "metrics")][1] == "text/plain"


def _hop(trace_id, name, start, span_id="s1", attrs=None, spans=()):
    return {"trace_id": trace_id, "name": name, "span_id": span_id,
            "start": start, "end": start + 0.01, "duration_ms": 10.0,
            "attrs": dict(attrs or {}), "spans": list(spans)}


def f_remote_parents(k):
    origin = _hop("op-t000001", "solve", 1.0, spans=[
        _hop("op-t000001", "remote", 1.001, span_id="s2")])
    child = _hop("op-t000001", "solve", 1.002, attrs={
        "remote_parent": "s2", "replica_id": "replica-1"})
    merged = k.fleet.assemble_traces({"operator": [origin],
                                      "replica-1": [child]})
    assert [h["parent_hop"] for h in merged[0]["hops"]] == [-1, 0]
    return merged, k.fleet.merged_span_stats(merged)


def f_session_journey(k):
    tid = "cli-sess-abc"
    est = _hop(tid, "solve", 1.0, attrs={"session_id": "abc",
                                         "replica_id": "replica-0"})
    d1 = _hop(tid, "solve", 2.0, attrs={"session_id": "abc",
                                        "remote_parent": "s1",
                                        "replica_id": "replica-0"})
    d2 = _hop(tid, "solve", 3.0, attrs={"session_id": "abc",
                                        "remote_parent": "s1",
                                        "replica_id": "replica-2"})
    merged = k.fleet.assemble_traces({"replica-0": [est, d1],
                                      "replica-2": [d2]})
    return merged, k.fleet.render_journey(merged[0])


FLEET_DOCS = {
    "http://r0/statusz": {
        "replica_id": "replica-0", "inflight_depth": {"tpu": 1.0},
        "delta_rpc": {"delta": 5.0, "establish": 1.0},
        "sessions": {"abc": {"epoch": 7, "lease_owner": "replica-0"}},
        "traces_recorded": 3.0},
    "http://r0/tracez": {"traces": [_hop("a-t1", "solve", 1.0)]},
    "http://r0/sloz": {"classes": {"critical": {"requests": 3}}},
    "http://r1/statusz": {
        "replica_id": "replica-1", "delta_rpc": {"delta": 2.0},
        "sessions": {"xyz": {"epoch": 2, "lease_owner": "replica-1"}},
        "traces_recorded": 1.0},
    "http://r1/tracez": {"traces": []},
}


def f_merge_and_unreachable(k):
    def fetch(url):
        if url.startswith("http://dead"):
            raise OSError("connection refused")
        if url.startswith("http://slow"):
            raise TimeoutError("timed out")
        return FLEET_DOCS[url]

    reg = k.metrics.Registry()
    k.fleet.zero_init(reg)
    doc = k.fleet.fleetz(["http://r0", "http://r1", "http://dead",
                          "http://slow"],
                         local=(reg, None, None), fetch=fetch)
    assert doc["partial"] is True and len(doc["unreachable"]) == 2
    return doc, k.fleet.render_fleetz(doc), {
        dict(lk)["outcome"]: v for lk, v in
        reg.counter(k.metrics.FLEET_PEER_FETCH).values.items()}


def f_conflicts(k):
    status = {"replica_id": "replica-0", "sessions": {"abc": {"epoch": 1}}}
    docs = {"http://a/statusz": status, "http://a/tracez": {},
            "http://b/statusz": status, "http://b/tracez": {},
            "http://c/statusz": {"replica_id": "replica-1",
                                 "sessions": {"abc": {"epoch": 1}}},
            "http://c/tracez": {}}
    doc = k.fleet.fleetz(["http://a", "http://b", "http://c"],
                         fetch=lambda u: docs[u])
    assert doc["session_conflicts"] == {"abc": ["replica-0", "replica-1"]}
    return doc


def f_env_peers(k):
    import os

    os.environ["KT_OBS_PEERS"] = " http://a:1/ ,http://b:2,, "
    try:
        return k.fleet.env_peers()
    finally:
        os.environ.pop("KT_OBS_PEERS")


FLEET_SCENARIOS = {
    "hops_link_remote_parents": f_remote_parents,
    "session_journey": f_session_journey,
    "merge_and_unreachable": f_merge_and_unreachable,
    "duplicate_replica_and_conflict": f_conflicts,
    "env_peers": f_env_peers,
}


@pytest.mark.parametrize("name", sorted(FLEET_SCENARIOS))
def test_fleetz(name):
    run_both(FLEET_SCENARIOS[name])


def test_fleetz_with_a_dead_peer_over_http():
    """A live replica's obs server and a dead address: the dead peer is
    listed stale, the document partial, and the fetch counted."""

    def scenario(k):
        reg, flight = populate(k)
        srv, port = k.export.serve(reg, flight, port=0,
                                   peers=[f"http://127.0.0.1:{dead}"])
        try:
            code, _ct, body = http(f"http://127.0.0.1:{port}/fleetz")
        finally:
            srv.shutdown()
        doc = json.loads(body)
        stale = [(u["url"], u["outcome"], u["stale"])
                 for u in doc["unreachable"]]
        return (code, doc["partial"], stale, sorted(doc["replicas"]),
                {dict(lk)["outcome"]: v for lk, v in reg.counter(
                    k.metrics.FLEET_PEER_FETCH).values.items()})

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    obs = run_both(scenario)
    assert obs[1] is True and obs[2][0][1:] == ("error", True)
    assert obs[4]["error"] == 1.0


# ---------------------------------------------------------------------------
# the replay harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape_name", ["uniform", "bursty", "diurnal",
                                        "burst-train"])
def test_synthesize_gives_the_reference_records(shape_name):
    def scenario(k):
        recs = k.replay.synthesize(n=60, shape=shape_name, seed=3)
        again = k.replay.synthesize(n=60, shape=shape_name, seed=3)
        assert recs == again
        return recs

    recs = run_both(scenario)
    assert {r["kind"] for r in recs} <= {"solve", "establish", "delta"}


def test_capture_files_and_trace_captures(tmp_path):
    def scenario(k):
        recs = k.replay.synthesize(n=10, shape="uniform", seed=1)
        path = str(tmp_path / f"{k.root}.jsonl")
        k.replay.save_capture(path, recs, source="test", meta={"a": 1})
        loaded, header = k.replay.load_capture(path)
        errors = []
        for bad in ('{"kind": "nope"}\n', "not json\n",
                    json.dumps({"kind": k.replay.CAPTURE_KIND,
                                "version": 999}) + "\n"):
            p = str(tmp_path / "bad.jsonl")
            with open(p, "w") as f:
                f.write(bad)
            with pytest.raises(k.replay.ReplayCaptureError) as exc:
                k.replay.load_capture(p)
            errors.append(str(exc.value).replace(p, "<path>"))
        traces = [
            {"trace_id": "a-t1", "start": 10.0,
             "attrs": {"rpc": "Solve", "n_pods": 40,
                       "priority_class": "batch", "session_id": "abc",
                       "delta": False}},
            {"trace_id": "a-t2", "start": 10.5,
             "attrs": {"rpc": "Solve", "n_pods": 4,
                       "priority_class": "critical", "session_id": "abc",
                       "delta": True}},
            {"trace_id": "a-t3", "start": 11.0, "attrs": {}}]
        return loaded, header, errors, k.replay.capture_from_traces(traces)

    run_both(scenario)


def test_replay_drives_the_real_wire_and_reports_fidelity(tmp_path):
    def scenario(k):
        recs = k.replay.synthesize(n=12, shape="uniform", seed=5,
                                   mean_rate=30.0, n_pods=12, churn=2,
                                   sessions=2)
        service, reg = _service(k)
        sock = f"unix:{tmp_path}/{k.root}.sock"
        srv, _ = k.server.make_server(service, host=sock)
        try:
            rp = k.replay.Replayer(sock, registry=reg,
                                   catalog=k.catalog.generate_catalog(
                                       full=False))
            report = rp.run(recs, speedup=4.0)
            fid = k.replay.fidelity(recs, report)
        finally:
            srv.stop(grace=None)
            service.close()
        return (report["n"], report["outcomes"], report["classes"],
                report["implicit_establishes"], sorted(report),
                fid["class_mix_match"], fid["errors"], sorted(fid),
                reg.counter(k.metrics.REPLAY_REQUESTS).get(
                    {"outcome": "ok"}))

    obs = run_both(scenario)
    assert obs[0] == 12 and obs[1].get("ok") == 12 and obs[-1] == 12.0
