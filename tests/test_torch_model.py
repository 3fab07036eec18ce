"""The port's protocol model checker and trace conformance checker
(``karpenter_tpu_torch/analysis/{model,conformance}.py``) against the
reference's, on the CPU.

The port speaks the reference's session protocol unchanged, so its models
and automaton are the reference's:

1. **Models** — for each shipped model (``delta-epoch``,
   ``lease-failover``, ``lease-automaton-simulation``) the port's
   exhaustive exploration visits the reference's state and transition
   counts; each seeded violation (one real guard removed) makes both DFSs
   find the same invariant along the same counterexample.
2. **Conformance** — the same event sets, clean and tampered, give equal
   reports from both ``check_events``; event sets recorded from the
   port's ``SolverService`` delta chain (``device="cpu"``, through the
   port's ``DeltaSession`` on a unix socket, plus a session closed and
   re-established) pass both checkers.

No test asserts on wall-clock time.

Tolerance: equal.
"""

import json
import tempfile

import pytest
import torch

from karpenter_tpu.analysis import conformance as ref_conformance
from karpenter_tpu.analysis import model as ref_model
from karpenter_tpu_torch.analysis import conformance, model

torch.set_num_threads(1)

MODELS = ["delta-epoch", "lease-failover", "lease-automaton-simulation"]


@pytest.fixture(scope="module")
def checked():
    return ({r.model: r for r in ref_model.check_all()},
            {r.model: r for r in model.check_all()})


@pytest.mark.parametrize("name", MODELS)
def test_model_explores_the_reference_state_space(checked, name):
    ref, port = checked[0][name], checked[1][name]
    assert port.ok and ref.ok
    assert not port.truncated and not ref.truncated
    assert (port.states, port.transitions) == (ref.states, ref.transitions)
    assert port.states > 10_000


def test_model_order_is_the_references(checked):
    assert list(checked[1]) == list(checked[0]) == MODELS


def test_seeded_violation_tables_match():
    assert sorted(model.SEEDED_VIOLATIONS) == \
        sorted(ref_model.SEEDED_VIOLATIONS)
    assert model.SESSION_AUTOMATON == ref_model.SESSION_AUTOMATON
    assert model.AUTOMATON_STATES == ref_model.AUTOMATON_STATES


@pytest.mark.parametrize("invariant", sorted(model.SEEDED_VIOLATIONS))
def test_seeded_violation_fires_the_same_invariant(invariant):
    port = model.explore(model.SEEDED_VIOLATIONS[invariant]())
    ref = ref_model.explore(ref_model.SEEDED_VIOLATIONS[invariant]())
    assert port.violation is not None
    assert port.violation.invariant == invariant
    assert ref.violation.invariant == invariant
    assert port.violation.trace and \
        list(port.violation.trace) == list(ref.violation.trace)
    assert port.states == ref.states


def test_broken_toy_protocol_is_caught_by_both():
    port = model.explore(model.BrokenCounterModel())
    ref = ref_model.explore(ref_model.BrokenCounterModel())
    assert port.violation.invariant == ref.violation.invariant \
        == "no-lost-update"
    assert list(port.violation.trace) == list(ref.violation.trace)


def test_truncation_is_reported_as_in_the_reference():
    port = model.explore(model.EpochModel(), max_states=50)
    ref = ref_model.explore(ref_model.EpochModel(), max_states=50)
    assert port.truncated and ref.truncated and not port.ok
    assert port.to_json()["states"] == ref.to_json()["states"]


def test_cli_model_json(capsys):
    from karpenter_tpu_torch.analysis.ktlint import main

    assert main(["--model", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True
    assert [r["model"] for r in doc["models"]] == MODELS
    assert all(r["exhaustive"] for r in doc["models"])
    assert model.main(fmt="text", max_states=50) == 1
    assert "TRUNCATED" in capsys.readouterr().out


@pytest.mark.parametrize("seq", [
    ("establish", "claim", "commit", "spool"),
    ("establish", "commit", "handoff", "adopt", "commit"),
    ("establish", "evict:ttl", "adopt", "steal", "commit"),
    ("establish", "handoff", "reap", "establish"),
    ("serve_unknown", "establish", "drop:error"),
    ("establish", "evict:ttl", "evict:ttl"),
    ("evict:ttl", "reap", "evict:ttl"),
    ("establish", "handoff", "reap", "commit"),
])
def test_accepts_agrees(seq):
    assert model.accepts(seq) == ref_model.accepts(seq)


# ---------------------------------------------------------------------------
# conformance: the same event sets through both checkers
# ---------------------------------------------------------------------------


def _ev(*names, replica="r0"):
    return [(n, {"replica": replica}) for n in names]


EVENT_SETS = {
    "clean": {"s1": _ev("establish", "claim", "commit", "spool",
                        "evict:ttl", "adopt", "commit")},
    "unknown_vocabulary": {"s1": _ev("establish", "warp_drive")},
    "leaves_the_language": {"s1": _ev("establish", "handoff", "reap",
                                      "commit")},
    "drainer_serves_handed_off_chain": {"s1": [
        ("establish", {"replica": "r0"}), ("handoff", {"replica": "r0"}),
        ("commit", {"replica": "r0"})]},
    "drainer_reacquires": {"s1": [
        ("establish", {"replica": "r0"}), ("handoff", {"replica": "r0"}),
        ("adopt", {"replica": "r0"}), ("commit", {"replica": "r0"})]},
    "acquired_elsewhere": {"s1": [
        ("establish", {"replica": "r0"}), ("handoff", {"replica": "r0"}),
        ("adopt", {"replica": "r1"}), ("commit", {"replica": "r1"}),
        ("handoff", {"replica": "r1"}), ("adopt", {"replica": "r0"}),
        ("commit", {"replica": "r0"})]},
    "several_sessions": {"a": _ev("establish", "nonsense"),
                         "b": _ev("establish", "commit"),
                         "c": _ev("establish", "nonsense")},
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(EVENT_SETS))
def test_check_events_reports_equal(name):
    port = conformance.check_events(EVENT_SETS[name])
    ref = ref_conformance.check_events(EVENT_SETS[name])
    assert port.to_json() == ref.to_json()
    assert port.format() == ref.format()


# ---------------------------------------------------------------------------
# event sets recorded from the port's serving stack
# ---------------------------------------------------------------------------

GIB = 1024.0 ** 3


def _pods(tag, n, g0=0):
    from karpenter_tpu_torch.models.pod import PodSpec

    return [PodSpec(
        name=f"{tag}-{i}", labels={"app": f"d{(i + g0) % 4}"},
        requests={"cpu": 0.5 + (i % 3) * 0.25, "memory": (1 + i % 2) * GIB},
        owner_key=f"d{(i + g0) % 4}") for i in range(n)]


@pytest.fixture(scope="module")
def recorded_chain():
    """The port's wire delta chain on ``device="cpu"``: a 120-pod session
    through 8 steps of 4 removals and 4 adds, then a second session closed
    and re-established under the same id, all under the port's
    transition tap."""
    from karpenter_tpu_torch.metrics import Registry
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.obs import protocol
    from karpenter_tpu_torch.service.client import DeltaSession
    from karpenter_tpu_torch.service.server import SolverService, make_server
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    catalog = generate_catalog(full=False)
    provs = [Provisioner(name="default").with_defaults()]
    reg = Registry()
    service = SolverService(
        BatchScheduler(backend="tpu", device="cpu", registry=reg),
        registry=reg)
    sock = f"unix:{tempfile.mkdtemp(prefix='kt-conf-')}/solver.sock"
    server, _ = make_server(service, host=sock)
    try:
        with protocol.recording() as rec:
            sess = DeltaSession(sock, session_id="chain")
            base = _pods("p", 120)
            sess.solve(base, provs, catalog)
            live = [p.name for p in base]
            for step in range(8):
                rm = live[step::13][:4]
                live = [n for n in live if n not in set(rm)]
                add = _pods(f"c{step}", 4, g0=step)
                sess.solve_delta(added=add, removed=rm)
                live += [p.name for p in add]
            sess.close()
            again = None
            for _round in range(2):
                again = DeltaSession(sock, session_id="again")
                again.solve(_pods("a", 40), provs, catalog)
                again.solve_delta(added=_pods("ax", 3), removed=["a-0"])
                again.close()
            epochs = again.epoch
        return rec.events_by_session(), epochs
    finally:
        server.stop(grace=None)
        service.close()


def test_recorded_port_chain_conforms_in_both(recorded_chain):
    events, _epoch = recorded_chain
    assert set(events) == {"chain", "again"}
    port = conformance.check_events(events)
    ref = ref_conformance.check_events(events)
    assert port.ok, port.format()
    assert port.to_json() == ref.to_json()
    assert port.sessions == 2
    names = [e for e, _attrs in events["chain"]]
    assert names[0] == "establish" and names.count("commit") >= 8
    again = [e for e, _attrs in events["again"]]
    assert again.count("establish") == 2


def _tampered(events):
    chain = list(events["chain"])
    return {
        "unknown_event": {"chain": chain[:3] + [("warp_drive", {})]
                          + chain[3:]},
        "commit_after_handoff": {"chain": chain + [
            ("handoff", dict(chain[-1][1])),
            ("commit", dict(chain[-1][1]))]},
        "reordered": {"chain": [chain[1], chain[0]] + chain[2:]},
        "second_session_broken": {
            "chain": chain,
            "again": [("evict:ttl", {}), ("reap", {}), ("evict:ttl", {})]},
    }


@pytest.mark.parametrize("kind", ["unknown_event", "commit_after_handoff",
                                  "reordered", "second_session_broken"])
def test_tampered_port_events_give_equal_reports(recorded_chain, kind):
    events, _epoch = recorded_chain
    tampered = _tampered(events)[kind]
    port = conformance.check_events(tampered)
    ref = ref_conformance.check_events(tampered)
    assert port.to_json() == ref.to_json()
    if kind != "reordered":
        assert not port.ok, port.format()


def test_check_recorder_roundtrip():
    from karpenter_tpu_torch.obs import protocol

    rec = protocol.TransitionRecorder()
    with protocol.recording(rec):
        protocol.emit("s1", "establish", replica="r0")
        protocol.emit("s1", "commit", replica="r0", epoch=1)
    protocol.emit("s1", "warp_drive", replica="r0")
    assert len(rec) == 2
    assert conformance.check_recorder(rec).ok
    assert protocol.installed() is None
