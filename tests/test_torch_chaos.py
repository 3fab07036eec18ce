"""The port's chaos, restart and fleet-failover drivers
(``scripts/chaos_drive_torch.py``) against the reference's
(``scripts/chaos_drive.py``) on the CPU, at the reference tests' sizes.

- ``run_chaos(seed=12, steps=24, pods_n=400, churn=4)`` on
  ``backend="tpu"`` (the device path, ``device="cpu"``) and on
  ``backend="oracle"``, with the reference's assertions
  (``tests/test_faults.py::TestChaosSmoke``); the four invariants are
  asserted inside the driver.  On ``oracle`` the scoreboard equals the
  reference driver's on the seeded fields (run twice first: only the
  fields equal across two reference runs are compared — the transport
  rules count into the process-global registry, which both drivers
  report cumulatively, and the re-establish count moves with the spool
  writer's timing);
- ``run_restart`` at 300 pods and 2 clients with the sidecar subprocess on
  ``--device cpu``: 0 re-establishes with a snapshot, exactly 2 without,
  and both sidecars stop cleanly and report their kernel launches (none
  on the host);
- ``run_fleet(replicas=3, clients=4, pods_n=320, pre_steps=2,
  post_steps=2, churn=3, seed=12)`` in each of the five modes, with the
  reference's assertions (``tests/test_fleet.py::TestFleetChaosSmoke``)
  and the mode checks the driver carries;
- every driver raises without a card when no device is given.

Tolerance: equal.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: the reference tests' tier-1 sizes
CHAOS = dict(seed=12, steps=24, pods_n=400, churn=4)
RESTART = dict(pods_n=300, clients=2, pre_steps=2, post_steps=2, churn=3)
FLEET = dict(replicas=3, clients=4, pods_n=320, pre_steps=2, post_steps=2,
             churn=3, seed=12)
#: scoreboard fields a seed determines, compared with the reference's.
#: Not ``full_resends``: whether a wiped or expired session restores warm
#: from the spool depends on whether the periodic writer ran between two
#: steps, so on a loaded host two reference runs read 3 and 5
SEEDED = ("faults_injected", "injected_by_rule", "parity_checked_steps",
          "typed_errors", "delta_rpcs")


def _load(name, file):
    spec = importlib.util.spec_from_file_location(name, ROOT / file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load("chaos_drive_torch_tests", "scripts/chaos_drive_torch.py")


@pytest.fixture(scope="module")
def reference():
    return _load("chaos_drive_tests", "scripts/chaos_drive.py")


def _check_chaos_board(board):
    # the schedule actually fired (composability is the point)
    assert board["faults_injected"] >= 6
    assert len(board["injected_by_rule"]) >= 6
    # typed errors only, bounded recovery and per-step parity are
    # asserted inside run_chaos — reaching here means clean
    assert board["parity_checked_steps"] >= board["steps"] - sum(
        board["typed_errors"].values())


def _stable(a, b):
    """The part of two scoreboards that is equal: whole fields, and the
    equal entries of ``injected_by_rule``."""
    out = {}
    for key in SEEDED:
        if key == "injected_by_rule":
            out[key] = {r: v for r, v in a[key].items()
                        if b[key].get(r) == v}
        elif a[key] == b[key]:
            out[key] = a[key]
    return out


@pytest.mark.parametrize("backend", ["tpu", "oracle"])
def test_seeded_composed_schedule_recovers_clean(port, backend):
    board = port.run_chaos(**CHAOS, verbose=False, backend=backend,
                           device="cpu")
    _check_chaos_board(board)
    assert board["backend"] == backend and board["device"] == "cpu"


def test_oracle_scoreboard_is_the_reference(port, reference):
    ref = [reference.run_chaos(**CHAOS, verbose=False) for _ in range(2)]
    stable = _stable(*ref)
    # what two reference runs agree on, checked first: the whole seeded
    # outcome, and every server-side rule's count
    for key in ("faults_injected", "parity_checked_steps", "typed_errors"):
        assert key in stable, key
    assert len(stable["injected_by_rule"]) >= 6
    got = port.run_chaos(**CHAOS, verbose=False, backend="oracle",
                         device="cpu")
    for key, want in stable.items():
        if key == "injected_by_rule":
            # rules other tests of this process fired may be in either
            # board too: hold the port to the rules both reference runs
            # counted alike
            assert {r: got[key].get(r) for r in want} == want
        else:
            assert got[key] == want, key


@pytest.mark.parametrize("snapshot,expect", [(True, 0), (False, 2)])
def test_restart_costs_zero_with_a_snapshot_and_one_each_without(
        port, snapshot, expect):
    board = port.run_restart(**RESTART, snapshot=snapshot, verbose=False,
                             device="cpu")
    assert board["extra_resends"] == expect
    assert board["clients"] == 2 and board["device"] == "cpu"
    assert len(board["first_post_delta_ms"]) == 2
    assert board["relaunch_ready_s"] > 0
    assert board["restart_wall_s"] >= board["relaunch_ready_s"]
    # both sidecars stopped on SIGTERM and counted no kernel launch
    from karpenter_tpu_torch import kernels

    assert board["server_launches"] == [
        {k.name: 0 for k in kernels.ALL}] * 2


@pytest.mark.parametrize("mode", ["kill", "drain", "kill-cold", "contend",
                                  "stale"])
def test_fleet_mode_recovers(port, mode):
    board = port.run_fleet(**FLEET, mode=mode, verbose=False, device="cpu")
    assert board["mode"] == mode and board["backend"] == "tpu"
    assert board["victim_sessions"] >= 1
    assert board["conformance"]["violations"] == 0
    if mode == "kill":
        assert board["extra_resends"] == 0
        assert board["adoptions"].get("stolen", 0) \
            >= board["victim_sessions"]
    elif mode == "drain":
        assert board["extra_resends"] == 0
        assert board["adoptions"].get("adopted", 0) \
            >= board["victim_sessions"]
    elif mode == "contend":
        assert board["extra_resends"] <= 1
        assert sum(board["contention_refusals"].values()) == 1
    else:  # kill-cold, stale: exactly one re-establish per session
        assert board["extra_resends"] == board["victim_sessions"]


@pytest.mark.parametrize("driver", ["run_chaos", "run_restart",
                                    "run_fleet"])
def test_drivers_default_to_the_card(port, driver, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(port, driver)(verbose=False)

