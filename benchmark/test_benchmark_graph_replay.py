"""The reader of ``scan.graph_replay_share`` and its entry in the manifest:
the share of the window's group loops on the card that a replay of their
signature's CUDA graph served, from the program's replay histogram.

    python -m pytest benchmark -q
"""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.test_benchmark_run import run_tiny

NAME = "scan.graph_replay_share"
HIST = "karpenter_solver_scan_graph_replays"
CELLS = ("zonespread-50k.burst", "zonespread-100k.burst")


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def run_of(hist_delta: dict) -> harness.Run:
    return harness.Run(window=[], window_s=1.0, setup_s=0.0,
                       hist_delta=hist_delta)


def test_the_reader_says_nothing_without_observations():
    read = harness.reader(NAME)
    assert read(run_of({})) is None
    assert read(run_of({HIST: (0.0, 0)})) is None


def test_the_reader_gives_the_replayed_share():
    read = harness.reader(NAME)
    assert read(run_of({HIST: (0.0, 4)})) == 0.0
    assert read(run_of({HIST: (45.0, 50)})) == 0.9
    assert read(run_of({HIST: (7.0, 7)})) == 1.0


def test_the_manifest_lists_it_in_both_accepted_cells(man):
    entry = next(m for m in man["per_layer"] if m["name"] == NAME)
    assert entry == {"name": NAME, "unit": "ratio", "better": "higher",
                     "source": "program_counter", "layer": "device solve",
                     "moves": "pods_per_s", "workloads": list(CELLS)}
    assert man["per_layer"][-1] is entry
    for cell in CELLS:
        assert NAME in {m["name"] for m in harness.cell(man, cell)[
            "per_layer"]}


def test_a_host_run_leaves_it_out(man):
    """Host tensors never reach the graph cache: a traced run on the CPU
    observes no loop and its line leaves the share out."""
    out = run_tiny(man, CELLS[0], trace=True)
    assert out["correct"] is True
    assert NAME not in out["metrics"]
