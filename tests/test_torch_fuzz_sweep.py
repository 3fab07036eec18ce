"""``scripts/fuzz_sweep_torch.py``'s modes on the CPU, each seed held to the
reference package step by step.

The reference's ``scripts/fuzz_sweep.py`` sweeps at import, so it cannot
be called.  Each test here runs one seed of a port mode on
``device="cpu"`` and drives the same seeded work through the reference
package: the reference's generators build the scenario, the step inputs
the port's record names (added pods converted with ``to_reference``,
removed names, ICE'd offerings, reclaimed nodes) are applied in the same
order, and both packages' node-name counters start every solve from the
value the record carries.  At every step the reference's result must
match the port's: the mode, the new-node cost to 1e-6, ``n_scheduled``,
and the node plan or ``placements_tie``.  Every port record must show no
problem.  The reference schedulers compile inline
(``compile_behind=False``).

Also the script's command line: ``--device cpu`` exits 0 with the
reference's summary lines; without ``--device`` it raises on a machine
without a card.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import karpenter_tpu.solver.relax as ref_relax
from karpenter_tpu.metrics import Registry as RefRegistry
from karpenter_tpu.models.catalog import generate_catalog as ref_catalog
from karpenter_tpu.models.provisioner import Provisioner as RefProv
from karpenter_tpu.models.tensorize import batch_needs_oracle as ref_needs_oracle
from karpenter_tpu.models.tensorize import device_inexpressible as ref_inexpressible
from karpenter_tpu.models.tensorize import tensorize as ref_tensorize
from karpenter_tpu.service.client import DeltaSession as RefDeltaSession
from karpenter_tpu.service.server import SolverService as RefService
from karpenter_tpu.service.server import make_server as ref_make_server
from karpenter_tpu.solver import hierarchy as ref_hier
from karpenter_tpu.solver import reference as ref_oracle
from karpenter_tpu.solver.scheduler import BatchScheduler as RefScheduler
from karpenter_tpu.solver.scheduler import _harden_preferences as ref_harden
from karpenter_tpu.solver.tpu import TpuSolver as RefTpuSolver
from karpenter_tpu_torch.models.catalog import generate_catalog
from karpenter_tpu_torch.solver.validate import unaccounted_pods
from scripts import fuzz_sweep_torch as fz

sys.path.insert(0, os.path.dirname(__file__))
import test_fuzz_parity as ref_fuzz  # noqa: E402
from test_torch_fuzz_parity import (  # noqa: E402
    assert_same_solve,
    content,
    names_from,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def catalogs():
    return ref_catalog(full=False), generate_catalog(full=False)


def to_reference(obj, memo=None):
    """The reference's copy of a port model object: the class of the same
    name in the reference's module of the same path, field by field."""
    memo = {} if memo is None else memo
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, (list, tuple, set, frozenset)):
        out = type(obj)(to_reference(v, memo) for v in obj)
    elif isinstance(obj, dict):
        out = {to_reference(k, memo): to_reference(v, memo)
               for k, v in obj.items()}
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = sys.modules[type(obj).__module__.replace(
            "karpenter_tpu_torch.", "karpenter_tpu.", 1)]
        cls = getattr(mod, type(obj).__name__)
        out = cls(**{f.name: to_reference(getattr(obj, f.name), memo)
                     for f in dataclasses.fields(obj) if f.init})
    else:
        out = obj
    memo[id(obj)] = out
    return out


class SeedProblems(AssertionError):
    """A port record that shows problems."""


def no_problems(rec):
    if rec["problems"]:
        raise SeedProblems(f"seed {rec['seed']}: {rec['problems']}")


class ReferenceLosesPods(AssertionError):
    """The reference's chain result accounts for fewer pods than the
    port's: a pod neither seated nor infeasible."""


#: wire seed 3: a reclaim's full fallback at step 2 leaves d0-8
#: unplaced; at step 3 the reference's chain drops it from the result
#: while the port keeps it and seats it (ROADMAP C1, fixed in the port)
C1 = pytest.mark.xfail(strict=True, raises=ReferenceLosesPods,
                       reason="C1: the reference loses the pods a full "
                       "fallback left unplaced at the next full")

#: chain seeds the reference's own sweep fails the same way (ROADMAP C10):
#: held to the reference step by step, then expected to show problems
#: (any other failure fails the test)
C10 = pytest.mark.xfail(strict=True, raises=SeedProblems,
                        reason="C10: the reference's chain breaks the delta "
                        "cost ceiling at this seed")


# ---------------------------------------------------------------------------
# warm-start chains
# ---------------------------------------------------------------------------


def replay_steps(rec, rcat, solve_base, solve_step, tag):
    """Drive one recorded chain through the reference: the base solve and
    every step from the record's counters, each against the port's
    result, and each step's from-scratch re-solve likewise."""
    pods, provs, unavailable = ref_fuzz.random_scenario(rec["seed"], rcat)
    assert content(provs) == content(rec["provisioners"])
    names_from(rec["base"]["names_at"])
    cur = solve_base(pods, provs, unavailable)
    assert_same_solve(rec["base"]["result"], cur, f"{tag} base")
    if cur.infeasible:
        pods = [p for p in pods if p.name not in set(cur.infeasible)]
    cur_pods = {p.name: p for p in pods}
    unavail = set(unavailable or ())
    for i, step in enumerate(rec["steps"]):
        added = to_reference(step["added"])
        if step["kind"] == "ice":
            unavail.add(step["iced"][0])
        names_from(step["names_at"])
        cur, mode, unavail_now = solve_step(cur, added, step, provs, unavail)
        assert mode == step["mode"], f"{tag} step {i}"
        for n in step["removed"]:
            cur_pods.pop(n, None)
        for p in added:
            cur_pods[p.name] = p
        lost = set(cur_pods) - set(cur.assignments) - set(cur.infeasible)
        if lost and not unaccounted_pods(list(cur_pods.values()),
                                         step["result"]):
            raise ReferenceLosesPods(f"{tag} step {i}: {sorted(lost)}")
        assert_same_solve(step["result"], cur, f"{tag} step {i}")
        assert unavail_now == step["unavailable"]
        names_from(step["full_names_at"])
        full = RefScheduler(backend="tpu", compile_behind=False).solve(
            list(cur_pods.values()), provs, rcat,
            unavailable=unavail_now or None)
        assert_same_solve(step["full"], full, f"{tag} step {i} full")


@pytest.mark.parametrize("seed", [0, 1, 2, pytest.param(8, marks=C10)])
def test_delta_chain_matches_reference(seed, catalogs):
    """``--delta``, 4 steps: the port's chain has no problem and every
    step's mode, cost, pods and plan are the reference's."""
    rcat, pcat = catalogs
    (rec,) = fz.run_delta_chains(1, 4, device="cpu", seeds=[seed],
                                 catalog=pcat, verbose=False)
    sched = RefScheduler(backend="tpu", compile_behind=False)

    def base(pods, provs, unavailable):
        return sched.solve(pods, provs, rcat, unavailable=unavailable)

    def step(cur, added, s, provs, unavail):
        out = sched.solve_delta(
            cur, added=added, removed=list(s["removed"]),
            iced=list(s["iced"]), provisioners=provs, instance_types=rcat,
            unavailable=unavail)
        return out.result, out.mode, set(unavail)

    replay_steps(rec, rcat, base, step, f"delta seed {seed}")
    no_problems(rec)


@pytest.mark.parametrize("seed", [0, 1, pytest.param(3, marks=C1),
                                  pytest.param(8, marks=C10)])
def test_delta_wire_chain_matches_reference(seed, catalogs):
    """``--delta-wire``, 4 steps: a real gRPC session on each side (the
    port's client and server, the reference's), the same epochs, results
    and re-solves."""
    rcat, pcat = catalogs
    (rec,) = fz.run_delta_wire_chains(1, 4, device="cpu", seeds=[seed],
                                      catalog=pcat, verbose=False)
    reg = RefRegistry()
    service = RefService(RefScheduler(backend="tpu", registry=reg,
                                      compile_behind=False), registry=reg)
    srv, port = ref_make_server(service, port=0)
    sess = RefDeltaSession(f"127.0.0.1:{port}", timeout=120.0)
    try:
        def base(pods, provs, unavailable):
            return sess.solve(pods, provs, rcat, unavailable=unavailable)

        def step(cur, added, s, provs, unavail):
            got = sess.solve_delta(added=added, removed=list(s["removed"]),
                                   iced=list(s["iced"]))
            pipe = list(service._pipelines.values())[0]
            epoch = pipe._delta_tab.get(sess.session_id).epoch
            return got, epoch, set(sess._unavailable)

        replay_steps(rec, rcat, base, step, f"wire seed {seed}")
    finally:
        sess.close()
        srv.stop(grace=None)
        service.close()
    no_problems(rec)


# ---------------------------------------------------------------------------
# the relax rung, the hierarchical decomposition, gangs
# ---------------------------------------------------------------------------


class ReferenceLeavesPods(AssertionError):
    """The reference's scan leaves pods unplaced that the port's seats."""


#: relax seed 10: the reference's flat scan leaves one pod of a zone-spread
#: deployment unplaced (d1-29), the port's seats all 407 (ROADMAP C2, fixed
#: in the port), so the reference's rung finds nothing to free and skips
#: while the port's runs and falls back to its scan
C2 = pytest.mark.xfail(strict=True, raises=ReferenceLeavesPods,
                       reason="C2: the reference's scan leaves a spread "
                       "pod unplaced")


@pytest.mark.parametrize("seed", [0, 1, 2, pytest.param(10, marks=C2)])
def test_relax_seed_matches_reference(seed, catalogs):
    """``--relax``: the same routing, outcome, scan and shipped plan as the
    reference's scan and ``relax.refine`` on the reference's scenario."""
    rcat, pcat = catalogs
    (rec,) = fz.run_relax_seeds(1, device="cpu", seeds=[seed],
                                catalog=pcat, verbose=False)
    no_problems(rec)
    base, provs, unavailable = ref_fuzz.random_scenario(seed, rcat)
    pods = [ref_harden(p) for p in base] + to_reference(fz._relax_mix(seed))
    scen = fz.relax_scenario(seed, pcat)
    skipped = ref_needs_oracle(pods) or any(ref_inexpressible(p)
                                            for p in pods)
    assert skipped == (scen is None) == bool(rec.get("skipped"))
    if skipped:
        return
    assert content(scen[0]) == content(pods)
    st = ref_tensorize(pods, provs, rcat, unavailable=unavailable)
    names_from(rec["names_at"])
    scan = RefTpuSolver().solve(st, track_assignments=True).result
    left = set(scan.infeasible) - set(rec["scan"].infeasible)
    if left:
        raise ReferenceLeavesPods(f"relax seed {seed}: {sorted(left)}")
    assert_same_solve(rec["scan"], scan, f"relax seed {seed} scan")
    shipped, outcome = ref_relax.refine(scan, st, registry=RefRegistry())
    assert outcome == rec["outcome"]
    assert_same_solve(rec["shipped"], shipped, f"relax seed {seed}")


@pytest.mark.parametrize("seed", range(3))
def test_hier_seed_matches_reference(seed, catalogs):
    """``--hier``: the reference's coupling components and block
    partitions, and its flat and hierarchical plans on the disjoint and
    the overlapping batch."""
    rcat, pcat = catalogs
    (rec,) = fz.run_hier_seeds(1, device="cpu", seeds=[seed], catalog=pcat,
                               verbose=False)
    no_problems(rec)
    provs = [RefProv(name="default").with_defaults()]
    sched = RefScheduler(backend="tpu", compile_behind=False)
    cpods, cprovs, unav = ref_fuzz.random_scenario(seed, rcat)
    st = ref_tensorize(cpods, cprovs, rcat, unavailable=unav)
    comps = ref_hier.coupling_components(st)
    assert [list(map(int, c)) for c in comps] == rec["components"]
    for max_blocks, blocks in rec["partitions"].items():
        masks = ref_hier.partition_blocks(st, comps, max_blocks)
        assert [m.nonzero()[0].tolist() for m in masks] == blocks
    for kind, disjoint in (("d", True), ("o", False)):
        pods = to_reference(fz._hier_fuzz_scenario(seed, disjoint))
        names_from(rec["names_at"][f"{kind}flat"])
        flat = sched.solve(pods, provs, rcat, relax=False)
        assert_same_solve(rec["results"][f"{kind}flat"], flat,
                          f"hier seed {seed} {kind}flat")
        names_from(rec["names_at"][f"{kind}hier"])
        hier = ref_hier.solve_hierarchical(sched, pods, provs, rcat)
        assert_same_solve(rec["results"][f"{kind}hier"], hier,
                          f"hier seed {seed} {kind}hier")


@pytest.mark.parametrize("seed", range(4))
def test_gang_seed_matches_reference(seed, catalogs):
    """``--gang``: the same gangs placed and retracted with the same typed
    reasons, and the same singleton-subset plans, as the reference's
    scheduler and oracle."""
    rcat, pcat = catalogs
    (rec,) = fz.run_gang_seeds(1, device="cpu", seeds=[seed], catalog=pcat,
                               verbose=False)
    no_problems(rec)
    base, provs, unavailable = ref_fuzz.random_scenario(seed, rcat)
    pods = to_reference(fz._gangify(seed, fz.random_scenario(seed, pcat)[0])[0])
    names_from(rec["names_at"]["gang"])
    res = RefScheduler(backend="tpu", compile_behind=False).solve(
        pods, provs, rcat, unavailable=unavailable)
    assert_same_solve(rec["result"], res, f"gang seed {seed}")
    assert {n: str(r) for n, r in res.infeasible.items()} == {
        n: str(r) for n, r in rec["result"].infeasible.items()}
    singles = [p for p in pods if not p.gang_id]
    if not singles:
        assert rec["singles"] is None
        return
    oracle = ref_oracle.solve(singles, provs, rcat, unavailable=unavailable)
    assert_same_solve(rec["singles_oracle"], oracle, f"gang seed {seed}")
    names_from(rec["names_at"]["singles"])
    got = RefScheduler(backend="tpu", compile_behind=False).solve(
        singles, provs, rcat, unavailable=unavailable)
    assert_same_solve(rec["singles"], got, f"gang seed {seed} singles")


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _run(*args, env=None):
    return subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "fuzz_sweep_torch.py"),
         *args], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=env)


def test_cli_on_the_host_prints_the_reference_summary_lines():
    proc = _run("--device", "cpu", "plain,kubelet", "6")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("plain: n=6 mean=")
    assert lines[1].startswith("kubelet: n=")
    proc = _run("--gang", "2", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith(
        "gang sweep: ") and "over 2 seeds" in proc.stdout


def test_cli_without_device_raises_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run("plain", "1", env=env)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "CUDA" in proc.stderr
    assert proc.stdout == ""
