"""The port's convex-relaxation rung against the reference package, on the CPU.

Three layers, held apart so a difference points at one of them:

- the device program (``_relax_program``) on the same numpy inputs —
  built by the port from the reference's tensors carried in with
  ``tensors_from_reference`` — against the reference's jitted program:
  ``best_cost`` within rtol 1e-5, ``best_x`` within rtol 1e-4 / atol 1e-3
  (the port reproduces the reference's float32 arithmetic; the descent is
  chaotic, so anything looser would not hold over 64 steps);
- the host rounding, materialisation and self-validation fed the
  reference's own ``best_x``: byte-equal node plans and assignments;
- end to end: ``BatchScheduler(backend="tpu", device="cpu").solve`` at its
  default ``relax`` against the reference's scheduler with its programs
  compiled (the port compiles nothing, so it always serves as a warm
  reference does): the same outcome label and equal plans or
  ``placements_tie``.

Plus the skip policy and the outcome counting.  Batches are built once
with the reference's models and converted to the port's (``to_port``).
"""

import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch

import karpenter_tpu.solver.relax as ref_relax
from karpenter_tpu.metrics import RELAX_TOTAL as REF_RELAX_TOTAL
from karpenter_tpu.metrics import Registry as RefRegistry
from karpenter_tpu.models import labels as RL
from karpenter_tpu.models.catalog import generate_catalog as ref_catalog
from karpenter_tpu.models.instancetype import GIB
from karpenter_tpu.models.pod import (
    LabelSelector,
    PodSpec,
    TopologySpreadConstraint,
)
from karpenter_tpu.models.provisioner import Provisioner as RefProv
from karpenter_tpu.models.tensorize import tensorize as ref_tensorize
from karpenter_tpu.solver.scheduler import BatchScheduler as RefScheduler
from karpenter_tpu.solver.tpu import TpuSolver as RefTpuSolver
from karpenter_tpu_torch.metrics import (
    RELAX_DURATION,
    RELAX_IMPROVEMENT,
    RELAX_OUTCOMES,
    RELAX_TOTAL,
    Registry,
)
from karpenter_tpu_torch.models.catalog import generate_catalog
from karpenter_tpu_torch.models.provisioner import Provisioner
from karpenter_tpu_torch.models.tensorize import tensorize
from karpenter_tpu_torch.solver import relax
from karpenter_tpu_torch.solver.scheduler import BatchScheduler
from karpenter_tpu_torch.solver.tpu import TpuSolver, tensors_from_reference

sys.path.insert(0, os.path.dirname(__file__))
from test_fuzz_parity import validate_solution  # noqa: E402

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# one batch, two packages
# ---------------------------------------------------------------------------


def to_port(obj, memo=None):
    """The port's copy of a reference model object (pods, selectors,
    requirements, taints, nodes ...): the class of the same name in the
    port's module of the same path, field by field."""
    memo = {} if memo is None else memo
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, (list, tuple, set, frozenset)):
        out = type(obj)(to_port(v, memo) for v in obj)
    elif isinstance(obj, dict):
        out = {to_port(k, memo): to_port(v, memo) for k, v in obj.items()}
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = sys.modules[type(obj).__module__.replace(
            "karpenter_tpu.", "karpenter_tpu_torch.", 1)]
        cls = getattr(mod, type(obj).__name__)
        out = cls(**{f.name: to_port(getattr(obj, f.name), memo)
                     for f in dataclasses.fields(obj) if f.init})
    else:
        out = obj
    memo[id(obj)] = out
    return out


def mix_pods(n_per=40, n_dep=6, spread_deps=0, tag="rx"):
    """The reference's ``tests/test_relax.py`` batch: complementary
    cpu-heavy / memory-heavy / balanced deployments, the first
    ``spread_deps`` with a hard zone spread."""
    pods = []
    for d in range(n_dep):
        kind = d % 3
        if kind == 0:
            cpu, mem = 1.0 + (d % 3) * 0.5, 0.25 * GIB
        elif kind == 1:
            cpu, mem = 0.1 + 0.05 * d, (6.0 + 2 * (d % 2)) * GIB
        else:
            cpu, mem = 0.5 * (1 + d % 2), 2.0 * GIB
        sel = LabelSelector.of({"app": f"{tag}{d}"})
        tsc = ([TopologySpreadConstraint(1, RL.ZONE, "DoNotSchedule", sel)]
               if d < spread_deps else [])
        for i in range(n_per):
            pods.append(PodSpec(
                name=f"{tag}{d}-{i}", labels={"app": f"{tag}{d}"},
                requests={"cpu": cpu, "memory": mem},
                topology_spread=list(tsc), owner_key=f"{tag}{d}"))
    return pods


def optimal_pods():
    """One shape exactly filling its density-best candidate."""
    return [PodSpec(name=f"u-{i}", labels={"app": "u"},
                    requests={"cpu": 1.0, "memory": 1.0 * GIB},
                    owner_key="u") for i in range(64)]


@pytest.fixture(scope="module")
def catalogs():
    ref_full = ref_catalog(full=True)
    return {
        "full": (ref_full, generate_catalog(full=True)),
        "small": (ref_catalog(full=False), generate_catalog(full=False)),
        "one_type": ([ref_full[0]], [generate_catalog(full=True)[0]]),
    }


def ref_provs():
    return [RefProv(name="default").with_defaults()]


def port_provs():
    return [Provisioner(name="default").with_defaults()]


def plan(result):
    return sorted(
        (n.instance_type, n.zone, n.capacity_type, round(n.price, 6),
         tuple(sorted(p.name for p in n.pods)))
        for n in result.nodes)


def names_from(start: int = 1000) -> None:
    """Restart both packages' node-name counters at one value: coalescing
    orders candidates by ``(size, name)``, so a compared pair of solves
    must start from one counter state (a counter crossing a digit boundary
    mid-solve reorders names as strings)."""
    import karpenter_tpu.solver.types as ref_types
    from karpenter_tpu_torch.solver import types as port_types

    for mod in (ref_types, port_types):
        with mod._node_lock:
            mod._node_next = start


def placements_tie(a, b):
    return (set(a.assignments) == set(b.assignments)
            and set(a.infeasible) == set(b.infeasible)
            and np.float32(sum(n.price for n in a.nodes)).tobytes()
            == np.float32(sum(n.price for n in b.nodes)).tobytes())


def _array_fields(st):
    return {f.name: getattr(st, f.name) for f in dataclasses.fields(st)
            if isinstance(getattr(st, f.name), np.ndarray)}


def scans(ref_pods, catalog_pair):
    """Both packages' flat scans of one batch; the port's runs on the
    reference's tensors carried in."""
    rcat, pcat = catalog_pair
    st_ref = ref_tensorize(ref_pods, ref_provs(), rcat)
    names_from()
    res_ref = RefTpuSolver().solve(st_ref, track_assignments=True).result
    port_pods = to_port(ref_pods)
    st = tensors_from_reference(
        _array_fields(st_ref),
        like=tensorize(port_pods, port_provs(), pcat))
    names_from()
    res = TpuSolver(device="cpu").solve(st, track_assignments=True).result
    assert plan(res) == plan(res_ref) or placements_tie(res, res_ref)
    return st_ref, res_ref, st, res, port_pods


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_per,n_dep,spread", [(250, 20, 0), (250, 20, 2),
                                                (60, 6, 0)])
def test_program_matches_reference(catalogs, n_per, n_dep, spread):
    _st_ref, _res_ref, st, res, _pods = scans(
        mix_pods(n_per, n_dep, spread), catalogs["full"])
    elig, freed, lifted, seats = relax.eligible_partition(st, res)
    assert elig and freed
    inputs = relax.relax_inputs(st, res, lifted, seats, freed,
                                relax._host_feasibility(st))
    dims = relax.relax_dims(st)
    assert inputs[0].shape == (dims["G"], dims["R"])
    assert inputs[2].shape == (dims["G"], dims["C"])
    bx_r, bf_r = ref_relax.relax_jit(*inputs, relax_iters=64)
    bx_r, bf_r = np.asarray(bx_r), float(np.asarray(bf_r))
    before = relax.RELAX_PROGRAM.get("cpu")
    bx, bf = relax._run_relax(*inputs, 64, "cpu")
    assert relax.RELAX_PROGRAM.get("cpu") == before + 1
    np.testing.assert_allclose(bf, bf_r, rtol=1e-5)
    np.testing.assert_allclose(bx, bx_r, rtol=1e-4, atol=1e-3)
    # within the tolerance because it is the same float32 arithmetic
    assert bx.tobytes() == bx_r.tobytes() and np.float32(bf) == bf_r


def test_program_step_pieces_match_reference_arithmetic():
    """The float32 pieces the program reproduces, on numpy-made inputs:
    exp against XLA's (subnormal results flushed), the windowed sum
    against ``jnp.sum`` at every candidate rung width, and the fused
    multiply-add chain against a float32 ``jnp.dot``."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-90, 1, 200_000),
                        rng.uniform(-1, 0, 50_000)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = relax._exp(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()
    for n in (64, 448, 512, 768, 1152, 1728):
        a = (rng.random((4, n)) * rng.uniform(0, 1e3, (4, n))).astype(
            np.float32)
        want = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=1))(a))
        assert relax._window_sum(torch.from_numpy(a)).numpy().tobytes() \
            == want.tobytes(), n
    a = (rng.random((32, 448)) * 100).astype(np.float32)
    b = np.array([[0.3, 6 * GIB, 0.0, 1.0]] * 32, dtype=np.float32)
    b *= rng.random((32, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, q: p.T @ q)(a, b))
    got = relax._fma_chain(torch.from_numpy(a).double()[:, :, None]
                           * torch.from_numpy(b).double()[:, None, :])
    assert got.numpy().tobytes() == want.tobytes()


def test_step_table_is_the_reference_programs():
    """The 256 step sizes equal ``mirror_eta(t)`` as the reference's jitted
    scan evaluates it, each within one ulp of the correctly rounded
    float32 of 1/sqrt(1 + t/8)."""
    import jax
    import jax.numpy as jnp

    def body(c, t):
        return c, ref_relax.mirror_eta(t.astype(jnp.float32))

    _c, want = jax.jit(lambda: jax.lax.scan(
        body, 0, jnp.arange(256, dtype=jnp.int32)))()
    table = np.array(relax._ETA_TABLE, dtype=np.float32)
    assert table.tobytes() == np.asarray(want).tobytes()
    exact = (1.0 / np.sqrt(1.0 + np.arange(256) / 8.0)).astype(np.float32)
    ulps = np.abs(table.view(np.int32) - exact.view(np.int32))
    assert ulps.max() <= 1


def test_program_raises_past_the_step_table():
    z = torch.zeros
    with pytest.raises(ValueError):
        relax._relax_program(z(16, 4), z(16), z(16, 64, dtype=torch.bool),
                             z(64, 4), z(64), z(16, 64), 257)


# ---------------------------------------------------------------------------
# the host rounding, fed the reference's best_x
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_per,n_dep,spread", [(250, 20, 0), (250, 20, 6),
                                                (60, 6, 0)])
def test_rounding_matches_reference_on_its_best_x(catalogs, monkeypatch,
                                                  n_per, n_dep, spread):
    st_ref, res_ref, st, res, port_pods = scans(
        mix_pods(n_per, n_dep, spread), catalogs["full"])
    seen = []

    def ref_program(req, counts, feas, alloc_inv, price, x0, iters,
                    device):
        seen.append(iters)
        bx, bf = ref_relax.relax_jit(req, counts, feas, alloc_inv, price,
                                     x0, relax_iters=iters)
        return np.asarray(bx), float(np.asarray(bf))

    monkeypatch.setattr(relax, "_run_relax", ref_program)
    out_ref, outcome_ref = ref_relax.refine(res_ref, st_ref,
                                            registry=RefRegistry())
    out, outcome = relax.refine(res, st, registry=Registry(), device="cpu")
    assert outcome == outcome_ref
    assert seen == [64]
    assert plan(out) == plan(out_ref)
    assert out.assignments == out_ref.assignments or (
        placements_tie(out, out_ref))
    assert not validate_solution(mix_pods(n_per, n_dep, spread),
                                 ref_provs(), out_ref, catalogs["full"][0])


# ---------------------------------------------------------------------------
# refine on the scan (the reference's never-worse fixtures)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["all_constrained", "single_type",
                                  "already_optimal", "mixed_spread"])
def test_refine_matches_reference(catalogs, case):
    pods, cat = {
        "all_constrained": (mix_pods(30, 6, 6), "full"),
        "single_type": (mix_pods(30), "one_type"),
        "already_optimal": (optimal_pods(), "small"),
        "mixed_spread": (mix_pods(40, 6, 2), "full"),
    }[case]
    st_ref, res_ref, st, res, port_pods = scans(pods, catalogs[cat])
    cost0 = res.new_node_cost
    out_ref, outcome_ref = ref_relax.refine(res_ref, st_ref,
                                            registry=RefRegistry())
    out, outcome = relax.refine(res, st, registry=Registry(), device="cpu")
    assert outcome == outcome_ref
    assert plan(out) == plan(out_ref) or placements_tie(out, out_ref)
    assert out.new_node_cost <= cost0 + 1e-9
    if case == "all_constrained":
        assert outcome == "skipped"


# ---------------------------------------------------------------------------
# end to end: the schedulers at their default relax
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def warm_ref():
    """The reference's scheduler with every program compiled before it
    serves: inline compiles (``compile_behind=False``), so no solve — the
    rung's repair solve included — is served by a cold host tier while a
    program compiles, and the relax program warmed explicitly."""
    reg = RefRegistry()
    sched = RefScheduler(backend="tpu", registry=reg, compile_behind=False)
    return sched, reg


def _outcomes(reg, total):
    return {o: reg.counter(total).get({"outcome": o})
            for o in RELAX_OUTCOMES}


def _ref_solve_warm(sched, reg, pods, catalog):
    """The reference's solve once its relax program has compiled (it skips
    the rung while the program is cold).  Returns the result and the
    outcomes the solve counted."""
    st, _ = sched._tensorize(pods, ref_provs(), catalog, (), None)
    ref_relax.warm_relax(sched._tpu, st)
    t0 = time.time()
    while not sched._tpu.warm_idle() and time.time() - t0 < 300:
        time.sleep(0.05)
    assert sched._tpu.ready(ref_relax.relax_signature(st))
    before = _outcomes(reg, REF_RELAX_TOTAL)
    names_from()
    res = sched.solve(pods, ref_provs(), catalog)
    after = _outcomes(reg, REF_RELAX_TOTAL)
    return res, {o: after[o] - before[o] for o in RELAX_OUTCOMES}


#: end-to-end batches: (pods, catalog) — the reference's test_relax.py
#: shapes; those of at most 256 pods skip the rung in both packages
E2E_CASES = {
    "mix_250x20": (lambda: mix_pods(250, 20), "full"),
    "mix_250x20_spread2": (lambda: mix_pods(250, 20, 2), "full"),
    "mix_250x20_spread6": (lambda: mix_pods(250, 20, 6), "full"),
    "mix_40x6": (lambda: mix_pods(40, 6), "full"),
    "mix_30x6_spread6": (lambda: mix_pods(30, 6, 6), "full"),
    "single_type_30x6": (lambda: mix_pods(30), "one_type"),
    "already_optimal": (optimal_pods, "small"),
}


@pytest.mark.parametrize("case", sorted(E2E_CASES))
def test_default_solve_matches_warmed_reference(catalogs, warm_ref, case):
    build_pods, cat = E2E_CASES[case]
    rcat, pcat = catalogs[cat]
    ref_pods = build_pods()
    ref_res, ref_counted = _ref_solve_warm(*warm_ref, ref_pods, rcat)
    reg = Registry()
    port = BatchScheduler(backend="tpu", device="cpu", registry=reg)
    names_from()
    res = port.solve(to_port(ref_pods), port_provs(), pcat)
    assert _outcomes(reg, RELAX_TOTAL) == ref_counted
    assert sum(ref_counted.values()) == (0 if len(ref_pods) <= 256 else 1)
    if case == "mix_250x20":
        assert ref_counted["improved"] == 1
    assert plan(res) == plan(ref_res) or placements_tie(res, ref_res)
    assert res.new_node_cost == ref_res.new_node_cost
    assert set(res.assignments) == set(ref_res.assignments)
    assert not validate_solution(ref_pods, ref_provs(), ref_res, rcat)
    if ref_counted.get("improved"):
        assert reg.gauge(RELAX_IMPROVEMENT).get() < 1.0
        assert reg.histogram(RELAX_DURATION).count() == 1


# ---------------------------------------------------------------------------
# skip policy and outcome counting
# ---------------------------------------------------------------------------


@pytest.fixture()
def refine_calls(monkeypatch):
    calls = []
    real = relax.refine
    monkeypatch.setattr(relax, "refine",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_small_batch_skips(catalogs, refine_calls):
    sched = BatchScheduler(backend="tpu", device="cpu", registry=Registry())
    sched.solve(to_port(mix_pods(10)), port_provs(), catalogs["small"][1])
    assert not refine_calls


def test_budgeted_and_forced_off_solves_skip(catalogs, refine_calls):
    pods = to_port(mix_pods(60))
    pcat = catalogs["full"][1]
    sched = BatchScheduler(backend="tpu", device="cpu", registry=Registry())
    sched.solve(pods, port_provs(), pcat, max_new_nodes=1000)
    sched.solve(pods, port_provs(), pcat, relax=False)
    assert not refine_calls
    sched.solve(pods, port_provs(), pcat)
    assert refine_calls == [1]


def test_kt_relax_off_is_byte_parity_with_the_scan(catalogs, monkeypatch,
                                                   refine_calls):
    pods = to_port(mix_pods(250, 20))
    pcat = catalogs["full"][1]
    sched = BatchScheduler(backend="tpu", device="cpu", registry=Registry())
    scan = sched.solve(pods, port_provs(), pcat, relax=False)
    monkeypatch.setenv("KT_RELAX", "0")
    off = sched.solve(pods, port_provs(), pcat)
    assert not refine_calls
    assert plan(off) == plan(scan) and off.assignments.keys() \
        == scan.assignments.keys()
    monkeypatch.delenv("KT_RELAX")
    on = sched.solve(pods, port_provs(), pcat)
    assert refine_calls == [1]
    assert on.new_node_cost < off.new_node_cost - 1e-9
    assert not validate_solution(mix_pods(250, 20), ref_provs(), on,
                                 catalogs["full"][0])


def test_tensorize_cache_off_skips_uncounted(catalogs, monkeypatch,
                                             refine_calls):
    monkeypatch.setenv("KT_TENSORIZE_CACHE", "0")
    reg = Registry()
    sched = BatchScheduler(backend="tpu", device="cpu", registry=reg)
    sched.solve(to_port(mix_pods(60)), port_provs(), catalogs["full"][1])
    assert not refine_calls
    assert sum(_outcomes(reg, RELAX_TOTAL).values()) == 0


def test_zero_init_and_one_count_per_evaluation(catalogs):
    reg = Registry()
    BatchScheduler(backend="oracle", device="cpu", registry=reg)
    for outcome in RELAX_OUTCOMES:
        assert reg.counter(RELAX_TOTAL).has({"outcome": outcome})
    assert reg.gauge(RELAX_IMPROVEMENT).get() == 1.0
    _st_ref, _res_ref, st, res, _pods = scans(mix_pods(30, 6, 6),
                                              catalogs["full"])
    relax.refine(res, st, registry=reg, device="cpu")
    assert sum(_outcomes(reg, RELAX_TOTAL).values()) == 1.0
    assert reg.counter(RELAX_TOTAL).get({"outcome": "skipped"}) == 1.0
    assert reg.histogram(RELAX_DURATION).count() == 1


def test_program_failure_ships_the_scan_as_fallback(catalogs, monkeypatch):
    _st_ref, _res_ref, st, res, _pods = scans(mix_pods(60), catalogs["full"])
    nodes0 = plan(res)

    def broken(*a, **k):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(relax, "_run_relax", broken)
    reg = Registry()
    out, outcome = relax.refine(res, st, registry=reg, device="cpu")
    assert outcome == "fallback" and plan(out) == nodes0
    assert reg.counter(RELAX_TOTAL).get({"outcome": "fallback"}) == 1.0


def test_refine_default_device_raises_without_cuda(catalogs, monkeypatch):
    _st_ref, _res_ref, st, res, _pods = scans(mix_pods(60), catalogs["full"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        relax.refine(res, st, registry=Registry())


def test_iter_rungs_and_knob():
    assert relax.iter_rung(1) == relax.RELAX_ITER_RUNGS[0]
    assert relax.iter_rung(65) == 128
    assert relax.iter_rung(10_000) == relax.RELAX_ITER_RUNGS[-1]
    assert relax.configured_iters() == ref_relax.DEFAULT_RELAX_ITERS == 64
    assert relax.RELAX_ITER_RUNGS == ref_relax.RELAX_ITER_RUNGS
    assert len(relax._ETA_TABLE) >= relax.RELAX_ITER_RUNGS[-1]
