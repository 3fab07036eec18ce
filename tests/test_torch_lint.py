"""The port's ktlint (``karpenter_tpu_torch/analysis``) against the
reference's, on the CPU.

Four surfaces:

1. **Carried-over rules** — every fixture of the reference's
   ``tests/test_lint.py`` whose rule carries over unchanged (KT002-KT005,
   KT007, KT009, KT010, KT012, KT015-KT017, KT019-KT025 and the
   suppression grammar) runs through both analyzers with the path prefix
   swapped (``karpenter_tpu`` -> ``karpenter_tpu_torch``, in paths and
   sources).  One case per reference test method: each rule call its body
   makes is recorded and replayed through both packages, which must give
   the same ``(rule, line)`` sets, active and suppressed.
2. **Port-idiom rules** — KT001, KT006, KT008, KT011, KT013, KT014 and
   KT018 speak the port's vocabulary (``.item()`` / ``.cpu()`` /
   ``torch.cuda.synchronize()``, ``torch.compile`` and per-call CUDA
   graphs, the port's ``Mesh`` factories, ``read_slot_rows``): torch
   fixtures that fire and fixtures that stay quiet.
3. **The package gate** — 0 active findings over the port, every
   suppression with a reason; every KT013 entry point and KT014 anchor
   resolves in the real tree; the KT012 edges agree with the sanitizer's
   ``LOCK_ORDER``; the port's golden descriptor is the reference's.
4. **The CLI** — ``--format json``, ``--select``, ``--lock-order``,
   ``--proto-golden`` and the summary cache (its own file, never the
   reference analyzer's).

Every lint run here uses an in-memory cache or a ``tmp_path`` one; no
test asserts on wall-clock time.

Tolerance: equal.
"""

import ast
import importlib.util
import json
import re
import textwrap
from pathlib import Path

import pytest
import torch

from karpenter_tpu.analysis import ktlint as ref_ktlint
from karpenter_tpu.analysis.rules import ALL_RULES as REF_RULES
from karpenter_tpu_torch.analysis import ktlint
from karpenter_tpu_torch.analysis.callgraph import (
    Project,
    SummaryCache,
    build_project,
)
from karpenter_tpu_torch.analysis.ktlint import (
    analyze_files,
    analyze_package,
    collect_package_files,
    load_source,
    main,
)
from karpenter_tpu_torch.analysis.rules import ALL_RULES

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_RULES = {r.ID: r for r in ALL_RULES}
REF_BY_ID = {r.ID: r for r in REF_RULES}


@pytest.fixture(autouse=True)
def _no_lint_cache(monkeypatch):
    monkeypatch.setenv("KT_LINT_CACHE", "0")


def swap(text: str) -> str:
    return re.sub(r"\bkarpenter_tpu\b", "karpenter_tpu_torch", text)


# ---------------------------------------------------------------------------
# 1. the reference's fixtures through both analyzers
# ---------------------------------------------------------------------------

#: the reference test classes whose rules carry over unchanged
CARRIED = (
    "TestKT002RawClock", "TestKT003MetricZeroInit", "TestKT004LockDiscipline",
    "TestKT005BroadExcept", "TestKT007SpanLifecycle",
    "TestKT009UncountedShed", "TestKT010LoopOfDispatch",
    "TestKT012LockOrder", "TestKT015DeltaSessionDiscipline",
    "TestKT016FaultPlaneDiscipline", "TestKT017SpoolFacadeDiscipline",
    "TestKT019WireTraceContext", "TestKT020HierarchicalPath",
    "TestKT021WireCompat", "TestKT022KnobDrift",
    "TestKT023InventoryDrift", "TestKT024KnobEnvBypass",
    "TestKT025GangIdentityAccess", "TestSuppressionGrammar",
)
#: a rule call over more files than this is a package run, not a fixture
MAX_FIXTURE_FILES = 20


def _record_reference_fixtures():
    """Run every self-only test method of :data:`CARRIED` from a private
    copy of the reference's tests/test_lint.py, with each reference rule's
    ``check`` wrapped to record its inputs; returns
    ``{case_id: [(rule_id, [(path, text)], kwargs)]}``."""
    spec = importlib.util.spec_from_file_location(
        "_reference_test_lint", ROOT / "tests" / "test_lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls: list = []
    originals = {}
    for rule in REF_RULES:
        originals[rule] = rule.check

        def recorder(files, *args, _rule=rule, **kwargs):
            kw = {k: v for k, v in kwargs.items() if k != "project"}
            calls.append((_rule.ID, [(f.path, f.text) for f in files], kw))
            return originals[_rule](files, *args, **kwargs)

        rule.check = recorder
    cases = {}
    try:
        tree = ast.parse((ROOT / "tests" / "test_lint.py").read_text())
        for cls in tree.body:
            if not (isinstance(cls, ast.ClassDef) and cls.name in CARRIED):
                continue
            for fn in cls.body:
                if not (isinstance(fn, ast.FunctionDef)
                        and fn.name.startswith("test_")
                        and [a.arg for a in fn.args.args] == ["self"]):
                    continue
                del calls[:]
                try:
                    getattr(getattr(mod, cls.name)(), fn.name)()
                except Exception:  # noqa: BLE001 — the replay decides
                    pass
                got = [c for c in calls if len(c[1]) <= MAX_FIXTURE_FILES
                       and (c[1] or c[2])]
                if got and len(got) == len(calls):
                    cases[f"{cls.name}.{fn.name}"] = list(got)
    finally:
        for rule, fn in originals.items():
            rule.check = fn
    return cases


FIXTURES = _record_reference_fixtures()


def _lines(findings):
    return sorted((f.rule, f.line) for f in findings)


def _replay(kt, rules, rule_id, pairs, kwargs, swapped):
    rule = rules[rule_id]
    files = [kt.load_source(swap(t) if swapped else t,
                            swap(p) if swapped else p)
             for p, t in pairs]
    if kwargs:
        return {"check": _lines(rule.check(files, **kwargs))}
    active, suppressed = kt.analyze_files(files, rules=[rule])
    return {"active": _lines(active), "suppressed": _lines(suppressed)}


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_reference_fixture_gives_the_same_findings(case):
    for rule_id, pairs, kwargs in FIXTURES[case]:
        ref = _replay(ref_ktlint, REF_BY_ID, rule_id, pairs, kwargs, False)
        port = _replay(ktlint, PORT_RULES, rule_id, pairs, kwargs, True)
        assert port == ref, (rule_id, pairs)


def test_every_carried_rule_has_recorded_fixtures():
    rules = {rule_id for calls in FIXTURES.values()
             for rule_id, _p, _k in calls}
    assert {"KT002", "KT003", "KT004", "KT005", "KT007", "KT009", "KT010",
            "KT012", "KT015", "KT016", "KT017", "KT019", "KT020", "KT021",
            "KT022", "KT023", "KT024", "KT025"} <= rules
    assert len(FIXTURES) >= 100


# ---------------------------------------------------------------------------
# 2. the port-idiom rules: torch fixtures
# ---------------------------------------------------------------------------

TPU = "karpenter_tpu_torch/solver/tpu.py"

#: rule -> {case: (files, expected rule ids, in order)}
IDIOM = {
    "KT001": {
        "item_on_device_tensor": ([(TPU, """
            import torch

            def hot(n, dev):
                t = torch.zeros(n, device=dev)
                return t.sum().item()
            """)], ["KT001"]),
        "cpu_on_uploaded_tensor": ([(TPU, """
            import numpy as np
            import torch

            def hot(a, dev):
                t = torch.from_numpy(a).to(dev)
                return t.cpu().numpy()
            """)], ["KT001"]),
        "float_of_a_kernel_result": ([(TPU, """
            def hot(f, price):
                best = packed_scan_scores(f, price)
                return float(best[0].min())
            """)], ["KT001"]),
        "asarray_of_the_scan": ([(TPU, """
            import numpy as np

            def hot(consts, init):
                carry, ys = _run_scan(consts, init, 1, 1, True, {})
                return np.asarray(carry[7])
            """)], ["KT001"]),
        "cuda_synchronize_always": ([(TPU, """
            import torch

            def hot():
                torch.cuda.synchronize()
            """)], ["KT001"]),
        "event_wait_and_elapsed": ([(TPU, """
            def hot(start, end):
                end.synchronize()
                return start.elapsed_time(end)
            """)], ["KT001", "KT001"]),
        "truth_test_of_device_any": ([(TPU, """
            def hot(t, dev):
                x = t.cuda()
                if x.any():
                    return 1
                return 0
            """)], ["KT001"]),
        "carry_param_tolist": ([(TPU, """
            def hot(carry):
                return carry[7].tolist()
            """)], ["KT001"]),
        "closure_carry_param": ([(TPU, """
            def _scan(n):
                def step(carry, g):
                    return int(carry[0])
                return step
            """)], ["KT001"]),
        "host_numpy_is_quiet": ([(TPU, """
            import numpy as np

            def estimate(st):
                counts = np.asarray(st.counts)
                return float(counts.sum())
            """)], []),
        "dtype_move_and_metadata_are_quiet": ([(TPU, """
            import torch

            def host(a, dev):
                h = torch.from_numpy(a).to(torch.float32)
                t = torch.zeros(4, device=dev)
                return float(h.sum()), int(t.shape[0]), t.numel()
            """)], []),
        "cpu_constructor_is_quiet": ([(TPU, """
            import torch

            def host(n):
                t = torch.zeros(n, device="cpu")
                return t.sum().item()
            """)], []),
        "fence_annotation_allows": ([(TPU, """
            # ktlint: fence the one device-to-host read of a dispatch
            def _read_back(self, carry, ys):
                return [x.cpu().numpy() for x in carry]
            """)], []),
        "cold_files_are_not_scanned": ([(
            "karpenter_tpu_torch/solver/guard.py", """
            import torch

            def probe(dev):
                torch.zeros(4, device=dev).sum().item()
            """)], []),
    },
    "KT006": {
        "double_in_the_relax_program": ([(
            "karpenter_tpu_torch/solver/relax.py", """
            def _relax_program(req, counts):
                return req.double() * counts
            """)], ["KT006"]),
        "float64_in_a_program_helper": ([(
            "karpenter_tpu_torch/solver/relax.py", """
            import torch

            def _acc(x):
                return x.to(torch.float64)

            def _relax_program(req, counts):
                return _acc(req)
            """)], ["KT006"]),
        "global_generator_in_the_scan": ([(TPU, """
            import torch

            def _run_scan(consts, init):
                return torch.rand(4)
            """)], ["KT006"]),
        "host_random_in_a_kernel_file": ([(
            "karpenter_tpu_torch/ops/masks.py", """
            import random

            def water_fill(x):
                return x * random.random()
            """)], ["KT006"]),
        "host_code_is_out_of_scope": ([(
            "karpenter_tpu_torch/solver/relax.py", """
            import numpy as np

            def _host_feasibility(st):
                return np.zeros(3, dtype=np.float64)
            """)], []),
        "seeded_generator_is_quiet": ([(TPU, """
            import torch

            def _run_scan(consts, init, gen):
                return torch.rand(4, generator=gen)
            """)], []),
        "annotated_exact_arithmetic_is_quiet": ([(
            "karpenter_tpu_torch/solver/relax.py", """
            def _relax_program(req, counts):
                # ktlint: allow[KT006] exact float64 products, one rounding
                return req.double() * counts
            """)], []),
    },
    "KT008": {
        "torch_compile_on_the_serving_path": ([(
            "karpenter_tpu_torch/solver/x.py", """
            import torch

            def step(x):
                return x + 1

            fast_step = torch.compile(step)
            """)], ["KT008"]),
        "jit_script_decorator": ([(
            "karpenter_tpu_torch/ops/x.py", """
            import torch

            @torch.jit.script
            def step(x):
                return x + 1
            """)], ["KT008"]),
        "per_call_graph_capture": ([(
            "karpenter_tpu_torch/solver/x.py", """
            import torch

            def replay(fn, x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    fn(x)
                g.replay()
            """)], ["KT008", "KT008"]),
        "memoized_capture_is_quiet": ([(
            "karpenter_tpu_torch/solver/x.py", """
            import functools

            import torch

            @functools.lru_cache(maxsize=64)
            def graph_for(sig):
                return torch.cuda.CUDAGraph()
            """)], []),
        "off_path_files_are_out_of_scope": ([(
            "karpenter_tpu_torch/profile_wave.py", """
            import torch

            fast = torch.compile(lambda x: x)
            """)], []),
    },
    "KT011": {
        "make_mesh_inside_a_serving_function": ([(
            "karpenter_tpu_torch/service/x.py", """
            from ..parallel.mesh import make_mesh

            def flush(batch):
                return make_mesh()
            """)], ["KT011"]),
        "slot_sharding_per_flush": ([(
            "karpenter_tpu_torch/solver/x.py", """
            from ..parallel.mesh import slot_sharding

            def dispatch(mesh, padded):
                return slot_sharding(mesh).shard_indices((len(padded),))
            """)], ["KT011"]),
        "batcher_is_in_scope": ([(
            "karpenter_tpu_torch/batcher.py", """
            from .parallel.mesh import Mesh, replicate

            def flush(devices, x):
                return replicate(Mesh(devices, ("pods", "types")), x)
            """)], ["KT011", "KT011"]),
        "module_level_layout_is_quiet": ([(
            "karpenter_tpu_torch/solver/x.py", """
            from ..parallel.mesh import make_mesh

            MESH = make_mesh(devices=["cpu"] * 2)
            """)], []),
        "parallel_package_is_the_home": ([(
            "karpenter_tpu_torch/parallel/x.py", """
            from .mesh import axis_sharding

            def layout(mesh):
                return axis_sharding(mesh, "pods")
            """)], []),
    },
    "KT018": {
        "cpu_of_the_stacked_carry": ([(TPU, """
            def results(self):
                return [x.cpu() for x in self.carry_b]
            """)], ["KT018"]),
        "asarray_of_stacked_ys": ([(
            "karpenter_tpu_torch/service/server.py", """
            import numpy as np

            def finalize(pending):
                return np.asarray(pending.ys_b)
            """)], ["KT018"]),
        "tolist_of_a_stacked_slice": ([(TPU, """
            def peek(carry_b):
                return carry_b[7].tolist()
            """)], ["KT018"]),
        "the_accessor_is_the_home": ([(TPU, """
            def read_slot_rows(arrays):
                return [a.cpu().numpy() for a in arrays]

            def results(self):
                return read_slot_rows(list(self.carry_b))
            """)], []),
        "single_solve_carry_is_out_of_scope": ([(TPU, """
            def result(carry):
                return [x.cpu() for x in carry]
            """)], []),
    },
}

SERVER = "karpenter_tpu_torch/service/server.py"
IDIOM["KT013"] = {
    "reachable_read_fires_with_its_chain": ([(SERVER, """
        from ..solver.tpu import run_solve

        class SolverService:
            def Solve(self, req, ctx):
                return run_solve(req)
        """), (TPU, """
        import torch

        def run_solve(req):
            t = torch.ones(4, device="cuda")
            return t.cpu()
        """)], ["KT001", "KT013"]),
    "fence_on_the_path_absorbs": ([(SERVER, """
        from ..solver.tpu import run_solve

        class SolverService:
            def Solve(self, req, ctx):
                return run_solve(req)
        """), (TPU, """
        import torch

        # ktlint: fence the one read of the solve
        def run_solve(req):
            t = torch.ones(4, device="cuda")
            return t.cpu()
        """)], []),
    "callable_handed_to_a_guard_is_followed": ([(SERVER, """
        from ..solver.tpu import Guard, run_solve

        class SolverService:
            def __init__(self):
                self.guard = Guard()

            def Solve(self, req, ctx):
                return self.guard.run(run_solve, req)
        """), (TPU, """
        import torch

        class Guard:
            def run(self, fn, *args):
                return fn(*args)

        def run_solve(req):
            torch.cuda.synchronize()
        """)], ["KT001", "KT013"]),
    "local_closure_is_followed": ([(SERVER, """
        import torch

        class SolverService:
            def Solve(self, req, ctx):
                def _call():
                    return torch.zeros(2, device="cuda").item()
                return _call()
        """)], ["KT013"]),
    "host_work_is_quiet": ([(SERVER, """
        import numpy as np

        class SolverService:
            def Solve(self, req, ctx):
                return float(np.asarray(req.counts).sum())
        """)], []),
}

TPU_OK = (TPU, """
    MEGA_MAX_SLOTS = 32

    def solve_dims(st):
        return dict(G=1, C=1, NR=1, NE_pad=1, S=1, P=1, D=1, R=1,
                    Z=1, K=1, W=1, track=True, a=1, b=1)

    def _mega_rung(n, n_dev=1):
        return n

    def _mega_key_tail(slots, zone_key, ct_key, mesh):
        tail = (("mega_slots", slots), ("zk", zone_key), ("ck", ct_key))
        if mesh is not None:
            from ..parallel.mesh import mesh_signature
            tail += (("mesh", mesh_signature(mesh)),)
        return tail

    def mega_signature(st):
        return _mega_key_tail(2, 0, 1, None)

    def _dispatch_prepared(st):
        return _mega_key_tail(2, 0, 1, None)
    """)
SCHED_OK = ("karpenter_tpu_torch/solver/scheduler.py", """
    from .tpu import MEGA_MAX_SLOTS

    class BatchScheduler:
        WARM_MEGA_SLOTS = (2, 4, 8)

        def warm_startup(self):
            return 0

        def precompile_buckets(self, mega_slots=None):
            self.warm_startup()
            return [s for s in (mega_slots or self.WARM_MEGA_SLOTS)
                    if 2 <= s <= MEGA_MAX_SLOTS]
    """)
SERVER_OK = (SERVER, """
    DEFAULT_MAX_SLOTS = 8

    def main(service):
        return service.scheduler.precompile_buckets(
            mega_slots=(2, 4, 8), wait=True)
    """)
SWEEP_OK = ("karpenter_tpu_torch/solver/consolidation.py", """
    def sweep_dims(st, NE, node_budget):
        from .tpu import solve_dims
        dims = solve_dims(st)
        dims["G"] = 4
        return dims
    """)
MESH_OK = ("karpenter_tpu_torch/parallel/mesh.py", """
    def mesh_signature(mesh):
        return ()
    """)
SURFACE = [TPU_OK, SCHED_OK, SERVER_OK, SWEEP_OK, MESH_OK]


def _with(files, path, old, new):
    out = []
    for p, src in files:
        if p == path:
            assert old in src, old
            src = src.replace(old, new)
        out.append((p, src))
    return out


IDIOM["KT014"] = {
    "consistent_surface_is_quiet": (SURFACE, []),
    "raised_default_cap_without_warm_rungs": (_with(
        SURFACE, SERVER, "DEFAULT_MAX_SLOTS = 8", "DEFAULT_MAX_SLOTS = 16"),
        ["KT014"]),
    "unregistered_dims_key": (_with(
        SURFACE, TPU, "track=True, a=1, b=1",
        "track=True, a=1, b=1, batch_hint=1"), ["KT014"]),
    "tail_without_the_mesh_fingerprint": (_with(
        SURFACE, TPU, 'tail += (("mesh", mesh_signature(mesh)),)',
        'tail += (("mesh", repr(mesh)),)'), ["KT014"]),
    "precompile_bypassing_warm_startup": (_with(
        SURFACE, "karpenter_tpu_torch/solver/scheduler.py",
        "            self.warm_startup()\n", ""), ["KT014"]),
    "hand_rolled_key_tail": ([*SURFACE, (
        "karpenter_tpu_torch/service/x.py", """
        def rogue(slots):
            return (("mega_slots", slots),)
        """)], ["KT014"]),
    "sweep_dims_inventing_a_key": (_with(
        SURFACE, "karpenter_tpu_torch/solver/consolidation.py",
        'dims["G"] = 4', 'dims["Q"] = 4'), ["KT014"]),
    "blocking_warmup_without_a_grid": (_with(
        SURFACE, SERVER, "mega_slots=(2, 4, 8), wait=True", "wait=True"),
        ["KT014"]),
    "moved_anchor_fires_when_siblings_remain": (_with(
        SURFACE, TPU, "def _mega_rung(", "def _mega_rung_renamed("),
        ["KT014"]),
    "fixture_without_anchors_is_quiet": ([(TPU, """
        def hot_path(x):
            return x
        """)], []),
}

IDIOM_CASES = sorted((rule, case) for rule in IDIOM for case in IDIOM[rule])


def lint_files(pairs, rules):
    files = [load_source(textwrap.dedent(src), path) for path, src in pairs]
    active, _ = analyze_files(files, rules=rules)
    return active


@pytest.mark.parametrize("rule,case", IDIOM_CASES)
def test_port_idiom_rule(rule, case):
    pairs, want = IDIOM[rule][case]
    rules = [PORT_RULES[rule]]
    if rule == "KT013":
        rules = [PORT_RULES["KT001"], PORT_RULES["KT013"]]
    got = [f.rule for f in lint_files(pairs, rules)]
    assert sorted(got) == sorted(want), [
        f.format() for f in lint_files(pairs, rules)]


def test_kt013_chain_names_the_entry_and_the_callee():
    pairs, _ = IDIOM["KT013"]["callable_handed_to_a_guard_is_followed"]
    (f,) = lint_files(pairs, [PORT_RULES["KT013"]])
    assert "SolverService.Solve -> run_solve" in f.message
    assert "`.synchronize()`" in f.message


def test_kt014_mirror_matches_the_real_rung_ladder():
    from karpenter_tpu_torch.analysis.rules.kt014 import mega_rung
    from karpenter_tpu_torch.solver.tpu import MEGA_MAX_SLOTS, _mega_rung

    for n in range(1, MEGA_MAX_SLOTS + 1):
        for n_dev in range(1, MEGA_MAX_SLOTS + 1):
            assert mega_rung(n, n_dev, MEGA_MAX_SLOTS) == \
                _mega_rung(n, n_dev), (n, n_dev)


def test_kt014_registry_models_the_real_signature():
    from karpenter_tpu_torch.analysis.rules.kt014 import (
        SIGNATURE_KEYS,
        TAIL_KEYS,
    )
    from karpenter_tpu_torch.solver import tpu

    assert set(tpu._MEGA_TAIL_NAMES) == set(TAIL_KEYS)
    st = type("St", (), {})()
    st.G, st.C, st.S, st.D, st.R, st.n_zones = 3, 5, 0, 2, 4, 1
    st.prov_names = ["default"]
    st.pm = torch.zeros((3, 2, 1)).numpy()
    dims = tpu.solve_dims(st, NE=0, node_budget=8, full_nr=True)
    assert set(dims) == set(SIGNATURE_KEYS)


@pytest.mark.parametrize("rule_id", sorted(PORT_RULES))
def test_every_rule_has_a_firing_and_a_quiet_fixture(rule_id):
    """Each of the 25 rules is exercised here both ways: the port-idiom
    rules by the torch fixtures above, the carried-over ones by the
    reference fixtures run through the port's analyzer."""
    outcomes = set()
    if rule_id in IDIOM:
        outcomes = {bool(want) for _pairs, want in IDIOM[rule_id].values()}
    for calls in FIXTURES.values():
        for rid, pairs, kwargs in calls:
            if rid != rule_id:
                continue
            got = _replay(ktlint, PORT_RULES, rid, pairs, kwargs, True)
            outcomes.add(bool(got.get("check") or got.get("active")))
    assert outcomes == {True, False}, outcomes


def test_all_rules_are_the_reference_catalog():
    assert [r.ID for r in ALL_RULES] == [f"KT{i:03d}" for i in range(1, 26)]
    assert [r.__name__.rsplit(".", 1)[-1] for r in ALL_RULES] == \
        [r.__name__.rsplit(".", 1)[-1] for r in REF_RULES]
    for r in ALL_RULES:
        assert r.__name__.startswith("karpenter_tpu_torch.analysis.rules.")
        assert r.TITLE and r.HINT


# ---------------------------------------------------------------------------
# 3. the package gate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def package_run():
    files = collect_package_files()
    project = Project.build(files, cache=SummaryCache(path=None))
    active, suppressed = analyze_files(files, project=project)
    return files, project, active, suppressed


def test_package_has_zero_active_findings(package_run):
    files, _project, active, suppressed = package_run
    assert len(files) > 120
    assert ktlint.package_root() == ROOT / "karpenter_tpu_torch"
    assert all(f.path.startswith("karpenter_tpu_torch/") for f in files)
    assert active == [], "\n".join(f.format() for f in active)
    assert suppressed


def test_every_suppression_carries_a_reason(package_run):
    files, _project, _active, suppressed = package_run
    for f in files:
        assert f.malformed == [], (f.path, f.malformed)
        for line, rules in f.suppressions.items():
            assert all(reason.strip() for reason in rules.values()), (
                f.path, line)
    by_path = {f.path: f for f in files}
    for fi in suppressed:
        f = by_path[fi.path]
        line, reasons = fi.line, []
        while line >= 1:
            reasons += [r for rid, r in f.suppressions.get(line, {}).items()
                        if rid == fi.rule]
            if line != fi.line and not ktlint._comment_only(f.lines, line):
                break
            line -= 1
        assert reasons and all(r.strip() for r in reasons), fi.format()


def test_every_kt013_entry_point_resolves(package_run):
    from karpenter_tpu_torch.analysis.rules.kt013 import ENTRY_POINTS

    _files, project, _a, _s = package_run
    for suffix, qual in ENTRY_POINTS:
        assert project.find_function(suffix, qual) is not None, qual


def test_the_fences_are_the_ports_read_backs(package_run):
    _files, project, _a, _s = package_run
    fences = {n.summary.qual for n in project.funcs.values()
              if n.summary.fence}
    assert {"TpuSolver._read_back", "PendingTpuSolve.result",
            "PendingMegaSolve.results", "read_slot_rows",
            "device_probe.probe"} <= fences


def test_the_serving_path_reaches_the_device(package_run):
    """The call graph follows the dispatch into the solver: the serving
    entries reach ``TpuSolver.solve`` and the fence behind it."""
    from karpenter_tpu_torch.analysis.rules import kt013

    _files, project, _a, _s = package_run
    roots = [project.find_function(s, q) for s, q in kt013.ENTRY_POINTS]
    reached = {project.funcs[f].summary.qual
               for f in kt013._reachable(project, roots)}
    assert {"TpuSolver.solve", "TpuSolver.solve_async",
            "TpuSolver._extract", "BatchScheduler._solve_tpu"} <= reached


def test_kt014_package_surface_yields_every_anchor(package_run):
    from karpenter_tpu_torch.analysis.rules.kt014 import surface

    files = package_run[0]
    s = surface(files)
    assert s["solve_dims_keys"] == sorted(s["signature_keys"])
    assert s["mega_max_slots"] and s["warm_mega_slots"] \
        and s["default_max_slots"], s
    for floor, sides in s["mega_rungs_by_device_floor"].items():
        assert set(sides["runtime"]) <= set(sides["warmed"]), floor


def test_lock_edges_agree_with_the_sanitizer_table(package_run):
    from karpenter_tpu_torch.analysis.rules.kt012 import lock_graph
    from karpenter_tpu_torch.analysis.sanitize import LOCK_ORDER

    files, project, _a, _s = package_run
    _nodes, edges, _kinds = lock_graph(files, project)
    idx = {n: i for i, n in enumerate(LOCK_ORDER)}
    assert edges
    for (src, dst), edge in edges.items():
        if src == dst or src not in idx or dst not in idx:
            continue
        assert idx[src] < idx[dst], (
            f"static edge {src} -> {dst} contradicts LOCK_ORDER "
            f"({edge.witness()})")


def test_lock_order_names_the_ports_locks(package_run):
    from karpenter_tpu_torch.analysis.sanitize import LOCK_ORDER

    _files, project, _a, _s = package_run
    declared = {f"{cs.name}.{attr}" for cs in project.classes.values()
                for attr in cs.locks}
    assert [n for n in LOCK_ORDER if n not in declared] == []
    assert "BatchScheduler._mesh_serial_lock" in LOCK_ORDER


def test_golden_descriptor_is_the_references_and_the_proto_is_clean():
    from karpenter_tpu.analysis.rules import kt021 as ref_kt021
    from karpenter_tpu_torch.analysis.rules import kt021

    assert kt021.golden_path() == \
        ROOT / "karpenter_tpu_torch/analysis/solver_descriptor.golden.json"
    port = json.loads(kt021.golden_path().read_text())
    assert port == json.loads(ref_kt021.golden_path().read_text())
    live = kt021.parse_proto((ROOT / kt021.PROTO_PATH).read_text())
    assert kt021.snapshot(live) == port
    files = [load_source("x = 1\n", "karpenter_tpu_torch/service/x.py")]
    assert kt021.check(files) == []


def test_the_knob_table_is_the_ports_section(package_run):
    from karpenter_tpu_torch.analysis.rules import kt022

    readme = (ROOT / "README.md").read_text()
    knobs = {k for _, k in kt022.readme_knobs(readme)}
    start = readme.index(kt022.PORT_HEADING)
    first = min(i for i, _ in kt022.readme_knobs(readme))
    assert first > readme[:start].count("\n")
    assert {"KT_SANITIZE", "KT_LINT_CACHE", "KT_MAX_SLOTS"} <= knobs
    # the reference's table is not read: a knob only the reference reads
    assert "KT_PALLAS" not in knobs


def test_reference_analyzer_stays_clean_over_the_reference():
    from karpenter_tpu.analysis.callgraph import SummaryCache as RefCache

    active, _supp, n = ref_ktlint.analyze_package(cache=RefCache(None))
    assert n > 100
    assert active == [], "\n".join(f.format() for f in active)


# ---------------------------------------------------------------------------
# 4. the CLI and the cache
# ---------------------------------------------------------------------------


def test_cli_json_and_exit_codes(tmp_path, capsys):
    bad = tmp_path / "karpenter_tpu_torch" / "bad.py"
    bad.parent.mkdir()
    bad.write_text("import time\n\ndef f():\n    return time.time()\n")
    assert main([str(bad), "--format", "json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["files"] == 1
    assert [f["rule"] for f in out["findings"]] == ["KT002"]
    good = tmp_path / "karpenter_tpu_torch" / "good.py"
    good.write_text("def f():\n    return 1\n")
    assert main([str(good), "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["findings"] == []


def test_cli_select_filters_rules(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\n\ndef f():\n    return time.time()\n")
    assert main([str(bad), "--select", "KT005"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--select", "KT999"])


def test_cli_lock_order(capsys):
    assert main(["--lock-order", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert "TpuSolver._lock" in doc["order"]
    assert "SolvePipeline._sched_lock -> CircuitBreaker._lock" \
        in doc["edges"]


def test_proto_golden_refresh_is_idempotent(tmp_path):
    from karpenter_tpu_torch.analysis.rules import kt021

    out = kt021.write_golden(tmp_path / "golden.json")
    assert json.loads(out.read_text()) == \
        json.loads(kt021.golden_path().read_text())


def test_summary_cache_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv("KT_LINT_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    cache = SummaryCache.default()
    assert cache.path == tmp_path / "karpenter-ktlint-torch" / "cache.json"
    monkeypatch.setenv("KT_LINT_CACHE", "0")
    assert SummaryCache.default().path is None
    monkeypatch.setenv("KT_LINT_CACHE", str(tmp_path / "c.json"))
    assert SummaryCache.default().path == tmp_path / "c.json"


def test_summary_cache_round_trip(tmp_path):
    files = [load_source("def f():\n    return g()\n\ndef g():\n    return 1\n",
                         "karpenter_tpu_torch/a.py")]
    c1 = SummaryCache(path=tmp_path / "cache.json")
    p1 = Project.build(files, cache=c1)
    c2 = SummaryCache(path=tmp_path / "cache.json")
    p2 = Project.build(files, cache=c2)
    assert (c1.misses, c2.hits, c2.misses) == (1, 1, 0)
    assert sorted(p1.funcs) == sorted(p2.funcs)
    assert p2.funcs["karpenter_tpu_torch.a:f"].edges[0][1] == \
        "karpenter_tpu_torch.a:g"


def test_package_run_through_a_tmp_cache(tmp_path):
    active, suppressed, n = analyze_package(
        cache=SummaryCache(path=tmp_path / "cache.json"))
    assert active == [] and suppressed and n > 120
    assert (tmp_path / "cache.json").exists()


def test_nested_def_and_callable_argument_edges():
    files = [load_source(textwrap.dedent("""
        class S:
            def run(self, fn):
                return fn()

            def work(self):
                return 1

            def go(self):
                def _call():
                    return self.work()
                return self.run(self.work), _call()
        """), "karpenter_tpu_torch/m.py")]
    project = build_project(files)
    edges = {c for _l, c, _n in project.funcs["karpenter_tpu_torch.m:S.go"].edges}
    assert {"karpenter_tpu_torch.m:S.run", "karpenter_tpu_torch.m:S.work",
            "karpenter_tpu_torch.m:S.go._call"} <= edges
