"""The packed-score function of the port against the reference package.

``karpenter_tpu_torch.solver.hierarchy.packed_scan_scores`` takes its plain
PyTorch version on CPU tensors (the CUDA kernel runs only on the card; see
``test_torch_cuda.py``).  Its cost and index must be BYTE-equal to both
reference paths — the lax program and the Pallas kernel interpreted on the
CPU — on the reference's own cases (ties, all-infeasible rows, one exact
(32, 128) tile) and at the hierarchical slice's padded shape (48 x 448).
``pack_scores`` must produce ml_dtypes' bf16 bytes, sentinel included.

The price loop's fused step, ``price_step_scores`` (plain version on CPU
tensors), must be byte-equal to the reference's chain on the same inputs:
``price_adjusted`` -> ``[:C].min(axis=1)`` -> ``pack_scores`` ->
``packed_scan_scores`` (lax and Pallas-interpreted), over shapes, provisioner
counts, dual values up to the 8.0 cap, sentinel and +inf prices,
all-infeasible rows, ties, and a hot provisioner whose multiplier moves the
argmin.  In the price loop the resident inputs are built once per solve and
the fused step runs once per price iteration.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from karpenter_tpu.models.tensorize import pack_feasibility as pack_f_ref
from karpenter_tpu.models.tensorize import pack_scores as pack_s_ref
from karpenter_tpu.solver import hierarchy as hier_ref
from karpenter_tpu_torch.models.tensorize import pack_feasibility, pack_scores
from karpenter_tpu_torch.solver import hierarchy as hier

torch.set_num_threads(1)


def _case(G, C, seed, p_feasible=0.6, ties=True):
    """Random int8 feasibility and f32 prices from one numpy seed; the
    second half of the prices repeats the first, forcing ties."""
    rng = np.random.default_rng(seed)
    feas = rng.random((G, C)) < p_feasible
    price = rng.uniform(0.1, 9.0, size=C).astype(np.float32)
    if ties:
        price[C // 2:] = price[: C - C // 2]
    return feas, price


def _both(feas, price):
    """Reference (lax, Pallas) and port outputs on the same inputs."""
    f_ref = pack_f_ref(feas)
    p_ref = pack_s_ref(price)
    lax = hier_ref.packed_scan_scores(f_ref, p_ref, use_pallas=False)
    pallas = hier_ref.packed_scan_scores(f_ref, p_ref, use_pallas=True)
    f = torch.from_numpy(pack_feasibility(feas))
    cost, idx = hier.packed_scan_scores(f, pack_scores(price))
    return lax, pallas, (cost.numpy(), idx.numpy())


CASES = {
    "ties_5x7": dict(G=5, C=7, seed=3),
    "tile_aligned_32x128": dict(G=32, C=128, seed=9),
    "slice_padded_48x448": dict(G=48, C=448, seed=11),
    "sparse_40x425": dict(G=40, C=425, seed=5, p_feasible=0.05),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_byte_equal_to_both_reference_paths(name):
    lax, pallas, port = _both(*_case(**CASES[name]))
    for ref in (lax, pallas):
        assert np.asarray(ref[0]).astype(np.float32).tobytes() == port[0].tobytes()
        assert np.asarray(ref[1]).astype(np.int32).tobytes() == port[1].tobytes()
    assert port[0].dtype == np.float32 and port[1].dtype == np.int32


def test_cheapest_feasible_pick():
    feas = np.array([[1, 0, 1], [0, 1, 1]], dtype=bool)
    price = np.array([5.0, 1.0, 2.0], dtype=np.float32)
    lax, pallas, (cost, idx) = _both(feas, price)
    np.testing.assert_array_equal(cost, [2.0, 1.0])
    assert idx.tolist() == [2, 1]
    assert idx.tobytes() == np.asarray(lax[1]).tobytes()


def test_all_infeasible_row_returns_sentinel_and_zero():
    feas = np.array([[0, 0], [1, 1]], dtype=bool)
    price = np.array([1.0, 2.0], dtype=np.float32)
    lax, pallas, (cost, idx) = _both(feas, price)
    assert cost[0] == np.float32(3.0e38) and idx[0] == 0
    assert cost[1] == 1.0 and idx[1] == 0
    assert cost.tobytes() == np.asarray(pallas[0]).tobytes()


def test_sentinel_priced_feasible_column_loses_to_infeasible():
    # 3.0e38 packs to 3.0041e38 in bf16 (0x7F62), so a feasible column at
    # the sentinel price scores ABOVE an infeasible one (3.0e38): both
    # packages agree, and the caller's < 1e37 filter makes it harmless
    feas = np.array([[1, 0, 1]], dtype=bool)
    price = np.array([3.0e38, 3.0e38, 3.0e38], dtype=np.float32)
    lax, pallas, (cost, idx) = _both(feas, price)
    assert idx.tolist() == [1]
    assert cost.tobytes() == np.asarray(lax[0]).tobytes()
    assert idx.tobytes() == np.asarray(pallas[1]).astype(np.int32).tobytes()


@pytest.mark.parametrize("values", [
    [0.0, 1.0, 0.1, 0.30000001, 9.99, 123.456, 1.5e-3, 7.0e10],
    [3.0e38, np.inf, 1e37, -2.5, 65504.0, 3.3895314e38],
])
def test_pack_scores_bytes_match_ml_dtypes(values):
    f32 = np.array(values, dtype=np.float32)
    ours = pack_scores(f32)
    assert ours.dtype == torch.bfloat16
    ref = np.asarray(f32, dtype=ml_dtypes.bfloat16)
    assert ours.view(torch.int16).numpy().tobytes() == ref.view(np.int16).tobytes()


def test_pack_scores_sentinel_bytes():
    packed = pack_scores(np.array([3.0e38], dtype=np.float32))
    assert int(packed.view(torch.int16).numpy().view(np.uint16)[0]) == 0x7F62


def test_pack_scores_random_bytes_match_ml_dtypes():
    rng = np.random.default_rng(7)
    f32 = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 30, 4096)
           ).astype(np.float32)
    ref = np.asarray(f32, dtype=ml_dtypes.bfloat16).view(np.int16)
    assert pack_scores(f32).view(torch.int16).numpy().tobytes() == ref.tobytes()


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    # a wrapper given a non-CPU tensor must launch the kernel or raise;
    # the meta device stands in for "not the CPU" here
    f = torch.zeros(2, 3, dtype=torch.int8, device="meta")
    p = torch.zeros(3, dtype=torch.bfloat16, device="meta")
    monkeypatch.setattr(hier, "packed_scan_scores_plain", None)
    with pytest.raises(ValueError):
        hier.packed_scan_scores(f, p)


# ---------------------------------------------------------------------------
# the price loop's fused score step
# ---------------------------------------------------------------------------


def _step_case(G, C, D, P, lam_kind, seed):
    """``chip_smoke.step_case``: the card suite's cases, from one seed."""
    import chip_smoke

    return chip_smoke.step_case(G, C, D, P, lam_kind, seed)


def _reference_step(feas, base, prov, lam, use_pallas):
    adj = hier_ref.price_adjusted(base, prov, lam)[:base.shape[0]].min(axis=1)
    cost, idx = hier_ref.packed_scan_scores(
        pack_f_ref(feas), pack_s_ref(adj), use_pallas=use_pallas)
    return (np.asarray(cost).astype(np.float32),
            np.asarray(idx).astype(np.int32))


def _port_step(feas, base, prov, lam):
    out = hier.price_step_scores(
        torch.from_numpy(pack_feasibility(feas)), torch.from_numpy(base),
        torch.from_numpy(prov),
        torch.from_numpy(np.exp(lam).astype(np.float32)))
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, feas.shape[0])
    cost, idx = hier.split_scores(out)
    return cost.numpy(), idx.numpy()


STEP_SHAPES = {"slice_40x425_d6": (40, 425, 6), "small_5x7_d2": (5, 7, 2)}


@pytest.mark.parametrize("lam_kind", ["zero", "mid", "cap"])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("shape", sorted(STEP_SHAPES))
def test_price_step_byte_equal_to_reference_chain(shape, P, lam_kind):
    G, C, D = STEP_SHAPES[shape]
    feas, base, prov, lam = _step_case(G, C, D, P, lam_kind, seed=G + C + P)
    cost, idx = _port_step(feas, base, prov, lam)
    for use_pallas in (False, True):
        ref_cost, ref_idx = _reference_step(feas, base, prov, lam, use_pallas)
        assert ref_cost.tobytes() == cost.tobytes()
        assert ref_idx.tobytes() == idx.tobytes()
    # the all-infeasible row, and the sentinel / +inf candidates never win
    assert cost[0] == np.float32(3.0e38) and idx[0] == 0
    assert not np.isin(idx[cost < 1e37], [1, 2]).any()


def test_price_step_sentinel_and_inf_only_row():
    # a row feasible only at the 3.0e38 and +inf candidates scores like an
    # all-infeasible one: both pack above the 3.0e38 infeasible score
    feas = np.array([[0, 1, 1, 0], [1, 1, 1, 1]], dtype=bool)
    base = np.array([[2.0], [3.0e38], [np.inf], [2.0]], dtype=np.float32)
    prov = np.zeros(4, dtype=np.int32)
    lam = np.array([0.3])
    cost, idx = _port_step(feas, base, prov, lam)
    assert cost[0] == np.float32(3.0e38) and idx[0] == 0
    assert idx[1] == 0  # candidates 0 and 3 tie: the first wins
    for use_pallas in (False, True):
        ref = _reference_step(feas, base, prov, lam, use_pallas)
        assert ref[0].tobytes() == cost.tobytes()
        assert ref[1].tobytes() == idx.tobytes()


def test_price_step_hot_provisioner_flips_the_argmin():
    # candidate 0 (provisioner 0) is cheapest until provisioner 0's dual
    # prices it above candidate 1 (provisioner 1)
    feas = np.ones((3, 2), dtype=bool)
    base = np.array([[1.0, 1.25], [1.5, 1.75]], dtype=np.float32)
    prov = np.array([0, 1], dtype=np.int32)
    idx_by_lam = {}
    for lam in ([0.0, 0.0], [0.6, 0.0]):
        lam = np.array(lam)
        cost, idx = _port_step(feas, base, prov, lam)
        for use_pallas in (False, True):
            ref = _reference_step(feas, base, prov, lam, use_pallas)
            assert ref[0].tobytes() == cost.tobytes()
            assert ref[1].tobytes() == idx.tobytes()
        idx_by_lam[float(lam[0])] = idx.tolist()
    assert idx_by_lam == {0.0: [0, 0, 0], 0.6: [1, 1, 1]}


def test_price_step_entry_equals_packed_entry_on_the_host_row():
    feas, base, prov, lam = _step_case(40, 425, 6, 3, "mid", seed=21)
    cost, idx = _port_step(feas, base, prov, lam)
    row = pack_scores(hier.price_adjusted(base, prov, lam).min(axis=1))
    c1, i1 = hier.packed_scan_scores(
        torch.from_numpy(pack_feasibility(feas)), row)
    assert c1.numpy().tobytes() == cost.tobytes()
    assert i1.numpy().tobytes() == idx.tobytes()


def test_price_step_cuda_tensors_never_take_the_plain_path(monkeypatch):
    f = torch.zeros(2, 3, dtype=torch.int8, device="meta")
    base = torch.zeros(3, 2, dtype=torch.float32, device="meta")
    prov = torch.zeros(3, dtype=torch.int32, device="meta")
    mult = torch.ones(1, dtype=torch.float32, device="meta")
    monkeypatch.setattr(hier, "price_step_scores_plain", None)
    with pytest.raises(ValueError):
        hier.price_step_scores(f, base, prov, mult)


def test_price_loop_builds_resident_inputs_once(monkeypatch):
    """A contended hierarchical solve on the CPU: the resident score inputs
    are built once, the fused step runs once per price iteration, the
    price-row entry not at all, and every iteration's ``score_ms`` is
    timed apart from the one-time set-up."""
    from karpenter_tpu_torch.models import catalog as t_catalog
    from karpenter_tpu_torch.models import pod as t_pod
    from karpenter_tpu_torch.models import provisioner as t_prov
    from karpenter_tpu_torch.models.tensorize import tensorize
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    zone = "topology.kubernetes.io/zone"
    pods = [
        t_pod.PodSpec(
            name=f"pl{d}-{i}", labels={"app": f"pl{d}"},
            requests={"cpu": 0.25 * (1 + d % 4),
                      "memory": (0.5 + d % 3) * 1024.0 ** 3},
            owner_key=f"pl{d}",
            topology_spread=[t_pod.TopologySpreadConstraint(
                1, zone, "DoNotSchedule",
                t_pod.LabelSelector.of({"app": f"pl{d}"}))])
        for d in range(4) for i in range(12)
    ]
    cat = t_catalog.generate_catalog(full=False)

    def prov(limit=None):
        p = t_prov.Provisioner(name="default").with_defaults()
        if limit is not None:
            p.limits = {"cpu": limit}
        return p

    sched = BatchScheduler(backend="tpu", device="cpu")
    free = hier.solve_hierarchical(sched, pods, [prov()], cat)
    st = tensorize(pods, [prov()], cat)
    bought = sum(float(st.capacity_row(n.instance_type, n.allocatable)[0])
                 for n in free.nodes)

    calls = {"inputs": [], "step": [], "packed": 0}
    real_inputs, real_step = hier.score_inputs, hier.price_step_scores

    def inputs(*a):
        out = real_inputs(*a)
        calls["inputs"].append(tuple(t.shape for t in out))
        return out

    def step(*a, **kw):
        calls["step"].append(tuple(tuple(t.shape) for t in a))
        return real_step(*a, **kw)

    def packed(*a):
        calls["packed"] += 1
        raise AssertionError("the price loop must not take the row entry")

    monkeypatch.setattr(hier, "score_inputs", inputs)
    monkeypatch.setattr(hier, "price_step_scores", step)
    monkeypatch.setattr(hier, "packed_scan_scores", packed)
    stats = {}
    res = hier.solve_hierarchical(
        sched, pods, [prov(round(bought * 0.99, 1))], cat, stats=stats)
    assert res is not None
    iters = stats["price_iters"]
    assert iters >= 1
    D = st.cand_price.shape[1]
    P = len(st.prov_names)
    assert calls["inputs"] == [((st.G, st.C), (st.C, D), (st.C,))]
    assert calls["step"] == [((st.G, st.C), (st.C, D), (st.C,), (P,))] * iters
    assert calls["packed"] == 0
    assert len(stats["score_ms"]) == iters
    assert stats["score_setup_ms"] > 0.0
    assert len(stats["price_lam"]) == P
