"""The packed-score function of the port against the reference package.

``karpenter_tpu_torch.solver.hierarchy.packed_scan_scores`` takes its plain
PyTorch version on CPU tensors (the CUDA kernel runs only on the card; see
``test_torch_cuda.py``).  Its cost and index must be BYTE-equal to both
reference paths — the lax program and the Pallas kernel interpreted on the
CPU — on the reference's own cases (ties, all-infeasible rows, one exact
(32, 128) tile) and at the hierarchical slice's padded shape (48 x 448).
``pack_scores`` must produce ml_dtypes' bf16 bytes, sentinel included.
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
