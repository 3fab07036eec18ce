"""The port on the CUDA card: each hand-written kernel against its plain
PyTorch version, and the hierarchical solve on ``cuda`` against ``cpu``.

Marked ``cuda``; every test skips (from a fixture) where no CUDA device is
present.  The card-side suite runs without the reference package (the
machine with the card has no JAX), so it skips the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.models.tensorize import pack_feasibility, pack_scores
from karpenter_tpu_torch.solver import hierarchy as hier

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from karpenter_tpu_torch import kernels

    kernels.build(kernels.ALL)
    return torch.device("cuda")


@pytest.mark.parametrize("G,C,p", [(5, 7, 0.6), (40, 425, 0.3),
                                   (48, 448, 0.05), (4096, 1024, 0.5),
                                   (3, 1, 0.0)])
def test_packed_score_kernel_byte_equal_to_plain(cuda, G, C, p):
    from karpenter_tpu_torch.kernels import PACKED_SCORE

    rng = np.random.default_rng(G * 7 + C)
    f = torch.from_numpy(pack_feasibility(rng.random((G, C)) < p))
    price = rng.uniform(0.1, 9.0, size=C).astype(np.float32)
    price[C // 2:] = price[: C - C // 2]
    pr = pack_scores(price)
    before = PACKED_SCORE.launches
    c_k, i_k = hier.packed_scan_scores(f.to(cuda), pr.to(cuda))
    torch.cuda.synchronize()
    assert PACKED_SCORE.launches == before + 1
    c_p, i_p = hier.packed_scan_scores_plain(f, pr)
    assert c_k.cpu().numpy().tobytes() == c_p.numpy().tobytes()
    assert i_k.cpu().numpy().tobytes() == i_p.numpy().tobytes()


def test_packed_score_rejects_bad_inputs(cuda):
    f = torch.zeros(4, 8, dtype=torch.int8, device=cuda)
    p = torch.zeros(8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        hier.packed_scan_scores(f.to(torch.int32), p)
    with pytest.raises(ValueError):
        hier.packed_scan_scores(f, p[:7])
    with pytest.raises(ValueError):
        hier.packed_scan_scores(f.t(), torch.zeros(4, dtype=torch.bfloat16,
                                                   device=cuda))
    with pytest.raises(ValueError):
        hier.packed_scan_scores(f, p.cpu())


def test_hierarchical_solve_cuda_matches_cpu(cuda, monkeypatch):
    import chip_smoke as cs
    from karpenter_tpu_torch.models.catalog import generate_catalog

    catalog = generate_catalog(full=False)
    pods = cs.deployments(6, 60, tag="q")
    monkeypatch.setenv("KT_HIER_THRESHOLD", str(len(pods)))
    out = {dev: cs.limited_solve(dev, pods, catalog) for dev in ("cuda", "cpu")}
    rg, rc = out["cuda"][4], out["cpu"][4]
    assert out["cuda"][2] == out["cpu"][2]
    assert cs.plan(rg) == cs.plan(rc) or cs.placements_tie(rg, rc)
    assert out["cuda"][7]["packed_score"] >= 1
