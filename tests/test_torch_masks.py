"""The port's ``ops/masks.py`` against the reference package's.

Inputs come from one numpy seed per case and go to both packages; integer
outputs (allocations, argmin indices, bit tests) must match EXACTLY.  The
cases carry the shapes the solve feeds these ops: ties, ineligible zones,
zero totals, and the BIG / 1e9 "unbounded" sentinels.  Each op is also run
batched (a leading slot axis, as the port's step calls it) and must equal
its row-by-row results.  On the CPU the two fills run their plain bodies
and launch no kernel (the kernel, ``csrc/zone_fill.cu``, is held to those
bodies on the card by ``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.ops import masks as ref
from karpenter_tpu_torch.ops import masks as ops

torch.set_num_threads(1)

SEEDS = list(range(6))
BIGN = np.float32(1e9)


def _zone_case(seed, Z=3):
    rng = np.random.default_rng(seed)
    current = rng.integers(0, 6, Z).astype(np.float32)
    cap = rng.choice([0, 1, 2, 5, 9, 40, BIGN], Z).astype(np.float32)
    rows = np.minimum(rng.integers(0, 6, Z).astype(np.float32), cap)
    total = np.float32(rng.choice([0, 1, 3, 7, 20, 61]))
    skew = np.float32(rng.choice([1, 2, 5, 3.4e38]))
    eligible = rng.random(Z) < 0.8
    if seed % 3 == 0:
        current[:] = current[0]  # ties
    return current, rows, cap, total, skew, eligible


@pytest.mark.parametrize("seed", SEEDS)
def test_water_fill(seed):
    current, _rows, cap, total, _skew, eligible = _zone_case(seed)
    want = np.asarray(ref.water_fill(
        jnp.asarray(current), jnp.asarray(cap), jnp.asarray(total),
        jnp.asarray(eligible)))
    got = ops.water_fill(
        torch.from_numpy(current), torch.from_numpy(cap),
        torch.tensor(total), torch.from_numpy(eligible)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_skew_band_fill(seed):
    current, rows, cap, total, skew, eligible = _zone_case(seed)
    want = np.asarray(ref.skew_band_fill(
        jnp.asarray(current), jnp.asarray(rows), jnp.asarray(cap),
        jnp.asarray(total), jnp.asarray(skew), jnp.asarray(eligible)))
    got = ops.skew_band_fill(
        torch.from_numpy(current), torch.from_numpy(rows),
        torch.from_numpy(cap), torch.tensor(total), torch.tensor(skew),
        torch.from_numpy(eligible)).numpy()
    np.testing.assert_array_equal(got, want)


def test_zone_ops_batched_equal_row_by_row():
    rows_in = [_zone_case(s) for s in SEEDS]
    stack = [torch.from_numpy(np.stack([r[i] for r in rows_in]))
             for i in range(6)]
    cur, rows, cap, total, skew, el = stack
    got_w = ops.water_fill(cur, cap, total, el)
    got_s = ops.skew_band_fill(cur, rows, cap, total, skew, el)
    for b, r in enumerate(rows_in):
        t = [torch.tensor(x) if np.ndim(x) == 0 else torch.from_numpy(x)
             for x in r]
        assert torch.equal(got_w[b], ops.water_fill(t[0], t[2], t[3], t[5]))
        assert torch.equal(got_s[b], ops.skew_band_fill(*t))


@pytest.mark.parametrize("seed", SEEDS)
def test_lex_argmin(seed):
    rng = np.random.default_rng(100 + seed)
    shape = (7, 4)
    # few distinct values so every key level ties somewhere
    keys = [rng.integers(0, 3, shape).astype(np.float32) for _ in range(3)]
    keys[0][rng.random(shape) < 0.3] = ref.BIG
    keys.append(np.arange(28, dtype=np.float32).reshape(shape))
    want = int(ref.lex_argmin(*[jnp.asarray(k) for k in keys]))
    got = ops.lex_argmin(*[torch.from_numpy(k) for k in keys])
    assert int(got) == want
    # batched over a leading slot axis
    batched = ops.lex_argmin(
        *[torch.from_numpy(np.stack([k, k[::-1]])) for k in keys],
        batch_dims=1)
    want_rev = int(ref.lex_argmin(*[jnp.asarray(k[::-1]) for k in keys]))
    assert batched.tolist() == [want, want_rev]


def test_lex_argmin_all_big_takes_first():
    k = np.full((3, 2), ref.BIG, dtype=np.float32)
    assert int(ops.lex_argmin(torch.from_numpy(k))) == 0
    assert int(ref.lex_argmin(jnp.asarray(k))) == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_prefix_allocate(seed):
    rng = np.random.default_rng(200 + seed)
    cap = np.floor(rng.uniform(0, 6, 17)).astype(np.float32)
    cap[rng.random(17) < 0.2] = 0.0
    quota = np.float32(rng.choice([0, 4, 13, 200]))
    want = np.asarray(ref.prefix_allocate(jnp.asarray(cap), jnp.asarray(quota)))
    got = ops.prefix_allocate(torch.from_numpy(cap), torch.tensor(quota)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_gather_pm_bits(seed):
    rng = np.random.default_rng(300 + seed)
    K, W, C = 5, 3, 9
    pm = rng.integers(0, 2**32, (K, W), dtype=np.uint32)
    pm[0, 0] = 0xFFFFFFFF  # bit 31 set
    vw = rng.integers(0, W, (C, K)).astype(np.int32)
    vb = rng.integers(0, 32, (C, K)).astype(np.int32)
    vb[0, :] = 31
    want = np.asarray(ref.gather_pm_bits(
        jnp.asarray(pm), jnp.asarray(vw), jnp.asarray(vb)))
    pm_t = torch.from_numpy(pm.astype(np.int64))
    got = ops.gather_pm_bits(pm_t, torch.from_numpy(vw), torch.from_numpy(vb))
    np.testing.assert_array_equal(got.numpy(), want)
    batched = ops.gather_pm_bits(torch.stack([pm_t, pm_t]),
                                 torch.from_numpy(vw), torch.from_numpy(vb))
    assert torch.equal(batched[1], got)


def test_constants_match():
    assert np.float32(ops.BIG).tobytes() == np.float32(ref.BIG).tobytes()


def test_band_remainder_takes_a_zone_with_whole_headroom():
    """Queue C2's band: no pods yet, free rows in zone 0 only, 2 pods at
    maxSkew 1.  The band fill's remainder must land below the band top
    ([1, 1, 0]); the reference's top-up takes the fractional headroom of
    zone 0 first and returns the skew-violating [2, 0, 0]."""
    cur = torch.zeros(1, 3)
    rows = torch.tensor([[6.0, 0.0, 0.0]])
    el = torch.ones(1, 3, dtype=torch.bool)
    got = ops.skew_band_fill(cur, rows, torch.full((1, 3), BIGN),
                             torch.tensor([2.0]), torch.tensor([1.0]), el)
    assert got.tolist() == [[1, 1, 0]]
    want_ref = np.asarray(ref.skew_band_fill(
        jnp.zeros(3), jnp.asarray([6.0, 0.0, 0.0]), jnp.full(3, BIGN),
        jnp.float32(2), jnp.float32(1), jnp.ones(3, bool)))
    assert want_ref.tolist() == [2, 0, 0]
    # whole-unit room is taken before fractional room, in zone order
    got = ops.water_fill(torch.tensor([[1.0, 0.0, 0.0]]),
                         torch.tensor([[0.34, 1.34, 1.34]]),
                         torch.tensor([1.0]), el)
    assert got.tolist() == [[0, 1, 0]]
    got = ops.water_fill(torch.zeros(1, 3),
                         torch.tensor([[0.67, 0.67, 0.67]]),
                         torch.tensor([2.0]), el)
    assert got.tolist() == [[1, 1, 0]]


def _fill_launches():
    from karpenter_tpu_torch.kernels import SKEW_BAND_FILL, WATER_FILL

    return SKEW_BAND_FILL.launches, WATER_FILL.launches


@pytest.mark.parametrize("seed", SEEDS)
def test_cpu_fills_take_the_plain_bodies(seed):
    rows_in = [_zone_case(seed + 10 * b) for b in range(3)]
    cur, rows, cap, total, skew, el = [
        torch.from_numpy(np.stack([r[i] for r in rows_in])) for i in range(6)]
    before = _fill_launches()
    assert torch.equal(ops.skew_band_fill(cur, rows, cap, total, skew, el),
                       ops.skew_band_fill_plain(cur, rows, cap, total, skew,
                                                el))
    assert torch.equal(ops.water_fill(cur, cap, total, el),
                       ops.water_fill_plain(cur, cap, total, el))
    assert _fill_launches() == before


def test_cpu_spread_solve_launches_no_fill_kernel():
    """A zone-spread solve on the CPU runs its fills through the plain
    bodies: the kernel entries count no launch."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.models import labels as L
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.pod import (
        LabelSelector,
        PodSpec,
        TopologySpreadConstraint,
    )
    from karpenter_tpu_torch.models.provisioner import Provisioner
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    pods = [PodSpec(name=f"d{d}-{i}", labels={"app": f"d{d}"},
                    requests={"cpu": 0.5, "memory": 2**30},
                    topology_spread=[TopologySpreadConstraint(
                        1, L.ZONE, "DoNotSchedule",
                        LabelSelector.of({"app": f"d{d}"}))],
                    owner_key=f"d{d}")
            for d in range(2) for i in range(30)]
    sched = BatchScheduler(backend="tpu", compile_behind=False, device="cpu")
    before = kernels.counts()
    res = sched.solve(pods, [Provisioner(name="default").with_defaults()],
                      generate_catalog(full=False))
    sched.stop_warms()
    assert len(res.assignments) == len(pods)
    assert kernels.counts() == before
    assert {k: before[k] for k in ("skew_band_fill", "water_fill")} == {
        "skew_band_fill": 0, "water_fill": 0}


def test_zone_fill_entries_are_registered():
    from karpenter_tpu_torch import kernels

    assert kernels.SKEW_BAND_FILL in kernels.ALL
    assert kernels.WATER_FILL in kernels.ALL
    lib = kernels.SKEW_BAND_FILL.library
    assert kernels.WATER_FILL.library is lib is kernels.ZONE_FILL_LIB
    assert lib.name == "zone_fill" and lib.source.name == "zone_fill.cu"
    assert lib.source.is_file()
    assert lib in kernels.libraries()
    text = lib.source.read_text()
    for k in (kernels.SKEW_BAND_FILL, kernels.WATER_FILL):
        assert f'extern "C" int {k.symbol}(' in text
        assert k.name in kernels.counts()
    # the source includes only the CUDA runtime headers: no PyTorch build
    includes = [ln for ln in text.splitlines() if ln.startswith("#include")]
    assert includes == ["#include <cuda_runtime.h>", "#include <stdint.h>"]
