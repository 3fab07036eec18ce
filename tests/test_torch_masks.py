"""The port's ``ops/masks.py`` against the reference package's.

Inputs come from one numpy seed per case and go to both packages; integer
outputs (allocations, argmin indices, bit tests) must match EXACTLY.  The
cases carry the shapes the solve feeds these ops: ties, ineligible zones,
zero totals, and the BIG / 1e9 "unbounded" sentinels.  Each op is also run
batched (a leading slot axis, as the port's step calls it) and must equal
its row-by-row results.
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
