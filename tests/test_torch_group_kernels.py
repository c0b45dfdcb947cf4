"""The port's group-by kernels (baikaldb_tpu_torch/ops/group_kernels.py)
against the JAX package's Pallas kernels (interpret mode, as
tests/test_pallas.py runs them) and their XLA fallbacks.

Inputs come from numpy with fixed seeds and go through both packages.
Tolerances: counts and min/max match exactly (the port's counts are int64,
the Pallas kernels' float32 counts are exact below 2^24; min/max select an
input value); sums use rtol=atol=1e-4 as tests/test_pallas.py does (float32
outputs, sums taken in another order).

On the CPU the entry points run their plain torch versions; the CUDA kernels
are held against those plain versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from baikaldb_tpu.ops import pallas_kernels as pk
from baikaldb_tpu_torch.ops import group_kernels as gk

RTOL = ATOL = 1e-4

CASES = [  # (n, num_groups, live fraction, seed)
    (5000, 37, 0.6, 0),        # test_pallas.py's shape
    (100, 3, 1.0, 1),          # heavy padding on the TPU side
    (5000, 1000, 0.7, 2),      # across the 512-group gate
    (3001, 4096, 0.5, 3),      # the largest group count, ragged n
]


def _inputs(n, ng, live, seed, out_of_range=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-2 if out_of_range else 0, ng + 2 if out_of_range else ng,
                         n).astype(np.int32)
    values = rng.normal(size=n).astype(np.float32)
    mask = rng.random(n) < live
    return codes, values, mask


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("n,ng,live,seed", CASES)
def test_filtered_group_sum_matches_pallas(n, ng, live, seed):
    codes, values, mask = _inputs(n, ng, live, seed)
    c_t, s_t = gk.filtered_group_sum(*_t(codes, values, mask), ng)
    c_p, s_p = pk.filtered_group_sum(*_j(codes, values, mask), ng, interpret=True)
    c_x, s_x = pk._xla_fallback(*_j(codes, values, mask), ng)
    assert c_t.dtype == torch.int64 and s_t.dtype == torch.float32
    for c_ref, s_ref in ((c_p, s_p), (c_x, s_x)):
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_ref))
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,ng,live,seed", CASES)
def test_fused_group_aggregate_matches_pallas(n, ng, live, seed):
    codes, values, mask = _inputs(n, ng, live, seed)
    got = gk.fused_group_aggregate(*_t(codes, values, mask), ng)
    for ref in (pk.fused_group_aggregate(*_j(codes, values, mask), ng, interpret=True),
                pk._xla_agg_fallback(*_j(codes, values, mask), ng)):
        c, s, mn, mx = (np.asarray(r) for r in ref)
        np.testing.assert_array_equal(got[0].numpy(), c)
        np.testing.assert_allclose(got[1].numpy(), s, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got[2].numpy(), mn)
        np.testing.assert_array_equal(got[3].numpy(), mx)


@pytest.mark.parametrize("n,ng,live,seed", CASES)
def test_partition_histogram_matches_pallas(n, ng, live, seed):
    codes, _, mask = _inputs(n, ng, live, seed)
    got = gk.partition_histogram(*_t(codes, mask), ng)
    ref = pk.partition_histogram(*_j(codes, mask), ng, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ok = mask & (codes >= 0) & (codes < ng)
    np.testing.assert_array_equal(got.numpy(), np.bincount(codes[ok], minlength=ng))


NAN_CASES = [  # (n, num_groups, seed)
    (5000, 700, 10), (3001, 4096, 11), (2000, 37, 12),
]


@pytest.mark.parametrize("n,ng,seed", NAN_CASES)
def test_fused_group_aggregate_keeps_nan_as_the_xla_fallback(n, ng, seed):
    """NaNs of both signs in live rows, a masked-out row and an
    out-of-range row; groups of all +inf and all -inf.  The reference is ``_xla_agg_fallback``, not the
    interpret-mode kernel: the TPU kernel's one-hot product turns NaN * 0
    into NaN in every group's sum."""
    codes, values, mask = _inputs(n, ng, 0.6, seed)
    bits = values.view(np.uint32)
    codes[10:13], mask[10:13], bits[10:13] = 5, True, 0x7FC00000    # +NaN
    codes[20:23], mask[20:23], bits[20:23] = 9, True, 0xFFC00000    # -NaN
    codes[30], mask[30], bits[30] = 11, False, 0x7FC00000           # masked out
    codes[31], mask[31], bits[31] = ng, True, 0xFFC00000            # out of range
    codes[40:43], mask[40:43] = 13, True
    codes[50:53], mask[50:53] = 17, True
    values[codes == 13] = np.inf        # all +inf: MIN keeps the 3.4e38 sentinel
    values[codes == 17] = -np.inf       # all -inf: MAX keeps the -3.4e38 sentinel
    got = [t.numpy() for t in gk.fused_group_aggregate(*_t(codes, values, mask), ng)]
    c, s, mn, mx = (np.asarray(r) for r in pk._xla_agg_fallback(*_j(codes, values, mask), ng))
    nan_groups = np.zeros(ng, bool)
    nan_groups[[5, 9]] = True
    for col in (got[1], got[2], got[3], s, mn, mx):
        np.testing.assert_array_equal(np.isnan(col), nan_groups)
    np.testing.assert_array_equal(got[0], c)
    np.testing.assert_allclose(got[1], s, rtol=RTOL, atol=ATOL)   # NaN equals NaN
    np.testing.assert_array_equal(got[2], mn)
    np.testing.assert_array_equal(got[3], mx)
    assert got[2][13] == np.float32(3.4e38) and got[3][13] == np.inf
    assert got[2][17] == -np.inf and got[3][17] == np.float32(-3.4e38)


def test_all_filtered_and_empty_groups():
    codes, values, mask = _t(np.zeros(100, np.int32), np.ones(100, np.float32),
                             np.zeros(100, bool))
    c, s = gk.filtered_group_sum(codes, values, mask, 4)
    assert c.sum() == 0 and s.sum() == 0
    c, s, mn, mx = gk.fused_group_aggregate(codes, values, mask, 4)
    assert c.sum() == 0
    assert torch.all(mn == torch.tensor(3.4e38, dtype=torch.float32))
    assert torch.all(mx == torch.tensor(-3.4e38, dtype=torch.float32))


def test_float64_values_contract_as_float32():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 600, 4000).astype(np.int32)
    values = rng.normal(size=4000) * 1e3
    mask = rng.random(4000) < 0.8
    c, s = gk.filtered_group_sum(*_t(codes, values, mask), 600)
    c_p, s_p = pk.filtered_group_sum(*_j(codes, values, mask), 600, interpret=True)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_p))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_p), rtol=RTOL, atol=1e-2)


@pytest.mark.parametrize("bad", ["codes_dtype", "mask_shape", "num_groups", "values_dtype"])
def test_entry_points_reject_what_the_kernels_do_not_take(bad):
    codes, values, mask = _t(*_inputs(64, 8, 0.5, 6, out_of_range=False))
    ng = 8
    if bad == "codes_dtype":
        codes = codes.to(torch.int64)
    elif bad == "mask_shape":
        mask = mask[:10]
    elif bad == "num_groups":
        ng = gk.MAX_GROUPS + 1
    else:
        values = values.to(torch.int32)
    with pytest.raises((TypeError, ValueError)):
        gk.filtered_group_sum(codes, values, mask, ng)


def test_cpu_path_launches_no_kernel():
    for c in gk.LAUNCHES.values():
        c.reset()
    codes, values, mask = _t(*_inputs(500, 600, 0.5, 7))
    gk.fused_group_aggregate(codes, values, mask, 600)
    gk.partition_histogram(codes, mask, 600)
    assert all(c.value == 0 for c in gk.LAUNCHES.values())


def test_k2_variant_anchors_are_in_the_kernel_source():
    """baikaldb_tpu_torch/bench/k2_variants.py edits group_agg.cu by text
    substitution; every text it replaces must still be in the source."""
    from baikaldb_tpu_torch.bench import k2_variants

    src = open(gk.SOURCE).read()
    for name, subs in k2_variants.VARIANTS.items():
        for old, _ in subs:
            assert src.count(old) == 1, name


def test_counts_are_exact_int64_above_2_pow_24():
    """One group of 2^24 + 1 live rows (a float32 count rounds it to 2^24)
    and a few rows elsewhere: K1-K3 count it exactly, in int64."""
    n = (1 << 24) + 1
    codes = torch.zeros(n + 3, dtype=torch.int32)
    codes[n:] = torch.tensor([1, 2, 7], dtype=torch.int32)
    values = torch.ones(n + 3, dtype=torch.float32)
    mask = torch.ones(n + 3, dtype=torch.bool)
    want = torch.tensor([n, 1, 1, 0, 0, 0, 0, 1], dtype=torch.int64)
    k1 = gk.filtered_group_sum(codes, values, mask, 8)
    k2 = gk.fused_group_aggregate(codes, values, mask, 8)
    k3 = gk.partition_histogram(codes, mask, 8)
    for counts in (k1[0], k2[0], k3):
        assert counts.dtype == torch.int64
        assert torch.equal(counts, want)
