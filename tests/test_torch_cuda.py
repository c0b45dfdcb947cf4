"""The port on the card: the hand-written kernels against their plain torch
versions, and a SQL session on CUDA.  Every test here needs a CUDA device
and skips without one.  This file imports neither JAX nor the JAX package,
so it runs where only torch is installed:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: counts and min/max exact (NaN equal to NaN: a group holding a
NaN gives NaN); sums to rtol=atol=1e-5 (both sides accumulate in float64 in
different orders, then round to float32).
"""

import numpy as np
import pytest
import torch

from baikaldb_tpu_torch.ops import group_kernels as gk

CASES = [  # (n, num_groups, live fraction, seed)
    (5000, 37, 0.6, 0), (100, 3, 1.0, 1), (5000, 1000, 0.7, 2),
    (3001, 4096, 0.5, 3), (1 << 20, 2049, 0.5, 8), (0, 600, 0.5, 9),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _inputs(n, ng, live, seed, dev):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-2, ng + 2, n).astype(np.int32)
    values = rng.normal(size=n).astype(np.float32)
    mask = rng.random(n) < live
    return [torch.from_numpy(a).to(dev) for a in (codes, values, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,ng,live,seed", CASES)
def test_kernels_match_plain_versions(cuda, n, ng, live, seed):
    codes, values, mask = _inputs(n, ng, live, seed, cuda)
    before = {k: c.value for k, c in gk.LAUNCHES.items()}
    k1 = gk.filtered_group_sum(codes, values, mask, ng)
    k1d = gk.filtered_group_sum(codes, values.double(), mask, ng)
    k2 = gk.fused_group_aggregate(codes, values, mask, ng)
    k3 = gk.partition_histogram(codes, mask, ng)
    torch.cuda.synchronize()
    p1 = gk.filtered_group_sum_plain(codes, values, mask, ng)
    p2 = gk.fused_group_aggregate_plain(codes, values, mask, ng)
    p3 = gk.partition_histogram_plain(codes, mask, ng)
    assert torch.equal(k3, p3)
    for got, want in ((k1, p1), (k1d, p1), (k2, p2)):
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert torch.equal(k2[2], p2[2]) and torch.equal(k2[3], p2[3])
    assert {k: c.value - before[k] for k, c in gk.LAUNCHES.items()} == \
        {"filtered_group_sum": 2, "fused_group_aggregate": 1, "partition_histogram": 1}


def _same(got, want):
    """Exact equality, NaN equal to NaN."""
    return (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [700, 2049])
def test_fused_group_aggregate_keeps_nan_of_either_sign(cuda, ng):
    rng = np.random.default_rng(ng)
    n = 200_003
    codes = rng.integers(0, ng, n).astype(np.int32)
    values = rng.normal(size=n).astype(np.float32)
    mask = rng.random(n) < 0.6
    bits = values.view(np.uint32)
    codes[10:13], mask[10:13], bits[10:13] = 5, True, 0x7FC00000   # +NaN (numpy's)
    codes[20:23], mask[20:23], bits[20:23] = 9, True, 0xFFC00000   # -NaN (x86's default)
    codes[30], mask[30], bits[30] = 11, False, 0x7FC00000           # masked out: dropped
    codes[40:43], mask[40:43] = 13, True
    codes[50:53], mask[50:53] = 17, True
    values[codes == 13] = np.inf        # all +inf: MIN keeps the 3.4e38 sentinel
    values[codes == 17] = -np.inf       # all -inf: MAX keeps the -3.4e38 sentinel
    c, v, m = (torch.from_numpy(a).to(cuda) for a in (codes, values, mask))
    got = [t.cpu() for t in gk.fused_group_aggregate(c, v, m, ng)]
    want = [t.cpu() for t in gk.fused_group_aggregate_plain(c, v, m, ng)]
    nan_groups = torch.zeros(ng, dtype=torch.bool)
    nan_groups[[5, 9]] = True
    for k in (1, 2, 3):       # sums, mins, maxs: NaN exactly in groups 5 and 9
        assert torch.equal(got[k].isnan(), nan_groups)
    assert torch.equal(got[0], want[0])
    assert _same(got[2], want[2]) and _same(got[3], want[3])   # other groups exact
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5, equal_nan=True)
    big = torch.tensor(3.4e38, dtype=torch.float32)
    assert got[2][13] == big and got[3][13] == float("inf")
    assert got[2][17] == float("-inf") and got[3][17] == -big


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(0, 1, 0), (0, 2, 0), (0, 3, 0), (1, 1, 1), (3, 3, 3),
                                     (2, 0, 1)])
@pytest.mark.parametrize("n", [100_003, 4097, 6])
def test_fused_group_aggregate_takes_views_at_any_offset(cuda, offsets, n):
    ng = 2049
    rng = np.random.default_rng(n + sum(offsets))
    codes = rng.integers(-2, ng + 2, n + 4).astype(np.int32)
    values = rng.normal(size=n + 4).astype(np.float32)
    mask = rng.random(n + 4) < 0.6
    oc, ov, om = offsets
    c = torch.from_numpy(codes).to(cuda)[oc:oc + n]
    v = torch.from_numpy(values).to(cuda)[ov:ov + n]
    m = torch.from_numpy(mask).to(cuda)[om:om + n]
    assert v.is_contiguous() and v.storage_offset() == ov
    got = gk.fused_group_aggregate(c, v, m, ng)
    want = gk.fused_group_aggregate_plain(c, v, m, ng)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


@pytest.mark.cuda
def test_session_runs_on_the_card(cuda):
    from baikaldb_tpu_torch.exec.session import Session

    s = Session()
    assert s.device.type == "cuda"
    s.execute("CREATE TABLE t (g INT, v FLOAT)")
    s.execute("INSERT INTO t VALUES (1, 2.0), (1, 3.0), (2, 4.0), (700, 1.0)")
    for c in gk.LAUNCHES.values():
        c.reset()
    assert s.query("SELECT g, SUM(v) s, MIN(v) m FROM t GROUP BY g HAVING s > 1 "
                   "ORDER BY g") == \
        [{"g": 1, "s": 5.0, "m": 2.0}, {"g": 2, "s": 4.0, "m": 4.0}]
    # 700 distinct key values: the dense group-by takes the kernels
    assert gk.LAUNCHES["fused_group_aggregate"].value == 1
    assert s.db.stores["default.t"].device_table_batch().device.type == "cuda"
