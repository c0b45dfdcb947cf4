"""The port on the card: the hand-written kernels against their plain torch
versions, and a SQL session on CUDA.  Every test here but
``test_make_mesh_needs_cuda`` needs a CUDA device and skips without one.
This file imports neither JAX nor the JAX package, so it runs where only
torch is installed:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: counts and min/max exact (NaN equal to NaN: a group holding a
NaN gives NaN); sums to rtol=atol=1e-5 (both sides accumulate in float64 in
different orders, then round to float32).  The joins (ops/join.py), the
TPC-H and analytic queries, window functions, sketches and builtins run on
the card and on the CPU and must agree: join rows exactly, query rows by the
parity contract of models/parity.py, the rest as stated where they start.
"""

import contextlib

import numpy as np
import pytest
import torch

from baikaldb_tpu_torch.models import analytics
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
def test_kernel_counts_are_exact_above_2_pow_24(cuda):
    """One group of 2^24 + 1 live rows: K1-K3 give the int64 count exactly
    (a float32 count would round it to 2^24)."""
    n = (1 << 24) + 1
    codes = torch.zeros(n + 3, dtype=torch.int32, device=cuda)
    codes[n:] = torch.tensor([1, 2, 7], dtype=torch.int32, device=cuda)
    values = torch.ones(n + 3, dtype=torch.float32, device=cuda)
    mask = torch.ones(n + 3, dtype=torch.bool, device=cuda)
    want = torch.tensor([n, 1, 1, 0, 0, 0, 0, 1], dtype=torch.int64)
    for counts in (gk.filtered_group_sum(codes, values, mask, 8)[0],
                   gk.filtered_group_sum(codes, values.double(), mask, 8)[0],
                   gk.fused_group_aggregate(codes, values, mask, 8)[0],
                   gk.partition_histogram(codes, mask, 8)):
        assert counts.dtype == torch.int64 and torch.equal(counts.cpu(), want)


# -- the segment kernel (ops/segments.py, csrc/segments.cu) against its plain
# version: integers, counts, MIN and MAX exact (NaN equal to NaN); float64
# sums within 1e-9 * sum(|x|) over the segment; float32 sums (accumulated in
# float64 on both sides, rounded once) within one float32 ulp of that.

SEG_DTYPES = [torch.bool, torch.int32, torch.int64, torch.float32, torch.float64]


def _seg_inputs(n, S, dtype, seed, dev, id_dtype=torch.int32):
    """Ids in [-2, S + 2) (outside [0, S) they drop), segment 3 left empty
    when S > 4; floats carry +NaN in segment 1 and -NaN in segment 2 when S >
    2 and n > 40 (also one in a dropped row); ints span half their range, so
    int32 sums wrap."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(-2, S + 2, n)
    if S > 4:
        gid[gid == 3] = 4
    if dtype is torch.bool:
        x = rng.random(n) < 0.5
    elif dtype.is_floating_point:
        x = (rng.normal(size=n) * 1e3).astype(np.float32 if dtype is torch.float32
                                                else np.float64)
        if S > 2 and n > 40:
            bits = x.view(np.uint32 if dtype is torch.float32 else np.uint64)
            pos, neg = (0x7FC00000, 0xFFC00000) if dtype is torch.float32 else \
                (0x7FF8000000000000, 0xFFF8000000000000)
            gid[10:13], bits[10:13] = 1, pos
            gid[20:23], bits[20:23] = 2, neg
            gid[30], bits[30] = S, pos                       # dropped
    else:
        info = torch.iinfo(dtype)
        x = rng.integers(info.min // 2, info.max // 2, n, dtype=np.int64)
    return (torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(dev),
            torch.from_numpy(gid).to(id_dtype).to(dev))


def _seg_close(op, x, gid, S, got, want):
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == (S,)
    if op != "sum" or not x.dtype.is_floating_point:
        assert _same(got.double(), want.double()) if got.dtype.is_floating_point \
            else torch.equal(got, want)
        return
    live = (gid >= 0) & (gid < S)
    sabs = torch.zeros(S + 1, dtype=torch.float64, device=x.device)
    sabs.index_add_(0, torch.where(live, gid, S).long(), x.abs().double().nan_to_num(0.0))
    tol = 1e-9 * sabs[:S].cpu()
    if x.dtype is torch.float32:
        tol = tol + want.double().abs() * 2.0 ** -23
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    assert bool(((got[ok].double() - want[ok].double()).abs() <= tol[ok]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", SEG_DTYPES)
@pytest.mark.parametrize("n,S", [(65_536, 17), (100_003, 1), (100_003, 16), (200_001, 64),
                                 (50_000, 512), (3, 16), (0, 5)])
def test_segment_kernel_matches_plain(cuda, op, dtype, n, S):
    from baikaldb_tpu_torch.ops import segments as seg

    x, gid = _seg_inputs(n, S, dtype, n + S, cuda)
    before = seg.LAUNCHES["segment_reduce"].value
    got = seg.segment_reduce(x, gid, S, op)
    torch.cuda.synchronize()
    assert seg.LAUNCHES["segment_reduce"].value == before + 1
    _seg_close(op, x, gid, S, got, seg.segment_reduce_plain(x, gid, S, op))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["private", "warp", "block"])
@pytest.mark.parametrize("op,dtype", [("sum", torch.float64), ("sum", torch.int64),
                                      ("sum", torch.bool), ("min", torch.float32),
                                      ("max", torch.float64), ("max", torch.int32)])
@pytest.mark.parametrize("S", [17, 48])
def test_segment_kernel_table_layouts_agree(cuda, mode, op, dtype, S):
    from baikaldb_tpu_torch.ops import segments as seg

    x, gid = _seg_inputs(300_007, S, dtype, S, cuda, id_dtype=torch.int64)
    _seg_close(op, x, gid, S, seg.segment_reduce(x, gid, S, op, mode=mode),
               seg.segment_reduce_plain(x, gid, S, op))


@pytest.mark.cuda
def test_segment_kernel_wraps_int64_and_keeps_identities(cuda):
    from baikaldb_tpu_torch.ops import segments as seg

    x = torch.tensor([2**62, 2**62, 2**62, -5, 7], dtype=torch.int64, device=cuda)
    gid = torch.tensor([0, 0, 0, 1, 9], dtype=torch.int32, device=cuda)
    want = np.zeros(3, np.int64)
    np.add.at(want, [0, 0, 0, 1], x.cpu().numpy()[:4])     # numpy wraps like the card
    assert seg.segment_reduce(x, gid, 3, "sum").cpu().tolist() == want.tolist()
    assert seg.segment_reduce(x, gid, 3, "min").cpu().tolist() == \
        [2**62, -5, torch.iinfo(torch.int64).max]
    f = torch.tensor([1.0, float("nan"), -2.0, 3.0, -float("nan"), 5.0], device=cuda)
    g = torch.tensor([0, 0, 1, 1, 2, 3], dtype=torch.int32, device=cuda)
    mn = seg.seg_min(f, g, 5).cpu()
    assert mn.isnan().tolist() == [True, False, True, False, False]
    assert mn[1] == -2.0 and mn[3] == 5.0 and mn[4] == float("inf")
    assert seg.seg_max(f, g, 5).cpu()[4] == float("-inf")


@pytest.mark.cuda
def test_segment_reductions_take_the_kernel_under_the_gate(cuda):
    from baikaldb_tpu_torch.ops import segments as seg

    x = torch.arange(1000, dtype=torch.float64, device=cuda)
    gid = (torch.arange(1000, device=cuda) % 7).to(torch.int32)
    c = seg.LAUNCHES["segment_reduce"]
    before = c.value
    seg.seg_sum(x, gid, 7), seg.seg_min(x, gid, 7), seg.seg_max(x, gid, 7)
    assert c.value == before + 3
    big = seg.max_segments(cuda) + 1
    seg.seg_sum(x, gid, big)                     # above the gate: the scatter
    seg.seg_sum(x.reshape(-1, 1), gid, 7)        # 2-D x: the scatter
    seg.seg_sum(x.cpu(), gid.cpu(), 7)           # the CPU: the scatter
    assert c.value == before + 3


# the wide dense GROUP BY (ops/hashagg.py dense_group_agg, csrc/dense_agg.cu)
# against its plain version (the scatter route) on the card: counts,
# integers and MIN/MAX exactly (NaN equal to NaN), float64 SUM/AVG to 1e-12
# relative (the kernel's atomics add in another order)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q10", "q18_inner"])
def test_dense_wide_kernel_matches_plain_at_tpch_shapes(cuda, name):
    from baikaldb_tpu_torch.bench import dense_wide
    from baikaldb_tpu_torch.ops import dense_agg, hashagg

    gid, sel, cols, specs, ng = dense_wide.shape(name, cuda, seed=3)
    c = dense_agg.LAUNCHES["dense_group_agg"]
    before = c.value
    got = hashagg.dense_group_agg(gid, sel, cols, specs, ng)
    torch.cuda.synchronize()
    assert c.value == before + 1
    dense_wide.compare(got, hashagg.dense_group_agg_plain(gid, sel, cols, specs, ng), specs)


def _wide_inputs(n, ng, seed, dev):
    """Sorted slot ids (runs of equal slots, some outside [0, ng)), a 50%
    selection, and a column of each input type of the wide route, with
    NULLs, NaN of both signs and int64 values whose sums wrap."""
    from baikaldb_tpu_torch.column.batch import Column
    from baikaldb_tpu_torch.types import LType

    rng = np.random.default_rng(seed)
    gid = np.sort(rng.integers(-3, ng + 3, n)).astype(np.int32)
    sel = rng.random(n) < 0.5
    f64 = rng.uniform(1.0, 1e4, n)
    f64[rng.random(n) < 0.01] = np.nan
    f32 = rng.uniform(1.0, 1e4, n).astype(np.float32)
    f32[rng.random(n) < 0.01] = -np.nan
    data = {"f64": (f64, LType.FLOAT64, True), "f32": (f32, LType.FLOAT32, False),
            "i64": (rng.integers(2 ** 61, 2 ** 62, n) * rng.choice([-1, 1], n), LType.INT64,
                    True),
            "i32": (rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32), LType.INT32, False),
            "d": (rng.integers(8000, 11000, n).astype(np.int32), LType.DATE, True),
            "s": (rng.integers(0, 5000, n).astype(np.int32), LType.STRING, False)}
    cols = {k: Column(torch.from_numpy(v).to(dev),
                      torch.from_numpy(rng.random(n) > 0.2).to(dev) if nulls else None, lt)
            for k, (v, lt, nulls) in data.items()}
    return (torch.from_numpy(gid).to(dev), torch.from_numpy(sel).to(dev), cols)


@pytest.mark.cuda
@pytest.mark.parametrize("n,ng,with_sel", [(1_000_003, 100_003, True), (1_000_003, 4097, False),
                                           (2049, 2049, True), (0, 5000, True)])
def test_dense_wide_kernel_matches_plain_on_every_type(cuda, n, ng, with_sel):
    from baikaldb_tpu_torch.bench import dense_wide
    from baikaldb_tpu_torch.ops import hashagg
    from baikaldb_tpu_torch.ops.hashagg import AggSpec

    gid, sel, cols = _wide_inputs(n, ng, n + ng, cuda)
    sel = sel if with_sel else None
    # no AVG of the int64 column: its float64 sum of +-2**62 terms cancels,
    # and cancellation is where another order of the additions shows
    specs = [AggSpec("count_star", None, "n")] + [
        AggSpec(op, k, f"{op}_{k}") for k in cols for op in ("count", "sum", "avg", "min", "max")
        if (op, k) != ("avg", "i64")]
    got = hashagg.dense_group_agg(gid, sel, cols, specs, ng)
    dense_wide.compare(got, hashagg.dense_group_agg_plain(gid, sel, cols, specs, ng), specs)
    # all dead: every slot empty, every MIN/MAX at its identity
    dead = torch.zeros_like(gid, dtype=torch.bool)
    got = hashagg.dense_group_agg(gid, dead, cols, specs, ng)
    assert not bool(got[0].any())
    dense_wide.compare(got, hashagg.dense_group_agg_plain(gid, dead, cols, specs, ng), specs)


@pytest.mark.cuda
def test_dense_wide_route_runs_without_a_stream_sync(cuda):
    from baikaldb_tpu_torch.bench import dense_wide
    from baikaldb_tpu_torch.column.batch import Column, ColumnBatch
    from baikaldb_tpu_torch.exec import executor
    from baikaldb_tpu_torch.ops import dense_agg, hashagg
    from baikaldb_tpu_torch.types import LType

    gid, sel, cols, specs, ng = dense_wide.shape("q10", cuda, seed=5)
    key = Column(gid + 7, None, LType.INT32)            # the planner shifts it back by 7
    batch = ColumnBatch(("k", *cols), [key, *cols.values()], sel)
    assert hashagg.dense_route(batch, specs, ng) == "wide"
    want = hashagg.group_aggregate_dense(                # builds and binds the library
        executor._shift_keys(batch, {"k": 7}, -1), ["k"], [ng - 1], specs)
    torch.cuda.synchronize()
    c = dense_agg.LAUNCHES["dense_group_agg"]
    before = c.value
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = executor._shift_keys(hashagg.group_aggregate_dense(
            executor._shift_keys(batch, {"k": 7}, -1), ["k"], [ng - 1], specs), {"k": 7}, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert c.value == before + 1
    assert torch.equal(out.sel, want.sel)
    assert torch.equal(out.column("k").data, want.column("k").data + 7)
    dense_wide.compare((out.sel, out.columns[1:]), (want.sel, want.columns[1:]), specs)


@pytest.mark.cuda
def test_session_runs_on_the_card(cuda):
    from baikaldb_tpu_torch.exec.session import Session

    s = Session()
    assert s.device.type == "cuda"
    s.execute("CREATE TABLE t (g INT, v FLOAT)")
    s.execute("INSERT INTO t VALUES (1, 2.0), (1, 3.0), (2, 4.0), (2500, 1.0)")
    for c in gk.LAUNCHES.values():
        c.reset()
    assert s.query("SELECT g, SUM(v) s, MIN(v) m FROM t GROUP BY g HAVING s > 1 "
                   "ORDER BY g") == \
        [{"g": 1, "s": 5.0, "m": 2.0}, {"g": 2, "s": 4.0, "m": 4.0}]
    # a key domain of 2500 values: above the card's gate, the dense group-by
    # takes the kernels
    assert gk.LAUNCHES["fused_group_aggregate"].value == 1
    assert s.db.stores["default.t"].device_table_batch().device.type == "cuda"


def _join_sides(dev, seed=0, n_probe=5000, n_build=3000):
    from baikaldb_tpu_torch.column.batch import ColumnBatch

    rng = np.random.default_rng(seed)
    probe = ColumnBatch.from_numpy(
        ("pk", "pv"), [(rng.integers(0, 900, n_probe).astype(np.int32),
                        rng.random(n_probe) > 0.1, "int32", None),
                       (rng.normal(size=n_probe), None, "float64", None)],
        sel=rng.random(n_probe) > 0.2, device=dev)
    build = ColumnBatch.from_numpy(
        ("bk", "bv"), [(rng.integers(100, 1000, n_build).astype(np.int32),
                        rng.random(n_build) > 0.1, "int32", None),
                       (rng.integers(-9, 9, n_build).astype(np.int64), None, "int64", None)],
        sel=rng.random(n_build) > 0.2, device=dev)
    return probe, build


def _sorted_rows(batch):
    rows = [tuple(r.values()) for r in batch.to_pylist()]
    return sorted(rows, key=lambda r: tuple((v is not None, v if v is not None else 0)
                                            for v in r))


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_joins_on_the_card_match_the_cpu(cuda, how):
    from baikaldb_tpu_torch.ops import join as tj

    (pc, bc), (pg, bg) = _join_sides("cpu"), _join_sides(cuda)
    got, n = tj.join(pg, ["pk"], bg, ["bk"], how=how)
    want, m = tj.join(pc, ["pk"], bc, ["bk"], how=how)
    assert got.device.type == torch.device(cuda).type and n == m
    assert _sorted_rows(got) == _sorted_rows(want)
    # unique build keys over [100, 1000): the dense PK-FK join
    keys = np.random.default_rng(1).permutation(900)[:600].astype(np.int32) + 100
    from baikaldb_tpu_torch.column.batch import ColumnBatch
    dense = [ColumnBatch.from_numpy(("bk", "bv"), [(keys, None, "int32", None),
                                                   (keys.astype(np.float64), None,
                                                    "float64", None)], device=d)
             for d in ("cpu", cuda)]
    got, _ = tj.dense_join(pg, ["pk"], dense[1], ["bk"], [100], [900], how=how)
    want, _ = tj.dense_join(pc, ["pk"], dense[0], ["bk"], [100], [900], how=how)
    assert _sorted_rows(got) == _sorted_rows(want)
    if how in ("semi", "anti"):
        got, _ = tj.semi_join_neq(pg, ["pk"], bg, ["bk"], "pk", "bv", how=how)
        want, _ = tj.semi_join_neq(pc, ["pk"], bc, ["bk"], "pk", "bv", how=how)
        assert _sorted_rows(got) == _sorted_rows(want)
    else:
        got, _ = tj.cross_join(pg.gather(torch.arange(40, device=cuda)), bg)
        want, _ = tj.cross_join(pc.gather(torch.arange(40)), bc)
        assert _sorted_rows(got) == _sorted_rows(want)


@pytest.fixture(scope="module")
def tpch_pair():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card's session needs one")
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models import tpch

    tables = tpch.generate(scale=0.01, seed=0)
    out = []
    for dev in ("cuda", "cpu"):
        s = Session(device=dev)
        for name, ddl in tpch.DDL.items():
            s.execute(ddl)
            s.load_arrow(name, tables[name])
        out.append(s)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q3", "q5", "q9", "q13", "q15", "q16", "q18", "q21", "q22",
                                  "q20_rows"])
def test_tpch_on_the_card_matches_the_cpu(tpch_pair, name):
    from baikaldb_tpu_torch.models import tpch
    from baikaldb_tpu_torch.models.parity import mismatch

    gpu, cpu = tpch_pair
    sql = {**tpch.QUERIES, **tpch.VARIANTS}[name]
    before = sum(c.value for c in gk.LAUNCHES.values())
    got = gpu.query(sql)
    ran = sum(c.value for c in gk.LAUNCHES.values()) != before
    diff = mismatch(got, cpu.query(sql), sql, 1e-4 if ran else 1e-9)
    assert diff is None, diff
    if name in tpch.VARIANTS:
        assert got, f"{name} returned no rows"   # the variant exists to have rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(analytics.QUERIES))
def test_analytic_query_on_the_card_matches_the_cpu(tpch_pair, name):
    from baikaldb_tpu_torch.models.parity import mismatch

    gpu, cpu = tpch_pair
    sql = analytics.QUERIES[name]
    before = sum(c.value for c in gk.LAUNCHES.values())
    got = gpu.query(sql)
    assert sum(c.value for c in gk.LAUNCHES.values()) == before   # no group-by kernel
    diff = mismatch(got, cpu.query(sql), sql)
    assert diff is None, diff


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q3", "q18", "q21"])
def test_op_spans_carry_device_intervals_inside_the_root(tpch_pair, name):
    """With tracing on, every ``op.*`` span of a query on the card carries
    its device interval (``dev_ts_us``, ``dev_ms``); the intervals follow
    one another without overlap and lie inside the root span's wall-clock
    interval."""
    from baikaldb_tpu_torch.models import tpch
    from baikaldb_tpu_torch.obs import trace

    gpu, _ = tpch_pair
    sql = tpch.QUERIES[name]
    gpu.query(sql)
    trace.TRACER.clear()
    gpu.execute("SET GLOBAL tracing = 1")
    try:
        gpu.query(sql)
    finally:
        gpu.execute("SET GLOBAL tracing = 0")
    rec = [t for t in trace.TRACER.list() if t["text"] == sql][-1]
    trace.TRACER.clear()
    root = next(s for s in rec["spans"] if not s["parent_id"])
    ops = [s["attrs"] for s in rec["spans"] if s["name"].startswith("op.")]
    assert ops and all(a["dev_ms"] >= 0 for a in ops)
    ivs = sorted((a["dev_ts_us"], a["dev_ts_us"] + a["dev_ms"] * 1e3) for a in ops)
    slack = 1.0         # us: the events' resolution and the float microseconds
    assert all(e0 <= s1 + slack for (_, e0), (s1, _) in zip(ivs, ivs[1:]))
    assert root["ts_us"] <= ivs[0][0]
    assert ivs[-1][1] <= root["ts_us"] + root["dur_ms"] * 1e3
    reads = [s for s in rec["spans"] if s["name"] == "host.read"]
    assert all(s["attrs"]["site"].endswith(tuple("0123456789")) for s in reads)


# -- windows, sketches and builtins on the card against the CPU ---------------
# Window SUM/AVG: |card - CPU| <= 1e-9 * sum(|x|) over the input column (one
# prefix sum over the whole column); percentiles and floating builtins to
# rtol 1e-12; everything else exact, NaN equal to NaN.

WIN_N = 300_000


def _window_table():
    """One partition of 200k rows (far more than one CUDA block's worth),
    then 100k rows in small partitions; NaN in 1% of ``w``, NULLs in ``v``,
    ``o`` and ``s``."""
    import pyarrow as pa

    rng = np.random.default_rng(31)
    p = np.concatenate([np.zeros(200_000, np.int64),
                        rng.integers(1, 5000, WIN_N - 200_000)])
    w = rng.standard_normal(WIN_N) * 10
    w[rng.random(WIN_N) < 0.01] = np.nan
    v = rng.standard_normal(WIN_N) * 100
    o = rng.integers(0, 50_000, WIN_N)
    words = np.asarray([f"s{k:03d}" for k in range(500)])
    return pa.table({
        "k": np.arange(WIN_N, dtype=np.int64), "p": p,
        "o": pa.array(o, mask=rng.random(WIN_N) < 0.05),
        "v": pa.array(v, mask=rng.random(WIN_N) < 0.1), "w": w,
        "s": pa.array(words[rng.integers(0, 500, WIN_N)], mask=rng.random(WIN_N) < 0.1),
    })


def _spec(op, inp=None, **kw):
    from baikaldb_tpu_torch.ops.window import WinSpec

    return WinSpec(op, inp, "", **kw)


WINDOW_CASES = {
    "ranking": ([("o", True), ("k", True)],
                lambda: [_spec("row_number"), _spec("rank"), _spec("dense_rank"),
                         _spec("ntile", n=7)]),
    "running_nan": ([("k", True)],
                    lambda: [_spec("min", "w", running=True), _spec("max", "w", running=True),
                             _spec("sum", "v", running=True), _spec("avg", "v", running=True),
                             _spec("count", "v", running=True)]),
    "framed_min_max_nan": ([("k", True)],
                           lambda: [_spec("min", "w", frame=("rows", ("p", 50), ("f", 7))),
                                    _spec("max", "w", frame=("rows", ("p", 3), ("f", 900))),
                                    _spec("max", "w", frame=("rows", ("c",), ("uf",))),
                                    _spec("sum", "v", frame=("rows", ("p", 2), ("c",)))]),
    "range_frames": ([("o", False)],
                     lambda: [_spec("sum", "v", frame=("range", ("p", 30), ("f", 10))),
                              _spec("min", "w", frame=("range", ("p", 5), ("c",))),
                              _spec("count", None, frame=("range", ("c",), ("f", 100))),
                              _spec("last_value", "s", frame=("range", ("up",), ("p", 2)))]),
    "lead_lag_values": ([("o", True), ("k", True)],
                        lambda: [_spec("lag", "s", offset=1, default="none"),
                                 _spec("lead", "v", offset=3),
                                 _spec("first_value", "w"), _spec("last_value", "s"),
                                 _spec("max", "v"), _spec("min", "s")]),
}


def _close_rows(got, want, sum_abs):
    assert len(got) == len(want)
    for key in want[0]:
        g = np.asarray([r[key] for r in got], dtype=object)
        w = np.asarray([r[key] for r in want], dtype=object)
        if key.startswith(("sum_", "avg_")):
            gn = np.asarray([np.nan if x is None else x for x in g], float)
            wn = np.asarray([np.nan if x is None else x for x in w], float)
            assert np.array_equal(np.isnan(gn), np.isnan(wn)), key
            ok = ~np.isnan(wn)
            assert np.all(np.abs(gn[ok] - wn[ok]) <= 1e-9 * sum_abs), key
        else:
            same = [(a == b) or (isinstance(a, float) and isinstance(b, float)
                                 and np.isnan(a) and np.isnan(b)) for a, b in zip(g, w)]
            assert all(same), (key, [(a, b) for a, b, s in zip(g, w, same) if not s][:5])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WINDOW_CASES))
def test_window_on_the_card_matches_the_cpu(cuda, name):
    from baikaldb_tpu_torch.column.batch import ColumnBatch
    from baikaldb_tpu_torch.ops.sort import SortKey
    from baikaldb_tpu_torch.ops.window import window_compute

    from dataclasses import replace

    table = _window_table()
    order, make = WINDOW_CASES[name]
    specs = [replace(s, out_name=f"{s.op}_{s.input}_{i}") for i, s in enumerate(make())]
    keys = [SortKey(n, a) for n, a in order]
    out = [window_compute(ColumnBatch.from_arrow(table, dev), ["p"], keys, specs)
           for dev in (cuda, "cpu")]
    assert out[0].column(out[0].names[-1]).data.device.type == torch.device(cuda).type
    sum_abs = float(np.nansum(np.abs(table.column("v").to_numpy(zero_copy_only=False)
                                     .astype(float))))
    _close_rows(out[0].to_pylist(), out[1].to_pylist(), sum_abs)


@pytest.mark.cuda
def test_sketches_on_the_card_match_the_cpu(cuda):
    from baikaldb_tpu_torch.column.batch import Column
    from baikaldb_tpu_torch.ops import hashagg
    from baikaldb_tpu_torch.types import LType
    from baikaldb_tpu_torch.utils.hashing import hash_columns

    rng = np.random.default_rng(41)
    n, ng = 1_000_003, 37
    cols = {"i64": (rng.integers(-2**62, 2**62, n), LType.INT64),
            "f64": (np.where(rng.random(n) < 0.01, np.nan, rng.standard_normal(n)),
                    LType.FLOAT64),
            "f32": (rng.standard_normal(n).astype(np.float32), LType.FLOAT32)}
    cols["f64"][0][:4] = [0.0, -0.0, np.inf, 5e-324]
    gid = rng.integers(0, ng, n)
    live = rng.random(n) < 0.9
    for name, (x, lt) in cols.items():
        res = []
        for dev in (cuda, "cpu"):
            c = Column(torch.from_numpy(x).to(dev), None, lt)
            g = torch.from_numpy(gid).to(dev)
            m = torch.from_numpy(live).to(dev)
            regs = hashagg._hll_registers(c, m, g, ng)
            pct = hashagg._segment_percentile(c, torch.where(m, g, ng), ng, 0.37)
            res.append([t.cpu() for t in (hash_columns([c.data]), regs,
                                          hashagg._hll_estimate(regs), pct[1], pct[0])])
        for k in range(4):
            assert torch.equal(res[0][k], res[1][k]), (name, k)
        torch.testing.assert_close(res[0][4], res[1][4], rtol=1e-12, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_builtins_on_the_card_match_the_cpu(cuda):
    import datetime

    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Session

    rng = np.random.default_rng(43)
    n = 50_000
    words = np.asarray(["alpha", "Beta", "a.b.c", "", "Hello World", "x,y,z", "robert"])
    data = pa.table({
        "id": np.arange(n), "x": pa.array(rng.uniform(-1, 1, n), mask=rng.random(n) < 0.1),
        "b": rng.integers(0, 1 << 20, n),
        "s": pa.array(words[rng.integers(0, len(words), n)], mask=rng.random(n) < 0.1),
        "d": pa.array([datetime.date(1990, 1, 1) + datetime.timedelta(days=int(v))
                       for v in rng.integers(0, 15_000, n)], pa.date32()),
    })
    exprs = ["SIN(x) + ACOS(x) + ATAN2(x, 0.5) + COT(x + 2) + SINH(x) + LOG(2, b + 1)",
             "HASH(b, x)", "HASH(s)", "BIT_COUNT(b) + BIT_XOR(b, 77) + RIGHT_SHIFT(b, 70)",
             "CRC32(MD5(s))", "LPAD(SUBSTRING_INDEX(s, '.', 1), 9, '*')",
             "LOCATE('o', s, 2)", "REGEXP_LIKE(s, '^[a-z]+$')",
             "CONCAT_WS('-', 'a', s)", "DAYNAME(d)", "WEEK(d) + YEARWEEK(d) + WEEKOFYEAR(d)",
             "TIMESTAMPDIFF(MONTH, d, DATE_ADD(d, INTERVAL b % 40 MONTH))",
             "DATE_SUB(d, INTERVAL 7 MONTH)"]
    sessions = []
    for dev in (cuda, "cpu"):
        s = Session(device=dev)
        s.execute("CREATE TABLE bt (id BIGINT, x DOUBLE, b BIGINT, s VARCHAR(16), d DATE)")
        s.load_arrow("bt", data)
        sessions.append(s)
    for e in exprs:
        sql = f"SELECT id, {e} AS v FROM bt ORDER BY id"
        got, want = (s.query(sql) for s in sessions)
        for rg, rw in zip(got, want):
            if isinstance(rw["v"], float):
                assert rg["v"] == pytest.approx(rw["v"], rel=1e-12), e
            else:
                assert rg == rw, e


# -- streamed scans on the card ------------------------------------------

STREAM_ROWS = 1_000_003             # 16 chunks of 65536 rows, the last ragged
STREAM_QUERIES = {
    # (sql, kernels launched per kept chunk)
    "b": ("SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > 0.5 "
          "GROUP BY g ORDER BY g", {"partition_histogram": 1, "fused_group_aggregate": 1}),
    "c": ("SELECT g, SUM(w), AVG(w) FROM t WHERE w > -1 GROUP BY g ORDER BY g",
          {"filtered_group_sum": 1, "partition_histogram": 1}),
    "scalar": ("SELECT COUNT(*), SUM(w), MIN(v), MAX(id) FROM t WHERE id >= 123456", {}),
    "sorted": ("SELECT g16, id % 3 m, COUNT(*) n, SUM(w) s, STDDEV(v) sd FROM t "
               "GROUP BY g16, m ORDER BY g16, m", {}),
    "zone_skip": ("SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE id >= 600000 "
                  "GROUP BY g ORDER BY g",
                  {"partition_histogram": 1, "fused_group_aggregate": 1}),
}


@contextlib.contextmanager
def _port_flags(**values):
    from baikaldb_tpu_torch.utils.flags import FLAGS

    prev = {k: getattr(FLAGS, k) for k in values}
    try:
        for k, v in values.items():
            FLAGS.set_flag(k, v)
        yield
    finally:
        for k, v in prev.items():
            FLAGS.set_flag(k, v)


@pytest.fixture(scope="module")
def stream_session():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card's session needs one")
    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Session

    rng = np.random.default_rng(4)
    n = STREAM_ROWS
    s = Session()
    s.execute("CREATE TABLE t (id BIGINT, g INT, v FLOAT, w DOUBLE, g16 INT)")
    s.load_arrow("t", pa.table({
        "id": np.arange(n, dtype=np.int64), "g": rng.integers(0, 2048, n, dtype=np.int32),
        "v": rng.standard_normal(n, dtype=np.float32), "w": rng.standard_normal(n),
        "g16": rng.integers(0, 16, n, dtype=np.int32)}))
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_QUERIES))
def test_streamed_scan_on_the_card_matches_resident(stream_session, name):
    """Streamed (65536-row chunks, the default) against resident on the
    card: it really streamed (``stream_chunks``), each kept chunk launched
    its kernels once, and the rows agree by the parity contract."""
    from baikaldb_tpu_torch.models.parity import mismatch
    from baikaldb_tpu_torch.utils import metrics

    s = stream_session
    sql, per_chunk = STREAM_QUERIES[name]
    with _port_flags(streaming_scan=True, streaming_min_rows=1 << 18,
                     streaming_chunk_rows=1 << 16):
        before = {k: c.value for k, c in gk.LAUNCHES.items()}
        c0, k0 = metrics.stream_chunks.value, metrics.stream_chunks_skipped.value
        got = s.query(sql)
        torch.cuda.synchronize()
        chunks = metrics.stream_chunks.value - c0
        skipped = metrics.stream_chunks_skipped.value - k0
        launched = {k: c.value - before[k] for k, c in gk.LAUNCHES.items()
                    if c.value != before[k]}
    assert chunks >= 1 and chunks + skipped == -(-STREAM_ROWS // (1 << 16))
    assert (skipped > 0) == (name in ("zone_skip", "scalar"))
    assert launched == {k: n * chunks for k, n in per_chunk.items()}
    with _port_flags(streaming_scan=False):
        c0 = metrics.stream_chunks.value
        want = s.query(sql)
        assert metrics.stream_chunks.value == c0
    diff = mismatch(got, want, sql, 1e-4 if per_chunk else 1e-9)
    assert diff is None, diff


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_rows", [1024, 4096])
def test_streamed_copies_survive_a_slow_fold(cuda, monkeypatch, chunk_rows):
    """The copy-stream race: tiny chunks, a fold slowed on the compute
    stream (``torch.cuda._sleep``), and columns whose value is their chunk
    id.  A pinned slot rewritten before its copy ran, or a device chunk
    handed out again before the fold read it, gives a wrong exact sum."""
    import pyarrow as pa

    from baikaldb_tpu_torch.exec import streaming
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.utils import metrics

    n = 257 * chunk_rows + 77
    cid = np.arange(n, dtype=np.int64) // chunk_rows
    s = Session()
    s.execute("CREATE TABLE r (cid BIGINT, x DOUBLE, k INT)")
    s.load_arrow("r", pa.table({"cid": cid, "x": cid.astype(np.float64),
                                "k": (cid % 7).astype(np.int32)}))
    partial = streaming.StreamRunner._partial

    def slow_partial(self, chunk):
        torch.cuda._sleep(2_000_000)            # ~1 ms on the compute stream
        return partial(self, chunk)

    monkeypatch.setattr(streaming.StreamRunner, "_partial", slow_partial)
    sql = "SELECT k, COUNT(*) n, SUM(cid) s, SUM(x) sx, MAX(cid) mx FROM r GROUP BY k ORDER BY k"
    with _port_flags(streaming_scan=True, streaming_min_rows=1,
                     streaming_chunk_rows=chunk_rows):
        c0 = metrics.stream_chunks.value
        got = s.query(sql)
        assert metrics.stream_chunks.value - c0 == -(-n // chunk_rows)
    want = []
    for k in range(7):
        sel = cid % 7 == k
        want.append({"k": k, "n": int(sel.sum()), "s": int(cid[sel].sum()),
                     "sx": float(cid[sel].sum()), "mx": int(cid[sel].max())})
    assert got == want


# -- observability on the card (obs/flightrec.py, obs/telemetry.py, KILL) ---

@pytest.mark.cuda
def test_device_stats_and_gauges_read_the_card(cuda):
    """device_stats() gives one row a card under the JAX package's keys;
    the device gauges equal torch's reads beside them."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.obs.flightrec import device_stats

    s = Session()
    keep = torch.ones(1 << 20, device=cuda)
    torch.cuda.synchronize()
    rows = device_stats()
    assert [r["device"] for r in rows] == [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    assert rows[0]["bytes_in_use"] == torch.cuda.memory_allocated(0) > 0
    assert rows[0]["peak_bytes_in_use"] >= rows[0]["bytes_in_use"]
    assert rows[0]["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory
    vals = {r["Variable_name"]: float(r["Value"])
            for r in s.query("SHOW STATUS LIKE 'device_hbm_%'")}
    n = torch.cuda.device_count()
    assert vals["device_hbm_in_use_bytes.value"] == sum(
        torch.cuda.memory_allocated(i) for i in range(n))
    assert vals["device_hbm_limit_bytes.value"] == sum(
        torch.cuda.get_device_properties(i).total_memory for i in range(n))
    assert vals["device_hbm_peak_bytes.value"] >= vals["device_hbm_in_use_bytes.value"]
    del keep


@pytest.mark.cuda
def test_killed_streamed_query_leaves_the_card_as_it_found_it(stream_session):
    """A KILL at chunk 5 of a streamed GROUP BY (16 chunks): the query raises
    QueryKilled between two chunks' launches, no stager thread is left, the
    card's allocated memory is back to its level, and the next run gives the
    resident rows with one pass's launches."""
    import gc
    import threading

    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models.parity import mismatch
    from baikaldb_tpu_torch.obs import progress
    from baikaldb_tpu_torch.utils import metrics

    s = stream_session
    sql, per_chunk = STREAM_QUERIES["b"]
    killer = Session(s.db)
    real = progress.QueryProgress.beat
    fired = []

    def beat(self, phase=None, operator=None, **counts):
        real(self, phase, operator, **counts)
        if not fired and self.db is s.db and self.chunk_no == 5 and self.chunks_total:
            fired.append(True)
            th = threading.Thread(target=killer.execute,
                                  args=(f"KILL QUERY {self.conn_id}",))
            th.start()
            th.join(60.0)

    with _port_flags(streaming_scan=True, streaming_min_rows=1 << 18,
                     streaming_chunk_rows=1 << 16):
        s.query(sql)                            # warm: plan and chunk set built
        torch.cuda.synchronize()
        # small tensors of earlier runs wait in reference cycles until the
        # collector's pass: both reads come after one
        gc.collect()
        mem0 = torch.cuda.memory_allocated()
        before = {k: c.value for k, c in gk.LAUNCHES.items()}
        c0 = metrics.stream_chunks.value
        progress.QueryProgress.beat = beat
        try:
            with pytest.raises(progress.QueryKilled):
                s.query(sql)
        finally:
            progress.QueryProgress.beat = real
        torch.cuda.synchronize()
        folded = metrics.stream_chunks.value - c0
        launched = {k: c.value - before[k] for k, c in gk.LAUNCHES.items()
                    if c.value != before[k]}
        assert fired and folded == 6            # chunks 0-5: it lands at chunk 6's beat
        assert launched == {k: n * folded for k, n in per_chunk.items()}
        assert not [t for t in threading.enumerate() if t.name == "stream-prefetch"]
        gc.collect()
        assert torch.cuda.memory_allocated() == mem0
        assert s.db.flightrec.rows()[-1]["status"] == "killed"
        assert progress.PROGRESS.live(s.db) == []
        before = {k: c.value for k, c in gk.LAUNCHES.items()}
        got = s.query(sql)
        torch.cuda.synchronize()
        launched = {k: c.value - before[k] for k, c in gk.LAUNCHES.items()
                    if c.value != before[k]}
    chunks = -(-STREAM_ROWS // (1 << 16))
    assert launched == {k: n * chunks for k, n in per_chunk.items()}
    with _port_flags(streaming_scan=False):
        want = s.query(sql)
    diff = mismatch(got, want, sql, 1e-4)
    assert diff is None, diff


# ----------------------------------------------------------------------
# vectors (ops/vector.py, index/annindex.py, VECTOR columns): the card
# against the CPU.  GEMM scores within rtol 1e-5 (L2: 1e-5 of the squared
# norms it cancels); ranks exact away from near-ties; SQL rows by the parity
# contract; k-means on separated clusters: assignments equal, centroids
# within atol 1e-4.


def _vec_inputs(seed, n=20_000, d=64, q=9):
    rng = np.random.default_rng(seed)
    base = (rng.normal(size=(40, d))[rng.integers(0, 40, n)] * 3
            + rng.normal(size=(n, d))).astype(np.float32)
    return base, (base[rng.integers(0, n, q)] + 0.05).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_vector_gemm_scores_are_float32_and_match_the_cpu(cuda, metric, precision):
    from baikaldb_tpu_torch.ops import vector as tv

    base, q = _vec_inputs(1)
    got = tv._scores(torch.from_numpy(q).to(cuda), torch.from_numpy(base).to(cuda), metric,
                     precision)
    want = tv._scores(torch.from_numpy(q), torch.from_numpy(base), metric, precision)
    assert got.dtype is torch.float32 and got.device.type == "cuda"
    atol = 1e-5 * float((q * q).sum(1).max() + (base * base).sum(1).max()) \
        if metric == "l2" else 1e-5
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=atol)
    if precision == "bf16":
        # products of bf16-rounded inputs in float32: not bf16-rounded scores
        assert (got.to(torch.bfloat16).float() != got).float().mean() > 0.5


@pytest.mark.cuda
def test_vector_topk_ties_take_the_lower_index_first_on_the_card(cuda):
    from baikaldb_tpu_torch.ops import vector as tv

    n = 300_000
    base = torch.zeros((n, 8), device=cuda)
    dup = torch.tensor([n - 1, 7, 123_456, 40, 299_000], device=cuda)
    base[dup, 0] = 1.0                               # five equal nearest rows
    q = torch.zeros((3, 8), device=cuda)
    q[:, 0] = 1.0
    s, idx = tv.brute_force_topk(q, base, None, 8, "l2", "f32")
    assert idx[:, :5].tolist() == [[7, 40, 123_456, 299_000, n - 1]] * 3
    assert idx[:, 5:].tolist() == [[0, 1, 2]] * 3    # then the zero rows, in order
    valid = torch.zeros(n, dtype=torch.bool, device=cuda)
    valid[[11, 5]] = True                            # fewer live rows than k
    s, idx = tv.brute_force_topk(q, base, valid, 4, "ip", "bf16")
    assert idx[0].tolist() == [5, 11, 0, 1] and torch.isneginf(s[:, 2:]).all()


@pytest.mark.cuda
def test_vector_probe_mask_on_the_card_equals_the_broadcast(cuda):
    from baikaldb_tpu_torch.ops import vector as tv

    base, q = _vec_inputs(2)
    cent, assign = tv.kmeans(base, 40, iters=3, device="cpu")
    b, qq = torch.from_numpy(base).to(cuda), torch.from_numpy(q).to(cuda)
    c, a = torch.from_numpy(cent).to(cuda), torch.from_numpy(assign).to(cuda)
    valid = torch.rand(len(base), device=cuda) > 0.1
    got = tv.ivf_topk(qq, b, valid, c, a, 10, 6, "l2", "f32")
    # the JAX package's [q, n, nprobe] broadcast, on the card
    _, probe = tv._topk(tv._scores(qq, c, "l2", "f32"), 6)
    in_probe = (a[None, :, None] == probe[:, None, :]).any(-1) & valid[None, :]
    s = tv._scores(qq, b, "l2", "f32").masked_fill_(~in_probe, float("-inf"))
    want = tv._topk(s, 10)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    cpu = tv.ivf_topk(qq.cpu(), b.cpu(), valid.cpu(), c.cpu(), a.cpu(), 10, 6, "l2", "f32")
    torch.testing.assert_close(got[0].cpu(), cpu[0], rtol=1e-5,
                               atol=1e-5 * float((base * base).sum(1).max() * 2))


@pytest.mark.cuda
def test_vector_kmeans_on_the_card_matches_the_cpu(cuda):
    from baikaldb_tpu_torch.ops import segments as seg
    from baikaldb_tpu_torch.ops import vector as tv

    rng = np.random.default_rng(4)
    centers = rng.normal(size=(4, 16)) * 20
    true = np.repeat(np.arange(4), 1500)
    x = (centers[true] + rng.normal(size=(6000, 16))).astype(np.float32)
    # seed 8 draws one initial centroid in each cluster, so no cluster is
    # split where a last-bit difference of the card's float32 sums could move
    # a row across the split
    seed = 8
    assert len(set(true[np.random.default_rng(seed).choice(6000, 4, replace=False)])) == 4
    before = seg.LAUNCHES["segment_reduce"].value
    gc, ga = tv.kmeans(x, 4, iters=6, seed=seed, device=cuda)
    # one per iteration: the counts (1-D float64 ones over 4 clusters)
    assert seg.LAUNCHES["segment_reduce"].value == before + 6
    cc, ca = tv.kmeans(x, 4, iters=6, seed=seed, device="cpu")
    assert np.array_equal(ga, ca)
    assert len(set(zip(ca.tolist(), true.tolist()))) == 4       # the true clusters
    np.testing.assert_allclose(gc, cc, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_vector_index_on_the_card_matches_the_cpu(cuda):
    from baikaldb_tpu_torch.ops import vector as tv

    base, q = _vec_inputs(3, n=5000)
    out = []
    for dev in (cuda, "cpu"):
        ix = tv.VectorIndex(64, metric="l2", device=dev)
        ix.add(np.arange(5000) * 10, base)
        ix.delete([30, 40])
        out.append(ix.search(q, 5))
    assert np.array_equal(out[0][0], out[1][0])
    assert tv.VectorIndex(4).device.type == "cuda"


def _vector_sessions(cuda):
    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Session

    rng = np.random.RandomState(11)
    centers = rng.randn(32, 16) * 4
    vecs = (centers[rng.randint(0, 32, 8000)] + rng.randn(8000, 16) * 0.5).astype(np.float32)
    out = []
    for dev in (cuda, "cpu"):
        s = Session(device=dev)
        s.execute("CREATE TABLE docs (id BIGINT, tag VARCHAR, emb VECTOR(4))")
        s.execute("INSERT INTO docs VALUES (1, 'a', '[1,0,0,0]'), (2, 'b', '[0,1,0,0]'), "
                  "(3, 'a', '[0.9,0.1,0,0]'), (4, 'b', '[0,0,1,0]'), (5, 'a', NULL)")
        s.execute("CREATE TABLE vt (id BIGINT, tag INT, v VECTOR(16), ANN INDEX a (v))")
        s.load_arrow("vt", pa.table({"id": np.arange(8000), "tag": np.arange(8000) % 10,
                                     "v": pa.FixedSizeListArray.from_arrays(
                                         pa.array(vecs.ravel()), 16)}))
        out.append(s)
    return out, vecs


@pytest.mark.cuda
def test_vector_sql_and_ann_on_the_card_match_the_cpu(cuda):
    from baikaldb_tpu_torch.index import annindex  # noqa: F401 — defines the ann flags
    from baikaldb_tpu_torch.models.parity import mismatch
    from baikaldb_tpu_torch.utils.flags import FLAGS

    prev = int(FLAGS.ann_min_rows)
    FLAGS.set_flag("ann_min_rows", 512)
    try:
        (gpu, cpu), vecs = _vector_sessions(cuda)
        lit = "[" + ",".join(str(float(x)) for x in vecs[17] + 0.01) + "]"
        sqls = [
            "SELECT id, L2_DISTANCE(emb, '[1,0,0,0]') d FROM docs ORDER BY d LIMIT 3",
            "SELECT id, COSINE_DISTANCE(emb, '[1,0.5,0,0]') c, "
            "INNER_PRODUCT(emb, '[1,0.5,0,0]') p FROM docs ORDER BY id",
            f"SELECT id, L2_DISTANCE(v, '{lit}') d FROM vt ORDER BY d LIMIT 10",
            f"SELECT id FROM vt WHERE tag = 3 ORDER BY COSINE_DISTANCE(v, '{lit}') LIMIT 10",
            f"SELECT id FROM vt ORDER BY INNER_PRODUCT(v, '{lit}') DESC LIMIT 10",
            f"SELECT COUNT(*) n FROM vt WHERE L2_DISTANCE(v, '{lit}') < 3",
        ]
        for sql in sqls:
            got = gpu.query(sql)
            assert mismatch(got, cpu.query(sql), sql) is None, sql
            assert got
        ex = f"EXPLAIN SELECT id FROM vt ORDER BY L2_DISTANCE(v, '{lit}') LIMIT 10"
        assert "ann(a nprobe=8)" in gpu.execute(ex).plan_text
        assert gpu.execute(ex).plan_text == cpu.execute(ex).plan_text
    finally:
        FLAGS.set_flag("ann_min_rows", prev)


# -- the mesh ------------------------------------------------------------------

def test_make_mesh_needs_cuda():
    """``make_mesh(n)`` spreads its shards over the CUDA devices and raises
    where there is none; only ``device="cpu"`` makes a CPU mesh."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        assert make_mesh(8).devices == tuple(torch.device("cuda", i % count)
                                             for i in range(8))
        assert Session(mesh=make_mesh(8)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(8)
        with pytest.raises(RuntimeError, match="CUDA"):
            Session(mesh=make_mesh(8))
    assert make_mesh(8, device="cpu").devices == (torch.device("cpu"),) * 8


def _mesh_sessions(card_mesh):
    """TPC-H SF 0.01 in a card mesh session and an 8-shard CPU mesh session."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models import tpch
    from baikaldb_tpu_torch.parallel.mesh import make_mesh

    tables = tpch.generate(scale=0.01, seed=0)
    out = []
    for mesh in (card_mesh, make_mesh(card_mesh.size, device="cpu")):
        s = Session(mesh=mesh)
        for name, ddl in tpch.DDL.items():
            s.execute(ddl)
            s.load_arrow(name, tables[name])
        out.append(s)
    return out


@pytest.fixture(scope="module")
def mesh_pair():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card's mesh needs one")
    from baikaldb_tpu_torch.parallel.mesh import make_mesh

    return _mesh_sessions(make_mesh(8, device="cuda:0"))


MESH_QUERIES = ["q1", "q3", "q5", "q7", "q8", "q9", "q13", "q15", "q18", "q21", "q22",
                "q20_rows"]


def _mesh_query_matches(gpu, cpu, name):
    from baikaldb_tpu_torch.models import tpch
    from baikaldb_tpu_torch.models.parity import mismatch

    sql = {**tpch.QUERIES, **tpch.VARIANTS}[name]
    before = {k: c.value for k, c in gk.LAUNCHES.items()}
    got = gpu.query(sql)
    ran = any(gk.LAUNCHES[k].value != before[k]
              for k in ("filtered_group_sum", "fused_group_aggregate"))
    diff = mismatch(got, cpu.query(sql), sql, 1e-4 if ran else 1e-9)
    assert diff is None, diff


@pytest.mark.cuda
@pytest.mark.parametrize("name", MESH_QUERIES)
def test_mesh_on_the_card_matches_the_cpu_mesh(mesh_pair, name):
    """8 shards on cuda:0 against the 8-shard CPU mesh, same seeded tables."""
    _mesh_query_matches(*mesh_pair, name)


@pytest.mark.cuda
def test_mesh_forced_shuffle_on_the_card_matches_the_cpu_mesh(mesh_pair):
    from baikaldb_tpu_torch.utils.flags import FLAGS

    FLAGS.set_flag("mpp_force_shuffle", True)
    try:
        for name in ("q3", "q5", "q9"):
            _mesh_query_matches(*mesh_pair, name)
    finally:
        FLAGS.set_flag("mpp_force_shuffle", False)


@pytest.mark.cuda
def test_mesh_group_by_launches_the_kernels_on_every_shard(cuda):
    """A dense GROUP BY over 2048 groups on an 8-shard card mesh: K3 and K2
    once a shard (FLOAT SUM/MIN), K1 and K3 once a shard (DOUBLE SUM); the
    rows equal the CPU mesh's."""
    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models.parity import mismatch
    from baikaldb_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(11)
    n = 200_000
    t = pa.table({"g": rng.integers(0, 2048, n, dtype=np.int32),
                  "v": rng.standard_normal(n, dtype=np.float32),
                  "w": rng.standard_normal(n)})
    out = []
    for mesh in (make_mesh(8, device="cuda:0"), make_mesh(8, device="cpu")):
        s = Session(mesh=mesh)
        s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE)")
        s.load_arrow("t", t)
        out.append(s)
    queries = {"SELECT g, COUNT(*) c, SUM(v) s, MIN(v) m FROM t GROUP BY g ORDER BY g":
               {"partition_histogram": 8, "fused_group_aggregate": 8},
               "SELECT g, SUM(w) s, AVG(w) a FROM t GROUP BY g ORDER BY g":
               {"partition_histogram": 8, "filtered_group_sum": 8}}
    for sql, want in queries.items():
        before = {k: c.value for k, c in gk.LAUNCHES.items()}
        got = out[0].query(sql)
        launched = {k: c.value - before[k] for k, c in gk.LAUNCHES.items()
                    if c.value != before[k]}
        assert launched == want, sql
        assert mismatch(got, out[1].query(sql), sql, 1e-4) is None, sql


@pytest.mark.cuda
def test_exchange_counts_from_k3_equal_searchsorted(cuda):
    """The exchange sizes its send buffers from K3's per-destination counts;
    they equal the JAX package's searchsorted counts exactly."""
    import pyarrow as pa

    from baikaldb_tpu_torch.column.batch import ColumnBatch
    from baikaldb_tpu_torch.parallel.shuffle import (_local_repartition,
                                                     partition_key_arrays)
    from baikaldb_tpu_torch.utils.hashing import partition_ids

    rng = np.random.default_rng(12)
    for n, parts in ((1, 8), (100_000, 8), (1_000_003, 8), (65_536, 64)):
        b = ColumnBatch.from_arrow(pa.table({"k": rng.integers(-50, 50_000, n)}), cuda)
        b = b.and_sel(torch.from_numpy(rng.random(n) < 0.7).to(cuda))
        order, counts = _local_repartition(b, ["k"], parts)
        dest = partition_ids(partition_key_arrays(b, ["k"]), parts)
        dest = torch.where(b.sel, dest, parts)
        srt = torch.sort(dest).values
        start = torch.searchsorted(srt, torch.arange(parts + 1, dtype=srt.dtype,
                                                     device=cuda))
        assert counts.tolist() == (start[1:] - start[:-1]).tolist()
        assert torch.equal(dest[order][:int(counts.sum())],
                           srt[:int(counts.sum())])


@pytest.mark.cuda
def test_mesh_across_cards_matches_the_cpu_mesh(cuda):
    """Shards spread over every card (cross-device exchanges and merges)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("one CUDA device: the cross-card mesh needs two or more")
    from baikaldb_tpu_torch.parallel.mesh import make_mesh
    from baikaldb_tpu_torch.utils.flags import FLAGS

    gpu, cpu = _mesh_sessions(make_mesh(8))
    for name in ("q1", "q3", "q9", "q18"):
        _mesh_query_matches(gpu, cpu, name)
    FLAGS.set_flag("mpp_force_shuffle", True)
    try:
        for name in ("q3", "q5"):
            _mesh_query_matches(gpu, cpu, name)
    finally:
        FLAGS.set_flag("mpp_force_shuffle", False)


# -- MVCC: versioned batches on the card --------------------------------------


@pytest.mark.cuda
def test_mvcc_visibility_mask_feeds_every_kernel(cuda):
    """A versioned batch's sel on the card: visibility_mask over int64
    commit / delete stamps ANDed into a WHERE mask, then K1, K2, K3 and the
    segment kernel held against their plain versions under that mask."""
    from baikaldb_tpu_torch.ops import segments as seg
    from baikaldb_tpu_torch.storage import mvcc

    rng = np.random.default_rng(19)
    n, ng, snap = 1_000_003, 2049, 5_000
    cts = rng.integers(0, 10_000, n).astype(np.int64)
    cts[rng.random(n) < 0.3] = 0
    cts[rng.random(n) < 0.01] = mvcc.PENDING
    dts = np.full(n, mvcc.MAX_TS, np.int64)
    dead = rng.random(n) < 0.2
    dts[dead] = cts[dead] + rng.integers(1, 8_000, int(dead.sum()))
    vis = mvcc.visibility_mask(torch.from_numpy(cts).to(cuda), torch.from_numpy(dts).to(cuda),
                               snap)
    want_vis = (cts <= snap) & (dts > snap)
    assert vis.device.type == "cuda" and torch.equal(vis.cpu(), torch.from_numpy(want_vis))
    codes, values, where = _inputs(n, ng, 0.6, 19, cuda)
    mask = where & vis
    p1 = gk.filtered_group_sum_plain(codes, values, mask, ng)
    p2 = gk.fused_group_aggregate_plain(codes, values, mask, ng)
    k1 = gk.filtered_group_sum(codes, values, mask, ng)
    k2 = gk.fused_group_aggregate(codes, values, mask, ng)
    assert torch.equal(gk.partition_histogram(codes, mask, ng),
                       gk.partition_histogram_plain(codes, mask, ng))
    assert torch.equal(k1[0], p1[0]) and torch.equal(k2[0], p2[0])
    torch.testing.assert_close(k1[1], p1[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k2[1], p2[1], rtol=1e-5, atol=1e-5)
    assert torch.equal(k2[2], p2[2]) and torch.equal(k2[3], p2[3])
    gid = torch.where(mask, codes.clamp(0, 16), torch.full_like(codes, 17)).long() % 17
    x = torch.where(mask, values, torch.zeros_like(values))
    before = seg.LAUNCHES["segment_reduce"].value
    got = seg.segment_reduce(x, gid, 17, "sum")
    assert seg.LAUNCHES["segment_reduce"].value == before + 1
    torch.testing.assert_close(got, seg.segment_reduce_plain(x, gid, 17, "sum"),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_mvcc_dml_then_pinned_reads_on_the_card_match_the_cpu(cuda):
    """UPDATE / DELETE / INSERT in a transaction under a pinned reader, on
    a CUDA session and a CPU session: the pinned and the unpinned GROUP BYs
    agree by the parity contract, and the pinned 2049-slot read launches K3
    and K2 over the versioned batch."""
    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.models.parity import mismatch

    rng = np.random.default_rng(23)
    n = 300_000
    data = pa.table({"id": np.arange(n, dtype=np.int64),
                     "g": rng.integers(0, 2048, n).astype(np.int32),
                     "g16": rng.integers(0, 16, n).astype(np.int32),
                     "v": rng.standard_normal(n).astype(np.float32),
                     "w": rng.standard_normal(n)})
    pairs = []
    for dev in ("cuda", "cpu"):
        db = Database(dev)
        reader, writer = Session(db), Session(db)
        writer.execute("CREATE TABLE t (id BIGINT, g INT, g16 INT, v FLOAT, w DOUBLE, "
                       "PRIMARY KEY (id))")
        writer.load_arrow("t", data)
        reader.execute("SET SNAPSHOT = 'now'")
        for q in ("BEGIN", "DELETE FROM t WHERE g = 5", "UPDATE t SET v = v + 1, w = w + 1 "
                  "WHERE g = 7", "INSERT INTO t VALUES (900001, 7, 3, 0.5, 0.25)", "COMMIT"):
            writer.execute(q)
        pairs.append((reader, writer))
    queries = {"SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > 0.5 "
               "GROUP BY g16 ORDER BY g16": 1e-9,
               "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > 0.5 "
               "GROUP BY g ORDER BY g": 1e-4,
               "SELECT g, SUM(w), AVG(w) FROM t WHERE w > -1 GROUP BY g ORDER BY g": 1e-4}
    (gpu_r, gpu_w), (cpu_r, cpu_w) = pairs
    for sql, rtol in queries.items():
        for a, b in ((gpu_r, cpu_r), (gpu_w, cpu_w)):
            diff = mismatch(a.query(sql), b.query(sql), sql, rtol)
            assert diff is None, diff
    fused = list(queries)[1]
    before = {k: c.value for k, c in gk.LAUNCHES.items()}
    pinned = gpu_r.query(fused)
    torch.cuda.synchronize()
    ran = {k: c.value - before[k] for k, c in gk.LAUNCHES.items() if c.value != before[k]}
    assert ran == {"partition_histogram": 1, "fused_group_aggregate": 1}
    assert pinned != gpu_w.query(fused)
    store = gpu_r.db.stores["default.t"]
    batch, versions = store.versioned_batch(gpu_r._snapshot[1])
    assert batch.sel.device.type == "cuda" and versions > 0


# -- the lane axis (the batched dispatcher's tick) ----------------------------

LANE_CASES = [  # (n, num_groups, lanes, seed)
    (100_003, 2049, 8, 30), (65_537, 37, 64, 31), (4097, 4096, 3, 32), (6, 5, 2, 33),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,ng,G,seed", LANE_CASES)
def test_lane_kernels_match_their_plain_versions(cuda, n, ng, G, seed):
    """K1-K3 with a lane axis: one launch over G masks, each lane equal to
    the one-lane plain function on its mask (an all-dead lane and a lane
    with a NaN group among them)."""
    from baikaldb_tpu_torch.ops import segments as seg

    codes, values, _ = _inputs(n, ng, 0.5, seed, cuda)
    mask = torch.rand((G, n), device=cuda, generator=torch.Generator(cuda).manual_seed(seed)) < 0.6
    mask[0] = False
    if n > 10:
        values[3] = float("nan")
        mask[1, 3] = True
    before = {k: c.value for k, c in gk.LANE_LAUNCHES.items()}
    k1 = gk.filtered_group_sum_lanes(codes, values.double(), mask, ng)
    k2 = gk.fused_group_aggregate_lanes(codes, values, mask, ng)
    k3 = gk.partition_histogram_lanes(codes, mask, ng)
    torch.cuda.synchronize()
    assert {k: c.value - before[k] for k, c in gk.LANE_LAUNCHES.items()} == \
        {"filtered_group_sum_lanes": 1, "fused_group_aggregate_lanes": 1,
         "partition_histogram_lanes": 1}
    for g in range(G):
        p1 = gk.filtered_group_sum_plain(codes, values.double(), mask[g], ng)
        p2 = gk.fused_group_aggregate_plain(codes, values, mask[g], ng)
        assert torch.equal(k3[g], gk.partition_histogram_plain(codes, mask[g], ng))
        assert torch.equal(k1[0][g], p1[0]) and torch.equal(k2[0][g], p2[0])
        torch.testing.assert_close(k1[1][g], p1[1], rtol=1e-5, atol=1e-5, equal_nan=True)
        torch.testing.assert_close(k2[1][g], p2[1], rtol=1e-5, atol=1e-5, equal_nan=True)
        assert _same(k2[2][g], p2[2]) and _same(k2[3][g], p2[3])
    S = min(ng, 17)
    gid = torch.remainder(codes, S).to(torch.int32)
    for x, op in ((values.double(), "sum"), (values, "min"), (values, "max"),
                  (torch.ones(n, dtype=torch.int64, device=cuda), "sum")):
        got = seg.segment_reduce_lanes(x, gid, mask, S, op)
        for g in range(G):
            ids = torch.where(mask[g], gid, S)
            # bit for bit the one-lane kernel (the same plan), and its plain version
            assert _same(got[g], seg.segment_reduce(x, ids, S, op))
            want = seg.segment_reduce_plain(x, ids, S, op)
            if op == "sum" and x.dtype.is_floating_point:
                torch.testing.assert_close(got[g], want, rtol=1e-12, atol=1e-9, equal_nan=True)
            else:
                assert _same(got[g], want)


def _lane_edges(fit: int) -> list:
    """Lane counts around a tile of ``fit`` lanes and the ticks' 64."""
    return sorted({1, max(1, fit - 1), fit + 1, 63, 64, 65})


@pytest.mark.cuda
@pytest.mark.parametrize("mode,S", [("private", 17), ("warp", 2048), ("block", 16384)])
def test_segment_lane_tiles_equal_the_one_lane_kernel_bit_for_bit(cuda, mode, S):
    """Every lane of the lane-tile kernel equals the one-lane kernel on
    ``where(mask[L], gid, S)`` bit for bit, in each table layout, at lane
    counts around the tile's edges, over a ragged row count with an all-dead
    lane and NaN in MIN/MAX.  The warp and block layouts add float64 sums
    with shared atomics in no fixed order, so their float64 values there are
    whole numbers (every order gives the same sum); the private layout adds
    in a fixed order and takes any values."""
    from baikaldb_tpu_torch.ops import segments as seg

    rng = np.random.default_rng(S)
    n = 100_003
    gid = torch.from_numpy(rng.integers(-1, S + 1, n).astype(np.int32)).to(cuda)
    vals = rng.normal(size=n) * 1e3
    f64 = torch.from_numpy(vals if mode == "private" else np.round(vals)).to(cuda)
    f32 = torch.from_numpy(vals.astype(np.float32)).to(cuda)
    f32[7] = float("nan")
    f32[8] = -float("nan")
    cases = [(f64, "sum"), (torch.ones(n, dtype=torch.int64, device=cuda), "sum"),
             (f32, "min"), (f32, "max"), (torch.from_numpy(rng.integers(-9, 9, n)).to(cuda),
                                          "max")]
    for x, op in cases:
        plan = seg.lane_plan(op, x.dtype, S, 64, mode)
        assert plan.layout == mode
        for G in _lane_edges(plan.fit):
            mask = torch.from_numpy(rng.random((G, n)) < 0.6).to(cuda)
            mask[G // 2] = False                 # an all-dead lane
            before = seg.LANE_LAUNCHES["segment_reduce_lanes"].value
            got = seg.segment_reduce_lanes(x, gid, mask, S, op, mode=mode)
            torch.cuda.synchronize()
            assert seg.LANE_LAUNCHES["segment_reduce_lanes"].value == before + 1
            for g in range(G):
                one = seg.segment_reduce(x, torch.where(mask[g], gid, S), S, op, mode=mode)
                assert _same(got[g].double(), one.double()), (op, x.dtype, G, g)
            for g in (0, G // 2, G - 1):
                _seg_close(op, x, torch.where(mask[g], gid, S), S, got[g],
                           seg.segment_reduce_plain(x, torch.where(mask[g], gid, S), S, op))


@pytest.mark.cuda
def test_lane_plans_match_the_kernels_tables(cuda):
    """The Python lane plans' table bytes are the ones the kernels build."""
    from baikaldb_tpu_torch.ops import segments as seg

    slib = gk.library(seg.SOURCE, seg._bind)
    for op, opc in seg._OPS.items():
        for dtype, tcode in seg._TCODE.items():
            for S in (1, 17, 64, 512, 2048, 4096, 16384):
                for mode in ("auto", "warp", "block"):
                    assert slib.bk_seg_table_bytes(opc, tcode, S, seg.MODES[mode]) == \
                        seg.lane_plan(op, dtype, S, 8, mode).table_bytes
    lib = gk._library()
    for kind in (gk.KIND_HIST, gk.KIND_SUM):
        for ng in (1, 17, 2049, 4096):
            assert lib.bk_group_agg_lane_table_bytes(kind, ng) == \
                gk.lane_plan(kind, ng, 8).table_bytes
    for ng in (1, 17, 37, 2049, 4096):
        assert lib.bk_fused_agg_lane_table_bytes(ng) == gk.lane_plan(gk.KIND_AGG, ng, 8).table_bytes
    assert lib.bk_fused_agg_lane_max() == gk.AGG_LANE_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [37, 2049, 4096])
def test_k1_k3_lane_tiles_match_plain_at_tile_edges(cuda, ng):
    """K1 and K3 over lane counts around their tiles' edges, on a ragged row
    count (most lanes' mask rows are not 4-byte aligned) and an aligned one:
    counts exact, sums within 1e-5 (float64 partials in another order,
    rounded once)."""
    rng = np.random.default_rng(ng)
    fits = {gk.lane_plan(k, ng, 1).fit for k in (gk.KIND_SUM, gk.KIND_HIST)}
    for n in (100_003, 65_536):
        codes, values, _ = _inputs(n, ng, 0.5, n, cuda)
        for G in sorted(set().union(*(_lane_edges(f) for f in fits))):
            mask = torch.from_numpy(rng.random((G, n)) < 0.6).to(cuda)
            mask[G // 2] = False
            k1 = gk.filtered_group_sum_lanes(codes, values.double(), mask, ng)
            k3 = gk.partition_histogram_lanes(codes, mask, ng)
            for g in range(G):
                p1 = gk.filtered_group_sum_plain(codes, values.double(), mask[g], ng)
                assert torch.equal(k3[g], gk.partition_histogram_plain(codes, mask[g], ng))
                assert torch.equal(k1[0][g], p1[0])
                torch.testing.assert_close(k1[1][g], p1[1], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_k1_k3_lane_tiles_count_exactly_above_2_pow_24(cuda):
    """One group of 2^24 + 5 rows in every lane of two tiles, on an odd row
    count: the int64 counts are exact in every lane."""
    n = (1 << 24) + 5
    codes = torch.zeros(n, dtype=torch.int32, device=cuda)
    G = gk.lane_plan(gk.KIND_HIST, 2, 1).tile + 3
    mask = torch.ones((G, n), dtype=torch.bool, device=cuda)
    mask[-1, :10] = False
    want = [n] * (G - 1) + [n - 10]
    ones = torch.ones(n, device=cuda)
    assert gk.filtered_group_sum_lanes(codes, ones, mask, 2)[0][:, 0].tolist() == want
    assert gk.partition_histogram_lanes(codes, mask, 2)[:, 0].tolist() == want
    # the float64 sums round once to float32
    assert gk.filtered_group_sum_lanes(codes, ones, mask, 2)[1][:, 0].tolist() == \
        torch.tensor(want, dtype=torch.float64).float().tolist()


def _k2_lanes_match(codes, values, mask, ng, got, where=""):
    """Every lane of K2's lane kernel against the one-lane kernel and the
    plain version on its mask: counts, MIN and MAX exact (NaN equal), sums
    within 1e-5 * sum|v| of the lane's group."""
    for g in range(mask.shape[0]):
        one = gk.fused_group_aggregate(codes, values, mask[g], ng)
        plain = gk.fused_group_aggregate_plain(codes, values, mask[g], ng)
        for k in (0, 2, 3):
            assert _same(got[k][g], one[k]) and _same(got[k][g], plain[k]), (where, g, k)
        live = mask[g] & (codes >= 0) & (codes < ng)
        sabs = torch.zeros(ng + 1, dtype=torch.float64, device=codes.device)
        sabs.index_add_(0, torch.where(live, codes, ng).long(),
                        values.double().abs().nan_to_num(0.0))
        ok = plain[1].isfinite()
        assert _same(got[1][g][~ok], plain[1][~ok]), (where, g)
        d = (got[1][g][ok].double() - plain[1][ok].double()).abs()
        assert bool((d <= 1e-5 * sabs[:ng][ok]).all()), (where, g, float(d.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [37, 2049, 4096])
def test_k2_lane_tiles_match_the_one_lane_kernel_at_tile_edges(cuda, ng):
    """K2's lane tile over lane counts around its fit and 63-65, on a ragged
    row count (most lanes' mask rows are not 4-byte aligned) and an aligned
    one, with an all-dead lane and NaN of either sign in live rows: one
    launch, every lane equal to the one-lane kernel and the plain version."""
    rng = np.random.default_rng(ng + 12)
    fit = gk.lane_plan(gk.KIND_AGG, ng, 1).fit
    for n in (100_003, 65_536):
        codes, values, _ = _inputs(n, ng, 0.5, n + ng, cuda)
        values.view(torch.int32)[7:9] = torch.tensor([0x7FC00000, -0x00400000], device=cuda,
                                                     dtype=torch.int32)
        for G in _lane_edges(fit):
            mask = torch.from_numpy(rng.random((G, n)) < 0.6).to(cuda)
            mask[G // 2] = False
            mask[:, 7:9] = True
            before = gk.LANE_LAUNCHES["fused_group_aggregate_lanes"].value
            got = gk.fused_group_aggregate_lanes(codes, values, mask, ng)
            torch.cuda.synchronize()
            assert gk.LANE_LAUNCHES["fused_group_aggregate_lanes"].value == before + 1
            _k2_lanes_match(codes, values, mask, ng, got, (n, G))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "sparse", "skewed", "mixed"])
def test_k2_lane_tiles_match_on_dense_sparse_and_skewed_masks(cuda, kind):
    """K2's lane kernel over dense masks, sparse ones, every code in one slot
    and all of these in one call (a dense first half with a stretch of one
    slot, a sparse second half): every forced tile from 1 to the fit equals
    the one-lane kernel."""
    rng = np.random.default_rng({"dense": 1, "sparse": 2, "skewed": 3, "mixed": 4}[kind])
    n, ng, G = 300_007, 2049, 9
    codes = rng.integers(0, ng, n).astype(np.int32)
    values = rng.normal(size=n).astype(np.float32)
    live = rng.random((G, n))
    if kind == "dense":
        mask = live < 0.6
    elif kind == "sparse":
        mask = live < 0.01
    elif kind == "skewed":
        codes[:] = 3
        mask = live < 0.6
    else:
        mask = live < np.where(np.arange(n) < n // 2, 0.6, 0.01)
        codes[50_000:80_000] = 11
    c, v, m = (torch.from_numpy(a).to(cuda) for a in (codes, values, mask))
    for tile in range(1, gk.lane_plan(gk.KIND_AGG, ng, G).fit + 1):
        got = gk._launch_agg_lanes(c, v, m, ng, tile)
        torch.cuda.synchronize()
        _k2_lanes_match(c, v, m, ng, got, (kind, tile))


@pytest.mark.cuda
def test_k2_lane_tiles_count_exactly_above_2_pow_24(cuda):
    """One group of 2^24 + 5 rows in every lane of two tiles of K2's lane
    kernel, on an odd row count: the int64 counts are exact in every lane,
    and the float64 sums of ones round once to float32."""
    n = (1 << 24) + 5
    codes = torch.zeros(n, dtype=torch.int32, device=cuda)
    G = gk.lane_plan(gk.KIND_AGG, 2, 1).fit + 3
    mask = torch.ones((G, n), dtype=torch.bool, device=cuda)
    mask[-1, :10] = False
    want = [n] * (G - 1) + [n - 10]
    counts, sums, mins, maxs = gk.fused_group_aggregate_lanes(codes, torch.ones(n, device=cuda),
                                                              mask, 2)
    assert counts[:, 0].tolist() == want and counts[:, 1].tolist() == [0] * G
    assert sums[:, 0].tolist() == torch.tensor(want, dtype=torch.float64).float().tolist()
    assert mins[:, 0].tolist() == maxs[:, 0].tolist() == [1.0] * G


@pytest.mark.cuda
def test_concurrent_group_on_the_card_matches_serial_rows(cuda):
    """D-a (chip_smoke.py phase 12) from 8 clients: the tick launches the
    lane segment kernel, and every client's rows equal its serial run bit
    for bit."""
    import threading
    import time

    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.ops import segments as seg
    from baikaldb_tpu_torch.utils import metrics
    from baikaldb_tpu_torch.utils.flags import FLAGS

    rng = np.random.default_rng(41)
    n = 400_000
    db = Database("cuda")
    boot = Session(db)
    boot.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
    boot.load_arrow("t", pa.table({"g": rng.integers(0, 2048, n).astype(np.int32),
                                   "v": rng.standard_normal(n).astype(np.float32),
                                   "w": rng.standard_normal(n),
                                   "g16": rng.integers(0, 16, n).astype(np.int32)}))
    sqls = [f"SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > {x / 10} "
            "GROUP BY g16" for x in range(-8, 8)]
    prev = (FLAGS.streaming_scan, FLAGS.batch_dispatch_tick_ms)
    FLAGS.set_flag("streaming_scan", False)
    FLAGS.set_flag("batch_dispatch_tick_ms", 50.0)
    try:
        serial = {q: boot.execute(q).arrow for q in sqls}
        g0 = metrics.batched_groups.value
        l0 = seg.LANE_LAUNCHES["segment_reduce_lanes"].value
        got, errs = {}, []
        start = threading.Barrier(8)

        def worker(mine):
            s = Session(db)
            start.wait()
            for q in mine:
                try:
                    got[q] = s.execute(q).arrow
                except Exception as e:      # noqa: BLE001 — re-raised below
                    errs.append(e)

        # each inline run holds 20 ms longer, so the first arrival is still
        # in flight when the others queue behind it
        real = Session._run_plan
        Session._run_plan = lambda self, plan, batches: (time.sleep(0.02),
                                                         real(self, plan, batches))[1]
        ts = [threading.Thread(target=worker, args=(sqls[i::8],)) for i in range(8)]
        try:
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        finally:
            Session._run_plan = real
        if errs:
            raise errs[0]
    finally:
        FLAGS.set_flag("streaming_scan", prev[0])
        FLAGS.set_flag("batch_dispatch_tick_ms", prev[1])
    ticks = metrics.batched_groups.value - g0
    assert ticks >= 1
    assert seg.LANE_LAUNCHES["segment_reduce_lanes"].value - l0 == 8 * ticks
    for q in sqls:
        assert got[q].equals(serial[q]), q


# -- partitions, global indexes and MATCH on the card -----------------------

def _partitioned_sessions(rows: int, seed: int):
    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Session

    rng = np.random.default_rng(seed)
    data = pa.table({"g": rng.integers(0, 2048, rows, dtype=np.int32),
                     "v": rng.standard_normal(rows, dtype=np.float32),
                     "w": rng.standard_normal(rows),
                     "g16": rng.integers(0, 16, rows, dtype=np.int32)})
    ddl = ("CREATE TABLE tp (g INT, v FLOAT, w DOUBLE, g16 INT) PARTITION BY RANGE (g) ("
           + ", ".join(f"PARTITION p{i} VALUES LESS THAN ({256 * (i + 1)})" for i in range(7))
           + ", PARTITION p7 VALUES LESS THAN MAXVALUE)")
    out = []
    for dev in ("cuda", "cpu"):
        s = Session(device=dev)
        s.execute("SET GLOBAL streaming_scan = 0")
        s.execute(ddl)
        s.load_arrow("tp", data)
        out.append(s)
    return out, data


@pytest.mark.cuda
@pytest.mark.parametrize("q,launches", [
    ("SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM tp WHERE v*2+1 > 0.5 "
     "AND g >= 512 AND g < 1024 GROUP BY g16 ORDER BY g16", {"segment_reduce": 8}),
    ("SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM tp WHERE v*2+1 > 0.5 "
     "AND g >= 512 AND g < 1024 GROUP BY g ORDER BY g",
     {"partition_histogram": 1, "fused_group_aggregate": 1}),
    ("SELECT g, SUM(w), AVG(w) FROM tp WHERE w > -1 AND g >= 512 AND g < 1024 "
     "GROUP BY g ORDER BY g", {"filtered_group_sum": 1, "partition_histogram": 1}),
])
def test_pruned_query_launches_each_kernel_once_over_the_pruned_batch(cuda, q, launches):
    """A pruned GROUP BY on the card: EXPLAIN's partition line, the rows of
    the CPU session (rtol 1e-4 for the float32 sums), and each kernel of its
    path launched once, over the kept partitions' batch."""
    from baikaldb_tpu_torch.models.parity import mismatch
    from baikaldb_tpu_torch.ops import segments as seg
    from baikaldb_tpu_torch.utils.flags import FLAGS

    prev = FLAGS.streaming_scan
    (card, cpu), data = _partitioned_sessions(300_000, 4)
    try:
        assert "access=partition(5/8 partitions pruned)" in card.execute("EXPLAIN " + q).plan_text
        counters = {**gk.LAUNCHES, **seg.LAUNCHES}
        before = {k: c.value for k, c in counters.items()}
        got = card.query(q)
        torch.cuda.synchronize()
        ran = {k: c.value - before[k] for k, c in counters.items() if c.value != before[k]}
        assert ran == launches
        assert mismatch(got, cpu.query(q), q, rtol=1e-4) is None
        g = data.column("g").to_numpy()
        batches = [b for k, (_, b) in card._access_batches.items() if k[2] == "part"]
        assert [len(b) for b in batches] == [int(((g >= 512) & (g < 1280)).sum())]   # p2-p4
        assert batches[0].device.type == "cuda"
    finally:
        FLAGS.set_flag("streaming_scan", int(prev))


@pytest.mark.cuda
def test_match_gathers_relevance_by_code_on_the_card(cuda):
    from baikaldb_tpu_torch.column.batch import ColumnBatch
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.expr.ast import Call, ColRef, Lit
    from baikaldb_tpu_torch.expr.compile import eval_output
    import pyarrow as pa

    t = pa.table({"body": ["special requests", "deposits", None, "special deposits",
                           "requests special requests"]})
    outs = []
    for dev in (cuda, torch.device("cpu")):
        b = ColumnBatch.from_arrow(t, dev)
        c = eval_output(Call("match_against", (ColRef("body"), Lit("special requests"),
                                                Lit(False))), b)
        assert c.data.device.type == dev.type and c.data.dtype == torch.float32
        outs.append(c.data.cpu())
    assert torch.equal(outs[0], outs[1]) and outs[0][0] > 0 and outs[0][1] == 0
    rows = []
    for dev in ("cuda", "cpu"):
        s = Session(device=dev)
        s.execute("CREATE TABLE o (k BIGINT, c VARCHAR(40))")
        s.load_arrow("o", t.append_column("k", pa.array(range(5), pa.int64())).select(["k", "body"])
                     .rename_columns(["k", "c"]))
        rows.append(s.query("SELECT k, MATCH(c) AGAINST('+special -deposits' IN BOOLEAN MODE) "
                            "AS s FROM o ORDER BY s DESC, k"))
    assert rows[0] == rows[1]


@pytest.mark.cuda
def test_global_index_lookup_on_the_card(cuda):
    from baikaldb_tpu_torch.exec.session import Session

    rows = []
    for dev in ("cuda", "cpu"):
        s = Session(device=dev)
        s.execute("CREATE TABLE u (id BIGINT, k BIGINT, c VARCHAR(8), PRIMARY KEY (id), "
                  "GLOBAL INDEX gk (k))")
        s.execute("INSERT INTO u VALUES " + ", ".join(f"({i}, {i % 97}, 'c{i}')"
                                                      for i in range(2000)))
        assert "access=global_index(gk:k)" in s.execute(
            "EXPLAIN SELECT id, c FROM u WHERE k = 5").plan_text
        s.execute("UPDATE u SET k = 5 WHERE id = 3")
        s.execute("DELETE FROM u WHERE id = 5")
        rows.append(s.query("SELECT id, c FROM u WHERE k = 5 ORDER BY id"))
        back = s.query("SELECT k, id FROM `__gidx__u__gk` WHERE k = 5 ORDER BY id")
        assert [r["id"] for r in back] == [r["id"] for r in rows[-1]]
    assert rows[0] == rows[1] and 3 in [r["id"] for r in rows[0]]


def _lifecycle_table(s, n=300_000, seed=14):
    """``t (g INT, v FLOAT, w DOUBLE, g16 INT)`` of seeded rows: g over 2048
    slots (K1-K3 on the card), g16 over 16 (the segment kernel)."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
    s.load_arrow("t", pa.table({"g": rng.integers(0, 2048, n, dtype=np.int32),
                                "v": rng.standard_normal(n, dtype=np.float32),
                                "w": rng.standard_normal(n),
                                "g16": rng.integers(0, 16, n, dtype=np.int32)}))


def _all_launches():
    from baikaldb_tpu_torch.ops import segments as seg

    return {**{k: c.value for k, c in gk.LAUNCHES.items()},
            **{k: c.value for k, c in seg.LAUNCHES.items()}}


def _moved(before):
    return {k: v - before[k] for k, v in _all_launches().items() if v != before[k]}


def _close_rollup_rows(got, want, rtol, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert list(a) == list(b)
        for k in b:
            if isinstance(b[k], float):
                assert a[k] == pytest.approx(b[k], rel=rtol, abs=atol), (k, a, b)
            else:
                assert a[k] == b[k], (k, a, b)


@pytest.mark.cuda
def test_rollup_refresh_on_the_card_matches_the_cpu(cuda):
    """A rollup's refresh is a GROUP BY over the base table: on the card it
    launches the group kernels; its answers equal the port on the CPU
    (FLOAT sums within rtol 1e-4, or 2e-3 absolute near zero), before and
    after a write."""
    from baikaldb_tpu_torch.exec.session import Session

    sql = {"g": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t GROUP BY g ORDER BY g",
           "g16": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t GROUP BY g16 "
                  "ORDER BY g16"}
    out, moved = {}, {}
    for dev in ("cuda", "cpu"):
        s = Session(device=dev)
        _lifecycle_table(s)
        # FLOAT measures: a DOUBLE MIN / MAX would send the whole refresh to
        # the scatter (the kernels' gate)
        s.execute("ALTER TABLE t ADD ROLLUP r_g (g, AGGREGATE(v))")
        s.execute("ALTER TABLE t ADD ROLLUP r_g16 (g16, AGGREGATE(v))")
        for k, q in sql.items():
            assert f"__rollup_t_r_{k}" in s.execute("EXPLAIN " + q).plan_text
            before = _all_launches()
            out[dev, k] = s.query(q)
            moved[dev, k] = _moved(before)
        s.execute("INSERT INTO t VALUES " + ", ".join(f"({i}, {i / 7}, {i / 3}, {i % 16})"
                                                      for i in range(1000)))
        out[dev, "after"] = s.query(sql["g"])
    # a group's FLOAT sum near zero is held to the kernels' 1e-5 * sum|v|:
    # ~150 standard-normal rows a group of g give sum|v| ~ 120
    for k in ("g", "g16", "after"):
        _close_rollup_rows(out["cuda", k], out["cpu", k], 1e-4, 2e-3)
    assert moved["cuda", "g"].get("fused_group_aggregate", 0) >= 1
    assert moved["cuda", "g"].get("partition_histogram", 0) >= 1
    assert moved["cuda", "g16"].get("segment_reduce", 0) >= 1
    assert not moved["cpu", "g"] and not moved["cpu", "g16"]


@pytest.mark.cuda
def test_view_answers_on_the_card_match_the_cpu(cuda):
    """A view's seed, group rescan and re-seed run on the card (the group
    kernels); its answers equal the CPU port's and ``matview_answer = 0`` bit
    for bit after inserts, an update, an update that moves rows off a group's
    MIN (one group rescan) and a bulk delete (a re-seed), each counted on the
    view itself."""
    from baikaldb_tpu_torch.exec.session import Session

    q = "SELECT g16, COUNT(*), SUM(g), MIN(g), MAX(g) FROM t GROUP BY g16 ORDER BY g16"
    # (statement, (group rescans, re-seeds) its fold makes)
    steps = [("INSERT INTO t VALUES " + ", ".join(f"({i}, 0.5, 0.5, {i % 16})"
                                                  for i in range(3000, 3400)), (0, 0)),
             ("UPDATE t SET g = g + 1 WHERE g = 7", (0, 0)),
             ("UPDATE t SET g = g + 1 WHERE g = 0 AND g16 = 5", (1, 0)),
             ("DELETE FROM t WHERE g >= 2000", (0, 1))]
    out = {}
    for dev in ("cuda", "cpu"):
        s = Session(device=dev)
        _lifecycle_table(s, n=100_000)
        s.execute(f"CREATE MATERIALIZED VIEW mv AS {q.split(' ORDER BY')[0]}")
        mv = s.db.matviews.get("default", "mv")
        calls = {"_rescan_group": 0, "_rebuild": 0}
        for name in calls:
            def counted(*a, _fn=getattr(mv, name), _name=name, **kw):
                calls[_name] += 1
                return _fn(*a, **kw)
            setattr(mv, name, counted)
        got = [s.query(q)]
        for st, refolds in steps:
            before = (calls["_rescan_group"], calls["_rebuild"])
            s.execute(st)
            got.append(s.query(q))
            assert (calls["_rescan_group"] - before[0], calls["_rebuild"] - before[1]) == refolds
            s.execute("SET GLOBAL matview_answer = 0")
            try:
                assert s.query(q) == got[-1]
            finally:
                s.execute("SET GLOBAL matview_answer = 1")
        out[dev] = got
        rescans = s.query("SELECT rescans FROM information_schema.materialized_views")
        assert rescans[0]["rescans"] == 3           # the seed, the group, the re-seed
    assert out["cuda"] == out["cpu"]


# -- the radix join, the presort and a fleet-bound session on the card -------

@pytest.mark.cuda
@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_radix_join_on_the_card_matches_the_cpu_and_the_sort_join(cuda, how):
    """ops/radix.py's bucket ids bit for bit and radix_join's rows exactly
    (as multisets) on the card against the CPU, with NULL keys, dead rows,
    duplicates and one skewed key."""
    from baikaldb_tpu_torch.column.batch import ColumnBatch
    from baikaldb_tpu_torch.ops import join as tjoin
    from baikaldb_tpu_torch.ops import radix

    rng = np.random.default_rng(16)
    keys = rng.integers(-(1 << 62), 1 << 62, 50_000, dtype=np.int64)
    for nb in (2, 64, 1024):
        assert torch.equal(radix.bucket_of(torch.from_numpy(keys).to(cuda), nb).cpu(),
                           radix.bucket_of(torch.from_numpy(keys), nb))
    pk = rng.integers(0, 5000, 40_000).astype(np.int64)
    bk = rng.integers(0, 6000, 30_000).astype(np.int64)
    bk[:3000] = 77                                   # past 4x the average bucket
    state = {"p": ({"pk": (pk, rng.random(40_000) > 0.05, "int64", None),
                    "pv": (np.arange(40_000, dtype=np.int64), None, "int64", None)},
                   rng.random(40_000) > 0.1),
             "b": ({"bk": (bk, rng.random(30_000) > 0.05, "int64", None),
                    "bv": (np.arange(30_000, dtype=np.int64) * 3, None, "int64", None)},
                   rng.random(30_000) > 0.1)}
    out = {}
    for dev in (cuda, "cpu"):
        p, b = (ColumnBatch.from_numpy(tuple(c), list(c.values()), sel=sel, device=dev)
                for c, sel in state.values())
        got, total, width = tjoin.radix_join(p, ["pk"], b, ["bk"], how=how, n_buckets=256)
        sort, sort_total = tjoin.join(p, ["pk"], b, ["bk"], how=how)
        def canon(batch):
            return sorted((tuple(r.values()) for r in batch.to_pylist()),
                          key=lambda r: tuple((v is None, v or 0) for v in r))
        rows = canon(got)
        assert rows == canon(sort)
        out[str(dev)] = (rows, total, width)
        assert total == sort_total
    bvalid, bsel = state["b"][0]["bk"][1], state["b"][1]
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][2] >= int(((bk == 77) & bvalid & bsel).sum())   # the skewed bucket


@pytest.mark.cuda
def test_presort_on_the_card_matches_the_stripped_run_and_the_cpu(cuda):
    """A sorted GROUP BY and an EXISTS-with-<> over a whole table take the
    host permutation on the card (its device copy is cached per version),
    and give the rows of a run without it and of the CPU session."""
    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Session

    rng = np.random.default_rng(3)
    n = 200_000
    data = pa.table({"ok": pa.array(rng.integers(1, 2_000_000, n), pa.int32()),
                     "sk": pa.array(rng.integers(1, 1000, n), pa.int32()),
                     "qty": rng.integers(1, 50, n).astype(np.float64),
                     "flag": rng.integers(0, 2, n).astype(np.int64)})
    sqls = ["SELECT ok, sk, SUM(qty) s, COUNT(*) c FROM l1 WHERE flag = 1 "
            "GROUP BY ok, sk ORDER BY ok, sk LIMIT 500",
            "SELECT COUNT(*) c FROM l1 a WHERE flag = 1 AND EXISTS (SELECT 1 FROM l1 b "
            "WHERE b.ok = a.ok AND b.sk <> a.sk)"]
    out = {}
    for dev in ("cuda", "cpu"):
        s = Session(device=dev)
        s.execute("CREATE TABLE l1 (ok INT, sk INT, qty DOUBLE, flag BIGINT)")
        s.load_arrow("l1", data)
        staged = []
        orig = s._collect_batches

        def spy(plan, _orig=orig):
            b, k, full = _orig(plan)
            staged.extend(kk for kk in b if str(kk).startswith("__presort__"))
            return b, k, full
        s._collect_batches = spy
        got = [s.query(q) for q in sqls]
        del s._collect_batches
        assert len(staged) == 2
        perm = s.db.stores["default.l1"].presort_order(
            "agg", ("ok", "sk"), s.db.stores["default.l1"].version)
        assert perm.device.type == torch.device(dev).type

        def strip(plan, _orig=orig):
            b, k, full = _orig(plan)
            return {kk: v for kk, v in b.items() if not str(kk).startswith("__presort__")}, k, full
        s._collect_batches = strip
        assert [s.query(q) for q in sqls] == got
        out[dev] = got
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
def test_fleet_bound_group_by_on_the_card_launches_the_kernels(cuda):
    """A Database over a 3-store fleet: (a)-(c)'s GROUP BYs over a table
    replicated in regions launch K1-K3 and the segment kernel on the card
    and equal a CPU session's rows over the same fleet's replicas, before
    and after a leader kill and a rebuild from the replicas."""
    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.meta.service import MetaService
    from baikaldb_tpu_torch.raft.fleet import StoreFleet

    rng = np.random.default_rng(16)
    n = 100_000
    ddl = "CREATE TABLE t (id BIGINT PRIMARY KEY, g INT, v FLOAT, w DOUBLE, g16 INT)"
    sql = {"a": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > 0.5 "
                "GROUP BY g16 ORDER BY g16",
           "b": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > 0.5 "
                "GROUP BY g ORDER BY g",
           "c": "SELECT g, SUM(w), AVG(w) FROM t WHERE w > -1 GROUP BY g ORDER BY g"}
    want = {"a": {"segment_reduce": 8},
            "b": {"partition_histogram": 1, "fused_group_aggregate": 1},
            "c": {"filtered_group_sum": 1, "partition_histogram": 1}}
    fleet = StoreFleet(MetaService(peer_count=3), ["s1:1", "s2:1", "s3:1"], seed=5)
    s = Session(Database("cuda", fleet=fleet))
    s.execute("SET GLOBAL streaming_scan = 0")
    try:
        s.execute(ddl)
        fleet.row_tiers["default.t"].split_rows = n // 3
        s.load_arrow("t", pa.table({"id": np.arange(n, dtype=np.int64),
                                    "g": rng.integers(0, 2048, n, dtype=np.int32),
                                    "v": rng.standard_normal(n, dtype=np.float32),
                                    "w": rng.standard_normal(n),
                                    "g16": rng.integers(0, 16, n, dtype=np.int32)}))
        assert len(fleet.row_tiers["default.t"].groups) >= 3
        s.execute("UPDATE t SET v = 0.75 WHERE id < 1000")
        tier = fleet.row_tiers["default.t"]
        leaders = [g.leader() for g in tier.groups]
        fleet.kill_store(fleet._addr[max(set(leaders), key=leaders.count)])
        s.execute("DELETE FROM t WHERE id >= 99000")
        rebuilt = Session(Database("cuda", fleet=fleet))
        rebuilt.execute(ddl)
        cpu = Session(Database("cpu", fleet=fleet))
        cpu.execute(ddl)
        for q, text in sql.items():
            for sess in (s, rebuilt):
                before = _all_launches()
                got = sess.query(text)
                assert _moved(before) == want[q], q
                _close_rollup_rows(got, cpu.query(text), 1e-4, 2e-3)
    finally:
        s.execute("SET GLOBAL streaming_scan = 1")


@pytest.mark.cuda
def test_cluster_frontend_group_by_on_the_card_launches_the_kernels(cuda, tmp_path):
    """A frontend over 3 store daemon processes (``spawn_cluster``): the
    table's first (a) runs as pushed fragments on the daemons and launches
    nothing; once its image is pulled, (a)-(c)'s GROUP BYs launch K1-K3
    and the segment kernel on the card and equal a CPU frontend's rows
    over the same daemons, and the kernels hold against their plain
    versions on that image."""
    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.ops import segments as seg
    from baikaldb_tpu_torch.tools.deploy_cluster import spawn_cluster, teardown

    rng = np.random.default_rng(17)
    n = 60_000
    ddl = "CREATE TABLE t (id BIGINT PRIMARY KEY, g INT, v FLOAT, w DOUBLE, g16 INT)"
    sql = {"a": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > 0.5 "
                "GROUP BY g16 ORDER BY g16",
           "b": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > 0.5 "
                "GROUP BY g ORDER BY g",
           "c": "SELECT g, SUM(w), AVG(w) FROM t WHERE w > -1 GROUP BY g ORDER BY g"}
    want = {"a": {"segment_reduce": 8},
            "b": {"partition_histogram": 1, "fused_group_aggregate": 1},
            "c": {"filtered_group_sum": 1, "partition_histogram": 1}}
    meta, procs = spawn_cluster(3, 0, cold_dir=str(tmp_path / "cold"))
    dbs = []
    try:
        def frontend(device):
            db = Database(device, cluster=meta)
            dbs.append(db)
            s = Session(db)
            s.execute("SET GLOBAL streaming_scan = 0")
            s.execute(ddl)
            return s
        writer = frontend("cuda")
        writer.load_arrow("t", pa.table({"id": np.arange(n, dtype=np.int64),
                                         "g": rng.integers(0, 2048, n, dtype=np.int32),
                                         "v": rng.standard_normal(n, dtype=np.float32),
                                         "w": rng.standard_normal(n),
                                         "g16": rng.integers(0, 16, n, dtype=np.int32)}))
        writer.execute("UPDATE t SET v = 0.75 WHERE id < 1000")
        s, cpu = frontend("cuda"), frontend("cpu")
        store = s.db.stores["default.t"]
        before = _all_launches()
        s.query(sql["a"])                          # pushed: the table stays unattached
        assert store.attach_pending and _moved(before) == {}
        batch = store.device_table_batch()
        for q, text in sql.items():
            before = _all_launches()
            got = s.query(text)
            assert _moved(before) == want[q], q
            _close_rollup_rows(got, cpu.query(text), 1e-4, 2e-3)
        col = dict(zip(batch.names, batch.columns))
        g, g16, v, w = (col[c].data for c in ("g", "g16", "v", "w"))
        keep, keep_w = (v * 2 + 1).double() > 0.5, w > -1
        counts, sums, mins, maxs = gk.fused_group_aggregate(g, v, keep, 2049)
        p_counts, p_sums, p_mins, p_maxs = gk.fused_group_aggregate_plain(g, v, keep, 2049)
        assert torch.equal(counts, p_counts) and torch.equal(mins, p_mins)
        assert torch.equal(maxs, p_maxs)
        assert torch.allclose(sums, p_sums, rtol=1e-5, atol=1e-3)
        k1, k1p = (f(g, w.float(), keep_w, 2049)
                   for f in (gk.filtered_group_sum, gk.filtered_group_sum_plain))
        assert torch.equal(k1[0], k1p[0]) and torch.allclose(k1[1], k1p[1], rtol=1e-5, atol=1e-3)
        assert torch.equal(gk.partition_histogram(g, keep, 2049),
                           gk.partition_histogram_plain(g, keep, 2049))
        gid = torch.where(keep, g16, 17)
        assert torch.allclose(seg.segment_reduce(v.double(), gid, 17, "sum"),
                              seg.segment_reduce_plain(v.double(), gid, 17, "sum"),
                              rtol=1e-9, atol=1e-6)
    finally:
        for db in dbs:
            db.close()
        teardown(procs)


@pytest.mark.cuda
def test_wire_round_trip_on_the_card_launches_the_kernels(cuda):
    """The port's MySQL server on the card: (a)-(c) sent by the port's
    client launch K1-K3 and the segment kernel in the server's connection
    thread, and the wire rows are the text of the session's own rows (keys
    and counts exact, float sums to rtol 1e-5: the kernels accumulate in
    no fixed order); a KILL CONNECTION of an idle client severs it."""
    import pyarrow as pa

    from baikaldb_tpu_torch.client.mysql_client import Connection
    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.server.mysql_server import MySQLServer

    rng = np.random.default_rng(18)
    n = 200_000
    sql = {"a": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > 0.5 "
                "GROUP BY g16 ORDER BY g16",
           "b": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > 0.5 "
                "GROUP BY g ORDER BY g",
           "c": "SELECT g, SUM(w), AVG(w) FROM t WHERE w > -1 GROUP BY g ORDER BY g"}
    want = {"a": {"segment_reduce": 8},
            "b": {"partition_histogram": 1, "fused_group_aggregate": 1},
            "c": {"filtered_group_sum": 1, "partition_histogram": 1}}
    db = Database("cuda")
    s = Session(db)                 # 200,000 rows: under streaming_min_rows, resident
    s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
    s.load_arrow("t", pa.table({"g": rng.integers(0, 2048, n, dtype=np.int32),
                                "v": rng.standard_normal(n, dtype=np.float32),
                                "w": rng.standard_normal(n),
                                "g16": rng.integers(0, 16, n, dtype=np.int32)}))
    srv = MySQLServer(db, port=0).start()
    try:
        c = Connection(port=srv.port)
        for q, text in sql.items():
            before = _all_launches()
            got = c.query(text).rows
            assert _moved(before) == want[q], q
            mine = s.execute(text).rows
            assert len(got) == len(mine)
            for wr, sr in zip(got, mine):
                assert wr[0] == str(sr[0]) and (q == "c" or wr[1] == str(sr[1]))
                for a, b in zip(wr, sr):
                    assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-6)
        victim = Connection(port=srv.port)
        vid = int(victim.query("SELECT CONNECTION_ID()").rows[0][0])
        c.query(f"KILL CONNECTION {vid}")
        with pytest.raises(Exception):
            victim.query("SELECT 1")
        c.close()
    finally:
        srv.stop()


# ---- the sync guard on the card (analysis/runtime.py) ----------------------

@pytest.fixture
def guards():
    from baikaldb_tpu_torch.analysis import runtime as rt
    from baikaldb_tpu_torch.utils.flags import set_flag

    yield rt, set_flag
    set_flag("debug_guards", "off")


@pytest.mark.cuda
def test_guard_item_inside_scope_raises_and_counts_one_trip(cuda, guards):
    """Under disallow a stray .item() of a CUDA tensor fails inside the
    torch op itself with one transfer trip; host_read of the same value
    (and a data-dependent shape through it) passes without one, and so do
    host->device uploads (a literal, a host column, a host index), which
    torch's sync debug mode flags too; a swallowed trip still fails the
    scope at its exit; under log the read passes and counts."""
    rt, set_flag = guards
    x = torch.arange(1000, device=cuda)
    set_flag("debug_guards", "disallow")
    t0 = rt.guard_transfer_trips.value
    with pytest.raises(RuntimeError, match="device->host transfer"):
        with rt.hot_path_guard(cuda):
            x.sum().item()
    assert rt.guard_transfer_trips.value == t0 + 1
    with rt.hot_path_guard(cuda):
        assert rt.host_read(x.sum()) == 499500
        tail = rt.host_read(x > 997, torch.nonzero).reshape(-1)
        assert rt.host_read(x[:3]).tolist() == [0, 1, 2]
        lit = torch.tensor(0.5, dtype=torch.float64, device=cuda)
        col = torch.from_numpy(np.arange(7)).to(cuda)
        picked = x[[1, 2]] + x[torch.tensor([4, 5])]
        x2 = x.clone()
        x2[torch.tensor([0, 1])] = 7
    assert rt.guard_transfer_trips.value == t0 + 1
    assert tail.tolist() == [998, 999]
    assert float(lit) == 0.5 and col.tolist() == list(range(7))
    assert picked.tolist() == [5, 7] and x2[:2].tolist() == [7, 7]
    with pytest.raises(RuntimeError, match="device->host transfer"):
        with rt.hot_path_guard(cuda):
            try:
                int(x.max())
            except RuntimeError:
                pass                    # swallowed: the scope's exit raises
    assert rt.guard_transfer_trips.value == t0 + 2
    set_flag("debug_guards", "log")
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with rt.hot_path_guard(cuda):
            assert bool(x.any())
    assert rt.guard_transfer_trips.value == t0 + 3
    syncs = [w for w in caught if rt.SYNC_TEXT in str(w.message)]
    assert len(syncs) == 1 and syncs[0].filename == __file__
    assert torch.cuda.get_sync_debug_mode() == 0      # restored after the scopes


@pytest.mark.cuda
def test_guard_ignores_syncs_of_other_threads(cuda, guards):
    """The mode is process-wide while a scope is open, but a read made by a
    thread outside any scope (another session's egress, a poller) neither
    trips nor fails."""
    import threading

    rt, set_flag = guards
    set_flag("debug_guards", "disallow")
    t0 = rt.guard_transfer_trips.value
    y = torch.ones(100, device=cuda)
    inside, done, got = threading.Event(), threading.Event(), []

    def other():
        inside.wait(30)
        got.append(y.sum().item())
        done.set()

    th = threading.Thread(target=other)
    th.start()
    with rt.hot_path_guard(cuda):
        inside.set()
        assert done.wait(30)
    th.join()
    assert got == [100.0] and rt.guard_transfer_trips.value == t0


@pytest.mark.cuda
def test_kernels_and_phase3_queries_inside_the_guard(cuda, guards):
    """K1-K3 and the segment kernel launch inside an armed scope with no
    trip, and (a)-(c) run under disallow with their launches and 0 trips."""
    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.ops import segments as seg

    rt, set_flag = guards
    codes, values, mask = _inputs(1 << 20, 2049, 0.6, 19, cuda)
    set_flag("debug_guards", "disallow")
    t0 = rt.guard_transfer_trips.value
    before = _all_launches()
    with rt.hot_path_guard(cuda):
        k1 = gk.filtered_group_sum(codes, values, mask, 2049)
        k2 = gk.fused_group_aggregate(codes, values, mask, 2049)
        k3 = gk.partition_histogram(codes, mask, 2049)
        sg = seg.segment_reduce(values.double(), codes.clamp(0, 16), 17, "sum")
    assert _moved(before) == {"filtered_group_sum": 1, "fused_group_aggregate": 1,
                              "partition_histogram": 1, "segment_reduce": 1}
    assert rt.guard_transfer_trips.value == t0
    assert torch.equal(k3, gk.partition_histogram_plain(codes, mask, 2049))
    p1 = gk.filtered_group_sum_plain(codes, values, mask, 2049)
    p2 = gk.fused_group_aggregate_plain(codes, values, mask, 2049)
    assert torch.equal(k1[0], p1[0]) and torch.equal(k2[0], p2[0])
    torch.testing.assert_close(k1[1], p1[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k2[1], p2[1], rtol=1e-5, atol=1e-5)
    gid = codes.clamp(0, 16)
    torch.testing.assert_close(sg, seg.segment_reduce_plain(values.double(), gid, 17, "sum"),
                               rtol=1e-9, atol=1e-9)

    rng = np.random.default_rng(19)
    n = 200_000
    s = Session(device="cuda")
    s.execute("SET GLOBAL streaming_scan = 0")
    try:
        s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
        s.load_arrow("t", pa.table({"g": rng.integers(0, 2048, n, dtype=np.int32),
                                    "v": rng.standard_normal(n, dtype=np.float32),
                                    "w": rng.standard_normal(n),
                                    "g16": rng.integers(0, 16, n, dtype=np.int32)}))
        sql = {"a": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
                    "WHERE v*2+1 > 0.5 GROUP BY g16 ORDER BY g16",
               "b": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
                    "WHERE v*2+1 > 0.5 GROUP BY g ORDER BY g",
               "c": "SELECT g, SUM(w), AVG(w) FROM t WHERE w > -1 GROUP BY g ORDER BY g"}
        want = {"a": {"segment_reduce": 8},
                "b": {"partition_histogram": 1, "fused_group_aggregate": 1},
                "c": {"filtered_group_sum": 1, "partition_histogram": 1}}
        set_flag("debug_guards", "off")
        off = {q: s.query(text) for q, text in sql.items()}
        set_flag("debug_guards", "disallow")
        for q, text in sql.items():
            before = _all_launches()
            got = s.query(text)
            assert _moved(before) == want[q], q
            assert len(got) == len(off[q])
        assert rt.guard_transfer_trips.value == t0
        assert any(ln.startswith("-- guards: mode=disallow transfer_trips=")
                   for ln in s.execute("EXPLAIN ANALYZE " + sql["b"]).plan_text.splitlines())
    finally:
        s.execute("SET GLOBAL streaming_scan = 1")


@pytest.mark.cuda
def test_ssb_flat_statements_and_week_on_the_card(cuda):
    """WEEK(d, 3) / WEEK(d, 0) over the year boundaries, and the SSB flat
    table's 13 statements on the card against the benchmark's plain
    reference, with each dense GROUP BY's ``route`` and ``slots`` on its
    ``op.agg`` span (the table and helpers of tests/test_torch_ssb_flat.py)."""
    import test_torch_ssb_flat as ssbt
    from baikaldb_tpu_torch.obs import trace
    from baikaldb_tpu_torch.ops.hashagg import dense_num_groups
    from baikaldb_tpu_torch.utils.flags import FLAGS, set_flag
    from gpubench.refs import ssb_flat

    got, want = ssbt.week_rows("cuda")
    assert got == want
    saved = {k: getattr(FLAGS, k) for k in ("streaming_scan", "tracing", "trace_sample_n")}
    try:
        t = ssbt.full_domain_table()
        s = ssbt.session(t, "cuda")
        ref = ssb_flat.Reference(ssbt.config(), {"lineorder_flat": t}, "cuda")
        set_flag("tracing", True)
        set_flag("trace_sample_n", 1)
        for name, sql in ssbt.config()["statements"].items():
            trace.TRACER.clear()
            ssbt.check_statement(s, ref, name)
            dense = [sp["attrs"] for rec in trace.TRACER.list() for sp in rec["spans"]
                     if sp["name"] == "op.agg" and sp["attrs"].get("strategy") == "dense"]
            if name in ssbt.ROUTES:
                domains, route = ssbt.ROUTES[name]
                assert [(a["route"], a["slots"]) for a in dense] == \
                    [(route, dense_num_groups(domains))], name
            else:
                assert not dense, name
    finally:
        for k, v in saved.items():
            set_flag(k, v)
        trace.TRACER.clear()
