"""The wide dense GROUP BY (ops/hashagg.py ``dense_route`` "wide",
``dense_group_agg``; ops/dense_agg.py; csrc/dense_agg.cu) on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py holds it against
its plain version there).  Here:

- ``dense_group_agg_plain`` is ``_segment_one`` spec by spec over the
  drop-slot ids, and ``dense_group_agg`` on a CPU tensor is the plain
  version, with no launch counted;
- the kernel's contract (csrc/dense_agg.cu), written out row by row in
  numpy below, assembled by ``wide_columns`` into the columns the card
  returns, equals the plain version: counts, integers and MIN/MAX exactly
  (NaN equal to NaN), float64 sums to 1e-12 relative (the kernel adds in
  another order);
- ``wide_plan`` takes each accumulator once, a count only where COUNT or
  AVG needs one;
- ``dense_route`` picks ``wide`` only for a CUDA device above the segment
  kernel's gate, with K1-K3 declined and every aggregate supported, and
  keeps the other routes as they were.

Cases: every input dtype of the route, with and without NULLs, NaN of both
signs, empty groups, an all-dead batch, int64 sums that wrap, and slot
counts on each side of the gates (2048 | 2049, 4096 | 4097).
"""

import numpy as np
import pytest
import torch

from baikaldb_tpu_torch.column.batch import Column, ColumnBatch
from baikaldb_tpu_torch.ops import dense_agg, hashagg
from baikaldb_tpu_torch.ops.hashagg import AggSpec
from baikaldb_tpu_torch.types import LType
from baikaldb_tpu_torch.utils.flags import FLAGS, set_flag

N = 2500
TYPES = {"int32": (LType.INT32, np.int32), "int64": (LType.INT64, np.int64),
         "date": (LType.DATE, np.int32), "string": (LType.STRING, np.int32),
         "float32": (LType.FLOAT32, np.float32), "float64": (LType.FLOAT64, np.float64)}
SPECS = [AggSpec("count_star", None, "cs"), AggSpec("count", "x", "c"),
         AggSpec("sum", "x", "s"), AggSpec("avg", "x", "a"), AggSpec("min", "x", "mn"),
         AggSpec("max", "x", "mx"), AggSpec("min", "y", "ymn")]
KINDS = ["plain", "empty", "dead", "nan", "wrap"]


def _case(dtype, nulls, kind, ng, seed=0):
    """-> (gid int32, sel, {name: Column}) for one case."""
    rng = np.random.default_rng(seed)
    lt, np_dt = TYPES[dtype]
    slots = 40 if kind in ("empty", "wrap") else min(ng, 3 * N)
    gid = (rng.integers(0, slots, N) * (ng // slots)).astype(np.int32)
    gid.sort()                      # runs of equal slots, as an ordered fact table gives
    sel = rng.random(N) < (0.0 if kind == "dead" else 0.6)
    if np.dtype(np_dt).kind == "f":
        x = (rng.normal(size=N) * 1e3).astype(np_dt)
        if kind == "nan":
            x[rng.random(N) < 0.05] = np.nan
            x[rng.random(N) < 0.05] = -np.nan
    elif kind == "wrap" and np_dt == np.int64:
        x = rng.integers(2 ** 61, 2 ** 62, N, dtype=np.int64) * rng.choice([-1, 1], N)
    else:
        info = np.iinfo(np_dt)
        lo, hi = (info.min // 2, info.max // 2) if kind == "wrap" else (-10 ** 6, 10 ** 6)
        x = rng.integers(lo, hi, N).astype(np_dt)
    xv = rng.random(N) > 0.3 if nulls else None
    y = rng.integers(0, 10 ** 5, N).astype(np.int32)
    cols = {"x": Column(torch.from_numpy(x), None if xv is None else torch.from_numpy(xv), lt),
            "y": Column(torch.from_numpy(y), None, LType.INT32)}
    return torch.from_numpy(gid), torch.from_numpy(sel), cols


CASES = [(d, nulls, kind, ng) for d in TYPES for nulls in (False, True) for kind in KINDS
         for ng in (2049, 4097)
         if not (kind == "nan" and TYPES[d][0] not in (LType.FLOAT32, LType.FLOAT64))
         and not (kind == "wrap" and TYPES[d][0] not in (LType.INT32, LType.INT64))]


def _kernel_outputs(gid, sel, cols, accs, ng):
    """csrc/dense_agg.cu's outputs as its contract states them, row by row:
    the live count a slot and each accumulator over the live rows whose
    column is valid, from the identities the wrapper fills."""
    g = gid.numpy()
    live = (np.ones(len(g), bool) if sel is None else sel.numpy()) & (g >= 0) & (g < ng)
    cnt = np.bincount(g[live], minlength=ng).astype(np.int32)
    outs = []
    for a in accs:
        c = cols[a.input]
        ok = live if c.validity is None else live & c.validity.numpy()
        v = c.data.numpy()
        if a.kind in (dense_agg.COUNT, dense_agg.FLAG):
            k = np.bincount(g[ok], minlength=ng)
            out = k.astype(np.int32) if a.kind == dense_agg.COUNT else (k > 0).astype(np.uint8)
        elif a.kind in (dense_agg.SUM_I64, dense_agg.SUM_F64):
            dt = np.int64 if a.kind == dense_agg.SUM_I64 else np.float64
            out = np.zeros(ng, dt)
            with np.errstate(over="ignore"):
                np.add.at(out, g[ok], v[ok].astype(dt))       # int64 wraps
        else:
            is_min = a.kind == dense_agg.MIN
            ident = (np.inf if is_min else -np.inf) if v.dtype.kind == "f" else \
                (np.iinfo(v.dtype).max if is_min else np.iinfo(v.dtype).min)
            out = np.full(ng, ident, dtype=v.dtype)
            for i in np.flatnonzero(ok):
                cur, x = out[g[i]], v[i]
                if v.dtype.kind == "f" and np.isnan(cur):
                    continue
                if (v.dtype.kind == "f" and np.isnan(x)) or (x < cur if is_min else x > cur):
                    out[g[i]] = x
        outs.append(torch.from_numpy(out))
    return torch.from_numpy(cnt), outs


def _same(got: Column, want: Column, rtol=0.0):
    """Equal columns: dtype, type, validity, and data exactly (NaN equal to
    NaN) or floats to ``rtol``."""
    assert got.data.dtype == want.data.dtype and got.ltype == want.ltype
    assert (got.validity is None) == (want.validity is None)
    if want.validity is not None:
        assert torch.equal(got.validity, want.validity)
    if want.data.dtype.is_floating_point:
        torch.testing.assert_close(got.data, want.data, rtol=rtol, atol=0.0, equal_nan=True)
    else:
        assert torch.equal(got.data, want.data)


@pytest.mark.parametrize("dtype,nulls,kind,ng", CASES)
def test_plain_is_segment_one_spec_by_spec(dtype, nulls, kind, ng):
    gid, sel, cols = _case(dtype, nulls, kind, ng)
    present, got = hashagg.dense_group_agg_plain(gid, sel, cols, SPECS, ng)
    gid_live = torch.where(sel, gid, ng)
    for s, col in zip(SPECS, got):
        _same(col, hashagg._segment_one(cols.get(s.input), s, gid_live, ng, sel))
    assert torch.equal(present, torch.bincount(gid[sel], minlength=ng) > 0)


@pytest.mark.parametrize("dtype,nulls,kind,ng", CASES)
def test_kernel_contract_assembles_to_the_plain_version(dtype, nulls, kind, ng):
    gid, sel, cols = _case(dtype, nulls, kind, ng, seed=1)
    accs = dense_agg.wide_plan(SPECS, cols)
    present, got = hashagg.wide_columns(SPECS, cols, accs,
                                        *_kernel_outputs(gid, sel, cols, accs, ng))
    want_present, want = hashagg.dense_group_agg_plain(gid, sel, cols, SPECS, ng)
    assert torch.equal(present, want_present)
    for g, w in zip(got, want):
        _same(g, w, rtol=1e-12)


@pytest.mark.parametrize("sel_none", [False, True])
def test_dense_group_agg_on_the_cpu_is_the_plain_version(sel_none):
    gid, sel, cols = _case("float64", True, "nan", 4097)
    sel = None if sel_none else sel
    before = dense_agg.LAUNCHES["dense_group_agg"].value
    present, got = hashagg.dense_group_agg(gid, sel, cols, SPECS, 4097)
    want_present, want = hashagg.dense_group_agg_plain(gid, sel, cols, SPECS, 4097)
    assert torch.equal(present, want_present)
    for g, w in zip(got, want):
        _same(g, w)
    assert dense_agg.LAUNCHES["dense_group_agg"].value == before


def test_wide_plan_takes_each_accumulator_once():
    _, _, cols = _case("int32", True, "plain", 4097)
    D = dense_agg
    assert D.wide_plan(SPECS, cols) == [
        D.Acc(D.COUNT, "x"), D.Acc(D.SUM_I64, "x"),
        D.Acc(D.SUM_F64, "x"), D.Acc(D.MIN, "x"),
        D.Acc(D.MAX, "x"), D.Acc(D.MIN, "y")]
    # no COUNT or AVG of a nullable column: a one-byte flag marks it non-empty
    specs = [AggSpec("sum", "x", "s"), AggSpec("min", "x", "m"), AggSpec("max", "y", "y")]
    assert D.wide_plan(specs, cols) == [
        D.Acc(D.FLAG, "x"), D.Acc(D.SUM_I64, "x"),
        D.Acc(D.MIN, "x"), D.Acc(D.MAX, "y")]
    # a float SUM and AVG share one float64 sum; COUNT(*) needs none
    _, _, fcols = _case("float64", False, "plain", 4097)
    assert D.wide_plan([AggSpec("count_star", None, "n"), AggSpec("sum", "x", "s"),
                        AggSpec("avg", "x", "a")], fcols) == [D.Acc(D.SUM_F64, "x")]


def _batch(dtype="int32", nulls=False):
    gid, sel, cols = _case(dtype, nulls, "plain", 4097)
    names = ("k", "x", "y", "f", "b")
    f = Column(torch.rand(N, dtype=torch.float32), None, LType.FLOAT32)
    b = Column(torch.rand(N) > 0.5, None, LType.BOOL)
    return ColumnBatch(names, [Column(gid, None, LType.INT32), cols["x"], cols["y"], f, b], sel)


def _route(batch, specs, ng, device="cuda"):
    return hashagg.dense_route(batch, specs, ng, torch.device(device))


@pytest.mark.parametrize("ng,want", [(100, "segment"), (2048, "segment"), (2049, "wide"),
                                     (4096, "wide"), (4097, "wide"), (150_001, "wide"),
                                     (6_000_001, "wide")])
def test_route_is_wide_above_the_segment_gate_on_cuda(ng, want):
    assert _route(_batch(), SPECS, ng) == want
    assert _route(_batch(), SPECS, ng, "cpu") == "scatter"


@pytest.mark.parametrize("ng,cuda,cpu", [(2048, "k123", "k123"), (2049, "k123", "k123"),
                                         (4095, "k123", "k123"), (4096, "wide", "scatter"),
                                         (100, "segment", "scatter")])
def test_route_keeps_k123_where_it_takes_the_group_by(ng, cuda, cpu):
    specs = [AggSpec("count_star", None, "n"), AggSpec("sum", "f", "s"),
             AggSpec("min", "f", "m")]
    assert _route(_batch(), specs, ng) == cuda
    assert _route(_batch(), specs, ng, "cpu") == cpu


def test_route_takes_wide_for_floats_when_k123_is_off():
    specs = [AggSpec("sum", "f", "s")]
    old = FLAGS.pallas_group_kernels
    set_flag("pallas_group_kernels", False)
    try:
        assert _route(_batch(), specs, 3000) == "wide"
    finally:
        set_flag("pallas_group_kernels", old)
    assert _route(_batch(), specs, 3000) == "k123"


@pytest.mark.parametrize("spec", [AggSpec("count", "x", "c", distinct=True),
                                  AggSpec("sum", "x", "s", distinct=True),
                                  AggSpec("percentile", "x", "p", param=0.5),
                                  AggSpec("approx_count_distinct", "x", "h"),
                                  AggSpec("stddev", "x", "sd"), AggSpec("sumsq", "x", "sq"),
                                  AggSpec("sum", "b", "sb"), AggSpec("min", "b", "mb")])
def test_route_keeps_the_scatter_for_what_the_kernel_does_not_take(spec):
    assert _route(_batch(), [AggSpec("count_star", None, "n"), spec], 150_001) == "scatter"


@pytest.mark.parametrize("dtype", list(TYPES))
@pytest.mark.parametrize("nulls", [False, True])
def test_route_takes_every_input_type_of_the_kernel(dtype, nulls):
    b = _batch(dtype, nulls)
    assert _route(b, SPECS, 150_001) == "wide"
    # a 0-d constant column is not a column the kernel can read
    const = ColumnBatch(b.names, [b.columns[0], Column(torch.tensor(3, dtype=torch.int32), None,
                                                       LType.INT32), *b.columns[2:]], b.sel)
    assert _route(const, SPECS, 150_001) == "scatter"


def test_route_refuses_more_accumulators_than_the_kernel_holds():
    b = _batch()
    cols = [b.columns[0]] + [Column(b.columns[2].data, None, LType.INT32)] * 12
    wide = ColumnBatch(("k",) + tuple(f"c{i}" for i in range(12)), cols, b.sel)
    specs = [AggSpec(op, f"c{i}", f"{op}{i}") for i in range(12) for op in ("sum", "min", "max")]
    assert len(dense_agg.wide_plan(specs, {f"c{i}": cols[1] for i in range(12)})) == 36
    assert _route(wide, specs, 150_001) == "scatter"
    assert _route(wide, specs[:30], 150_001) == "wide"


def test_group_aggregate_dense_on_the_cpu_never_takes_the_kernel():
    b = _batch("float64", True)
    before = dense_agg.LAUNCHES["dense_group_agg"].value
    out = hashagg.group_aggregate_dense(b, ["k"], [4096], SPECS)
    assert len(out) == 4097 and out.names[1:] == tuple(s.out_name for s in SPECS)
    assert dense_agg.LAUNCHES["dense_group_agg"].value == before


@pytest.mark.parametrize("kind", KINDS)
def test_plain_present_from_a_histogram_is_the_same(kind):
    gid, sel, cols = _case("int64", True, kind, 2049, seed=2)
    hist = torch.bincount(gid[sel], minlength=2049)
    present, got = hashagg.dense_group_agg_plain(gid, sel, cols, SPECS, 2049, hist)
    want_present, want = hashagg.dense_group_agg_plain(gid, sel, cols, SPECS, 2049)
    assert torch.equal(present, want_present)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("dtype", ["int32", "float64"])
def test_group_aggregate_dense_on_the_cpu_is_the_plain_composition(dtype):
    """The CPU's scatter route is ``dense_group_agg_plain`` itself, the
    version the kernel is held to."""
    b = _batch(dtype, True)
    assert _route(b, SPECS, 4097, "cpu") == "scatter"
    out = hashagg.group_aggregate_dense(b, ["k"], [4096], SPECS)
    present, want = hashagg.dense_group_agg_plain(
        b.column("k").data, b.sel_mask(), {"x": b.column("x"), "y": b.column("y")}, SPECS, 4097)
    assert torch.equal(out.sel, present)
    for g, w in zip(out.columns[1:], want):
        _same(g, w)
