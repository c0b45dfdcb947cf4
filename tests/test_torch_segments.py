"""The port's segment reductions (baikaldb_tpu_torch/ops/segments.py) against
the JAX package's (baikaldb_tpu/ops/segments.py).

The JAX side runs its accelerator branch, the fused select+reduce, forced on
as tests/test_segments.py forces it (``_onehot_backend -> True``), and its
CPU scatter.  The port runs both of its CPU routes: ``seg_sum`` /
``seg_min`` / ``seg_max`` (the scatter) and ``segment_reduce_plain`` (the
select+reduce the segment kernel is held against on the card).  The cases
mirror tests/test_segments.py.  Tolerances: integers, counts, MIN and MAX
exact; float64 sums rtol 1e-9; float32 sums rtol 2e-7 (the select+reduce
accumulates in float64 and rounds once; the scatter accumulates in float32,
so float32 sums of the scatter are held to numpy at 1e-4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from baikaldb_tpu.ops import segments as jseg
from baikaldb_tpu_torch.ops import segments as tseg


@pytest.fixture
def force_onehot(monkeypatch):
    monkeypatch.setattr(jseg, "_onehot_backend", lambda: True)


def _ids(n, ns, rng):
    gid = rng.integers(0, ns, n).astype(np.int32)
    gid[rng.random(n) < 0.1] = ns  # dead bucket, must drop
    return gid


def _port(route, op, x, gid, ns):
    """The port's result on ``route``: "scatter" (seg_*) or "plain"
    (segment_reduce_plain)."""
    tx, tg = torch.from_numpy(np.ascontiguousarray(x)), torch.from_numpy(gid)
    if route == "plain":
        return tseg.segment_reduce_plain(tx, tg, ns, op).numpy()
    return {"sum": tseg.seg_sum, "min": tseg.seg_min, "max": tseg.seg_max}[op](
        tx, tg, ns).numpy()


def _jax(op, x, gid, ns):
    f = {"sum": jseg.seg_sum, "min": jseg.seg_min, "max": jseg.seg_max}[op]
    return np.asarray(f(jnp.asarray(x), jnp.asarray(gid), num_segments=ns))


ROUTES = ["scatter", "plain"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n,ns", [(1, 1), (7, 3), (1000, 16), (5000, 130)])
def test_counts_exact(force_onehot, route, n, ns):
    rng = np.random.default_rng(n)
    gid = _ids(n, ns, rng)
    ones = np.ones(n, np.int64)
    got = _port(route, "sum", ones, gid, ns + 1)
    want = _jax("sum", ones, gid, ns + 1)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.bincount(gid, minlength=ns + 1))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_int_sums_exact_with_negatives(force_onehot, route, dtype):
    rng = np.random.default_rng(0)
    n, ns = 4000, 20
    gid = _ids(n, ns, rng)
    lo, hi = (np.iinfo(dtype).min // 2, np.iinfo(dtype).max // 2)
    x = rng.integers(lo, hi, n).astype(dtype)
    got = _port(route, "sum", x, gid, ns + 1)
    want = np.zeros(ns + 1, dtype)
    np.add.at(want, gid, x)          # numpy wraps like two's complement
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax("sum", x, gid, ns + 1))


@pytest.mark.parametrize("route", ROUTES)
def test_int64_wraparound_exact(force_onehot, route):
    x = np.asarray([2**62, 2**62, 2**62, -5], np.int64)
    gid = np.asarray([0, 0, 0, 1], np.int32)
    got = _port(route, "sum", x, gid, 3)
    want = np.zeros(3, np.int64)
    np.add.at(want, [0, 0, 0, 1], x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax("sum", x, gid, 3))


@pytest.mark.parametrize("route", ROUTES)
def test_bool_sums_count_as_int32(force_onehot, route):
    rng = np.random.default_rng(4)
    gid = _ids(3000, 9, rng)
    x = rng.random(3000) < 0.3
    got = _port(route, "sum", x, gid, 10)
    want = _jax("sum", x, gid, 10)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_sums_tolerance(force_onehot, route, dtype):
    rng = np.random.default_rng(1)
    n, ns = 20000, 16
    gid = _ids(n, ns, rng)
    x = (rng.normal(size=n) * 1e3).astype(dtype)
    got = _port(route, "sum", x, gid, ns + 1)
    want = np.zeros(ns + 1, np.float64)
    np.add.at(want, gid, x.astype(np.float64))
    assert got.dtype == dtype
    if route == "scatter" and dtype == np.float32:
        # the scatter accumulates in float32, as jax.ops.segment_sum does
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
        return
    rtol = 1e-9 if dtype == np.float64 else 2e-7
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-9)
    np.testing.assert_allclose(got, _jax("sum", x, gid, ns + 1), rtol=rtol, atol=1e-9)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64, np.bool_])
def test_min_max(force_onehot, route, dtype):
    rng = np.random.default_rng(2)
    n, ns = 3000, 40
    gid = _ids(n, ns, rng)
    gid[gid == 7] = 8                 # segment 7 empty: the identity
    if dtype == np.bool_:
        x = rng.random(n) < 0.5
    elif np.issubdtype(dtype, np.integer):
        x = rng.integers(-10**6, 10**6, n).astype(dtype)
    else:
        x = rng.normal(size=n).astype(dtype)
    for op in ("min", "max"):
        got = _port(route, op, x, gid, ns + 1)
        want = _jax(op, x, gid, ns + 1)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if np.issubdtype(dtype, np.floating):
        assert _port(route, "min", x, gid, ns + 1)[7] == np.inf


@pytest.mark.parametrize("route", ROUTES)
def test_nan_of_either_sign(force_onehot, route):
    """A NaN of either sign in a segment makes its float MIN and MAX NaN."""
    x = np.asarray([1, np.nan, -2, 3, -np.nan, 5], np.float32)
    x.view(np.uint32)[4] = 0xFFC00000          # -NaN (x86's default)
    gid = np.asarray([0, 0, 1, 1, 2, 3], np.int32)
    for op in ("min", "max"):
        got = _port(route, op, x, gid, 4)
        want = _jax(op, x, gid, 4)
        np.testing.assert_array_equal(np.isnan(got), [True, False, True, False])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ROUTES)
def test_out_of_range_ids_drop(force_onehot, route):
    x = np.arange(8, dtype=np.int64)
    gid = np.asarray([-1, 0, 5, 1, 3, -7, 2, 9], np.int32)
    got = _port(route, "sum", x, gid, 4)
    np.testing.assert_array_equal(got, [1, 3, 6, 4])
    np.testing.assert_array_equal(got, _jax("sum", x, gid, 4))


def test_large_segments_fall_back(force_onehot):
    """Above the gate the reference takes the scatter; the port's plain
    select+reduce and scatter agree with it there too."""
    n, ns = 100, tseg.CPU_MAX_SEGMENTS + 1
    gid = np.arange(n, dtype=np.int32)
    ones = np.ones(n, np.int64)
    for route in ROUTES:
        got = _port(route, "sum", ones, gid, ns)
        assert got[:n].sum() == n and got.shape == (ns,)
        np.testing.assert_array_equal(got, _jax("sum", ones, gid, ns))


def test_the_cpu_takes_the_scatter_and_launches_nothing():
    c = tseg.LAUNCHES["segment_reduce"]
    before = c.value
    x = torch.arange(100, dtype=torch.float64)
    gid = (torch.arange(100) % 7).to(torch.int32)
    tseg.seg_sum(x, gid, 7), tseg.seg_min(x, gid, 7), tseg.segment_reduce(x, gid, 7, "max")
    assert c.value == before
    assert tseg.max_segments("cpu") == jseg.ONEHOT_MAX_SEGMENTS


@pytest.mark.parametrize("slots", [9, 17, 600])
def test_group_aggregate_dense_matches_jax(force_onehot, slots):
    """The dense group-by end to end, with a filter, at 9 and 17 slots (the
    select+reduce in the JAX package, the scatter in the port on the CPU)
    and at 600 (above the CPU's gate: the scatter in both), against the JAX
    package with its one-hot branch forced on."""
    from baikaldb_tpu.column.batch import Column as JColumn
    from baikaldb_tpu.column.batch import ColumnBatch as JBatch
    from baikaldb_tpu.ops.hashagg import AggSpec as JSpec
    from baikaldb_tpu.ops.hashagg import group_aggregate_dense as jdense
    from baikaldb_tpu.types import LType as JLType
    from baikaldb_tpu_torch.column.batch import Column, ColumnBatch
    from baikaldb_tpu_torch.ops.hashagg import AggSpec, group_aggregate_dense
    from baikaldb_tpu_torch.types import LType

    rng = np.random.default_rng(slots)
    n, dom = 2500, slots - 1
    g = rng.integers(0, dom, n).astype(np.int32)
    v = rng.normal(size=n)
    k = rng.integers(-50, 50, n).astype(np.int64)
    sel = rng.random(n) < 0.8
    specs = [("count_star", None, "n"), ("sum", "v", "s"), ("min", "v", "mn"),
             ("max", "v", "mx"), ("sum", "k", "sk"), ("avg", "v", "a")]
    jout = jdense(JBatch(("g", "v", "k"),
                         [JColumn(jnp.asarray(g), None, JLType.INT32),
                          JColumn(jnp.asarray(v), None, JLType.FLOAT64),
                          JColumn(jnp.asarray(k), None, JLType.INT64)], jnp.asarray(sel)),
                  ["g"], [dom], [JSpec(*s) for s in specs])
    tout = group_aggregate_dense(
        ColumnBatch(("g", "v", "k"),
                    [Column(torch.from_numpy(g), None, LType.INT32),
                     Column(torch.from_numpy(v), None, LType.FLOAT64),
                     Column(torch.from_numpy(k), None, LType.INT64)], torch.from_numpy(sel)),
        ["g"], [dom], [AggSpec(*s) for s in specs])
    np.testing.assert_array_equal(tout.sel.numpy(), np.asarray(jout.sel))
    live = tout.sel.numpy()
    for name in ("n", "sk", "mn", "mx"):
        np.testing.assert_array_equal(tout.column(name).data.numpy()[live],
                                      np.asarray(jout.column(name).data)[live])
    for name in ("s", "a"):
        np.testing.assert_allclose(tout.column(name).data.numpy()[live],
                                   np.asarray(jout.column(name).data)[live], rtol=1e-9)
