"""Window functions of the port against the JAX package.

``window_compute`` is driven directly on one seeded table (partitions with
NULL keys, order keys with ties and NULLs, values with NULLs and NaN, a
string column, a selection vector), built from the same Arrow data in both
packages; then the window SQL of ``tests/test_sql.py`` and a few more
statements run through both ``Session``s, with their ``EXPLAIN`` plans.

The parity contract:

- exact: ROW_NUMBER, RANK, DENSE_RANK, NTILE, LEAD/LAG (string defaults
  included), FIRST_VALUE/LAST_VALUE, window COUNT and window MIN/MAX (NaN
  equal to NaN), NULL placement and ORDER BY order;
- window SUM and AVG are differences of one prefix sum over the whole
  column, in both packages: |port - JAX| <= 1e-9 * sum(|x|) over the whole
  input column, not a per-row rtol.
"""

import math

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from baikaldb_tpu.column.batch import ColumnBatch as JBatch
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.ops.sort import SortKey as JKey
from baikaldb_tpu.ops.window import WinSpec as JSpec
from baikaldb_tpu.ops.window import window_compute as jwindow
from baikaldb_tpu_torch.column.batch import ColumnBatch as TBatch
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.ops.sort import SortKey as TKey
from baikaldb_tpu_torch.ops.window import WinSpec as TSpec
from baikaldb_tpu_torch.ops.window import window_compute as twindow

N = 240


def _table() -> pa.Table:
    rng = np.random.default_rng(17)

    def nulls(vals, p):
        m = rng.random(len(vals)) < p
        return [None if k else v for v, k in zip(vals, m)]

    w = rng.standard_normal(N) * 10
    w[rng.random(N) < 0.05] = np.nan
    return pa.table({
        "k": pa.array(np.arange(N), pa.int64()),
        "p": pa.array(nulls([int(x) for x in rng.integers(0, 5, N)], 0.1), pa.int64()),
        "q": pa.array([int(x) for x in rng.integers(0, 2, N)], pa.int32()),
        "o": pa.array(nulls([int(x) for x in rng.integers(0, 30, N)], 0.1), pa.int64()),
        "o2": pa.array([int(x) for x in rng.integers(0, 40, N)], pa.int64()),
        "of": pa.array([float(x) / 4 for x in rng.integers(0, 60, N)], pa.float64()),
        "v": pa.array(nulls([float(x) for x in rng.standard_normal(N) * 100], 0.2),
                      pa.float64()),
        "w": pa.array([float(x) for x in w], pa.float64()),
        "i": pa.array(nulls([int(x) for x in rng.integers(-50, 50, N)], 0.2), pa.int32()),
        "s": pa.array(nulls([f"s{int(x):02d}" for x in rng.integers(0, 12, N)], 0.2),
                      pa.string()),
    })


TABLE = _table()
SUM_ABS = {c: float(np.nansum(np.abs(np.asarray(TABLE.column(c).to_pylist(),
                                                 dtype=float))))
           for c in ("v", "w", "i")}


def _run(partition, order, specs, sel=None):
    """The same window over the same rows in both packages -> (port, JAX)
    rows, each in the batch's row order."""
    jb, tb = JBatch.from_arrow(TABLE), TBatch.from_arrow(TABLE, "cpu")
    if sel is not None:
        jb, tb = jb.and_sel(jnp.asarray(sel)), tb.and_sel(torch.from_numpy(sel))
    jout = jwindow(jb, partition, [JKey(n, a) for n, a in order],
                   [JSpec(*a, **kw) for a, kw in specs])
    tout = twindow(tb, partition, [TKey(n, a) for n, a in order],
                   [TSpec(*a, **kw) for a, kw in specs])
    return tout.to_arrow().to_pylist(), jout.to_arrow().to_pylist()


def _assert_same(got, want, specs):
    """Exact, NaN equal to NaN; SUM/AVG within 1e-9 * sum(|x|) of the input."""
    assert len(got) == len(want)
    tol = {}
    for (op, inp, out), _ in ((a[:3], kw) for a, kw in specs):
        if op in ("sum", "avg"):
            tol[out] = 1e-9 * SUM_ABS[inp]
    for rg, rw in zip(got, want):
        assert list(rg) == list(rw)
        for key, w in rw.items():
            g = rg[key]
            if isinstance(w, float) and isinstance(g, float):
                if math.isnan(w) or math.isnan(g):
                    assert math.isnan(w) and math.isnan(g), (key, g, w)
                else:
                    assert abs(g - w) <= tol.get(key, 0.0), (key, g, w)
            else:
                assert g == w and type(g) is type(w), (key, g, w)


def S(op, inp=None, out=None, **kw):
    return (op, inp, out or f"{op}_{inp}_{kw.get('offset', kw.get('n', ''))}"), kw


AGGS_V = [S("sum", "v"), S("count", "v"), S("count", None, "cnt_star"), S("avg", "v"),
          S("min", "v"), S("max", "v")]
AGGS_I = [S("sum", "i"), S("count", "i"), S("avg", "i"), S("min", "i"), S("max", "i")]
RANKS = [S("row_number"), S("rank"), S("dense_rank"), S("ntile", n=3)]

CASES = {
    "ranking": (["p"], [("o", True)], RANKS),
    "ranking_desc_two_keys": (["p"], [("o", False), ("i", True)], RANKS),
    "ranking_no_partition": ([], [("v", False)], RANKS),
    "ranking_two_partition_keys": (["p", "s"], [("o2", True)], RANKS),
    "partition_aggs": (["p"], [], AGGS_V),
    "partition_aggs_int": (["p"], [("o", True)], AGGS_I),
    "partition_min_max_nan": (["q"], [], [S("min", "w"), S("max", "w"), S("sum", "w")]),
    "running_aggs": (["p"], [("o", True)],
                     [(a[:3], {**kw, "running": True}) for a, kw in AGGS_V]),
    "running_aggs_int": (["p"], [("o2", False)],
                         [(a[:3], {**kw, "running": True}) for a, kw in AGGS_I]),
    "running_min_max_nan": (["q"], [("k", True)],
                            [S("min", "w", running=True), S("max", "w", running=True)]),
    "lead_lag": (["p"], [("o", True), ("k", True)],
                 [S("lag", "o", offset=1), S("lead", "o", offset=2), S("lag", "v", offset=3),
                  S("lag", "i", "lag_def", offset=1, default=-1),
                  S("lead", "i", "lead_frac", offset=1, default=2.5),
                  S("lead", "v", "lead_def", offset=2, default=0.0)]),
    "lead_lag_string": (["p"], [("o2", True), ("k", True)],
                        [S("lag", "s", "lag_s", offset=1, default="none"),
                         S("lead", "s", "lead_s", offset=1),
                         S("lead", "s", "lead_s_def", offset=2, default="s05")]),
    "first_last": (["p"], [("o", True), ("k", True)],
                   [S("first_value", "v"), S("last_value", "v"), S("first_value", "s"),
                    S("last_value", "s", "lv_running", running=True)]),
    "ntile_sizes": (["q"], [("o2", True), ("k", True)],
                    [S("ntile", n=1), S("ntile", n=2), S("ntile", n=4), S("ntile", n=7),
                     S("ntile", n=200)]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_window_matches_jax(name):
    partition, order, specs = CASES[name]
    got, want = _run(partition, order, specs)
    _assert_same(got, want, specs)


def test_window_respects_the_selection_vector():
    sel = np.random.default_rng(5).random(N) < 0.7
    specs = RANKS + AGGS_V + [S("lag", "s", "lg", offset=1, default="x")]
    got, want = _run(["p"], [("o", True)], specs, sel)
    assert len(got) == int(sel.sum())
    _assert_same(got, want, specs)


FRAME_SPECS = [S("sum", "v"), S("count", "v"), S("count", None, "cnt_star"),
               S("avg", "v"), S("min", "v"), S("max", "v"), S("first_value", "v"),
               S("last_value", "v"), S("min", "w"), S("max", "w"), S("sum", "i"),
               S("first_value", "s")]
ROWS_FRAMES = [(("p", 2), ("c",)), (("p", 1), ("f", 1)), (("up",), ("f", 1)),
               (("c",), ("uf",)), (("f", 1), ("f", 2)), (("p", 3), ("p", 1)),
               (("up",), ("uf",)), (("up",), ("c",))]
RANGE_FRAMES = [(("p", 3), ("f", 3)), (("p", 2), ("c",)), (("c",), ("f", 4)),
                (("up",), ("f", 2)), (("p", 5), ("uf",)), (("p", 6), ("p", 2)),
                (("f", 1), ("f", 4)), (("up",), ("p", 3)), (("f", 2), ("uf",)),
                (("c",), ("c",))]


def _framed(unit, lo, hi):
    return [(a, {**kw, "frame": (unit, lo, hi)}) for a, kw in FRAME_SPECS]


@pytest.mark.parametrize("asc", [True, False], ids=["asc", "desc"])
@pytest.mark.parametrize("lo,hi", ROWS_FRAMES, ids=[f"{a}..{b}" for a, b in ROWS_FRAMES])
def test_rows_frames_match_jax(lo, hi, asc):
    specs = _framed("rows", lo, hi)
    got, want = _run(["p"], [("o", asc), ("k", True)], specs)
    _assert_same(got, want, specs)


@pytest.mark.parametrize("key", ["o", "o2", "of"],
                         ids=["int_with_nulls", "int", "float"])
@pytest.mark.parametrize("asc", [True, False], ids=["asc", "desc"])
@pytest.mark.parametrize("lo,hi", RANGE_FRAMES, ids=[f"{a}..{b}" for a, b in RANGE_FRAMES])
def test_range_frames_match_jax(lo, hi, asc, key):
    if key == "of":
        # a float order key takes fractional distances
        lo, hi = ((b[0], b[1] / 2) if len(b) == 2 else b for b in (lo, hi))
    specs = _framed("range", lo, hi)
    got, want = _run(["p"], [(key, asc)], specs)
    _assert_same(got, want, specs)


def test_range_frame_over_a_selection_vector():
    sel = np.random.default_rng(6).random(N) < 0.6
    specs = _framed("range", ("p", 4), ("f", 2))
    got, want = _run(["q"], [("o", True)], specs, sel)
    _assert_same(got, want, specs)


# -- through SQL -------------------------------------------------------------

SQL_ROWS = [
    (1, "a", 10.0, 1, 1.0), (2, "b", 20.0, 2, 2.0), (3, "a", 30.0, 2, 10.0),
    (4, None, 40.0, 4, 100.0), (5, "b", None, 7, 4.0), (6, "a", 25.0, 8, 1000.0),
    (7, "c", 5.0, 3, 7.0), (8, "b", 20.0, 3, 8.0),
]

SQL = {
    "row_number_and_partition_sum":
        "SELECT id, v, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v) rn, "
        "SUM(v) OVER (PARTITION BY g) tot "
        "FROM t WHERE v IS NOT NULL AND g IS NOT NULL ORDER BY id",
    "running_sum_and_rank":
        "SELECT id, SUM(v) OVER (PARTITION BY g ORDER BY id) run, "
        "RANK() OVER (ORDER BY v DESC) rk FROM t WHERE v IS NOT NULL ORDER BY id",
    "rows_frames":
        "SELECT id, "
        "SUM(v) OVER (ORDER BY id ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) s3, "
        "AVG(v) OVER (ORDER BY id ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) a3, "
        "MIN(v) OVER (ORDER BY id ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) mn, "
        "COUNT(*) OVER (ORDER BY id ROWS 1 PRECEDING) c2 FROM t ORDER BY id",
    "range_frame":
        "SELECT id, SUM(x) OVER (ORDER BY k RANGE BETWEEN 2 PRECEDING AND 1 FOLLOWING) sr, "
        "MAX(x) OVER (ORDER BY k RANGE BETWEEN 3 PRECEDING AND 1 PRECEDING) mx "
        "FROM t ORDER BY id",
    "range_current_row_peers":
        "SELECT id, SUM(x) OVER (ORDER BY k RANGE BETWEEN CURRENT ROW AND CURRENT ROW) sp "
        "FROM t ORDER BY id",
    "default_frame_includes_peers":
        "SELECT id, SUM(x) OVER (ORDER BY k) r, SUM(x) OVER (ORDER BY k RANGE BETWEEN "
        "UNBOUNDED PRECEDING AND CURRENT ROW) r2 FROM t ORDER BY id",
    "rows_prefix":
        "SELECT id, SUM(x) OVER (ORDER BY k, id ROWS BETWEEN UNBOUNDED PRECEDING AND "
        "CURRENT ROW) r FROM t ORDER BY id",
    "dense_rank_ntile_lead_lag":
        "SELECT id, DENSE_RANK() OVER (PARTITION BY g ORDER BY k) dr, "
        "NTILE(2) OVER (PARTITION BY g ORDER BY id) nt, "
        "LAG(v, 1, -1) OVER (PARTITION BY g ORDER BY id) lg, "
        "LEAD(g, 1, 'zz') OVER (ORDER BY id) ld FROM t ORDER BY id",
    "first_last_value":
        "SELECT id, FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY id) fv, "
        "LAST_VALUE(v) OVER (PARTITION BY g ORDER BY id) lv, "
        "LAST_VALUE(x) OVER (PARTITION BY g ORDER BY id ROWS BETWEEN UNBOUNDED PRECEDING "
        "AND UNBOUNDED FOLLOWING) lvw FROM t ORDER BY id",
    "top_one_per_group":
        "SELECT g, id, v FROM (SELECT g, id, v, ROW_NUMBER() OVER (PARTITION BY g "
        "ORDER BY v DESC, id) rn FROM t) r WHERE rn = 1 ORDER BY g",
    "window_over_group_by":
        "SELECT g, SUM(x) sx, RANK() OVER (ORDER BY SUM(x) DESC) rk FROM t "
        "GROUP BY g ORDER BY g",
    "window_count_min_max":
        "SELECT id, COUNT(v) OVER (PARTITION BY g) c, MIN(v) OVER (PARTITION BY g "
        "ORDER BY id) mn, MAX(x) OVER (PARTITION BY g ORDER BY id ROWS BETWEEN "
        "1 PRECEDING AND 1 FOLLOWING) mx FROM t ORDER BY id",
}


@pytest.fixture(scope="module")
def sql_sessions():
    data = pa.table({
        "id": pa.array([r[0] for r in SQL_ROWS], pa.int64()),
        "g": pa.array([r[1] for r in SQL_ROWS], pa.string()),
        "v": pa.array([r[2] for r in SQL_ROWS], pa.float64()),
        "k": pa.array([r[3] for r in SQL_ROWS], pa.int64()),
        "x": pa.array([r[4] for r in SQL_ROWS], pa.float64()),
    })
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute("CREATE TABLE t (id BIGINT, g VARCHAR(4), v DOUBLE, k BIGINT, x DOUBLE)")
        s.load_arrow("t", data)
        out.append(s)
    return out


@pytest.mark.parametrize("name", list(SQL))
def test_window_sql_matches_jax(sql_sessions, name):
    jsess, tsess = sql_sessions
    got, want = tsess.query(SQL[name]), jsess.query(SQL[name])
    assert got == want


@pytest.mark.parametrize("name", list(SQL))
def test_window_sql_plan_matches_jax(sql_sessions, name):
    # both sessions annotate each scan with its access path
    jsess, tsess = sql_sessions
    want = jsess.execute("EXPLAIN " + SQL[name]).plan_text
    assert tsess.execute("EXPLAIN " + SQL[name]).plan_text == want
