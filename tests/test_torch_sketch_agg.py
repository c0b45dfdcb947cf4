"""Key hashing and the sketch aggregates of the port against the JAX package.

The same numpy inputs (fixed seeds) go through ``baikaldb_tpu`` (CPU, x64)
and ``baikaldb_tpu_torch`` on the CPU.  The parity contract:

- ``split64``, ``mix32``, ``hash_columns`` and ``partition_ids`` are
  bit-identical on every lane type: int16/int32/int64, bool, float32 and
  float64 (+0.0 and -0.0, NaN, infinities, subnormals) and string codes;
- HLL registers and APPROX_COUNT_DISTINCT estimates are exact (same hash,
  integer registers, and a float64 sum of at most 512 dyadic terms, which is
  exact in any order);
- PERCENTILE and MEDIAN match to rtol 1e-12, scalar and grouped, with NULL
  lanes, all-NULL groups (NULL result) and filters that leave no row (the
  port answers NULL there, where the JAX package raises);
- NULLs and ORDER BY order are exact.
"""

import datetime
import math

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from baikaldb_tpu.column.batch import Column as JColumn
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.ops import hashagg as jagg
from baikaldb_tpu.utils import hashing as jh
from baikaldb_tpu_torch.column.batch import Column as TColumn
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.ops import hashagg as tagg
from baikaldb_tpu_torch.types import LType as TLType
from baikaldb_tpu_torch.utils import hashing as th


def _lanes(kind: str, n: int = 4000) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "int16":
        x = rng.integers(-2**15, 2**15, n, dtype=np.int16)
        x[:3] = [-2**15, -1, 2**15 - 1]
    elif kind == "int32":
        x = rng.integers(-2**31, 2**31, n, dtype=np.int32)
        x[:4] = [-2**31, -1, 0, 2**31 - 1]
    elif kind == "int64":
        x = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
        x[:5] = [-2**63, -1, 0, 2**63 - 1, 2**32]
    elif kind == "codes":                      # dictionary codes, -1 = NULL
        x = rng.integers(-1, 150_000, n).astype(np.int32)
    elif kind == "bool":
        x = rng.random(n) < 0.5
    elif kind == "float32":
        x = (rng.standard_normal(n) * 1e3).astype(np.float32)
        x[:8] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, -3e-39, 3.4e38]
    else:                                      # float64
        x = rng.standard_normal(n) * 1e6
        x[:10] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324, -2e-310,
                  1.7e308, 2.0**53, 123456789.0]
    return x


KINDS = ["int16", "int32", "int64", "codes", "bool", "float32", "float64"]


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("kind", KINDS)
def test_hash_columns_bit_identical(kind):
    x = _lanes(kind)
    want = _np(jh.hash_columns([jnp.asarray(x)]))
    got = th.hash_columns([torch.from_numpy(x)]).numpy()
    np.testing.assert_array_equal(got, want)
    # the fold of several columns, the second a fixed int32 stream
    y = np.arange(len(x), dtype=np.int32) * 7 - 3
    want2 = _np(jh.hash_columns([jnp.asarray(x), jnp.asarray(y)], seed=99))
    got2 = th.hash_columns([torch.from_numpy(x), torch.from_numpy(y)], seed=99).numpy()
    np.testing.assert_array_equal(got2, want2)


@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_split64_bit_identical(kind):
    x = _lanes(kind)
    lo_j, hi_j = jh.split64(jnp.asarray(x))
    lo_t, hi_t = th.split64(torch.from_numpy(x))
    np.testing.assert_array_equal(lo_t.numpy(), _np(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), _np(hi_j))


def test_mix32_and_partition_ids_bit_identical():
    x = np.concatenate([np.arange(0, 1 << 16, dtype=np.uint32),
                        np.random.default_rng(3).integers(0, 2**32, 50_000,
                                                          dtype=np.uint32),
                        np.asarray([2**32 - 1, 2**31, 2**31 - 1], np.uint32)])
    np.testing.assert_array_equal(th.mix32(torch.from_numpy(x.astype(np.int64))).numpy(),
                                  _np(jh.mix32(jnp.asarray(x))))
    k = _lanes("int64")
    for parts in (1, 7, 64, 1000):
        np.testing.assert_array_equal(
            th.partition_ids([torch.from_numpy(k)], parts).numpy(),
            np.asarray(jh.partition_ids([jnp.asarray(k)], parts)))


@pytest.mark.parametrize("kind", ["int32", "int64", "codes", "float32", "float64"])
def test_hll_registers_exact(kind):
    """The registers of 8 groups: a row's slot is its hash mod 512 and its rank
    the leading zeros of a second hash stream, counted exactly."""
    x = _lanes(kind, 20_000)
    rng = np.random.default_rng(4)
    live = rng.random(len(x)) < 0.8
    gid = rng.integers(0, 8, len(x)).astype(np.int32)
    lt = {"int32": "INT32", "codes": "INT32", "int64": "INT64",
          "float32": "FLOAT32", "float64": "FLOAT64"}[kind]
    jc = JColumn(jnp.asarray(x), None, getattr(jagg.LType, lt))
    tc = TColumn(torch.from_numpy(x), None, getattr(TLType, lt))
    want = np.asarray(jagg._hll_registers(jc, jnp.asarray(live), jnp.asarray(gid), 8))
    got = tagg._hll_registers(tc, torch.from_numpy(live), torch.from_numpy(gid), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tagg._hll_estimate(got).numpy(),
                                  np.asarray(jagg._hll_estimate(jnp.asarray(want))))


def test_hll_estimate_exact_over_register_tables():
    rng = np.random.default_rng(9)
    regs = rng.integers(0, 34, (64, tagg.HLL_REGISTERS)).astype(np.int32)
    regs[:8] = rng.geometric(0.5, (8, tagg.HLL_REGISTERS))   # typical sketches
    regs[8] = 0                                              # empty group
    regs[9, :500] = 0                                        # small-range branch
    want = np.asarray(jagg._hll_estimate(jnp.asarray(regs)))
    np.testing.assert_array_equal(tagg._hll_estimate(torch.from_numpy(regs)).numpy(), want)


# -- through SQL -------------------------------------------------------------

N = 3000


def _sketch_table() -> pa.Table:
    """Groups 0-4 random; group 5 has NULL in every value column; group 6 has
    one row; NULLs elsewhere at 15%; -0.0 and repeated values in the floats."""
    rng = np.random.default_rng(21)
    g = rng.integers(0, 5, N).astype(np.int32)
    g[:40] = 5
    g[40] = 6
    null = rng.random(N) < 0.15
    null[:40] = True
    null[40] = False

    def col(vals, typ):
        return pa.array([None if m else v for v, m in zip(vals, null)], typ)

    i = rng.integers(-500, 500, N)
    d = np.round(rng.standard_normal(N) * 100, 1)
    d[41:50] = -0.0
    f = rng.standard_normal(N).astype(np.float32)
    words = np.asarray([f"w{k:03d}" for k in range(300)])
    base = datetime.date(1995, 1, 1)
    return pa.table({
        "g": pa.array(g, pa.int32()),
        "i": col([int(v) for v in i], pa.int32()),
        "b": col([int(v) * 10**9 for v in i], pa.int64()),
        "f": col([float(v) for v in f], pa.float32()),
        "d": col([float(v) for v in d], pa.float64()),
        "s": col(list(words[rng.integers(0, 300, N)]), pa.string()),
        "dt": col([base + datetime.timedelta(days=int(v))
                   for v in rng.integers(0, 2000, N)], pa.date32()),
        "ts": col([datetime.datetime(2020, 1, 1) + datetime.timedelta(seconds=int(v))
                   for v in rng.integers(0, 10**7, N)], pa.timestamp("us")),
    })


@pytest.fixture(scope="module")
def sessions():
    data = _sketch_table()
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute("CREATE TABLE sk (g INT, i INT, b BIGINT, f FLOAT, d DOUBLE, "
                  "s VARCHAR(8), dt DATE, ts DATETIME)")
        s.load_arrow("sk", data)
        out.append(s)
    return out


def _same(got: list[dict], want: list[dict], rtol: float):
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        assert list(rg) == list(rw)
        for k, w in rw.items():
            g = rg[k]
            if isinstance(w, float) and isinstance(g, float):
                if math.isnan(w):
                    assert math.isnan(g), (k, g, w)
                else:
                    assert math.isclose(g, w, rel_tol=rtol, abs_tol=0.0), (k, g, w)
            else:
                assert g == w and type(g) is type(w), (k, g, w)


def _check(sessions, sql, rtol=0.0):
    jsess, tsess = sessions
    _same(tsess.query(sql), jsess.query(sql), rtol)


HLL_COLS = ["i", "b", "f", "d", "s", "dt", "ts"]


@pytest.mark.parametrize("col", HLL_COLS)
@pytest.mark.parametrize("grouped", [False, True], ids=["scalar", "grouped"])
def test_approx_count_distinct_exact(sessions, col, grouped):
    if grouped:
        sql = (f"SELECT g, APPROX_COUNT_DISTINCT({col}) AS v, COUNT({col}) AS c "
               "FROM sk GROUP BY g ORDER BY g")
    else:
        sql = f"SELECT APPROX_COUNT_DISTINCT({col}) AS v FROM sk"
    _check(sessions, sql)


PCT_COLS = ["i", "b", "f", "d"]


@pytest.mark.parametrize("col", PCT_COLS)
@pytest.mark.parametrize("grouped", [False, True], ids=["scalar", "grouped"])
def test_percentile_and_median(sessions, col, grouped):
    items = (f"MEDIAN({col}) AS md, PERCENTILE({col}, 0) AS p0, "
             f"PERCENTILE({col}, 0.25) AS p25, PERCENTILE({col}, 0.9) AS p90, "
             f"PERCENTILE({col}, 1) AS p100")
    if grouped:
        sql = f"SELECT g, {items} FROM sk GROUP BY g ORDER BY g"
    else:
        sql = f"SELECT {items} FROM sk"
    _check(sessions, sql, rtol=1e-12)


@pytest.mark.parametrize("sql", [
    # no row passes the filter: APPROX_COUNT_DISTINCT is 0
    "SELECT APPROX_COUNT_DISTINCT(d) AS a, COUNT(*) AS n FROM sk WHERE i > 10000",
    # the all-NULL group 5 and the one-row group 6 among the rest
    "SELECT g, APPROX_COUNT_DISTINCT(d) AS a, PERCENTILE(d, 0.5) AS m, "
    "PERCENTILE(i, 0.75) AS q FROM sk WHERE g >= 4 GROUP BY g ORDER BY g",
    # a sketch beside plain aggregates and a string key
    "SELECT s, COUNT(*) AS n, SUM(i) AS si, APPROX_COUNT_DISTINCT(g) AS a, "
    "MEDIAN(b) AS m FROM sk GROUP BY s ORDER BY n DESC, s LIMIT 20",
    # a filter that keeps part of each group
    "SELECT g, MEDIAN(f) AS m, APPROX_COUNT_DISTINCT(s) AS a FROM sk "
    "WHERE d > 0 GROUP BY g ORDER BY g",
], ids=["empty", "null_group", "string_key", "filtered"])
def test_sketch_edge_cases(sessions, sql):
    _check(sessions, sql, rtol=1e-12)


def test_percentile_of_no_rows_is_null(sessions):
    """MEDIAN over no row is NULL in the port; the JAX package raises there
    (its ``_segment_percentile`` gathers from an empty array), so the port
    is held to MySQL's answer."""
    jsess, tsess = sessions
    sql = "SELECT MEDIAN(d) AS m, PERCENTILE(i, 0.9) AS p FROM sk WHERE i > 10000"
    with pytest.raises(IndexError):
        jsess.query(sql)
    assert tsess.query(sql) == [{"m": None, "p": None}]


def test_all_null_group_gives_null_percentile(sessions):
    _, tsess = sessions
    rows = tsess.query("SELECT g, MEDIAN(d) AS m, APPROX_COUNT_DISTINCT(d) AS a "
                       "FROM sk WHERE g = 5 GROUP BY g")
    assert rows == [{"g": 5, "m": None, "a": 0}]


def test_sketches_skip_the_group_kernels(sessions, monkeypatch):
    """APPROX_COUNT_DISTINCT and PERCENTILE go to the segment path: the gate of
    the hand-written group-by kernels admits COUNT/SUM/AVG/MIN/MAX only."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.ops import group_kernels as gk

    s = Session(device="cpu")
    rng = np.random.default_rng(2)
    s.execute("CREATE TABLE kg (g INT, v FLOAT)")
    s.load_arrow("kg", pa.table({"g": rng.integers(0, 2048, 20_000).astype(np.int32),
                                 "v": rng.standard_normal(20_000).astype(np.float32)}))
    ran = set()
    for k in gk.LAUNCHES:
        plain = getattr(gk, f"{k}_plain")
        monkeypatch.setattr(gk, f"{k}_plain", lambda *a, _k=k, _p=plain: ran.add(_k) or _p(*a))
    s.query("SELECT g, SUM(v) FROM kg GROUP BY g")
    assert ran                       # the gate admits this shape ...
    ran.clear()
    s.query("SELECT g, SUM(v), APPROX_COUNT_DISTINCT(v), MEDIAN(v) FROM kg GROUP BY g")
    assert not ran                   # ... and the sketches keep it off the kernels
