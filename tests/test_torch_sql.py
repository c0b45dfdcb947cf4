"""The port's SQL path end to end against the JAX package's Session.

The same DDL and the same Arrow data (numpy, fixed seed) go into the JAX
``Session()`` and the port's ``Session(device="cpu")``; every query runs in
both and the rows are compared.  Keys, counts, NULLs and ORDER BY order
match exactly.  Floats match to rtol 1e-4 where the port's group-by kernel
path (float32 output contract, taken for 512 < groups <= 4096) meets the
JAX segment path (JAX on the CPU never takes its Pallas gate), and to
rtol 1e-9 elsewhere (float64 sums taken in another order).
"""

import math

import numpy as np
import pyarrow as pa
import pytest

from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.ops import group_kernels as gk

ROWS = 200_000

SMOKE = {
    # the bench headline: 16 groups, segment path in both packages
    "headline": ("SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
                 "WHERE v*2+1 > 0.5 GROUP BY g16 ORDER BY g16", 1e-9, set()),
    # 2048 groups: the port's K3 (COUNT(*)) + K2 (SUM/AVG/MIN on FLOAT)
    "fused": ("SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
              "WHERE v*2+1 > 0.5 GROUP BY g ORDER BY g", 1e-4,
              {"partition_histogram", "fused_group_aggregate"}),
    # 2048 groups, DOUBLE column, no MIN/MAX: K1
    "sum": ("SELECT g, SUM(w), AVG(w) FROM t WHERE w > -1 GROUP BY g ORDER BY g",
            1e-4, {"filtered_group_sum"}),
    # integer key in [1000, 1600): dense with key_shift, through the kernels
    "key_shift": ("SELECT h, COUNT(*) c, MAX(v) mx FROM t WHERE g16 < 8 "
                  "GROUP BY h HAVING c > 10 ORDER BY c DESC, h LIMIT 50 OFFSET 5",
                  1e-4, {"partition_histogram", "fused_group_aggregate"}),
    "scalar": ("SELECT COUNT(*), SUM(w), MIN(g), MAX(w) FROM t WHERE v > 1.5", 1e-9, set()),
    "top_rows": ("SELECT g, v, w FROM t WHERE w > 2.5 ORDER BY w DESC LIMIT 20", 1e-9, set()),
}


def smoke_table(rows: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "g": pa.array(rng.integers(0, 2048, rows, dtype=np.int32)),
        "v": pa.array(rng.standard_normal(rows, dtype=np.float32)),
        "w": pa.array(rng.standard_normal(rows)),
        "g16": pa.array(rng.integers(0, 16, rows, dtype=np.int32)),
        "h": pa.array(rng.integers(1000, 1600, rows, dtype=np.int32)),
    })


@pytest.fixture(scope="module")
def smoke_sessions():
    data = smoke_table(ROWS, 7)
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT, h INT)")
        s.load_arrow("t", data)
        out.append(s)
    return out


def assert_rows(got, want, rtol):
    assert len(got) == len(want)
    for r_got, r_want in zip(got, want):
        assert list(r_got) == list(r_want)
        for key, b in r_want.items():
            a = r_got[key]
            if isinstance(b, float) and a is not None:
                assert math.isclose(a, b, rel_tol=rtol, abs_tol=1e-9), (key, a, b)
            else:
                assert a == b, (key, a, b)


@pytest.mark.parametrize("name", list(SMOKE))
def test_smoke_queries_match_jax(smoke_sessions, monkeypatch, name):
    sql, rtol, kernels = SMOKE[name]
    jsess, tsess = smoke_sessions
    ran = set()
    for k in gk.LAUNCHES:
        plain = getattr(gk, f"{k}_plain")

        def spy(*a, _k=k, _plain=plain):
            ran.add(_k)
            return _plain(*a)
        monkeypatch.setattr(gk, f"{k}_plain", spy)
    want = jsess.query(sql)
    got = tsess.query(sql)
    assert_rows(got, want, rtol)
    assert ran == kernels            # the kernel path, through the plain versions
    assert all(c.value == 0 for c in gk.LAUNCHES.values())


def test_nan_in_a_float_column_matches_jax(monkeypatch):
    """700 groups (the port's K2 path): a group holding a +NaN or a -NaN
    gives NaN for SUM, MIN and MAX in both packages; the others match."""
    rng = np.random.default_rng(0)
    g = rng.integers(0, 700, 5000).astype(np.int32)
    v = rng.standard_normal(5000).astype(np.float32)
    v.view(np.uint32)[np.nonzero(g == 5)[0][0]] = 0x7FC00000    # +NaN (numpy's)
    v.view(np.uint32)[np.nonzero(g == 9)[0][1]] = 0xFFC00000    # -NaN (x86's default)
    data = pa.table({"g": g, "v": v})
    sql = "SELECT g, COUNT(*) c, SUM(v) s, MIN(v) mn, MAX(v) mx FROM t GROUP BY g ORDER BY g"
    ran = []
    plain = gk.fused_group_aggregate_plain
    monkeypatch.setattr(gk, "fused_group_aggregate_plain", lambda *a: ran.append(1) or plain(*a))
    rows = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute("CREATE TABLE t (g INT, v FLOAT)")
        s.load_arrow("t", data)
        rows.append(s.query(sql))
    want, got = rows
    assert ran == [1]
    assert [list(r.values())[:2] for r in got] == [list(r.values())[:2] for r in want]
    for r_got, r_want in zip(got, want):
        nan = r_want["g"] in (5, 9)
        for key in ("s", "mn", "mx"):
            assert math.isnan(r_want[key]) == nan and math.isnan(r_got[key]) == nan
            if not nan:
                assert math.isclose(r_got[key], r_want[key], rel_tol=1e-4, abs_tol=1e-9)


def test_plans_match_jax(smoke_sessions):
    jsess, tsess = smoke_sessions
    for sql, _, _ in SMOKE.values():
        # the JAX session annotates scans with their access path; the port
        # has one (the full scan)
        want = jsess.execute("EXPLAIN " + sql).plan_text.replace(" access=full", "")
        assert tsess.execute("EXPLAIN " + sql).plan_text == want


@pytest.fixture(scope="module")
def sql_sessions():
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, g VARCHAR(16), v DOUBLE, d DATE)")
        s.execute("INSERT INTO t (id, g, v, d) VALUES "
                  "(1,'a',10.0,'2024-01-01'),(2,'b',20.0,'2024-01-02'),"
                  "(3,'a',30.0,'2024-02-01'),(4,NULL,40.0,'2024-03-05'),"
                  "(5,'b',NULL,'2024-01-01')")
        out.append(s)
    return out


# the single-table queries of tests/test_sql.py
SQL_QUERIES = {
    "count_star": "SELECT COUNT(*) FROM t",
    "projection_filter": "SELECT id, v*2 AS dv FROM t WHERE v > 15 AND g = 'a'",
    "group_by_with_nulls": "SELECT g, SUM(v) AS s, COUNT(*) n FROM t GROUP BY g "
                           "ORDER BY s DESC, g",
    "group_by_expression": "SELECT MONTH(d) m, COUNT(*) c FROM t GROUP BY m ORDER BY m",
    "having_alias": "SELECT g, COUNT(*) c FROM t GROUP BY g HAVING c >= 2 ORDER BY g",
    "order_limit_desc": "SELECT id FROM t ORDER BY id DESC LIMIT 2",
    "order_limit_offset": "SELECT id FROM t ORDER BY id LIMIT 2 OFFSET 1",
    "nulls_order": "SELECT g, v FROM t ORDER BY v, g DESC",
    "dates": "SELECT id, d FROM t WHERE d >= '2024-01-02' AND v IS NOT NULL ORDER BY d, id",
}


@pytest.mark.parametrize("name", list(SQL_QUERIES))
def test_single_table_sql_matches_jax(sql_sessions, name):
    jsess, tsess = sql_sessions
    sql = SQL_QUERIES[name]
    assert_rows(tsess.query(sql), jsess.query(sql), 1e-12)


def test_expected_rows_of_test_sql(sql_sessions):
    _, tsess = sql_sessions
    assert tsess.execute("SELECT COUNT(*) FROM t").scalar() == 5
    assert tsess.query(SQL_QUERIES["group_by_with_nulls"]) == [
        {"g": None, "s": 40.0, "n": 1}, {"g": "a", "s": 40.0, "n": 2},
        {"g": "b", "s": 20.0, "n": 2}]
    assert tsess.query(SQL_QUERIES["group_by_expression"]) == [
        {"m": 1, "c": 3}, {"m": 2, "c": 1}, {"m": 3, "c": 1}]


def test_set_global_flag_moves_both_packages_off_the_kernel_path(smoke_sessions, monkeypatch):
    from baikaldb_tpu.utils.flags import FLAGS as JFLAGS
    from baikaldb_tpu_torch.utils.flags import FLAGS as TFLAGS

    jsess, tsess = smoke_sessions
    ran = []
    monkeypatch.setattr(gk, "fused_group_aggregate_plain",
                        lambda *a: ran.append(1))
    sql = SMOKE["fused"][0]
    try:
        for s in (jsess, tsess):
            s.execute("SET GLOBAL pallas_group_kernels = 0")
        assert not JFLAGS.pallas_group_kernels and not TFLAGS.pallas_group_kernels
        assert_rows(tsess.query(sql), jsess.query(sql), 1e-9)
        assert not ran
    finally:
        for s in (jsess, tsess):
            s.execute("SET GLOBAL pallas_group_kernels = 1")


def test_traced_query_records_the_session_spans(smoke_sessions):
    """With ``tracing`` on, a query returns the same rows and its trace holds
    the session's spans (the chip run reads them for its host breakdown)."""
    from baikaldb_tpu_torch.obs import trace

    _, tsess = smoke_sessions
    sql = SMOKE["fused"][0]
    want = tsess.query(sql)
    try:
        tsess.execute("SET GLOBAL tracing = 1")
        got = tsess.query(sql)
    finally:
        tsess.execute("SET GLOBAL tracing = 0")
    assert got == want
    rec = [t for t in trace.TRACER.list() if t["text"] == sql][-1]
    names = {s["name"] for s in rec["spans"]}
    assert {"query", "parse", "plan.build", "exec.batches", "exec.run",
            "egress.arrow"} <= names
