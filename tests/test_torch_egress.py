"""The port's egress functions and catalog statements against the JAX
package's Session.

FORMAT, DATE_FORMAT, HEX, BIN and OCT of numbers (select list, WHERE
inversion, GROUP BY buckets, host ORDER BY), the statements that need only
the catalog (CREATE / DROP DATABASE, USE, CREATE / DROP VIEW, DROP TABLE,
TRUNCATE, DESCRIBE, the catalog SHOW forms) and SELECT ... INTO OUTFILE run
in the JAX ``Session()`` and the port's ``Session(device="cpu")`` on the
same DDL and the same seeded data.  Rows match exactly (the formatted
strings are the same host code in both packages; float sums to rtol 1e-9),
as multisets where the query has no ORDER BY.
"""

import math

import numpy as np
import pyarrow as pa
import pytest

from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu_torch.exec.session import Session as TSession

DDL = ("CREATE TABLE t (id BIGINT, d DATE, ts DATETIME, v DOUBLE, n INT, b BIGINT, "
       "s VARCHAR(16), PRIMARY KEY (id))")
ROWS = 300


def _table() -> pa.Table:
    rng = np.random.default_rng(11)
    d = rng.integers(18_000, 20_000, ROWS).astype("datetime64[D]")
    ts = (rng.integers(1_500_000_000, 1_700_000_000, ROWS) * 1_000_000).astype(
        "datetime64[us]")
    null = rng.random(ROWS) < 0.1
    return pa.table({
        "id": pa.array(np.arange(ROWS, dtype=np.int64)),
        "d": pa.array(d, mask=null),
        "ts": pa.array(ts),
        "v": pa.array(rng.normal(size=ROWS) * 10_000, mask=rng.random(ROWS) < 0.1),
        "n": pa.array(rng.integers(-5, 300, ROWS).astype(np.int32), mask=null[::-1].copy()),
        "b": pa.array(rng.integers(0, 1 << 40, ROWS)),
        "s": pa.array([f"k{i % 7}" for i in range(ROWS)]),
    })


@pytest.fixture(scope="module")
def sessions():
    data = _table()
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute(DDL)
        s.load_arrow("t", data)
        out.append(s)
    return out


def _same_rows(got, want, ordered: bool):
    def norm(rows):
        return [tuple(r.items()) for r in rows]

    g, w = norm(got), norm(want)
    if not ordered:
        key = repr
        g, w = sorted(g, key=key), sorted(w, key=key)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        assert [k for k, _ in rg] == [k for k, _ in rw]
        for (k, a), (_, b) in zip(rg, rw):
            if isinstance(b, float) and isinstance(a, float):
                assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-9), (k, a, b)
            else:
                assert a == b, (k, a, b)


EGRESS = {
    # (sql, ordered)
    "select_list": ("SELECT id, FORMAT(v, 2) f2, FORMAT(v, 0) f0, DATE_FORMAT(d, '%Y-%m-%d') dd, "
                    "DATE_FORMAT(ts, '%H:%i:%s %W') tt, HEX(n) h, BIN(n) bn, OCT(b) o "
                    "FROM t ORDER BY id", True),
    "nested": ("SELECT id, CONCAT(HEX(n + 1), '/', BIN(id)) c, FORMAT(v * 2, 3) f "
               "FROM t WHERE id < 40 ORDER BY id DESC", True),
    "no_order": ("SELECT HEX(b) h, DATE_FORMAT(d, '%Y') y FROM t WHERE id % 3 = 0", False),
    "where_month": ("SELECT id FROM t WHERE DATE_FORMAT(d, '%Y-%m') = '2021-03' ORDER BY id",
                    True),
    "where_range": ("SELECT id, d FROM t WHERE DATE_FORMAT(d, '%Y-%m-%d') >= '2022-06' "
                    "AND DATE_FORMAT(d, '%Y') < '2024' ORDER BY id", True),
    "where_between": ("SELECT id FROM t WHERE DATE_FORMAT(d, '%Y') BETWEEN '2020' AND "
                      "'2021' ORDER BY id", True),
    "where_in": ("SELECT id, n FROM t WHERE HEX(n) IN ('FF', '1A', '7', '0x10') "
                 "ORDER BY id", True),
    "where_radix": ("SELECT id, n FROM t WHERE BIN(n) <> '101' AND OCT(n) <> '0xff' "
                    "ORDER BY id LIMIT 25", True),
    "group_by_bucket": ("SELECT DATE_FORMAT(d, '%Y-%m') m, COUNT(*) c, SUM(v) sv FROM t "
                        "GROUP BY DATE_FORMAT(d, '%Y-%m') ORDER BY m", True),
    "group_by_alias": ("SELECT DATE_FORMAT(d, '%Y') y, COUNT(*) c FROM t GROUP BY y", False),
    "order_by_formatted": ("SELECT id, HEX(n) h FROM t WHERE n IS NOT NULL "
                           "ORDER BY HEX(n) DESC, id LIMIT 12 OFFSET 3", True),
}


@pytest.mark.parametrize("name", list(EGRESS))
def test_egress_functions_match_jax(sessions, name):
    sql, ordered = EGRESS[name]
    jsess, tsess = sessions
    want = jsess.query(sql)
    got = tsess.query(sql)
    assert want, name
    _same_rows(got, want, ordered)


@pytest.fixture
def pair():
    """A fresh JAX session and port session over the same table."""
    data = _table()
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute(DDL)
        s.load_arrow("t", data)
        out.append(s)
    return out


def _run(pair, sql):
    return [s.execute(sql) for s in pair]


def _check(pair, sql, ordered=True):
    want, got = (s.query(sql) for s in pair)
    _same_rows(got, want, ordered)
    return got


STATEMENTS = {
    "databases": (["CREATE DATABASE x", "CREATE DATABASE IF NOT EXISTS x", "USE x",
                   "CREATE TABLE u (a INT, b DOUBLE)", "INSERT INTO u VALUES (1, 2.5), (3, NULL)"],
                  ["SHOW DATABASES", "SHOW TABLES", "SELECT a, b FROM u ORDER BY a",
                   "SHOW TABLES FROM default"]),
    "drop_database": (["CREATE DATABASE y", "CREATE TABLE y.w (a INT)", "DROP DATABASE y",
                       "DROP DATABASE IF EXISTS y"],
                      ["SHOW DATABASES", "SHOW TABLES"]),
    "views": (["CREATE VIEW v1 AS SELECT id, v FROM t WHERE id < 10",
               "CREATE OR REPLACE VIEW v1 (k, val) AS SELECT id, v * 2 FROM t WHERE id < 5"],
              ["SELECT * FROM v1 ORDER BY k", "SHOW FULL TABLES", "DESCRIBE v1",
               "SHOW CREATE TABLE v1", "SHOW COLUMNS FROM v1"]),
    "drop_view": (["CREATE VIEW v2 AS SELECT id FROM t", "DROP VIEW v2",
                   "DROP VIEW IF EXISTS v2"],
                  ["SHOW TABLES", "SHOW FULL TABLES"]),
    "describe": ([], ["DESCRIBE t", "SHOW COLUMNS FROM t", "SHOW FULL COLUMNS FROM t LIKE '%s'",
                      "SHOW INDEX FROM t", "SHOW CREATE TABLE t", "SHOW TABLES LIKE 'T%'"]),
    "variables": (["SET sql_mode = 'ANSI'", "SET GLOBAL streaming_chunk_rows = 4096"],
                  ["SHOW VARIABLES LIKE 'streaming%'", "SHOW VARIABLES LIKE 'version'",
                   "SHOW VARIABLES LIKE 'sql_mode'"]),
    "truncate": (["TRUNCATE TABLE t"],
                 ["SELECT COUNT(*) c FROM t", "SHOW TABLES"]),
    "drop_table": (["CREATE TABLE z (a INT)", "DROP TABLE z", "DROP TABLE IF EXISTS z",
                    "DROP TABLE t"],
                   ["SHOW TABLES"]),
}


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_catalog_statements_match_jax(pair, name):
    from baikaldb_tpu.utils.flags import FLAGS as JFLAGS
    from baikaldb_tpu_torch.utils.flags import FLAGS as TFLAGS

    stmts, checks = STATEMENTS[name]
    prev = (JFLAGS.streaming_chunk_rows, TFLAGS.streaming_chunk_rows)
    try:
        for sql in stmts:
            _run(pair, sql)
        for sql in checks:
            _check(pair, sql, ordered="ORDER BY" in sql or sql.startswith(("SHOW", "DESC")))
    finally:
        JFLAGS.set_flag("streaming_chunk_rows", prev[0])
        TFLAGS.set_flag("streaming_chunk_rows", prev[1])


def test_dropped_table_is_gone_and_its_store_released(pair):
    tsess = pair[1]
    store = tsess.db.stores["default.t"]
    store.device_table_batch()
    _run(pair, "DROP TABLE t")
    assert "default.t" not in tsess.db.stores and store._device_batch is None
    for s in pair:
        with pytest.raises(Exception, match="t"):
            s.query("SELECT COUNT(*) FROM t")
    # a new table of the same name starts empty
    _run(pair, "CREATE TABLE t (a INT)")
    _check(pair, "SELECT COUNT(*) c FROM t")


def test_select_into_outfile_matches_jax(pair, tmp_path):
    sql = ("SELECT id, v, d, s, HEX(n) h FROM t WHERE id < 50 ORDER BY id "
           "INTO OUTFILE '{}' FIELDS TERMINATED BY ',' LINES TERMINATED BY '\\n'")
    paths = [tmp_path / "jax.csv", tmp_path / "port.csv"]
    counts = [s.execute(sql.format(p)).affected_rows for s, p in zip(pair, paths)]
    assert counts == [50, 50]
    assert paths[0].read_text() == paths[1].read_text()
    assert "\\N" in paths[1].read_text()            # NULLs as \N
    for s, p in zip(pair, paths):                    # never overwrites
        with pytest.raises(Exception, match="already exists"):
            s.execute(sql.format(p))


@pytest.mark.parametrize("what", ["PROCESSLIST", "STATUS", "PROFILES"])
def test_show_forms_of_unported_planes_raise(sessions, what):
    """SHOW PROCESSLIST, STATUS and PROFILES read the observability plane,
    ported since: each gives the JAX session's rows (without the columns
    that read the clock or each package's own connection ids)."""
    from baikaldb_tpu.obs.trace import TRACER as JTRACER
    from baikaldb_tpu.utils.flags import FLAGS as JFLAGS
    from baikaldb_tpu_torch.obs.trace import TRACER as TTRACER
    from baikaldb_tpu_torch.utils.flags import FLAGS as TFLAGS

    def run(s, sql):
        rows = s.query(sql)
        if what == "PROCESSLIST":
            return [{k: v for k, v in r.items() if k not in ("Id", "Time")} for r in rows]
        if what == "PROFILES":
            return [(r["Kind"], r["Query"], r["Duration_ms"] > 0.0) for r in rows]
        return rows

    if what == "PROFILES":
        for tracer in (JTRACER, TTRACER):
            tracer.clear()
        for f in (JFLAGS, TFLAGS):
            f.set_flag("tracing", True)
        try:
            for s in sessions:
                s.query("SELECT COUNT(*) FROM t WHERE n > 10")
            got = [run(s, "SHOW PROFILES") for s in sessions]
        finally:
            for f in (JFLAGS, TFLAGS):
                f.set_flag("tracing", False)
            for tracer in (JTRACER, TTRACER):
                tracer.clear()
        assert got[1] == got[0] == [("query", "SELECT COUNT(*) FROM t WHERE n > 10", True)]
        return
    sql = {"PROCESSLIST": "SHOW FULL PROCESSLIST",
           "STATUS": "SHOW STATUS LIKE 'health.%'"}[what]
    got = [run(s, sql) for s in sessions]
    assert got[1] == got[0] and got[1]
    if what == "STATUS":
        names = [[r["Variable_name"] for r in s.query("SHOW STATUS LIKE 'query_latency.%'")]
                 for s in sessions]
        assert names[1] == names[0] == [f"query_latency.{f}" for f in (
            "avg_ms", "count", "max_ms", "p50_ms", "p95_ms", "p99_ms")]


@pytest.mark.parametrize("sql", [
    "SELECT m FROM (SELECT DATE_FORMAT(d, '%Y') m FROM t) x",
    "SELECT b FROM (SELECT BIN(n) b, id FROM t) x WHERE id < 3",
])
def test_egress_functions_inside_a_derived_table_fail_as_in_jax(sessions, sql):
    """A derived table's items reach the device plan, not the egress stage:
    both packages refuse them with the compiler's error."""
    msgs = []
    for s in sessions:
        with pytest.raises(Exception) as err:
            s.query(sql)
        msgs.append((type(err.value).__name__, str(err.value)))
    assert msgs[0] == msgs[1]
