"""The port's rollup indexes (index/rollup.py and the session's rewrite)
against the JAX package's.

The cases of tests/test_rollup.py run in a JAX ``Session`` (CPU, x64) and a
port ``Session(device="cpu")`` over the same seeded rows: EXPLAIN naming the
hidden rollup table (compared whole), the answers against each package's
own base-table scan, refresh after DML, the rewrite's coverage rules, DROP
ROLLUP / DROP TABLE, a ``data_dir`` reopened, COUNT over no group, column
names, and the transaction gate.  Keys, counts and integer sums are exact;
DOUBLE sums and averages within rtol 1e-9 (float64 partials re-aggregated),
and FLOAT ones within the parity contract's rtol 1e-4.
"""

import math

import numpy as np
import pytest

from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession


def _key(r):
    return tuple((k, repr(v)) for k, v in sorted(r.items()))


def _same(got, want, rtol, ordered=True):
    assert len(got) == len(want), (got, want)
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    for a, b in zip(got, want):
        assert list(a) == list(b), (a, b)
        for k in b:
            if isinstance(b[k], float) and a[k] is not None:
                assert math.isclose(a[k], b[k], rel_tol=rtol, abs_tol=1e-9), (k, a, b)
            else:
                assert a[k] == b[k], (k, a, b)


class Pair:
    def __init__(self, jdb=None, tdb=None):
        self.j = JSession(jdb or JDatabase())
        self.t = TSession(tdb or TDatabase("cpu"))

    def run(self, sql, rtol=1e-9, ordered=True):
        outs = []
        for s in (self.j, self.t):
            try:
                r = s.execute(sql)
                outs.append(("rows", r.to_pylist()) if r.arrow is not None
                            else ("affected", r.affected_rows))
            except Exception as e:     # noqa: BLE001 — compared across packages
                outs.append(("error", type(e).__name__))
        (jk, jv), (tk, tv) = outs
        assert tk == jk, (sql, outs)
        if tk == "rows":
            _same(tv, jv, rtol, ordered)
        else:
            assert tv == jv, (sql, outs)
        return tv

    def script(self, stmts):
        for q in stmts:
            self.run(q)

    def explain(self, sql):
        got = self.t.execute("EXPLAIN " + sql).plan_text
        assert got == self.j.execute("EXPLAIN " + sql).plan_text
        return got

    def without_rollups(self, sql, table="sales", rtol=1e-9):
        """``sql`` answered from the rollup equals the base scan, in the
        port (the rollups hidden from the catalog for the second run)."""
        got = self.t.query(sql)
        info = self.t.db.catalog.get_table("default", table)
        saved = info.indexes
        info.indexes = [ix for ix in saved if ix.kind != "rollup"]
        try:
            want = self.t.query(sql)
        finally:
            info.indexes = saved
        _same(got, want, rtol, ordered=False)
        return got


@pytest.fixture
def pair():
    p = Pair()
    p.run("CREATE TABLE sales (id BIGINT PRIMARY KEY, region VARCHAR(8), "
          "product VARCHAR(8), qty INT, price DOUBLE)")
    rng = np.random.default_rng(11)
    regions, products = ["east", "west", "north"], ["a", "b", "c", "d"]
    rows = [f"({i},'{regions[int(rng.integers(0, 3))]}','{products[int(rng.integers(0, 4))]}',"
            f"{int(rng.integers(1, 20))},{round(float(rng.uniform(1, 100)), 2)})"
            for i in range(400)]
    p.run("INSERT INTO sales VALUES " + ",".join(rows))
    p.run("ALTER TABLE sales ADD ROLLUP by_rp (region, product, AGGREGATE(qty, price))")
    return p


@pytest.mark.parametrize("sql", [
    "SELECT region, COUNT(*) c, SUM(qty) q, AVG(price) a, MIN(price) mn, MAX(qty) mx "
    "FROM sales GROUP BY region ORDER BY region",
    "SELECT product, SUM(price) s FROM sales WHERE region <> 'east' GROUP BY product "
    "HAVING SUM(qty) > 10 ORDER BY s DESC",
    "SELECT region, COUNT(qty) c FROM sales GROUP BY region ORDER BY region",
    "SELECT region, product, SUM(qty) q, COUNT(price) n FROM sales GROUP BY region, product "
    "ORDER BY region, product",
    "SELECT SUM(qty) q, MAX(price) m FROM sales",
])
def test_rollup_rewrite_used_and_correct(pair, sql):
    assert "__rollup_sales_by_rp" in pair.explain(sql)
    pair.run(sql)
    pair.without_rollups(sql)


def test_rollup_refreshes_on_dml(pair):
    q0 = pair.run("SELECT SUM(qty) q FROM sales")[0]["q"]
    pair.run("INSERT INTO sales VALUES (9999,'east','a',1000,5.0)")
    q1 = pair.run("SELECT region, SUM(qty) q FROM sales GROUP BY region ORDER BY q DESC")
    assert sum(r["q"] for r in q1) == q0 + 1000
    pair.run("UPDATE sales SET qty = qty + 1 WHERE region = 'west'")
    pair.run("SELECT region, SUM(qty) q, MIN(qty) m FROM sales GROUP BY region ORDER BY region")
    pair.run("DELETE FROM sales WHERE id = 9999")
    pair.run("SELECT SUM(qty) q FROM sales")
    pair.without_rollups("SELECT region, SUM(qty) q FROM sales GROUP BY region")


@pytest.mark.parametrize("sql", [
    "SELECT region, SUM(qty) FROM sales WHERE price > 50 GROUP BY region",
    "SELECT region, COUNT(DISTINCT qty) FROM sales GROUP BY region",
    "SELECT region, qty FROM sales",
    "SELECT region, SUM(id) FROM sales GROUP BY region",
    "SELECT s.region, COUNT(*) FROM sales s JOIN sales t ON s.id = t.id GROUP BY s.region",
])
def test_rollup_not_used_when_uncovered(pair, sql):
    assert "__rollup" not in pair.explain(sql)
    pair.run(sql, ordered=False)


def test_rollup_not_used_for_a_new_column(pair):
    pair.run("ALTER TABLE sales ADD COLUMN weight DOUBLE")
    assert "__rollup" not in pair.explain("SELECT region, SUM(weight) FROM sales "
                                          "GROUP BY region")


def test_rollup_hidden_and_dropped(pair):
    assert pair.run("SHOW TABLES") == [{"Tables_in_default": "sales"}]
    pair.run("SHOW TABLE STATUS")
    pair.run("SHOW INDEX FROM sales")
    pair.run("ALTER TABLE sales DROP ROLLUP by_rp")
    assert "__rollup" not in pair.explain("SELECT region, SUM(qty) FROM sales GROUP BY region")
    assert not pair.t.db.catalog.has_table("default", "__rollup_sales_by_rp")
    pair.script(["ALTER TABLE sales DROP ROLLUP by_rp",
                 "ALTER TABLE sales ADD ROLLUP r2 (region, AGGREGATE(qty))",
                 "ALTER TABLE sales ADD ROLLUP r2 (region, AGGREGATE(qty))",
                 "ALTER TABLE sales ADD ROLLUP r3 (nosuch, AGGREGATE(qty))",
                 "ALTER TABLE sales DROP INDEX r2",
                 "DROP TABLE sales"])
    assert not pair.t.db.catalog.has_table("default", "__rollup_sales_r2")
    assert "default.__rollup_sales_r2" not in pair.t.db.stores


def test_rollup_durable_across_restart(tmp_path):
    dirs = (str(tmp_path / "j"), str(tmp_path / "t"))
    p = Pair(JDatabase(data_dir=dirs[0]), TDatabase("cpu", data_dir=dirs[1]))
    p.script(["CREATE TABLE t (id BIGINT PRIMARY KEY, g VARCHAR(4), v INT)",
              "INSERT INTO t VALUES (1,'a',10),(2,'a',20),(3,'b',5)",
              "ALTER TABLE t ADD ROLLUP byg (g, AGGREGATE(v))"])
    assert p.run("SELECT g, SUM(v) s FROM t GROUP BY g ORDER BY g") == \
        [{"g": "a", "s": 30}, {"g": "b", "s": 5}]
    p.j.db.checkpoint()
    p.t.db.checkpoint()
    p2 = Pair(JDatabase(data_dir=dirs[0]), TDatabase("cpu", data_dir=dirs[1]))
    assert "__rollup_t_byg" in p2.explain("SELECT g, SUM(v) FROM t GROUP BY g")
    p2.run("INSERT INTO t VALUES (4, 'b', 1)")
    assert p2.run("SELECT g, SUM(v) s FROM t GROUP BY g ORDER BY g") == \
        [{"g": "a", "s": 30}, {"g": "b", "s": 6}]
    # the JAX package's directory in the port
    t3 = TSession(TDatabase("cpu", data_dir=dirs[0]))
    assert t3.query("SELECT g, SUM(v) s FROM t GROUP BY g ORDER BY g") == \
        [{"g": "a", "s": 30}, {"g": "b", "s": 6}]


def test_rollup_count_empty_is_zero(pair):
    assert pair.run("SELECT COUNT(*) c FROM sales WHERE region = 'nowhere'") == [{"c": 0}]
    p = Pair()
    p.script(["CREATE TABLE e (id BIGINT PRIMARY KEY, g VARCHAR(4), v INT)",
              "ALTER TABLE e ADD ROLLUP r (g, AGGREGATE(v))"])
    assert p.run("SELECT COUNT(*) c FROM e") == [{"c": 0}]
    assert p.run("SELECT COUNT(v) c FROM e") == [{"c": 0}]
    p.run("SELECT g, SUM(v) FROM e GROUP BY g")


def test_rollup_keeps_column_names(pair):
    sql = "SELECT region, COUNT(*), SUM(qty), AVG(price) FROM sales GROUP BY region ORDER BY region"
    got = pair.run(sql)
    assert list(got[0]) == ["region", "count_star()", "sum(qty)", "avg(price)"]
    pair.without_rollups(sql)


def test_rollup_invisible_inside_transaction(pair):
    pair.script(["BEGIN", "INSERT INTO sales VALUES (8888,'east','a',500,1.0)"])
    in_txn = pair.run("SELECT SUM(qty) q FROM sales WHERE region='east'")
    pair.run("ROLLBACK")
    after = pair.run("SELECT SUM(qty) q FROM sales WHERE region='east'")
    assert in_txn[0]["q"] == after[0]["q"] + 500


def test_rollup_over_float_measures_within_tolerance():
    """FLOAT partials: SUM re-aggregates float64 sums of float32 values,
    held to the parity contract's rtol 1e-4 against the JAX package and
    against the base scan."""
    rng = np.random.default_rng(5)
    p = Pair()
    p.run("CREATE TABLE f (g INT, v FLOAT, w DOUBLE, g16 INT)")
    vals = ", ".join(f"({int(rng.integers(0, 40))}, {float(np.float32(rng.standard_normal()))!r}, "
                     f"{float(rng.standard_normal())!r}, {int(rng.integers(0, 16))})"
                     for _ in range(3000))
    p.run(f"INSERT INTO f VALUES {vals}")
    p.script(["ALTER TABLE f ADD ROLLUP r_g (g, AGGREGATE(v, w))",
              "ALTER TABLE f ADD ROLLUP r_g16 (g16, AGGREGATE(v))"])
    for sql in ("SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM f GROUP BY g ORDER BY g",
                "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM f GROUP BY g16 ORDER BY g16",
                "SELECT g, SUM(w), AVG(w), MAX(w) FROM f GROUP BY g ORDER BY g"):
        plan = p.explain(sql)
        assert "__rollup_f_r_g" in plan
        p.run(sql, rtol=1e-4)
        p.without_rollups(sql, table="f", rtol=1e-4)
