"""The port's global indexes against the JAX package's: the hidden backing
table, GLOBAL UNIQUE's duplicate check (NULLs never conflict), maintenance
by INSERT, UPDATE, DELETE, REPLACE, ON DUPLICATE KEY UPDATE, INSERT ...
SELECT, LOAD DATA, DROP PARTITION and TRUNCATE inside the statement's
transaction, ROLLBACK undoing both tables, the ``global_index(ix:col)``
access path with EXPLAIN compared whole, and DROP INDEX / DROP TABLE taking
the backing table with them.

Each statement runs in a JAX ``Session`` (CPU, x64) and a port
``Session(device="cpu")``; rows, affected counts and error types are
compared exactly, floats within rtol 1e-9, and after every script the
backing table equals the main table's (index cols, pk cols) projection in
both.  The cases mirror tests/test_global_index.py but for its fleet and
cluster-process cases (the replicated tier is not ported) and its online
ADD GLOBAL INDEX cases, which are in tests/test_torch_online_ddl.py.
"""

import math

import numpy as np
import pytest

from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession

BACKING = "__gidx__u__g_email"


def _rowkey(r):
    return tuple(repr(v) for v in r.values())


class Pair:
    def __init__(self):
        self.j = JSession(JDatabase())
        self.t = TSession(TDatabase("cpu"))

    def run(self, sql, ordered=True):
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
            if not ordered:
                jv, tv = sorted(jv, key=_rowkey), sorted(tv, key=_rowkey)
            assert len(tv) == len(jv), (sql, outs)
            for a, b in zip(tv, jv):
                assert list(a) == list(b)
                for k in b:
                    if isinstance(b[k], float) and a[k] is not None:
                        assert math.isclose(a[k], b[k], rel_tol=1e-9), (sql, a, b)
                    else:
                        assert a[k] == b[k], (sql, a, b)
        else:
            assert tv == jv, (sql, outs)
        return tv

    def script(self, stmts):
        return [self.run(q) for q in stmts]

    def explain(self, sql):
        want = self.j.execute("EXPLAIN " + sql).plan_text
        got = self.t.execute("EXPLAIN " + sql).plan_text
        assert got == want
        return got

    def check_backing(self, table="u", index="g_email", cols=("email", "id")):
        """The backing table holds exactly the (index, pk) projection."""
        sel = ", ".join(cols)
        for s in (self.j, self.t):
            main = s.query(f"SELECT {sel} FROM {table}")
            back = s.query(f"SELECT {sel} FROM `__gidx__{table}__{index}`")
            assert sorted(map(_rowkey, main)) == sorted(map(_rowkey, back))
        self.run(f"SELECT {sel} FROM `__gidx__{table}__{index}` ORDER BY {sel}")


UNIQUE_DDL = ("CREATE TABLE u (id BIGINT, email VARCHAR(64), v DOUBLE, PRIMARY KEY (id), "
              "GLOBAL UNIQUE INDEX g_email (email))")
PLAIN_DDL = ("CREATE TABLE u (id BIGINT, email VARCHAR(64), v DOUBLE, PRIMARY KEY (id), "
             "GLOBAL INDEX g_email (email))")


def test_create_table_with_global_index_hides_backing():
    p = Pair()
    p.run(UNIQUE_DDL)
    names = p.run("SHOW TABLES")
    assert [r["Tables_in_default"] for r in names] == ["u"]
    ddl = p.run("SHOW CREATE TABLE u")[0]["Create Table"]
    assert "GLOBAL UNIQUE KEY `g_email` (`email`)" in ddl
    p.run("SHOW FULL TABLES")
    p.run("SHOW TABLE STATUS")
    p.run("SHOW INDEX FROM u")
    # information_schema lists the backing table, as the JAX session does
    p.run("SELECT table_name FROM information_schema.tables "
          "WHERE table_schema = 'default' ORDER BY table_name")
    p.run("SELECT table_name, column_name FROM information_schema.columns "
          "WHERE table_schema = 'default' ORDER BY table_name, column_name")


def test_global_unique_rejects_duplicates_local():
    p = Pair()
    p.script([UNIQUE_DDL,
              "INSERT INTO u VALUES (1, 'a@x', 1.0), (2, 'b@x', 2.0)",
              "INSERT INTO u VALUES (3, 'a@x', 3.0)",
              "INSERT INTO u VALUES (4, NULL, 4.0), (5, NULL, 5.0)",
              "SELECT COUNT(*) n FROM u",
              "INSERT INTO u VALUES (6, 'z@x', 0.0), (7, 'z@x', 0.0)",
              "SELECT COUNT(*) n FROM u"])
    p.check_backing()


def test_global_index_maintained_by_update_delete():
    p = Pair()
    p.script([UNIQUE_DDL,
              "INSERT INTO u VALUES (1, 'a@x', 1.0), (2, 'b@x', 2.0)",
              "UPDATE u SET email = 'c@x' WHERE id = 1",
              "INSERT INTO u VALUES (3, 'a@x', 3.0)",
              "UPDATE u SET email = 'b@x' WHERE id = 3",
              "UPDATE u SET v = 9.0 WHERE id = 2",
              "DELETE FROM u WHERE id = 2",
              "INSERT INTO u VALUES (9, 'b@x', 0.0)",
              "SELECT id FROM u ORDER BY id",
              "UPDATE u SET email = 'q@x' WHERE v > 0.5",
              "UPDATE u SET id = id + 100 WHERE id = 9",
              "SELECT id, email FROM u ORDER BY id"])
    p.check_backing()


def test_select_routes_through_global_index():
    p = Pair()
    p.run(PLAIN_DDL)
    for i in range(50):
        p.run(f"INSERT INTO u VALUES ({i}, 'u{i}@x', {float(i)})")
    assert "global_index(g_email:email)" in p.explain("SELECT v FROM u WHERE email = 'u7@x'")
    assert p.run("SELECT id, v FROM u WHERE email = 'u7@x'") == [{"id": 7, "v": 7.0}]
    p.run("INSERT INTO u VALUES (100, 'u7@x', 100.0)")
    assert [r["id"] for r in p.run("SELECT id FROM u WHERE email = 'u7@x' ORDER BY id")] \
        == [7, 100]
    p.explain("SELECT id FROM u WHERE email = 'u7@x' AND v > 50")
    p.run("SELECT id FROM u WHERE email = 'u7@x' AND v > 50")
    p.explain("SELECT COUNT(*) FROM u WHERE email > 'u7@x'")       # a range: full
    p.run("SELECT id FROM u WHERE email = 'nobody'")
    p.check_backing()


def test_upserts_load_data_and_insert_select_maintain_the_backing_table(tmp_path):
    p = Pair()
    p.script([PLAIN_DDL,
              "INSERT INTO u VALUES (1, 'a', 1.0), (2, 'b', 2.0), (3, 'c', 3.0)",
              "REPLACE INTO u VALUES (2, 'bb', 20.0), (4, 'd', 4.0)",
              "INSERT INTO u VALUES (3, 'x', 0.0), (5, 'e', 5.0) "
              "ON DUPLICATE KEY UPDATE email = VALUES(email)",
              "CREATE TABLE src (id BIGINT, email VARCHAR(64), v DOUBLE)",
              "INSERT INTO src VALUES (10, 's1', 1.5), (11, 's2', 2.5)",
              "INSERT INTO u SELECT * FROM src",
              "SELECT id, email, v FROM u ORDER BY id"])
    p.check_backing()
    path = tmp_path / "more.csv"
    path.write_text("".join(f"{i},l{i % 7},{i / 4}\n" for i in range(20, 60)))
    p.run(f"LOAD DATA INFILE '{path}' INTO TABLE u")
    p.run(f"LOAD DATA INFILE '{path}' INTO TABLE u")          # duplicate keys
    p.explain("SELECT id FROM u WHERE email = 'l3'")
    p.run("SELECT id FROM u WHERE email = 'l3' ORDER BY id")
    p.check_backing()
    p.run("TRUNCATE TABLE u")
    p.check_backing()


def test_unique_load_data_and_replace_conflicts_match_jax(tmp_path):
    p = Pair()
    p.script([UNIQUE_DDL, "INSERT INTO u VALUES (1, 'a', 1.0), (2, 'b', 2.0)"])
    path = tmp_path / "dup.csv"
    path.write_text("7,a,7.0\n8,h,8.0\n")
    p.run(f"LOAD DATA INFILE '{path}' INTO TABLE u")
    p.run("REPLACE INTO u VALUES (2, 'a', 0.0)")
    p.run("REPLACE INTO u VALUES (2, 'b2', 0.0)")
    p.run("INSERT INTO u VALUES (1, 'b2', 0.0) ON DUPLICATE KEY UPDATE email = VALUES(email)")
    p.run("SELECT id, email FROM u ORDER BY id")
    p.check_backing()


def test_transactions_commit_and_roll_back_both_tables():
    p = Pair()
    p.script([UNIQUE_DDL, "INSERT INTO u VALUES (1, 'a', 1.0)",
              "BEGIN", "INSERT INTO u VALUES (2, 'b', 2.0)",
              "UPDATE u SET email = 'aa' WHERE id = 1", "ROLLBACK",
              "SELECT id, email FROM u ORDER BY id"])
    p.check_backing()
    p.script(["BEGIN", "INSERT INTO u VALUES (2, 'b', 2.0)", "DELETE FROM u WHERE id = 1",
              "COMMIT", "INSERT INTO u VALUES (3, 'a', 3.0)",
              "SELECT id, email FROM u ORDER BY id"])
    p.check_backing()


def test_drop_partition_deletes_the_entries():
    p = Pair()
    p.script(["CREATE TABLE u (id BIGINT, email VARCHAR(64), PRIMARY KEY (id), "
              "GLOBAL INDEX g_email (email)) PARTITION BY RANGE (id) ("
              "PARTITION p0 VALUES LESS THAN (10), PARTITION p1 VALUES LESS THAN MAXVALUE)",
              "INSERT INTO u VALUES " + ", ".join(f"({i}, 'e{i % 5}')" for i in range(20)),
              "ALTER TABLE u DROP PARTITION p0",
              "SELECT id FROM u WHERE email = 'e3' ORDER BY id"])
    p.check_backing()


def test_drop_global_index_and_drop_table_drop_backing():
    p = Pair()
    p.script([UNIQUE_DDL, "INSERT INTO u VALUES (1, 'a', 1.0)",
              "ALTER TABLE u DROP INDEX g_email",
              "INSERT INTO u VALUES (2, 'a', 2.0)",
              "SELECT COUNT(*) n FROM u"])
    for s in (p.j, p.t):
        assert not any(n.startswith("__gidx__") for n in s.db.catalog.tables(s.current_db))
    p.script(["CREATE TABLE w (id BIGINT, k BIGINT, PRIMARY KEY (id), GLOBAL INDEX gk (k))",
              "INSERT INTO w VALUES (1, 5)", "DROP TABLE w",
              "CREATE TABLE w (id BIGINT, k BIGINT, PRIMARY KEY (id), GLOBAL INDEX gk (k))",
              "SELECT COUNT(*) n FROM `__gidx__w__gk`"])
    for s in (p.j, p.t):
        assert "default.__gidx__w__gk" in s.db.stores


def test_seeded_dml_keeps_the_backing_table_equal_to_the_projection():
    """A seeded run of point selects and coupled DML (the chip's global-index
    phase at a small size): every select equals the JAX session's and the
    same statement over a table without the index."""
    rng = np.random.default_rng(5)
    p = Pair()
    p.script(["CREATE TABLE g (id BIGINT, k BIGINT, c VARCHAR(16), PRIMARY KEY (id), "
              "GLOBAL INDEX k_1 (k))",
              "CREATE TABLE n (id BIGINT, k BIGINT, c VARCHAR(16), PRIMARY KEY (id))"])
    rows = ", ".join(f"({i}, {int(k)}, 'c{i % 11}')"
                     for i, k in enumerate(rng.integers(0, 300, 1500)))
    p.run(f"INSERT INTO g VALUES {rows}")
    p.run(f"INSERT INTO n VALUES {rows}")
    for k in rng.integers(0, 300, 12):
        got = p.run(f"SELECT id, k, c FROM g WHERE k = {int(k)}", ordered=False)
        assert sorted(map(_rowkey, got)) == sorted(map(_rowkey, p.t.query(
            f"SELECT id, k, c FROM n WHERE k = {int(k)}")))
    assert "global_index(k_1:k)" in p.explain("SELECT id FROM g WHERE k = 5")
    next_id = 1500
    for i in rng.integers(0, 1500, 10):
        p.run(f"UPDATE g SET k = k + 1 WHERE id = {int(i)}")
        p.run(f"DELETE FROM g WHERE id = {int(i) + 1}")
        p.run(f"INSERT INTO g VALUES ({next_id}, {int(i) % 300}, 'new')")
        next_id += 1
    p.check_backing("g", "k_1", ("k", "id"))


@pytest.mark.parametrize("sql", [
    "ALTER TABLE u ADD GLOBAL UNIQUE INDEX g2 (email)",
    "ALTER TABLE u ADD GLOBAL INDEX g3 (v)",
    "ALTER TABLE u ADD INDEX k (v)",
    "CREATE TABLE b (id BIGINT, v BIGINT) BINLOG=1",
    "CREATE TABLE b (id BIGINT, v BIGINT, create_time DATETIME) TTL=60",
])
def test_online_index_ddl_and_plane_options_raise(sql):
    """Online ADD INDEX (its backfill worker, global indexes included) and
    the binlog / TTL table options give the JAX session's outcome: the work
    record, the index state, the backing table, EXPLAIN, and the rows the
    table takes afterwards."""
    p = Pair()
    p.run(PLAIN_DDL)
    p.run("INSERT INTO u VALUES " + ", ".join(f"({i}, 'e{i}', {float(i % 13)})"
                                             for i in range(60)))
    out = p.run(sql)
    if isinstance(out, list):           # ALTER ... ADD INDEX: the work id
        recs = []
        for s in (p.j, p.t):
            w = s.db.ddl.wait(out[0]["work_id"], 30.0)
            recs.append((w.state, w.kind, w.error, [
                (ix.name, ix.kind, ix.params.get("state"))
                for ix in s.db.catalog.get_table("default", "u").indexes]))
        assert recs[1] == recs[0] and recs[1][0] == "public"
        name, col = sql.split("INDEX ")[1].split(" (")
        col = col.rstrip(")")
        lit = "'e5'" if col == "email" else "5"
        p.explain(f"SELECT id FROM u WHERE {col} = {lit}")
        if "GLOBAL" in sql:
            p.check_backing("u", name, (col, "id"))
        p.run("INSERT INTO u VALUES (100, 'new', 5.0)")
        p.run(f"SELECT id FROM u WHERE {col} = {lit} ORDER BY id")
    else:
        p.run("SHOW CREATE TABLE b")
        p.run("INSERT INTO b (id, v) VALUES (1, 2)")
        p.run("SELECT id, v FROM b")


@pytest.mark.parametrize("ddl", [
    PLAIN_DDL,
    "CREATE TABLE u (id BIGINT, email VARCHAR(64), v DOUBLE, PRIMARY KEY (id), "
    "KEY k_email (email))",
])
def test_number_against_an_indexed_string_column_matches_jax(ddl):
    """``email = 5`` over a KEY- or GLOBAL-indexed string column: the
    selector cannot compare the number with the column's strings, so EXPLAIN
    carries no ``access=`` on the scan in either package (compared whole),
    and the rows come from the full scan."""
    p = Pair()
    p.run(ddl)
    p.run("INSERT INTO u VALUES " + ", ".join(f"({i}, '{i % 7}', {float(i % 13)})"
                                             for i in range(60)))
    assert "access=" not in p.explain("SELECT id FROM u WHERE email = 5")
    p.run("SELECT id FROM u WHERE email = 5 ORDER BY id")
    p.run("SELECT COUNT(*) AS n FROM u WHERE email = 5")
