"""The port's write path against the JAX package's: INSERT (VALUES, SELECT,
AUTO_INCREMENT), REPLACE and ON DUPLICATE KEY UPDATE, UPDATE and DELETE,
BEGIN / COMMIT / ROLLBACK with conflicts, durability under ``data_dir`` (WAL
recovery without a checkpoint, checkpoint then more DML, a killed writer,
TRUNCATE, ALTER), the point / secondary / zone-map access paths with their
EXPLAIN lines, and the port recovering a data directory the JAX package
wrote.

Every statement runs in a JAX ``Session`` and in a port
``Session(device="cpu")``; result rows, affected-row counts and errors are
compared exactly (integers, strings, NULLs, row order under ORDER BY) and
floats within rtol 1e-9 (no float32 kernel runs at these sizes).  The cases
mirror tests/test_row_tier_sql.py, tests/test_upsert.py and
tests/test_index_selector.py.
"""

import math
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pytest

from baikaldb_tpu.exec import session as jsession
from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.utils import metrics as jmetrics
from baikaldb_tpu_torch.exec import session as tsession
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.storage.rowstore import ConflictError
from baikaldb_tpu_torch.utils import metrics as tmetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(got, want):
    assert len(got) == len(want), (got, want)
    for a, b in zip(got, want):
        assert list(a) == list(b), (a, b)
        for k in b:
            if isinstance(b[k], float) and a[k] is not None:
                assert math.isclose(a[k], b[k], rel_tol=1e-9, abs_tol=1e-12), (k, a, b)
            else:
                assert a[k] == b[k], (k, a, b)


class Pair:
    """One JAX and one port session over their own databases; ``run``
    executes a statement in both and holds the outcomes equal."""

    def __init__(self, jdb=None, tdb=None, database="default"):
        self.j = JSession(jdb or JDatabase(), database)
        self.t = TSession(tdb or TDatabase("cpu"), database)

    def run(self, sql):
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
            _same(tv, jv)
        else:
            assert tv == jv, (sql, outs)
        return tv

    def script(self, stmts):
        return [self.run(q) for q in stmts]


def acct():
    p = Pair()
    p.run("CREATE TABLE acct (id BIGINT, bal DOUBLE, name VARCHAR, PRIMARY KEY (id))")
    p.run("INSERT INTO acct VALUES (1, 100.0, 'a'), (2, 200.0, 'b'), (3, 300.0, 'c')")
    return p


# ---- transactions ----------------------------------------------------------

def test_txn_commit_and_read_your_writes():
    p = acct()
    p.script(["BEGIN", "UPDATE acct SET bal = bal - 50 WHERE id = 1",
              "UPDATE acct SET bal = bal + 50 WHERE id = 2",
              "SELECT bal FROM acct WHERE id = 1", "COMMIT",
              "SELECT SUM(bal) t FROM acct", "SELECT bal FROM acct WHERE id = 2"])
    assert p.run("SELECT bal FROM acct WHERE id = 2") == [{"bal": 250.0}]


def test_txn_rollback_restores_everything():
    p = acct()
    store = p.t.db.stores["default.acct"]
    pre = store.regions[0].data
    v0 = store.version
    p.script(["BEGIN", "INSERT INTO acct VALUES (4, 1.0, 'd')", "DELETE FROM acct WHERE id = 1",
              "UPDATE acct SET name = 'zz' WHERE id = 2", "SELECT COUNT(*) c FROM acct",
              "ROLLBACK"])
    assert p.run("SELECT id, bal, name FROM acct ORDER BY id") == [
        {"id": 1, "bal": 100.0, "name": "a"}, {"id": 2, "bal": 200.0, "name": "b"},
        {"id": 3, "bal": 300.0, "name": "c"}]
    assert store.regions[0].data is pre          # the pre-image itself, no copy
    assert store.version > v0                    # versions never go back


def test_duplicate_pk_rejected():
    p = acct()
    assert p.run("INSERT INTO acct VALUES (1, 5.0, 'dup')") == "ConflictError"
    assert p.run("INSERT INTO acct VALUES (7, 1.0, 'x'), (7, 2.0, 'y')") == "ConflictError"
    p.script(["BEGIN", "INSERT INTO acct VALUES (8, 1.0, 'x')", "ROLLBACK",
              "INSERT INTO acct VALUES (8, 2.0, 'z')"])
    assert p.run("SELECT bal FROM acct WHERE id = 8") == [{"bal": 2.0}]


def test_concurrent_writer_conflict():
    p = acct()
    other = Pair(p.j.db, p.t.db)
    p.run("BEGIN")
    p.run("UPDATE acct SET bal = 0 WHERE id = 1")
    assert other.run("UPDATE acct SET bal = 1 WHERE id = 2") == "ConflictError"
    with pytest.raises(ConflictError):
        other.t.execute("INSERT INTO acct VALUES (10, 1.0, 'x')")
    p.run("ROLLBACK")
    other.run("UPDATE acct SET bal = 1 WHERE id = 2")
    assert p.run("SELECT bal FROM acct WHERE id = 2") == [{"bal": 1.0}]


def test_ddl_commits_an_open_transaction():
    p = acct()
    p.script(["BEGIN", "INSERT INTO acct VALUES (5, 5.0, 'e')", "CREATE TABLE other (x INT)",
              "ROLLBACK", "SELECT COUNT(*) c FROM acct"])
    assert p.run("SELECT COUNT(*) c FROM acct") == [{"c": 4}]


# ---- upserts, INSERT ... SELECT, AUTO_INCREMENT ---------------------------

def upsert_pair():
    p = Pair()
    p.run("CREATE TABLE t (id BIGINT, v BIGINT, name VARCHAR(16), PRIMARY KEY (id))")
    p.run("INSERT INTO t VALUES (1, 10, 'a'), (2, 20, 'b')")
    return p


def test_replace_into_and_on_duplicate_key_update():
    p = upsert_pair()
    assert p.run("REPLACE INTO t VALUES (1, 99, 'z'), (3, 30, 'c')") == 3
    assert p.run("INSERT INTO t VALUES (1, 111, 'x'), (4, 40, 'd') "
                 "ON DUPLICATE KEY UPDATE v = VALUES(v), name = 'dup'") == 3
    assert p.run("SELECT id, v, name FROM t ORDER BY id") == [
        {"id": 1, "v": 111, "name": "dup"}, {"id": 2, "v": 20, "name": "b"},
        {"id": 3, "v": 30, "name": "c"}, {"id": 4, "v": 40, "name": "d"}]


def test_upserts_within_batch_and_from_select():
    p = upsert_pair()
    assert p.run("REPLACE INTO t VALUES (1, 50, 'p'), (1, 60, 'q')") == 4
    p.run("INSERT INTO t VALUES (9, 1, 'a'), (9, 2, 'b') ON DUPLICATE KEY UPDATE v = VALUES(v)")
    assert p.run("SELECT v, name FROM t WHERE id = 9") == [{"v": 2, "name": "a"}]
    p.script(["CREATE TABLE src (id BIGINT, v BIGINT, name VARCHAR(16), PRIMARY KEY (id))",
              "INSERT INTO src VALUES (1, 500, 'srcrow'), (7, 70, 'new')",
              "REPLACE INTO t SELECT * FROM src",
              "SELECT id, v FROM t ORDER BY id"])


def test_upsert_requires_pk():
    p = Pair()
    p.run("CREATE TABLE nop (x BIGINT)")
    assert p.run("REPLACE INTO nop VALUES (1)") == "PlanError"


def test_insert_select_hot_and_bulk(monkeypatch):
    p = acct()
    p.script(["CREATE TABLE acct2 (id BIGINT, bal DOUBLE, name VARCHAR, PRIMARY KEY (id))",
              "INSERT INTO acct2 SELECT id, bal, name FROM acct"])
    assert p.run("INSERT INTO acct2 SELECT id, bal, name FROM acct") == "ConflictError"
    # past HOT_INSERT_ROWS the rows append in bulk, still primary-key checked
    monkeypatch.setattr(jsession, "HOT_INSERT_ROWS", 2)
    monkeypatch.setattr(tsession, "HOT_INSERT_ROWS", 2)
    p.script(["CREATE TABLE acct3 (id BIGINT, bal DOUBLE, name VARCHAR, PRIMARY KEY (id))",
              "INSERT INTO acct3 SELECT id, bal * 2, name FROM acct WHERE id >= 2",
              "SELECT * FROM acct3 ORDER BY id"])
    assert p.run("INSERT INTO acct3 SELECT id, bal, name FROM acct") == "ConflictError"
    assert p.run("SELECT COUNT(*) c FROM acct3") == [{"c": 2}]


def test_auto_increment():
    p = Pair()
    p.script(["CREATE TABLE ai (id BIGINT AUTO_INCREMENT, v VARCHAR(8), PRIMARY KEY (id))",
              "INSERT INTO ai (v) VALUES ('a'), ('b')",
              "INSERT INTO ai VALUES (10, 'c')",
              "INSERT INTO ai (v) VALUES ('d')",
              "BEGIN", "INSERT INTO ai (v) VALUES ('gone')", "ROLLBACK",
              "INSERT INTO ai (v) VALUES ('e')"])
    assert p.run("SELECT id, v FROM ai ORDER BY id") == [
        {"id": 1, "v": "a"}, {"id": 2, "v": "b"}, {"id": 10, "v": "c"},
        {"id": 11, "v": "d"}, {"id": 13, "v": "e"}]     # a rolled-back id is burned


# ---- UPDATE / DELETE --------------------------------------------------------

def test_update_delete_expressions_nulls_and_strings():
    rng = np.random.default_rng(11)
    n = 400
    data = pa.table({"id": np.arange(n, dtype=np.int64),
                     "g": rng.integers(0, 7, n).astype(np.int32),
                     "v": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.1),
                     "s": pa.array([f"s{i % 13}" for i in range(n)])})
    p = Pair()
    p.run("CREATE TABLE u (id BIGINT, g INT, v DOUBLE, s VARCHAR, PRIMARY KEY (id))")
    for s in (p.j, p.t):
        s.load_arrow("u", data)
    p.script(["UPDATE u SET v = v * 2 + g, s = CONCAT(s, '!') WHERE g = 3",
              "UPDATE u SET s = 'new' WHERE v IS NULL AND id > 100",
              "DELETE FROM u WHERE s = 's5' OR v > 1.5",
              "UPDATE u SET g = g + 10 WHERE s LIKE 's1%'",
              "DELETE FROM u WHERE id = 2.5",
              "UPDATE u SET g = 0 WHERE id = 7 AND s = 'nope'",
              "SELECT id, g, v, s FROM u ORDER BY id",
              "SELECT s, COUNT(*) c, SUM(v) sv FROM u GROUP BY s ORDER BY s",
              "SELECT g, COUNT(*) c FROM u GROUP BY g ORDER BY g"])


def test_point_write_fast_path_semantics():
    p = Pair()
    p.script(["CREATE TABLE pw (id BIGINT, k BIGINT, c VARCHAR(20), PRIMARY KEY (id))",
              "INSERT INTO pw VALUES (1, 10, 'a'), (2, 20, 'b'), (3, 30, NULL)"])
    assert p.run("UPDATE pw SET k = k + id WHERE id = 2") == 1
    p.script(["UPDATE pw SET c = NULL WHERE id = 1", "UPDATE pw SET c = CONCAT(c, '!') WHERE id = 3",
              "UPDATE pw SET id = 9 WHERE id = 1", "SELECT id, k, c FROM pw ORDER BY id"])
    assert p.run("UPDATE pw SET k = 0 WHERE id = 99") == 0
    assert p.run("UPDATE pw SET k = 0 WHERE id = 2 AND c = 'ZZZ'") == 0
    assert p.run("DELETE FROM pw WHERE id = 2") == 1
    assert p.run("UPDATE pw SET k = 0 WHERE id = 2.5") == 0
    assert p.run("SELECT COUNT(*) n FROM pw") == [{"n": 2}]


def test_alter_add_drop_column():
    p = acct()
    p.script(["ALTER TABLE acct ADD COLUMN note VARCHAR", "UPDATE acct SET note = 'x' WHERE id = 1",
              "ALTER TABLE acct DROP COLUMN bal", "SELECT * FROM acct ORDER BY id",
              "DESCRIBE acct"])


# ---- access paths ------------------------------------------------------------

@pytest.fixture
def users():
    p = Pair()
    p.run("CREATE TABLE u (id BIGINT PRIMARY KEY, name VARCHAR(16), score DOUBLE, KEY kn (name))")
    p.run("INSERT INTO u VALUES " + ",".join(f"({i},'u{i % 50}',{i * 1.0})" for i in range(1000)))
    return p


def test_point_lookup(users):
    p0, j0 = tmetrics.point_lookups.value, jmetrics.point_lookups.value
    users.script(["SELECT id, name FROM u WHERE id = 7", "SELECT * FROM u WHERE id = 7",
                  "SELECT * FROM u WHERE id = 99999", "SELECT name n FROM u WHERE id = 3",
                  "SELECT score * 2 d FROM u WHERE id = 3",
                  "SELECT id FROM u WHERE id = 7 AND score > 100",
                  "SELECT id, name FROM u WHERE id = 7 AND name = 'WRONG'",
                  "SELECT id FROM u WHERE id = 7 AND id = 8", "SELECT id FROM u WHERE id = 7 AND id = 7",
                  "SELECT name, name FROM u WHERE id = 7"])
    assert tmetrics.point_lookups.value - p0 == jmetrics.point_lookups.value - j0 == 5
    users.script(["BEGIN", "UPDATE u SET score = -1 WHERE id = 5", "SELECT score FROM u WHERE id = 5",
                  "ROLLBACK", "SELECT score FROM u WHERE id = 5"])


def test_secondary_index_path(users):
    sql = "SELECT COUNT(*) c, SUM(score) s FROM u WHERE name = 'u3'"
    plan = users.run("EXPLAIN " + sql)
    assert any("access=index(kn:name)" in r["plan"] for r in plan)
    i0 = tmetrics.index_scans.value
    users.run(sql)
    assert tmetrics.index_scans.value > i0
    users.script(["INSERT INTO u VALUES (5000, 'u3', 123.0)", sql])
    p = Pair()
    p.run("CREATE TABLE h (id BIGINT PRIMARY KEY, g VARCHAR(4), KEY kg (g))")
    p.run("INSERT INTO h VALUES " + ",".join(f"({i},'same')" for i in range(100)))
    plan = p.run("EXPLAIN SELECT id FROM h WHERE g = 'same'")
    assert not any("index(" in r["plan"] for r in plan)      # every row matches


def test_zone_map_pruning(users):
    for s in (users.j, users.t):
        s.db.stores["default.u"].region_rows = 200
    users.run("INSERT INTO u VALUES " + ",".join(f"({i},'z',{i * 1.0})" for i in range(2000, 3000)))
    assert len(users.t.db.stores["default.u"].regions) == \
        len(users.j.db.stores["default.u"].regions) > 3
    plan = users.run("EXPLAIN SELECT SUM(score) FROM u WHERE id >= 2900")
    assert any("zonemap(" in r["plan"] for r in plan)
    r0 = tmetrics.regions_pruned.value
    users.script(["SELECT COUNT(*) c FROM u WHERE id >= 2900",
                  "SELECT COUNT(*) c FROM u WHERE id >= 2100 AND id < 2300",
                  "SELECT COUNT(*) c FROM u WHERE id > 10000000",
                  "EXPLAIN SELECT COUNT(*) c FROM u WHERE id > 10000000",
                  "SELECT id FROM u WHERE id = 7 AND id > 'x'"])
    assert tmetrics.regions_pruned.value > r0


def test_zone_map_dates():
    p = Pair()
    p.run("CREATE TABLE ev (id BIGINT PRIMARY KEY, d DATE, v INT)")
    for s in (p.j, p.t):
        s.db.stores["default.ev"].region_rows = 100
    p.run("INSERT INTO ev VALUES " + ",".join(f"({i},'1994-{1 + i // 100:02d}-15',{i})"
                                              for i in range(300)))
    p.script(["EXPLAIN SELECT SUM(v) FROM ev WHERE d >= '1994-03-01'",
              "SELECT COUNT(*) c FROM ev WHERE d >= '1994-03-01'"])


def test_access_cache_bounded(users):
    for i in range(60):
        users.t.query(f"SELECT COUNT(*) c FROM u WHERE name = 'u{i % 50}'")
    assert len(users.t._access_batches) <= users.t._ACCESS_CACHE_MAX


# ---- durability ---------------------------------------------------------------

def durable(tmp_path):
    return Pair(JDatabase(data_dir=str(tmp_path / "jax")),
                TDatabase("cpu", data_dir=str(tmp_path / "port")))


def reopen(tmp_path):
    return Pair(JDatabase(data_dir=str(tmp_path / "jax")),
                TDatabase("cpu", data_dir=str(tmp_path / "port")))


def test_durability_without_checkpoint(tmp_path):
    p = durable(tmp_path)
    p.script(["CREATE TABLE t (k BIGINT, v VARCHAR, PRIMARY KEY (k))",
              "INSERT INTO t VALUES (1, 'one'), (2, 'two')", "UPDATE t SET v = 'TWO' WHERE k = 2",
              "INSERT INTO t VALUES (3, 'three')", "DELETE FROM t WHERE k = 1",
              "BEGIN", "INSERT INTO t VALUES (5, 'gone')", "ROLLBACK",
              "BEGIN", "INSERT INTO t VALUES (6, 'six')", "COMMIT"])
    q = reopen(tmp_path)
    assert q.run("SELECT k, v FROM t ORDER BY k") == [
        {"k": 2, "v": "TWO"}, {"k": 3, "v": "three"}, {"k": 6, "v": "six"}]
    q.script(["INSERT INTO t VALUES (4, 'four')", "SELECT COUNT(*) c FROM t"])


def test_checkpoint_then_more_dml_and_truncate(tmp_path):
    p = durable(tmp_path)
    p.script(["CREATE TABLE t (k BIGINT, v DOUBLE)", "INSERT INTO t VALUES (1, 1.5), (2, 2.5)"])
    for s in (p.j, p.t):
        s.db.checkpoint()
    p.script(["UPDATE t SET v = 9.0 WHERE k = 1", "INSERT INTO t VALUES (3, 3.5)"])
    q = reopen(tmp_path)
    assert q.run("SELECT k, v FROM t ORDER BY k") == [
        {"k": 1, "v": 9.0}, {"k": 2, "v": 2.5}, {"k": 3, "v": 3.5}]
    q.run("TRUNCATE TABLE t")
    assert reopen(tmp_path).run("SELECT COUNT(*) c FROM t") == [{"c": 0}]


def test_alter_and_bulk_load_durable(tmp_path):
    p = durable(tmp_path)
    p.script(["CREATE TABLE t (k BIGINT)", "INSERT INTO t VALUES (1), (2)",
              "ALTER TABLE t ADD COLUMN v VARCHAR", "UPDATE t SET v = 'x' WHERE k = 1",
              "CREATE TABLE big (k BIGINT, v DOUBLE)"])
    for s in (p.j, p.t):
        s.load_arrow("big", pa.table({"k": list(range(1000)), "v": [float(i) for i in range(1000)]}))
        s.db.checkpoint()
    q = reopen(tmp_path)
    q.script(["SELECT k, v FROM t ORDER BY k", "SELECT COUNT(*) c, SUM(k) s FROM big"])
    q.script(["CREATE DATABASE appdb", "CREATE TABLE appdb.w (id BIGINT, PRIMARY KEY (id))",
              "INSERT INTO appdb.w VALUES (1)", "DROP TABLE big"])
    assert not os.path.exists(tmp_path / "port" / "default.big.wal")
    r = reopen(tmp_path)
    r.script(["SELECT id FROM appdb.w", "SHOW TABLES"])


def test_kill9_recovery(tmp_path):
    """A writer killed with an open transaction: its committed rows survive,
    the open transaction's do not."""
    d = str(tmp_path / "data")
    child = textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {ROOT!r})
        from baikaldb_tpu_torch.exec.session import Database, Session
        s = Session(Database("cpu", data_dir={d!r}))
        s.execute("CREATE TABLE k9 (id BIGINT, v VARCHAR, PRIMARY KEY (id))")
        s.execute("INSERT INTO k9 VALUES (1, 'committed')")
        s.execute("BEGIN")
        s.execute("INSERT INTO k9 VALUES (2, 'uncommitted')")
        print("READY", flush=True)
        os.kill(os.getpid(), 9)
    """)
    p = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == -signal.SIGKILL and "READY" in p.stdout, p.stderr
    assert TSession(TDatabase("cpu", data_dir=d)).query("SELECT id, v FROM k9 ORDER BY id") == \
        [{"id": 1, "v": "committed"}]


def test_port_recovers_a_jax_data_dir(tmp_path):
    """A data directory the JAX package wrote (catalog.json, a Parquet
    checkpoint, WAL deltas over it, a view) recovers in the port to the same
    rows, and the port's next writes land in the same files."""
    d = str(tmp_path / "shared")
    js = JSession(JDatabase(data_dir=d))
    rng = np.random.default_rng(5)
    data = pa.table({"id": np.arange(500, dtype=np.int64),
                     "g": rng.integers(0, 9, 500).astype(np.int32),
                     "v": rng.standard_normal(500),
                     "s": pa.array([None if i % 11 == 0 else f"n{i % 7}" for i in range(500)]),
                     "d": pa.array(np.datetime64("2024-01-01") + np.arange(500) % 40,
                                   pa.date32())})
    js.execute("CREATE TABLE t (id BIGINT, g INT, v DOUBLE, s VARCHAR, d DATE, "
               "PRIMARY KEY (id), KEY kg (g))")
    js.load_arrow("t", data)
    js.db.checkpoint()
    for q in ("UPDATE t SET v = v + 1, s = 'upd' WHERE g = 3", "DELETE FROM t WHERE g = 5",
              "INSERT INTO t VALUES (1000, 4, 0.5, 'ins', '2024-05-05')",
              "CREATE VIEW vv AS SELECT g, COUNT(*) c FROM t GROUP BY g"):
        js.execute(q)
    ts = TSession(TDatabase("cpu", data_dir=d))
    for q in ("SELECT * FROM t ORDER BY id", "SELECT g, COUNT(*) c, SUM(v) sv FROM t "
              "GROUP BY g ORDER BY g", "SELECT * FROM vv ORDER BY g", "SHOW INDEX FROM t"):
        _same(ts.query(q), js.query(q))
    ts.execute("UPDATE t SET g = 99 WHERE id = 1000")
    ts.db.checkpoint()
    ts.execute("DELETE FROM t WHERE id < 10")
    back = JSession(JDatabase(data_dir=d))
    _same(back.query("SELECT id, g FROM t ORDER BY id"), ts.query("SELECT id, g FROM t ORDER BY id"))


def test_sysbench_transactions_match_the_replay_and_jax():
    """The sysbench oltp_read_write model (models/sysbench.py) on a small
    sbtest1 cut into small regions, with both range forms: every statement
    of every transaction equals the replay reference in both packages, and
    the final tables are equal."""
    from baikaldb_tpu_torch.models import sysbench as sb

    rows = 3000
    p = Pair()
    p.run(sb.DDL)
    for s in (p.j, p.t):
        s.db.stores["default.sbtest1"].region_rows = 256
        s.load_arrow("sbtest1", sb.table(rows, 4))
    drivers = [sb.Driver(s, rows, 4) for s in (p.j, p.t)]
    for d in drivers:
        d.run(3)
        d.workload.range_form = "comparisons"
        d.run(3)
    assert drivers[1].statements == 6 * 18
    for q in ("SELECT COUNT(*) c, SUM(k) s FROM sbtest1",
              "SELECT id, k, c, pad FROM sbtest1 ORDER BY id"):
        p.run(q)
    # neither selector reads BETWEEN as a range; the same range written as
    # two comparisons prunes regions in both, with the same EXPLAIN
    for where, access in (("id BETWEEN 100 AND 199", "access=full"),
                          ("id >= 100 AND id <= 199", "access=zonemap(")):
        sql = f"EXPLAIN SELECT c FROM sbtest1 WHERE {where}"
        plans = [s.execute(sql).plan_text for s in (p.j, p.t)]
        assert plans[1] == plans[0] and access in plans[1], plans


def test_lookup_by_pks_matches_jax(users):
    """The primary-key gather a global index's lookup join reads (the
    index itself waits): the same rows as the JAX store's."""
    keys = pa.table({"id": pa.array([7, 3, 99999, 512, 7], pa.int64())})
    users.run("DELETE FROM u WHERE id = 512")
    got = users.t.db.stores["default.u"].lookup_by_pks(keys).to_pylist()
    want = users.j.db.stores["default.u"].lookup_by_pks(keys).to_pylist()
    assert got == want and [r["id"] for r in got] == [3, 7]
