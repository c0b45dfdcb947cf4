"""The port's online ADD INDEX (meta/ddl.py and the session's ALTER) against
the JAX package's.

The cases of tests/test_online_ddl.py and the online cases of
tests/test_global_index.py run in a JAX ``Session`` (CPU, x64) and a port
``Session(device="cpu")`` on the same rows: the statement returns a
``work_id`` at once, the worker backfills region by region and publishes,
EXPLAIN's access path (compared whole) switches to the index only then,
DML during the backfill stays right, UNIQUE backfills fail on duplicates,
HANDLE ddl suspend / resume, DROP INDEX, a restart resuming an unfinished
backfill, and ADD GLOBAL [UNIQUE] INDEX filling its backing table.  The
work records (state, regions, error text) are compared exactly, and so is
the error a column that cannot be sorted gives.  Every wait on the worker
has a timeout.
"""

import time

import pyarrow as pa

from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession

WAIT_S = 30.0


class Pair:
    def __init__(self, jdb=None, tdb=None):
        self.j = JSession(jdb or JDatabase())
        self.t = TSession(tdb or TDatabase("cpu"))

    def run(self, sql, ordered=True):
        outs = []
        for s in (self.j, self.t):
            try:
                r = s.execute(sql)
                outs.append(r.to_pylist() if r.arrow is not None else r.affected_rows)
            except Exception as e:     # noqa: BLE001 — compared across packages
                outs.append(type(e).__name__)
        if not ordered and all(isinstance(o, list) for o in outs):
            outs = [sorted(o, key=repr) for o in outs]
        assert outs[1] == outs[0], (sql, outs)
        return outs[1]

    def script(self, stmts):
        for q in stmts:
            self.run(q)

    def explain(self, sql):
        got = self.t.execute("EXPLAIN " + sql).plan_text
        assert got == self.j.execute("EXPLAIN " + sql).plan_text
        return got

    def wait(self, work_id):
        """Both works at their end state: the same record."""
        recs = []
        for s in (self.j, self.t):
            w = s.db.ddl.wait(work_id, WAIT_S)
            assert w.done.is_set(), "backfill did not finish"
            recs.append((w.state, w.kind, w.regions_done, w.regions_total, w.error))
        assert recs[1] == recs[0]
        return recs[1]

    def load(self, n):
        t = pa.table({"id": list(range(n)), "grp": [i % 50 for i in range(n)],
                      "v": [float(i) for i in range(n)]})
        self.run("CREATE TABLE t (id BIGINT, grp BIGINT, v DOUBLE, PRIMARY KEY (id))")
        for s in (self.j, self.t):
            s.load_arrow("t", t)


def _make(n=5000):
    p = Pair()
    p.load(n)
    return p


def test_add_index_async_publish_and_selector_pickup():
    p = _make()
    p.run("HANDLE split default.t 1000")
    assert p.run("ALTER TABLE t ADD INDEX idx_grp (grp)") == [{"work_id": 1}]
    state, _, done, total, err = p.wait(1)
    assert state == "public" and done == total >= 4 and not err
    q = "SELECT COUNT(*) c FROM t WHERE grp = 7"
    assert p.run(q) == [{"c": 100}]
    assert "index(idx_grp:grp)" in p.explain(q)
    assert p.run("SELECT state FROM information_schema.ddl_work "
                 "WHERE index_name = 'idx_grp'") == [{"state": "public"}]
    p.run("SELECT * FROM information_schema.ddl_work")
    p.run("SHOW CREATE TABLE t")
    p.run("SHOW INDEX FROM t")


def test_index_not_choosable_while_backfilling():
    p = _make(2000)
    p.run("HANDLE ddl suspend")
    p.run("ALTER TABLE t ADD INDEX idx_grp (grp)")
    q = "SELECT COUNT(*) c FROM t WHERE grp = 3"
    assert p.run(q) == [{"c": 40}]
    assert "index(" not in p.explain(q)
    assert p.run("SELECT state FROM information_schema.ddl_work") == [{"state": "backfilling"}]
    p.run("HANDLE ddl resume")
    assert p.wait(1)[0] == "public"
    assert "index(" in p.explain(q)
    p.run("HANDLE ddl nonsense")


def test_concurrent_dml_during_backfill_stays_correct():
    p = _make(3000)
    p.run("HANDLE split default.t 500")
    p.run("ALTER TABLE t ADD INDEX idx_grp (grp)")
    # each worker snapshots the table's regions before its first walk step
    # (``regions_total`` set); the INSERTs below may split the last region,
    # so they wait for both snapshots to hold the whole work record equal
    deadline = time.monotonic() + WAIT_S
    for s in (p.j, p.t):
        while not s.db.ddl.works[1].regions_total and time.monotonic() < deadline:
            time.sleep(0.001)
        assert s.db.ddl.works[1].regions_total, "the backfill never took its snapshot"
    for i in range(3000, 3050):
        p.run(f"INSERT INTO t VALUES ({i}, 7, 0.0)")
    p.run("DELETE FROM t WHERE id < 10")
    assert p.wait(1)[0] == "public"
    got = p.run("SELECT COUNT(*) c FROM t WHERE grp = 7")
    assert got == p.run("SELECT COUNT(*) c FROM t WHERE grp + 0 = 7")
    p.run("SELECT id, v FROM t WHERE grp = 7 ORDER BY id")


def test_unique_backfill_fails_on_duplicates():
    p = _make(100)
    p.run("INSERT INTO t VALUES (100, 1, 1.0), (101, 1, 1.0)")
    p.run("ALTER TABLE t ADD UNIQUE INDEX u_grp (grp)")
    state, _, _, _, err = p.wait(1)
    assert state == "failed" and "duplicate" in err
    for s in (p.j, p.t):
        ix = next(i for i in s.db.catalog.get_table("default", "t").indexes
                  if i.name == "u_grp")
        assert ix.params["state"] == "failed"
    assert "index(" not in p.explain("SELECT COUNT(*) c FROM t WHERE grp = 1")


def test_unique_backfill_publishes_on_distinct_values():
    p = _make(300)
    p.run("ALTER TABLE t ADD UNIQUE INDEX u_id (v)")
    assert p.wait(1)[0] == "public"
    assert "index(u_id:v)" in p.explain("SELECT id FROM t WHERE v = 7.0")
    p.run("SELECT id FROM t WHERE v = 7.0")


def test_unsortable_column_fails_with_the_jax_error():
    """A region whose column Arrow cannot sort (a struct here): the work
    fails with the JAX package's error text."""
    p = _make(50)
    for s in (p.j, p.t):
        r = s.db.stores["default.t"].regions[0]
        structs = pa.array([{"a": i} for i in range(r.data.num_rows)])
        r.data = r.data.set_column(r.data.column_names.index("grp"), "grp", structs)
    p.run("ALTER TABLE t ADD INDEX idx_grp (grp)")
    state, _, done, _, err = p.wait(1)
    assert state == "failed" and done == 0
    assert err.startswith("TypeError: '<' not supported")


def test_drop_index_and_errors():
    p = _make(100)
    p.run("ALTER TABLE t ADD INDEX idx_grp (grp)")
    p.wait(1)
    p.script(["ALTER TABLE t DROP INDEX idx_grp", "ALTER TABLE t DROP INDEX nope",
              "ALTER TABLE t ADD INDEX bad (missing_col)", "ALTER TABLE t ADD INDEX i2 ()",
              "ALTER TABLE t ADD INDEX id_ix (id)", "ALTER TABLE t ADD INDEX id_ix (v)"])
    p.wait(2)
    assert [ix.name for ix in p.t.db.catalog.get_table("default", "t").indexes] == \
        [ix.name for ix in p.j.db.catalog.get_table("default", "t").indexes]


def test_drop_index_cannot_touch_rollups():
    p = _make(100)
    p.script(["ALTER TABLE t ADD ROLLUP r1 (grp, AGGREGATE(v))",
              "ALTER TABLE t DROP INDEX r1",
              "ALTER TABLE t DROP ROLLUP r1",
              "ALTER TABLE t ADD ROLLUP r1 (grp, AGGREGATE(v))"])
    assert any(ix.name == "r1" and ix.kind == "rollup"
               for ix in p.t.db.catalog.get_table("default", "t").indexes)


def test_drop_index_invalidates_cached_plans():
    p = _make(2000)
    p.run("ALTER TABLE t ADD INDEX idx_grp (grp)")
    p.wait(1)
    q = "SELECT COUNT(*) c FROM t WHERE grp = 7"
    assert p.run(q) == [{"c": 40}]
    assert "index(" in p.explain(q)
    p.run("ALTER TABLE t DROP INDEX idx_grp")
    assert p.run(q) == [{"c": 40}]
    assert "index(" not in p.explain(q)


def test_duplicate_fulltext_name_rejected():
    p = Pair()
    p.script(["CREATE TABLE ft (id BIGINT, txt VARCHAR(64), PRIMARY KEY (id))",
              "ALTER TABLE ft ADD FULLTEXT INDEX f (txt)",
              "ALTER TABLE ft ADD FULLTEXT INDEX f (txt)"])


def test_backfill_resumes_after_restart(tmp_path):
    dirs = (str(tmp_path / "j"), str(tmp_path / "t"))
    p = Pair(JDatabase(data_dir=dirs[0]), TDatabase("cpu", data_dir=dirs[1]))
    p.script(["CREATE TABLE t (id BIGINT, grp BIGINT, PRIMARY KEY (id))",
              "INSERT INTO t VALUES (1, 1), (2, 2), (3, 1)"])
    for s in (p.j, p.t):
        s.db.ddl.suspend()
    p.run("ALTER TABLE t ADD INDEX idx_grp (grp)")
    p.t.db.close()
    for d in dirs:
        s2 = (JSession if d == dirs[0] else TSession)(
            JDatabase(data_dir=d) if d == dirs[0] else TDatabase("cpu", data_dir=d))
        ix = next(i for i in s2.db.catalog.get_table("default", "t").indexes
                  if i.name == "idx_grp")
        deadline = time.time() + WAIT_S
        while ix.params.get("state") != "public" and time.time() < deadline:
            time.sleep(0.05)
        assert ix.params["state"] == "public"
        assert s2.query("SELECT COUNT(*) c FROM t WHERE grp = 1") == [{"c": 2}]
    # the port reopens the JAX package's directory: the index is public there
    t3 = TSession(TDatabase("cpu", data_dir=dirs[0]))
    assert [ix.params.get("state") for ix in t3.db.catalog.get_table("default", "t").indexes
            if ix.name == "idx_grp"] == ["public"]
    assert not t3.db.ddl.works


def test_closed_database_stops_its_worker():
    p = _make(100)
    p.run("ALTER TABLE t ADD INDEX idx_grp (grp)")
    p.wait(1)
    thread = p.t.db.ddl._thread
    assert thread is not None and thread.is_alive()
    p.t.db.close()
    thread.join(WAIT_S)
    assert not thread.is_alive()


# -- online ADD GLOBAL [UNIQUE] INDEX (tests/test_global_index.py) ----------

def test_online_add_global_index_backfills_and_publishes():
    p = Pair()
    p.run("CREATE TABLE u (id BIGINT, email VARCHAR(64), PRIMARY KEY (id))")
    for i in range(20):
        p.run(f"INSERT INTO u VALUES ({i}, 'e{i}')")
    assert p.run("ALTER TABLE u ADD GLOBAL UNIQUE INDEX g_email (email)") == [{"work_id": 1}]
    assert p.wait(1)[:2] == ("public", "global_unique")
    p.run("INSERT INTO u VALUES (99, 'e3')")        # ConflictError in both
    assert "global_index(g_email:email)" in p.explain("SELECT id FROM u WHERE email = 'e3'")
    p.run("SELECT id FROM u WHERE email = 'e3'")
    p.run("SELECT email, id FROM `__gidx__u__g_email` ORDER BY email")
    p.run("UPDATE u SET email = 'moved' WHERE id = 3")
    p.run("SELECT email, id FROM `__gidx__u__g_email` ORDER BY email")
    p.run("SHOW TABLES")


def test_online_add_global_index_non_unique_and_dml_while_suspended():
    """While the backfill is held, DML does not maintain the index; the
    fill at publish takes the rows as they stand."""
    p = Pair()
    p.run("CREATE TABLE u (id BIGINT, k BIGINT, PRIMARY KEY (id))")
    p.run("INSERT INTO u VALUES " + ", ".join(f"({i}, {i % 9})" for i in range(200)))
    p.run("HANDLE ddl suspend")
    p.run("ALTER TABLE u ADD GLOBAL INDEX gk (k)")
    p.run("SELECT COUNT(*) n FROM `__gidx__u__gk`")
    p.run("INSERT INTO u VALUES (500, 4)")
    p.run("DELETE FROM u WHERE id < 5")
    assert "global_index" not in p.explain("SELECT id FROM u WHERE k = 4")
    p.run("HANDLE ddl resume")
    assert p.wait(1)[0] == "public"
    assert "global_index(gk:k)" in p.explain("SELECT id FROM u WHERE k = 4")
    p.run("SELECT id FROM u WHERE k = 4", ordered=False)
    p.run("SELECT k, id FROM `__gidx__u__gk` ORDER BY k, id")


def test_add_global_unique_fails_on_existing_duplicates():
    p = Pair()
    p.script(["CREATE TABLE u (id BIGINT, email VARCHAR(64), PRIMARY KEY (id))",
              "INSERT INTO u VALUES (1, 'dup'), (2, 'dup')",
              "ALTER TABLE u ADD GLOBAL UNIQUE INDEX g_email (email)"])
    state, _, _, _, err = p.wait(1)
    assert state == "failed" and "duplicate" in err.lower()
    p.run("INSERT INTO u VALUES (3, 'dup')")
    assert "global_index" not in p.explain("SELECT id FROM u WHERE email = 'dup'")


def test_global_backfill_resumes_after_kill(tmp_path):
    dirs = (str(tmp_path / "j"), str(tmp_path / "t"))
    p = Pair(JDatabase(data_dir=dirs[0]), TDatabase("cpu", data_dir=dirs[1]))
    p.run("CREATE TABLE u (id BIGINT, email VARCHAR(64), PRIMARY KEY (id))")
    for i in range(10):
        p.run(f"INSERT INTO u VALUES ({i}, 'e{i}')")
    for s in (p.j, p.t):
        s.db.ddl.suspend()
    p.run("ALTER TABLE u ADD GLOBAL UNIQUE INDEX g_email (email)")
    p.t.db.close()
    p2 = Pair(JDatabase(data_dir=dirs[0]), TDatabase("cpu", data_dir=dirs[1]))
    works = [[w.work_id for w in s.db.ddl.works.values() if w.index_name == "g_email"]
             for s in (p2.j, p2.t)]
    assert works[0] == works[1] == [1]
    assert p2.wait(1)[0] == "public"
    p2.run("INSERT INTO u VALUES (99, 'e3')")
    assert "global_index(g_email:email)" in p2.explain("SELECT id FROM u WHERE email='e3'")
