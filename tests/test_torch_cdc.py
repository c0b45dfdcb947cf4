"""The port's change streams and materialized views (cdc/) against the JAX
package's.

The cases of tests/test_cdc.py run in a JAX ``Session`` (CPU, x64) and a port
``Session(device="cpu")`` on the same statements: the k-way merge's
tiebreak, GC holds and force-expiry (``CursorLagging``), subscriptions
pinning GC until acked, FETCH resuming exactly after a restart, and the
views' answers, folds, group rescans, re-seeds on statement images, EXPLAIN
ANALYZE's ``-- view:`` line, the transaction and snapshot gates, validation
errors, DROP TABLE's cascade and SHOW TABLES.  Then a ``data_dir`` that the
JAX package wrote with subscriptions, a view and events, opened by the port.

Rows, FETCH columns other than ``commit_ts`` (each package's wall-clock
TSO), affected counts, error types, view counters and EXPLAIN lines are
compared exactly: view measures are integers, so every answer is exact, and
each package's answer also equals its own ``matview_answer = 0`` recompute.
"""

import json
import shutil

import pytest

from baikaldb_tpu.cdc.streams import CursorLagging as JLagging
from baikaldb_tpu.cdc.streams import merge_by_commit_ts as j_merge
from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.storage.binlog import Binlog as JBinlog
from baikaldb_tpu.utils import metrics as jmetrics
from baikaldb_tpu_torch.cdc.streams import CursorLagging as TLagging
from baikaldb_tpu_torch.cdc.streams import merge_by_commit_ts as t_merge
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.storage.binlog import Binlog as TBinlog
from baikaldb_tpu_torch.utils import metrics as tmetrics
from baikaldb_tpu_torch.utils.flags import FLAGS as TFLAGS

AGG = ("SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v), AVG(v), COUNT(v) "
       "FROM t GROUP BY k ORDER BY k")
MV_DDL = ("CREATE MATERIALIZED VIEW mv AS SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v), "
          "AVG(v), COUNT(v) FROM t GROUP BY k")


def _outcome(s, sql):
    try:
        r = s.execute(sql)
    except Exception as e:          # noqa: BLE001 — compared across packages
        return type(e).__name__
    if r.arrow is None:
        return r.affected_rows
    rows = r.to_pylist()
    for row in rows:
        row.pop("commit_ts", None)  # each package's own wall-clock TSO
    return rows


class Pair:
    """A JAX and a port session, each over its own database, in database
    ``d``: ``run`` executes a statement in both and holds the outcomes
    equal."""

    def __init__(self, jdb=None, tdb=None, create=True):
        self.j = JSession(jdb or JDatabase())
        self.t = TSession(tdb or TDatabase("cpu"))
        for s in (self.j, self.t):
            if create:
                s.execute("CREATE DATABASE IF NOT EXISTS d")
            s.execute("USE d")

    def run(self, sql):
        want, got = _outcome(self.j, sql), _outcome(self.t, sql)
        assert got == want, (sql, got, want)
        return got

    def script(self, stmts):
        for q in stmts:
            self.run(q)

    def both(self, sql):
        """The view's answer and the recompute (``matview_answer = 0``), in
        both packages: all four equal."""
        on = self.run(sql)
        self.run("SET GLOBAL matview_answer = 0")
        try:
            off = self.run(sql)
        finally:
            self.run("SET GLOBAL matview_answer = 1")
        assert on == off
        return on

    def views(self):
        """Each package's view counters: equal."""
        cols = ("deltas_folded, rescans, answered_queries, groups, staleness_ms, "
                "cursor_lag_ms, base_table, definition")
        return self.run(f"SELECT view_name, {cols} FROM information_schema.materialized_views")


def _mv_pair():
    p = Pair()
    p.script(["CREATE TABLE t (k VARCHAR(16), v BIGINT, id BIGINT, PRIMARY KEY(id))",
              MV_DDL])
    return p


# -- merge and GC holds ------------------------------------------------------

def test_merge_equal_ts_deterministic_tiebreak():
    f0 = [{"commit_ts": 5, "tag": "a0"}, {"commit_ts": 7, "tag": "a1"}]
    f1 = [{"commit_ts": 5, "tag": "b0"}, {"commit_ts": 5, "tag": "b1"}]
    for feeds in ([(0, f0), (1, f1)], [(1, f0), (0, f1)]):
        got = [e["tag"] for e in t_merge([(i, list(f)) for i, f in feeds])]
        assert got == [e["tag"] for e in j_merge([(i, list(f)) for i, f in feeds])]
    assert [e["tag"] for e in t_merge([(0, list(f0)), (1, list(f1))])] == \
        ["a0", "b0", "b1", "a1"]


def test_gc_clamps_at_oldest_unacked_cursor():
    outs = []
    for Binlog, metrics in ((JBinlog, jmetrics), (TBinlog, tmetrics)):
        b = Binlog(capacity=4)
        b.hold_gc("slow", 0)
        held0 = metrics.binlog_gc_held_by_cursor.value
        ts = [b.append("insert", "d", "t", rows=[{"i": i}]) for i in range(9)]
        pinned = [e.commit_ts for e in b.read(0)] == ts
        held = metrics.binlog_gc_held_by_cursor.value - held0
        b.hold_gc("slow", ts[5])
        b.append("insert", "d", "t", rows=[{"i": 9}])
        with pytest.raises(ValueError):
            b.read(0)
        outs.append((pinned, held, b.min_hold() == ts[5], b._oldest_ts == ts[5],
                     len(b.read(ts[5]))))
        b.release_gc("slow")
    assert outs[1] == outs[0] and outs[1][0] and outs[1][1] > 0


def _small_binlog_pair():
    jdb, tdb = JDatabase(), TDatabase("cpu")
    jdb.binlog, tdb.binlog = JBinlog(capacity=4), TBinlog(capacity=4)
    p = Pair(jdb, tdb)
    p.run("CREATE TABLE t (id BIGINT, v BIGINT, PRIMARY KEY(id))")
    return p


def test_cursor_lagging_on_force_expiry():
    p = _small_binlog_pair()
    subs = [s.db.cdc.create("lagger", table_key="d.t") for s in (p.j, p.t)]
    prev = float(TFLAGS.cdc_cursor_max_lag_s)
    p.run("SET GLOBAL cdc_cursor_max_lag_s = 0")
    try:
        for i in range(10):
            p.run(f"INSERT INTO t VALUES ({i}, {i})")
        lost = []
        for sub, s, err in zip(subs, (p.j, p.t), (JLagging, TLagging)):
            with pytest.raises(err) as ei:
                sub.fetch()
            assert ei.value.subscription == "lagger"
            assert ei.value.lost_to == s.db.binlog._oldest_ts
            got = sub.fetch()
            assert got and got[0].commit_ts > s.db.binlog._oldest_ts
            lost.append([r for e in got for r in e.rows])
        assert lost[1] == lost[0]
    finally:
        p.run(f"SET GLOBAL cdc_cursor_max_lag_s = {prev}")


def test_subscription_pins_gc_until_acked():
    p = _small_binlog_pair()
    subs = [s.db.cdc.create("audit", table_key="d.t") for s in (p.j, p.t)]
    for i in range(8):
        p.run(f"INSERT INTO t VALUES ({i}, {i})")
    outs = []
    for sub, s in zip(subs, (p.j, p.t)):
        evs = sub.fetch(100)
        sub.ack(evs[-1].commit_ts)
        outs.append([r["id"] for e in evs for r in e.rows])
    p.run("INSERT INTO t VALUES (8, 8)")
    for sub, s in zip(subs, (p.j, p.t)):
        assert len(s.db.binlog._events) <= s.db.binlog.capacity
        outs.append([r["id"] for e in sub.fetch(100) for r in e.rows])
    assert outs == [list(range(8)), list(range(8)), [8], [8]]


# -- durable cursors ----------------------------------------------------------

def test_cursor_replays_exactly_after_restart(tmp_path):
    dirs = (str(tmp_path / "j"), str(tmp_path / "t"))
    p = Pair(JDatabase(data_dir=dirs[0]), TDatabase("cpu", data_dir=dirs[1]))
    p.script(["CREATE TABLE t (id BIGINT, v BIGINT, PRIMARY KEY(id))",
              "CREATE SUBSCRIPTION audit ON t",
              "INSERT INTO t VALUES (1, 10)", "INSERT INTO t VALUES (2, 20)"])
    assert len(p.run("FETCH 1 FROM audit")) == 1
    p2 = Pair(JDatabase(data_dir=dirs[0]), TDatabase("cpu", data_dir=dirs[1]), create=False)
    rows = p2.run("FETCH 10 FROM audit")
    assert len(rows) == 1 and json.loads(rows[0]["rows"]) == [{"id": 2, "v": 20}]
    assert p2.run("FETCH 10 FROM audit") == []
    p2.run("SELECT name, table_key, internal, events_delivered FROM "
           "information_schema.subscriptions")


def test_jax_written_data_dir_opens_in_the_port(tmp_path):
    """Subscriptions, a view and binlog events written by the JAX package:
    the port FETCHes the same events (same commit_ts: the same log) and
    answers the view with the JAX package's rows."""
    d = str(tmp_path / "jax")
    j = JSession(JDatabase(data_dir=d))
    for q in ["CREATE DATABASE d", "USE d",
              "CREATE TABLE t (k VARCHAR(16), v BIGINT, id BIGINT, PRIMARY KEY(id))",
              "CREATE SUBSCRIPTION audit ON t", "CREATE SUBSCRIPTION everything", MV_DDL,
              "INSERT INTO t VALUES ('a', 1, 1), ('a', 5, 2), ('b', 7, 3), (NULL, 2, 4)",
              AGG,
              "UPDATE t SET v = 9 WHERE id = 1", "DELETE FROM t WHERE id = 3",
              "INSERT INTO t VALUES ('c', 4, 5)"]:
        j.execute(q)
    j.execute("FETCH 2 FROM audit")
    j.db.checkpoint()
    # the same directory twice: the JAX package reads one, the port the other
    d2 = str(tmp_path / "copy")
    shutil.copytree(d, d2)
    jj = JSession(JDatabase(data_dir=d), "d")
    t = TSession(TDatabase("cpu", data_dir=d2), "d")
    assert t.db.binlog._cursors == jj.db.binlog._cursors
    assert sorted(t.db.cdc.subs) == sorted(jj.db.cdc.subs)
    assert t.db.matviews.to_meta() == jj.db.matviews.to_meta()
    got = {n: t.execute(f"FETCH 100 FROM {n}").to_pylist() for n in ("audit", "everything")}
    want = {n: jj.execute(f"FETCH 100 FROM {n}").to_pylist() for n in ("audit", "everything")}
    assert got == want and [r["event_type"] for r in got["audit"]] == ["delete", "insert"]
    assert t.query(AGG) == jj.query(AGG)
    assert t.query("SELECT view_name, groups FROM information_schema.materialized_views") == \
        [{"view_name": "mv", "groups": 3}]


# -- views --------------------------------------------------------------------

def test_view_bit_identical_with_string_and_null_keys():
    p = _mv_pair()
    p.run("INSERT INTO t VALUES ('a', 1, 1), ('a', 5, 2), ('b', 7, 3), (NULL, 2, 4), "
          "(NULL, NULL, 5)")
    on = p.both(AGG)
    assert {r["k"] for r in on} == {"a", "b", None}
    nrow = next(r for r in on if r["k"] is None)
    assert nrow["count_star()"] == 2 and nrow["count(v)"] == 1
    p.views()


def test_view_folds_updates_and_deletes_incrementally():
    p = _mv_pair()
    p.run("INSERT INTO t VALUES ('a', 1, 1), ('a', 5, 2), ('a', 3, 6), ('b', 7, 3)")
    p.both(AGG)
    seeds = p.views()[0]["rescans"]
    p.run("UPDATE t SET v = 4 WHERE id = 6")        # not the min/max: folds
    p.run("INSERT INTO t VALUES ('b', 2, 4)")
    p.both(AGG)
    v = p.views()[0]
    assert v["deltas_folded"] >= 2 and v["rescans"] == seeds
    p.run("DELETE FROM t WHERE id = 3")             # the group's max: one rescan
    p.both(AGG)
    assert p.views()[0]["rescans"] == seeds + 1
    p.run("DELETE FROM t WHERE k = 'b'")            # the group's last row
    assert {r["k"] for r in p.both(AGG)} == {"a"}
    p.views()


def test_view_absorbs_statement_image_traffic():
    p = _mv_pair()
    p.script(["INSERT INTO t VALUES ('a', 1, 1), ('b', 2, 2)",
              "CREATE TABLE src (k VARCHAR(16), v BIGINT, id BIGINT, PRIMARY KEY(id))",
              "INSERT INTO src VALUES ('c', 9, 7), ('a', 3, 8)",
              "INSERT INTO t SELECT k, v, id FROM src"])
    p.both(AGG)
    p.run("REPLACE INTO t VALUES ('a', 100, 1)")
    p.both(AGG)
    p.run("TRUNCATE TABLE t")
    assert p.both(AGG) == []
    p.views()


def test_explain_analyze_view_line():
    p = _mv_pair()
    p.run("INSERT INTO t VALUES ('a', 1, 1), ('b', 2, 2)")
    lines = []
    for s in (p.j, p.t):
        rows = [r[0] for r in s.execute(
            "EXPLAIN ANALYZE SELECT k, COUNT(*) FROM t GROUP BY k").rows]
        view = [x for x in rows if x.startswith("-- view: d.mv")]
        assert len(view) == 1
        # applied_ts is each package's TSO; the rest is the same
        lines.append(" ".join(w for w in view[0].split() if not w.startswith("applied_ts=")))
    assert lines[1] == lines[0] and "groups=2" in lines[1]
    p.run("EXPLAIN SELECT k, COUNT(*) FROM t GROUP BY k")
    p.run("SET GLOBAL matview_answer = 0")
    try:
        rows = [r[0] for r in p.t.execute(
            "EXPLAIN ANALYZE SELECT k, COUNT(*) FROM t GROUP BY k").rows]
        assert not any(x.startswith("-- view:") for x in rows)
        p.run("EXPLAIN SELECT k, COUNT(*) FROM t GROUP BY k")
    finally:
        p.run("SET GLOBAL matview_answer = 1")


def test_view_not_used_inside_txn_or_snapshot():
    p = _mv_pair()
    p.run("INSERT INTO t VALUES ('a', 1, 1)")
    p.run(AGG)
    answered = p.views()[0]["answered_queries"]
    p.script(["SET SNAPSHOT = 'now'", AGG, "SET SNAPSHOT = 0",
              "BEGIN", "INSERT INTO t VALUES ('a', 2, 2)", AGG, "ROLLBACK"])
    assert p.views()[0]["answered_queries"] == answered


@pytest.mark.parametrize("sql", [
    "CREATE MATERIALIZED VIEW m1 AS SELECT COUNT(*) FROM t",
    "CREATE MATERIALIZED VIEW m2 AS SELECT k, SUM(f) FROM t GROUP BY k",
    "CREATE MATERIALIZED VIEW m3 AS SELECT f, COUNT(*) FROM t GROUP BY f",
    "CREATE MATERIALIZED VIEW m4 AS SELECT k, COUNT(*) FROM t WHERE v > 0 GROUP BY k",
    "CREATE MATERIALIZED VIEW m5 AS SELECT k, v, COUNT(*) FROM t GROUP BY k",
    "CREATE MATERIALIZED VIEW m6 AS SELECT k, COUNT(DISTINCT v) FROM t GROUP BY k",
    "CREATE MATERIALIZED VIEW m7 AS SELECT k, COUNT(*) FROM nosuch GROUP BY k",
    "DROP MATERIALIZED VIEW nosuch",
])
def test_matview_validation_errors(sql):
    p = Pair()
    p.run("CREATE TABLE t (k VARCHAR(16), f DOUBLE, v BIGINT, id BIGINT, PRIMARY KEY(id))")
    assert isinstance(p.run(sql), str)          # the same error type in both
    assert p.run("SELECT * FROM information_schema.materialized_views") == []
    p.run("DROP MATERIALIZED VIEW IF EXISTS nosuch")


def test_drop_table_cascades_to_views_and_fetch_sql():
    p = _mv_pair()
    p.run("INSERT INTO t VALUES ('a', 1, 1)")
    p.run(AGG)
    assert [r["view_name"] for r in p.run(
        "SELECT table_schema, view_name FROM information_schema.materialized_views")] == ["mv"]
    subs = p.run("SELECT name, table_key, internal FROM information_schema.subscriptions")
    assert {r["name"] for r in subs} == {"__mv!d.mv"}
    assert p.run("DROP SUBSCRIPTION `__mv!d.mv`") == "PlanError"
    p.run("DROP TABLE t")
    assert p.run("SELECT * FROM information_schema.materialized_views") == []
    assert p.run("SELECT * FROM information_schema.subscriptions") == []
    assert p.run("FETCH FROM nosuch") == "PlanError"
    p.script(["CREATE SUBSCRIPTION s1", "CREATE SUBSCRIPTION s1",
              "CREATE SUBSCRIPTION IF NOT EXISTS s1", "CREATE SUBSCRIPTION s2 ON nosuch",
              "DROP SUBSCRIPTION s1", "DROP SUBSCRIPTION s1", "DROP SUBSCRIPTION IF EXISTS s1"])


def test_show_tables_hides_mv_backing_table():
    p = _mv_pair()
    assert p.run("SHOW TABLES") == [{"Tables_in_d": "t"}]
    p.run("SHOW FULL TABLES")
    assert "d.__mv_mv" in p.t.db.stores
    p.run("DROP MATERIALIZED VIEW mv")
    assert "d.__mv_mv" not in p.t.db.stores
    p.run("SELECT * FROM information_schema.subscriptions")


def test_fetch_events_of_a_write_mix_match_jax():
    """FETCH's event columns (row images as JSON, statement images,
    affected counts) over inserts, updates, deletes, an upsert and a
    transaction."""
    p = Pair()
    p.script(["CREATE TABLE t (id BIGINT PRIMARY KEY, g INT, v BIGINT, s VARCHAR(8))",
              "CREATE TABLE other (id BIGINT)",
              "CREATE SUBSCRIPTION feed ON t",
              "INSERT INTO t VALUES (1, 1, 10, 'x'), (2, 1, 20, NULL), (3, 2, 30, 'z')",
              "INSERT INTO other VALUES (1)",
              "UPDATE t SET v = v * 2, s = 'u' WHERE g = 1",
              "DELETE FROM t WHERE id = 3",
              "INSERT INTO t VALUES (1, 1, 0, 'q') ON DUPLICATE KEY UPDATE v = 7",
              "BEGIN", "INSERT INTO t VALUES (9, 9, 9, 'n')", "COMMIT"])
    got = p.run("FETCH 3 FROM feed")
    assert [r["event_type"] for r in got] == ["insert", "update", "delete"]
    assert [r["event_type"] for r in p.run("FETCH FROM feed")] == ["insert", "insert"]
    assert p.run("FETCH FROM feed") == []


def test_subscription_stream_acks_each_event_as_the_next_is_taken():
    """The library iterator: apply-then-ack, ending after a quiet timeout."""
    p = Pair()
    p.run("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    subs = [s.db.cdc.create("it", table_key="d.t") for s in (p.j, p.t)]
    p.script([f"INSERT INTO t VALUES ({i}, {i})" for i in range(3)])
    got = []
    for sub in subs:
        seen = [r["id"] for e in sub.stream(timeout=0.05) for r in e.rows]
        got.append((seen, sub.fetch()))
    assert got[1] == got[0] == ([0, 1, 2], [])

