"""The port's binlog (storage/binlog.py) against the JAX package's.

The cases of tests/test_binlog_durable.py run through both packages'
``Binlog`` on the same appends: reopen, capacity trim across recovery, a
named capturer resuming after a restart, log compaction, the gap error of a
lagging cursor, and a SIGKILL'd writer.  Commit timestamps come from each
package's wall-clock TSO, so an outcome is compared with every timestamp
replaced by its position in the order of appends; a ``binlog.wal`` written
by one package is read by the other with its timestamps as written.  Then
the session's events (kind, table, row images, statement image, affected
count; never ``commit_ts``) for the same statements in a JAX ``Session``
(CPU, x64) and a port ``Session(device="cpu")``: DML, LOAD DATA,
transactions, ALTER, TRUNCATE, and a ``data_dir`` reopened.  All exact.
"""

import os
import signal
import subprocess
import sys
import textwrap

import pytest

from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.storage.binlog import Binlog as JBinlog
from baikaldb_tpu.storage.binlog import BinlogGapError as JGap
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.storage.binlog import Binlog as TBinlog
from baikaldb_tpu_torch.storage.binlog import BinlogGapError as TGap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = [(JBinlog, JGap), (TBinlog, TGap)]


def _both(scenario, tmp_path):
    """Run ``scenario(Binlog, GapError, path)`` for each package in its own
    directory; the outcomes must be equal."""
    outs = []
    for name, (cls, gap) in zip(("jax", "port"), PACKAGES):
        d = tmp_path / name
        d.mkdir()
        outs.append(scenario(cls, gap, str(d / "b.wal")))
    assert outs[1] == outs[0]
    return outs[1]


def _pos(ts_list):
    """ts -> its index in append order."""
    return {t: i for i, t in enumerate(ts_list)}


def test_events_survive_reopen(tmp_path):
    def sc(Binlog, _gap, p):
        b = Binlog(path=p)
        ts = [b.append("insert", "d", "t", rows=[{"id": i}]) for i in range(5)]
        got = Binlog(path=p).read(0)
        b2 = Binlog(path=p)
        t6 = b2.append("ddl", "d", "t", statement="ALTER ...")
        pos = _pos(ts)
        return ([(pos[e.commit_ts], e.event_type, e.rows) for e in got], t6 > ts[-1])
    assert _both(sc, tmp_path)[1]


def test_capacity_trim_survives_recovery(tmp_path):
    def sc(Binlog, _gap, p):
        b = Binlog(capacity=3, path=p)
        ts = [b.append("insert", "d", "t") for _ in range(6)]
        b2 = Binlog(capacity=3, path=p)
        kept = [_pos(ts)[e.commit_ts] for e in b2.read(ts[2])]
        with pytest.raises(ValueError):
            b2.read(0)          # GC'd past: the live log's contract
        return kept
    assert _both(sc, tmp_path) == [3, 4, 5]


def test_named_capturer_resumes_after_restart(tmp_path):
    def sc(Binlog, _gap, p):
        b = Binlog(path=p)
        first = [b.append("insert", "d", "t", rows=[{"i": i}]) for i in range(4)]
        got1 = [e.commit_ts for e in b.subscribe(name="sync").poll(limit=2)]
        b2 = Binlog(path=p)
        more = b2.append("delete", "d", "t", affected=1)
        got2 = [e.commit_ts for e in b2.subscribe(name="sync").poll()]
        pos = _pos(first + [more])
        return [pos[t] for t in got1], [pos[t] for t in got2]
    assert _both(sc, tmp_path) == ([0, 1], [2, 3, 4])


def test_log_compaction_bounds_disk_and_recovery(tmp_path):
    def sc(Binlog, _gap, p):
        b = Binlog(capacity=50, path=p)
        ts = [b.append("insert", "d", "t", rows=[{"i": i}]) for i in range(130)]
        size = os.path.getsize(p)
        ring = [e.commit_ts for e in b.read(b._oldest_ts)]
        b2 = Binlog(capacity=50, path=p)
        again = [e.commit_ts for e in b2.read(b2._oldest_ts)]
        for i in range(400):
            b2.append("insert", "d", "t", rows=[{"i": i}])
        bounded = os.path.getsize(p) < max(4 * size, 200_000)
        pos = _pos(ts)
        return [pos[t] for t in ring], again == ring, bounded
    ring, same, bounded = _both(sc, tmp_path)
    assert ring == list(range(80, 130)) and same and bounded


def test_lagging_cursor_gets_gap_error_then_resumes(tmp_path):
    def sc(Binlog, gap, p):
        b = Binlog(capacity=4, path=p)
        ts = [b.append("insert", "d", "t") for _ in range(3)]
        cap = b.subscribe(name="slow")
        first = [e.commit_ts for e in cap.poll(limit=1)]
        ts += [b.append("insert", "d", "t") for _ in range(10)]
        with pytest.raises(gap) as ei:
            cap.poll()
        pos = _pos(ts)
        lost = (pos[ei.value.lost_from], pos[ei.value.lost_to])
        got = [pos[e.commit_ts] for e in cap.poll()]
        resumed = Binlog(capacity=4, path=p).subscribe(name="slow").poll()
        return [pos[t] for t in first], lost, got, resumed
    assert _both(sc, tmp_path) == ([0], (0, 8), [9, 10, 11, 12], [])


def test_kill9_recovery_no_gap_no_dup(tmp_path):
    """A SIGKILL'd writer of the port: what its capturer acknowledged stays
    acknowledged, what it appended stays readable, the cursor resumes with
    no gap and no duplicate; the JAX package reads the same log and cursor."""
    p = str(tmp_path / "b.wal")
    out = str(tmp_path / "acked.txt")
    child = textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {REPO!r})
        from baikaldb_tpu_torch.storage.binlog import Binlog
        b = Binlog(path={p!r})
        for i in range(10):
            b.append("insert", "d", "t", rows=[{{"i": i}}])
        acked = b.subscribe(name="sync").poll(limit=6)
        with open({out!r}, "w") as f:
            f.write(",".join(str(e.commit_ts) for e in acked))
            f.flush(); os.fsync(f.fileno())
        os.kill(os.getpid(), 9)
    """)
    r = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == -signal.SIGKILL, r.stderr
    acked = [int(x) for x in open(out).read().split(",")]
    for cls in (TBinlog, JBinlog):
        b = cls(path=p)
        all_ts = [e.commit_ts for e in b.read(0)]
        assert len(all_ts) == 10 and acked == all_ts[:6]
        assert [e.commit_ts for e in b.subscribe(name="sync").poll()] == all_ts[6:]
        # the poll moved the durable cursor: the next package starts over
        b._save_cursor("sync", acked[-1])


@pytest.mark.parametrize("writer,reader", [(JBinlog, TBinlog), (TBinlog, JBinlog)],
                         ids=["jax_to_port", "port_to_jax"])
def test_a_binlog_wal_opens_in_the_other_package(tmp_path, writer, reader):
    """The same file: events, named cursors and the GC watermark as written."""
    p = str(tmp_path / "b.wal")
    b = writer(capacity=5, path=p)
    ts = [b.append("update", "d", "t", rows=[{"old": {"i": i}, "new": {"i": i + 1}}],
                   statement=f"UPDATE {i}", affected=1) for i in range(8)]
    b.subscribe(start_ts=ts[4], name="c").poll(limit=1)
    b.hold_gc("h", ts[6])
    b.append("delete", "d", "t", statement="DELETE", affected=3)
    want = [(e.commit_ts, e.event_type, e.rows, e.statement, e.affected)
            for e in b.read(b._oldest_ts)]
    r = reader(capacity=5, path=p)
    assert r._oldest_ts == b._oldest_ts and r._cursors == b._cursors
    assert [(e.commit_ts, e.event_type, e.rows, e.statement, e.affected)
            for e in r.read(r._oldest_ts)] == want
    assert r.append("ddl", "d", "t") > want[-1][0]


# -- the session's events ----------------------------------------------------

def _events(db) -> list:
    return [(e.event_type, e.database, e.table, e.rows, e.statement, e.affected)
            for e in db.binlog.read(0, 1 << 30)]


class Pair:
    """A JAX and a port session over their own databases: each statement
    runs in both with the same outcome, and the binlogs hold the same
    events."""

    def __init__(self, jdb=None, tdb=None):
        self.j = JSession(jdb or JDatabase())
        self.t = TSession(tdb or TDatabase("cpu"))

    def run(self, sql):
        outs = []
        for s in (self.j, self.t):
            try:
                r = s.execute(sql)
                outs.append(r.to_pylist() if r.arrow is not None else r.affected_rows)
            except Exception as e:     # noqa: BLE001 — compared across packages
                outs.append(type(e).__name__)
        assert outs[1] == outs[0], (sql, outs)
        return outs[1]

    def script(self, stmts):
        for q in stmts:
            self.run(q)

    def events(self):
        got, want = _events(self.t.db), _events(self.j.db)
        assert got == want
        return got


def test_dml_events_match_jax():
    p = Pair()
    p.script(["CREATE TABLE bl (id BIGINT PRIMARY KEY, v DOUBLE, s VARCHAR(8), "
              "d DATETIME)",
              "INSERT INTO bl VALUES (1, 1.5, 'a', '2024-01-02 03:04:05'), "
              "(2, 2.5, NULL, NULL)",
              "UPDATE bl SET v = 9 WHERE id = 1",
              "DELETE FROM bl WHERE id = 2",
              "DELETE FROM bl WHERE id = 99",
              "REPLACE INTO bl VALUES (1, 3.0, 'r', NULL), (5, 5.0, 'n', NULL)",
              "INSERT INTO bl VALUES (5, 0, 'x', NULL) ON DUPLICATE KEY UPDATE v = 6",
              "INSERT INTO bl SELECT id + 10, v, s, d FROM bl",
              "ALTER TABLE bl ADD COLUMN note VARCHAR(4)",
              "TRUNCATE TABLE bl"])
    kinds = [e[0] for e in p.events()]
    assert kinds == ["insert", "update", "delete", "insert", "insert", "insert", "ddl",
                     "truncate"]


def test_bulk_statements_log_statement_images_as_jax():
    """Past 1,000 rows an INSERT logs its statement image; an UPDATE and a
    DELETE log row images only while a subscription reads the table."""
    p = Pair()
    p.run("CREATE TABLE big (id BIGINT PRIMARY KEY, v BIGINT)")
    p.run("INSERT INTO big VALUES " + ", ".join(f"({i}, {i % 7})" for i in range(1200)))
    p.run("UPDATE big SET v = v + 1 WHERE id < 3")
    for s in (p.j, p.t):
        s.execute("CREATE SUBSCRIPTION watch ON big")
    p.run("UPDATE big SET v = v + 1 WHERE id < 3")
    p.run("DELETE FROM big WHERE id >= 1195")
    ev = p.events()
    assert ev[0][3] == [] and ev[0][4] == "bulk insert 1200 rows"
    assert ev[1][3] == [] and ev[2][3][0]["old"] == {"id": 0, "v": 1}
    assert len(ev[3][3]) == 5


def test_load_data_logs_one_event_as_jax(tmp_path):
    path = tmp_path / "rows.csv"
    path.write_text("".join(f"{i},{i * 3}\n" for i in range(50)))
    p = Pair()
    p.run("CREATE TABLE l (id BIGINT PRIMARY KEY, v BIGINT)")
    p.run(f"LOAD DATA INFILE '{path}' INTO TABLE l")
    assert p.events() == [("insert", "default", "l", [], f"LOAD DATA INFILE {str(path)!r}",
                           50)]


def test_transactions_publish_at_commit_only():
    """Rolled-back changes never reach the binlog; a commit appends its
    events in statement order (tests/test_lifecycle.py's regression)."""
    p = Pair()
    p.run("CREATE TABLE tb (x BIGINT PRIMARY KEY, y BIGINT)")
    caps = [s.db.binlog.subscribe() for s in (p.j, p.t)]
    p.script(["BEGIN", "INSERT INTO tb VALUES (1, 1)"])
    assert [c.poll() for c in caps] == [[], []]
    p.run("ROLLBACK")
    assert [c.poll() for c in caps] == [[], []]
    p.script(["BEGIN", "INSERT INTO tb VALUES (2, 2)", "UPDATE tb SET y = 5 WHERE x = 2",
              "DELETE FROM tb WHERE x = 2", "INSERT INTO tb VALUES (3, 3)"])
    assert [c.poll() for c in caps] == [[], []]
    p.run("COMMIT")
    got = [[(e.event_type, e.rows, e.affected) for e in c.poll()] for c in caps]
    assert got[1] == got[0] and [g[0] for g in got[1]] == ["insert", "update", "delete",
                                                              "insert"]
    # DDL commits an open transaction, events included
    p.script(["BEGIN", "INSERT INTO tb VALUES (4, 4)", "CREATE TABLE other (a BIGINT)"])
    assert [[e.rows for e in c.poll()] for c in caps] == [[[{"x": 4, "y": 4}]]] * 2
    p.events()


def test_database_binlog_durable_under_data_dir(tmp_path):
    p = Pair(JDatabase(data_dir=str(tmp_path / "j")),
             TDatabase("cpu", data_dir=str(tmp_path / "t")))
    p.script(["CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))",
              "INSERT INTO t VALUES (1, 1.0), (2, 2.0)",
              "DELETE FROM t WHERE id = 2"])
    before = p.events()
    # reopened: the history is intact (through JSON, as the JAX package keeps it)
    p2 = Pair(JDatabase(data_dir=str(tmp_path / "j")),
              TDatabase("cpu", data_dir=str(tmp_path / "t")))
    assert p2.events() == before and [e[0] for e in before] == ["insert", "delete"]
    # the port reads the JAX package's directory: same events, same ts
    t3 = TDatabase("cpu", data_dir=str(tmp_path / "j"))
    assert [(e.commit_ts, e.rows) for e in t3.binlog.read(0)] == \
        [(e.commit_ts, e.rows) for e in p2.j.db.binlog.read(0)]
