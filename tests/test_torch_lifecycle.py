"""The port's lifecycle statements against the JAX package's: binlog capture
through a capturer, resume from a timestamp, TTL purges (``ttl_tick`` and
HANDLE ttl, a misconfigured table skipped), the BINLOG table option, ALTER
TABLE ADD / DROP COLUMN, and transactions in the binlog.

The cases of tests/test_lifecycle.py, without its backup round trip (whose
tools/backup.py is not ported), run in a JAX ``Session`` (CPU, x64) and a
port ``Session(device="cpu")`` on the same statements.  Rows, affected
counts, error types and events (kind, table, row images, statement image,
affected count; never ``commit_ts``) are compared exactly.
"""

import datetime

from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession


def _ev(e):
    # a TTL purge's cutoff is each package's own wall clock
    stmt = e.statement.split(" < ")[0] if e.statement.startswith("TTL purge") else e.statement
    return (e.event_type, e.database, e.table, e.rows, stmt, e.affected)


class Pair:
    def __init__(self):
        self.j = JSession(JDatabase())
        self.t = TSession(TDatabase("cpu"))

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

    def capturers(self, **kw):
        return [s.db.binlog.subscribe(**kw) for s in (self.j, self.t)]

    @staticmethod
    def poll(caps):
        got = [[_ev(e) for e in c.poll()] for c in caps]
        assert got[1] == got[0]
        return got[1]

    def events(self):
        got = [[_ev(e) for e in s.db.binlog.read(0, 1 << 30)] for s in (self.j, self.t)]
        assert got[1] == got[0]
        return got[1]


def _ago(**delta) -> str:
    return (datetime.datetime.now() - datetime.timedelta(**delta)).strftime(
        "%Y-%m-%d %H:%M:%S")


def test_binlog_capture_ordering():
    p = Pair()
    p.run("CREATE TABLE bl (id BIGINT, v DOUBLE)")
    caps = p.capturers()
    p.script(["INSERT INTO bl VALUES (1, 1.0), (2, 2.0)",
              "UPDATE bl SET v = 9 WHERE id = 1",
              "DELETE FROM bl WHERE id = 2"])
    events = p.poll(caps)
    assert [e[0] for e in events] == ["insert", "update", "delete"]
    assert events[0][3] == [{"id": 1, "v": 1.0}, {"id": 2, "v": 2.0}]
    assert "UPDATE bl" in events[1][4] and events[1][5] == 1 and events[2][5] == 1
    for c in caps:
        ts = [e.commit_ts for e in c.binlog.read(0)]
        assert ts == sorted(ts)
    assert p.poll(caps) == []
    p.run("INSERT INTO bl VALUES (3, 3.0)")
    assert [e[3] for e in p.poll(caps)] == [[{"id": 3, "v": 3.0}]]


def test_binlog_resume_from_ts():
    p = Pair()
    p.script(["CREATE TABLE bl2 (id BIGINT)", "INSERT INTO bl2 VALUES (1)"])
    mids = [s.db.binlog.current_ts() for s in (p.j, p.t)]
    p.run("INSERT INTO bl2 VALUES (2)")
    caps = [s.db.binlog.subscribe(start_ts=m) for s, m in zip((p.j, p.t), mids)]
    assert [e[3] for e in p.poll(caps)] == [[{"id": 2}]]


def test_ttl_purge():
    p = Pair()
    p.run("CREATE TABLE sess_log (id BIGINT, create_time DATETIME) TTL=3600")
    p.run(f"INSERT INTO sess_log VALUES (1, '{_ago(hours=2)}'), (2, '{_ago(seconds=0)}')")
    now = datetime.datetime.now()
    assert [s.ttl_tick(now) for s in (p.j, p.t)] == [1, 1]
    assert p.run("SELECT id FROM sess_log") == [{"id": 2}]
    assert p.events()[-1] == ("delete", "default", "sess_log", [], "TTL purge create_time", 1)
    stmts = [s.db.binlog.read(0)[-1].statement for s in (p.j, p.t)]
    assert stmts[1] == stmts[0] == \
        f"TTL purge create_time < {now - datetime.timedelta(seconds=3600)}"


def test_handle_ttl_with_ttl_column_and_binlog_option():
    p = Pair()
    p.script(["CREATE TABLE ev (id BIGINT PRIMARY KEY, ts DATETIME, v INT) TTL=60 "
              "TTL_COLUMN=ts BINLOG=1",
              "CREATE TABLE keep (id BIGINT, create_time DATE) TTL=86400",
              f"INSERT INTO ev VALUES (1, '{_ago(hours=1)}', 1), (2, '{_ago(seconds=0)}', 2), "
              f"(3, NULL, 3), (4, '{_ago(days=3)}', 4)",
              "INSERT INTO keep VALUES (1, '2000-01-01'), (2, '2999-01-01')"])
    assert p.run("HANDLE ttl") == 3
    p.run("SELECT id FROM ev ORDER BY id")
    p.run("SELECT id FROM keep ORDER BY id")
    assert p.run("HANDLE ttl_tick") == 0
    p.run("SHOW CREATE TABLE ev")
    assert p.events()[-2:][0][0] == "delete"


def test_ttl_misconfigured_table_does_not_block_sweep():
    p = Pair()
    p.script(["CREATE TABLE badttl (id BIGINT, name VARCHAR(8)) TTL=10 TTL_COLUMN=name",
              "CREATE TABLE goodttl (id BIGINT, create_time DATETIME) TTL=10",
              f"INSERT INTO goodttl VALUES (1, '{_ago(hours=1)}')",
              "INSERT INTO badttl VALUES (1, 'x')"])
    assert [s.ttl_tick() for s in (p.j, p.t)] == [1, 1]
    p.run("SELECT COUNT(*) n FROM badttl")


def test_alter_table_add_drop_column():
    p = Pair()
    p.script(["CREATE TABLE al (id BIGINT, a DOUBLE)", "INSERT INTO al VALUES (1, 1.5)",
              "ALTER TABLE al ADD COLUMN note VARCHAR(32)"])
    assert p.run("SELECT id, note FROM al") == [{"id": 1, "note": None}]
    p.script(["INSERT INTO al VALUES (2, 2.5, 'hi')", "SELECT id, note FROM al ORDER BY id",
              "ALTER TABLE al DROP COLUMN a", "DESCRIBE al", "SELECT a FROM al",
              "SELECT id FROM al ORDER BY id", "ALTER TABLE al FROB COLUMN x"])
    assert [e[0] for e in p.events()] == ["insert", "ddl", "insert", "ddl"]


def test_binlog_respects_transactions():
    p = Pair()
    p.run("CREATE TABLE tb (x BIGINT)")
    caps = p.capturers()
    p.script(["BEGIN", "INSERT INTO tb VALUES (1)"])
    assert p.poll(caps) == []
    p.run("ROLLBACK")
    assert p.poll(caps) == []
    p.script(["BEGIN", "INSERT INTO tb VALUES (2)", "COMMIT"])
    assert [e[3] for e in p.poll(caps)] == [[{"x": 2}]]


def test_alter_not_null_rejected_on_nonempty():
    p = Pair()
    p.script(["CREATE TABLE ann (id BIGINT)", "INSERT INTO ann VALUES (1)",
              "ALTER TABLE ann ADD COLUMN x BIGINT NOT NULL",
              "ALTER TABLE ann ADD COLUMN y BIGINT", "DESCRIBE ann"])


def test_drop_column_removes_dangling_indexes():
    p = Pair()
    p.script(["CREATE TABLE dci (a BIGINT PRIMARY KEY, b BIGINT)",
              "ALTER TABLE dci DROP COLUMN a", "SHOW INDEX FROM dci"])
    info = p.t.db.catalog.get_table("default", "dci")
    assert all("a" not in ix.columns for ix in info.indexes)
