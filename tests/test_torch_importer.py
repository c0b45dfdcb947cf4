"""The port's bulk importer and backup tools (tools/importer.py,
tools/backup.py) against the JAX package's.

The cases of tests/test_importer.py run in both packages on the same files:
hot CSV and Parquet jobs, the done-file watch, the fast import that builds
cold segments on a fleet, and its guards; the rows each package imported
are compared exactly.  A backup dumped by either package restores in the
other with equal rows and an equal catalog (tests/test_lifecycle.py's
round trip, across packages), and the importer's command line runs on the
CPU with ``--device cpu``.
"""

import json
import os
import subprocess
import sys

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.tools import backup as jbackup
from baikaldb_tpu.tools import importer as jimp
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.tools import backup as tbackup
from baikaldb_tpu_torch.tools import importer as timp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DDL = ("CREATE TABLE imp (id BIGINT, name VARCHAR(32), amt DOUBLE, "
       "PRIMARY KEY (id))")
ALL = "SELECT id, name, amt FROM imp ORDER BY id"


def write_csv(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join("" if x is None else str(x) for x in r) + "\n")


def _pair():
    j, t = JSession(JDatabase()), TSession(TDatabase("cpu"))
    for s in (j, t):
        s.execute(DDL)
    return j, t


def _both(j, t, job_kw, sql=ALL):
    """Run one job in each package -> the imported count and the rows,
    held equal."""
    nj = jimp.run_job(j, jimp.ImportJob(**job_kw))
    nt = timp.run_job(t, timp.ImportJob(**job_kw))
    assert nt == nj
    rows = t.query(sql)
    assert rows == j.query(sql)
    return nt, rows


def test_hot_csv_job(tmp_path):
    j, t = _pair()
    write_csv(tmp_path / "a.csv", [(1, "x", 1.5), (2, "y", 2.5), (4, None, None)])
    write_csv(tmp_path / "b.csv", [(3, "z", 3.5)])
    n, _ = _both(j, t, {"table": "imp", "files": [str(tmp_path / "a.csv"),
                                                  str(tmp_path / "b.csv")]})
    assert n == 4
    assert t.query("SELECT COUNT(*) n, SUM(amt) sa FROM imp") == [{"n": 4, "sa": 7.5}]
    # PK duplicates are rejected in both (the hot path is checked)
    write_csv(tmp_path / "dup.csv", [(1, "again", 0.0)])
    errs = []
    for s, mod in ((j, jimp), (t, timp)):
        with pytest.raises(Exception) as ei:
            mod.run_job(s, mod.ImportJob(table="imp", files=[str(tmp_path / "dup.csv")]))
        errs.append(type(ei.value).__name__)
    assert errs[0] == errs[1]
    assert t.query(ALL) == j.query(ALL)
    # the job is a binlog event in both
    for s in (j, t):
        ev = [e for e in s.db.binlog.read(0, 1 << 20) if e.table == "imp"][-1]
        assert (ev.event_type, ev.statement, ev.affected) == \
            ("insert", "IMPORT 2 files", 4)


def test_parquet_job(tmp_path):
    j, t = _pair()
    pq.write_table(pa.table({"id": [10, 11], "name": ["p", "q"], "amt": [1.0, 2.0],
                             "extra": [0, 0]}), tmp_path / "d.parquet")
    n, rows = _both(j, t, {"table": "imp", "files": [str(tmp_path / "d.parquet")],
                           "format": "parquet"})
    assert n == 2 and [r["id"] for r in rows] == [10, 11]


def test_csv_job_options(tmp_path):
    """A JSON job with a delimiter, a column order and relative paths."""
    j, t = _pair()
    (tmp_path / "s.csv").write_text("x|5|0.25\ny|6|\\N\n")
    (tmp_path / "j.json").write_text(json.dumps(
        {"table": "default.imp", "files": ["s.csv"], "delimiter": "|",
         "columns": ["name", "id", "amt"]}))
    for s, mod in ((j, jimp), (t, timp)):
        assert mod.run_job(s, mod.ImportJob.from_json(str(tmp_path / "j.json"))) == 2
    assert t.query(ALL) == j.query(ALL) == [
        {"id": 5, "name": "x", "amt": 0.25}, {"id": 6, "name": "y", "amt": None}]


def test_done_file_watch(tmp_path):
    s = TSession(TDatabase("cpu"))
    s.execute(DDL)
    d = tmp_path / "inbox"
    d.mkdir()
    write_csv(d / "j1.csv", [(1, "a", 1.0)])
    (d / "j1.json").write_text(json.dumps({"table": "imp", "files": ["j1.csv"]}))
    assert timp.watch_dir(s, str(d), poll_s=0, max_rounds=1) == 0   # no .done yet
    (d / "j1.done").write_text("")
    assert timp.watch_dir(s, str(d), poll_s=0, max_rounds=1) == 1
    assert s.query("SELECT COUNT(*) n FROM imp") == [{"n": 1}]
    assert timp.watch_dir(s, str(d), poll_s=0, max_rounds=1) == 0   # never re-runs
    assert (d / "j1.imported").exists()


def test_fast_import_builds_cold_segments(tmp_path):
    """The fast import on a fleet in both packages: the bulk rows land in
    cold segments (the hot tier keeps its one row), a fresh frontend sees
    them, and both packages hold the same rows and segment files."""
    from baikaldb_tpu.meta.service import MetaService as JMeta
    from baikaldb_tpu.raft.fleet import StoreFleet as JFleet
    from baikaldb_tpu_torch.meta.service import MetaService
    from baikaldb_tpu_torch.raft.fleet import StoreFleet

    write_csv(tmp_path / "bulk.csv", [(i, f"r{i}", float(i)) for i in range(100, 120)])
    out = []
    for Meta, Fleet, Sess, mkdb, mod, tag in (
            (JMeta, JFleet, JSession, JDatabase, jimp, "j"),
            (MetaService, StoreFleet, TSession, lambda **kw: TDatabase("cpu", **kw), timp,
             "t")):
        fleet = Fleet(Meta(peer_count=3), ["a:1", "b:1", "c:1"], seed=47)
        cold = str(tmp_path / f"afs_{tag}")
        s = Sess(mkdb(fleet=fleet, cold_dir=cold))
        s.execute(DDL)
        s.execute("INSERT INTO imp VALUES (1, 'hot', 1.0)")
        job = mod.ImportJob(table="imp", files=[str(tmp_path / "bulk.csv")], mode="fast")
        assert mod.run_job(s, job) == 20
        assert fleet.row_tiers["default.imp"].num_rows() == 1       # only the hot row
        files = sorted(s.db.cold_fs().list())
        assert files
        s2 = Sess(mkdb(fleet=fleet, cold_dir=cold))
        s2.execute(DDL)
        out.append((s.query(ALL), s2.query(ALL), files))
    (jrows, jrows2, jfiles), (trows, trows2, tfiles) = out
    assert len(trows) == 21 and trows == trows2 == jrows == jrows2
    assert tfiles == jfiles


def test_fast_import_guards(tmp_path):
    s = TSession(TDatabase("cpu"))
    s.execute(DDL)
    write_csv(tmp_path / "x.csv", [(1, "a", 1.0)])
    with pytest.raises(ValueError, match="fleet-replicated"):
        timp.run_job(s, timp.ImportJob(table="imp", files=[str(tmp_path / "x.csv")],
                                       mode="fast"))


def test_importer_cli_on_the_cpu(tmp_path):
    """``python -m baikaldb_tpu_torch.tools.importer --job J --data-dir D
    --device cpu``: the job's rows are durable in D (the JAX package's
    layout: a JAX Database over D reads them)."""
    data = tmp_path / "data"
    s = TSession(TDatabase("cpu", data_dir=str(data)))
    s.execute(DDL)
    s.db.close()
    write_csv(tmp_path / "c.csv", [(7, "q", 0.5), (8, "r", 1.5)])
    (tmp_path / "c.json").write_text(json.dumps({"table": "imp", "files": ["c.csv"]}))
    r = subprocess.run([sys.executable, "-m", "baikaldb_tpu_torch.tools.importer",
                        "--job", str(tmp_path / "c.json"), "--data-dir", str(data),
                        "--device", "cpu"], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"imported": 2}
    want = [{"id": 7, "name": "q", "amt": 0.5}, {"id": 8, "name": "r", "amt": 1.5}]
    assert TSession(TDatabase("cpu", data_dir=str(data))).query(ALL) == want
    assert JSession(JDatabase(data_dir=str(data))).query(ALL) == want


# -- backup / restore ----------------------------------------------------------

BACKUP_SCRIPT = [
    "CREATE DATABASE appdb",
    "USE appdb",
    "CREATE TABLE users (id BIGINT PRIMARY KEY, name VARCHAR(16), score DOUBLE, "
    "born DATE, KEY k_name (name))",
    "INSERT INTO users VALUES (1, 'a', 1.5, '2001-02-03'), (2, 'b', NULL, NULL), "
    "(3, NULL, -2.25, '1999-12-31')",
    "CREATE TABLE events (k BIGINT, g INT, v FLOAT) TTL=3600",
    "INSERT INTO events VALUES (1, 1, 0.5), (2, 1, 1.5), (3, 2, 2.5)",
    "DELETE FROM events WHERE k = 2",
    "USE default",
    "CREATE TABLE plain (x BIGINT)",
    "INSERT INTO plain VALUES (42)",
]
BACKUP_READS = [
    ("appdb", "SELECT id, name, score, born FROM users ORDER BY id"),
    ("appdb", "SELECT g, COUNT(*) n, SUM(v) s FROM events GROUP BY g ORDER BY g"),
    ("appdb", "SELECT name FROM users WHERE name = 'b'"),
    ("default", "SELECT x FROM plain"),
]


def _catalog(db):
    out = {}
    for d in db.catalog.databases():
        if d == "information_schema":
            continue
        for name in db.catalog.tables(d):
            info = db.catalog.get_table(d, name)
            out[f"{d}.{name}"] = (
                [(f.name, f.ltype.value, f.nullable) for f in info.schema.fields],
                [(ix.name, ix.kind, list(ix.columns)) for ix in info.indexes],
                dict(info.options or {}), info.version)
    return out


@pytest.mark.parametrize("dumper", ["jax", "port"])
def test_backup_restores_across_packages(tmp_path, dumper):
    """A backup dumped by either package restores in both: equal rows and
    an equal catalog; the restored tables take writes."""
    j, t = JSession(JDatabase()), TSession(TDatabase("cpu"))
    for sql in BACKUP_SCRIPT:
        for s in (j, t):
            s.execute(sql)
    src = j if dumper == "jax" else t
    (jbackup if dumper == "jax" else tbackup).dump(src.db, str(tmp_path / "bk"))
    restored = {"jax": jbackup.restore(str(tmp_path / "bk")),
                "port": tbackup.restore(str(tmp_path / "bk"), device="cpu")}
    assert restored["port"].device.type == "cpu"
    assert _catalog(restored["port"]) == _catalog(restored["jax"]) == _catalog(src.db)
    for dbname, sql in BACKUP_READS:
        got = TSession(restored["port"], dbname).query(sql)
        assert got == JSession(restored["jax"], dbname).query(sql) == \
            TSession(t.db, dbname).query(sql), sql
    s2 = TSession(restored["port"], "appdb")
    s2.execute("INSERT INTO users VALUES (4, 'd', 4.0, NULL)")
    assert s2.query("SELECT COUNT(*) n FROM users") == [{"n": 4}]
    info = restored["port"].catalog.get_table("appdb", "users")
    assert info.primary_key() is not None
