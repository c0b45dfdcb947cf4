"""The port's MySQL server and client (server/mysql_server.py,
client/mysql_client.py) against the JAX package's.

The cases of tests/test_server.py and tests/test_server_surface.py run
against the port's server (``MySQLServer(Database("cpu"))``) through the
port's client: a real TCP round trip, auth against the privilege catalog,
prepared statements over the binary protocol, SHOW / HANDLE / LOAD DATA,
the errno catalog, KILL CONNECTION.

The cross-wire case runs one SQL script (DDL, DML, SELECT with GROUP BY,
errors, a transaction, prepared statements, SHOW) four ways: the JAX
client against the port's server, the port's client against the JAX
server, and each client against its own server.  Every packet a client
reads is kept: the column-definition packets must be equal byte for byte,
OK packets' affected rows equal, ERR packets' errno and SQLSTATE equal, and
the row values equal under the parity contract (rtol 1e-4 where the JAX
package and the port round a float32 sum differently; exact elsewhere).
"""

import math
import os
import subprocess
import sys
import threading
import time

import pytest

from baikaldb_tpu.client.mysql_client import Connection as JConnection
from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.server.mysql_server import MySQLServer as JServer
from baikaldb_tpu_torch.client.mysql_client import Connection, MySQLError, Pool
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.server.mysql_server import MySQLServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server():
    srv = MySQLServer(TDatabase("cpu"), port=0).start()
    yield srv
    srv.stop()


# -- tests/test_server.py ----------------------------------------------------

def test_connect_ping_quit(server):
    c = Connection(port=server.port)
    assert c.ping()
    c.close()


def test_ddl_dml_select_roundtrip(server):
    c = Connection(port=server.port)
    c.query("CREATE TABLE wire (id BIGINT, name VARCHAR(16), v DOUBLE)")
    r = c.query("INSERT INTO wire VALUES (1,'a',1.5),(2,'b',NULL),(3,NULL,3.0)")
    assert r.affected_rows == 3
    r = c.query("SELECT id, name, v FROM wire ORDER BY id")
    assert r.columns == ["id", "name", "v"]
    assert r.rows[0] == ("1", "a", "1.5")
    assert r.rows[1][2] is None
    assert r.rows[2][1] is None
    r = c.query("SELECT name, COUNT(*) n FROM wire GROUP BY name ORDER BY n DESC, name")
    assert len(r.rows) == 3
    c.close()


def test_error_packet(server):
    c = Connection(port=server.port)
    with pytest.raises(MySQLError):
        c.query("SELECT broken syntax here FROM")
    assert c.ping()                    # the connection survives an error
    c.close()


def test_use_database(server):
    c = Connection(port=server.port)
    c.query("CREATE DATABASE IF NOT EXISTS wiredb")
    c.query("USE wiredb")
    c.query("CREATE TABLE t2 (x BIGINT)")
    c.query("INSERT INTO t2 VALUES (7)")
    assert c.query("SELECT x FROM t2").rows == [("7",)]
    c.close()


def test_concurrent_connections_share_database(server):
    c1 = Connection(port=server.port)
    c2 = Connection(port=server.port)
    c1.query("CREATE TABLE shared (x BIGINT)")
    c1.query("INSERT INTO shared VALUES (42)")
    assert c2.query("SELECT x FROM shared").rows == [("42",)]
    c1.close()
    c2.close()


def test_transactions_per_connection(server):
    c1 = Connection(port=server.port)
    c1.query("CREATE TABLE wtx (x BIGINT)")
    c1.query("INSERT INTO wtx VALUES (1)")
    c1.query("BEGIN")
    c1.query("INSERT INTO wtx VALUES (2)")
    c1.query("ROLLBACK")
    assert c1.query("SELECT COUNT(*) FROM wtx").rows == [("1",)]
    c1.close()


def test_pool(server):
    pool = Pool("127.0.0.1", server.port, size=2)
    pool.query("CREATE TABLE pooled (x BIGINT)")
    pool.query("INSERT INTO pooled VALUES (1)")
    results = []

    def worker():
        results.append(pool.query("SELECT COUNT(*) FROM pooled").rows[0][0])

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == ["1"] * 6


def test_kill_connection_severs_the_socket(server):
    """KILL CONNECTION from another connection shuts the victim's socket:
    its next command finds the connection gone, and it leaves the
    processlist."""
    victim = Connection(port=server.port)
    vid = int(victim.query("SELECT CONNECTION_ID()").rows[0][0])
    assert vid in server.db.processlist
    killer = Connection(port=server.port)
    assert killer.query(f"KILL CONNECTION {vid}").affected_rows == 0
    with pytest.raises((ConnectionError, OSError, MySQLError)):
        victim.query("SELECT 1")
    deadline = time.monotonic() + 10
    while vid in server.db.processlist and time.monotonic() < deadline:
        time.sleep(0.02)
    assert vid not in server.db.processlist
    with pytest.raises(MySQLError) as ei:
        killer.query("KILL 999999")
    assert ei.value.code == 1094
    killer.close()


def test_sysvar_wire_protocol(server):
    """tests/test_session_env.py's wire case: the session environment over
    the port's server (the version comment names the port)."""
    c = Connection("127.0.0.1", server.port)
    assert c.query("SELECT @@version_comment").rows == [("baikaldb_tpu_torch (PyTorch/CUDA)",)]
    r = c.query("SELECT DATABASE(), CONNECTION_ID()")
    assert r.rows[0][0] == "default" and int(r.rows[0][1]) in server.db.processlist
    c.close()


# -- tests/test_server_surface.py --------------------------------------------

@pytest.fixture(scope="module")
def srv():
    server = MySQLServer(TDatabase("cpu"), port=0).start()
    root = Connection("127.0.0.1", server.port)
    root.query("CREATE USER 'app' IDENTIFIED BY 'secret'")
    root.query("CREATE DATABASE shop")
    root.query("GRANT ALL ON shop.* TO 'app'")
    root.query("CREATE TABLE shop.items (id BIGINT AUTO_INCREMENT, "
               "name VARCHAR, PRIMARY KEY (id))")
    root.query("INSERT INTO shop.items (name) VALUES ('pen'), ('ink')")
    yield server, root
    server.stop()


def _app(server):
    return Connection("127.0.0.1", server.port, user="app", password="secret",
                      database="shop")


def test_auth_rejects_wrong_password(srv):
    server, _ = srv
    with pytest.raises(MySQLError) as ei:
        Connection("127.0.0.1", server.port, user="app", password="nope")
    assert ei.value.code == 1045


def test_auth_accepts_and_selects_db(srv):
    server, _ = srv
    a = _app(server)
    assert a.query("SELECT id, name FROM items ORDER BY id").rows == \
        [("1", "pen"), ("2", "ink")]
    a.close()


def test_privilege_fence(srv):
    server, _ = srv
    a = _app(server)
    with pytest.raises(MySQLError) as ei:
        a.query("SELECT * FROM default.secret_table")
    assert ei.value.code == 1045
    a.close()


def test_errno_catalog(srv):
    _, root = srv
    for sql, code in (("INSERT INTO shop.items VALUES (1, 'dup')", 1062),
                      ("SELECT nope FROM shop.items", 1054),
                      ("SELECT * FROM shop.missing", 1146),
                      ("SELEC 1", 1064)):
        with pytest.raises(MySQLError) as ei:
            root.query(sql)
        assert ei.value.code == code, sql


def test_prepared_statements_binary(srv):
    server, _ = srv
    a = _app(server)
    sid = a.prepare("SELECT id, name FROM items WHERE id = ? OR name = ?")
    assert sorted(a.execute(sid, (1, "ink")).rows) == [("1", "pen"), ("2", "ink")]
    assert a.execute(sid, (2, "none")).rows == [("2", "ink")]
    assert a.execute(sid, (None, "pen")).rows == [("1", "pen")]     # NULL param
    ins = a.prepare("INSERT INTO items (name) VALUES (?)")
    assert a.execute(ins, ("quill",)).affected_rows == 1
    assert a.query("SELECT name FROM items WHERE id = 3").rows == [("quill",)]
    a.close()


def test_show_surface(srv):
    _, root = srv
    r = root.query("SHOW CREATE TABLE shop.items")
    assert "AUTO_INCREMENT" in r.rows[0][1] and "PRIMARY KEY" in r.rows[0][1]
    assert any("baikaldb" in v for _, v in
               root.query("SHOW VARIABLES LIKE 'version%'").rows)
    assert len(root.query("SHOW PROCESSLIST").rows) >= 1
    assert root.query("SHOW GRANTS FOR 'app'").rows == \
        [("GRANT ALL ON shop.* TO 'app'",)]
    root.query("USE shop")
    assert any("shop.items" in row[0] for row in root.query("SHOW REGIONS").rows)
    assert root.query("SHOW INDEX FROM items").rows[0][1] == "PRIMARY"
    assert root.query("SHOW COLUMNS FROM items").rows[0][0] == "id"


def test_load_data_and_handle(srv, tmp_path):
    _, root = srv
    csv = tmp_path / "more.csv"
    csv.write_text("10,stylus\n11,brush\n")
    r = root.query(f"LOAD DATA INFILE '{csv}' INTO TABLE shop.items "
                   "FIELDS TERMINATED BY ','")
    assert r.affected_rows == 2
    root.query("HANDLE ttl_tick")
    with pytest.raises(MySQLError):
        root.query("HANDLE bogus_command")


def test_privilege_no_subquery_bypass(srv):
    """Subqueries and INSERT..SELECT sources are grant-checked too."""
    server, root = srv
    root.query("CREATE DATABASE IF NOT EXISTS vault")
    root.query("CREATE TABLE IF NOT EXISTS vault.s (x BIGINT)")
    a = _app(server)
    for sql in ("SELECT * FROM items WHERE EXISTS (SELECT 1 FROM vault.s)",
                "INSERT INTO items (name) SELECT 'x' FROM vault.s",
                "SHOW TABLES FROM vault"):
        with pytest.raises(MySQLError) as ei:
            a.query(sql)
        assert ei.value.code == 1045, sql
    a.close()


def test_auto_increment_skips_explicit_ids(srv):
    _, root = srv
    root.query("CREATE TABLE shop.ai (id BIGINT AUTO_INCREMENT, v VARCHAR, "
               "PRIMARY KEY (id))")
    root.query("INSERT INTO shop.ai (v) VALUES ('a')")          # id 1
    root.query("INSERT INTO shop.ai (id, v) VALUES (5, 'b')")   # explicit
    root.query("INSERT INTO shop.ai (v) VALUES ('c')")          # must be 6
    r = root.query("SELECT id FROM shop.ai ORDER BY id")
    assert [x for (x,) in r.rows] == ["1", "5", "6"]


def test_revoke_all_privileges_syntax(srv):
    _, root = srv
    root.query("CREATE USER IF NOT EXISTS tmpu")
    root.query("GRANT ALL ON shop.* TO tmpu")
    root.query("REVOKE ALL PRIVILEGES ON shop.* FROM tmpu")
    assert root.query("SHOW GRANTS FOR tmpu").rows == []


def test_prepared_stmt_escaped_quote(srv):
    server, _ = srv
    a = _app(server)
    sid = a.prepare("SELECT name FROM items WHERE name = 'O\\'x' OR id = ?")
    assert a.execute(sid, (1,)).rows == [("pen",)]
    a.close()


def test_non_super_cannot_grant(srv):
    server, _ = srv
    a = _app(server)
    with pytest.raises(MySQLError) as ei:
        a.query("GRANT ALL ON *.* TO 'app'")
    assert ei.value.code == 1227
    a.close()


def test_handle_operator_surface():
    """HANDLE's operator commands on a fleet (the same case as the JAX
    package's, on a port session): privileges, flags, region ops, the
    control-loop tick."""
    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.meta.service import MetaService
    from baikaldb_tpu_torch.raft.fleet import StoreFleet
    from baikaldb_tpu_torch.utils.flags import FLAGS

    meta = MetaService(peer_count=3)
    fleet = StoreFleet(meta, ["a:1", "b:1", "c:1", "d:1"], seed=23)
    s = Session(Database("cpu", fleet=fleet))
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    for i in range(10):
        s.execute(f"INSERT INTO t VALUES ({i}, 1.0)")
    tier = fleet.row_tiers["default.t"]
    rid = tier.metas[0].region_id

    s.execute("CREATE USER 'ops' IDENTIFIED BY 'pw'")
    s.execute("HANDLE add_privilege ops default read")
    assert ("default", "SELECT") in s.db.privileges.grants_of("ops")
    s.execute("HANDLE drop_privilege ops default")
    assert ("default", "SELECT") not in s.db.privileges.grants_of("ops")

    prev = int(FLAGS.region_split_rows)
    s.execute("HANDLE set_flag region_split_rows 123")
    assert int(FLAGS.region_split_rows) == 123
    FLAGS.set_flag("region_split_rows", prev)

    s.execute(f"HANDLE split_region {rid}")
    assert len(tier.groups) == 2
    rm = meta.regions[rid]
    target = next(a for a in rm.peers if a != rm.leader)
    assert s.execute(f"HANDLE trans_leader {rid} {target}").affected_rows == 1
    assert meta.regions[rid].leader == target
    assert "d:1" not in rm.peers
    assert s.execute(f"HANDLE add_peer {rid} d:1").affected_rows == 1
    assert "d:1" in meta.regions[rid].peers
    assert len(tier.groups[0].peers()) == 4
    victim = next(a for a in rm.peers if a != meta.regions[rid].leader)
    assert s.execute(f"HANDLE remove_peer {rid} {victim}").affected_rows == 1
    assert victim not in meta.regions[rid].peers
    for bad in ("HANDLE add_peer 99999 d:1", f"HANDLE add_peer {rid} nosuch:1",
                f"HANDLE remove_peer {rid} {meta.regions[rid].leader}"):
        with pytest.raises(Exception):
            s.execute(bad)
    s.execute("HANDLE balance_tick")
    s.execute("HANDLE drop_instance c:1")
    assert meta.instances["c:1"].status == "MIGRATE"
    s.execute("HANDLE compact")
    assert s.query("SELECT COUNT(*) n FROM t") == [{"n": 10}]


# -- the entry point ---------------------------------------------------------

def test_server_entry_point_needs_a_card_or_cpu():
    """``python -m baikaldb_tpu_torch.server`` runs on the card: without one
    (and without ``--device cpu``) it exits non-zero naming it; with
    ``--device cpu`` it listens and answers."""
    import torch

    env = dict(os.environ, PYTHONPATH=ROOT)
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "-m", "baikaldb_tpu_torch.server", "--port", "0"],
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert "CUDA" in r.stderr and "--device" not in r.stdout
    p = subprocess.Popen([sys.executable, "-m", "baikaldb_tpu_torch.server", "--port", "0",
                          "--device", "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True)
    try:
        line = p.stdout.readline()
        assert "listening on" in line and "device cpu" in line, line
        port = int(line.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
        c = Connection(port=port)
        c.query("CREATE TABLE e (x BIGINT)")
        c.query("INSERT INTO e VALUES (1), (2)")
        assert c.query("SELECT SUM(x) FROM e").rows == [("3",)]
        c.close()
    finally:
        p.terminate()
        p.wait(timeout=30)


# -- the cross-wire parity ---------------------------------------------------

SCRIPT = [
    "CREATE TABLE w (id BIGINT, g INT, v FLOAT, d DOUBLE, name VARCHAR(16), "
    "PRIMARY KEY (id))",
    "INSERT INTO w VALUES (1, 1, 0.5, 1.25, 'a'), (2, 1, 1.1, 2.5, 'b'), "
    "(3, 2, 2.2, NULL, NULL), (4, 2, 3.3, 4.75, 'd'), (5, 3, -0.7, 5.5, 'e'), "
    "(6, 3, 0.1, -6.25, 'f'), (7, 2, 7.7, 7.0, 'g')",
    "UPDATE w SET d = d + 1 WHERE g = 2",
    "DELETE FROM w WHERE id = 6",
    "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(d), MAX(name) FROM w GROUP BY g ORDER BY g",
    "SELECT g, SUM(d) s, AVG(d) a FROM w WHERE d > 0 GROUP BY g ORDER BY g",
    "SELECT id, name, v, d FROM w ORDER BY id",
    "SELECT * FROM w WHERE name IS NULL",
    "SELECT COUNT(*) FROM w WHERE v * 2 + 1 > 0.5",
    "SELECT nope FROM w",
    "SELECT * FROM missing",
    "SELEC 1",
    "INSERT INTO w VALUES (1, 9, 9.0, 9.0, 'dup')",
    "CREATE TABLE w (x BIGINT)",
    "SELECT nosuch(id) FROM w",
    "USE nodb_at_all",
    "SELECT (SELECT id FROM w) FROM w",
    "KILL 987654",
    "BEGIN",
    "INSERT INTO w VALUES (8, 4, 8.0, 8.0, 'h')",
    "ROLLBACK",
    "SELECT COUNT(*) FROM w",
    "SHOW TABLES",
    "SHOW COLUMNS FROM w",
    "SHOW CREATE TABLE w",
    "SHOW INDEX FROM w",
    "DESCRIBE w",
    ("prepare", "SELECT id, name FROM w WHERE g = ? ORDER BY id", [(1,), (2,), (None,)]),
    ("prepare", "SELECT g, COUNT(*), SUM(d) FROM w WHERE d > ? GROUP BY g ORDER BY g",
     [(0.0,), (2.5,), (100.0,)]),
    ("prepare", "INSERT INTO w VALUES (?, ?, ?, ?, ?)",
     [(9, 4, 1.5, 2.5, "i"), (10, 4, None, 3.5, "j'k"), (9, 4, 1.0, 1.0, "dup")]),
    "SELECT id, g, v, d, name FROM w WHERE id >= 9 ORDER BY id",
    "DROP TABLE w",
    "SHOW TABLES",
]


def _decode(pkts, prepared=False):
    """One response's packets -> ("ok", affected) | ("err", errno,
    sqlstate) | ("rs", column-definition packets, ncols, rows kept by the
    client)."""
    first = pkts[0]
    if first[0] == 0xFF:
        return ("err", int.from_bytes(first[1:3], "little"), first[4:9].decode())
    if first[0] == 0x00:
        return ("ok", first[1])                   # affected rows (< 251 here)
    ncols = first[0]
    return ("rs", [bytes(p) for p in pkts[1:1 + ncols]], ncols)


def _run_script(conn, db):
    """Run SCRIPT in database ``db`` on ``conn``, keeping every packet read."""
    seen = []
    read = conn.p.read

    def keep():
        pkt = read()
        if pkt is not None:
            seen.append(pkt)
        return pkt
    conn.p.read = keep
    conn.query(f"CREATE DATABASE {db}")
    conn.query(f"USE {db}")
    out = []

    def one(call):
        seen.clear()
        try:
            res = call()
            rows = [tuple(r) for r in res.rows]
        except Exception as e:     # noqa: BLE001 — the packets decide
            if not seen:
                raise
            rows = type(e).__name__
        got = _decode(list(seen))
        out.append(got + (rows,) if got[0] == "rs" else got)

    for step in SCRIPT:
        if isinstance(step, tuple):
            _, sql, params = step
            seen.clear()
            sid = conn.prepare(sql)
            out.append(("prepared", seen[0][7:9]))          # the param count
            for ps in params:
                one(lambda ps=ps: conn.execute(sid, ps))
        else:
            one(lambda step=step: conn.query(step))
    conn.p.read = read
    return out


def _same_value(a, b):
    if a == b:
        return True
    if a is None or b is None:
        return False
    try:
        x, y = float(a), float(b)
    except ValueError:
        return False
    return math.isclose(x, y, rel_tol=1e-4, abs_tol=1e-9)


def test_cross_wire_parity():
    """The JAX and the port's client against the JAX and the port's server:
    the same column definitions byte for byte, affected rows, errno /
    SQLSTATE, and row values under the parity contract."""
    runs = {}
    for client, cname in ((JConnection, "jax"), (Connection, "port")):
        for sname in ("jax", "port"):
            # a fresh server a pair: the database name is in SHOW TABLES'
            # column definition
            srv_ = (JServer(JDatabase(), port=0) if sname == "jax"
                    else MySQLServer(TDatabase("cpu"), port=0)).start()
            try:
                c = client("127.0.0.1", srv_.port)
                runs[(cname, sname)] = _run_script(c, "xw")
                c.close()
            finally:
                srv_.stop()
    want = runs[("jax", "jax")]
    assert [o[0] for o in want].count("err") >= 10        # the errors ran
    for key, got in runs.items():
        assert len(got) == len(want), key
        for i, (g, w) in enumerate(zip(got, want)):
            assert g[0] == w[0], (key, i, g, w)
            if g[0] != "rs":
                assert g == w, (key, i, g, w)
                continue
            assert g[1] == w[1] and g[2] == w[2], (key, i, "column definitions", g, w)
            assert len(g[3]) == len(w[3]), (key, i, g[3], w[3])
            for rg, rw in zip(g[3], w[3]):
                assert all(_same_value(a, b) for a, b in zip(rg, rw)), (key, i, rg, rw)
