"""The port's users and grants (meta/privileges.py and the session's
per-statement check) against the JAX package's.

Each case runs the same statements through embedded JAX sessions (CPU,
x64) and port sessions (``device="cpu"``): root sets up users, databases
and grants, then sessions opened as those users (``Session(db,
user=...)``) run the statements.  Rows, affected counts, error types and
the grant lists are compared exactly.  The cases are
tests/test_server_surface.py's privilege cases (the fence, no subquery
bypass, REVOKE ALL PRIVILEGES, a non-super GRANT, SHOW GRANTS) without the
wire, HANDLE add_privilege / drop_privilege from its operator surface, and
the password scheme the wire server will use.
"""

import hashlib

import pytest

from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.meta import privileges as jpriv
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.meta import privileges as tpriv

SETUP = [
    "CREATE USER 'app' IDENTIFIED BY 'secret'",
    "CREATE DATABASE shop",
    "GRANT ALL ON shop.* TO 'app'",
    "CREATE TABLE shop.items (id BIGINT, name VARCHAR, PRIMARY KEY (id))",
    "INSERT INTO shop.items VALUES (1, 'pen'), (2, 'ink')",
    "CREATE TABLE secret_table (x BIGINT)",
    "INSERT INTO secret_table VALUES (7)",
    "CREATE DATABASE vault",
    "CREATE TABLE vault.s (x BIGINT)",
    "INSERT INTO vault.s VALUES (1)",
]


class Pair:
    """A JAX and a port database, each with its root session."""

    def __init__(self):
        self.jdb, self.tdb = JDatabase(), TDatabase("cpu")
        self.root = (JSession(self.jdb), TSession(self.tdb))
        for q in SETUP:
            self.both(self.root, q)

    def sessions(self, user, database="default"):
        return (JSession(self.jdb, database, user=user),
                TSession(self.tdb, database, user=user))

    @staticmethod
    def both(pair, sql):
        outs = []
        for s in pair:
            try:
                r = s.execute(sql)
                outs.append(("rows", r.to_pylist()) if r.arrow is not None
                            else ("affected", r.affected_rows))
            except Exception as e:      # noqa: BLE001 — compared across packages
                outs.append(("error", type(e).__name__))
        assert outs[1] == outs[0], (sql, outs)
        return outs[1]


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_a_user_reads_its_granted_database_as_jax(pair):
    app = pair.sessions("app", "shop")
    assert pair.both(app, "SELECT id, name FROM items ORDER BY id") == \
        ("rows", [{"id": 1, "name": "pen"}, {"id": 2, "name": "ink"}])
    assert pair.both(app, "INSERT INTO items VALUES (3, 'cap')") == ("affected", 1)
    assert pair.both(app, "DELETE FROM items WHERE id = 3") == ("affected", 1)


@pytest.mark.parametrize("sql", [
    "SELECT * FROM default.secret_table",
    "SELECT COUNT(*) FROM default.secret_table WHERE x > 0",
    "SELECT * FROM items WHERE EXISTS (SELECT 1 FROM vault.s)",
    "SELECT id, (SELECT MAX(x) FROM vault.s) m FROM items",
    "SELECT i.id FROM items i JOIN vault.s v ON i.id = v.x",
    "WITH c AS (SELECT x FROM vault.s) SELECT * FROM c",
    "SELECT id FROM items UNION SELECT x FROM vault.s",
    "INSERT INTO items (id, name) SELECT x, 'x' FROM vault.s",
    "UPDATE items SET name = 'z' WHERE id IN (SELECT x FROM vault.s)",
    "DELETE FROM vault.s",
    "SHOW TABLES FROM vault",
    "DESCRIBE vault.s",
    "EXPLAIN SELECT * FROM vault.s",
    "USE vault",
    "CREATE TABLE vault.n (x BIGINT)",
    "DROP DATABASE vault",
    "CREATE DATABASE other",
    "TRUNCATE vault.s",
])
def test_the_fence_and_no_subquery_bypass_as_jax(pair, sql):
    """A grant on shop reads and writes shop only: subqueries, CTEs,
    unions, INSERT ... SELECT sources, DDL and SHOW elsewhere are denied
    before anything runs."""
    assert pair.both(pair.sessions("app", "shop"), sql) == ("error", "AccessError")
    # nothing changed under root
    assert pair.both(pair.root, "SELECT COUNT(*) AS n FROM vault.s") == ("rows", [{"n": 1}])


def test_information_schema_is_readable_without_a_grant_as_jax(pair):
    pair.both(pair.root, "CREATE USER IF NOT EXISTS reader")
    r = pair.both(pair.sessions("reader"),
                  "SELECT COUNT(*) AS n FROM information_schema.metrics WHERE name = 'zzz'")
    assert r == ("rows", [{"n": 0}])


def test_read_grant_reads_but_does_not_write_as_jax(pair):
    pair.both(pair.root, "CREATE USER IF NOT EXISTS ro")
    pair.both(pair.root, "GRANT SELECT ON shop.* TO ro")
    ro = pair.sessions("ro", "shop")
    assert pair.both(ro, "SELECT COUNT(*) AS n FROM items")[0] == "rows"
    assert pair.both(ro, "INSERT INTO items VALUES (9, 'no')") == ("error", "AccessError")
    assert pair.both(ro, "PREPARE q FROM 'DELETE FROM items WHERE id = ?'")[0] == "affected"
    # EXECUTE checks the bound statement
    assert pair.both(ro, "EXECUTE q USING 1") == ("error", "AccessError")
    assert pair.both(pair.root, "SHOW GRANTS FOR ro") == \
        ("rows", [{"Grants for ro": "GRANT SELECT ON shop.* TO 'ro'"}])


def test_revoke_all_privileges_syntax_as_jax(pair):
    pair.both(pair.root, "CREATE USER IF NOT EXISTS tmpu")
    pair.both(pair.root, "GRANT ALL ON shop.* TO tmpu")
    pair.both(pair.root, "REVOKE ALL PRIVILEGES ON shop.* FROM tmpu")
    assert pair.both(pair.root, "SHOW GRANTS FOR tmpu") == ("rows", [])


@pytest.mark.parametrize("sql", [
    "GRANT ALL ON *.* TO 'app'", "REVOKE ALL ON shop.* FROM app",
    "CREATE USER x2", "DROP USER app", "HANDLE add_privilege app vault read",
    "HANDLE flightrec clear",
])
def test_a_non_super_user_cannot_administer_as_jax(pair, sql):
    assert pair.both(pair.sessions("app", "shop"), sql) == ("error", "AccessError")


def test_show_grants_as_jax(pair):
    assert pair.both(pair.root, "SHOW GRANTS FOR 'app'") == \
        ("rows", [{"Grants for app": "GRANT ALL ON shop.* TO 'app'"}])
    assert pair.both(pair.root, "SHOW GRANTS") == \
        ("rows", [{"Grants for root": "GRANT ALL ON *.* TO 'root'"}])
    assert pair.both(pair.sessions("app", "shop"), "SHOW GRANTS") == \
        ("rows", [{"Grants for app": "GRANT ALL ON shop.* TO 'app'"}])
    assert pair.both(pair.root, "SHOW GRANTS FOR nobody") == ("rows", [])


@pytest.mark.parametrize("sql", [
    "CREATE USER 'app'", "CREATE USER IF NOT EXISTS 'app'", "DROP USER root",
    "DROP USER IF EXISTS ghost", "DROP USER ghost", "GRANT ALL ON shop.* TO ghost",
    "REVOKE ALL ON shop.* FROM ghost",
])
def test_user_statements_give_the_jax_outcome(pair, sql):
    pair.both(pair.root, sql)


def test_handle_add_and_drop_privilege_as_jax():
    p = Pair()
    p.both(p.root, "CREATE USER 'ops' IDENTIFIED BY 'pw'")
    ops = p.sessions("ops")
    assert p.both(ops, "SELECT COUNT(*) AS n FROM secret_table") == ("error", "AccessError")
    p.both(p.root, "HANDLE add_privilege ops default read")
    assert [db.privileges.grants_of("ops") for db in (p.jdb, p.tdb)] == \
        [[("default", "SELECT")]] * 2
    assert p.both(ops, "SELECT COUNT(*) AS n FROM secret_table") == ("rows", [{"n": 1}])
    assert p.both(ops, "INSERT INTO secret_table VALUES (8)") == ("error", "AccessError")
    p.both(p.root, "HANDLE add_privilege ops default write")
    assert p.both(ops, "INSERT INTO secret_table VALUES (8)") == ("affected", 1)
    p.both(p.root, "HANDLE drop_privilege ops default")
    assert [db.privileges.grants_of("ops") for db in (p.jdb, p.tdb)] == [[]] * 2
    assert p.both(ops, "SELECT COUNT(*) AS n FROM secret_table") == ("error", "AccessError")
    for sql in ("HANDLE add_privilege ops", "HANDLE drop_privilege ops",
                "HANDLE add_privilege ops default bogus", "HANDLE add_privilege ghost d read"):
        p.both(p.root, sql)


def test_password_scheme_matches_jax():
    salt = bytes(range(20))
    for pw in ("secret", "", "pässwörd"):
        stored = tpriv.mysql_native_hash(pw)
        assert stored == jpriv.mysql_native_hash(pw)
        sha_pw = hashlib.sha1(pw.encode()).digest()
        mask = hashlib.sha1(salt + stored).digest()
        resp = bytes(a ^ b for a, b in zip(sha_pw, mask))
        for mod in (jpriv, tpriv):
            assert mod.scramble_check(stored, salt, resp)
            assert not mod.scramble_check(stored, salt, resp[:-1] + b"\0")
            assert not mod.scramble_check(stored, salt, resp[:19])
    outs = []
    for mod in (jpriv, tpriv):
        pm = mod.PrivilegeManager()
        pm.create_user("u", "pw")
        stored = pm.users["u"].auth
        resp = bytes(a ^ b for a, b in zip(hashlib.sha1(b"pw").digest(),
                                           hashlib.sha1(salt + stored).digest()))
        outs.append((pm.authenticate("u", salt, resp), pm.authenticate("u", salt, b""),
                     pm.authenticate("root", salt, b""), pm.authenticate("ghost", salt, b"")))
    assert outs[1] == outs[0] == (True, False, True, False)
