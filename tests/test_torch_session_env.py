"""The port's session surface against the JAX package's: the connection
environment (@@sysvars, @user variables, DATABASE() / USER() / VERSION() /
CONNECTION_ID() and the SET forms connectors send at connect time), SHOW
COLLATION / CHARSET / ENGINES / TABLE STATUS, the ``information_schema``
tables, LOAD DATA INFILE and HANDLE's in-process commands.

Every statement runs in a JAX ``Session`` (CPU, x64) and in a port
``Session(device="cpu")`` over the same seeded data.  Rows, affected-row
counts and error types are compared exactly (keys, counts, strings, NULLs,
row order); floats within rtol 1e-9 (no float32 sum runs here); result sets
without ORDER BY as multisets.  The cases mirror tests/test_session_env.py
(all but its wire-protocol case, in tests/test_torch_server.py),
tests/test_sql_show.py and tests/test_upsert.py::test_select_into_outfile.
The forms whose planes the port lacks raise ``NotPortedError``; those of the
lifecycle plane (subscriptions, views, online DDL, TTL) are compared.
"""

import math

import numpy as np
import pyarrow as pa
import pytest

from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu_torch.errors import NotPortedError
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.utils.flags import FLAGS as TFLAGS


def _key(r):
    return tuple((k, repr(v)) for k, v in sorted(r.items()))


def _same(got, want, ordered=True):
    assert len(got) == len(want), (got, want)
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    for a, b in zip(got, want):
        assert list(a) == list(b), (a, b)
        for k in b:
            if isinstance(b[k], float) and a[k] is not None:
                assert math.isclose(a[k], b[k], rel_tol=1e-9, abs_tol=1e-12), (k, a, b)
            else:
                assert a[k] == b[k], (k, a, b)


class Pair:
    """A JAX and a port session, each over its own database; ``run``
    executes a statement in both and holds the outcomes equal."""

    def __init__(self, database="default"):
        self.j = JSession(JDatabase(), database)
        self.t = TSession(TDatabase("cpu"), database)

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
            _same(tv, jv, ordered)
        else:
            assert tv == jv, (sql, outs)
        return tv

    def script(self, stmts):
        return [self.run(q) for q in stmts]


# -- the connection environment (tests/test_session_env.py) ---------------

@pytest.mark.parametrize("sql", [
    "SELECT @@version",
    "SELECT @@session.autocommit",
    "SELECT @@global.max_allowed_packet",
    "SELECT @@version AS v",
    "SELECT @@version_comment IS NOT NULL AS c",
    "SELECT @@sql_mode, @@time_zone, @@character_set_client",
    "SELECT @@no_such_thing",
    "SELECT @never_set",
    "SELECT DATABASE()",
    "SELECT SCHEMA()",
    "SELECT USER()",
    "SELECT CURRENT_USER()",
    "SELECT SESSION_USER(), SYSTEM_USER()",
    "SELECT VERSION()",
    "SELECT LENGTH(VERSION()) AS n",
])
def test_sysvar_and_env_functions_match_jax(sql):
    Pair().run(sql)


def test_sysvar_reflects_set_and_skips_the_plan_cache():
    """The same text twice with a SET between: the substitution bypasses
    the plan cache, as in the JAX session."""
    p = Pair()
    for level, want in (("READ COMMITTED", "READ-COMMITTED"),
                        ("REPEATABLE READ", "REPEATABLE-READ")):
        p.run(f"SET SESSION TRANSACTION ISOLATION LEVEL {level}")
        assert p.run("SELECT @@tx_isolation") == [{"@@tx_isolation": want}]
    assert p.t._plan_cache == {} or all(
        "@@" not in str(k) for k in p.t._plan_cache)


def test_user_vars_match_jax():
    p = Pair()
    p.run("SET @x = 5")
    assert p.run("SELECT @x") == [{"@x": 5}]
    p.run("SET @s = 'abc'")
    p.run("SELECT @s, @x + 1 AS y, @never_set")


def test_env_functions_follow_use_and_the_connection():
    p = Pair()
    p.script(["CREATE DATABASE envdb", "USE envdb"])
    assert p.run("SELECT DATABASE()") == [{"DATABASE()": "envdb"}]
    for s in (p.j, p.t):
        cid = s.query("SELECT CONNECTION_ID()")[0]["CONNECTION_ID()"]
        assert cid == s.connection_id()
        assert s.query("SELECT CONNECTION_ID()") == [{"CONNECTION_ID()": cid}]


def test_env_exprs_in_where_and_dml_match_jax():
    p = Pair()
    p.script(["CREATE TABLE u (id BIGINT PRIMARY KEY, owner VARCHAR(32), db VARCHAR(16))",
              "INSERT INTO u VALUES (1, 'root@localhost', 'default'), (2, 'other', 'x')"])
    p.run("SELECT id FROM u WHERE owner = USER()")
    p.run("SELECT id FROM u WHERE db = DATABASE() AND owner = CURRENT_USER()")
    p.run("UPDATE u SET owner = USER() WHERE id = 2")
    p.run("SELECT id, owner FROM u ORDER BY id")
    p.run("SET @k = 1")
    p.run("DELETE FROM u WHERE id = @k")
    p.run("INSERT INTO u SELECT 3, USER(), DATABASE()")
    p.run("SELECT id, owner, db FROM u ORDER BY id")


def test_connect_burst_set_forms_match_jax():
    p = Pair()
    p.script(["SET NAMES utf8mb4",
              "SET NAMES utf8mb4 COLLATE utf8mb4_general_ci",
              "SET character_set_results = NULL",
              "SET SESSION TRANSACTION ISOLATION LEVEL SERIALIZABLE",
              "SELECT @@transaction_isolation",
              "SET TRANSACTION READ ONLY",
              "SET autocommit=0",
              "SELECT @@autocommit",
              "SELECT @@character_set_results"])


# SHOW STATUS names by design in one package only: the JAX package's XLA,
# AOT-cache and transaction-counter instruments have no counterpart in the
# port; the port's kernel launch counters, its count of host reads and of
# the traces its store drops none in the JAX package (the wire's
# connections_total is in both since the port's MySQL server, the guards'
# three trip counters since the port's analysis plane)
STATUS_JAX_ONLY = {
    "aot_cache_deser_ms", "aot_cache_evictions", "aot_cache_fallbacks", "aot_cache_hits",
    "aot_cache_misses", "aot_cache_peer_fetches", "aot_cache_publishes",
    "compile_ms", "shuffle_overflow_retries",
    "txn_commits", "txn_rollbacks", "wal_appends", "xla_retraces",
}
STATUS_PORT_ONLY = {f"kernel_launches.{k}{lanes}" for lanes in ("", "_lanes") for k in (
    "filtered_group_sum", "fused_group_aggregate", "partition_histogram", "segment_reduce")} \
    | {"host_reads", "traces_dropped"}
# made on first touch by whatever ran before in the process
_LAZY = ("swallowed.", "failpoint.", "test_")
# counters both packages move over the same statements
STATUS_MOVED = ("queries_total.value", "queries_failed.value", "dml_rows.value",
                "plan_cache_misses.value", "query_latency.count", "flightrec_records.value",
                "queries_killed.value", "Threads_connected", "health.status")


def _status(s) -> dict:
    return {r["Variable_name"]: r["Value"] for r in s.query("SHOW GLOBAL STATUS")}


def _metric_names(status: dict) -> set:
    return {k if k.startswith("health.") or "." not in k else k.rsplit(".", 1)[0]
            for k in status if not k.startswith(_LAZY)}


def test_show_scope_prefix_matches_jax():
    """SHOW SESSION VARIABLES and a SET seen by SHOW VARIABLES; SHOW GLOBAL
    STATUS gives the JAX session's names but for the two lists above, and
    the counters both packages move move alike."""
    p = Pair()
    p.run("SHOW SESSION VARIABLES LIKE 'version'")
    p.run("SET sql_mode = ''")
    p.run("SHOW VARIABLES LIKE 'sql_mode'")
    before = [_status(s) for s in (p.j, p.t)]
    p.script(["CREATE TABLE st (id BIGINT, v DOUBLE)", "INSERT INTO st VALUES (1, 0.5), (2, 1.5)",
              "SELECT SUM(v) AS s FROM st", "UPDATE st SET v = 2.0 WHERE id = 1"])
    p.run("SELECT nope FROM st")
    after = [_status(s) for s in (p.j, p.t)]
    jn, tn = _metric_names(after[0]), _metric_names(after[1])
    assert jn - tn == STATUS_JAX_ONLY and tn - jn == STATUS_PORT_ONLY

    def moved(b, a):
        return {k: (float(a[k]) - float(b[k]) if k != "health.status" else a[k])
                for k in STATUS_MOVED}
    assert moved(before[1], after[1]) == moved(before[0], after[0])
    p.run("SHOW GLOBAL STATUS LIKE 'health.%'")
    p.run("SHOW SESSION STATUS LIKE 'Threads_connected'")


# -- SHOW COLLATION / CHARSET / ENGINES / TABLE STATUS --------------------

def _show_pair():
    p = Pair()
    p.script(["CREATE DATABASE d", "USE d",
              "CREATE TABLE t (id BIGINT PRIMARY KEY, v DOUBLE)",
              "INSERT INTO t VALUES (1, 1.5), (2, 2.5)",
              "CREATE VIEW vw AS SELECT id FROM t",
              "CREATE TABLE pt (id BIGINT PRIMARY KEY, k BIGINT) PARTITION BY HASH (k) "
              "PARTITIONS 3"])
    return p


@pytest.mark.parametrize("sql", [
    "SHOW COLLATION", "SHOW COLLATION LIKE 'utf8mb4%'", "SHOW COLLATION LIKE 'UTF8MB4%'",
    "SHOW COLLATION LIKE ''", "SHOW CHARSET", "SHOW CHARACTER SET",
    "SHOW CHARSET LIKE 'bin%'", "SHOW TABLE STATUS", "SHOW TABLE STATUS LIKE 't%'",
    "SHOW TABLE STATUS LIKE '_'", "SHOW TABLE STATUS LIKE 'v_'", "SHOW TABLE STATUS IN d",
    "SHOW TABLE STATUS LIKE 't[1]'", "SHOW ENGINES LIKE 'x'", "SHOW TABLES",
    "SHOW FULL TABLES",
])
def test_show_forms_match_jax(sql):
    _show_pair().run(sql)


def test_show_engines_names_the_ports_engine():
    """Every cell but the Comment, which names each package's own engine."""
    p = _show_pair()
    j, t = p.j.query("SHOW ENGINES"), p.t.query("SHOW ENGINES")
    assert [list(r) for r in t] == [list(r) for r in j] and len(t) == 1
    drop = lambda rows: [{k: v for k, v in r.items() if k != "Comment"} for r in rows]  # noqa: E731
    assert drop(t) == drop(j)
    assert "PyTorch" in t[0]["Comment"] and "JAX" not in t[0]["Comment"]


# -- information_schema ----------------------------------------------------

def _info_pair():
    rng = np.random.RandomState(7)
    p = Pair()
    p.script(["CREATE TABLE a (id BIGINT PRIMARY KEY, g INT, v DOUBLE, s VARCHAR(8))",
              "CREATE TABLE r (id BIGINT PRIMARY KEY, v BIGINT) PARTITION BY RANGE (v) "
              "(PARTITION p0 VALUES LESS THAN (10), PARTITION p1 VALUES LESS THAN (20), "
              "PARTITION pm VALUES LESS THAN MAXVALUE)",
              "CREATE VIEW av AS SELECT id, g FROM a WHERE g > 1"])
    vals = ", ".join(f"({i}, {int(rng.randint(0, 5))}, {float(rng.randn()):.6f}, "
                     f"'{'xyz'[i % 3]}')" for i in range(40))
    p.run(f"INSERT INTO a VALUES {vals}")
    p.run("INSERT INTO r VALUES " + ", ".join(f"({i}, {int(v)})" for i, v in
                                             enumerate(rng.randint(0, 30, 25))))
    return p


@pytest.mark.parametrize("table,cols", [
    ("tables", "*"), ("columns", "*"), ("views", "*"), ("partitions", "*"),
    ("column_stats", "*"), ("snapshots", "snapshot_ts, query, holder"),
])
def test_information_schema_tables_match_jax(table, cols):
    p = _info_pair()
    p.run(f"SELECT {cols} FROM information_schema.{table}", ordered=False)
    p.run(f"SELECT COUNT(*) AS n FROM information_schema.{table}")


def test_information_schema_snapshots_list_the_pins():
    p = _info_pair()
    p.run("SET SNAPSHOT = 'now'")
    jrows = p.j.query("SELECT query, holder FROM information_schema.snapshots")
    trows = p.t.query("SELECT query, holder FROM information_schema.snapshots")
    assert trows == jrows and len(trows) == 1


def test_information_schema_where_and_group_by_match_jax():
    p = _info_pair()
    p.run("SELECT table_name, COUNT(*) AS n FROM information_schema.columns "
          "WHERE table_schema = 'default' GROUP BY table_name ORDER BY table_name")
    p.run("SELECT partition_name, table_rows FROM information_schema.partitions "
          "WHERE table_name = 'r' ORDER BY partition_name")


def test_information_schema_flags_and_failpoints_match_jax_on_shared_names():
    """The port registers a subset of the JAX package's flags and
    failpoints.  Each table renders its own registry whole; on the names
    both catalog the rows are equal, the help texts aside (they describe
    each package) and the flags whose defaults the port measured on the
    card apart (their default and value are the port's)."""
    from baikaldb_tpu.utils.flags import FLAGS as JFLAGS

    p = _info_pair()
    t_flags = p.t.query("SELECT * FROM information_schema.flags")
    assert [(r["name"], r["value"], r["default_value"]) for r in t_flags] == \
        [(n, str(v), str(d)) for n, v, d, _ in TFLAGS.describe()]
    jdef = {n: d for n, _, d, _ in JFLAGS.describe()}
    for table, cols in (("flags", ("value", "default_value")),
                        ("failpoints", ("spec", "hits", "trips"))):
        j = {r["name"]: r for r in p.j.query(f"SELECT * FROM information_schema.{table}")}
        t = {r["name"]: r for r in p.t.query(f"SELECT * FROM information_schema.{table}")}
        shared = set(j) & set(t)
        assert shared and set(t) <= set(j), table
        for n in shared:
            assert list(t[n]) == list(j[n])
            if table == "flags" and str(jdef[n]) != t[n]["default_value"]:
                continue
            assert all(t[n][c] == j[n][c] for c in cols), (n, t[n], j[n])


def test_information_schema_trace_spans_of_a_traced_query():
    """Span ids are random in both packages: the schema is compared, and
    every kept span of the port's traced query names its parent."""
    p = _info_pair()
    p.run("SET GLOBAL tracing = 1")
    try:
        p.run("SELECT g, COUNT(*) AS n FROM a GROUP BY g ORDER BY g")
        cols = "query_id, trace_id, span_id, parent_id, name, node, start_us, duration_ms, attrs"
        j = p.j.execute(f"SELECT {cols} FROM information_schema.trace_spans")
        t = p.t.execute(f"SELECT {cols} FROM information_schema.trace_spans")
        assert t.arrow.schema.names == j.arrow.schema.names
        rows = t.to_pylist()
        assert rows and {r["name"] for r in rows} >= {"query", "parse", "exec.run"}
        ids = {r["span_id"] for r in rows}
        assert all(r["parent_id"] in ids or not r["parent_id"] for r in rows)
    finally:
        p.run("SET GLOBAL tracing = 0")


# the lifecycle plane's tables: a subscription, a view and a finished
# online ADD INDEX give them rows in both packages
# the observability plane's tables: the columns that do not read the clock,
# the process-wide counters' values, or each package's connection ids
OBSERVABILITY_TABLES = {
    "processlist": "SELECT user, host, db, command, state, info, phase, operator, "
                   "batches_done, batches_total, rounds_total, chunk_no, chunks_total "
                   "FROM information_schema.processlist",
    "flight_recorder": "SELECT rec_id, query_id > 0 AS q, user, db, query, status, rows "
                       "FROM information_schema.flight_recorder ORDER BY rec_id",
    "metrics": "SELECT name, field FROM information_schema.metrics WHERE name IN "
               "('queries_total', 'query_latency', 'flightrec_records', 'queries_killed', "
               "'process_rss_bytes') ORDER BY name, field",
    "cluster_metrics": "SELECT daemon, metric, labels, field, stale, age_ms FROM "
                       "information_schema.cluster_metrics WHERE metric IN "
                       "('queries_total', 'query_latency', 'slow_queries') "
                       "ORDER BY daemon, metric, field",
}

LIFECYCLE_TABLES = {
    "subscriptions": "name, table_key, internal, events_delivered",
    "materialized_views": ("table_schema, view_name, base_table, definition, deltas_folded, "
                           "rescans, answered_queries, groups"),
    "ddl_work": "*",
}


@pytest.mark.parametrize("table", [
    "subscriptions", "materialized_views", "ddl_work", "processlist", "flight_recorder",
    "metrics", "regions", "fragments", "cold_segments", "cluster_metrics",
    "executables", "aot_cache",
])
def test_information_schema_tables_of_unported_planes_raise(table):
    """The tables of planes the port lacks (the XLA executable cache) raise
    ``NotPortedError``; those of the lifecycle plane, of the observability
    plane, of the replicated tier and of the network plane (ported) equal
    the JAX session's."""
    if table == "fragments":
        # the dispatch ring is process-wide in each package: no row names a
        # table this session does not have (with a cluster:
        # tests/test_torch_fragments.py)
        _info_pair().run("SELECT * FROM information_schema.fragments "
                         "WHERE table_name = 'default.none'")
        return
    if table == "cold_segments":
        # no replicated tier, no manifest: empty in both (with a fleet:
        # tests/test_torch_cold_tier.py)
        _info_pair().run("SELECT * FROM information_schema.cold_segments")
        return
    if table == "regions":
        # without a fleet both packages render it empty; the fleet's rows
        # are held to the JAX package in tests/test_torch_replicated_sql.py
        _info_pair().run("SELECT * FROM information_schema.regions")
        return
    if table in OBSERVABILITY_TABLES:
        p = _info_pair()
        p.run("SELECT COUNT(*) FROM a WHERE g > 1")
        p.run("SELECT missing FROM a")
        p.run(OBSERVABILITY_TABLES[table])
        return
    if table not in LIFECYCLE_TABLES:
        s = TSession(device="cpu")
        with pytest.raises(NotPortedError):
            s.query(f"SELECT * FROM information_schema.{table}")
        return
    p = _info_pair()
    p.run(f"SELECT * FROM information_schema.{table}")          # empty in both
    p.script(["CREATE SUBSCRIPTION feed ON a",
              "CREATE MATERIALIZED VIEW mv AS SELECT g, COUNT(*), SUM(id) FROM a GROUP BY g",
              "INSERT INTO a VALUES (100, 1, 0.5, 'x')",
              "SELECT g, COUNT(*), SUM(id) FROM a GROUP BY g ORDER BY g"])
    wid = p.run("ALTER TABLE a ADD INDEX ig (g)")[0]["work_id"]
    for s in (p.j, p.t):
        assert s.db.ddl.wait(wid, 30.0).state == "public"
    p.run(f"SELECT {LIFECYCLE_TABLES[table]} FROM information_schema.{table}", ordered=False)
    p.run(f"SELECT COUNT(*) AS n FROM information_schema.{table}")


# -- LOAD DATA INFILE (tests/test_upsert.py::test_select_into_outfile) -----

def test_outfile_round_trips_through_load_data(tmp_path):
    p = Pair()
    p.script(["CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, name VARCHAR(16))",
              "INSERT INTO t VALUES (1, 10, 'a'), (2, 20, 'b'), (3, NULL, 'n')",
              "CREATE TABLE t2 (id BIGINT, v BIGINT, name VARCHAR(16), PRIMARY KEY (id))"])
    paths = [tmp_path / "jax.csv", tmp_path / "port.csv"]
    for s, path in zip((p.j, p.t), paths):
        r = s.execute(f"SELECT id, v, name FROM t ORDER BY id INTO OUTFILE '{path}'")
        assert r.affected_rows == 3
    assert paths[0].read_text() == paths[1].read_text()
    counts = [s.execute(f"LOAD DATA INFILE '{path}' INTO TABLE t2").affected_rows
              for s, path in zip((p.j, p.t), paths)]
    assert counts == [3, 3]
    p.run("SELECT id, v, name FROM t2 ORDER BY id")
    p.run("SELECT v FROM t2 WHERE id = 3")
    # the primary key is checked: a second load conflicts in both
    outs = []
    for s, path in zip((p.j, p.t), paths):
        with pytest.raises(Exception) as e:
            s.execute(f"LOAD DATA INFILE '{path}' INTO TABLE t2")
        outs.append(type(e.value).__name__)
    assert outs[0] == outs[1]
    p.run("SELECT COUNT(*) AS n FROM t2")


def test_load_data_of_seeded_rows_with_options(tmp_path):
    rng = np.random.RandomState(3)
    n = 2000
    ids = np.arange(n)
    v = rng.randn(n)
    g = rng.randint(0, 50, n)
    path = tmp_path / "rows.tsv"
    with open(path, "w") as f:
        f.write("id\tg\tv\n")
        for i in range(n):
            f.write(f"{ids[i]}\t{'\\N' if i % 97 == 0 else g[i]}\t{v[i]!r}\n")
    p = Pair()
    p.run("CREATE TABLE l (id BIGINT PRIMARY KEY, g INT, v DOUBLE)")
    p.run(f"LOAD DATA INFILE '{path}' INTO TABLE l FIELDS TERMINATED BY '\\t' "
          "IGNORE 1 LINES")
    p.run("SELECT g, COUNT(*) AS n, SUM(v) AS s FROM l GROUP BY g ORDER BY g")
    p.run("SELECT COUNT(*) AS n FROM l WHERE g IS NULL")


# -- HANDLE -----------------------------------------------------------------

def test_handle_checkpoint_gc_and_set_flag_match_jax(tmp_path):
    p = Pair.__new__(Pair)
    p.j = JSession(JDatabase(data_dir=str(tmp_path / "j")))
    p.t = TSession(TDatabase("cpu", data_dir=str(tmp_path / "t")))
    p.script(["CREATE TABLE h (id BIGINT PRIMARY KEY, v BIGINT)",
              "INSERT INTO h VALUES (1, 1), (2, 2)",
              "UPDATE h SET v = 5 WHERE id = 1",
              "HANDLE checkpoint", "HANDLE gc",
              "HANDLE set_flag plan_cache_size 7",
              "SELECT id, v FROM h ORDER BY id"])
    assert int(TFLAGS.plan_cache_size) == 7
    p.run("HANDLE set_flag plan_cache_size 256")
    # the checkpoint is on disk: a new database over the directory reads it
    t2 = TSession(TDatabase("cpu", data_dir=str(tmp_path / "t")))
    assert t2.query("SELECT id, v FROM h ORDER BY id") == [{"id": 1, "v": 5}, {"id": 2, "v": 2}]


def test_handle_split_matches_jax():
    p = Pair()
    p.run("CREATE TABLE sp (id BIGINT PRIMARY KEY, v BIGINT)")
    p.run("INSERT INTO sp VALUES " + ", ".join(f"({i}, {i % 7})" for i in range(100)))
    p.run("HANDLE split default.sp 16")
    regions = [len([r for r in s.db.stores["default.sp"].regions if r.num_rows])
               for s in (p.j, p.t)]
    assert regions == [7, 7]
    p.run("SELECT v, COUNT(*) AS n FROM sp GROUP BY v ORDER BY v")
    p.run("HANDLE split default.nope 16")
    p.run("HANDLE no_such_command")


@pytest.mark.parametrize("cmd", [
    "flightrec clear", "ttl", "ddl suspend", "add_privilege u d read", "compact",
    "store_heartbeat", "cold_status default.t", "split_region 1",
])
def test_handle_commands_of_unported_planes_raise(cmd):
    """TTL, online DDL, the flight recorder, the privileges, the replicated
    tier's and the cold tier's commands (all ported) give the JAX session's
    outcome."""
    if cmd in ("compact", "store_heartbeat", "split_region 1", "cold_status default.t"):
        # no fleet: compact does nothing, the others need one, in both
        # packages (with a fleet: tests/test_torch_replicated_sql.py)
        Pair().run(f"HANDLE {cmd}")
        return
    if cmd in ("flightrec clear", "add_privilege u d read"):
        p = Pair()
        p.script(["CREATE TABLE h (id BIGINT)", "INSERT INTO h VALUES (1)",
                  "SELECT COUNT(*) AS n FROM h", f"HANDLE {cmd}", "CREATE USER u",
                  f"HANDLE {cmd}", "SHOW GRANTS FOR u",
                  "SELECT query, status FROM information_schema.flight_recorder "
                  "ORDER BY rec_id"])
        return
    if cmd not in ("ttl", "ddl suspend"):
        s = TSession(device="cpu")
        with pytest.raises(NotPortedError):
            s.execute(f"HANDLE {cmd}")
        return
    p = Pair()
    p.script(["CREATE TABLE e (id BIGINT PRIMARY KEY, create_time DATETIME) TTL=60",
              "INSERT INTO e VALUES (1, '2001-01-01 00:00:00'), (2, '2999-01-01 00:00:00')",
              f"HANDLE {cmd}", "SELECT id FROM e ORDER BY id"])
    if cmd == "ddl suspend":
        wid = p.run("ALTER TABLE e ADD INDEX ic (create_time)")[0]["work_id"]
        p.run("SELECT state, regions_done FROM information_schema.ddl_work")
        p.run("HANDLE ddl resume")
        for s in (p.j, p.t):
            assert s.db.ddl.wait(wid, 30.0).state == "public"
        p.run("SELECT state FROM information_schema.ddl_work")
