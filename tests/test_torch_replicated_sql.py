"""The port's counterpart of tests/test_replicated_sql.py: the JAX oracle's cases run
against baikaldb_tpu_torch on the CPU, and the cases at the end run the same
seeded work on both packages and compare.  The oracle's text follows.

SQL on the raft-replicated store tier (VERDICT r02 missing #1).

Reference behavior being matched: every DML is a raft apply on a Region
(/root/reference/src/store/region.cpp:2301 dml_1pc, :1961 dml_2pc), COMMIT is
primary-first 2PC from the frontend (fetcher_store.cpp:1848-1904), and a
store restart recovers committed state from the replicated log
(include/store/region.h:644).  These tests drive all of it through SQL:

- differential: the same workload on a 3-store fleet-bound Session and on a
  plain single-node Session produces identical query results,
- a leader SIGKILL mid-workload loses nothing committed (writes keep
  succeeding after re-election; a fresh Database rebuilt from the replicas
  sees every committed row),
- a SQL transaction spanning regions commits atomically through 2PC, and a
  rolled-back transaction leaves no trace in the replicas.
"""

import pytest

from baikaldb_tpu_torch.exec.session import Database, Session
from baikaldb_tpu_torch.meta.service import MetaService
from baikaldb_tpu_torch.raft.fleet import StoreFleet
from baikaldb_tpu_torch.storage.replicated import ReplicationError


STORES = ["store1:8110", "store2:8110", "store3:8110"]


def make_fleet():
    meta = MetaService(peer_count=3)
    return StoreFleet(meta, STORES, seed=11)


def fleet_session():
    fleet = make_fleet()
    db = Database("cpu", fleet=fleet)
    return Session(db), fleet


WORKLOAD = [
    "CREATE TABLE t (id BIGINT, name VARCHAR(32), score DOUBLE, "
    "PRIMARY KEY (id))",
    "INSERT INTO t VALUES (1, 'ada', 9.5), (2, 'bob', 7.25), (3, 'cyd', 8.0)",
    "UPDATE t SET score = score + 1 WHERE id <= 2",
    "DELETE FROM t WHERE name = 'cyd'",
    "INSERT INTO t VALUES (4, 'dee', 5.0)",
    "BEGIN",
    "INSERT INTO t VALUES (5, 'eve', 6.5)",
    "UPDATE t SET score = 0 WHERE id = 4",
    "COMMIT",
    "BEGIN",
    "INSERT INTO t VALUES (6, 'fox', 1.0)",
    "ROLLBACK",
]

CHECKS = [
    "SELECT id, name, score FROM t ORDER BY id",
    "SELECT COUNT(*) n, SUM(score) s FROM t",
    "SELECT name FROM t WHERE score > 6 ORDER BY name",
]


def test_differential_vs_single_node():
    rep, _ = fleet_session()
    plain = Session(Database("cpu"))
    for sql in WORKLOAD:
        rep.execute(sql)
        plain.execute(sql)
    for q in CHECKS:
        assert rep.query(q) == plain.query(q), q


def test_dml_lands_in_raft_replicas():
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    s.execute("INSERT INTO t VALUES (1, 1.0), (2, 2.0)")
    tier = fleet.row_tiers["default.t"]
    # every region group's LEADER has the rows raft-committed; so do
    # followers (same log)
    rows = tier.scan_rows()
    live = [r for r in rows if not r.get("__del")]
    assert len(live) == 2
    for g in tier.groups:
        ldr = g.bus.nodes[g.leader()]
        for nid, node in g.bus.nodes.items():
            assert node.core.commit_index == ldr.core.commit_index, \
                f"replica {nid} lags in region {g.region_id}"


def test_leader_kill_mid_workload_loses_nothing_committed():
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    for i in range(10):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")

    # find the store currently leading the most regions and SIGKILL it
    tier = fleet.row_tiers["default.t"]
    leaders = [g.leader() for g in tier.groups]
    victim_nid = max(set(leaders), key=leaders.count)
    victim_addr = fleet._addr[victim_nid]
    fleet.kill_store(victim_addr)

    # writes continue: groups re-elect among the surviving 2/3 quorum
    for i in range(10, 20):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    assert s.query("SELECT COUNT(*) n FROM t") == [{"n": 20}]

    # a FRESH frontend rebuilt from the replicas sees every committed row:
    # nothing the killed leader acked is lost
    db2 = Database("cpu", fleet=fleet)
    s2 = Session(db2)
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    got = s2.query("SELECT COUNT(*) n, SUM(v) s FROM t")
    assert got == [{"n": 20, "s": float(sum(range(20)))}]


def test_txn_commit_spans_regions_via_2pc():
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    # grow the table past the split threshold so it range-splits into
    # multiple regions, then run one transaction touching both sides
    tier = fleet.row_tiers["default.t"]
    tier.split_rows = 8
    for i in range(8):
        s.execute(f"INSERT INTO t VALUES ({i}, 1.0)")
    assert len(tier.groups) >= 2
    s.execute("BEGIN")
    for i in range(8, 16):
        s.execute(f"INSERT INTO t VALUES ({i}, 1.0)")
    s.execute("UPDATE t SET v = 2.0")      # touches every region
    s.execute("COMMIT")
    per_region = [len(node.rows_in_range())
                  for g in tier.groups
                  for node in [g.bus.nodes[g.leader()]]]
    assert sum(per_region) == 16
    assert all(n > 0 for n in per_region), \
        f"txn should span regions, got {per_region}"
    assert s.query("SELECT COUNT(*) n, SUM(v) s FROM t") == \
        [{"n": 16, "s": 32.0}]
    # no prepared (in-doubt) txns remain anywhere after a clean commit
    for g in tier.groups:
        for node in g.bus.nodes.values():
            assert not node.prepared


def test_rollback_leaves_no_trace_in_replicas():
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    s.execute("BEGIN")
    for i in range(8):
        s.execute(f"INSERT INTO t VALUES ({i}, 1.0)")
    s.execute("ROLLBACK")
    tier = fleet.row_tiers["default.t"]
    assert tier.num_rows() == 0
    assert s.query("SELECT COUNT(*) n FROM t") == [{"n": 0}]


def test_no_quorum_fails_statement_and_keeps_cache_consistent():
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    s.execute("INSERT INTO t VALUES (1, 1.0)")
    # kill two of three stores: no region group can reach quorum
    fleet.kill_store(STORES[0])
    fleet.kill_store(STORES[1])
    with pytest.raises(ReplicationError):
        s.execute("INSERT INTO t VALUES (2, 2.0)")
    # the columnar cache did NOT apply the failed write
    assert s.query("SELECT COUNT(*) n FROM t") == [{"n": 1}]
    with pytest.raises(ReplicationError):
        s.execute("DELETE FROM t WHERE id = 1")
    assert s.query("SELECT COUNT(*) n FROM t") == [{"n": 1}]


def test_truncate_replicates():
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    for i in range(6):
        s.execute(f"INSERT INTO t VALUES ({i}, 1.0)")
    s.execute("TRUNCATE TABLE t")
    # a rebuild from the replicas must not resurrect truncated rows
    db2 = Database("cpu", fleet=fleet)
    s2 = Session(db2)
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    assert s2.query("SELECT COUNT(*) n FROM t") == [{"n": 0}]


def test_alter_table_rebuilds_replicated_encoding():
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    s.execute("INSERT INTO t VALUES (1, 1.5), (2, 2.5)")
    s.execute("ALTER TABLE t ADD COLUMN note VARCHAR(16)")
    s.execute("INSERT INTO t VALUES (3, 3.5, 'new')")
    # recovery decodes every replicated row with the NEW codec.  (The
    # catalog is recovered separately — here by recreating the post-ALTER
    # schema; the fleet replicates DATA.  Folding the catalog into the
    # raft-replicated meta service removes this step.)
    db2 = Database("cpu", fleet=fleet)
    s2 = Session(db2)
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, note VARCHAR(16), "
               "PRIMARY KEY (id))")
    assert s2.query("SELECT id, v, note FROM t ORDER BY id") == [
        {"id": 1, "v": 1.5, "note": None},
        {"id": 2, "v": 2.5, "note": None},
        {"id": 3, "v": 3.5, "note": "new"},
    ]


def test_commit_no_quorum_restores_columnar_preimage():
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    s.execute("INSERT INTO t VALUES (1, 1.0)")
    s.execute("BEGIN")
    s.execute("INSERT INTO t VALUES (2, 2.0)")
    s.execute("UPDATE t SET v = 9.0 WHERE id = 1")
    fleet.kill_store(STORES[0])
    fleet.kill_store(STORES[1])
    with pytest.raises(ReplicationError):
        s.execute("COMMIT")
    # the columnar cache rolled back to the pre-transaction image
    assert s.query("SELECT id, v FROM t ORDER BY id") == [{"id": 1, "v": 1.0}]


def test_drop_table_releases_raft_groups():
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    s.execute("INSERT INTO t VALUES (1, 1.0)")
    n_groups = len(fleet.groups)
    n_regions = len(fleet.meta.regions)
    assert n_groups > 0
    s.execute("DROP TABLE t")
    assert "default.t" not in fleet.row_tiers
    assert len(fleet.groups) < n_groups
    assert len(fleet.meta.regions) < n_regions


def test_region_splits_under_consensus_during_workload():
    """VERDICT r02 missing #6: an oversized replicated region splits while a
    workload writes; row counts reconcile across all replicas (the
    reference's split lifecycle, region.cpp:4472/:7198/:4864)."""
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    tier = fleet.row_tiers["default.t"]
    tier.split_rows = 10
    for i in range(35):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
        # reads interleaved with the split lifecycle: never a lost or
        # double-counted row
        assert s.query("SELECT COUNT(*) n FROM t") == [{"n": i + 1}]
    assert len(tier.groups) >= 3
    # the ranges partition the keyspace: contiguous, no gaps or overlap
    assert tier._starts[0] == b"" and tier._ends[-1] == b""
    for i in range(len(tier.groups) - 1):
        assert tier._ends[i] == tier._starts[i + 1]
    # every replica of every region is log-identical with its leader, and
    # the OWNED row sets reconcile to exactly the inserted rows
    seen: set = set()
    for g in tier.groups:
        ldr = g.bus.nodes[g.leader()]
        for nid, node in g.bus.nodes.items():
            assert node.core.commit_index == ldr.core.commit_index, \
                f"replica {nid} lags in region {g.region_id}"
        ids = {r["id"] for r in ldr.rows_in_range()}
        assert not (seen & ids), "row owned by two regions"
        seen |= ids
    assert seen == set(range(35))
    # meta's routing table tracks the same region set
    tier_rids = {m.region_id for m in tier.metas}
    meta_rids = {r.region_id for r in fleet.meta.regions.values()
                 if r.table_id == tier.table_id}
    assert tier_rids == meta_rids
    # a fresh frontend over the fleet sees the split table intact
    s2 = Session(Database("cpu", fleet=fleet))
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    assert s2.query("SELECT COUNT(*) n, SUM(v) s FROM t") == \
        [{"n": 35, "s": float(sum(range(35)))}]


def test_split_survives_one_dead_store():
    """Splits are raft operations: they proceed on a 2/3 quorum."""
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    tier = fleet.row_tiers["default.t"]
    tier.split_rows = 10
    fleet.kill_store(STORES[0])
    for i in range(25):
        s.execute(f"INSERT INTO t VALUES ({i}, 1.0)")
    assert len(tier.groups) >= 2
    assert s.query("SELECT COUNT(*) n FROM t") == [{"n": 25}]


def test_split_aborts_cleanly_without_quorum():
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    tier = fleet.row_tiers["default.t"]
    for i in range(12):
        s.execute(f"INSERT INTO t VALUES ({i}, 1.0)")
    fleet.kill_store(STORES[0])
    fleet.kill_store(STORES[1])
    from baikaldb_tpu_torch.storage.replicated import SplitError
    with pytest.raises(SplitError):
        tier.split_region(0)
    # the aborted split left routing unchanged: one region, reads intact
    assert len(tier.groups) == 1


def test_merge_regions_under_consensus():
    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    tier = fleet.row_tiers["default.t"]
    tier.split_rows = 8
    for i in range(20):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    n_before = len(tier.groups)
    assert n_before >= 2
    # the table shrank relative to policy: raise the threshold and merge
    tier.split_rows = 1000
    assert tier.maybe_merge() >= 1
    assert len(tier.groups) < n_before
    assert tier._starts[0] == b"" and tier._ends[-1] == b""
    for i in range(len(tier.groups) - 1):
        assert tier._ends[i] == tier._starts[i + 1]
    assert s.query("SELECT COUNT(*) n, SUM(v) s FROM t") == \
        [{"n": 20, "s": float(sum(range(20)))}]
    # merged state is replicated: a fresh frontend reads it all back
    s2 = Session(Database("cpu", fleet=fleet))
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    assert s2.query("SELECT COUNT(*) n FROM t") == [{"n": 20}]
    # retired regions left meta's routing table
    meta_rids = {r.region_id for r in fleet.meta.regions.values()
                 if r.table_id == tier.table_id}
    assert meta_rids == {m.region_id for m in tier.metas}


def test_bulk_ingest_replicates():
    import pyarrow as pa

    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    n = 500
    s.load_arrow("t", pa.table({"id": list(range(n)),
                                "v": [float(i) for i in range(n)]}))
    db2 = Database("cpu", fleet=fleet)
    s2 = Session(db2)
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    assert s2.query("SELECT COUNT(*) n FROM t") == [{"n": n}]


def test_two_frontends_insert_without_rowid_collision():
    """Cluster-wide rowid ranges from meta (auto-incr FSM shape): two
    frontends over the SAME fleet inserting concurrently never overwrite
    each other's rows."""
    import threading

    fleet = make_fleet()
    a = Session(Database("cpu", fleet=fleet))
    a.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    a.execute("INSERT INTO t VALUES (0, 0.0)")
    b = Session(Database("cpu", fleet=fleet))     # second frontend, same fleet
    b.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")

    errs = []

    def writer(sess, base):
        try:
            for i in range(20):
                sess.execute(f"INSERT INTO t VALUES ({base + i}, 1.0)")
        except Exception as e:            # noqa: BLE001
            errs.append(e)
    ta = threading.Thread(target=writer, args=(a, 100))
    tb = threading.Thread(target=writer, args=(b, 200))
    ta.start(); tb.start(); ta.join(); tb.join()
    assert not errs, errs
    # every committed row is in the replicas: a fresh frontend sees 41
    c = Session(Database("cpu", fleet=fleet))
    c.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    assert c.query("SELECT COUNT(*) n FROM t") == [{"n": 41}]


# -- differential: the same seeded workload on a JAX fleet and a port fleet --

def _jax_fleet_session():
    from baikaldb_tpu.exec.session import Database as JDatabase, Session as JSession
    from baikaldb_tpu.meta.service import MetaService as JMeta
    from baikaldb_tpu.raft.fleet import StoreFleet as JFleet

    fleet = JFleet(JMeta(peer_count=3), STORES, seed=11)
    return JSession(JDatabase(fleet=fleet)), fleet


# information_schema.regions' columns that the seed decides (the load
# gauges come from heartbeats and wall time)
REGION_COLS = ("region_id", "table_name", "start_key", "end_key", "peers",
               "learners", "leader", "state", "version")


def _regions(s):
    return [{c: r[c] for c in REGION_COLS}
            for r in s.query("SELECT * FROM information_schema.regions ORDER BY region_id")]


def test_fleet_workload_rows_and_regions_match_jax():
    """WORKLOAD with splits on both packages' fleets: the same rows, the
    same SHOW REGIONS and the same raft regions, leaders included."""
    j, jfleet = _jax_fleet_session()
    t, tfleet = fleet_session()
    for s, fleet in ((j, jfleet), (t, tfleet)):
        for sql in WORKLOAD[:1]:
            s.execute(sql)
        fleet.row_tiers["default.t"].split_rows = 3
        for sql in WORKLOAD[1:]:
            s.execute(sql)
    for q in CHECKS:
        assert t.query(q) == j.query(q), q
    assert t.query("SHOW REGIONS") == j.query("SHOW REGIONS")
    assert len(tfleet.row_tiers["default.t"].groups) >= 2
    assert _regions(t) == _regions(j)


def test_handle_fleet_commands_match_jax():
    """The 13 HANDLE fleet commands on both packages, each followed by the
    regions it leaves; affected rows equal."""
    j, jfleet = _jax_fleet_session()
    t, tfleet = fleet_session()
    for s in (j, t):
        s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
        s.execute("INSERT INTO t VALUES " + ", ".join(f"({i}, {i}.5)" for i in range(12)))
    rid = tfleet.row_tiers["default.t"].metas[0].region_id
    assert rid == jfleet.row_tiers["default.t"].metas[0].region_id
    script = [f"HANDLE split_region {rid}", "HANDLE add_instance olap:1 olap",
              f"HANDLE add_learner {rid} olap:1", f"HANDLE remove_learner {rid} olap:1",
              "HANDLE add_instance store4:8110",
              f"HANDLE add_peer {rid} store4:8110", f"HANDLE remove_peer {rid} store4:8110",
              f"HANDLE trans_leader {rid} store2:8110", "HANDLE store_heartbeat",
              "HANDLE balance_tick", f"HANDLE merge_region {rid}", "HANDLE compact",
              "HANDLE drop_instance store4:8110", "HANDLE migrate store4:8110"]
    for sql in script:
        rj, rt = j.execute(sql), t.execute(sql)
        assert rt.affected_rows == rj.affected_rows, sql
        assert _regions(t) == _regions(j), sql
    assert t.query("SELECT COUNT(*) n, SUM(v) s FROM t") == \
        j.query("SELECT COUNT(*) n, SUM(v) s FROM t")


def test_cold_handles_and_the_cold_half_raise_not_ported():
    """The cold tier's segments wait for ROADMAP item 6b: HANDLE cold_*, a
    fleet-bound Database with a cold directory, the tier's cold methods and
    Database(cluster=...) raise NotPortedError."""
    from baikaldb_tpu_torch.errors import NotPortedError

    s, fleet = fleet_session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    for cmd in ("cold_flush default.t", "cold_gc default.t", "cold_status default.t"):
        with pytest.raises(NotPortedError, match="6b"):
            s.execute(f"HANDLE {cmd}")
    tier = fleet.row_tiers["default.t"]
    for call in (lambda: tier.flush_cold(None), lambda: tier.cold_rows(None),
                 lambda: tier.cold_gc(None)):
        with pytest.raises(NotPortedError, match="6b"):
            call()
    with pytest.raises(NotPortedError, match="6b"):
        Session(Database("cpu", fleet=fleet, cold_dir="/nonexistent-cold")).execute(
            "CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    with pytest.raises(NotPortedError):
        Database("cpu", cluster="127.0.0.1:1")
    with pytest.raises(ValueError):
        Database("cpu", fleet=fleet, data_dir="/nonexistent-data")


def test_a_fleet_has_one_tso():
    """Every Database over a fleet stamps commits from the meta service's
    TSO: two frontends' timestamps interleave on one clock."""
    s, fleet = fleet_session()
    t = Session(Database("cpu", fleet=fleet))
    a = s.db.mvcc.now_ts()
    b = t.db.mvcc.now_ts()
    c = fleet.meta.tso.gen()
    assert a < b < c


def test_information_schema_regions_without_a_fleet_is_empty():
    s = Session(Database("cpu"))
    assert s.query("SELECT * FROM information_schema.regions") == []
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    s.execute("INSERT INTO t VALUES (1, 1.0)")
    assert [r["Rows"] for r in s.query("SHOW REGIONS")] == [1]


def test_a_transaction_over_two_replicated_tables_commits_as_one_2pc():
    """COMMIT of a transaction that wrote two tables runs one 2PC over both
    tables' regions (column_store.commit_group -> write_ops_atomic): both
    replicate, or, without a quorum, neither does and both tables' rows
    return to their pre-image; the JAX package gives the same rows."""
    from baikaldb_tpu_torch.raft import twopc

    j, _ = _jax_fleet_session()
    t, fleet = fleet_session()
    calls = []
    orig = twopc.TwoPhaseCoordinator.write

    def counted(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)
    twopc.TwoPhaseCoordinator.write = counted
    try:
        for s in (j, t):
            s.execute("CREATE TABLE a (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
            s.execute("CREATE TABLE b (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
            for sql in ("BEGIN", "INSERT INTO a VALUES (1, 1.0), (2, 2.0)",
                        "INSERT INTO b VALUES (7, 7.0)", "COMMIT"):
                s.execute(sql)
        assert calls == [1]
        for q in ("SELECT id, v FROM a ORDER BY id", "SELECT id, v FROM b ORDER BY id"):
            assert t.query(q) == j.query(q)
        fresh = Session(Database("cpu", fleet=fleet))
        fresh.execute("CREATE TABLE a (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
        fresh.execute("CREATE TABLE b (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
        assert fresh.query("SELECT COUNT(*) n FROM a") == [{"n": 2}]
        assert fresh.query("SELECT COUNT(*) n FROM b") == [{"n": 1}]
        t.execute("BEGIN")
        t.execute("UPDATE a SET v = 9.0 WHERE id = 1")
        t.execute("INSERT INTO b VALUES (8, 8.0)")
        fleet.kill_store(STORES[0])
        fleet.kill_store(STORES[1])
        with pytest.raises(ReplicationError):
            t.execute("COMMIT")
        assert t.query("SELECT id, v FROM a ORDER BY id") == [{"id": 1, "v": 1.0},
                                                             {"id": 2, "v": 2.0}]
        assert t.query("SELECT id, v FROM b ORDER BY id") == [{"id": 7, "v": 7.0}]
    finally:
        twopc.TwoPhaseCoordinator.write = orig
