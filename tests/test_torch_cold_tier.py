"""The cold tier of the port's replicated tables (storage/replicated.py,
storage/remote_tier.py, storage/coldfs.py) against the JAX package's.

``tests/test_cold_tier.py``'s cases on a port fleet with ``cold_dir``: a
flush evicts the hot rows into Parquet segments and a SELECT spans hot and
cold; a store's death and a fresh frontend's rebuild lose nothing; the
manifest survives a leader change and a snapshot install, repeated flushes
and GC, a region merge; a frontend without the cold FS refuses the table;
GC compacts a lone dirty segment and never deletes a file a split sibling
still names; the daemon plane's flush through ``spawn_cluster``'s store
processes survives a SIGKILL; HANDLE without a cold FS raises; and
``information_schema.cold_segments`` lists the segments.  Then the segments
themselves: the port's codec writes the JAX package's bytes for the same
seeded rows, and the segments a fleet of either package flushes read back
in the other as the rows its own tier reads.
"""

import numpy as np
import pyarrow as pa
import pytest

from baikaldb_tpu_torch.exec.session import Database, Session


def fleet_session(tmp_path, **dbkw):
    from baikaldb_tpu_torch.meta.service import MetaService
    from baikaldb_tpu_torch.raft.fleet import StoreFleet

    meta = MetaService(peer_count=3)
    fleet = StoreFleet(meta, ["a:1", "b:1", "c:1"], seed=23)
    db = Database("cpu", fleet=fleet, cold_dir=str(tmp_path / "afs"), **dbkw)
    return Session(db), fleet


def test_flush_evicts_hot_and_select_spans_hot_plus_cold(tmp_path):
    s, fleet = fleet_session(tmp_path)
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    for i in range(20):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    tier = fleet.row_tiers["default.t"]
    hot_before = tier.hot_bytes()
    n = s.execute("HANDLE cold_flush default.t").affected_rows
    assert n == 20
    # cold bytes EVICTED from the row tier
    assert tier.hot_bytes() < hot_before / 4
    assert tier.num_rows() == 0                      # hot is empty
    fs = s.db.cold_fs()
    assert fs.list()                                 # segments on the FS
    # new rows land hot; SELECT spans hot + cold transparently
    s.execute("INSERT INTO t VALUES (100, 1.5)")
    got = s.query("SELECT COUNT(*) n, SUM(v) sv FROM t")
    assert got == [{"n": 21, "sv": float(sum(range(20))) + 1.5}]


def test_kill_and_rebuild_loses_nothing(tmp_path):
    """The verdict's done-criterion: kill after cold flush loses nothing —
    a store dies AND a fresh frontend rebuilds from cold + the surviving
    replicas."""
    s, fleet = fleet_session(tmp_path)
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    for i in range(15):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    s.execute("HANDLE cold_flush default.t")
    s.execute("INSERT INTO t VALUES (50, 0.5)")      # hot on top of cold
    s.execute("UPDATE t SET v = 99.0 WHERE id = 3")  # hot update of a COLD row
    s.execute("DELETE FROM t WHERE id = 7")          # hot delete of a COLD row
    fleet.kill_store("a:1")
    s2 = Session(Database("cpu", fleet=fleet, cold_dir=str(s.db.cold_dir)))
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    got = s2.query("SELECT COUNT(*) n, SUM(v) sv FROM t")
    want_sum = sum(float(i) for i in range(15) if i not in (3, 7)) \
        + 99.0 + 0.5
    assert got == [{"n": 15, "sv": want_sum}]
    assert s2.query("SELECT v FROM t WHERE id = 3") == [{"v": 99.0}]
    assert s2.query("SELECT v FROM t WHERE id = 7") == []


def test_manifest_survives_leader_change_and_snapshot(tmp_path):
    s, fleet = fleet_session(tmp_path)
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    for i in range(10):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    s.execute("HANDLE cold_flush default.t")
    tier = fleet.row_tiers["default.t"]
    g = tier.groups[0]
    # compaction folds the manifest into the raft snapshot; a follower that
    # catches up via snapshot-install must still know the cold segments
    for node in g.bus.nodes.values():
        node.compact()
    old = g.leader()
    g.bus.kill(old)
    new = g.bus.elect()
    assert new != old
    assert g.bus.nodes[new].cold_manifest    # manifest survived
    g.bus.revive(old)
    s2 = Session(Database("cpu", fleet=fleet, cold_dir=str(s.db.cold_dir)))
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    assert s2.query("SELECT COUNT(*) n FROM t") == [{"n": 10}]


def test_repeated_flush_and_gc(tmp_path):
    s, fleet = fleet_session(tmp_path)
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    for i in range(8):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    s.execute("HANDLE cold_flush default.t")
    for i in range(8, 16):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    s.execute("DELETE FROM t WHERE id = 2")          # deletes a cold row
    s.execute("HANDLE cold_flush default.t")         # second segment
    fs = s.db.cold_fs()
    files_before = len(fs.list())
    assert files_before >= 2
    reclaimed = s.execute("HANDLE cold_gc default.t").affected_rows
    assert reclaimed >= 2
    assert len(fs.list()) < files_before             # orphans deleted
    # GC'd cold state still reads correctly from a fresh frontend
    s2 = Session(Database("cpu", fleet=fleet, cold_dir=str(s.db.cold_dir)))
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    got = s2.query("SELECT COUNT(*) n, SUM(v) sv FROM t")
    assert got == [{"n": 15,
                    "sv": float(sum(range(16)) - 2)}]


def test_region_merge_preserves_cold_manifest(tmp_path):
    """Merging regions must fold the right region's cold manifest into the
    survivor — the evicted rows live only in those segments."""
    s, fleet = fleet_session(tmp_path)
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    tier = fleet.row_tiers["default.t"]
    tier.split_rows = 8
    for i in range(20):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    assert len(tier.groups) > 1
    s.execute("HANDLE cold_flush default.t")
    fs = s.db.cold_fs()
    before = len(tier.cold_rows(fs))
    tier.split_rows = 0
    while len(tier.groups) > 1:
        tier.merge_region(0)
    assert len(tier.cold_rows(fs)) == before         # nothing lost
    s2 = Session(Database("cpu", fleet=fleet, cold_dir=str(s.db.cold_dir)))
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    assert s2.query("SELECT COUNT(*) n FROM t") == [{"n": 20}]


def test_frontend_without_cold_fs_refuses_rebuild(tmp_path):
    s, fleet = fleet_session(tmp_path)
    s.execute("CREATE TABLE t (id BIGINT, PRIMARY KEY (id))")
    s.execute("INSERT INTO t VALUES (1), (2)")
    s.execute("HANDLE cold_flush default.t")
    s2 = Session(Database("cpu", fleet=fleet))             # cold_dir forgotten
    with pytest.raises(ValueError, match="cold segments"):
        s2.execute("CREATE TABLE t (id BIGINT, PRIMARY KEY (id))")


def test_gc_compacts_single_dirty_segment(tmp_path):
    """A lone segment carrying __del markers or superseded versions still
    compacts (the common one-segment-per-region case)."""
    s, fleet = fleet_session(tmp_path)
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    for i in range(6):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    s.execute("DELETE FROM t WHERE id = 2")
    s.execute("HANDLE cold_flush default.t")        # one segment, has marker
    assert s.execute("HANDLE cold_gc default.t").affected_rows >= 1
    # idempotent: a clean single segment is left alone
    assert s.execute("HANDLE cold_gc default.t").affected_rows == 0
    s2 = Session(Database("cpu", fleet=fleet, cold_dir=str(s.db.cold_dir)))
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    assert s2.query("SELECT COUNT(*) n FROM t") == [{"n": 5}]


def test_gc_never_deletes_segment_shared_by_split_child(tmp_path):
    """Split children can reference the parent's segment file; GC of one
    region must not delete a file a sibling manifest still needs."""
    s, fleet = fleet_session(tmp_path)
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    tier = fleet.row_tiers["default.t"]
    for i in range(12):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    s.execute("HANDLE cold_flush default.t")        # one shared-era segment
    for i in range(12, 24):
        s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
    s.execute("DELETE FROM t WHERE id = 1")
    s.execute("HANDLE cold_flush default.t")        # second segment
    s.execute("DELETE FROM t WHERE id = 2")
    s.execute("HANDLE cold_flush default.t")
    s.execute("HANDLE cold_gc default.t")
    # every manifest-referenced file must still exist
    fs = s.db.cold_fs()
    for m, g in zip(tier.metas, tier.groups):
        node = g.bus.nodes[g.leader()]
        for _sq, f, _w in node.cold_manifest:
            assert fs.exists(f), f
    s2 = Session(Database("cpu", fleet=fleet, cold_dir=str(s.db.cold_dir)))
    s2.execute("CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))")
    got = s2.query("SELECT COUNT(*) n FROM t")
    assert got == [{"n": 22}]


def test_daemon_plane_cold_flush(tmp_path):
    """Cold tier on the multi-process cluster: the flush coordinator runs
    on the frontend over RPC, segments land on the shared external FS, the
    manifest raft-commits inside the store daemons (shared CMD_COLD apply),
    and a SIGKILL'd store loses nothing."""
    from baikaldb_tpu_torch.tools.deploy_cluster import spawn_cluster, teardown

    cold = str(tmp_path / "afs")
    ddl = "CREATE TABLE t (id BIGINT, v DOUBLE, PRIMARY KEY (id))"
    meta_addr, procs = spawn_cluster(n_stores=3, base_port=0)
    try:
        s = Session(Database("cpu", cluster=meta_addr, cold_dir=cold))
        s.execute(ddl)
        for i in range(12):
            s.execute(f"INSERT INTO t VALUES ({i}, {float(i)})")
        n = s.execute("HANDLE cold_flush default.t").affected_rows
        assert n == 12
        st = s.execute("HANDLE cold_status default.t").arrow.to_pylist()[0]
        assert st["hot_bytes"] == 0 and st["cold_segments"] >= 1
        s.execute("INSERT INTO t VALUES (50, 0.5)")          # hot again
        s.execute("DELETE FROM t WHERE id = 3")              # del of a COLD row
        procs["stores"][0].kill()                            # SIGKILL
        s2 = Session(Database("cpu", cluster=meta_addr, cold_dir=cold))
        s2.execute(ddl)
        got = s2.query("SELECT COUNT(*) n, SUM(v) sv FROM t")
        want = sum(float(i) for i in range(12) if i != 3) + 0.5
        assert got == [{"n": 12, "sv": want}]
        # a frontend without the cold FS refuses a lossy rebuild
        with pytest.raises(ValueError, match="cold segments"):
            s3 = Session(Database("cpu", cluster=meta_addr))
            s3.execute(ddl)
        s2.execute("HANDLE cold_flush default.t")
        assert s2.execute("HANDLE cold_gc default.t").affected_rows >= 1
        assert s2.query("SELECT COUNT(*) n FROM t") == [{"n": 12}]
        for d in (s.db, s2.db):
            d.close()
    finally:
        teardown(procs)


def test_cold_flush_requires_configured_fs(tmp_path):
    from baikaldb_tpu_torch.meta.service import MetaService
    from baikaldb_tpu_torch.raft.fleet import StoreFleet
    from baikaldb_tpu_torch.plan.planner import PlanError

    meta = MetaService(peer_count=3)
    fleet = StoreFleet(meta, ["a:1", "b:1", "c:1"], seed=29)
    s = Session(Database("cpu", fleet=fleet))        # no cold_dir, no flag
    s.execute("CREATE TABLE t (id BIGINT, PRIMARY KEY (id))")
    s.execute("INSERT INTO t VALUES (1)")
    with pytest.raises(PlanError, match="no cold storage"):
        s.execute("HANDLE cold_flush default.t")


def test_information_schema_cold_segments(tmp_path):
    s, fleet = fleet_session(tmp_path)
    s.execute("CREATE TABLE t (id BIGINT, PRIMARY KEY (id))")
    s.execute("INSERT INTO t VALUES (1), (2)")
    s.execute("HANDLE cold_flush default.t")
    got = s.query("SELECT table_schema, table_name, file FROM "
                  "information_schema.cold_segments")
    assert got and got[0]["table_schema"] == "default"
    assert got[0]["table_name"] == "t"
    assert got[0]["file"].endswith(".parquet")


# -- segments across the packages -------------------------------------------

def _seg_rows(seed: int, n: int = 50) -> list:
    rng = np.random.default_rng(seed)
    return [{"__rowid": i + 1, "__del": None if i % 9 else True,
             "id": None if i % 9 == 0 else i, "v": float(rng.normal()),
             "s": None if i % 7 == 0 else f"s{int(rng.integers(0, 99))}",
             "b": None if i % 5 == 0 else bool(rng.integers(0, 2))}
            for i in range(n)]


SEG_SCHEMA = pa.schema([("__rowid", pa.int64()), ("__del", pa.bool_()), ("id", pa.int64()),
                        ("v", pa.float64()), ("s", pa.string()), ("b", pa.bool_())])


@pytest.mark.parametrize("seed", [3, 4])
def test_segment_codec_matches_jax(seed):
    from baikaldb_tpu.storage import coldfs as jcold
    from baikaldb_tpu_torch.storage import coldfs as tcold

    rows = _seg_rows(seed)
    got = tcold.segment_bytes(rows, SEG_SCHEMA)
    assert got == jcold.segment_bytes(rows, SEG_SCHEMA)
    assert tcold.segment_rows(got) == jcold.segment_rows(got)
    assert tcold.segment_rows(jcold.segment_bytes(rows, SEG_SCHEMA)) == jcold.segment_rows(got)


def _flush_fleet(pkg, tmp, seed):
    """A fleet of ``pkg`` with a cold tier: seeded inserts, an update and a
    delete, one flush -> (its session, its tier, its cold FS)."""
    import importlib

    sess = importlib.import_module(f"{pkg}.exec.session")
    meta = importlib.import_module(f"{pkg}.meta.service").MetaService(peer_count=3)
    fleet = importlib.import_module(f"{pkg}.raft.fleet").StoreFleet(
        meta, ["a:1", "b:1", "c:1"], seed=31)
    kw = {"fleet": fleet, "cold_dir": str(tmp / pkg)}
    db = sess.Database("cpu", **kw) if pkg.endswith("_torch") else sess.Database(**kw)
    s = sess.Session(db)
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE, name VARCHAR(8), PRIMARY KEY (id))")
    rng = np.random.default_rng(seed)
    vals = ", ".join(f"({i}, {float(rng.normal()):.6f}, 'n{i % 3}')" for i in range(30))
    s.execute(f"INSERT INTO t VALUES {vals}")
    s.execute("UPDATE t SET v = 2.5 WHERE id = 4")
    s.execute("DELETE FROM t WHERE id = 9")
    s.execute("HANDLE cold_flush default.t")
    return s, fleet.row_tiers["default.t"], s.db.cold_fs()


def test_fleet_segments_read_back_across_packages(tmp_path):
    from baikaldb_tpu.storage import coldfs as jcold
    from baikaldb_tpu_torch.storage import coldfs as tcold

    ts, ttier, tfs = _flush_fleet("baikaldb_tpu_torch", tmp_path, 5)
    js, jtier, jfs = _flush_fleet("baikaldb_tpu", tmp_path, 5)
    # each tier's own cold rows, in manifest order, are the other's
    tcold_rows, jcold_rows = ttier.cold_rows(tfs), jtier.cold_rows(jfs)
    assert tcold_rows == jcold_rows and len(tcold_rows) == 30
    # every file of one package's flush decodes in the other alike
    for fs, other in ((tfs, jcold), (jfs, tcold)):
        for name in fs.list():
            blob = fs.get(name)
            assert other.segment_rows(blob) == tcold.segment_rows(blob)
    q = "SELECT COUNT(*) n, SUM(v) sv, MIN(name) m FROM t"
    got, want = ts.query(q), js.query(q)
    assert got[0]["n"] == want[0]["n"] == 29
    assert got[0]["sv"] == pytest.approx(want[0]["sv"], rel=1e-12)
    assert got[0]["m"] == want[0]["m"]


def test_batched_cold_keys_equal_the_row_at_a_time_keys():
    """A pushed fragment's cold fold encodes a segment's keys in one batch
    (``KeyCodec.encode_dicts``): the bytes of ``encode_one`` a row, the
    port's and the JAX package's, NULLs and strings included."""
    from baikaldb_tpu.storage.rowstore import KeyCodec as JKeyCodec
    from baikaldb_tpu.types import Field as JField
    from baikaldb_tpu.types import LType as JLType
    from baikaldb_tpu.types import Schema as JSchema
    from baikaldb_tpu_torch.storage.rowstore import KeyCodec
    from baikaldb_tpu_torch.types import Field, LType, Schema

    cols = (("__rowid", "INT64", False), ("s", "STRING", True), ("f", "FLOAT64", True))
    sch = Schema(tuple(Field(n, LType[t], nl) for n, t, nl in cols))
    jsch = JSchema(tuple(JField(n, JLType[t], nl) for n, t, nl in cols))
    rng = np.random.default_rng(9)
    rows = [{"__rowid": int(rng.integers(-2**62, 2**62)),
             "s": None if i % 5 == 0 else f"x{i}",
             "f": None if i % 7 == 0 else float(rng.normal())} for i in range(500)]
    for key in (["__rowid"], ["s", "__rowid"], ["f"], ["s"]):
        got = KeyCodec(sch, key).encode_dicts(rows)
        assert got == [JKeyCodec(jsch, key).encode_one(r) for r in rows]
    assert KeyCodec(sch, ["__rowid"]).encode_dicts([]) == []


def test_batched_value_hashes_equal_the_jax_hash():
    """A cold flush's eviction compare-and-swap hashes (``_fnv64_many``,
    one batch a region) are the JAX package's ``_fnv64`` of each value."""
    from baikaldb_tpu.storage.replicated import _fnv64 as jfnv
    from baikaldb_tpu_torch.storage.replicated import _fnv64_many

    rng = np.random.default_rng(11)
    vals = [rng.integers(0, 256, int(rng.integers(0, 70)), dtype=np.uint8).tobytes()
            for _ in range(3000)] + [b"", b"\xff" * 64]
    assert _fnv64_many(vals) == [jfnv(v) for v in vals]
    assert _fnv64_many([]) == []
