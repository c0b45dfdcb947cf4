"""The port's partitioned tables against the JAX package's: RANGE and HASH
partitioning, rows in per-partition regions, pruning with its EXPLAIN line,
ADD / DROP PARTITION, NULL keys, the bound checks, an UPDATE that moves a
row across partitions, the unroutable INSERT refused before the WAL, the
tags across a checkpoint, ``information_schema.partitions``, and the pruned
GROUP BYs (a-p)–(c-p) of the chip's partition phase at a small size, each
through its kernel path (the plain versions on the CPU) over the pruned
batch.

Each statement runs in a JAX ``Session`` (CPU, x64) and a port
``Session(device="cpu")`` over the same seeded data.  Keys, counts, NULLs,
error types and ORDER BY order are exact; float sums within rtol 1e-4 where
the port's kernels sum FLOAT in float32 (the JAX package sums in float64),
rtol 1e-9 elsewhere; EXPLAIN is compared whole.  The cases mirror
tests/test_partition.py; its first case compares float SUMs with ``==`` and
fails in the JAX package itself, so its counterpart here holds SUMs within
the tolerance and keys and counts exactly.
"""

import math

import numpy as np
import pyarrow as pa
import pytest

from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.ops import group_kernels as gk
from baikaldb_tpu_torch.utils import metrics


def _same(got, want, rtol=1e-9, ordered=True):
    assert len(got) == len(want), (got, want)
    if not ordered:
        key = lambda r: tuple(repr(v) for v in r.values())  # noqa: E731
        got, want = sorted(got, key=key), sorted(want, key=key)
    for a, b in zip(got, want):
        assert list(a) == list(b), (a, b)
        for k in b:
            if isinstance(b[k], float) and a[k] is not None:
                assert math.isclose(a[k], b[k], rel_tol=rtol, abs_tol=1e-9), (k, a, b)
            else:
                assert a[k] == b[k], (k, a, b)


class Pair:
    def __init__(self, jdb=None, tdb=None):
        self.j = JSession(jdb or JDatabase())
        self.t = TSession(tdb or TDatabase("cpu"))

    def run(self, sql, rtol=1e-9, ordered=True):
        outs = []
        for s in (self.j, self.t):
            try:
                r = s.execute(sql)
                outs.append(("rows", r.to_pylist()) if r.arrow is not None
                            else ("affected", r.affected_rows))
            except Exception as e:     # noqa: BLE001 — compared across packages
                outs.append(("error", type(e).__name__, str(e)))
        assert outs[1][0] == outs[0][0], (sql, outs)
        if outs[0][0] == "rows":
            _same(outs[1][1], outs[0][1], rtol, ordered)
        elif outs[0][0] == "affected":
            assert outs[1][1] == outs[0][1], (sql, outs)
        else:
            assert outs[1][1] == outs[0][1], (sql, outs)
        return outs[1]

    def script(self, stmts):
        return [self.run(q) for q in stmts]

    def explain(self, sql):
        want = self.j.execute("EXPLAIN " + sql).plan_text
        got = self.t.execute("EXPLAIN " + sql).plan_text
        assert got == want
        return got


LINEITEM_DDL = """
CREATE TABLE lineitem (
  l_orderkey BIGINT, l_quantity DOUBLE, l_extendedprice DOUBLE,
  l_discount DOUBLE, l_shipdate DATE, PRIMARY KEY (l_orderkey)
) PARTITION BY RANGE (l_shipdate) (
  PARTITION p1992 VALUES LESS THAN ('1993-01-01'),
  PARTITION p1993 VALUES LESS THAN ('1994-01-01'),
  PARTITION p1994 VALUES LESS THAN ('1995-01-01'),
  PARTITION pmax VALUES LESS THAN MAXVALUE
)
"""


def _lineitem_rows(n):
    return "INSERT INTO lineitem VALUES " + ", ".join(
        f"({i}, {i % 50}.0, {100.0 + i}, 0.0{i % 9}, '{1992 + i % 4}-03-{1 + i % 27:02d}')"
        for i in range(n))


def test_range_partition_prunes_and_matches_unpartitioned():
    p = Pair()
    p.script([LINEITEM_DDL, _lineitem_rows(120),
              "CREATE TABLE flat (l_orderkey BIGINT, l_quantity DOUBLE, "
              "l_extendedprice DOUBLE, l_discount DOUBLE, l_shipdate DATE, "
              "PRIMARY KEY (l_orderkey))",
              "INSERT INTO flat SELECT * FROM lineitem"])
    q = ("SELECT COUNT(*) n, SUM(l_extendedprice * (1 - l_discount)) rev FROM {t} "
         "WHERE l_shipdate >= '1993-01-01' AND l_shipdate < '1994-01-01'")
    plan = p.explain(q.format(t="lineitem"))
    assert "partition(" in plan and "partitions pruned" in plan
    got = p.run(q.format(t="lineitem"))[1]
    flat = p.t.query(q.format(t="flat"))
    _same(got, flat, rtol=1e-12)
    assert got[0]["n"] == flat[0]["n"] > 0


def test_rows_land_in_per_partition_regions():
    p = Pair()
    p.script([LINEITEM_DDL, _lineitem_rows(40)])
    for s in (p.j, p.t):
        store = s.db.stores[f"{s.current_db}.lineitem"]
        assert {r.part for r in store.regions if r.num_rows} == {0, 1, 2, 3}
        for r in store.regions:
            if r.num_rows:
                assert set(store.partition_ids(r.data).tolist()) == {r.part}
    p.run("SELECT * FROM information_schema.partitions ORDER BY partition_name")


@pytest.mark.parametrize("ddl,stmts", [
    ("CREATE TABLE t (id BIGINT, v BIGINT, PRIMARY KEY (id)) PARTITION BY RANGE (v) ("
     "PARTITION p0 VALUES LESS THAN (10), PARTITION p1 VALUES LESS THAN (20))",
     ["INSERT INTO t VALUES (1, 5), (2, 15)", "INSERT INTO t VALUES (3, 25)",
      "SELECT COUNT(*) n FROM t"]),
    # the closed upper bound keeps the partition holding the bound itself
    ("CREATE TABLE t (id BIGINT, v BIGINT, PRIMARY KEY (id)) PARTITION BY RANGE (v) ("
     "PARTITION p0 VALUES LESS THAN (10), PARTITION p1 VALUES LESS THAN (20))",
     ["INSERT INTO t VALUES (1, 5), (2, 10), (3, 15)",
      "EXPLAIN SELECT id FROM t WHERE v <= 10 ORDER BY id",
      "SELECT id FROM t WHERE v <= 10 ORDER BY id",
      "SELECT id FROM t WHERE v > 9 AND v < 11 ORDER BY id"]),
    # NULL keys route to the lowest partition
    ("CREATE TABLE t (id BIGINT, v VARCHAR(8), PRIMARY KEY (id)) PARTITION BY RANGE (v) ("
     "PARTITION p0 VALUES LESS THAN ('m'), PARTITION p1 VALUES LESS THAN MAXVALUE)",
     ["INSERT INTO t VALUES (1, NULL), (2, 'a'), (3, 'z')", "SELECT COUNT(*) n FROM t",
      "SELECT id FROM t WHERE v IS NULL", "SELECT id FROM t WHERE v = 'z'",
      "EXPLAIN SELECT id FROM t WHERE v = 'z'",
      "CREATE TABLE h (id BIGINT, k BIGINT, PRIMARY KEY (id)) PARTITION BY HASH (k) "
      "PARTITIONS 3",
      "INSERT INTO h VALUES (1, NULL), (2, 7)", "SELECT COUNT(*) n FROM h",
      "SELECT * FROM information_schema.partitions"]),
    # the partition clause after table options
    ("CREATE TABLE t (id BIGINT, k BIGINT, PRIMARY KEY (id)) ENGINE=olap "
     "PARTITION BY HASH (k) PARTITIONS 4",
     ["SHOW CREATE TABLE t", "SHOW TABLE STATUS"]),
    # string keys hash by FNV-1a
    ("CREATE TABLE t (id BIGINT, s VARCHAR(8), PRIMARY KEY (id)) PARTITION BY HASH (s) "
     "PARTITIONS 5",
     ["INSERT INTO t VALUES " + ", ".join(f"({i}, 'k{i % 13}')" for i in range(60)),
      "SELECT * FROM information_schema.partitions",
      "EXPLAIN SELECT COUNT(*) n FROM t WHERE s = 'k3'",
      "SELECT COUNT(*) n FROM t WHERE s = 'k3'"]),
    # a DATE range, pruned on both sides
    (LINEITEM_DDL,
     [_lineitem_rows(80),
      "EXPLAIN SELECT COUNT(*) n FROM lineitem WHERE l_shipdate > '1994-06-01'",
      "SELECT COUNT(*) n FROM lineitem WHERE l_shipdate > '1994-06-01'",
      "SELECT l_orderkey FROM lineitem WHERE l_shipdate = '1992-03-05' ORDER BY 1",
      "SELECT COUNT(*) n FROM lineitem WHERE l_shipdate < '1980-01-01'"]),
])
def test_partition_statements_match_jax(ddl, stmts):
    p = Pair()
    p.run(ddl)
    for q in stmts:
        if q.startswith("EXPLAIN "):
            p.explain(q[len("EXPLAIN "):])
        else:
            p.run(q)


def test_no_partition_for_value_rejected():
    p = Pair()
    p.script(["CREATE TABLE t (id BIGINT, v BIGINT, PRIMARY KEY (id)) "
              "PARTITION BY RANGE (v) (PARTITION p0 VALUES LESS THAN (10), "
              "PARTITION p1 VALUES LESS THAN (20))",
              "INSERT INTO t VALUES (1, 5), (2, 15)"])
    err = p.run("INSERT INTO t VALUES (3, 25)")
    assert err[0] == "error" and "no partition for value" in err[2]
    p.run("SELECT COUNT(*) n FROM t")


def test_hash_partitioning_routes_and_prunes_equality():
    p = Pair()
    p.script(["CREATE TABLE h (id BIGINT, k BIGINT, PRIMARY KEY (id)) "
              "PARTITION BY HASH (k) PARTITIONS 4",
              "INSERT INTO h VALUES " + ", ".join(f"({i}, {i % 10})" for i in range(80))])
    for s in (p.j, p.t):
        assert {r.part for r in s.db.stores["default.h"].regions if r.num_rows} <= {0, 1, 2, 3}
    assert "partition(3/4 partitions pruned)" in p.explain("SELECT COUNT(*) n FROM h WHERE k = 3")
    assert p.run("SELECT COUNT(*) n FROM h WHERE k = 3")[1] == [{"n": 8}]
    p.explain("SELECT COUNT(*) n FROM h WHERE k > 3")        # a range on HASH: no pruning


def test_add_and_drop_partition():
    p = Pair()
    p.script(["CREATE TABLE t (id BIGINT, v BIGINT, PRIMARY KEY (id)) PARTITION BY RANGE (v) ("
              "PARTITION p0 VALUES LESS THAN (10), PARTITION p1 VALUES LESS THAN (20))",
              "INSERT INTO t VALUES (1, 5), (2, 15)",
              "INSERT INTO t VALUES (3, 25)",
              "ALTER TABLE t ADD PARTITION (PARTITION p2 VALUES LESS THAN (30))",
              "INSERT INTO t VALUES (3, 25)",
              "SHOW CREATE TABLE t",
              "ALTER TABLE t DROP PARTITION p0",
              "SELECT id FROM t ORDER BY id",
              "INSERT INTO t VALUES (9, 5)",
              "SELECT COUNT(*) n FROM t WHERE v < 10",
              "ALTER TABLE t DROP PARTITION nope",
              "ALTER TABLE t ADD PARTITION (PARTITION p1 VALUES LESS THAN (40))",
              "ALTER TABLE t ADD PARTITION (PARTITION p9 VALUES LESS THAN (5))",
              "ALTER TABLE t ADD PARTITION (PARTITION pm VALUES LESS THAN MAXVALUE)",
              "ALTER TABLE t ADD PARTITION (PARTITION px VALUES LESS THAN (99))",
              "SELECT * FROM information_schema.partitions",
              "SHOW CREATE TABLE t"])
    assert p.run("ALTER TABLE t DROP PARTITION p1")[1] == 2
    p.run("SELECT id, v FROM t ORDER BY id")
    p.run("CREATE TABLE h (id BIGINT, k BIGINT) PARTITION BY HASH (k) PARTITIONS 2")
    p.run("ALTER TABLE h DROP PARTITION p0")
    p.run("CREATE TABLE f (id BIGINT)")
    p.run("ALTER TABLE f ADD PARTITION (PARTITION p0 VALUES LESS THAN (10))")


def test_partition_ddl_guards():
    p = Pair()
    p.script(["CREATE TABLE z (id BIGINT, k BIGINT) PARTITION BY HASH (k) PARTITIONS 0",
              "CREATE TABLE t (id BIGINT, v BIGINT, PRIMARY KEY (id)) PARTITION BY RANGE (v) "
              "(PARTITION p0 VALUES LESS THAN (10))",
              "ALTER TABLE t DROP PARTITION p0",
              # DDL commits an open transaction: ROLLBACK after it undoes nothing
              "BEGIN", "INSERT INTO t VALUES (1, 5)",
              "ALTER TABLE t ADD PARTITION (PARTITION p1 VALUES LESS THAN (20))",
              "ROLLBACK", "SELECT COUNT(*) n FROM t"])


@pytest.mark.parametrize("ddl", [
    "CREATE TABLE bad (id BIGINT, v BIGINT) PARTITION BY RANGE (v) ("
    "PARTITION p0 VALUES LESS THAN (20), PARTITION p1 VALUES LESS THAN (10))",
    "CREATE TABLE bad (id BIGINT) PARTITION BY RANGE (nope) (PARTITION p0 VALUES LESS THAN (10))",
    "CREATE TABLE bad (id BIGINT, v BIGINT) PARTITION BY RANGE (v) ("
    "PARTITION p0 VALUES LESS THAN (10), PARTITION p0 VALUES LESS THAN (20))",
    "CREATE TABLE bad (id BIGINT, d DATE) PARTITION BY RANGE (d) ("
    "PARTITION p0 VALUES LESS THAN ('1995-01-01'), PARTITION p1 VALUES LESS THAN ('1994-01-01'))",
])
def test_partition_bounds_validated(ddl):
    p = Pair()
    assert p.run(ddl)[0] == "error"
    p.run("SHOW TABLES")


def test_update_moves_row_across_partitions():
    p = Pair()
    p.script(["CREATE TABLE t (id BIGINT, v BIGINT, PRIMARY KEY (id)) PARTITION BY RANGE (v) ("
              "PARTITION p0 VALUES LESS THAN (10), PARTITION p1 VALUES LESS THAN (20))",
              "INSERT INTO t VALUES (1, 5), (2, 15)",
              "UPDATE t SET v = 15 WHERE id = 1",
              "SELECT id FROM t WHERE v = 15 ORDER BY id",
              "UPDATE t SET v = 99 WHERE id = 1",
              "SELECT COUNT(*) n FROM t",
              "UPDATE t SET v = v - 10 WHERE v >= 10",
              "SELECT id, v FROM t WHERE v < 10 ORDER BY id",
              "SELECT * FROM information_schema.partitions"])
    store = p.t.db.stores["default.t"]
    for r in store.regions:
        if r.num_rows and r.part >= 0:
            assert set(store.partition_ids(r.data).tolist()) == {r.part}


def test_unroutable_insert_does_not_strand_wal_row(tmp_path):
    p = Pair(JDatabase(data_dir=str(tmp_path / "j")), TDatabase("cpu", data_dir=str(tmp_path / "t")))
    p.script(["CREATE TABLE t (id BIGINT, v BIGINT, PRIMARY KEY (id)) PARTITION BY RANGE (v) "
              "(PARTITION p0 VALUES LESS THAN (10))",
              "INSERT INTO t VALUES (1, 5)",
              "INSERT INTO t VALUES (2, 25)"])
    p2 = Pair(JDatabase(data_dir=str(tmp_path / "j")), TDatabase("cpu", data_dir=str(tmp_path / "t")))
    assert p2.run("SELECT id FROM t")[1] == [{"id": 1}]


def test_partitions_survive_checkpoint_reload(tmp_path):
    p = Pair(JDatabase(data_dir=str(tmp_path / "j")), TDatabase("cpu", data_dir=str(tmp_path / "t")))
    p.script(["CREATE TABLE t (id BIGINT, v BIGINT, PRIMARY KEY (id)) PARTITION BY RANGE (v) ("
              "PARTITION p0 VALUES LESS THAN (10), PARTITION p1 VALUES LESS THAN (20))",
              "INSERT INTO t VALUES (1, 5), (2, 15)"])
    p.j.db.checkpoint()
    p.t.db.checkpoint()
    p2 = Pair(JDatabase(data_dir=str(tmp_path / "j")), TDatabase("cpu", data_dir=str(tmp_path / "t")))
    store = p2.t.db.stores["default.t"]
    assert store.partition_spec() is not None
    assert {r.part for r in store.regions if r.num_rows} == {0, 1}
    assert "partitions pruned" in p2.explain("SELECT id FROM t WHERE v = 5")
    assert p2.run("SELECT id FROM t WHERE v = 5")[1] == [{"id": 1}]


def test_wal_replay_of_a_cross_partition_update_rehomes_the_row(tmp_path):
    """A replayed UPDATE of the partition column moves its row, so pruning
    still finds it after recovery (the port re-homes on replay; a
    checkpoint first makes the JAX package agree)."""
    d = str(tmp_path / "t")
    s = TSession(TDatabase("cpu", data_dir=d))
    s.execute("CREATE TABLE t (id BIGINT, v BIGINT, PRIMARY KEY (id)) PARTITION BY RANGE (v) ("
              "PARTITION p0 VALUES LESS THAN (10), PARTITION p1 VALUES LESS THAN (20))")
    s.execute("INSERT INTO t VALUES (1, 5), (2, 15)")
    s.db.checkpoint()
    s.execute("UPDATE t SET v = 12 WHERE id = 1")
    s2 = TSession(TDatabase("cpu", data_dir=d))
    assert s2.query("SELECT id FROM t WHERE v >= 10 ORDER BY id") == [{"id": 1}, {"id": 2}]
    store = s2.db.stores["default.t"]
    for r in store.regions:
        if r.num_rows and r.part >= 0:
            assert set(store.partition_ids(r.data).tolist()) == {r.part}


# -- the chip's partition phase at a small size ----------------------------

ROWS = 120_000
TP_DDL = ("CREATE TABLE tp (g INT, v FLOAT, w DOUBLE, g16 INT) PARTITION BY RANGE (g) ("
          + ", ".join(f"PARTITION p{i} VALUES LESS THAN ({256 * (i + 1)})" for i in range(7))
          + ", PARTITION p7 VALUES LESS THAN MAXVALUE)")

PRUNED = {
    # 16 groups: the segment kernel's path (on the CPU the reference's
    # scatter; tests/test_torch_cuda.py counts the launches on the card)
    "a-p": ("SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM {t} WHERE v*2+1 > 0.5 "
            "AND g >= 512 AND g < 1024 GROUP BY g16 ORDER BY g16", 1e-9, set()),
    # 2049 slots: K3 + K2
    "b-p": ("SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM {t} WHERE v*2+1 > 0.5 "
            "AND g >= 512 AND g < 1024 GROUP BY g ORDER BY g", 1e-4,
            {"partition_histogram", "fused_group_aggregate"}),
    # 2049 slots, DOUBLE: K1 (the card's run adds K3, tests/test_torch_cuda.py)
    "c-p": ("SELECT g, SUM(w), AVG(w) FROM {t} WHERE w > -1 AND g >= 512 AND g < 1024 "
            "GROUP BY g ORDER BY g", 1e-4, {"filtered_group_sum"}),
}


def tp_table(rows: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "g": pa.array(rng.integers(0, 2049, rows, dtype=np.int32)),
        "v": pa.array(rng.standard_normal(rows, dtype=np.float32)),
        "w": pa.array(rng.standard_normal(rows)),
        "g16": pa.array(rng.integers(0, 16, rows, dtype=np.int32)),
    })


@pytest.fixture(scope="module")
def tp_sessions():
    data = tp_table(ROWS, 11)
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute(TP_DDL)
        s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
        s.load_arrow("tp", data)
        s.load_arrow("t", data)
        out.append(s)
    return out


@pytest.mark.parametrize("name", list(PRUNED))
def test_pruned_group_bys_match_jax_and_the_unpartitioned_table(tp_sessions, monkeypatch,
                                                                 name):
    """EXPLAIN whole (the closed-range rule keeps p2–p4: 5 of 8 pruned),
    the rows against the JAX session and against the same SQL over the
    unpartitioned table, each kernel path run once over the pruned batch."""
    sql, rtol, kernels = PRUNED[name]
    jsess, tsess = tp_sessions
    q = sql.format(t="tp")
    plan = tsess.execute("EXPLAIN " + q).plan_text
    assert plan == jsess.execute("EXPLAIN " + q).plan_text
    assert "access=partition(5/8 partitions pruned)" in plan
    ran = []
    for k in gk.LAUNCHES:
        plain = getattr(gk, f"{k}_plain")

        def spy(*a, _k=k, _plain=plain):
            ran.append((_k, int(a[0].shape[0])))
            return _plain(*a)
        monkeypatch.setattr(gk, f"{k}_plain", spy)
    swallowed = metrics.REGISTRY.counter("swallowed.session.access_path")
    faults = swallowed.value
    got = tsess.query(q)
    assert swallowed.value == faults                     # pruned, not a swallowed full scan
    g = tp_table(ROWS, 11).column("g").to_numpy()
    kept = int(((g >= 512) & (g < 1280)).sum())         # partitions p2–p4
    assert {k for k, _ in ran} == kernels
    assert all(n == kept for _, n in ran)                # over the pruned batch
    assert len(ran) == len(kernels)                      # once each, as over t
    _same(got, jsess.query(q), rtol)
    _same(got, tsess.query(sql.format(t="t")), 1e-9 if name == "a-p" else 1e-6)


def test_pruned_batch_is_cached_per_version_and_drop_partition_matches_numpy(tp_sessions):
    jsess, tsess = tp_sessions
    q = PRUNED["b-p"][0].format(t="tp")
    tsess.query(q)
    before = dict(tsess._access_batches)
    tsess.query(q)
    assert tsess._access_batches == before and any(k[2] == "part" for k in before)
    data = tp_table(ROWS, 11)
    for s in (jsess, tsess):
        s.execute("CREATE TABLE tq (g INT, v FLOAT, w DOUBLE, g16 INT) PARTITION BY RANGE (g) ("
                  + ", ".join(f"PARTITION p{i} VALUES LESS THAN ({256 * (i + 1)})"
                              for i in range(7)) + ", PARTITION p7 VALUES LESS THAN MAXVALUE)")
        s.load_arrow("tq", data)
    dropped = [s.execute("ALTER TABLE tq DROP PARTITION p2").affected_rows for s in (jsess, tsess)]
    g = data.column("g").to_numpy()
    v = data.column("v").to_numpy()
    assert dropped == [int(((g >= 512) & (g < 768)).sum())] * 2
    qd = PRUNED["b-p"][0].format(t="tq")
    got = tsess.query(qd)
    _same(got, jsess.query(qd), 1e-4)
    m = (v * 2 + 1 > 0.5) & (g >= 768) & (g < 1024)
    keys, counts = np.unique(g[m], return_counts=True)
    cols = [list(r.values()) for r in got]                 # g, COUNT, SUM, AVG, MIN
    assert [c[0] for c in cols] == keys.tolist()
    assert [c[1] for c in cols] == counts.tolist()
    assert [c[4] for c in cols] == [float(v[m][g[m] == k].min()) for k in keys]


def test_drop_and_truncate_free_the_pruned_batch_and_a_new_table_stages_its_own():
    """DROP TABLE and TRUNCATE free the session's pruned batches of the
    table at once; a table made again under the same name (its versions
    start anew) reads its own rows, not the dropped table's batch."""
    p = Pair()
    q = PRUNED["b-p"][0].format(t="tp")
    parts = lambda: [k for k in p.t._access_batches if k[0] == "default.tp"]  # noqa: E731
    for seed in (5, 6):
        for s in (p.j, p.t):
            s.execute(TP_DDL)
            s.load_arrow("tp", tp_table(20_000, seed))
        p.run(q, rtol=1e-4)
        assert parts()
        p.run("TRUNCATE TABLE tp")
        assert parts() == []
        for s in (p.j, p.t):
            s.load_arrow("tp", tp_table(20_000, seed))
        p.run(q, rtol=1e-4)
        assert parts()
        p.run("DROP TABLE tp")
        assert parts() == []


def test_a_table_made_again_in_another_session_is_not_read_from_the_old_batch():
    """Another session over the same database drops the table and makes it
    again with other rows, at the same version: this session's cached
    pruned batch of the old table is not read for the new one."""
    p = Pair()
    other = TSession(p.t.db)
    q = PRUNED["b-p"][0].format(t="tp")
    for s in (p.j, p.t):
        s.execute(TP_DDL)
        s.load_arrow("tp", tp_table(20_000, 5))
    p.run(q, rtol=1e-4)
    key = [k for k in p.t._access_batches if k[0] == "default.tp"]
    for s in (p.j, other):
        s.execute("DROP TABLE tp")
        s.execute(TP_DDL)
        s.load_arrow("tp", tp_table(20_000, 6))
    p.run(q, rtol=1e-4)
    assert [k for k in p.t._access_batches if k[0] == "default.tp"] == key   # same version
