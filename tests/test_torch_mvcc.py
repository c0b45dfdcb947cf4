"""The port's MVCC (storage/mvcc.py and the session's snapshot scope)
against the JAX package's: the visibility predicate, the TSO client, SET
SNAPSHOT under UPDATE / DELETE / INSERT, replay at a recorded timestamp, the
automatic analytical pin, ``mvcc = 0``, one timestamp per transaction, GC
never below the oldest pin, expired pins, the ``mvcc.gc`` failpoint, a pin
across region splits, and one script of DDL, DML, transactions and pinned
GROUP BYs at 2049 and 17 group slots.

Each case runs its statements in a JAX ``Session`` and a port
``Session(device="cpu")`` and compares the rows by the parity contract
(models/parity.py): keys, counts, integers and NULLs exact, floats within
rtol 1e-4 where the port's float32 group-by kernels ran (their plain
versions on the CPU), 1e-9 elsewhere.  Timestamps differ between the two
packages' oracles, so a case compares what a timestamp selects, never the
timestamp.  Both flag and failpoint registries are set alike and restored.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from baikaldb_tpu.chaos import failpoint as jfp
from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.storage import mvcc as jmv
from baikaldb_tpu.utils.flags import set_flag as jset_flag
from baikaldb_tpu_torch.chaos import failpoint as tfp
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.meta.tso import Tso
from baikaldb_tpu_torch.models.parity import mismatch
from baikaldb_tpu_torch.ops import group_kernels as gk
from baikaldb_tpu_torch.sql.lexer import SqlError
from baikaldb_tpu_torch.storage import mvcc as tmv
from baikaldb_tpu_torch.utils.flags import set_flag as tset_flag


def both_flags(name, value):
    jset_flag(name, value)
    tset_flag(name, value)


@pytest.fixture(autouse=True)
def _clean():
    jfp.clear_all()
    tfp.clear_all()
    both_flags("mvcc", True)
    yield
    jfp.clear_all()
    tfp.clear_all()
    both_flags("mvcc", True)
    both_flags("snapshot_max_age_s", 300.0)
    both_flags("tso_batch_size", 64)
    both_flags("chaos_seed", 0)


def _sessions(n=8):
    """(JAX session, port session) over the JAX test's table r."""
    out = []
    for db, S in ((JDatabase(), JSession), (TDatabase("cpu"), TSession)):
        s = S(db, "t")
        s.execute("CREATE DATABASE t")
        s.execute("CREATE TABLE r (id BIGINT, g BIGINT, v BIGINT, PRIMARY KEY (id))")
        for i in range(n):
            s.execute(f"INSERT INTO r VALUES ({i}, {i % 2}, {i * 10})")
        out.append(s)
    return out


def _writer(s):
    return type(s)(s.db, "t")


def check(ts, js, sql, rtol=1e-9):
    got, want = ts.query(sql), js.query(sql)
    diff = mismatch(got, want, sql, rtol)
    assert diff is None, diff
    return got


# ---- the visibility predicate and the TSO client -------------------------

def test_visibility_mask_interval_semantics():
    cts = np.array([1, 5, 9, 0, 3, 7], dtype=np.int64)
    dts = np.array([4, tmv.MAX_TS, tmv.MAX_TS, tmv.MAX_TS, tmv.PENDING, 7], dtype=np.int64)
    for snap in (0, 4, 5, 7, 9, tmv.MAX_TS - 1):
        got = tmv.visibility_mask(torch.from_numpy(cts), torch.from_numpy(dts), snap)
        want = np.asarray(jmv.visibility_mask(cts, dts, snap))
        assert got.dtype == torch.bool and got.numpy().tolist() == want.tolist()
    assert tmv.visibility_mask(torch.from_numpy(cts), torch.from_numpy(dts), 5) \
        .tolist() == [False, True, False, True, True, False]
    assert tmv.MAX_TS == jmv.MAX_TS and tmv.PENDING == jmv.PENDING


def test_tso_client_batches_and_stays_monotonic():
    grants = []

    def gen(count):
        grants.append(count)
        return sum(grants[:-1]) + 1_000_000

    both_flags("tso_batch_size", 8)
    cli = tmv.TsoClient(gen)
    out = [cli.next_ts() for _ in range(20)]
    assert out == sorted(set(out)) and grants == [8, 8, 8] and cli.last_ts() == out[-1]
    r0, a0 = tmv.tso_batch_refills.value, tmv.tso_allocations.value
    both_flags("tso_batch_size", 4)
    cli = tmv.TsoClient(Tso().gen)
    a = cli.next_ts()
    b = cli.next_ts(10)
    c = cli.next_ts()
    assert a < b < c and c >= b + 10
    assert tmv.tso_allocations.value - a0 == 12 and tmv.tso_batch_refills.value - r0 == 3


def test_tso_client_lost_grant_and_regressing_source():
    both_flags("tso_batch_size", 4)
    both_flags("chaos_seed", 1)
    cli = tmv.TsoClient(Tso().gen)
    before = cli.next_ts()
    tfp.set_failpoint("tso.allocate", "1*drop")
    seq = [cli.next_ts() for _ in range(12)]
    assert all(x < y for x, y in zip([before] + seq, seq))
    bad = tmv.TsoClient(lambda count: 100)
    bad.next_ts(4)
    with pytest.raises(tmv.TsoError):
        bad.next_ts(4)


def test_tso_hybrid_layout_carry_and_clamp():
    t = Tso()
    first = t.gen_at(1000, 5)
    assert first == 1000 << Tso.LOGICAL_BITS and t.gen_at(1000, 1) == first + 5
    cap = 1 << Tso.LOGICAL_BITS
    f2 = t.gen_at(2000, cap + 10)
    assert t.gen_at(2000, 1) >= f2 + cap + 10
    a, b = t.gen_at(5000, 1), t.gen_at(4000, 1)
    assert a < b and b >> Tso.LOGICAL_BITS == 5000


# ---- pinned reads under writes ---------------------------------------------

def test_set_snapshot_pins_under_update_delete_insert():
    js, ts = _sessions()
    queries = ["SELECT id, v FROM r ORDER BY id", "SELECT g, SUM(v) FROM r GROUP BY g ORDER BY g"]
    for s in (js, ts):
        s.execute("SET SNAPSHOT = 'now'")
    base = [check(ts, js, q) for q in queries]
    for s in (js, ts):
        w = _writer(s)
        w.execute("UPDATE r SET v = v + 1000 WHERE id < 4")
        w.execute("DELETE FROM r WHERE id = 5")
        w.execute("INSERT INTO r VALUES (100, 0, 1)")
    assert [check(ts, js, q) for q in queries] == base
    for s in (js, ts):
        s.execute("SET SNAPSHOT = 0")
    now = check(ts, js, queries[0])
    assert now != base[0] and {r["id"] for r in now} == {0, 1, 2, 3, 4, 6, 7, 100}


def test_set_snapshot_at_recorded_ts_replays():
    js, ts = _sessions()
    base = {}
    for s in (js, ts):
        s.execute("SET SNAPSHOT = 'now'")
        ts_ = s._snapshot[1]
        base[id(s)] = s.query("SELECT SUM(v), COUNT(*) FROM r")
        w = _writer(s)
        for i in range(8):
            w.execute(f"UPDATE r SET v = v + 5 WHERE id = {i}")
        s2 = _writer(s)
        s2.execute(f"SET SNAPSHOT = {ts_}")
        assert s2.query("SELECT SUM(v), COUNT(*) FROM r") == base[id(s)]
        s2.execute("SET SNAPSHOT = 0")
        s.execute("SET SNAPSHOT = 0")
    assert base[id(ts)] == base[id(js)]


def test_set_snapshot_validation():
    js, ts = _sessions(2)
    with pytest.raises(SqlError):
        ts.execute("SET SNAPSHOT = 'tuesday'")
    both_flags("mvcc", False)
    with pytest.raises(SqlError):
        ts.execute("SET SNAPSHOT = 'now'")


def test_auto_pin_analytical_consistency_point():
    """An aggregate draws one fresh ts and its pin lives only while it
    runs; a plain row fetch never pins."""
    js, ts = _sessions()
    seen = {}
    for s in (js, ts):
        reg = s.db.mvcc.snapshots
        orig = reg.pin
        got = seen.setdefault(id(s), [])

        def spy(t, query="", holder="", _orig=orig, _got=got):
            _got.append(query)
            return _orig(t, query=query, holder=holder)
        reg.pin = spy
        s.query("SELECT g, SUM(v) FROM r GROUP BY g ORDER BY g")
        s.query("SELECT id FROM r WHERE id = 3")
        reg.pin = orig
        assert reg.describe() == []
    assert seen[id(ts)] == seen[id(js)] == ["auto"]


def test_auto_pin_refusal_degrades_unpinned():
    js, ts = _sessions()
    both_flags("chaos_seed", 1)
    jfp.set_failpoint("snapshot.pin", "drop")
    tfp.set_failpoint("snapshot.pin", "drop")
    assert check(ts, js, "SELECT SUM(v) AS sv FROM r") == [{"sv": 280}]
    with pytest.raises(SqlError):
        ts.execute("SET SNAPSHOT = 'now'")


def test_off_switch_bit_identical():
    js, ts = _sessions()
    queries = ["SELECT g, SUM(v) FROM r GROUP BY g ORDER BY g", "SELECT id, v FROM r ORDER BY id"]
    on = [check(ts, js, q) for q in queries]
    both_flags("mvcc", False)
    _writer(ts).execute("UPDATE r SET v = v WHERE id = 1")
    _writer(js).execute("UPDATE r SET v = v WHERE id = 1")
    assert [check(ts, js, q) for q in queries] == on
    assert ts.db.stores["t.r"]._mvcc.history == []


# ---- transactions ----------------------------------------------------------

def test_txn_commit_stamps_one_ts_rollback_restores():
    js, ts = _sessions()
    store = ts.db.stores["t.r"]
    for s in (js, ts):
        s.execute("SET SNAPSHOT = 'now'")
    base = check(ts, js, "SELECT SUM(v) FROM r")
    for s in (js, ts):
        w = _writer(s)
        w.execute("BEGIN")
        w.execute("UPDATE r SET v = v + 100 WHERE id = 0")
        w.execute("INSERT INTO r VALUES (50, 0, 7)")
        if s is ts:
            # uncommitted rows carry PENDING: invisible to every snapshot
            assert any(r.cts_max() == tmv.PENDING for r in store.regions)
            assert store.mvcc_needs_versioned(s._snapshot[1])
        w.execute("COMMIT")
    stamps = np.concatenate([r.cts for r in store.regions])
    assert tmv.PENDING not in stamps
    # the transaction's UPDATE and INSERT share its one commit ts
    assert stamps[0] == stamps[-1] and stamps[0] > 0
    assert store._mvcc.history[0].dts == stamps[0]
    assert check(ts, js, "SELECT SUM(v) FROM r") == base
    hist = len(store._mvcc.history)
    for s in (js, ts):
        w = _writer(s)
        w.execute("BEGIN")
        w.execute("DELETE FROM r WHERE id = 1")
        w.execute("ROLLBACK")
    assert len(store._mvcc.history) == hist
    for s in (js, ts):
        s.execute("SET SNAPSHOT = 0")
    assert {r["id"] for r in check(ts, js, "SELECT id FROM r ORDER BY id")} >= {0, 1, 50}


def test_versioned_batch_matches_jax_snapshot_versions():
    """The versioned image at a pin: the port's device batch holds the rows
    the JAX package's ``snapshot_versions`` makes visible, scanning as many
    history versions."""
    js, ts = _sessions()
    for s in (js, ts):
        s.execute("SET SNAPSHOT = 'now'")
        w = _writer(s)
        w.execute("UPDATE r SET v = v + 1 WHERE id < 3")
        w.execute("DELETE FROM r WHERE id = 6")
    batch, n = ts.db.stores["t.r"].versioned_batch(ts._snapshot[1])
    table, cts, dts, want_n = js.db.stores["t.r"].snapshot_versions(js._snapshot[1])
    vis = np.asarray(jmv.visibility_mask(cts, dts, js._snapshot[1]))
    want = table.filter(pa.array(vis)).to_pylist()
    got = batch.gather(torch.nonzero(batch.sel).reshape(-1)).to_arrow().to_pylist()
    key = lambda r: (r["id"], r["v"])     # noqa: E731
    assert n == want_n == 4 and len(batch) == table.num_rows
    assert sorted(got, key=key) == sorted(want, key=key)


# ---- GC ----------------------------------------------------------------------

def test_gc_never_reclaims_at_or_above_oldest_pin():
    js, ts = _sessions()
    reclaimed = {}
    for s in (js, ts):
        s.execute("SET SNAPSHOT = 'now'")
        pin = s._snapshot[1]
        w = _writer(s)
        for i in range(8):
            w.execute(f"UPDATE r SET v = v + 3 WHERE id = {i}")
        assert s.db.mvcc.snapshots.watermark(s.db.mvcc.tso.last_ts()) <= pin
        assert s.db.mvcc.gc(s.db.stores.values()) == 0
        s.execute("SET SNAPSHOT = 0")
        reclaimed[id(s)] = s.db.mvcc.gc(s.db.stores.values())
    assert reclaimed[id(ts)] == reclaimed[id(js)] == 8
    assert ts.db.stores["t.r"]._mvcc.history == []


def test_expired_pin_stops_holding_watermark():
    reg = tmv.SnapshotRegistry()
    reg.pin(1000, query="q")
    assert reg.watermark(5000) == 1000 and reg.oldest() == 1000
    both_flags("snapshot_max_age_s", 0.0)
    assert reg.watermark(5000) == 5000


def test_wedged_gc_failpoint_skips_one_sweep():
    js, ts = _sessions()
    for s in (js, ts):
        w = _writer(s)
        for i in range(8):
            w.execute(f"UPDATE r SET v = v + 3 WHERE id = {i}")
    both_flags("chaos_seed", 1)
    tfp.set_failpoint("mvcc.gc", "drop")
    assert ts.db.mvcc.gc(ts.db.stores.values()) == 0
    assert ts.db.stores["t.r"]._mvcc.history_rows() == 8
    tfp.clear_all()
    assert ts.db.mvcc.gc(ts.db.stores.values()) == 8


def test_pin_across_region_splits():
    """Inserts that split the table into new regions while a pin is held:
    the pinned aggregate stays what it was at the pin."""
    js, ts = _sessions(12)
    for s in (js, ts):
        s.db.stores["t.r"].region_rows = 4
        s.execute("SET SNAPSHOT = 'now'")
    base = check(ts, js, "SELECT SUM(v), COUNT(*) FROM r")
    for i in range(10):
        for s in (js, ts):
            _writer(s).execute(f"INSERT INTO r VALUES ({100 + i}, 1, 1)")
        assert check(ts, js, "SELECT SUM(v), COUNT(*) FROM r") == base
    assert len(ts.db.stores["t.r"].regions) == len(js.db.stores["t.r"].regions) > 4
    for s in (js, ts):
        s.execute("SET SNAPSHOT = 0")
    assert check(ts, js, "SELECT COUNT(*) AS c FROM r") == [{"c": 22}]


# ---- the whole slice -----------------------------------------------------------

SLICE_DATA_ROWS = 6000


def _slice_table(seed):
    rng = np.random.default_rng(seed)
    n = SLICE_DATA_ROWS
    return pa.table({"id": np.arange(n, dtype=np.int64),
                     "g": rng.integers(0, 2048, n).astype(np.int32),
                     "g16": rng.integers(0, 16, n).astype(np.int32),
                     "v": rng.standard_normal(n).astype(np.float32),
                     "w": rng.standard_normal(n),
                     "s": pa.array([f"s{i}" for i in rng.integers(0, 30, n)])})


# (statement, session: "a" reads pinned, "b" writes, rtol of a SELECT)
SLICE = [
    ("CREATE TABLE h (id BIGINT, g INT, g16 INT, v FLOAT, w DOUBLE, s VARCHAR(8), "
     "PRIMARY KEY (id), KEY ks (s))", "b", None),
    ("LOAD", "b", None),
    ("SET SNAPSHOT = 'now'", "a", None),
    ("SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM h WHERE v*2+1 > 0.5 "
     "GROUP BY g16 ORDER BY g16", "a", 1e-9),
    ("SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM h WHERE v*2+1 > 0.5 "
     "GROUP BY g ORDER BY g", "a", 1e-4),
    ("SELECT g, SUM(w), AVG(w) FROM h WHERE w > -1 GROUP BY g ORDER BY g", "a", 1e-4),
    ("BEGIN", "b", None),
    ("DELETE FROM h WHERE g16 = 5", "b", None),
    ("UPDATE h SET v = v + 1, w = w + 1 WHERE g16 = 7", "b", None),
    ("UPDATE h SET s = CONCAT(s, 'x') WHERE g < 100", "b", None),
    ("INSERT INTO h VALUES (90001, 3, 3, 0.5, 2.5, 'new'), (90002, 2047, 15, -1.5, 0.25, 's1')",
     "b", None),
    ("SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM h WHERE v*2+1 > 0.5 "
     "GROUP BY g16 ORDER BY g16", "a", 1e-9),
    ("COMMIT", "b", None),
    ("SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM h WHERE v*2+1 > 0.5 "
     "GROUP BY g16 ORDER BY g16", "a", 1e-9),
    ("SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM h WHERE v*2+1 > 0.5 "
     "GROUP BY g ORDER BY g", "a", 1e-4),
    ("SELECT g, SUM(w), AVG(w) FROM h WHERE w > -1 GROUP BY g ORDER BY g", "a", 1e-4),
    ("SELECT COUNT(*), SUM(w) FROM h WHERE s = 's4'", "a", 1e-9),
    ("SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM h WHERE v*2+1 > 0.5 "
     "GROUP BY g16 ORDER BY g16", "b", 1e-9),
    ("SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM h WHERE v*2+1 > 0.5 "
     "GROUP BY g ORDER BY g", "b", 1e-4),
    ("SELECT g, SUM(w), AVG(w) FROM h WHERE w > -1 GROUP BY g ORDER BY g", "b", 1e-4),
    ("SELECT COUNT(*), SUM(w) FROM h WHERE s = 's4x'", "b", 1e-9),
    ("BEGIN", "b", None),
    ("DELETE FROM h WHERE g < 1000", "b", None),
    ("ROLLBACK", "b", None),
    ("SELECT COUNT(*) FROM h", "b", 1e-9),
    ("SET SNAPSHOT = 0", "a", None),
    ("SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM h WHERE v*2+1 > 0.5 "
     "GROUP BY g ORDER BY g", "a", 1e-4),
    ("SELECT id, g, v, s FROM h WHERE id = 90001", "a", 1e-9),
]


def test_whole_slice_script_matches_jax(monkeypatch):
    """DDL, a bulk load, a pinned session, a writer's transaction (DELETE,
    UPDATE of floats and strings, INSERT), pinned and unpinned GROUP BYs at
    17 slots (the segment path) and 2049 slots (K1-K3's plain versions),
    a secondary-index read, a rolled-back transaction: statement by
    statement through both packages."""
    runs = []

    def counting(name):
        fn = getattr(gk, name)

        def wrapped(*a, **k):
            runs.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(gk, name, wrapped)
    for name in ("filtered_group_sum_plain", "fused_group_aggregate_plain",
                 "partition_histogram_plain"):
        if hasattr(gk, name):
            counting(name)
    data = _slice_table(9)
    jdb, tdb = JDatabase(), TDatabase("cpu")
    sess = {"a": (JSession(jdb), TSession(tdb)), "b": (JSession(jdb), TSession(tdb))}
    got = []
    for sql, who, rtol in SLICE:
        j, t = sess[who]
        if sql == "LOAD":
            j.load_arrow("h", data)
            t.load_arrow("h", data)
        elif rtol is None:
            rj, rt = j.execute(sql), t.execute(sql)
            assert rt.affected_rows == rj.affected_rows, sql
        else:
            got.append(t.query(sql))
            diff = mismatch(got[-1], j.query(sql), sql, rtol)
            assert diff is None, (sql, diff)
    assert runs, "the 2049-slot GROUP BYs did not reach the group kernels"
    # the pinned session read the same state before and after the commit,
    # the writer's session the committed one
    assert got[0] == got[3] == got[4] and got[1] == got[5] and got[2] == got[6]
    assert got[8] != got[4] and got[9] != got[5]


def test_pinned_group_by_over_strings_only_the_history_holds():
    """A pinned GROUP BY over a string the live rows no longer hold: the
    versioned batch's dictionary is the union of the live and the history
    dictionaries, and the planner sizes the dense domain from it.  The JAX
    package groups this wrong (ROADMAP.md §3), so the oracle is the rows as
    they were at the pin."""
    from baikaldb_tpu_torch.storage.column_store import _union_sorted

    a = np.asarray(["a", "c", "zz"])
    assert _union_sorted(a, np.asarray(["a", "zz"])) is a
    assert _union_sorted(a, np.asarray(["b", "zzz"])).tolist() == ["a", "b", "c", "zz", "zzz"]
    s = TSession(TDatabase("cpu"))
    s.execute("CREATE TABLE acct (id BIGINT, bal DOUBLE, name VARCHAR, k INT, PRIMARY KEY (id))")
    s.execute("INSERT INTO acct VALUES (1, 100.0, 'a', 1), (2, 200.0, 'b', 2), (3, 300.0, 'c', 3)")
    s.execute("SET SNAPSHOT = 'now'")
    w = TSession(s.db)
    w.execute("DELETE FROM acct WHERE name = 'c'")
    w.execute("UPDATE acct SET name = 'zz', k = k + 10 WHERE bal > 100")
    assert s.query("SELECT name, SUM(bal) s FROM acct GROUP BY name ORDER BY name") == \
        [{"name": "a", "s": 100.0}, {"name": "b", "s": 200.0}, {"name": "c", "s": 300.0}]
    assert s.query("SELECT k, COUNT(*) n FROM acct GROUP BY k ORDER BY k") == \
        [{"k": 1, "n": 1}, {"k": 2, "n": 1}, {"k": 3, "n": 1}]
    assert w.query("SELECT name, SUM(bal) s FROM acct GROUP BY name ORDER BY name") == \
        [{"name": "a", "s": 100.0}, {"name": "zz", "s": 200.0}]
