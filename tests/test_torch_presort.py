"""The host presort permutations in the port against the JAX package.

The planner marks a join's build side, an EXISTS-with-<> build or a sorted
GROUP BY over a whole table (``presort``); the session stages the store's
host permutation of the keys as a ``__presort__`` batch, and the operator
skips its device sort.  Here: the permutations equal the JAX store's on the
same data; the presort engages where the JAX session engages it and only
under its guards (no pinned batch, no write between capture and presort);
a batched dispatcher member runs inline and equals its serial run; and rows
equal both a run with the permutations stripped and the JAX session.
"""

import threading

import numpy as np
import pyarrow as pa
import pytest

from baikaldb_tpu.exec.session import Database as JDatabase, Session as JSession
from baikaldb_tpu.utils.flags import FLAGS as JFLAGS
from baikaldb_tpu_torch.exec import dispatch
from baikaldb_tpu_torch.exec.session import Database as TDatabase, Session as TSession
from baikaldb_tpu_torch.models import tpch
from baikaldb_tpu_torch.models.parity import mismatch
from baikaldb_tpu_torch.utils.flags import FLAGS as TFLAGS

Q_EXISTS = ("SELECT COUNT(*) c FROM l1 a WHERE flag = 1 AND EXISTS ("
            "SELECT 1 FROM l1 b WHERE b.ok = a.ok AND b.sk <> a.sk)")
Q_AGG = ("SELECT ok, sk, SUM(qty) s, COUNT(*) c FROM l1 "
         "WHERE flag = 1 GROUP BY ok, sk ORDER BY ok, sk")


def _l1(n=2000, seed=3):
    rng = np.random.default_rng(seed)
    # spans force the sorted GROUP BY (the product is past the dense cap)
    return pa.table({"ok": pa.array(rng.integers(1, 200_000, n), pa.int32()),
                     "sk": pa.array(rng.integers(1, 1000, n), pa.int32()),
                     "qty": rng.integers(1, 50, n).astype(np.float64),
                     "flag": rng.integers(0, 2, n).astype(np.int64)})


def _sessions(n=2000):
    j, t = JSession(JDatabase()), TSession(TDatabase("cpu"))
    for s in (j, t):
        s.execute("CREATE TABLE l1 (ok INT, sk INT, qty DOUBLE, flag BIGINT)")
        s.load_arrow("l1", _l1(n))
    return j, t


def _presorts(sess, sql) -> list[str]:
    """The __presort__ batches a statement stages when it runs."""
    seen = []
    orig = sess._collect_batches

    def spy(plan):
        out = orig(plan)
        seen.extend(k for k in out[0] if str(k).startswith("__presort__"))
        return out
    sess._collect_batches = spy
    try:
        sess.query(sql)
    finally:
        del sess._collect_batches
    return sorted(seen)


def _stripped(db):
    """A session over ``db`` whose batches never carry a presort: the JAX
    package's own way to turn it off (tests/test_ops.py)."""
    s = TSession(db)
    orig = s._collect_batches

    def no_presort(plan):
        b, k, full = orig(plan)
        return {kk: v for kk, v in b.items() if not str(kk).startswith("__presort__")}, k, full
    s._collect_batches = no_presort
    return s


def test_presort_engages_and_matches_the_stripped_run_and_jax():
    j, t = _sessions()
    for q in (Q_EXISTS, Q_AGG):
        assert _presorts(t, q) == _presorts(j, q) != []
    got = (t.query(Q_EXISTS), t.query(Q_AGG))
    off = _stripped(t.db)
    assert got == (off.query(Q_EXISTS), off.query(Q_AGG))
    assert got == (j.query(Q_EXISTS), j.query(Q_AGG))
    # a write moves the version: the permutations rebuild, rows stay right
    for s in (j, t):
        s.execute("INSERT INTO l1 VALUES (1, 19, 5.0, 1)")
        s.execute("UPDATE l1 SET sk = 7 WHERE ok = 3")
    assert t.query(Q_AGG) == off.query(Q_AGG) == j.query(Q_AGG)
    assert t.query(Q_EXISTS) == off.query(Q_EXISTS) == j.query(Q_EXISTS)


@pytest.fixture
def no_bucketing():
    """The JAX store pads its device batch to a capacity bucket; the port's
    is never padded, so the permutations compare over unpadded batches."""
    saved = JFLAGS.get("batch_bucketing")
    JFLAGS.set_flag("batch_bucketing", "0")
    yield
    JFLAGS.set_flag("batch_bucketing", str(saved))


@pytest.mark.parametrize("cols", [("ok",), ("ok", "sk"), ("sk", "ok"), ("flag", "sk")])
def test_sort_permutations_equal_the_jax_stores(no_bucketing, cols):
    j, t = _sessions()
    for s in (j, t):
        s.execute("INSERT INTO l1 VALUES (NULL, 4, 1.0, 1), (17, NULL, 2.0, 0), "
                  "(NULL, NULL, 3.0, 1)")
    js, ts = j.db.stores["default.l1"], t.db.stores["default.l1"]
    for name in ("sort_permutation", "agg_sort_permutation"):
        want = np.asarray(getattr(js, name)(cols))
        got = getattr(ts, name)(cols)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        # cached per version, and the device copy is the same permutation
        assert getattr(ts, name)(cols) is got
        kind = "join" if name == "sort_permutation" else "agg"
        np.testing.assert_array_equal(ts.presort_order(kind, cols, ts.version).numpy(), got)


def test_a_write_between_capture_and_presort_means_no_presort():
    _, t = _sessions()
    st = t.db.stores["default.l1"]
    orig = st.sort_permutation
    fired = []

    def write_first(cols):
        if not fired:
            fired.append(1)
            # another writer lands after the scan captured its version
            TSession(t.db).execute("INSERT INTO l1 VALUES (5, 5, 5.0, 1)")
        return orig(cols)
    st.sort_permutation = write_first
    try:
        staged = _presorts(t, Q_EXISTS)
    finally:
        st.sort_permutation = orig
    assert fired and staged == []
    assert st.presort_order("join", ("ok", "sk"), st.version - 1) is None
    assert t.query(Q_EXISTS) == _stripped(t.db).query(Q_EXISTS)


def test_a_pinned_batch_never_takes_the_live_images_permutation():
    j, t = _sessions()
    for s in (j, t):
        s.execute("SET SNAPSHOT = 'now'")
    for s in (JSession(j.db), TSession(t.db)):
        s.execute("UPDATE l1 SET sk = sk + 1 WHERE flag = 1")
        s.execute("DELETE FROM l1 WHERE ok < 50000")
    # the pinned reads stage versioned batches: no presort in either package
    assert _presorts(t, Q_AGG) == _presorts(j, Q_AGG) == []
    pinned = (t.query(Q_AGG), t.query(Q_EXISTS))
    assert pinned == (j.query(Q_AGG), j.query(Q_EXISTS))
    for s in (j, t):
        s.execute("SET SNAPSHOT = 0")
    # released: the live image and its permutation
    assert _presorts(t, Q_AGG) != []
    assert t.query(Q_AGG) == j.query(Q_AGG) != pinned[0]


def test_dispatcher_clients_over_a_presorted_shape_equal_their_serial_runs():
    """Parameterized clients of one presorted shape: the dispatcher never
    batches them (the permutation is per-plan-object state), each runs
    inline and gets its serial rows."""
    _, t = _sessions(3000)
    saved = TFLAGS.get("batch_dispatch_tick_ms")
    TFLAGS.set_flag("batch_dispatch_tick_ms", "40")
    sql = ("SELECT ok, sk, SUM(qty) s, COUNT(*) c FROM l1 WHERE flag = {} "
           "GROUP BY ok, sk ORDER BY ok, sk")
    serial = {i: TSession(t.db).query(sql.format(i % 2)) for i in range(8)}
    assert _presorts(t, sql.format(1)) != []
    groups0 = dispatch.metrics.batched_groups.value
    got, barrier = {}, threading.Barrier(8)

    def client(i):
        s = TSession(t.db)
        barrier.wait()
        got[i] = s.query(sql.format(i % 2))
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        TFLAGS.set_flag("batch_dispatch_tick_ms", str(saved))
    assert got == serial
    assert dispatch.metrics.batched_groups.value == groups0


# -- TPC-H with the presort engaged --------------------------------------------

@pytest.fixture(scope="module")
def tpch_pair():
    tables = tpch.generate(scale=0.002, seed=7)
    sessions = [JSession(), TSession(device="cpu")]
    for s in sessions:
        for name, ddl in tpch.DDL.items():
            s.execute(ddl)
            s.load_arrow(name, tables[name])
    return sessions


@pytest.mark.parametrize("name", ["q3", "q10", "q18", "q21"])
def test_tpch_with_the_presort_matches_jax(tpch_pair, name):
    j, t = tpch_pair
    sql = tpch.QUERIES[name]
    staged = _presorts(t, sql)
    assert staged == _presorts(j, sql)
    if name == "q21":
        assert staged, f"{name} stages no presort"
    got = t.query(sql)
    # the kernels' float32 sums of q18's inner GROUP BY: rtol 1e-4
    diff = mismatch(got, j.query(sql), sql, 1e-4)
    assert diff is None, diff
    assert mismatch(got, _stripped(t.db).query(sql), sql, 1e-9) is None
