"""Pushed-down fragment dispatch of the port (exec/fragments.py and the
store daemons' ``fragment_execute``) against the JAX package's.

``tests/test_fragments.py``'s cases over the port's in-process daemons
(``baikaldb_tpu_torch.server``, port 0, a shared cold directory): pushed
rows equal the pulled image path's and the ``fragment_pushdown`` off-switch
is the identity; the artifact ladder warm-starts without compiling (disk
blob, then a peer's, then the inline ``need_frag`` resend, the only rung
that compiles); an ineligible plan bypasses dispatch; EXPLAIN ANALYZE's
``-- fragments:`` line and ``information_schema.fragments``; the store-side
subtrees of a plan; a join build side dispatched in rows mode; a split by
another frontend re-targets the dispatch; a region evicted to the cold tier
folds in place on its daemon.  The same inserts into a JAX cluster (its
own in-process daemons) give the same pushed rows, and its
``information_schema.fragments`` has the port's columns.
"""

import glob
import os
import re

import pytest

from baikaldb_tpu_torch.utils import metrics
from baikaldb_tpu_torch.utils.flags import FLAGS, set_flag

N = 300
DDL = ("CREATE TABLE t (id BIGINT NOT NULL, g BIGINT, name VARCHAR(16), "
       "v DOUBLE, w BIGINT, PRIMARY KEY (id))")


def _row(i):
    return (i, i % 5,
            "NULL" if i % 13 == 0 else f"'n{i % 4}'",
            "NULL" if i % 17 == 0 else i * 0.25,
            (i * 7) % 23)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.server.meta_server import MetaServer
    from baikaldb_tpu_torch.server.store_server import StoreServer

    root = tmp_path_factory.mktemp("frag")
    cold = str(root / "cold")       # shared FS: daemons fold what we flush
    meta = MetaServer("127.0.0.1:0")
    meta.start()
    meta_addr = f"127.0.0.1:{meta.rpc.port}"
    stores = []
    for sid in (1, 2, 3):
        st = StoreServer(sid, "127.0.0.1:0", meta_addr, tick_interval=0.02,
                         aot_dir=str(root / f"aot{sid}"), cold_dir=cold)
        st.address = f"127.0.0.1:{st.rpc.port}"
        st.start()
        stores.append(st)
    writer = Session(Database("cpu", cluster=meta_addr))
    writer.db.telemetry.stop()
    writer.execute(DDL)
    for lo in range(0, N, 100):
        vals = ", ".join("({}, {}, {}, {}, {})".format(*_row(i))
                         for i in range(lo, min(lo + 100, N)))
        writer.execute(f"INSERT INTO t VALUES {vals}")
    yield meta_addr, stores, cold
    for st in stores:
        st.stop()
    meta.stop()


@pytest.fixture(autouse=True)
def _push_flags():
    prev = {k: getattr(FLAGS, k) for k in ("pushdown_reads",
                                           "fragment_pushdown")}
    set_flag("pushdown_reads", "always")
    set_flag("fragment_pushdown", True)
    yield
    for k, v in prev.items():
        set_flag(k, v)


@pytest.fixture(scope="module")
def sess(cluster):
    from baikaldb_tpu_torch.exec.session import Database, Session

    meta_addr, _, _ = cluster
    s = Session(Database("cpu", cluster=meta_addr))
    s.db.telemetry.stop()
    s.execute(DDL)
    return s


def _pulled(s, q):
    set_flag("pushdown_reads", "off")
    try:
        return s.query(q)
    finally:
        set_flag("pushdown_reads", "always")


def _norm(rows):
    return [{k: round(v, 9) if isinstance(v, float) else v
             for k, v in r.items()} for r in rows]


def _daemon_count(stores, name):
    return sum(st.metrics.counter(name).value for st in stores)


QUERIES = [
    "SELECT g, COUNT(*) n, SUM(w) s, MIN(w) lo, MAX(w) hi FROM t "
    "GROUP BY g ORDER BY g",
    "SELECT g, SUM(v) s, AVG(v) a FROM t GROUP BY g ORDER BY g",
    "SELECT name, COUNT(*) n, COUNT(v) nv FROM t GROUP BY name "
    "ORDER BY name",
    "SELECT name, MIN(v) lo, MAX(v) hi FROM t WHERE g <> 2 "
    "GROUP BY name ORDER BY name",
    "SELECT COUNT(*) n, SUM(w) s FROM t WHERE id >= 100",
]


@pytest.mark.parametrize("q", QUERIES)
def test_pushed_matches_pulled(cluster, sess, q):
    d0 = metrics.fragments_dispatched.value
    pushed = sess.query(q)
    assert metrics.fragments_dispatched.value > d0, \
        "query did not take the pushed dispatch path"
    assert _norm(pushed) == _norm(_pulled(sess, q))


def test_off_switch_identity(cluster, sess):
    q = QUERIES[0]
    pushed = sess.query(q)
    set_flag("fragment_pushdown", False)
    d0 = metrics.fragments_dispatched.value
    serial = sess.query(q)          # v1 serial per-region loop
    assert metrics.fragments_dispatched.value == d0
    assert serial == pushed


def test_warm_start_zero_compiles(cluster, sess):
    _, stores, _ = cluster
    q = QUERIES[0]
    sess.query(q)                   # publish + first dispatch
    c0 = _daemon_count(stores, "fragment_warm_compiles")
    f0 = metrics.fragment_warm_compiles.value
    l0 = _daemon_count(stores, "fragment_warm_loads")
    sess.query(q)                   # re-dispatch: in-memory program
    # restart analog: programs gone, disk blobs survive
    for st in stores:
        st._frag_programs.clear()
    sess.query(q)
    assert _daemon_count(stores, "fragment_warm_compiles") == c0
    assert metrics.fragment_warm_compiles.value == f0
    assert _daemon_count(stores, "fragment_warm_loads") > l0


def test_peer_fetch_ladder(cluster, sess):
    """A daemon missing both warm rungs fetches the body from a PEER's
    blob tier — still no compile, no inline resend."""
    _, stores, _ = cluster
    q = QUERIES[0]
    sess.query(q)
    tier = sess.db.stores["default.t"].replicated
    leader = tier.regions[0].leader_addr
    victim = next(st for st in stores if st.address == leader)
    victim._frag_programs.clear()
    for f in glob.glob(os.path.join(str(victim._aot_fs.root), "frag_*")):
        os.unlink(f)
    c0 = _daemon_count(stores, "fragment_warm_compiles")
    p0 = _daemon_count(stores, "fragment_peer_fetches")
    assert _norm(sess.query(q)) == _norm(_pulled(sess, q))
    assert _daemon_count(stores, "fragment_warm_compiles") == c0
    assert _daemon_count(stores, "fragment_peer_fetches") > p0


def test_need_frag_inline_resend(cluster, sess):
    """Every warm source gone (all daemons restarted, blobs wiped): the
    leader answers ``need_frag`` and the body ships inline ONCE — the only
    rung that compiles."""
    _, stores, _ = cluster
    q = QUERIES[1]
    sess.query(q)
    for st in stores:
        st._frag_programs.clear()
        for f in glob.glob(os.path.join(str(st._aot_fs.root), "frag_*")):
            os.unlink(f)
    c0 = _daemon_count(stores, "fragment_warm_compiles")
    f0 = metrics.fragment_warm_compiles.value
    assert _norm(sess.query(q)) == _norm(_pulled(sess, q))
    assert metrics.fragment_warm_compiles.value > f0
    assert _daemon_count(stores, "fragment_warm_compiles") > c0


def test_ineligible_plan_bypasses_dispatch(cluster, sess):
    d0 = metrics.fragments_dispatched.value
    b0 = metrics.fragment_fallbacks.value
    got = sess.query("SELECT DISTINCT g FROM t ORDER BY g")
    assert got == [{"g": i} for i in range(5)]
    assert metrics.fragments_dispatched.value == d0
    # bypass is not a fallback: nothing was dispatched, nothing failed
    assert metrics.fragment_fallbacks.value == b0


def test_explain_analyze_and_info_schema(cluster, sess):
    out = sess.query("EXPLAIN ANALYZE " + QUERIES[0])
    text = "\n".join(r[next(iter(r))] for r in out)
    m = re.search(r"-- fragments: dispatched=(\d+) local=(\d+) "
                  r"retargeted=(\d+) partial_rows=(\d+) bytes_saved=(\d+)",
                  text)
    assert m, text
    assert int(m.group(1)) >= 1 and int(m.group(4)) >= 1
    rows = sess.query("SELECT frag_key, table_name, mode, dispatched, "
                      "scanned, status FROM information_schema.fragments")
    ok = [r for r in rows if r["status"] == "ok"]
    assert ok and ok[-1]["table_name"] == "default.t"
    assert ok[-1]["scanned"] == N and ok[-1]["mode"] == "agg"


def test_fragment_subtrees_recognition():
    """plan/distribute.fragment_subtrees on embedded physical plans: the
    agg subtree and a join BUILD side are store-sliceable; DISTINCT aggs
    and derived inputs are not."""
    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.plan.distribute import fragment_subtrees
    from baikaldb_tpu_torch.sql.parser import parse_sql

    s = Session(device="cpu")
    s.execute(DDL)
    s.execute("INSERT INTO t VALUES " +
              ", ".join("({}, {}, {}, {}, {})".format(*_row(i))
                        for i in range(40)))

    def subs(sql):
        return fragment_subtrees(s._plan_select(parse_sql(sql)[0]))

    ag = subs("SELECT g, SUM(w) s, COUNT(*) n FROM t WHERE w < 9 "
              "GROUP BY g")
    assert [x["role"] for x in ag] == ["agg"]
    assert ag[0]["table_key"] == "default.t"
    frag = ag[0]["frag"]
    assert frag["mode"] == "agg" and frag["filter"] is not None
    assert sorted(a[0] for a in frag["aggs"]) == ["count_star", "sum"]

    jb = subs("SELECT a.id FROM t a JOIN t b ON a.g = b.g "
              "WHERE b.w < 5")
    roles = [x["role"] for x in jb]
    assert "join_build" in roles
    build = next(x for x in jb if x["role"] == "join_build")
    assert build["frag"]["mode"] == "rows"

    assert not subs("SELECT g, COUNT(DISTINCT w) FROM t GROUP BY g")


def test_join_build_fragment_dispatch(cluster, sess):
    """A recognized join build-side fragment (rows mode) dispatched over
    the daemon plane returns exactly the filtered build rows."""
    from baikaldb_tpu_torch.exec.fragments import dispatch_fragments
    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.expr.roweval import val_from_wire
    from baikaldb_tpu_torch.plan.distribute import fragment_subtrees
    from baikaldb_tpu_torch.sql.parser import parse_sql

    emb = Session(device="cpu")
    emb.execute(DDL)
    emb.execute("INSERT INTO t VALUES (0, 0, 'x', 0.0, 0)")
    plan = emb._plan_select(parse_sql(
        "SELECT a.id FROM t a JOIN t b ON a.g = b.g WHERE b.w < 5")[0])
    build = next(x for x in fragment_subtrees(plan)
                 if x["role"] == "join_build")
    frag = build["frag"]

    tier = sess.db.stores["default.t"].replicated
    payloads, stats = dispatch_fragments(tier, frag)
    names = [n for n, _ in frag["outputs"]]
    wi = next(i for i, n in enumerate(names) if n.split(".")[-1] == "w")
    got = []
    for p in payloads:
        assert p["mode"] == "rows"
        for r in p["rows"]:
            vals = [val_from_wire(x) for x in r]
            assert vals[wi] < 5
            got.append(vals[wi])
    want = [(i * 7) % 23 for i in range(N) if (i * 7) % 23 < 5]
    assert sorted(got) == sorted(want)
    assert stats["dispatched"] == len(payloads) >= 1
    assert stats["scanned"] == N


def test_retarget_after_split(cluster, sess):
    """ANOTHER frontend live-splits the region; this frontend's next
    dispatch discovers it mid-flight, re-slices over both children, and
    still folds every row exactly once."""
    from baikaldb_tpu_torch.exec.fragments import recent_dispatches
    from baikaldb_tpu_torch.exec.session import Database, Session

    q = QUERIES[0]
    want = _norm(sess.query(q))     # primes (stale-to-be) routing
    other = Session(Database("cpu", cluster=cluster[0]))
    other.db.telemetry.stop()
    other.execute(DDL)
    other.db.stores["default.t"].replicated.split_region(0)
    r0 = metrics.fragment_retargets.value
    assert _norm(sess.query(q)) == want
    assert metrics.fragment_retargets.value > r0
    last = recent_dispatches()[-1]
    assert last["status"] == "ok" and last["dispatched"] >= 2
    assert last["retargeted"] >= 1 and last["scanned"] == N


def test_cold_region_folds_in_place(cluster):
    """After rows evict to the cold tier, the owning daemon folds its own
    cold segments (the hot-over-cold discipline, store-side): payloads
    come back ``cold``-marked and results stay identical."""
    from baikaldb_tpu_torch.exec.fragments import recent_dispatches
    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.storage.coldfs import ExternalFS

    meta_addr, stores, cold_dir = cluster
    s = Session(Database("cpu", cluster=meta_addr, cold_dir=cold_dir))
    s.db.telemetry.stop()
    s.execute(DDL)
    tier = s.db.stores["default.t"].replicated
    assert tier.flush_cold(ExternalFS(cold_dir)) > 0
    q = QUERIES[0]
    pushed = s.query(q)
    last = recent_dispatches()[-1]
    assert last["status"] == "ok" and last["local"] >= 1
    assert last["scanned"] == N     # hot leftovers + cold, exactly once
    assert _norm(pushed) == _norm(_pulled(s, q))


# -- against the JAX package's cluster --------------------------------------

@pytest.fixture(scope="module")
def jax_cluster():
    """The JAX package's in-process daemons and a frontend over the same
    inserts, pushing every eligible SELECT."""
    from baikaldb_tpu.exec.session import Database as JDatabase
    from baikaldb_tpu.exec.session import Session as JSession
    from baikaldb_tpu.server.meta_server import MetaServer as JMeta
    from baikaldb_tpu.server.store_server import StoreServer as JStore

    meta = JMeta("127.0.0.1:0")
    meta.start()
    meta_addr = f"127.0.0.1:{meta.rpc.port}"
    stores = []
    for sid in (1, 2, 3):
        st = JStore(sid, "127.0.0.1:0", meta_addr, tick_interval=0.02)
        st.address = f"127.0.0.1:{st.rpc.port}"
        st.start()
        stores.append(st)
    s = JSession(JDatabase(cluster=meta_addr))
    s.db.telemetry.stop()
    s.execute(DDL)
    for lo in range(0, N, 100):
        vals = ", ".join("({}, {}, {}, {}, {})".format(*_row(i))
                         for i in range(lo, min(lo + 100, N)))
        s.execute(f"INSERT INTO t VALUES {vals}")
    yield s
    s.db.close()
    for st in stores:
        st.stop()
    meta.stop()


@pytest.fixture
def _jax_push():
    from baikaldb_tpu.utils.flags import FLAGS as JFLAGS
    from baikaldb_tpu.utils.flags import set_flag as jset

    prev = JFLAGS.pushdown_reads
    jset("pushdown_reads", "always")
    yield
    jset("pushdown_reads", prev)


@pytest.mark.parametrize("q", QUERIES)
def test_pushed_rows_equal_jax_cluster(cluster, sess, jax_cluster, _jax_push, q):
    from baikaldb_tpu.utils import metrics as jmetrics

    d0 = jmetrics.fragments_dispatched.value
    want = jax_cluster.query(q)
    assert jmetrics.fragments_dispatched.value > d0
    assert _norm(sess.query(q)) == _norm(want)


def test_fragments_info_schema_columns_match_jax(cluster, sess, jax_cluster, _jax_push):
    jax_cluster.query(QUERIES[0])
    sess.query(QUERIES[0])
    q = "SELECT * FROM information_schema.fragments"
    jrows, trows = jax_cluster.query(q), sess.query(q)
    assert list(trows[-1]) == list(jrows[-1])
    # the region count (and so dispatched / partial_rows) is each cluster's
    # own: the port's has been split by test_retarget_after_split
    keep = ("table_name", "mode", "scanned", "status")
    assert {k: trows[-1][k] for k in keep} == {k: jrows[-1][k] for k in keep}
    # the same fragment body: the same content key in both packages
    assert trows[-1]["frag_key"] == jrows[-1]["frag_key"]
