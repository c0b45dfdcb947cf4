"""The port's ANN access path (index/annindex.py through Session.query)
against the JAX package's: every case of tests/test_ann_sql.py, on the same
seeded data through both sessions.

The IVF candidates come from numpy in both packages (``ivf_search_host``);
k-means trains on the store's device (the CPU here).  Rows are compared
with the JAX session's exactly on the clustered data, and recall@10 against
the exact answer must reach 0.95.
"""

import numpy as np
import pytest

from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.index import annindex as jann  # noqa: F401 — registers ann flags
from baikaldb_tpu.utils.flags import FLAGS as JFLAGS
from baikaldb_tpu.utils.flags import set_flag as jset_flag
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.index import annindex as tann
from baikaldb_tpu_torch.utils import metrics as tmetrics
from baikaldb_tpu_torch.utils.flags import FLAGS as TFLAGS
from baikaldb_tpu_torch.utils.flags import set_flag as tset_flag


@pytest.fixture(autouse=True)
def small_ann_threshold():
    prev = (int(JFLAGS.ann_min_rows), int(TFLAGS.ann_min_rows))
    jset_flag("ann_min_rows", 512)
    tset_flag("ann_min_rows", 512)
    yield
    jset_flag("ann_min_rows", prev[0])
    tset_flag("ann_min_rows", prev[1])


def _vec_lit(v):
    return "[" + ",".join(f"{x:.5f}" for x in v) + "]"


def _load(s, vecs, table="vt"):
    for i in range(0, len(vecs), 400):
        vals = ", ".join(f"({j}, '{_vec_lit(vecs[j])}')"
                         for j in range(i, min(i + 400, len(vecs))))
        s.execute(f"INSERT INTO {table} VALUES {vals}")


def _sessions(ddl, vecs=None):
    out = []
    for s in (JSession(JDatabase()), TSession(TDatabase("cpu"))):
        s.execute(ddl)
        if vecs is not None:
            _load(s, vecs)
        out.append(s)
    return out


def _ids(s, sql):
    return [r["id"] for r in s.query(sql)]


def _plan(s, sql):
    return s.execute("EXPLAIN " + sql).plan_text


def test_ann_ddl_and_explain_match_jax():
    js, ts = _sessions("CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX av (v))")
    info = ts.db.catalog.get_table("default", "vt")
    assert any(ix.kind == "ann" and ix.columns == ["v"] for ix in info.indexes)
    sql = "SELECT id FROM vt ORDER BY l2_distance(v, '[0,0,0,0]') LIMIT 3"
    for step, want in ((None, "ann(av nprobe=8)"), ("ALTER TABLE vt DROP INDEX av", None),
                       ("ALTER TABLE vt ADD ANN INDEX av2 (v)", "ann(av2 nprobe=8)")):
        if step:
            js.execute(step)
            ts.execute(step)
        plan = _plan(ts, sql)
        assert plan == _plan(js, sql)
        assert (want in plan) if want else ("ann(" not in plan)
        assert ts.query("SHOW INDEX FROM vt") == js.query("SHOW INDEX FROM vt")
        assert ts.query("SHOW CREATE TABLE vt") == js.query("SHOW CREATE TABLE vt")
    for s in (js, ts):
        with pytest.raises(Exception):
            s.execute("ALTER TABLE vt ADD ANN INDEX bad (id)")   # not a vector
        with pytest.raises(Exception, match="exists"):
            s.execute("ALTER TABLE vt ADD ANN INDEX av2 (v)")
        with pytest.raises(Exception, match="unknown index"):
            s.execute("ALTER TABLE vt DROP INDEX nope")
    # the index is named after its column when the statement names none
    js.execute("ALTER TABLE vt ADD ANN INDEX (v)")
    ts.execute("ALTER TABLE vt ADD ANN INDEX (v)")
    assert ts.query("SHOW INDEX FROM vt") == js.query("SHOW INDEX FROM vt")


@pytest.mark.parametrize("lit", ["1 2 3 4", "[1 2 3 4]", "1,2,3,4"])
def test_ann_matcher_reads_the_reference_literal_grammar(lit):
    """The matcher takes brackets with commas, as the JAX package's does:
    other forms of a query vector (which INSERT and the distance functions
    read in both packages) run the exact scan, with no ``ann(`` line, and
    give the JAX session's rows."""
    rng = np.random.RandomState(3)
    vecs = rng.randn(1500, 4).astype(np.float32)
    js, ts = _sessions("CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX a (v))", vecs)
    assert tann.parse_vec_literal(lit, 4) is None
    assert tann.parse_vec_literal("[1,2,3,4]", 4) == (1.0, 2.0, 3.0, 4.0)
    sql = f"SELECT id FROM vt ORDER BY l2_distance(v, '{lit}') LIMIT 5"
    plan = _plan(ts, sql)
    assert plan == _plan(js, sql) and "ann(" not in plan
    assert _ids(ts, sql) == _ids(js, sql)
    exact = np.argsort(((vecs - np.arange(1, 5, dtype=np.float32)) ** 2).sum(1),
                       kind="stable")[:5]
    assert _ids(ts, sql) == exact.tolist()


def test_other_index_and_alter_forms_still_raise():
    """Online ADD INDEX on a vector table (its backfill worker) gives the
    JAX session's work record, index state and access path; ADD / DROP
    COLUMN, KEY indexes in CREATE TABLE and AUTO_INCREMENT are in
    tests/test_torch_dml.py, global indexes and partitions in
    ``test_vector_tables_with_global_indexes_and_partitions_match_jax``."""
    vecs = np.random.RandomState(4).randn(600, 4).astype(np.float32)
    js, ts = _sessions("CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX av (v))", vecs)
    recs = []
    for s in (js, ts):
        wid = s.execute("ALTER TABLE vt ADD INDEX k (id)").to_pylist()[0]["work_id"]
        w = s.db.ddl.wait(wid, 30.0)
        ix = next(i for i in s.db.catalog.get_table("default", "vt").indexes if i.name == "k")
        recs.append((wid, w.state, w.error, w.regions_done, ix.params.get("state")))
    assert recs[1] == recs[0] and recs[1][1] == "public"
    sql = "SELECT id FROM vt WHERE id = 17"
    assert _plan(ts, sql) == _plan(js, sql) and "index(k:id)" in _plan(ts, sql)
    assert _ids(ts, sql) == _ids(js, sql) == [17]


@pytest.mark.parametrize("ddl", [
    "CREATE TABLE vt (id BIGINT, v VECTOR(4), PRIMARY KEY (id), GLOBAL INDEX g (id))",
    "CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX av (v)) PARTITION BY HASH (id) "
    "PARTITIONS 2",
    "CREATE TABLE vt (id BIGINT, v VECTOR(4), PRIMARY KEY (id), ANN INDEX av (v)) "
    "PARTITION BY RANGE (id) (PARTITION p0 VALUES LESS THAN (600), "
    "PARTITION p1 VALUES LESS THAN MAXVALUE)",
])
def test_vector_tables_with_global_indexes_and_partitions_match_jax(ddl):
    """The GLOBAL INDEX and PARTITION BY statements over a VECTOR table,
    as parity cases: the same rows (exact top-k ids, a pruned or an
    index-routed point select) and EXPLAIN as the JAX session."""
    rng = np.random.RandomState(5)
    vecs = rng.randn(1200, 4).astype(np.float32)
    js, ts = _sessions(ddl, vecs)
    q = _vec_lit(vecs[17] + 0.01)
    for sql in (f"SELECT id FROM vt ORDER BY l2_distance(v, '{q}') LIMIT 5",
                f"SELECT id FROM vt WHERE id < 300 ORDER BY l2_distance(v, '{q}') LIMIT 5",
                "SELECT id FROM vt WHERE id = 17"):
        assert _plan(ts, sql) == _plan(js, sql)
        assert ts.query(sql) == js.query(sql)
    assert js.query("SHOW CREATE TABLE vt") == ts.query("SHOW CREATE TABLE vt")


def test_ann_recall_and_rows_match_jax():
    """recall@10 >= 0.95 against the exact answer over clustered data, and
    the rows of the JAX session."""
    rng = np.random.RandomState(11)
    centers = rng.randn(32, 16) * 4
    vecs = (centers[rng.randint(0, 32, 8000)]
            + rng.randn(8000, 16) * 0.5).astype(np.float32)
    js, ts = _sessions("CREATE TABLE vt (id BIGINT, v VECTOR(16), ANN INDEX a (v))", vecs)
    hits = total = 0
    for qi in rng.randint(0, len(vecs), 12):
        q = vecs[qi] + rng.randn(16).astype(np.float32) * 0.05
        sql = f"SELECT id FROM vt ORDER BY l2_distance(v, '{_vec_lit(q)}') LIMIT 10"
        got = _ids(ts, sql)
        assert got == _ids(js, sql)
        exact = set(np.argsort(((vecs - q) ** 2).sum(1))[:10].tolist())
        hits += len(set(got) & exact)
        total += 10
    assert hits / total >= 0.95, f"recall {hits / total}"
    # a repeated statement reduces again, to the same rows
    scans = tmetrics.index_scans.value
    assert _ids(ts, sql) == got and tmetrics.index_scans.value == scans + 1
    plan = ts.execute("EXPLAIN SELECT id, l2_distance(v, '[0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0]') d "
                      "FROM vt ORDER BY d LIMIT 5").plan_text
    assert "ann(" not in plan               # ORDER BY an alias is not the ANN shape
    # one query vector under each metric in turn: the candidates of one
    # metric are never served to another
    for metric, order in (("l2_distance", ""), ("cosine_distance", ""),
                          ("inner_product", " DESC"), ("l2_distance", "")):
        sql = (f"SELECT id FROM vt ORDER BY {metric}(v, '{_vec_lit(vecs[5])}'){order} "
               "LIMIT 10")
        assert "ann(a" in _plan(ts, sql)
        assert _ids(ts, sql) == _ids(js, sql)


def test_ann_sees_new_rows_and_null_vectors():
    """New rows are searchable without an explicit rebuild: within
    ann_rebuild_drift they are assigned to the kept centroids, past it
    k-means retrains; NULL vectors are invalid rows."""
    rng = np.random.RandomState(5)
    vecs = rng.randn(1500, 4).astype(np.float32)
    js, ts = _sessions("CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX a (v))", vecs)
    q = vecs[7]
    sql = f"SELECT id FROM vt ORDER BY l2_distance(v, '{_vec_lit(q)}') LIMIT 3"
    assert _ids(ts, sql) == _ids(js, sql)
    assert _ids(ts, sql)[0] == 7
    st = tann.manager(ts.db)._states[("default.vt", "v")]
    built = st.centroids.copy()
    for s in (js, ts):
        s.execute(f"INSERT INTO vt VALUES (9001, '{_vec_lit(q)}'), (9002, NULL)")
    assert _ids(ts, sql) == _ids(js, sql)
    assert set(_ids(ts, sql)[:2]) == {7, 9001}          # equal vectors
    assert np.array_equal(st.centroids, built) and st.built_rows == 1500
    assert not st.valid[np.nonzero(st.order == 1501)[0][0]]      # the NULL row
    # TRUNCATE and a reload of another size past the drift: retrained
    more = rng.randn(2000, 4).astype(np.float32)
    for s in (js, ts):
        s.execute("TRUNCATE TABLE vt")
        _load(s, more)
    q2 = more[11]
    sql2 = f"SELECT id FROM vt ORDER BY l2_distance(v, '{_vec_lit(q2)}') LIMIT 3"
    assert _ids(ts, sql2) == _ids(js, sql2)
    assert _ids(ts, sql2)[0] == 11
    assert st.built_rows == 2000 and not np.array_equal(st.centroids, built)


def test_ann_sees_deletes():
    """The DELETE half of the JAX package's test_ann_sees_deletes_and_new_rows:
    a deleted row leaves the ANN answer at once, in both packages."""
    rng = np.random.RandomState(5)
    vecs = rng.randn(1500, 4).astype(np.float32)
    js, ts = _sessions("CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX a (v))", vecs)
    sql = f"SELECT id FROM vt ORDER BY l2_distance(v, '{_vec_lit(vecs[7])}') LIMIT 3"
    assert _ids(ts, sql)[0] == 7
    for s in (js, ts):
        assert s.execute("DELETE FROM vt WHERE id = 7").affected_rows == 1
    got = _ids(ts, sql)
    assert 7 not in got and got == _ids(js, sql)
    assert "ann(a" in _plan(ts, sql)


def test_ann_where_filter_composes():
    rng = np.random.RandomState(9)
    vecs = rng.randn(2000, 4).astype(np.float32)
    js, ts = _sessions("CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX a (v))", vecs)
    sql = (f"SELECT id FROM vt WHERE id >= 1000 ORDER BY "
           f"l2_distance(v, '{_vec_lit(vecs[42])}') LIMIT 5")
    got = _ids(ts, sql)
    assert got == _ids(js, sql)
    assert all(i >= 1000 for i in got) and len(got) == 5


def test_ann_selective_where_still_fills_limit():
    """A HIGHLY selective WHERE (1% of rows) must not return fewer than
    LIMIT rows: the pool widens by ann_where_widen, and when the widened
    pool approaches the table the exact scan runs."""
    rng = np.random.RandomState(17)
    vecs = rng.randn(1000, 4).astype(np.float32)
    js, ts = _sessions("CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX a (v))", vecs)
    q = vecs[5]
    sql = (f"SELECT id FROM vt WHERE id >= 990 ORDER BY "
           f"l2_distance(v, '{_vec_lit(q)}') LIMIT 8")
    got = _ids(ts, sql)
    assert got == _ids(js, sql)
    d = ((vecs[990:] - q) ** 2).sum(axis=1)
    assert got == [990 + int(i) for i in np.argsort(d, kind="stable")[:8]]


def test_ann_small_table_falls_back_to_brute_force():
    tset_flag("ann_min_rows", 4096)
    jset_flag("ann_min_rows", 4096)
    rng = np.random.RandomState(2)
    vecs = rng.randn(600, 4).astype(np.float32)
    js, ts = _sessions("CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX a (v))", vecs)
    sql = f"SELECT id FROM vt ORDER BY l2_distance(v, '{_vec_lit(vecs[3])}') LIMIT 3"
    got = _ids(ts, sql)
    assert got == _ids(js, sql) and got[0] == 3
    assert tann.manager(ts.db)._states[("default.vt", "v")].matrix is None


def test_window_functions_block_ann_reduction():
    js, ts = _sessions("CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX a (v))")
    for s in (js, ts):
        s.execute("INSERT INTO vt VALUES (1, '[0,0,0,1]'), (2, '[0,0,1,0]')")
    sql = ("SELECT id, COUNT(*) OVER () n FROM vt ORDER BY "
           "l2_distance(v, '[0,0,0,0]') LIMIT 1")
    assert "ann(" not in _plan(ts, sql)
    assert ts.query(sql) == js.query(sql)


@pytest.mark.parametrize("sql", [
    "SELECT id FROM vt ORDER BY l2_distance(v, '[0,0,0,0]') DESC LIMIT 3",
    "SELECT id FROM vt ORDER BY l2_distance(v, '[0,0,0,0]')",
    "SELECT id FROM vt ORDER BY inner_product(v, '[0,0,0,0]') LIMIT 3",
    "SELECT DISTINCT id FROM vt ORDER BY id LIMIT 3",
    "SELECT id FROM vt ORDER BY l2_distance(v, '[0,0,0,0]'), id LIMIT 3",
], ids=["desc", "no_limit", "ip_asc", "distinct", "two_keys"])
def test_ann_not_used_for_wrong_shapes(sql):
    js, ts = _sessions("CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX a (v))")
    for s in (js, ts):
        s.execute("INSERT INTO vt VALUES (1, '[0,0,0,1]')")
    plan = _plan(ts, sql)
    assert "ann(" not in plan and plan == _plan(js, sql)
    assert ts.query(sql) == js.query(sql)


def test_drop_table_forgets_the_trained_state():
    """DROP TABLE forgets the trained index, and a table created again
    under the same name, loaded with as many INSERTs (so at the same store
    version), answers the same statement from its own rows."""
    rng = np.random.RandomState(3)
    s = TSession(TDatabase("cpu"))
    vecs = rng.randn(800, 4).astype(np.float32)
    sql = f"SELECT id FROM vt ORDER BY l2_distance(v, '{_vec_lit(vecs[9])}') LIMIT 1"
    s.execute("CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX a (v))")
    _load(s, vecs)
    assert _ids(s, sql) == [9] and "ann(a" in _plan(s, sql)
    version = s.db.stores["default.vt"].version
    assert ("default.vt", "v") in tann.manager(s.db)._states
    s.execute("DROP TABLE vt")
    assert ("default.vt", "v") not in tann.manager(s.db)._states
    s.execute("CREATE TABLE vt (id BIGINT, v VECTOR(4), ANN INDEX a (v))")
    _load(s, vecs[::-1].copy())
    assert s.db.stores["default.vt"].version == version
    assert _ids(s, sql) == [len(vecs) - 1 - 9]
