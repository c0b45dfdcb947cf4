"""The port's 8-shard CPU mesh against the JAX package's 8-device CPU mesh.

The same inputs (seeded numpy, the seeds of tests/test_parallel.py and the
tables of tests/test_dist_sql.py) go through ``baikaldb_tpu.parallel`` over
``make_mesh(8)`` (8 virtual CPU devices, tests/conftest.py) and through
``baikaldb_tpu_torch.parallel`` over ``make_mesh(8, device="cpu")``:

- the distributed kernels: every shard holds the JAX shard's live rows (a
  repartition keeps their order too); joins and group-bys give the same
  rows;
- every SQL shape of tests/test_dist_sql.py through ``Session(mesh=...)``:
  the rows agree by the parity contract (models/parity.py; float64 summed
  in another order within rtol 1e-9) and EXPLAIN prints the same plan;
- the exchange accounting of TPC-H q5/q7/q8/q9 equals
  tools/tpch_rounds_manifest.json in both regimes.
"""

import json
import os

import numpy as np
import pyarrow as pa
import pytest

import baikaldb_tpu.plan.distribute as jdist
from baikaldb_tpu import ColumnBatch as JBatch
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.ops.hashagg import AggSpec as JSpec
from baikaldb_tpu.parallel import agg as jpagg
from baikaldb_tpu.parallel import shuffle as jshuffle
from baikaldb_tpu.parallel.mesh import make_mesh as jmake_mesh
from baikaldb_tpu.parallel.mesh import shard_batch as jshard_batch

import baikaldb_tpu_torch.plan.distribute as tdist
from baikaldb_tpu_torch.column.batch import ColumnBatch as TBatch
from baikaldb_tpu_torch.exec import executor as texec
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.models import tpch
from baikaldb_tpu_torch.models.parity import mismatch
from baikaldb_tpu_torch.ops import join as tjoin
from baikaldb_tpu_torch.ops.hashagg import AggSpec as TSpec
from baikaldb_tpu_torch.ops.hashagg import group_aggregate_sorted as tgroup_sorted
from baikaldb_tpu_torch.parallel import agg as tpagg
from baikaldb_tpu_torch.parallel import shuffle as tshuffle
from baikaldb_tpu_torch.parallel.mesh import ShardedBatch, make_mesh, shard_batch
from baikaldb_tpu_torch.plan.nodes import JoinNode, MultiJoinNode
from baikaldb_tpu_torch.sql.parser import parse_sql
from baikaldb_tpu_torch.utils import metrics
from baikaldb_tpu_torch.utils.flags import FLAGS

N = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANY_ORDER = "SELECT * FROM t"          # parity: rows compare as a multiset


@pytest.fixture(scope="module")
def meshes():
    return jmake_mesh(N), make_mesh(N, device="cpu")


def _both(meshes, table: pa.Table):
    jm, tm = meshes
    return (jshard_batch(JBatch.from_arrow(table), jm),
            shard_batch(TBatch.from_arrow(table, "cpu"), tm))


def _jax_shards(b, names) -> list:
    """Per-shard live rows (tuples over ``names``) of a JAX sharded batch."""
    sel = np.asarray(b.sel_mask())
    per = len(sel) // N
    cols = []
    for n in names:
        c = b.column(n)
        d = np.asarray(c.data)
        if c.dictionary is not None:
            d = c.dictionary.values[np.clip(d, 0, None)]
        valid = [True] * len(d) if c.validity is None else np.asarray(c.validity).tolist()
        cols.append([x if ok else None for x, ok in zip(d.tolist(), valid)])
    return [[tuple(col[r] for col in cols) for r in range(i * per, (i + 1) * per) if sel[r]]
            for i in range(N)]


def _port_shards(sb, names) -> list:
    out = []
    for b in sb.shards:
        rows = b.to_arrow().to_pylist()
        out.append([tuple(r[n] for n in names) for r in rows])
    return out


def _jax_rows(b) -> list[dict]:
    return b.to_arrow().to_pylist()


def _port_rows(sb) -> list[dict]:
    return [r for b in sb.shards for r in b.to_arrow().to_pylist()]


def _same(got, want, rtol=1e-9):
    diff = mismatch(got, want, ANY_ORDER, rtol)
    assert diff is None, diff


# -- the distributed kernels (tests/test_parallel.py's inputs) ---------------

def test_table_shards_hold_the_jax_shards_rows(meshes):
    """Every shard of a sharded table holds the JAX shard's rows: the same
    per-shard length (bucketing) and the same slice of the table."""
    rng = np.random.default_rng(5)
    for rows in (0, 3, 977, 1024, 1025, 5000):
        t = pa.table({"k": rng.integers(0, 50, rows), "v": rng.normal(size=rows)})
        jb, tb = _both(meshes, t)
        assert [len(b) for b in tb.shards] == [len(jb) // N] * N
        assert _port_shards(tb, ["k", "v"]) == _jax_shards(jb, ["k", "v"]), rows


def test_dist_scalar_agg_matches_jax(meshes):
    rng = np.random.default_rng(0)
    v = rng.normal(size=1000)
    jb, tb = _both(meshes, pa.table({"v": v}))
    specs = [("sum", "v", "s"), ("count_star", None, "n"), ("avg", "v", "a"),
             ("min", "v", "mn"), ("max", "v", "mx")]
    want = jpagg.dist_scalar_aggregate(jb, [JSpec(*s) for s in specs], meshes[0])
    got = tpagg.dist_scalar_aggregate(tb, [TSpec(*s) for s in specs], meshes[1])
    _same(got.to_pylist(), _jax_rows(want))
    assert got.to_pylist()[0]["n"] == 1000


def test_dist_dense_groupby_matches_jax_and_local(meshes):
    rng = np.random.default_rng(1)
    g = rng.integers(0, 5, 977)   # deliberately not divisible by 8
    v = rng.normal(size=977)
    jb, tb = _both(meshes, pa.table({"g": g, "v": v}))
    specs = [("sum", "v", "s"), ("count_star", None, "n"), ("avg", "v", "a"),
             ("min", "v", "mn")]
    want = jpagg.dist_group_aggregate_dense(jb, ["g"], [5], [JSpec(*s) for s in specs],
                                            meshes[0])
    got = tpagg.dist_group_aggregate_dense(tb, ["g"], [5], [TSpec(*s) for s in specs],
                                           meshes[1]).to_pylist()
    _same(got, _jax_rows(want))
    local = [{"g": gi, "s": v[g == gi].sum(), "n": int((g == gi).sum()),
              "a": v[g == gi].mean(), "mn": v[g == gi].min()} for gi in range(5)]
    _same(got, local)


KEYS = {
    "int": lambda rng: pa.array(rng.integers(0, 100, 800)),
    "string": lambda rng: pa.array([None if i % 11 == 0 else f"s{int(x)}"
                                    for i, x in enumerate(rng.integers(0, 60, 800))]),
    "double_null": lambda rng: pa.array([None if i % 7 == 0 else float(x) for i, x in
                                         enumerate(rng.integers(-30, 30, 800))]),
}


@pytest.mark.parametrize("kind", list(KEYS))
def test_dist_repartition_places_rows_as_jax_does(meshes, kind):
    """Equal keys land on one shard, every row on the JAX package's shard,
    in the JAX package's order (its stable dest-major send buffer); NULL keys
    all go to one shard."""
    rng = np.random.default_rng(2)
    t = pa.table({"k": KEYS[kind](rng), "i": np.arange(800)})
    jb, tb = _both(meshes, t)
    want, ovf = jshuffle.dist_hash_repartition(jb, ["k"], meshes[0], cap=256)
    assert not bool(ovf)
    got, needed = tshuffle.dist_hash_repartition(tb, ["k"], meshes[1])
    shards = _port_shards(got, ["k", "i"])
    assert shards == _jax_shards(want, ["k", "i"])
    keys = [{r[0] for r in s} for s in shards]
    assert all(not (a & b) for i, a in enumerate(keys) for b in keys[i + 1:])
    assert sorted(r[1] for s in shards for r in s) == list(range(800))
    assert needed <= 256


def test_dist_join_matches_jax(meshes):
    rng = np.random.default_rng(3)
    pk = rng.integers(0, 50, 400)
    pv = rng.integers(0, 1000, 400)
    bk = np.arange(50)
    jp, tp = _both(meshes, pa.table({"k": pk, "pv": pv}))
    jbd, tbd = _both(meshes, pa.table({"k": bk, "bv": bk * 10}))
    want, flags = jshuffle.dist_join(jp, ["k"], jbd, ["k"], meshes[0], shuffle_cap=256)
    assert not any(bool(f) for f in flags)
    # what the executor runs for a shuffle join: both sides repartition,
    # then ops/join.join on every shard
    pr, _ = tshuffle.dist_hash_repartition(tp, ["k"], meshes[1])
    br, _ = tshuffle.dist_hash_repartition(tbd, ["k"], meshes[1])
    got = ShardedBatch([tjoin.join(p, ["k"], b, ["k"], how="inner")[0]
                        for p, b in zip(pr.shards, br.shards)])
    names = ["k", "pv", "bv"]
    for g, w in zip(_port_shards(got, names), _jax_shards(want, names)):
        assert sorted(g) == sorted(w)
    assert sorted(r[:2] for s in _port_shards(got, names) for r in s) == \
        sorted(zip(pk.tolist(), pv.tolist()))


def test_dist_multiway_join_matches_jax(meshes):
    rng = np.random.default_rng(6)
    pk = rng.integers(0, 40, 500)
    jp, tp = _both(meshes, pa.table({"k": pk, "pv": rng.integers(0, 9, 500)}))
    a = pa.table({"ak": rng.integers(0, 40, 90), "av": np.arange(90)})
    b = pa.table({"bk": np.arange(0, 40, 3), "bv": np.arange(0, 40, 3) * 2.5})
    ja, ta = _both(meshes, a)
    jbb, tbb = _both(meshes, b)
    want, flags = jshuffle.dist_multiway_join(
        jp, ["k"], [(ja, ["ak"]), (jbb, ["bk"])], ["inner", "left"], meshes[0],
        shuffle_cap=512)
    assert not bool(flags[2]) and not any(bool(f) for f in flags[1])
    # the executor's fused exchange: every input repartitions once, then
    # ops/join.multiway_join on every shard
    pr, _ = tshuffle.dist_hash_repartition(tp, ["k"], meshes[1])
    ar, _ = tshuffle.dist_hash_repartition(ta, ["ak"], meshes[1])
    br, _ = tshuffle.dist_hash_repartition(tbb, ["bk"], meshes[1])
    got = ShardedBatch([
        tjoin.multiway_join(p, ["k"], [(a_, ["ak"]), (b_, ["bk"])], ["inner", "left"])[0]
        for p, a_, b_ in zip(pr.shards, ar.shards, br.shards)])
    names = ["k", "pv", "ak", "av", "bk", "bv"]
    for g, w in zip(_port_shards(got, names), _jax_shards(want, names)):
        assert g == w


def test_dist_groupby_shuffled_high_cardinality_matches_jax(meshes):
    rng = np.random.default_rng(4)
    g = rng.integers(0, 300, 2000)
    v = rng.normal(size=2000)
    jb, tb = _both(meshes, pa.table({"g": g, "v": v}))
    specs = [("sum", "v", "s"), ("count_star", None, "n")]
    want, flags = jshuffle.dist_group_aggregate_shuffled(
        jb, ["g"], [JSpec(*s) for s in specs], meshes[0], max_groups_per_shard=300,
        shuffle_cap=256)
    assert not any(bool(f) for f in flags)
    # the executor's repartition below a per-shard sorted GROUP BY
    rep, _ = tshuffle.dist_hash_repartition(tb, ["g"], meshes[1])
    got = ShardedBatch([tgroup_sorted(b, ["g"], [TSpec(*s) for s in specs], 300)
                        for b in rep.shards])
    _same(_port_rows(got), _jax_rows(want))
    assert len(_port_rows(got)) == len(np.unique(g))
    for gs, ws in zip(_port_shards(got, ["g", "n"]), _jax_shards(want, ["g", "n"])):
        assert sorted(gs) == sorted(ws)


def test_partial_shuffled_groupby_matches_jax(meshes):
    rng = np.random.default_rng(8)
    g = rng.integers(0, 12, 3000)
    v = rng.normal(size=3000)
    jb, tb = _both(meshes, pa.table({"g": g, "v": v}))
    specs = [("sum", "v", "s"), ("avg", "v", "a"), ("max", "v", "mx"),
             ("count_star", None, "n")]
    want, flags = jpagg.dist_group_aggregate_partial_shuffled(
        jb, ["g"], [JSpec(*s) for s in specs], meshes[0], max_groups_per_shard=64,
        shuffle_cap=64)
    assert not any(bool(f) for f in flags)
    got, _ = tpagg.dist_group_aggregate_partial_shuffled(
        tb, ["g"], [TSpec(*s) for s in specs], meshes[1], max_groups_per_shard=64)
    _same(_port_rows(got), _jax_rows(want))


# -- SQL over the mesh (tests/test_dist_sql.py's tables and shapes) -----------

def _fill(s, seed=0):
    """tests/test_dist_sql.py's tables, row for row."""
    rng = np.random.default_rng(seed)
    n = 500
    s.execute("CREATE TABLE fact (id BIGINT, k BIGINT, grp BIGINT, "
              "val DOUBLE, name VARCHAR)")
    names = ["alpha", "beta", "gamma", "delta", None]
    rows = []
    for i in range(n):
        rows.append((i, int(rng.integers(0, 40)), int(rng.integers(0, 5)),
                     round(float(rng.normal()), 3),
                     names[int(rng.integers(0, 5))]))
    vals = ", ".join(
        f"({i}, {k}, {g}, {v}, " + ("NULL" if nm is None else f"'{nm}'") + ")"
        for i, k, g, v, nm in rows)
    s.execute(f"INSERT INTO fact VALUES {vals}")
    s.execute("CREATE TABLE dim (k BIGINT, tag VARCHAR, w DOUBLE)")
    dim = ", ".join(f"({k}, 'tag{k % 7}', {k * 0.5})" for k in range(0, 40, 2))
    s.execute(f"INSERT INTO dim VALUES {dim}")
    s.execute("CREATE TABLE other (k BIGINT, val DOUBLE, name VARCHAR)")
    oth = ", ".join(f"({int(rng.integers(0, 40))}, {round(float(rng.normal()), 3)}, "
                    f"'{names[int(rng.integers(0, 4))]}')" for _ in range(300))
    s.execute(f"INSERT INTO other VALUES {oth}")
    return s


@pytest.fixture(scope="module")
def sql_pair(meshes):
    return _fill(JSession(mesh=meshes[0])), _fill(TSession(mesh=meshes[1]))


SHAPES = {
    "scalar_aggregates": "SELECT COUNT(*) c, SUM(val) s, AVG(val) a, MIN(val) mn, "
                         "MAX(val) mx FROM fact",
    "scalar_agg_with_filter": "SELECT COUNT(*) c, SUM(val) s FROM fact "
                              "WHERE grp < 3 AND val > 0",
    "dense_groupby_psum": "SELECT grp, COUNT(*) c, SUM(val) s, AVG(val) a, MIN(val) mn "
                          "FROM fact GROUP BY grp ORDER BY grp",
    "string_groupby": "SELECT name, COUNT(*) c, SUM(val) s FROM fact GROUP BY name",
    "count_distinct_grouped": "SELECT grp, COUNT(DISTINCT k) dk FROM fact GROUP BY grp",
    "count_distinct_scalar": "SELECT COUNT(DISTINCT name) dn, COUNT(DISTINCT k) dk "
                             "FROM fact",
    "broadcast_join": "SELECT f.grp, d.tag, SUM(f.val * d.w) s FROM fact f "
                      "JOIN dim d ON f.k = d.k GROUP BY f.grp, d.tag",
    "left_join": "SELECT f.id, d.tag FROM fact f LEFT JOIN dim d ON f.k = d.k "
                 "WHERE f.id < 50",
    "semi_subquery": "SELECT COUNT(*) c FROM fact WHERE k IN (SELECT k FROM dim)",
    "anti_subquery": "SELECT COUNT(*) c FROM fact WHERE k NOT IN (SELECT k FROM dim)",
    "exists_subquery": "SELECT COUNT(*) c FROM fact f WHERE EXISTS "
                       "(SELECT 1 FROM dim d WHERE d.k = f.k)",
    "scalar_subquery": "SELECT id, val - (SELECT AVG(val) FROM fact) d FROM fact "
                       "WHERE id < 20",
    "topk": "SELECT id, val FROM fact ORDER BY val DESC, id LIMIT 7",
    "topk_offset": "SELECT id, val FROM fact ORDER BY val, id LIMIT 5 OFFSET 3",
    "full_sort": "SELECT id, val FROM fact WHERE id < 40 ORDER BY val, id",
    "distinct": "SELECT DISTINCT grp, name FROM fact",
    "union_all": "SELECT k, val FROM fact WHERE grp = 0 UNION ALL SELECT k, val FROM other",
    "union_distinct": "SELECT grp FROM fact UNION SELECT k FROM dim",
    "window": "SELECT id, val, SUM(val) OVER (PARTITION BY grp ORDER BY id) rs "
              "FROM fact WHERE id < 60",
    "derived_table": "SELECT t.grp, t.s FROM (SELECT grp, SUM(val) s FROM fact "
                     "GROUP BY grp) t WHERE t.s > 0",
    "cte": "WITH g AS (SELECT grp, COUNT(*) c FROM fact GROUP BY grp) "
           "SELECT g.grp, g.c FROM g WHERE g.c > 10",
    "having": "SELECT k, COUNT(*) c FROM fact GROUP BY k HAVING COUNT(*) > 10",
    "cross_join": "SELECT COUNT(*) c FROM fact f, dim d WHERE f.k = d.k AND d.w > 5",
    "no_from": "SELECT 1 + 1 AS two",
}
# the shuffle join (BROADCAST_ROWS = 0): integer keys, and string keys from
# two tables with different dictionaries (value-hash partitioning must still
# co-locate equal strings)
SHUFFLED = {
    "shuffle_join": "SELECT f.grp, COUNT(*) c, SUM(o.val) s FROM fact f "
                    "JOIN other o ON f.k = o.k GROUP BY f.grp",
    "shuffle_join_string_keys": "SELECT f.name, COUNT(*) c FROM fact f "
                                "JOIN other o ON f.name = o.name GROUP BY f.name",
    "explain_shows_exchanges": "SELECT f.grp, COUNT(*) c FROM fact f "
                               "JOIN other o ON f.k = o.k GROUP BY f.grp",
}


def _plan_text(s, sql: str) -> str:
    return s.execute("EXPLAIN " + sql).plan_text


def _check_sql(sql_pair, sql):
    js, ts = sql_pair
    assert _plan_text(ts, sql) == _plan_text(js, sql)
    diff = mismatch(ts.query(sql), js.query(sql), sql)
    assert diff is None, diff


@pytest.mark.parametrize("name", list(SHAPES))
def test_sql_shape_matches_jax_mesh(sql_pair, name):
    _check_sql(sql_pair, SHAPES[name])


@pytest.mark.parametrize("name", list(SHUFFLED))
def test_forced_shuffle_join_matches_jax_mesh(sql_pair, monkeypatch, name):
    monkeypatch.setattr(jdist, "BROADCAST_ROWS", 0)
    monkeypatch.setattr(tdist, "BROADCAST_ROWS", 0)
    js, ts = sql_pair
    js._plan_cache.clear()
    try:
        _check_sql(sql_pair, SHUFFLED[name])
        assert "Exchange(repartition" in _plan_text(ts, SHUFFLED[name])
    finally:
        js._plan_cache.clear()


def test_limit_without_order(sql_pair):
    js, ts = sql_pair
    assert len(ts.query("SELECT id FROM fact LIMIT 13")) == 13


def test_empty_table_mesh(meshes):
    out = []
    for s in (JSession(mesh=meshes[0]), TSession(mesh=meshes[1])):
        s.execute("CREATE TABLE e (a BIGINT, b DOUBLE)")
        out.append((s.query("SELECT COUNT(*) c, SUM(b) s FROM e"),
                    s.query("SELECT a FROM e ORDER BY a LIMIT 3")))
    assert out[1] == out[0] == ([{"c": 0, "s": None}], [])


def test_insert_then_distributed_read(meshes):
    out = []
    for s in (JSession(mesh=meshes[0]), TSession(mesh=meshes[1])):
        s.execute("CREATE TABLE t (a BIGINT, b BIGINT)")
        s.execute("INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)")
        first = s.query("SELECT SUM(b) s FROM t")
        s.execute("INSERT INTO t VALUES (4, 40)")
        out.append((first, s.query("SELECT COUNT(*) c, SUM(b) s FROM t")))
    assert out[1] == out[0] == ([{"s": 60}], [{"c": 4, "s": 100}])


def test_drop_table_frees_the_shards_and_a_new_table_reads_its_own(meshes):
    """DROP TABLE frees the sharded copy, and a table created again under
    the same name, loaded with its rows reversed at the same store version,
    answers from its own rows, in this session and in another one that
    shares the database and has read the dropped table."""
    a = np.arange(3000)
    other = TSession(mesh=meshes[1])
    s = TSession(db=other.db, mesh=meshes[1])
    sql = "SELECT a, b FROM t WHERE a < 2 ORDER BY a"
    s.execute("CREATE TABLE t (a BIGINT, b BIGINT)")
    s.load_arrow("t", pa.table({"a": a, "b": a * 10}))
    old = s.db.stores["default.t"]
    version = old.version
    assert s.query(sql) == other.query(sql) == [{"a": 0, "b": 0}, {"a": 1, "b": 10}]
    s.execute("DROP TABLE t")
    assert old._sharded is None and old._device_batch is None
    s.execute("CREATE TABLE t (a BIGINT, b BIGINT)")
    s.load_arrow("t", pa.table({"a": a, "b": a[::-1] * 10}))
    assert s.db.stores["default.t"].version == version
    want = [{"a": 0, "b": 29990}, {"a": 1, "b": 29980}]
    assert other.query(sql) == s.query(sql) == want


def test_mesh_telemetry_counts_rounds_and_traces_spans(sql_pair, monkeypatch):
    """Each mesh query adds its executed repartition rounds to
    shuffle_rounds; with tracing on its mpp.* spans are recorded."""
    from baikaldb_tpu_torch.obs import trace

    monkeypatch.setattr(tdist, "BROADCAST_ROWS", 0)
    _, ts = sql_pair
    sql = SHUFFLED["shuffle_join"]
    r0 = metrics.shuffle_rounds.value
    ts.query(sql)
    assert metrics.shuffle_rounds.value - r0 == 1
    FLAGS.set_flag("tracing", True)
    try:
        ts.query(sql)
    finally:
        FLAGS.set_flag("tracing", False)
    rec = [t for t in trace.TRACER.list() if t["text"] == sql][-1]
    names = [sp["name"] for sp in rec["spans"]]
    assert names.count("mpp.repartition") == 2 and "mpp.join" in names
    assert "mpp.agg" in names


def test_mesh_session_runs_no_streamed_scan(sql_pair):
    js, ts = sql_pair
    sql = "SELECT grp, SUM(val) s FROM fact GROUP BY grp"
    FLAGS.set_flag("streaming_min_rows", 1)
    try:
        c0 = metrics.stream_chunks.value
        assert mismatch(ts.query(sql), js.query(sql), sql) is None
        assert metrics.stream_chunks.value == c0
    finally:
        FLAGS.set_flag("streaming_min_rows", 1 << 18)


def test_vector_topk_on_the_mesh_matches_jax(meshes):
    """tests/test_vector_sql.py's mesh half: an exact L2 top-10 over a
    VECTOR(16) column, distributed (per-shard top-k, gather, final top-k)."""
    rng = np.random.default_rng(3)
    n, d = 500, 16
    mat = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=d).astype(np.float32)
    qs = "[" + ",".join(str(float(x)) for x in q) + "]"
    sql = f"SELECT id FROM big ORDER BY L2_DISTANCE(emb, '{qs}') LIMIT 10"
    want = [int(i) for i in np.argsort(((mat - q) ** 2).sum(axis=1))[:10]]
    got = []
    for s in (JSession(mesh=meshes[0]), TSession(mesh=meshes[1])):
        s.execute("CREATE TABLE big (id BIGINT, emb VECTOR(16))")
        s.load_arrow("big", pa.table({"id": np.arange(n), "emb": list(mat.tolist())}))
        got.append([r["id"] for r in s.query(sql)])
    assert got[1] == got[0] == want


# -- the pinned TPC-H exchange accounting ------------------------------------

def _plan_metrics(s, sql):
    plan = s._plan_select(parse_sql(sql)[0])
    x = texec.exchange_summary(plan)
    seen, steps = set(), [0]

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, (JoinNode, MultiJoinNode)):
            steps[0] += 1
        for c in n.children:
            walk(c)
    walk(plan)
    return {"rounds": x["rounds"], "collectives": x["collectives"],
            "reused": x["reused"], "join_steps": steps[0]}


def test_tpch_exchange_accounting_matches_the_manifest(meshes, monkeypatch):
    """The port's exchange_summary of q5/q7/q8/q9 equals the manifest the
    JAX package's plans are pinned to (tools/tpch_rounds_manifest.json),
    fused and with multiway_join off, in the natural and the force-shuffle
    regime.  The manifest is read, never written."""
    with open(os.path.join(ROOT, "tools", "tpch_rounds_manifest.json")) as f:
        manifest = json.load(f)
    cfg = manifest["config"]
    monkeypatch.setattr(tdist, "BROADCAST_ROWS", cfg["broadcast_rows"])
    s = TSession(mesh=make_mesh(cfg["mesh"], device="cpu"))
    tpch.load_into(s, scale=cfg["scale"], seed=cfg["seed"])
    prior = {k: getattr(FLAGS, k) for k in ("dense_join_span_max", "mpp_force_shuffle",
                                            "multiway_join")}
    FLAGS.set_flag("dense_join_span_max", cfg["dense_join_span_max"])
    try:
        for regime in ("natural", "force_shuffle"):
            FLAGS.set_flag("mpp_force_shuffle", regime == "force_shuffle")
            for q, want in manifest[regime].items():
                FLAGS.set_flag("multiway_join", True)
                got = _plan_metrics(s, tpch.QUERIES[q])
                FLAGS.set_flag("multiway_join", False)
                base = _plan_metrics(s, tpch.QUERIES[q])
                assert got == {k: want[k] for k in got}, (regime, q, got)
                for k in ("rounds", "collectives", "join_steps"):
                    assert base[k] == want[f"baseline_{k}"], (regime, q, k, base)
    finally:
        for k, v in prior.items():
            FLAGS.set_flag(k, v)
