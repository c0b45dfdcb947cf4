"""The port's plan cache and auto-parameterization (plan/paramize.py, the
session's ``_select_cached``) against tests/test_param_cache.py's shapes.

The same statements run through the JAX ``Session()`` and the port's
``Session(device="cpu")`` over the same rows; results compare exactly (the
ROADMAP parity contract: keys, counts, NULLs and ORDER BY order exactly,
floats here are sums of a handful of exact binary fractions).  The port's
counterpart of the reference's "zero retraces" is "no replan": a hit never
calls ``_plan_select``.
"""

import pytest

from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.utils.flags import set_flag as jset_flag
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.utils import metrics
from baikaldb_tpu_torch.utils.flags import set_flag

DDL = "CREATE TABLE p (id BIGINT, v DOUBLE, name VARCHAR(16), d DATE)"
ROWS = ("INSERT INTO p VALUES (1, 1.5, 'alpha', '2024-01-01'), (2, 2.5, 'beta', '2024-01-02'),"
        " (3, 3.5, 'alpha', '2024-01-03'), (4, NULL, 'gamma', NULL),"
        " (5, 4.5, NULL, '2024-02-01')")


@pytest.fixture
def pair():
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute(DDL)
        s.execute(ROWS)
        out.append(s)
    return out


@pytest.fixture
def plans(monkeypatch):
    """Counts the port's planner calls."""
    calls = [0]
    real = TSession._plan_select

    def spy(self, stmt):
        calls[0] += 1
        return real(self, stmt)
    monkeypatch.setattr(TSession, "_plan_select", spy)
    return calls


QUERIES = [
    # INT / FLOAT params, both comparison orientations, arithmetic
    "SELECT id, v FROM p WHERE id = 2",
    "SELECT id FROM p WHERE 3 <= id ORDER BY id",
    "SELECT id FROM p WHERE v > 1.5 AND v < 4.0 ORDER BY id",
    "SELECT id FROM p WHERE v * 2 + 1 > 6.0 ORDER BY id",
    "SELECT id FROM p WHERE id BETWEEN 2 AND 4 ORDER BY id",
    # STRING vs dictionary column (eq / ne / range)
    "SELECT id FROM p WHERE name = 'alpha' ORDER BY id",
    "SELECT id FROM p WHERE name <> 'alpha' ORDER BY id",
    "SELECT id FROM p WHERE name >= 'b' ORDER BY id",
    # string literal vs temporal column, vs numeric column
    "SELECT id FROM p WHERE d >= '2024-01-02' ORDER BY id",
    "SELECT id FROM p WHERE v > '2' ORDER BY id",
    # NULL literal: pinned, three-valued logic intact
    "SELECT id FROM p WHERE v = NULL",
    "SELECT COUNT(*) c FROM p WHERE id <> 1",
    "SELECT name, COUNT(*) c, SUM(v) s FROM p WHERE id > 1 GROUP BY name ORDER BY name",
]


@pytest.mark.parametrize("q", QUERIES)
def test_param_vs_baked_bit_identical_and_equal_to_jax(pair, q):
    js, ts = pair
    on = ts.execute(q).arrow
    set_flag("param_queries", False)
    try:
        off = TSession(ts.db).execute(q).arrow
    finally:
        set_flag("param_queries", True)
    assert on.equals(off), q
    assert on.to_pylist() == js.query(q), q


def test_fifty_literal_variants_one_entry_no_replans(pair, plans):
    js, ts = pair
    ts.query("SELECT COUNT(*) c, SUM(v) s FROM p WHERE v <> 0.0")      # warm: the miss
    p0, h0 = plans[0], metrics.plan_cache_param_hits.value
    for i in range(50):
        q = f"SELECT COUNT(*) c, SUM(v) s FROM p WHERE v <> {float(i + 1)}"
        rows = ts.query(q)
        assert rows == js.query(q)
        assert rows[0]["c"] in (3, 4)   # the NULL v never matches <>
    assert plans[0] == p0
    assert metrics.plan_cache_param_hits.value == h0 + 50
    assert len([k for k in ts._plan_cache if k[0] == "//params"]) == 1


def test_string_variants_no_replans(pair, plans):
    js, ts = pair
    ts.query("SELECT COUNT(*) c FROM p WHERE name = 'warmup'")
    p0 = plans[0]
    qs = [f"SELECT COUNT(*) c FROM p WHERE name = '{n}'"
          for n in ("alpha", "beta", "gamma", "delta", "alpha")]
    counts = [ts.query(q)[0]["c"] for q in qs]
    assert counts == [2, 1, 1, 0, 2] == [js.query(q)[0]["c"] for q in qs]
    assert plans[0] == p0


def test_pinned_positions(pair):
    """LIMIT and IN-list literals stay baked: distinct values key distinct
    entries and the results stay exact."""
    js, ts = pair
    for q, want in (("SELECT id FROM p ORDER BY id LIMIT 2", [1, 2]),
                    ("SELECT id FROM p ORDER BY id LIMIT 3", [1, 2, 3]),
                    ("SELECT id FROM p WHERE id IN (1, 3) ORDER BY id", [1, 3]),
                    ("SELECT id FROM p WHERE id IN (2, 5) ORDER BY id", [2, 5])):
        assert [r["id"] for r in ts.query(q)] == want == [r["id"] for r in js.query(q)]
    keys = [k for k in ts._plan_cache if k[0] == "//params"]
    in_keys = [k for k in keys if "in" in str(k)]
    assert len(in_keys) >= 2 or not in_keys


def test_dense_groupby_domain_refresh(pair):
    """Dense group-by domains are stats-derived plan choices: a version
    bump replans even when the normalized key is unchanged."""
    js, ts = pair
    q = "SELECT k, SUM(v) s FROM pg WHERE v <> 0 GROUP BY k ORDER BY k"
    for s in (js, ts):
        s.execute("CREATE TABLE pg (k INT, v BIGINT)")
        s.execute("INSERT INTO pg VALUES (1,10),(2,20)")
    assert [r["k"] for r in ts.query(q)] == [1, 2]
    for s in (js, ts):
        s.execute("INSERT INTO pg VALUES (99,30)")    # outside the old domain's span
    rows = ts.query(q)
    assert [r["k"] for r in rows] == [1, 2, 99] and rows[-1]["s"] == 30
    assert rows == js.query(q)


def test_accounting_reconciles(pair, plans):
    """hits + param_hits + misses move by exactly one a cached-path SELECT;
    a version bump whose replan keeps the plan signature stays a hit."""
    js, ts = pair

    def counts():
        return (metrics.plan_cache_hits.value, metrics.plan_cache_param_hits.value,
                metrics.plan_cache_misses.value)

    ts.query("SELECT COUNT(*) c FROM p WHERE id <> 0")
    h0, p0, m0 = counts()
    for i in range(5):
        ts.query(f"SELECT COUNT(*) c FROM p WHERE id <> {i}")
    ts.query("SELECT COUNT(*) c FROM p WHERE id <> 0")        # the exact-text hit
    h1, p1, m1 = counts()
    assert (h1 - h0) + (p1 - p0) + (m1 - m0) == 6
    assert m1 == m0 and h1 - h0 >= 1
    ts.execute("INSERT INTO p VALUES (6, 5.5, 'delta', '2024-03-01')")
    r0 = plans[0]
    assert ts.query("SELECT COUNT(*) c FROM p WHERE id <> 0") == [{"c": 6}]
    h2, p2, m2 = counts()
    assert plans[0] == r0 + 1                    # the version bump replanned ...
    assert m2 == m1 and (h2 - h1) + (p2 - p1) == 1   # ... and it is a hit
    log = ts.query("SELECT query, cache FROM information_schema.query_log")
    assert [r["cache"] for r in log[-7:]] == ["hit"] + ["param_hit"] * 4 + ["hit", "hit"]


def test_ddl_and_view_changes_drop_entries(pair, plans):
    js, ts = pair
    q = "SELECT id FROM pv WHERE id > 1 ORDER BY id"
    ts.execute("CREATE VIEW pv AS SELECT id FROM p WHERE id < 4")
    assert [r["id"] for r in ts.query(q)] == [2, 3]
    other = TSession(ts.db)
    other.execute("DROP VIEW pv")
    other.execute("CREATE VIEW pv AS SELECT id FROM p WHERE id < 5")
    assert [r["id"] for r in ts.query(q)] == [2, 3, 4]     # view_gen moved: replanned
    ts.execute("CREATE TABLE other_t (a BIGINT)")
    assert not ts._plan_cache                              # DDL cleared this session's


def test_prepare_execute_roundtrip(pair, plans):
    js, ts = pair
    for s in (js, ts):
        s.execute("PREPARE q FROM 'SELECT id, v FROM p WHERE id = ?'")
    p0 = plans[0]
    for arg in ("1", "2"):
        assert ts.query(f"EXECUTE q USING {arg}") == js.query(f"EXECUTE q USING {arg}")
    assert ts.query("EXECUTE q USING 1") == [{"id": 1, "v": 1.5}]
    for s in (js, ts):
        s.execute("SET @pid = 3")
    assert ts.query("EXECUTE q USING @pid") == [{"id": 3, "v": 3.5}] == \
        js.query("EXECUTE q USING @pid")
    assert plans[0] - p0 <= 1                            # one shape, one plan
    # ? in INSERT VALUES
    for s in (js, ts):
        s.execute("PREPARE ins FROM 'INSERT INTO p VALUES (?, ?, ?, ?)'")
        s.execute("EXECUTE ins USING 50, 5.5, 'zeta', '2024-03-01'")
    q = "SELECT v, name, d FROM p WHERE id = 50"
    assert ts.query(q) == js.query(q)
    assert ts.query("SELECT v, name FROM p WHERE id = 50") == [{"v": 5.5, "name": "zeta"}]
    # the arity error; DEALLOCATE forgets the statement
    with pytest.raises(Exception, match="needs 1 parameters, got 2"):
        ts.execute("EXECUTE q USING 1, 2")
    ts.execute("DEALLOCATE PREPARE q")
    with pytest.raises(Exception, match="unknown prepared statement"):
        ts.execute("EXECUTE q USING 1")
    with pytest.raises(Exception, match="unknown prepared statement"):
        ts.execute("DEALLOCATE PREPARE q")


def test_param_path_respects_access_paths(pair):
    """A parameterized filter still drives the access paths with the real
    literal: the secondary index engages, the zone maps prune and a full
    primary key reads the point."""
    js, ts = pair
    for s in (js, ts):
        s.execute("CREATE TABLE ix (id BIGINT PRIMARY KEY, g VARCHAR(8), KEY kg (g))")
        s.execute("INSERT INTO ix VALUES " + ",".join(f"({i},'g{i % 100}')"
                                                      for i in range(1000)))
    for lit in ("g7", "g8", "g9"):
        i0 = metrics.index_scans.value
        q = f"SELECT COUNT(*) c FROM ix WHERE g = '{lit}'"
        assert ts.query(q) == [{"c": 10}] == js.query(q)
        assert metrics.index_scans.value > i0
    p0 = metrics.point_lookups.value
    q = "SELECT id, g FROM ix WHERE id = 42"
    assert ts.query(q) == [{"id": 42, "g": "g42"}] == js.query(q)
    assert metrics.point_lookups.value == p0 + 1


def test_zone_maps_see_each_executions_literal(pair):
    js, ts = pair
    for s in (js, ts):
        s.execute("CREATE TABLE zr (id BIGINT PRIMARY KEY, v DOUBLE)")
        s.db.stores["default.zr"].region_rows = 100
        s.execute("INSERT INTO zr VALUES " + ",".join(f"({i}, {i * 0.5})" for i in range(1000)))
    for lo in (100, 900, 500):
        q = f"SELECT COUNT(*) c, SUM(v) s FROM zr WHERE id >= {lo}"
        r0 = metrics.regions_pruned.value
        assert ts.query(q) == js.query(q)
        assert metrics.regions_pruned.value - r0 == lo // 100


def test_subquery_shapes_still_cache(pair):
    """Normalized keys recurse through subquery statements: the same text
    parsed again still hits."""
    js, ts = pair
    q = "SELECT id FROM p WHERE v > (SELECT MIN(v) FROM p WHERE id <> 1) ORDER BY id"
    a = ts.query(q)
    m0 = metrics.plan_cache_misses.value
    b = ts.query(q)
    assert a == b == js.query(q)
    assert metrics.plan_cache_misses.value == m0


def test_plan_cache_size_zero_disables_caching(pair, plans):
    js, ts = pair
    set_flag("plan_cache_size", 0)
    jset_flag("plan_cache_size", 0)
    try:
        for i in range(3):
            q = f"SELECT id FROM p WHERE id > {i} ORDER BY id"
            assert ts.query(q) == js.query(q)
        assert plans[0] == 3 and not ts._plan_cache
    finally:
        set_flag("plan_cache_size", 256)
        jset_flag("plan_cache_size", 256)


def test_cached_select_spans_and_cache_event(pair):
    from baikaldb_tpu_torch.obs import trace

    js, ts = pair
    q = "SELECT id FROM p WHERE id > 2 ORDER BY id"
    set_flag("tracing", True)
    try:
        ts.query(q)
        ts.query(q.replace("2", "3"))
    finally:
        set_flag("tracing", False)
    recs = [t for t in trace.TRACER.list() if t["text"] in (q, q.replace("2", "3"))][-2:]
    first = {s["name"] for s in recs[0]["spans"]}
    second = {s["name"]: s for s in recs[1]["spans"]}
    assert {"plan.paramize", "plan.build", "plan.bind", "plan.cache", "exec.batches",
            "exec.run", "egress.arrow"} <= first
    assert "plan.build" not in second
    assert second["plan.cache"]["attrs"]["outcome"] == "param_hit"


def test_another_sessions_drop_and_create_replans():
    """A table dropped and created again by another session is another
    store: the cached plan is not reused, even at the same store version."""
    a = TSession(device="cpu")
    b = TSession(a.db)
    a.execute("CREATE TABLE x (k BIGINT, v BIGINT)")
    a.execute("INSERT INTO x VALUES (1, 10), (2, 20), (3, 30)")
    q = "SELECT k, v FROM x WHERE k > 1 ORDER BY k"
    assert a.query(q) == [{"k": 2, "v": 20}, {"k": 3, "v": 30}]
    b.execute("DROP TABLE x")
    b.execute("CREATE TABLE x (v DOUBLE, k BIGINT)")
    b.execute("INSERT INTO x VALUES (0.5, 1), (1.5, 2), (2.5, 3)")
    m0 = metrics.plan_cache_misses.value
    assert a.query(q) == [{"k": 2, "v": 1.5}, {"k": 3, "v": 2.5}]
    assert metrics.plan_cache_misses.value == m0 + 1
