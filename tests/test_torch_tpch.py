"""The 22 TPC-H queries through the port's Session against the JAX package.

The same tables (``generate(scale=0.002, seed=7)``) go into the JAX
``Session()`` and the port's ``Session(device="cpu")``; every query runs in
both and the rows are compared under the parity contract:

- keys, counts, integers, strings, dates, NULLs and ORDER BY order are exact;
- DOUBLE values match within rtol 1e-9 (float64 summed in another order);
  an absolute 1e-6 covers sums that cancel to about zero.  Where the port's
  group-by kernels ran (a dense domain with 512 < groups + 1 <= 4096, which
  q18's inner GROUP BY hits at this scale), their float32 output contract
  gives rtol 1e-4;
- result sets without ORDER BY compare as multisets;
- rows that tie on every ORDER BY key compare as a multiset within the run;
- where LIMIT cuts through a tied run, only that run's ORDER BY values
  compare.

The contract is ``baikaldb_tpu_torch/models/parity.py``, which the card run
(chip_smoke.py) holds the card to as well.  The planner is a copy, so the
``EXPLAIN`` plans must be equal too.

The same 22 queries also run on the mesh: the port's ``Session(mesh=
make_mesh(8, device="cpu"))`` against the JAX ``Session(mesh=make_mesh(8))``
over 8 virtual CPU devices (tests/conftest.py), rows and distributed plans
equal under the same contract.
"""

import pytest

from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.models import tpch as jtpch
from baikaldb_tpu.parallel.mesh import make_mesh as jmake_mesh
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.models import analytics, tpch
from baikaldb_tpu_torch.models.parity import mismatch
from baikaldb_tpu_torch.ops import group_kernels as gk
from baikaldb_tpu_torch.parallel.mesh import make_mesh
from baikaldb_tpu_torch.sql.parser import parse_sql

SCALE, SEED = 0.002, 7


def _load(sessions):
    tables = tpch.generate(scale=SCALE, seed=SEED)
    for s in sessions:
        for name, ddl in tpch.DDL.items():
            s.execute(ddl)
            s.load_arrow(name, tables[name])
    return sessions


@pytest.fixture(scope="module")
def tpch_sessions():
    return _load([JSession(), TSession(device="cpu")])


@pytest.fixture(scope="module")
def tpch_mesh_sessions():
    return _load([JSession(mesh=jmake_mesh(8)),
                  TSession(mesh=make_mesh(8, device="cpu"))])


def assert_result_matches(got: list[dict], want: list[dict], sql: str,
                          rtol: float = 1e-9):
    diff = mismatch(got, want, sql, rtol)
    assert diff is None, diff


ALL = {**tpch.QUERIES, **tpch.VARIANTS}


@pytest.mark.parametrize("name", list(ALL))
def test_tpch_query_matches_jax(tpch_sessions, monkeypatch, name):
    jsess, tsess = tpch_sessions
    ran = set()
    for k in gk.LAUNCHES:
        plain = getattr(gk, f"{k}_plain")
        monkeypatch.setattr(gk, f"{k}_plain",
                            lambda *a, _k=k, _p=plain: ran.add(_k) or _p(*a))
    sql = ALL[name]
    got = tsess.query(sql)
    assert ran == ({"filtered_group_sum"} if name == "q18" else set())
    want = jsess.query(sql)
    assert_result_matches(got, want, sql, 1e-4 if ran else 1e-9)
    if name in tpch.VARIANTS:
        assert want, f"{name} returned no rows"   # the variant exists to have rows


def test_stock_q20_has_no_rows_and_its_variant_has(tpch_sessions):
    """Stock q20 is empty under this generator (models/tpch.py VARIANTS says
    why); its variant keeps the shape and returns rows, and only those rows
    pass the correlated comparison: with the factor at 0.5 more come back."""
    jsess, tsess = tpch_sessions
    assert tsess.query(tpch.QUERIES["q20"]) == [] == jsess.query(tpch.QUERIES["q20"])
    sql = tpch.VARIANTS["q20_rows"]
    rows = tsess.query(sql)
    assert 0 < len(rows) < len(tsess.query(sql.replace("200 * SUM", "0.5 * SUM")))


def _plan_text(sess, sql: str) -> str:
    return sess.execute("EXPLAIN " + sql).plan_text


@pytest.mark.parametrize("name", list(ALL))
def test_tpch_plan_matches_jax(tpch_sessions, name):
    jsess, tsess = tpch_sessions
    sql = ALL[name]
    assert _plan_text(tsess, sql) == _plan_text(jsess, sql)


@pytest.mark.parametrize("name", list(ALL))
def test_tpch_query_matches_jax_on_the_mesh(tpch_mesh_sessions, monkeypatch, name):
    """The port's 8-shard mesh against the JAX package's 8-device mesh.  Where
    a float group-by kernel (K1, K2) ran on some shard, its float32 output
    contract gives rtol 1e-4; K3 also counts each exchange's destinations
    (exact)."""
    jsess, tsess = tpch_mesh_sessions
    ran = set()
    for k in gk.LAUNCHES:
        plain = getattr(gk, f"{k}_plain")
        monkeypatch.setattr(gk, f"{k}_plain",
                            lambda *a, _k=k, _p=plain: ran.add(_k) or _p(*a))
    sql = ALL[name]
    got = tsess.query(sql)
    float_kernels = ran & {"filtered_group_sum", "fused_group_aggregate"}
    assert_result_matches(got, jsess.query(sql), sql, 1e-4 if float_kernels else 1e-9)


@pytest.mark.parametrize("name", list(ALL))
def test_tpch_plan_matches_jax_on_the_mesh(tpch_mesh_sessions, name):
    jsess, tsess = tpch_mesh_sessions
    sql = ALL[name]
    assert _plan_text(tsess, sql) == _plan_text(jsess, sql)


def test_mesh_q3_forced_shuffle_matches_jax(tpch_mesh_sessions):
    """Q3 (BASELINE config #3) with every join input repartitioned: at
    least one executed round, and the JAX mesh's rows."""
    from baikaldb_tpu.utils.flags import set_flag as jset_flag
    from baikaldb_tpu_torch.exec.executor import exchange_summary
    from baikaldb_tpu_torch.utils.flags import FLAGS

    jsess, tsess = tpch_mesh_sessions
    sql = tpch.QUERIES["q3"]
    FLAGS.set_flag("mpp_force_shuffle", True)
    jset_flag("mpp_force_shuffle", True)
    jsess._plan_cache.clear()
    try:
        assert exchange_summary(tsess._plan_select(parse_sql(sql)[0]))["rounds"] >= 1
        assert_result_matches(tsess.query(sql), jsess.query(sql), sql)
    finally:
        FLAGS.set_flag("mpp_force_shuffle", False)
        jset_flag("mpp_force_shuffle", False)
        jsess._plan_cache.clear()


@pytest.mark.parametrize("name", list(analytics.QUERIES))
def test_analytic_query_matches_jax(tpch_sessions, name):
    """The analytic set (windows, sketches, builtins) over the same tables:
    its outer sums of window SUM/AVG values compare to rtol 1e-9, the rest
    exactly (``models/parity.py``)."""
    jsess, tsess = tpch_sessions
    sql = analytics.QUERIES[name]
    got = tsess.query(sql)
    assert got, f"{name} returned no rows"
    assert_result_matches(got, jsess.query(sql), sql)


@pytest.mark.parametrize("name", list(analytics.QUERIES))
def test_analytic_plan_matches_jax(tpch_sessions, name):
    jsess, tsess = tpch_sessions
    sql = analytics.QUERIES[name]
    assert _plan_text(tsess, sql) == _plan_text(jsess, sql)


def test_analytic_checks_hold_the_port_to_numpy(tpch_sessions):
    """The numpy checks the card run applies at SF1, here on the CPU session,
    and they catch a wrong answer."""
    _, tsess = tpch_sessions
    lineitem = tpch.generate(scale=SCALE, seed=SEED)["lineitem"]
    results = {q: tsess.query(analytics.QUERIES[q])
               for q in ("w_rank", "a_sketch", "a_sketch_all")}
    analytics.check_against_numpy(results, lineitem)
    results["a_sketch_all"] = [{**results["a_sketch_all"][0],
                                "med_qty": results["a_sketch_all"][0]["med_qty"] + 0.5}]
    with pytest.raises(AssertionError):
        analytics.check_against_numpy(results, lineitem)


def test_generator_matches_jax():
    mine = tpch.generate(scale=SCALE, seed=3)
    ref = jtpch.generate(scale=SCALE, seed=3)
    assert list(mine) == list(ref)
    for name in ref:
        assert mine[name].equals(ref[name]), name
    assert tpch.DDL == jtpch.DDL and tpch.QUERIES == jtpch.QUERIES


def test_comparator_applies_the_contract():
    sql = "SELECT a, b FROM t ORDER BY a LIMIT 3"
    want = [{"a": 1, "b": 1.0}, {"a": 2, "b": 5.0}, {"a": 2, "b": 6.0}]
    # a tied run cut by LIMIT: only the ORDER BY values compare
    assert_result_matches([{"a": 1, "b": 1.0}, {"a": 2, "b": 7.0},
                           {"a": 2, "b": 8.0}], want, sql)
    with pytest.raises(AssertionError):
        assert_result_matches([{"a": 1, "b": 1.5}, {"a": 2, "b": 5.0},
                               {"a": 2, "b": 6.0}], want, sql)
    # a tied run inside the result compares as a multiset
    sql = "SELECT a, b FROM t ORDER BY a"
    assert_result_matches([{"a": 2, "b": 6.0}, {"a": 2, "b": 5.0}, {"a": 3, "b": 0.0}],
                          [{"a": 2, "b": 5.0}, {"a": 2, "b": 6.0 * (1 + 1e-12)},
                           {"a": 3, "b": 0.0}], sql)
    with pytest.raises(AssertionError):
        assert_result_matches([{"a": 2, "b": 6e6}, {"a": 2, "b": 5.0}],
                              [{"a": 2, "b": 5.0}, {"a": 2, "b": 6e6 * (1 + 1e-8)}], sql)


def test_q15_evaluates_its_view_once(tpch_sessions, monkeypatch):
    """q15 reads its ``revenue`` view twice; the port evaluates the body once,
    so the view's float sums and their MAX come from one computation (on the
    card, atomic float adds are not bitwise repeatable)."""
    from baikaldb_tpu_torch.exec import executor

    _, tsess = tpch_sessions
    calls = []
    dense = executor.group_aggregate_dense
    monkeypatch.setattr(executor, "group_aggregate_dense",
                        lambda *a: calls.append(a[1]) or dense(*a))
    rows = tsess.query(tpch.QUERIES["q15"])
    assert len(rows) == 1 and calls == [["lineitem.l_suppkey"]]


def test_string_tables_are_built_once_per_dictionary(tpch_sessions, monkeypatch):
    """q22's SUBSTRING and q16's NOT LIKE run host work over every distinct
    value; a second run of the query reuses the tables its first run built."""
    from baikaldb_tpu_torch.column.dictionary import Dictionary

    _, tsess = tpch_sessions
    first = {q: tsess.query(tpch.QUERIES[q]) for q in ("q22", "q16")}
    built = []
    memo = Dictionary.memo
    monkeypatch.setattr(Dictionary, "memo",
                        lambda self, key, build: memo(self, key,
                                                      lambda: built.append(key) or build()))
    for q, rows in first.items():
        assert tsess.query(tpch.QUERIES[q]) == rows
    assert built == []
    phone = tsess.db.stores["default.customer"].device_table_batch().column("c_phone")
    assert ("substr", 1, 2) in phone.dictionary._memo


def test_string_tables_are_bounded_per_dictionary():
    """Ad-hoc LIKE patterns do not grow a dictionary's tables without limit:
    the least recently used goes, and a pattern in use stays."""
    import pyarrow as pa

    from baikaldb_tpu_torch.column.dictionary import MEMO_MAX

    s = TSession(device="cpu")
    s.execute("CREATE TABLE p (k INT, phone VARCHAR(20))")
    s.load_arrow("p", pa.table({"k": list(range(300)),
                                "phone": [f"{i % 97:02d}-{i:04d}" for i in range(300)]}))
    for i in range(3 * MEMO_MAX):
        assert s.query(f"SELECT COUNT(*) AS n FROM p WHERE phone LIKE '%-{i:04d}'") \
            == [{"n": 1}]
        s.query("SELECT COUNT(*) AS n FROM p WHERE phone LIKE '%-0007'")
    memo = s.db.stores["default.p"].device_table_batch().column("phone").dictionary._memo
    assert len(memo) == MEMO_MAX
    assert ("like", "%-0007") in memo


def test_derived_key_ignores_generated_names_only():
    from baikaldb_tpu_torch.exec.executor import derived_key
    from baikaldb_tpu_torch.plan.nodes import ProjectNode

    def view_copies(sql):
        plan = TSession(device="cpu")
        plan.execute("CREATE TABLE t (k INT, v DOUBLE, __c1 DOUBLE, __c2 DOUBLE)")
        root = plan._plan_select(parse_sql(sql)[0])
        found = []

        def walk(n):
            if isinstance(n, ProjectNode) and n.derived:
                found.append(n)
            for c in n.children:
                walk(c)
        walk(root)
        return [derived_key(n) for n in found]

    same = view_copies("WITH r AS (SELECT k, SUM(v) s FROM t GROUP BY k) "
                       "SELECT r.k FROM r WHERE r.s = (SELECT MAX(s) FROM r)")
    assert len(same) == 2 and same[0] == same[1]
    other = view_copies("SELECT a.k FROM (SELECT k, SUM(v) s FROM t GROUP BY k) a "
                        "JOIN (SELECT k, MIN(v) s FROM t GROUP BY k) b ON a.k = b.k")
    assert len(other) == 2 and other[0] != other[1]
    # user columns named like generated ones are the table's own data
    users = view_copies("SELECT a.k FROM (SELECT k, SUM(__c1) s FROM t GROUP BY k) a "
                        "JOIN (SELECT k, SUM(__c2) s FROM t GROUP BY k) b ON a.k = b.k")
    assert len(users) == 2 and users[0] != users[1]
