"""Pushed-down plan fragments of the port (baikaldb_tpu_torch/plan/fragment.py)
against the JAX package's.

``tests/test_pushdown.py``'s pure cases on the same seeded rows: every
query's fragment is built by both packages (``build_push_query``), its
canonical body and content key are the same bytes (``frag_canonical``,
``frag_wire_key``: a body one package publishes warm-starts a daemon of the
other), each region third runs through ``run_fragment`` and the payloads
merge (``merge_push_results``) to the JAX package's rows; the port's pushed
rows also equal its own image path on the CPU.  The refusals (shapes a
store cannot run) refuse alike.
"""

import numpy as np
import pytest

from baikaldb_tpu.meta.catalog import TableInfo as JTableInfo
from baikaldb_tpu.plan import fragment as jfrag
from baikaldb_tpu.sql.parser import parse_sql as jparse
from baikaldb_tpu.types import Field as JField
from baikaldb_tpu.types import LType as JLType
from baikaldb_tpu.types import Schema as JSchema
from baikaldb_tpu_torch.meta.catalog import TableInfo
from baikaldb_tpu_torch.plan import fragment as tfrag
from baikaldb_tpu_torch.sql.parser import parse_sql
from baikaldb_tpu_torch.types import Field, LType, Schema

_COLS = (("id", "INT64", False), ("v", "FLOAT64", True), ("grp", "INT64", True),
         ("name", "STRING", True))
SCHEMA = Schema(tuple(Field(n, LType[t], nl) for n, t, nl in _COLS))
INFO = TableInfo(1, "ns", "default", "t", SCHEMA)
JINFO = JTableInfo(1, "ns", "default", "t",
                   JSchema(tuple(JField(n, JLType[t], nl) for n, t, nl in _COLS)))


def _rows(seed: int = 17, n: int = 240) -> list:
    rng = np.random.default_rng(seed)
    v = rng.uniform(-50, 150, n).round(3)
    return [{"id": i,
             "v": None if i % 11 == 0 else float(v[i]),
             "grp": int(rng.integers(0, 4)),
             "name": None if i % 13 == 0 else f"name{int(rng.integers(0, 7))}"}
            for i in range(n)]


ROWS = _rows()

QUERIES = [
    "SELECT id, v FROM t WHERE v > 40 ORDER BY id",
    "SELECT id FROM t WHERE v IS NULL ORDER BY id",
    "SELECT id FROM t WHERE name = 'name3' ORDER BY id",
    "SELECT id FROM t WHERE name LIKE 'name%' AND id < 20 ORDER BY id",
    "SELECT id FROM t WHERE id BETWEEN 10 AND 15 ORDER BY id",
    "SELECT id FROM t WHERE grp IN (1, 3) AND v IS NOT NULL ORDER BY id",
    "SELECT id, id + grp * 2 x FROM t WHERE id < 10 ORDER BY x DESC, id",
    "SELECT COUNT(*) n, COUNT(v) nv, SUM(v) s, MIN(v) lo, MAX(v) hi FROM t",
    "SELECT grp, COUNT(*) n, AVG(v) a FROM t GROUP BY grp ORDER BY grp",
    "SELECT grp, SUM(v) s FROM t WHERE id >= 100 GROUP BY grp "
    "HAVING SUM(v) > 1000 ORDER BY s DESC",
    "SELECT grp, MAX(id) m FROM t GROUP BY grp ORDER BY m LIMIT 2",
    "SELECT SUM(v) s FROM t WHERE v < -1000",
    "SELECT upper(name) u, id FROM t WHERE id IN (1, 2) ORDER BY id",
    "SELECT id FROM t WHERE NOT (v > 40 OR v IS NULL) AND grp <> 2 ORDER BY id LIMIT 5",
    "SELECT id FROM t ORDER BY id LIMIT 4 OFFSET 3",
    "SELECT CASE WHEN grp = 0 THEN 'z' ELSE 'nz' END c, COUNT(*) n "
    "FROM t GROUP BY grp ORDER BY grp",
    "SELECT id, v FROM t WHERE id < 30 ORDER BY 2 DESC, 1 ASC",
    "SELECT grp, SUM(v) s FROM t GROUP BY grp ORDER BY 2 DESC",
    "SELECT name, COUNT(*) n, MIN(v) lo FROM t GROUP BY name ORDER BY name",
    "SELECT id, HEX(id) h, BIN(grp) b FROM t WHERE id IN (1, 2, 17) ORDER BY id",
]

NOT_PUSHABLE = [
    "SELECT DISTINCT grp FROM t",
    "SELECT grp, COUNT(DISTINCT v) FROM t GROUP BY grp",
    "SELECT id FROM t a JOIN t b ON a.id = b.id",
    "SELECT id, SUM(v) OVER (PARTITION BY grp) FROM t",
    "SELECT id FROM t WHERE v > (SELECT AVG(v) FROM t)",
    "SELECT v FROM t GROUP BY grp",
    "SELECT id FROM t ORDER BY 3",
]


def _pushed(mod, parse, info, sql):
    push = mod.build_push_query(parse(sql)[0], info)
    assert push is not None, f"not pushable: {sql}"
    third = len(ROWS) // 3
    parts = [ROWS[:third], ROWS[third:2 * third], ROWS[2 * third:]]
    payloads = [mod.run_fragment(iter([dict(r) for r in p]), push.frag) for p in parts]
    return push, payloads, mod.merge_push_results(push, payloads)


def _norm(rows):
    return [tuple(round(v, 6) if isinstance(v, float) else v for v in r) for r in rows]


@pytest.fixture(scope="module")
def image():
    """The port's image path on the CPU over the same rows."""
    from baikaldb_tpu_torch.exec.session import Session

    s = Session(device="cpu")
    s.execute("CREATE TABLE t (id BIGINT NOT NULL, v DOUBLE, grp BIGINT, "
              "name VARCHAR(32), PRIMARY KEY (id))")
    vals = ", ".join("({}, {}, {}, {})".format(
        r["id"], "NULL" if r["v"] is None else r["v"], r["grp"],
        "NULL" if r["name"] is None else f"'{r['name']}'") for r in ROWS)
    s.execute(f"INSERT INTO t (id, v, grp, name) VALUES {vals}")
    return s


@pytest.mark.parametrize("sql", QUERIES)
def test_fragment_matches_jax_and_image_path(image, sql):
    tpush, tpay, (tnames, trows) = _pushed(tfrag, parse_sql, INFO, sql)
    jpush, jpay, (jnames, jrows) = _pushed(jfrag, jparse, JINFO, sql)
    # one body, one key, one payload per region, one merged result
    assert tfrag.frag_canonical(tpush.frag) == jfrag.frag_canonical(jpush.frag)
    assert tfrag.frag_wire_key(tpush.frag) == jfrag.frag_wire_key(jpush.frag)
    assert tpay == jpay
    assert tnames == jnames
    assert _norm(trows) == _norm(jrows)
    want = image.query(sql)
    got = [dict(zip(tnames, r)) for r in trows]
    if "ORDER BY" in sql:
        assert _norm([tuple(r.values()) for r in got]) == \
            _norm([tuple(r.values()) for r in want])
    else:
        assert sorted(_norm([tuple(r.values()) for r in got]), key=repr) == \
            sorted(_norm([tuple(r.values()) for r in want]), key=repr)


@pytest.mark.parametrize("sql", NOT_PUSHABLE)
def test_not_pushable_shapes_refused_alike(sql):
    assert tfrag.build_push_query(parse_sql(sql)[0], INFO) is None
    assert jfrag.build_push_query(jparse(sql)[0], JINFO) is None


@pytest.mark.parametrize("rows,sql,want", [
    # WHERE <string> keeps the numerically truthy values (MySQL coercion)
    ([{"id": 1, "s": "0"}, {"id": 2, "s": "3"}, {"id": 3, "s": "abc"},
      {"id": 4, "s": None}, {"id": 5, "s": "2drinks"}],
     "SELECT id FROM t WHERE s ORDER BY id", [(2,), (5,)]),
    # SUM over a string column coerces numerically
    ([{"id": 1, "s": "2"}, {"id": 2, "s": "3.5"}, {"id": 3, "s": "abc"},
      {"id": 4, "s": None}], "SELECT SUM(s) x FROM t", [(5.5,)]),
], ids=["string_truthiness", "sum_of_strings"])
def test_string_coercions_match_jax(rows, sql, want):
    info = TableInfo(2, "ns", "default", "t",
                     Schema((Field("id", LType.INT64, False), Field("s", LType.STRING, True))))
    jinfo = JTableInfo(2, "ns", "default", "t",
                       JSchema((JField("id", JLType.INT64, False),
                                JField("s", JLType.STRING, True))))
    got = tfrag.merge_push_results(
        p := tfrag.build_push_query(parse_sql(sql)[0], info),
        [tfrag.run_fragment(iter(rows), p.frag)])[1]
    jgot = jfrag.merge_push_results(
        q := jfrag.build_push_query(jparse(sql)[0], jinfo),
        [jfrag.run_fragment(iter(rows), q.frag)])[1]
    assert got == jgot == want


def test_duplicate_aliases_keep_distinct_values():
    push = tfrag.build_push_query(parse_sql("SELECT id, v AS id FROM t WHERE id = 2 ORDER BY 1")[0],
                                  INFO)
    names, rows = tfrag.merge_push_results(push, [tfrag.run_fragment(iter(ROWS), push.frag)])
    assert names == ["id", "id"]
    assert rows == [(2, ROWS[2]["v"])]


def test_int_div_and_mod_match_jax():
    from baikaldb_tpu.expr import ast as jast
    from baikaldb_tpu.expr.roweval import eval_row as jeval
    from baikaldb_tpu_torch.expr import ast as tast
    from baikaldb_tpu_torch.expr.roweval import eval_row

    big = 10 ** 18
    for op, a, b in [("int_div", -7, 2), ("int_div", 7, 2), ("mod", -5, 3), ("mod", 5, -3),
                     ("int_div", big, 3), ("mod", big, 7)]:
        got = eval_row(tast.call(op, tast.lit(a), tast.lit(b)), {})
        assert got == jeval(jast.call(op, jast.lit(a), jast.lit(b)), {})
    assert eval_row(tast.call("int_div", tast.lit(-7), tast.lit(2)), {}) == -4
    assert eval_row(tast.call("mod", tast.lit(-5), tast.lit(3)), {}) == -2
