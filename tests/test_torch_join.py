"""The port's ops/join.py and DISTINCT aggregates against the JAX package.

The same numpy state (fixed seeds) builds a JAX ``ColumnBatch`` and, through
``ColumnBatch.from_numpy``, the port's batch on the CPU.  The JAX joins emit
``cap`` rows whose dead tail is masked by ``sel``; the port emits exactly the
matched rows.  Both are densified to their live rows and compared as
multisets, exactly (a join moves values, it computes none).  DISTINCT sums
and averages match to rtol 1e-12.

The JAX expanding joins cannot take a zero-length side, so the zero-length
cases are held to the SQL result they must give instead.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from baikaldb_tpu.column.batch import Column as JColumn, ColumnBatch as JBatch
from baikaldb_tpu.column.dictionary import Dictionary as JDict
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.ops import hashagg as jagg
from baikaldb_tpu.ops import join as jjoin
from baikaldb_tpu.types import LType as JLType
from baikaldb_tpu_torch.column.batch import ColumnBatch as TBatch
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.ops import hashagg as tagg
from baikaldb_tpu_torch.ops import join as tjoin

HOWS = ["inner", "left", "semi", "anti"]
FRUIT = np.asarray(["apple", "banana", "cherry", "date", "fig"], dtype=str)
BERRY = np.asarray(["banana", "date", "elder", "fig", "grape"], dtype=str)


def _pair(state: dict, sel):
    """name -> (data, validity|None, ltype, dict values|None) -> both batches."""
    names = tuple(state)
    jcols = [JColumn(jnp.asarray(d), None if v is None else jnp.asarray(v),
                     JLType(lt), None if dv is None else JDict(dv))
             for d, v, lt, dv in state.values()]
    jb = JBatch(names, jcols, None if sel is None else jnp.asarray(sel))
    tb = TBatch.from_numpy(names, list(state.values()), sel=sel, device="cpu")
    return jb, tb


def _rows(batch) -> list[tuple]:
    return [tuple(r.values()) for r in batch.to_pylist()]


def _canon(row):
    return tuple((v is not None, v if v is not None else 0) for v in row)


def _same_rows(got, want):
    assert sorted(_rows(got), key=_canon) == sorted(_rows(want), key=_canon)


def _sides(seed: int, key: str, np_=300, nb=120):
    """A probe and a build side with duplicate build keys, NULL keys and dead
    rows on both sides.  ``key``: int | two | string (the two sides' string
    dictionaries come from different tables)."""
    rng = np.random.default_rng(seed)
    if key == "string":
        pk = {"pk": (rng.integers(0, len(FRUIT), np_).astype(np.int32),
                     rng.random(np_) > 0.1, "string", FRUIT)}
        bk = {"bk": (rng.integers(0, len(BERRY), nb).astype(np.int32),
                     rng.random(nb) > 0.1, "string", BERRY)}
    else:
        pk = {"pk": (rng.integers(0, 60, np_).astype(np.int32),
                     rng.random(np_) > 0.1, "int32", None)}
        bk = {"bk": (rng.integers(10, 70, nb).astype(np.int32),
                     rng.random(nb) > 0.1, "int32", None)}
        if key == "two":
            pk["pk2"] = (rng.integers(0, 3, np_).astype(np.int32), None, "int32", None)
            bk["bk2"] = (rng.integers(0, 3, nb).astype(np.int32),
                         rng.random(nb) > 0.1, "int32", None)
    probe = dict(pk, pv=(rng.normal(size=np_), rng.random(np_) > 0.2, "float64", None))
    build = dict(bk, bv=(rng.integers(-5, 5, nb).astype(np.int64), None, "int64", None))
    return (_pair(probe, rng.random(np_) > 0.2), _pair(build, rng.random(nb) > 0.2),
            [k for k in probe if k != "pv"], [k for k in build if k != "bv"])


@pytest.mark.parametrize("key", ["int", "two", "string"])
@pytest.mark.parametrize("how", HOWS)
def test_join_matches_jax(how, key):
    (jp, tp), (jb, tb), pkeys, bkeys = _sides(1, key)
    want, _ = jjoin.join(jp, pkeys, jb, bkeys, how=how, cap=4096)
    got, total = tjoin.join(tp, pkeys, tb, bkeys, how=how)
    _same_rows(got, want)
    if how in ("inner", "left"):
        assert total == len(got) == len(_rows(want)) and got.sel is None


@pytest.mark.parametrize("how", HOWS)
def test_join_with_a_key_sorted_build_matches_jax(how):
    """``build_sorted``: the build's live rows arrive in key order, so a
    stable partition by deadness replaces the sort."""
    (jp, tp), _, pkeys, bkeys = _sides(10, "int")
    rng = np.random.default_rng(10)
    build = {"bk": (np.sort(rng.integers(10, 70, 120)).astype(np.int32),
                    rng.random(120) > 0.1, "int32", None),
             "bv": (np.arange(120, dtype=np.int64), None, "int64", None)}
    jb, tb = _pair(build, rng.random(120) > 0.2)
    want, _ = jjoin.join(jp, pkeys, jb, bkeys, how=how, cap=4096, build_sorted=True)
    got, _ = tjoin.join(tp, pkeys, tb, bkeys, how=how, build_sorted=True)
    _same_rows(got, want)


@pytest.mark.parametrize("how", HOWS)
def test_join_with_no_live_build_row_matches_jax(how):
    (jp, tp), _, pkeys, bkeys = _sides(2, "int")
    (jb, tb) = _pair({"bk": (np.arange(5, dtype=np.int32), None, "int32", None),
                      "bv": (np.arange(5, dtype=np.int64), None, "int64", None)},
                     np.zeros(5, bool))
    want, _ = jjoin.join(jp, pkeys, jb, bkeys, how=how, cap=512)
    got, _ = tjoin.join(tp, pkeys, tb, bkeys, how=how)
    _same_rows(got, want)


@pytest.mark.parametrize("how", HOWS)
def test_join_with_a_zero_length_side(how):
    rng = np.random.default_rng(3)
    _, tp = _pair({"pk": (rng.integers(0, 9, 40).astype(np.int32), rng.random(40) > 0.2,
                          "int32", None)}, rng.random(40) > 0.3)
    _, tb = _pair({"bk": (np.zeros(0, np.int32), None, "int32", None),
                   "bv": (np.zeros(0, np.float64), None, "float64", None)}, None)
    got, _ = tjoin.join(tp, ["pk"], tb, ["bk"], how=how)
    live = [r for r, s in zip(_rows(TBatch(tp.names, tp.columns)), tp.sel.tolist()) if s]
    want = {"inner": [], "semi": [], "left": [r + (None, None) for r in live], "anti": live}[how]
    assert sorted(_rows(got), key=_canon) == sorted(want, key=_canon)
    # and a zero-length probe side gives no rows
    got, total = tjoin.join(tb, ["bk"], tp, ["pk"], how=how)
    assert _rows(got) == [] and total == 0


def _dense_sides(seed: int):
    rng = np.random.default_rng(seed)
    nb, np_ = 200, 500
    # a unique build key over [100, 100 + 260), some dead, one NULL
    bkeys = rng.permutation(260)[:nb].astype(np.int32) + 100
    bvalid = np.ones(nb, bool)
    bvalid[7] = False
    build = {"bk": (bkeys, bvalid, "int32", None),
             "bs": (rng.integers(0, len(BERRY), nb).astype(np.int32), None, "string", BERRY)}
    probe = {"pk": (rng.integers(90, 370, np_).astype(np.int32), rng.random(np_) > 0.1,
                    "int32", None),
             "pv": (rng.normal(size=np_), None, "float64", None)}
    return _pair(probe, rng.random(np_) > 0.2), _pair(build, rng.random(nb) > 0.15)


@pytest.mark.parametrize("how", HOWS)
def test_dense_join_matches_jax(how):
    (jp, tp), (jb, tb) = _dense_sides(4)
    want, _ = jjoin.dense_join(jp, ["pk"], jb, ["bk"], [100], [260], how=how)
    got, _ = tjoin.dense_join(tp, ["pk"], tb, ["bk"], [100], [260], how=how)
    _same_rows(got, want)
    # the live build rows scatter into distinct slots: only the spillway slot
    # takes several writers
    slot, ok = tjoin._dense_slots(tb, ["bk"], [100], [260])
    live = slot[ok & tb.sel]
    assert live.unique().numel() == live.numel()


def test_dense_join_two_keys_matches_jax():
    rng = np.random.default_rng(5)
    a, b = np.divmod(rng.permutation(40 * 7)[:150], 7)
    build = {"b1": (a.astype(np.int32), None, "int32", None),
             "b2": (b.astype(np.int32), None, "int32", None),
             "bv": (rng.normal(size=150), None, "float64", None)}
    probe = {"p1": (rng.integers(-2, 42, 400).astype(np.int32), None, "int32", None),
             "p2": (rng.integers(0, 8, 400).astype(np.int32), rng.random(400) > 0.1,
                    "int32", None)}
    (jp, tp), (jb, tb) = _pair(probe, rng.random(400) > 0.1), _pair(build, None)
    for how in HOWS:
        want, _ = jjoin.dense_join(jp, ["p1", "p2"], jb, ["b1", "b2"], [0, 0], [40, 7], how=how)
        got, _ = tjoin.dense_join(tp, ["p1", "p2"], tb, ["b1", "b2"], [0, 0], [40, 7], how=how)
        _same_rows(got, want)


@pytest.mark.parametrize("how", ["semi", "anti"])
def test_semi_join_neq_matches_jax(how):
    rng = np.random.default_rng(6)
    n, m = 400, 900
    probe = {"ok": (rng.integers(0, 80, n).astype(np.int32), None, "int32", None),
             "os": (rng.integers(0, 6, n).astype(np.int32), rng.random(n) > 0.05,
                    "int32", None)}
    build = {"lk": (rng.integers(0, 80, m).astype(np.int32), rng.random(m) > 0.05,
                    "int32", None),
             "ls": (rng.integers(0, 6, m).astype(np.int32), rng.random(m) > 0.05,
                    "int32", None)}
    (jp, tp), (jb, tb) = _pair(probe, rng.random(n) > 0.2), _pair(build, rng.random(m) > 0.4)
    want, _ = jjoin.semi_join_neq(jp, ["ok"], jb, ["lk"], "os", "ls", how=how)
    got, _ = tjoin.semi_join_neq(tp, ["ok"], tb, ["lk"], "os", "ls", how=how)
    _same_rows(got, want)


def test_cross_join_matches_jax():
    rng = np.random.default_rng(8)
    (jp, tp) = _pair({"a": (np.arange(7, dtype=np.int32), None, "int32", None)},
                     rng.random(7) > 0.3)
    (jb, tb) = _pair({"b": (rng.integers(0, len(FRUIT), 5).astype(np.int32),
                            rng.random(5) > 0.2, "string", FRUIT)}, rng.random(5) > 0.3)
    want, _ = jjoin.cross_join(jp, jb)
    got, total = tjoin.cross_join(tp, tb)
    _same_rows(got, want)
    assert total == int(tp.sel.sum()) * int(tb.sel.sum())


def _agg_state(seed):
    rng = np.random.default_rng(seed)
    n = 2000
    return {"g": (rng.integers(0, 40, n).astype(np.int32), rng.random(n) > 0.05,
                  "int32", None),
            "x": (rng.integers(0, 30, n).astype(np.int64), rng.random(n) > 0.1,
                  "int64", None),
            "w": (np.round(rng.normal(size=n), 1), rng.random(n) > 0.1, "float64", None),
            }, rng.random(n) > 0.2


def _distinct_specs(mod):
    return [mod.AggSpec(op, col, f"{op}_{col}", distinct=True)
            for op in ("count", "sum", "avg") for col in ("x", "w")]


def _assert_close_rows(got, want):
    g, w = sorted(_rows(got), key=_canon), sorted(_rows(want), key=_canon)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        for a, b in zip(rg, rw):
            if isinstance(b, float):
                assert math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-12), (a, b)
            else:
                assert a == b


@pytest.mark.parametrize("kind", ["scalar", "sorted", "dense"])
def test_distinct_aggregates_match_jax(kind):
    jb, tb = _pair(*_agg_state(9))
    js, ts = _distinct_specs(jagg), _distinct_specs(tagg)
    if kind == "scalar":
        want, got = jagg.scalar_aggregate(jb, js), tagg.scalar_aggregate(tb, ts)
    elif kind == "sorted":
        want = jagg.group_aggregate_sorted(jb, ["g"], js, 64)
        got = tagg.group_aggregate_sorted(tb, ["g"], ts, 64)
    else:
        want = jagg.group_aggregate_dense(jb, ["g"], [40], js)
        got = tagg.group_aggregate_dense(tb, ["g"], [40], ts)
    _assert_close_rows(got, want)


@pytest.fixture(scope="module")
def sub_sessions():
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute("CREATE TABLE a (id INT, k INT, name VARCHAR(8))")
        s.execute("CREATE TABLE b (k INT, tag VARCHAR(8))")
        s.execute("INSERT INTO a (id, k, name) VALUES (1, 1, 'x'), (2, 2, 'y'), "
                  "(3, NULL, 'z'), (4, 4, NULL), (5, 5, 'y')")
        s.execute("INSERT INTO b (k, tag) VALUES (1, 'y'), (2, 'q'), (NULL, 'x'), "
                  "(2, 'r')")
        out.append(s)
    return out


SUBQUERIES = {
    "in_null_in_list": "SELECT id, k IN (SELECT k FROM b) AS m FROM a ORDER BY id",
    "not_in_null_in_list": "SELECT id, k NOT IN (SELECT k FROM b) AS m FROM a ORDER BY id",
    "not_in_no_null": "SELECT id FROM a WHERE k NOT IN (SELECT k FROM b WHERE k IS NOT NULL) "
                      "ORDER BY id",
    "in_strings": "SELECT id FROM a WHERE name IN (SELECT tag FROM b) ORDER BY id",
    "in_empty_list": "SELECT id, k NOT IN (SELECT k FROM b WHERE k > 9) AS m FROM a "
                     "ORDER BY id",
    "scalar_one_row": "SELECT id FROM a WHERE k = (SELECT MAX(k) FROM b) ORDER BY id",
    "scalar_no_row": "SELECT id, (SELECT k FROM b WHERE k > 9) AS s FROM a ORDER BY id",
    "left_join_null_keys": "SELECT a.id, b.tag FROM a LEFT JOIN b ON a.k = b.k "
                           "ORDER BY a.id, b.tag",
    "exists": "SELECT id FROM a WHERE EXISTS (SELECT 1 FROM b WHERE b.k = a.k) ORDER BY id",
    "union": "SELECT name AS v FROM a UNION ALL SELECT tag FROM b",
    "count_distinct": "SELECT COUNT(DISTINCT name), COUNT(DISTINCT k) FROM a",
}


@pytest.mark.parametrize("name", list(SUBQUERIES))
def test_subqueries_match_jax(sub_sessions, name):
    jsess, tsess = sub_sessions
    sql = SUBQUERIES[name]
    want, got = jsess.query(sql), tsess.query(sql)
    if "ORDER BY" in sql:
        assert got == want
    else:
        assert sorted(map(_canon, (tuple(r.values()) for r in got))) == \
            sorted(map(_canon, (tuple(r.values()) for r in want)))


def test_in_with_null_in_list_is_three_valued(sub_sessions):
    _, tsess = sub_sessions
    rows = tsess.query(SUBQUERIES["not_in_null_in_list"])
    # 1 and 2 are in the list; 3 is a NULL key; 4 and 5 miss a list with NULL
    assert [r["m"] for r in rows] == [False, False, None, None, None]


def test_scalar_subquery_with_two_rows_raises(sub_sessions):
    sql = "SELECT id FROM a WHERE k = (SELECT k FROM b WHERE k = 2)"
    for sess in sub_sessions:
        with pytest.raises(Exception, match="Subquery returns more than 1 row"):
            sess.query(sql)
