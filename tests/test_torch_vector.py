"""The port's vector surface against the JAX package, on the CPU.

``ops/vector.py`` (every case of tests/test_vector.py, through both
packages on the same seeded numpy inputs), the vectorized ingest of list
columns, and VECTOR columns with the distance functions through both
sessions (the single-device half of tests/test_vector_sql.py).

Tolerances: ``brute_force_topk`` / ``ivf_topk`` scores within rtol 1e-5 and
the indices equal wherever the k-th and (k+1)-th scores differ by more than
that (an L2 score is ||q||^2 - 2 q.b + ||b||^2, which cancels: there the
tolerance is 1e-5 of the squared norms it is made of); ``kmeans`` on
separated clusters: assignments equal, centroids within atol 1e-4; SQL: the
same rows in the same order, distances within rtol 1e-12 (L2_DISTANCE and
INNER_PRODUCT are DOUBLE all through) or 1e-6 (COSINE_DISTANCE: DOUBLE, but
the row's norm is a FLOAT sum of FLOAT squares in both packages).
"""

import math

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from baikaldb_tpu.exec import session as jsession
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.ops import vector as jv
from baikaldb_tpu.plan.planner import PlanError as JPlanError
from baikaldb_tpu_torch.exec import session as tsession
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.ops import vector as tv
from baikaldb_tpu_torch.plan.planner import PlanError as TPlanError

RTOL = 1e-5


def _both_topk(fn_j, fn_t, q, base, k, **kw):
    js, ji = fn_j(jnp.asarray(q), jnp.asarray(base), None, k, **kw)
    ts, ti = fn_t(torch.from_numpy(q), torch.from_numpy(base), None, k, **kw)
    return (np.asarray(js), np.asarray(ji)), (ts.numpy(), ti.numpy())


def assert_topk_match(j, t, full_scores=None):
    """Scores within RTOL; indices equal where the ranking is not within
    RTOL of a tie (the k-th against the (k+1)-th score when given)."""
    (js, ji), (ts, ti) = j, t
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=1e-6)
    _assert_order(js, ji, ti, full_scores)


def l2_atol(q, base):
    """1e-5 of the largest ||q||^2 + ||b||^2 an L2 score is made of."""
    return RTOL * float((q * q).sum(1).max() + (base * base).sum(1).max())


def _assert_order(js, ji, ti, full_scores=None):
    for r in range(js.shape[0]):
        s = js[r]
        scale = np.maximum(np.abs(s), 1e-6)
        gaps = np.abs(np.diff(s)) > RTOL * scale[1:]
        if full_scores is not None:
            kth, nxt = np.sort(full_scores[r])[::-1][[len(s) - 1, len(s)]]
            if abs(kth - nxt) <= RTOL * max(abs(kth), 1e-6):
                continue
        for c in range(len(s)):
            clear = (c == 0 or gaps[c - 1]) and (c == len(s) - 1 or gaps[c])
            if clear:
                assert ti[r, c] == ji[r, c], (r, c, ti[r], ji[r])


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_brute_force_topk_matches_jax(metric, precision):
    rng = np.random.default_rng(0)
    base = rng.normal(size=(500, 32)).astype(np.float32)
    q = rng.normal(size=(7, 32)).astype(np.float32)
    j, t = _both_topk(jv.brute_force_topk, tv.brute_force_topk, q, base, 5,
                      metric=metric, precision=precision)
    full = tv._scores(torch.from_numpy(q), torch.from_numpy(base), metric,
                      precision).numpy()
    assert_topk_match(j, t, full)
    if metric == "l2" and precision == "f32":
        # tests/test_vector.py::test_brute_force_exact_l2's numpy checks
        d = ((q[:, None, :] - base[None, :, :]) ** 2).sum(-1)
        want = np.argsort(d, axis=1)[:, :5]
        assert np.array_equal(t[1][:, 0], want[:, 0])
        assert all(set(t[1][i]) == set(want[i]) for i in range(7))


def test_bf16_scores_are_float32_products_of_rounded_inputs():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, 64)).astype(np.float32)
    b = rng.normal(size=(40, 64)).astype(np.float32)
    s = tv._scores(torch.from_numpy(q), torch.from_numpy(b), "ip", "bf16")
    assert s.dtype is torch.float32
    want = np.asarray(jv._scores(jnp.asarray(q), jnp.asarray(b), "ip", "bf16"))
    np.testing.assert_allclose(s.numpy(), want, rtol=RTOL, atol=1e-5)
    # not bf16-rounded scores: most differ from their own bf16 rounding
    rounded = s.to(torch.bfloat16).float()
    assert (rounded != s).float().mean() > 0.5


def test_top_k_ties_take_the_lower_index_first():
    base = np.zeros((12, 4), np.float32)
    base[[2, 5, 7, 11]] = [1, 0, 0, 0]            # four equal nearest rows
    base[[0, 9]] = [0.5, 0, 0, 0]                 # two equal next ones
    q = np.asarray([[1, 0, 0, 0]], np.float32)
    for metric in ("l2", "ip"):
        j, t = _both_topk(jv.brute_force_topk, tv.brute_force_topk, q, base, 6,
                          metric=metric, precision="f32")
        assert t[1].tolist() == j[1].tolist() == [[2, 5, 7, 11, 0, 9]]
    # -inf slots (dead rows) keep index order too, and equal jax's
    valid = np.zeros(12, bool)
    valid[[3, 8]] = True
    js, ji = jv.brute_force_topk(jnp.asarray(q), jnp.asarray(base), jnp.asarray(valid),
                                 5, "l2", "f32")
    ts, ti = tv.brute_force_topk(torch.from_numpy(q), torch.from_numpy(base),
                                 torch.from_numpy(valid), 5, "l2", "f32")
    assert ti.tolist() == np.asarray(ji).tolist() == [[3, 8, 0, 1, 2]]
    assert np.isneginf(ts.numpy()[0, 2:]).all()


def test_ordered_key_keeps_float_order():
    x = torch.tensor([[-np.inf, -3.5, -0.0, 0.0, 1e-30, 2.0, np.inf, -1e-30]],
                     dtype=torch.float32)
    key = tv._ordered_i32(x)[0].tolist()
    order = sorted(range(8), key=lambda i: key[i])
    assert order == [0, 1, 7, 2, 3, 4, 5, 6]


def _vector_index(mod, **kw):
    return mod.VectorIndex(**kw, device="cpu") if mod is tv else mod.VectorIndex(**kw)


def test_index_add_search_delete_matches_jax():
    rng = np.random.default_rng(1)
    base = rng.normal(size=(200, 16)).astype(np.float32)
    q = base[17:18] + 0.001
    out = []
    for mod in (jv, tv):
        ix = _vector_index(mod, dim=16, metric="l2")
        ix.add(np.arange(200), base)
        ids, scores = ix.search(q, k=3)
        assert ids[0, 0] == 17
        ix.delete([17])
        ids2, scores2 = ix.search(q, k=3)
        assert 17 not in ids2[0] and len(ix) == 199
        out.append((ids, scores, ids2, scores2))
    (a, b, c, d), (e, f, g, h) = out
    assert np.array_equal(a, e) and np.array_equal(c, g)
    np.testing.assert_allclose(f, b, rtol=RTOL, atol=l2_atol(q, base))
    np.testing.assert_allclose(h, d, rtol=RTOL, atol=l2_atol(q, base))


def test_ip_and_cosine_match_jax():
    rng = np.random.default_rng(2)
    base = rng.normal(size=(100, 8)).astype(np.float32)
    q = base[5:6] * 3
    for metric, want in (("ip", int(np.argmax(base @ q[0]))), ("cosine", 5)):
        got = []
        for mod in (jv, tv):
            ix = _vector_index(mod, dim=8, metric=metric)
            ix.add(np.arange(100), base)
            ids, scores = ix.search(q, k=4)
            assert ids[0, 0] == want
            got.append((ids, scores))
        assert np.array_equal(got[0][0], got[1][0])
        np.testing.assert_allclose(got[1][1], got[0][1], rtol=RTOL)


def test_ivf_recall_matches_jax():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(4000, 24)).astype(np.float32)
    q = base[rng.choice(4000, 20)] + 0.0005
    recalls = []
    for mod in (jv, tv):
        ix = _vector_index(mod, dim=24, metric="l2", ivf_threshold=1000,
                           n_clusters=32, nprobe=16)
        ix.add(np.arange(4000), base)
        ids, _ = ix.search(q, k=10)
        exact = _vector_index(mod, dim=24, metric="l2", ivf_threshold=10**9)
        exact.add(np.arange(4000), base)
        gt, _ = exact.search(q, k=10)
        recalls.append(np.mean([len(set(ids[i]) & set(gt[i])) / 10 for i in range(20)]))
    assert min(recalls) >= 0.8, recalls
    assert abs(recalls[0] - recalls[1]) <= 0.05, recalls


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_ivf_topk_with_jax_centroids_matches_jax(metric):
    """The JAX-trained centroids and assignments go to both ``ivf_topk``s:
    the probed clusters and the top-k are the same."""
    rng = np.random.default_rng(13)
    base = (rng.normal(size=(16, 12))[rng.integers(0, 16, 3000)] * 4
            + rng.normal(size=(3000, 12))).astype(np.float32)
    q = base[rng.choice(3000, 9)] + 0.01
    cent, assign = (np.array(a) for a in jv.kmeans(base, 16, iters=4))
    valid = rng.random(3000) > 0.1
    js, ji = jv.ivf_topk(jnp.asarray(q), jnp.asarray(base), jnp.asarray(valid),
                         jnp.asarray(cent), jnp.asarray(assign), 10, 4, metric, "f32")
    ts, ti = tv.ivf_topk(torch.from_numpy(q), torch.from_numpy(base), torch.from_numpy(valid),
                         torch.from_numpy(cent), torch.from_numpy(assign), 10, 4, metric,
                         "f32")
    atol = l2_atol(q, base) if metric == "l2" else 1e-6
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=atol)
    _assert_order(np.asarray(js), np.asarray(ji), ti.numpy())
    assert valid[ti.numpy()[np.isfinite(ts.numpy())]].all()


def test_probe_mask_equals_the_broadcast():
    rng = np.random.default_rng(4)
    assign = torch.from_numpy(rng.integers(0, 40, 5000))
    probe = torch.stack([torch.from_numpy(rng.choice(40, 6, replace=False))
                         for _ in range(7)])
    mask = torch.zeros((7, 40), dtype=torch.bool).scatter_(1, probe, True)
    gathered = mask.index_select(1, assign)
    broadcast = (assign[None, :, None] == probe[:, None, :]).any(-1)
    assert torch.equal(gathered, broadcast)


def test_pack_and_host_search_equal_jax():
    rng = np.random.default_rng(6)
    vecs = rng.normal(size=(900, 8)).astype(np.float32)
    assign = rng.integers(0, 12, 900)
    cents = rng.normal(size=(14, 8)).astype(np.float32)    # two empty clusters
    pj, pt = jv.pack_ivf(vecs, assign, 14), tv.pack_ivf(vecs, assign, 14)
    for a, b in zip(pj, pt):
        assert np.array_equal(a, b)
    order, starts, counts, _ = pt
    m = vecs[order]
    norms = (m * m).sum(1)
    valid = rng.random(900) > 0.2
    for metric in ("l2", "ip", "cosine"):
        for k, nprobe in ((5, 3), (40, 14), (2000, 14)):
            a = jv.ivf_search_host(vecs[3], m, valid, cents, starts, counts, k, nprobe,
                                   metric, norms)
            b = tv.ivf_search_host(vecs[3], m, valid, cents, starts, counts, k, nprobe,
                                   metric, norms)
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    # tests/test_ann_sql.py::test_empty_clusters_are_probeable
    v4 = np.asarray([[0.0, 0], [0.1, 0], [5, 5], [5.1, 5]], np.float32)
    order, starts, counts, _ = tv.pack_ivf(v4, np.asarray([0, 0, 1, 1]), n_clusters=3)
    _, idx = tv.ivf_search_host(np.asarray([99, 99], np.float32), v4[order], None,
                                np.asarray([[0, 0], [5, 5], [99, 99]], np.float32),
                                starts, counts, 2, 3)
    assert len(idx) == 2


def test_empty_and_small_k_match_jax():
    for mod in (jv, tv):
        ix = _vector_index(mod, dim=4)
        ids, scores = ix.search(np.zeros((1, 4), np.float32), k=3)
        assert ids.shape == (1, 3) and (ids == -1).all() and np.isneginf(scores).all()
        ix.add([1, 2], np.ones((2, 4), np.float32))
        ids, scores = ix.search(np.ones((1, 4), np.float32), k=5)
        assert ids.shape == (1, 5)
        assert ids[0].tolist() == [1, 2, -1, -1, -1]      # the tie in index order
        assert np.isneginf(scores[0, 2:]).all()
        # fewer live rows than k: the dead rows' -inf slots become -1
        ix.delete([1])
        ids, _ = ix.search(np.ones((1, 4), np.float32), k=3)
        assert ids[0].tolist() == [2, -1, -1]


@pytest.mark.parametrize("n_clusters", [2, 3, 8])
def test_kmeans_matches_jax_on_separated_clusters(n_clusters):
    rng = np.random.default_rng(4)
    a = rng.normal(size=(100, 4)) + 10
    b = rng.normal(size=(100, 4)) - 10
    c = rng.normal(size=(100, 4)) + [10, -10, 10, -10]
    x = np.concatenate([a, b] + ([c] if n_clusters > 2 else [])).astype(np.float32)
    jc, ja = jv.kmeans(x, n_clusters, iters=5)
    tc, ta = tv.kmeans(x, n_clusters, iters=5, device="cpu")
    assert tc.dtype == np.float64 and ta.dtype == np.int64
    assert np.array_equal(ta, ja)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-4)
    if n_clusters == 2:
        # tests/test_vector.py::test_kmeans_clusters
        assert len(set(ta[:100])) == 1 and len(set(ta[100:])) == 1
        assert ta[0] != ta[150]


def test_kmeans_starts_from_jax_initial_centroids():
    x = np.random.default_rng(8).normal(size=(300, 5)).astype(np.float32)
    jc, _ = jv.kmeans(x, 7, iters=0, seed=3)
    tc, _ = tv.kmeans(x, 7, iters=0, seed=3, device="cpu")
    assert np.array_equal(np.asarray(jc), tc)


def test_entry_points_need_cuda_unless_cpu_is_named():
    x = np.ones((10, 2), np.float32)
    if torch.cuda.is_available():
        assert tv.VectorIndex(2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tv.kmeans(x, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tv.VectorIndex(2)


# ----------------------------------------------------------------------
# ingest of list columns


def _ingest_cases():
    rng = np.random.default_rng(9)
    m = rng.normal(size=(7, 3)).astype(np.float32)
    rows = [list(map(float, r)) for r in m]
    with_null = rows[:2] + [None] + rows[3:]
    flat = pa.array(m.ravel())
    fixed = pa.FixedSizeListArray.from_arrays(flat, 3)
    return {
        "list": pa.array(rows),
        "list_nulls": pa.array(with_null),
        "large_list": pa.array(with_null, pa.large_list(pa.float64())),
        "list_float32": pa.array(with_null, pa.list_(pa.float32())),
        "fixed": fixed,
        "fixed_nulls": pa.FixedSizeListArray.from_arrays(
            flat, 3, mask=pa.array([False, True, False, False, True, False, False])),
        "sliced": pa.array(with_null).slice(1, 5),
        "fixed_sliced": fixed.slice(2, 4),
        "chunked": pa.chunked_array([pa.array(rows[:3]), pa.array(with_null[3:])]),
        "all_null": pa.array([None, None], pa.list_(pa.float64())),
        "ints": pa.array([[1, 2, 3], None, [4, 5, 6]]),
    }


@pytest.mark.parametrize("case", list(_ingest_cases()))
def test_vector_ingest_matches_jax_expansion(case):
    col = _ingest_cases()[case]
    t = pa.table({"id": np.arange(len(col)), "e": col})
    want = jsession._expand_vector_arrow(t, {"e": 3})
    got = tsession._expand_vector_arrow(t, {"e": 3})
    assert got.column_names == want.column_names
    for name in want.column_names:
        assert got.column(name).type == want.column(name).type, name
        assert got.column(name).to_pylist() == want.column(name).to_pylist(), name


@pytest.mark.parametrize("col", [
    pa.array([[1.0, 2.0, 3.0], [1.0, 2.0]]),
    pa.array([[1.0, 2.0, 3.0], None, [1.0, 2.0, 3.0, 4.0]]),
    pa.FixedSizeListArray.from_arrays(pa.array(np.zeros(8, np.float32)), 4),
], ids=["short", "long_after_null", "fixed_wrong_size"])
def test_vector_ingest_of_a_wrong_length_raises_as_jax(col):
    t = pa.table({"e": col})
    with pytest.raises(JPlanError, match="expects dim 3"):
        jsession._expand_vector_arrow(t, {"e": 3})
    with pytest.raises(TPlanError, match="expects dim 3"):
        tsession._expand_vector_arrow(t, {"e": 3})


@pytest.mark.parametrize("col", [pa.array([[1.0, None, 3.0], [1.0, 2.0, 3.0]]),
                                 pa.array([[1, None, 3], None, [4, 5, 6]])],
                         ids=["float", "int"])
def test_vector_ingest_of_a_null_component_reads_nan_as_jax(col):
    t = pa.table({"e": col})
    want = jsession._expand_vector_arrow(t, {"e": 3}).to_pydict()
    got = tsession._expand_vector_arrow(t, {"e": 3}).to_pydict()
    assert math.isnan(want["__e_1"][0]) and math.isnan(got["__e_1"][0])
    for k in want:
        assert str(got[k]) == str(want[k]), k


# ----------------------------------------------------------------------
# SQL (tests/test_vector_sql.py, single device)


@pytest.fixture(scope="module")
def sessions():
    out = []
    rng = np.random.default_rng(3)
    mat = rng.normal(size=(500, 16)).astype(np.float32)
    for s in (JSession(), TSession(device="cpu")):
        s.execute("CREATE TABLE docs (id BIGINT, tag VARCHAR, emb VECTOR(4))")
        s.execute("INSERT INTO docs VALUES (1, 'a', '[1,0,0,0]'), "
                  "(2, 'b', '[0,1,0,0]'), (3, 'a', '[0.9,0.1,0,0]'), "
                  "(4, 'b', '[0,0,1,0]'), (5, 'a', NULL)")
        s.execute("CREATE TABLE big (id BIGINT, emb VECTOR(16))")
        s.load_arrow("big", pa.table({"id": np.arange(500), "emb": list(mat.tolist())}))
        out.append(s)
    return out, mat


def assert_same_rows(got, want, rtol=1e-12):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key, b in w.items():
            a = g[key]
            if isinstance(b, float) and a is not None and not math.isnan(b):
                assert math.isclose(a, b, rel_tol=rtol, abs_tol=1e-15), (key, a, b)
            else:
                assert a == b, (key, a, b)


_Q = "'[1,0.5,0,0]'"
SQL = {
    "l2_nulls_first": "SELECT id, L2_DISTANCE(emb, '[1,0,0,0]') d FROM docs ORDER BY d LIMIT 3",
    "l2_not_null": ("SELECT id, L2_DISTANCE(emb, '[1,0,0,0]') d FROM docs "
                    "WHERE L2_DISTANCE(emb, '[1,0,0,0]') IS NOT NULL ORDER BY d LIMIT 2"),
    "where": ("SELECT id FROM docs WHERE tag = 'b' "
              "ORDER BY L2_DISTANCE(emb, '[1,0,0,0]') LIMIT 1"),
    "cosine": ("SELECT id, COSINE_DISTANCE(emb, '[1,0,0,0]') c FROM docs "
               "WHERE COSINE_DISTANCE(emb, '[1,0,0,0]') IS NOT NULL ORDER BY c LIMIT 1"),
    "ip_desc": "SELECT id FROM docs ORDER BY INNER_PRODUCT(emb, '[1,0,0,0]') DESC LIMIT 1",
    "all_three": (f"SELECT id, tag, L2_DISTANCE(emb, {_Q}) l, COSINE_DISTANCE(emb, {_Q}) c, "
                  f"INNER_PRODUCT(emb, {_Q}) p FROM docs ORDER BY id"),
    "star": "SELECT * FROM docs WHERE id = 1",
    "qualified": ("SELECT d.id FROM docs d ORDER BY L2_DISTANCE(d.emb, '[0,0,1,0]'), "
                  "d.id LIMIT 2"),
    "in_where": ("SELECT id FROM docs WHERE INNER_PRODUCT(emb, '[0,1,0,0]') > 0.05 "
                 "ORDER BY id"),
    "big_l2": "SELECT id, L2_DISTANCE(emb, '{q}') d FROM big ORDER BY d LIMIT 10",
    "big_cosine_where": ("SELECT id, COSINE_DISTANCE(emb, '{q}') d FROM big WHERE id % 3 = 1 "
                         "ORDER BY d LIMIT 7"),
    "big_ip": "SELECT id FROM big ORDER BY INNER_PRODUCT(emb, '{q}') DESC LIMIT 10",
}


@pytest.mark.parametrize("name", list(SQL))
def test_vector_sql_matches_jax(sessions, name):
    (js, ts), mat = sessions
    q = np.random.default_rng(3 + 17).normal(size=16).astype(np.float32)
    sql = SQL[name].replace("{q}", "[" + ",".join(str(float(x)) for x in q) + "]")
    want = js.query(sql)
    got = ts.query(sql)
    assert_same_rows(got, want, 1e-6 if "COSINE" in sql else 1e-12)
    assert got
    if name == "big_l2":
        # tests/test_vector_sql.py::test_golden_topk_and_mesh's numpy answer
        d = ((mat.astype(np.float64) - q.astype(np.float64)) ** 2).sum(axis=1)
        assert [r["id"] for r in got] == [int(i) for i in np.argsort(d)[:10]]


def test_parity_compares_rows_in_order_under_an_expression_order_by():
    from baikaldb_tpu_torch.models.parity import mismatch

    sql = "SELECT id FROM t ORDER BY L2_DISTANCE(v, '[0,0]') LIMIT 2"
    assert mismatch([{"id": 1}, {"id": 2}], [{"id": 1}, {"id": 2}], sql) is None
    assert "row 0" in mismatch([{"id": 2}, {"id": 1}], [{"id": 1}, {"id": 2}], sql)


def test_describe_and_show_match_jax(sessions):
    (js, ts), _ = sessions
    for sql in ("DESCRIBE docs", "SHOW COLUMNS FROM docs", "SHOW FULL COLUMNS FROM docs",
                "SHOW CREATE TABLE docs", "SHOW COLUMNS FROM big LIKE 'e%'"):
        assert ts.query(sql) == js.query(sql), sql
    assert any(r["Type"] == "vector(4)" for r in ts.query("DESCRIBE docs"))
    assert set(ts.query("SELECT * FROM docs WHERE id = 1")[0]) == {"id", "tag"}


def test_vector_errors_match_jax():
    for s, err in ((JSession(), JPlanError), (TSession(device="cpu"), TPlanError)):
        s.execute("CREATE TABLE docs (id BIGINT, tag VARCHAR, emb VECTOR(4))")
        with pytest.raises(err):
            s.query("SELECT L2_DISTANCE(tag, '[1,0]') FROM docs")
        with pytest.raises(err):
            s.execute("INSERT INTO docs VALUES (9, 'x', '[1,2]')")   # wrong dim
        with pytest.raises(err, match="out of range"):
            s.execute("CREATE TABLE t0 (e VECTOR(4097))")
        with pytest.raises(err, match="dimension"):
            s.execute("CREATE TABLE t1 (e VECTOR)")
        with pytest.raises(err, match="ANN INDEX"):
            s.execute("CREATE TABLE t2 (id BIGINT, e VECTOR(2), ANN INDEX a (id))")
        with pytest.raises(err):
            s.query("SELECT L2_DISTANCE(emb, '[1,0,0,0]') FROM docs d, docs e")


def test_insert_with_column_list_and_positional_vectors_match_jax():
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute("CREATE TABLE v2 (e VECTOR(2), id INT, f VECTOR(3))")
        s.execute("INSERT INTO v2 VALUES ('[1,2]', 1, '[0,0,1]'), (NULL, 2, '[1 1 1]')")
        s.execute("INSERT INTO v2 (id, f) VALUES (3, '[2,2,2]')")
        out.append(s.query("SELECT *, L2_DISTANCE(e, '[0,0]') a, "
                           "INNER_PRODUCT(f, '[1,2,3]') b FROM v2 ORDER BY id"))
    assert_same_rows(out[1], out[0])
    assert [r["b"] for r in out[1]] == [3.0, 6.0, 12.0]


@pytest.mark.parametrize("dim,deep", [(256, False), (512, True)])
def test_deep_distance_expression_plans_as_jax_does(dim, deep):
    """A distance is a left-deep chain of ~3d calls in both packages: it
    plans at 256 components and exceeds Python's recursion limit at 512, in
    the JAX package and in the port alike."""
    rng = np.random.default_rng(0)
    m = rng.normal(size=(6, dim)).astype(np.float32)
    q = "[" + ",".join(str(float(x)) for x in m[3]) + "]"
    sql = f"SELECT id FROM t ORDER BY L2_DISTANCE(e, '{q}') LIMIT 2"
    got = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute(f"CREATE TABLE t (id BIGINT, e VECTOR({dim}))")
        s.load_arrow("t", pa.table({"id": np.arange(6), "e": list(m.tolist())}))
        if deep:
            with pytest.raises(RecursionError):
                s.query(sql)
        else:
            got.append(s.query(sql))
    if not deep:
        assert got[0] == got[1] and got[1][0]["id"] == 3
