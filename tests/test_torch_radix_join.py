"""The port's radix join (ops/radix.py, ops/join.py ``radix_join``, the
executor's ``radix_join_buckets`` gate) against the JAX package.

Bucket ids and the bucket order are compared bit for bit.  Joins are
compared as multisets of their live rows, exactly: the JAX per-bucket sort
is not stable, so the order of one probe row's matches among equal build
keys may differ.  SQL runs on a JAX session and a port session under the
same flags, and rows must be equal.
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp

from baikaldb_tpu.column.batch import Column as JColumn, ColumnBatch as JBatch
from baikaldb_tpu.column.dictionary import Dictionary as JDict
from baikaldb_tpu.exec.session import Database as JDatabase, Session as JSession
from baikaldb_tpu.ops import join as jjoin
from baikaldb_tpu.ops import radix as jradix
from baikaldb_tpu.types import LType as JLType
from baikaldb_tpu.utils.flags import FLAGS as JFLAGS
from baikaldb_tpu_torch.column.batch import ColumnBatch as TBatch
from baikaldb_tpu_torch.exec import executor as texec
from baikaldb_tpu_torch.exec.session import Database as TDatabase, Session as TSession
from baikaldb_tpu_torch.ops import join as tjoin
from baikaldb_tpu_torch.ops import radix as tradix
from baikaldb_tpu_torch.utils.flags import FLAGS as TFLAGS

import torch

HOWS = ["inner", "left", "semi", "anti"]
I64 = np.iinfo(np.int64)
FRUIT = np.asarray(["apple", "banana", "cherry", "date", "fig"], dtype=str)
BERRY = np.asarray(["banana", "date", "elder", "fig", "grape"], dtype=str)


def _pair(state: dict, sel):
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


# -- bucket ids and order ------------------------------------------------------

EDGE_KEYS = np.asarray([0, 1, -1, 2, -2, 7, I64.min, I64.max, I64.min + 1, I64.max - 1,
                        1 << 32, -(1 << 32), 0x9E3779B97F4A7C15 - (1 << 64),
                        123456789012345, -987654321098765], np.int64)


@pytest.mark.parametrize("nb", [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024])
def test_bucket_of_is_bit_identical_to_jax(nb):
    rng = np.random.default_rng(nb)
    keys = np.concatenate([EDGE_KEYS, rng.integers(I64.min, I64.max, 4000, dtype=np.int64)])
    want = np.asarray(jradix.bucket_of(jnp.asarray(keys), nb))
    got = tradix.bucket_of(torch.from_numpy(keys), nb).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    small = keys.astype(np.int32)          # int32 keys, negatives included
    np.testing.assert_array_equal(
        tradix.bucket_of(torch.from_numpy(small), nb).numpy(),
        np.asarray(jradix.bucket_of(jnp.asarray(small), nb)))


def test_bucket_of_refuses_a_bucket_count_that_is_no_power_of_two():
    for nb in (0, 1, 3, 100):
        with pytest.raises(ValueError):
            tradix.bucket_of(torch.zeros(3, dtype=torch.int64), nb)


@pytest.mark.parametrize("nb,n", [(16, 1000), (256, 9000), (4, 1)])
def test_stable_bucket_order_matches_jax(nb, n):
    rng = np.random.default_rng(n)
    b = rng.integers(0, nb, n).astype(np.int32)
    jp, jo, jc = (np.asarray(x) for x in jradix.stable_bucket_order(jnp.asarray(b), nb,
                                                                      block=64))
    tp, to, tc = (x.numpy() for x in tradix.stable_bucket_order(torch.from_numpy(b), nb))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tc, jc)


def test_radix_build_matches_jax_per_bucket():
    """Each bucket's live keys, in order, and the set of its source rows."""
    rng = np.random.default_rng(5)
    keys = rng.integers(-50, 50, 700).astype(np.int64)
    dead = rng.random(700) < 0.2
    nb = 16
    width_t = int(np.bincount(np.asarray(jradix.bucket_of(jnp.asarray(keys), nb))[~dead],
                              minlength=nb).max())
    js, jk, jneed = (np.asarray(x) for x in jradix.radix_build(
        jnp.asarray(keys), jnp.asarray(dead), nb, width_t))
    ts, tk, tw = tradix.radix_build(torch.from_numpy(keys), torch.from_numpy(dead), nb)
    assert tw == int(jneed) == width_t
    np.testing.assert_array_equal(tk.numpy(), jk)
    for b in range(nb):
        assert sorted(ts.numpy()[b].tolist()) == sorted(js[b].tolist())


# -- radix_join against the JAX radix_join and the port's sort join -----------

def _sides(seed: int, key: str, np_=400, nb=300, skew=False):
    """Duplicate build keys, NULL keys and dead rows on both sides; ``skew``
    puts half the build rows on one key (past 4x the average bucket)."""
    rng = np.random.default_rng(seed)
    if key == "string":
        pk = {"pk": (rng.integers(0, len(FRUIT), np_).astype(np.int32),
                     rng.random(np_) > 0.1, "string", FRUIT)}
        bk = {"bk": (rng.integers(0, len(BERRY), nb).astype(np.int32),
                     rng.random(nb) > 0.1, "string", BERRY)}
    else:
        pvals = rng.integers(-40, 60, np_).astype(np.int64)
        bvals = rng.integers(-30, 70, nb).astype(np.int64)
        if skew:
            bvals[: nb // 2] = 13
        pk = {"pk": (pvals, rng.random(np_) > 0.1, "int64", None)}
        bk = {"bk": (bvals, rng.random(nb) > 0.1, "int64", None)}
    probe = dict(pk, pv=(np.arange(np_, dtype=np.int64), None, "int64", None))
    build = dict(bk, bv=(np.arange(nb, dtype=np.int64) * 7, None, "int64", None))
    return (_pair(probe, rng.random(np_) > 0.2), _pair(build, rng.random(nb) > 0.2))


@pytest.mark.parametrize("key", ["int", "skew", "string"])
@pytest.mark.parametrize("how", HOWS)
def test_radix_join_matches_jax_and_the_sort_join(how, key):
    (jp, tp), (jb, tb) = _sides(3, "string" if key == "string" else "int",
                                skew=key == "skew")
    nb = 16
    got, total, width = tjoin.radix_join(tp, ["pk"], tb, ["bk"], how=how, n_buckets=nb)
    want, jtotal, jneed = jjoin.radix_join(jp, ["pk"], jb, ["bk"], how=how, cap=8192,
                                           n_buckets=nb, width=512)
    assert width == int(jneed)
    _same_rows(got, want)
    sort_join, sort_total = tjoin.join(tp, ["pk"], tb, ["bk"], how=how)
    _same_rows(got, sort_join)
    if how in ("inner", "left"):
        assert total == int(jtotal) == sort_total == len(got)
    if key == "skew":
        assert width > 4 * 300 // nb


def test_radix_join_expands_duplicate_build_keys():
    p = {"pk": (np.asarray([5, 5, 9], np.int64), None, "int64", None)}
    b = {"bk": (np.asarray([5, 5, 5, 7], np.int64), None, "int64", None),
         "bv": (np.asarray([10, 20, 30, 40], np.int64), None, "int64", None)}
    (jp, tp), (jb, tb) = _pair(p, None), _pair(b, None)
    got, total, _ = tjoin.radix_join(tp, ["pk"], tb, ["bk"], how="inner", n_buckets=4)
    want, _, _ = jjoin.radix_join(jp, ["pk"], jb, ["bk"], how="inner", cap=16,
                                  n_buckets=4, width=8)
    assert total == 6
    _same_rows(got, want)


def test_radix_join_keys_at_the_padding_value_and_int64_edges():
    """Live keys equal to the padding sentinel (int64 max) and int64 min
    match only live rows (the clamp to each bucket's live occupancy)."""
    keys = np.asarray([I64.max, I64.min, 0, I64.max, -1], np.int64)
    p = {"pk": (keys, None, "int64", None)}
    b = {"bk": (np.asarray([I64.max, I64.min, 3], np.int64),
                np.asarray([True, True, False]), "int64", None)}
    (jp, tp), (jb, tb) = _pair(p, None), _pair(b, None)
    for how in HOWS:
        got, _, _ = tjoin.radix_join(tp, ["pk"], tb, ["bk"], how=how, n_buckets=2)
        want, _, _ = jjoin.radix_join(jp, ["pk"], jb, ["bk"], how=how, cap=16,
                                      n_buckets=2, width=4)
        _same_rows(got, want)


def test_a_join_with_an_empty_build_side():
    p = {"pk": (np.arange(4, dtype=np.int64), None, "int64", None)}
    b = {"bk": (np.zeros(0, np.int64), None, "int64", None)}
    _, tp = _pair(p, None)
    _, tb = _pair(b, None)
    for how, n in (("inner", 0), ("left", 4)):
        got, total, width = tjoin.radix_join(tp, ["pk"], tb, ["bk"], how=how, n_buckets=4)
        assert total == n == len(got) and width == 1
    semi, _, _ = tjoin.radix_join(tp, ["pk"], tb, ["bk"], how="semi", n_buckets=4)
    assert int(semi.live_count()) == 0


# -- SQL under radix_join_buckets ----------------------------------------------

@pytest.fixture
def radix_flags():
    """Both packages at 256 buckets and a small build threshold; restored."""
    saved = [(f, n, f.get(n)) for f in (JFLAGS, TFLAGS)
             for n in ("radix_join_buckets", "radix_join_min_build")]

    def set_(buckets, min_build=1):
        for f in (JFLAGS, TFLAGS):
            f.set_flag("radix_join_buckets", str(buckets))
            f.set_flag("radix_join_min_build", str(min_build))
    yield set_
    for f, n, v in saved:
        f.set_flag(n, str(v))


def _load(s, seed):
    rng = np.random.default_rng(seed)
    fk = rng.integers(0, 1 << 30, 3000).astype(np.int64)
    s.execute("CREATE TABLE f (id BIGINT, k BIGINT, g INT, v DOUBLE, PRIMARY KEY (id))")
    s.execute("CREATE TABLE d (k BIGINT, tag BIGINT, name VARCHAR(8))")
    ks = np.unique(fk[rng.integers(0, 3000, 500)])
    ks = np.concatenate([ks, ks[:40]])                 # duplicate build keys
    s.load_arrow("f", pa.table({"id": np.arange(3000, dtype=np.int64), "k": fk,
                                "g": (fk % 7).astype(np.int32),
                                "v": rng.normal(size=3000)}))
    s.load_arrow("d", pa.table({"k": pa.array(list(ks) + [None] * 5, pa.int64()),
                                "tag": (np.arange(len(ks) + 5) % 97).astype(np.int64),
                                "name": [f"n{i % 13}" for i in range(len(ks) + 5)]}))


SQL = {
    "inner": "SELECT f.g, COUNT(*) n, SUM(d.tag) st FROM f JOIN d ON f.k = d.k "
             "GROUP BY f.g ORDER BY f.g",
    "left": "SELECT COUNT(*) n, COUNT(d.tag) m FROM f LEFT JOIN d ON f.k = d.k",
    "semi": "SELECT COUNT(*) n FROM f WHERE f.k IN (SELECT k FROM d)",
    "anti": "SELECT COUNT(*) n FROM f WHERE NOT EXISTS (SELECT 1 FROM d WHERE d.k = f.k)",
    "string": "SELECT a.name, COUNT(*) n FROM d a JOIN d b ON a.name = b.name "
              "GROUP BY a.name ORDER BY a.name",
}


def _strip_presort(s):
    """The session's batches without ``__presort__`` keys (the JAX package's
    way to run without the presort, tests/test_ops.py): the radix gate
    refuses a presorted build, and these builds are whole tables."""
    orig = s._collect_batches

    def strip(plan):
        b, k, full = orig(plan)
        return {kk: v for kk, v in b.items() if not str(kk).startswith("__presort__")}, k, full
    s._collect_batches = strip
    return s


@pytest.mark.parametrize("shape", sorted(SQL))
def test_sql_under_radix_join_buckets_matches_jax(radix_flags, shape):
    radix_flags(256)
    j, t = JSession(JDatabase()), TSession(TDatabase("cpu"))
    for s in (j, t):
        _load(s, 3)
        _strip_presort(s)
    calls = []
    orig = tjoin.radix_join

    def spy(*a, **kw):
        out = orig(*a, **kw)
        calls.append(out[2])
        return out
    tjoin.radix_join = spy
    try:
        got = t.query(SQL[shape])
    finally:
        tjoin.radix_join = orig
    assert calls, "the radix join did not engage"
    assert got == j.query(SQL[shape])
    radix_flags(0)
    assert TSession(t.db).query(SQL[shape]) == got


def test_radix_gate_refuses_presorted_and_small_builds_and_bad_bucket_counts(radix_flags):
    t = TSession(TDatabase("cpu"))
    _load(t, 4)
    calls = []
    orig = tjoin.radix_join
    tjoin.radix_join = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    try:
        radix_flags(256, 1)
        t.query(SQL["inner"])            # the build takes the presort
        _strip_presort(t)
        for buckets, min_build in ((256, 100_000), (100, 1), (0, 1)):
            radix_flags(buckets, min_build)
            t.query(SQL["inner"])
        assert not calls
        radix_flags(256, 1)
        t.query(SQL["inner"])
        assert calls
    finally:
        tjoin.radix_join = orig


def test_radix_flags_are_the_jax_packages():
    assert TFLAGS.get("radix_join_buckets") == 0
    assert TFLAGS.get("radix_join_min_build") == 65536
    assert texec.join_ops is tjoin
