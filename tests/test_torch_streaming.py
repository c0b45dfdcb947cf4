"""The port's out-of-core streaming scans against the JAX package.

The same table (numpy, fixed seed) goes into a JAX ``Session`` and a port
``Session(device="cpu")``, each over a ``Database(cold_dir=...)``, with the
same flags set in both flag registries: ``streaming_min_rows = 1`` and a
small ``streaming_chunk_rows``, so every eligible query folds chunk by
chunk.  Each query runs streamed in both packages and resident in the port:

- the port's streamed rows equal the JAX package's streamed rows and the
  port's own resident rows under the parity contract
  (``models/parity.py``): keys, counts, integers and NULLs exact, float
  aggregates within rtol 1e-4 where the float32 group-by kernels ran (their
  output contract), within 1e-9 elsewhere (float64 sums taken in another
  order), result sets without ORDER BY as multisets;
- ``stream_chunks`` and ``stream_chunks_skipped`` move by the same amounts
  in both packages;
- on the CPU the kernels' plain versions run, once per kept chunk where the
  dense gate admits the partial specs.

The partial-aggregate protocol, the zone-map pieces, the prefetcher, the
failpoints and the cold tier are also held against the JAX functions
directly.  Every test restores the flags and failpoints it sets.
"""

import contextlib
import datetime
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from baikaldb_tpu.chaos import failpoint as jfailpoint
from baikaldb_tpu.column.batch import ColumnBatch as JBatch
from baikaldb_tpu.exec import streaming as jstreaming
from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.index import selector as jselector
from baikaldb_tpu.ops import hashagg as jhashagg
from baikaldb_tpu.parallel import agg as jagg
from baikaldb_tpu.storage import column_store as jcolumn_store
from baikaldb_tpu.storage import streamchunks as jstreamchunks
from baikaldb_tpu.utils import metrics as jmetrics
from baikaldb_tpu.utils.flags import FLAGS as JFLAGS
from baikaldb_tpu_torch.chaos import failpoint
from baikaldb_tpu_torch.column.batch import ColumnBatch
from baikaldb_tpu_torch.exec import streaming
from baikaldb_tpu_torch.exec.session import Database, Session
from baikaldb_tpu_torch.index import selector
from baikaldb_tpu_torch.models import tpch
from baikaldb_tpu_torch.models.parity import mismatch
from baikaldb_tpu_torch.ops import group_kernels as gk
from baikaldb_tpu_torch.ops import hashagg
from baikaldb_tpu_torch.parallel import agg
from baikaldb_tpu_torch.sql.parser import parse_sql
from baikaldb_tpu_torch.storage import column_store, streamchunks
from baikaldb_tpu_torch.storage.coldfs import ExternalFS
from baikaldb_tpu_torch.utils import metrics, prefetch
from baikaldb_tpu_torch.utils.flags import FLAGS

ROWS = 1000
CHUNK = 64                      # 15 full chunks and a ragged 40-row tail
N_CHUNKS = -(-ROWS // CHUNK)
DDL = ("CREATE TABLE t (id BIGINT, g BIGINT, sv VARCHAR(8), gn INT, v DOUBLE, "
       "w DOUBLE, f FLOAT, k INT, h INT, d DATE)")


@contextlib.contextmanager
def flags(**values):
    """Set flags in both packages' registries; restore them on exit."""
    prev = [(reg, name, getattr(reg, name)) for name in values for reg in (FLAGS, JFLAGS)]
    try:
        for name, v in values.items():
            FLAGS.set_flag(name, v)
            JFLAGS.set_flag(name, v)
        yield
    finally:
        for reg, name, v in prev:
            reg.set_flag(name, v)


@pytest.fixture
def streamed():
    with flags(streaming_scan=True, streaming_min_rows=1, streaming_chunk_rows=CHUNK):
        yield


def stream_table(n: int = ROWS, seed: int = 11) -> pa.Table:
    """id 0..n-1 in insert order (chunk zone maps see disjoint id ranges);
    g cycles 0..6 and sv 'a'..'d'/NULL so every group spans every chunk; gn
    holds NULLs; v and w are integer-valued doubles; f a float32 normal; k
    (2048 values) and h (600 values from 1000) give dense GROUP BYs inside
    the kernels' gate; d advances one day per ten rows."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    svs = np.array(["a", "b", "c", "d", None], dtype=object)
    gn = pa.array((i % 11).astype(np.int32), mask=(i % 3 == 0))
    days = (datetime.date(2024, 1, 1) - datetime.date(1970, 1, 1)).days + i // 10
    return pa.table({
        "id": pa.array(i, pa.int64()), "g": pa.array(i % 7, pa.int64()),
        "sv": pa.array(svs[i % 5], pa.string()), "gn": gn,
        "v": pa.array((i % 101).astype(np.float64)),
        "w": pa.array(((i * 3) % 53).astype(np.float64)),
        "f": pa.array(rng.standard_normal(n, dtype=np.float32)),
        "k": pa.array(rng.integers(0, 2048, n, dtype=np.int32)),
        "h": pa.array(rng.integers(1000, 1600, n, dtype=np.int32)),
        "d": pa.array(days.astype(np.int32), pa.date32()),
    })


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    data = stream_table()
    root = tmp_path_factory.mktemp("cold")
    js = JSession(JDatabase(cold_dir=str(root / "jax")))
    ts = Session(Database("cpu", cold_dir=str(root / "port")))
    for s in (js, ts):
        s.execute(DDL)
        s.load_arrow("t", data)
    return js, ts


class KernelCalls:
    """Counts of the group-by kernels' plain versions (what the CPU runs
    where the card launches K1-K3)."""

    def __init__(self, monkeypatch):
        self.calls = {k: 0 for k in gk.LAUNCHES}
        for k in gk.LAUNCHES:
            plain = getattr(gk, f"{k}_plain")
            monkeypatch.setattr(gk, f"{k}_plain", self._wrap(k, plain))

    def _wrap(self, k, plain):
        def run(*a):
            self.calls[k] += 1
            return plain(*a)
        return run

    def ran(self) -> dict:
        return {k: n for k, n in self.calls.items() if n}


def run_counted(s, reg, sql):
    """-> (rows, stream_chunks delta, stream_chunks_skipped delta)."""
    c0, k0 = reg.stream_chunks.value, reg.stream_chunks_skipped.value
    rows = s.query(sql)
    return rows, reg.stream_chunks.value - c0, reg.stream_chunks_skipped.value - k0


def assert_parity(got, want, sql, rtol):
    diff = mismatch(got, want, sql, rtol)
    assert diff is None, diff


# SQL matrix: name -> (sql, group-by kernels per kept chunk)
K32 = {"partition_histogram": 1, "fused_group_aggregate": 1}
MATRIX = {
    "grouped_all_aggs": ("SELECT g, SUM(v) s, COUNT(*) n, COUNT(w) nw, AVG(v) a, STDDEV(v) sd, "
                         "MIN(w) mn, MAX(w) mx FROM t WHERE id < 800 GROUP BY g ORDER BY g", {}),
    "string_key": ("SELECT sv, COUNT(*) n, SUM(v) s, AVG(w) a FROM t GROUP BY sv "
                   "ORDER BY n DESC, sv", {}),
    "null_int_key": ("SELECT gn, COUNT(*) n, SUM(w) s, MIN(v) mn, MAX(v) mx FROM t "
                     "GROUP BY gn ORDER BY gn", {}),
    "multi_key_stddev": ("SELECT g, sv, COUNT(*) n, STDDEV(v) sd, VARIANCE(w) vr FROM t "
                         "GROUP BY g, sv ORDER BY g, n, sv", {}),
    "multiset_no_order": ("SELECT sv, gn, COUNT(*) n, SUM(v) s FROM t GROUP BY sv, gn", {}),
    "sample_stddev": ("SELECT g, STDDEV_SAMP(v) s, VAR_SAMP(w) vs FROM t GROUP BY g "
                      "ORDER BY g", {}),
    "expression_key": ("SELECT id % 7 m, SUM(v) s, COUNT(*) n FROM t GROUP BY m ORDER BY m", {}),
    "having_limit": ("SELECT g, SUM(v) s FROM t WHERE w > 10 GROUP BY g HAVING s > 1000 "
                     "ORDER BY s DESC LIMIT 3", {}),
    "string_filter": ("SELECT g, AVG(v) a FROM t WHERE sv = 'b' GROUP BY g ORDER BY g", {}),
    "null_filter": ("SELECT g, COUNT(*) n FROM t WHERE gn IS NULL GROUP BY g ORDER BY g", {}),
    "month_key": ("SELECT MONTH(d) m, COUNT(*) n, SUM(v) s FROM t WHERE d >= '2024-02-15' "
                  "GROUP BY m ORDER BY m", {}),
    "many_groups": ("SELECT sv, v, COUNT(*) n, SUM(w) s FROM t GROUP BY sv, v "
                    "ORDER BY sv, v, n", {}),
    # the dense gate (512 < groups + 1 <= 4096): the kernels' plain versions
    "dense_k3_k2": ("SELECT k, COUNT(*), SUM(f), AVG(f), MIN(f) FROM t WHERE f*2+1 > 0.5 "
                    "GROUP BY k ORDER BY k", K32),
    "dense_k1": ("SELECT k, SUM(w), AVG(w) FROM t WHERE w > 5 GROUP BY k ORDER BY k",
                 {"filtered_group_sum": 1}),
    "dense_key_shift": ("SELECT h, COUNT(*) c, MAX(f) mx FROM t WHERE g < 5 GROUP BY h "
                        "HAVING c > 1 ORDER BY c DESC, h LIMIT 20", K32),
    "dense_min_max": ("SELECT k, MAX(f) mx, MIN(f) mn FROM t GROUP BY k ORDER BY k",
                      {"fused_group_aggregate": 1}),
    "scalar_aggs": ("SELECT SUM(v) s, COUNT(*) n, COUNT(sv) ns, AVG(w) a, MIN(v) mn, "
                    "MAX(v) mx FROM t WHERE v > 10.0", {}),
    "scalar_count": ("SELECT COUNT(*) n FROM t", {}),
    "scalar_float": ("SELECT SUM(f) s, MIN(f) mn, MAX(f) mx, AVG(f) a FROM t WHERE f > 0", {}),
    "scalar_null_ints": ("SELECT COUNT(gn) c, SUM(gn) s, MIN(gn) mn, MAX(gn) mx FROM t", {}),
    "scalar_expression": ("SELECT SUM(v) * 2 + COUNT(*) x FROM t", {}),
    # zone maps: id is monotone, so chunks carry disjoint id ranges
    "zone_skip": ("SELECT g, COUNT(*) n, SUM(v) s FROM t WHERE id >= 768 GROUP BY g "
                  "ORDER BY g", {}),
    # beyond the table: the region zone maps drop its one region before any
    # chunk set is looked at (0 chunks folded, 0 skipped), in both packages
    "zone_prune_all": ("SELECT COUNT(*) n, SUM(v) s FROM t WHERE id > 100000", {}),
    # every chunk fails one of the two ranges, while the table as a whole
    # passes both: the region stays, its chunk zone maps skip every chunk
    "zone_prune_chunks": ("SELECT COUNT(*) n, SUM(v) s FROM t "
                          "WHERE id < 64 AND d >= '2024-03-01'", {}),
    "zone_range": ("SELECT COUNT(*) n, SUM(w) s FROM t WHERE id >= 100 AND id < 200", {}),
    "zone_eq": ("SELECT g, SUM(w) s FROM t WHERE id = 500 GROUP BY g", {}),
    "zone_date": ("SELECT COUNT(*) n, MAX(v) mx FROM t WHERE d < '2024-01-20'", {}),
}


@pytest.mark.parametrize("name", list(MATRIX))
def test_streamed_query_matches_jax_and_resident(sessions, streamed, monkeypatch, name):
    js, ts = sessions
    sql, per_chunk = MATRIX[name]
    kc = KernelCalls(monkeypatch)
    got, chunks, skipped = run_counted(ts, metrics, sql)
    ran = kc.ran()
    want, jchunks, jskipped = run_counted(js, jmetrics, sql)
    assert chunks >= 1 or name in ("zone_prune_all", "zone_prune_chunks")
    assert (chunks, skipped) == (jchunks, jskipped)
    assert chunks + skipped == (0 if name == "zone_prune_all" else N_CHUNKS)
    if name == "zone_prune_chunks":
        assert (chunks, skipped) == (0, N_CHUNKS)
    assert ran == {k: n * chunks for k, n in per_chunk.items()}
    rtol = 1e-4 if ran else 1e-9
    assert_parity(got, want, sql, rtol)
    with flags(streaming_scan=False):
        resident, rchunks, _ = run_counted(ts, metrics, sql)
    assert rchunks == 0
    assert_parity(got, resident, sql, rtol)


def test_zone_maps_skip_chunks_before_any_transfer(sessions, streamed):
    js, ts = sessions
    sql = MATRIX["zone_skip"][0]
    b0 = metrics.stream_bytes_h2d.value
    _, chunks, skipped = run_counted(ts, metrics, sql)
    assert (chunks, skipped) == (4, N_CHUNKS - 4)      # ids 768.. are chunks 12..15
    per_chunk = (metrics.stream_bytes_h2d.value - b0) / chunks
    _, all_chunks, _ = run_counted(ts, metrics, "SELECT g, COUNT(*) n FROM t GROUP BY g")
    assert all_chunks == N_CHUNKS and per_chunk > 0


def test_prune_everything_still_renders_count_zero(sessions, streamed):
    js, ts = sessions
    sql = MATRIX["zone_prune_all"][0]
    got, chunks, skipped = run_counted(ts, metrics, sql)
    want, jchunks, jskipped = run_counted(js, jmetrics, sql)
    assert got == want == [{"n": 0, "s": None}]
    assert (chunks, skipped) == (jchunks, jskipped) == (0, 0)
    plan = ts.execute("EXPLAIN " + sql).plan_text
    assert "access=zonemap(1/1 regions pruned)" in plan
    assert plan == js.execute("EXPLAIN " + sql).plan_text


@pytest.mark.parametrize("sql", [
    "SELECT STDDEV(v) sd FROM t",
    "SELECT VAR_SAMP(w) vs, COUNT(*) n FROM t",
    "SELECT COUNT(DISTINCT g) c FROM t",
    "SELECT g, APPROX_COUNT_DISTINCT(v) a FROM t GROUP BY g ORDER BY g",
    "SELECT g, MEDIAN(v) m FROM t GROUP BY g ORDER BY g",
    "SELECT id, v FROM t WHERE id < 5 ORDER BY id",
    "SELECT DISTINCT g FROM t ORDER BY g",
    "SELECT a.g, COUNT(*) n FROM t a JOIN t b ON a.id = b.id GROUP BY a.g ORDER BY a.g",
], ids=["scalar_stddev", "scalar_var_samp", "count_distinct", "approx_count_distinct",
        "median", "no_aggregate", "distinct", "self_join"])
def test_ineligible_plans_stay_resident(sessions, streamed, sql):
    """Keyless STDDEV/VARIANCE (mean-centered: no partial form), DISTINCT
    and row-set aggregates, plans without an aggregate, and two scans of one
    table run resident in both packages, with the same rows."""
    js, ts = sessions
    got, chunks, _ = run_counted(ts, metrics, sql)
    want, jchunks, _ = run_counted(js, jmetrics, sql)
    assert chunks == jchunks == 0
    assert_parity(got, want, sql, 1e-9)


def test_off_switch_and_min_rows_gate(sessions, streamed):
    js, ts = sessions
    sql = "SELECT g, SUM(v) s FROM t GROUP BY g ORDER BY g"
    streamed_rows, chunks, _ = run_counted(ts, metrics, sql)
    assert chunks == N_CHUNKS
    for kw in ({"streaming_scan": False}, {"streaming_min_rows": ROWS + 1}):
        with flags(**kw):
            got, chunks, _ = run_counted(ts, metrics, sql)
            want, jchunks, _ = run_counted(js, jmetrics, sql)
        assert chunks == jchunks == 0
        assert got == want == streamed_rows
    with flags(streaming_min_rows=ROWS):          # the gate is inclusive
        _, chunks, _ = run_counted(ts, metrics, sql)
    assert chunks == N_CHUNKS


@pytest.mark.parametrize("chunk_rows", [100, 333, 1000, 4096])
def test_chunk_sizes_that_do_not_divide_the_table(sessions, chunk_rows):
    js, ts = sessions
    sql = "SELECT g, SUM(v) s, COUNT(*) n, MIN(w) mn FROM t GROUP BY g ORDER BY g"
    with flags(streaming_scan=True, streaming_min_rows=1, streaming_chunk_rows=chunk_rows):
        got, chunks, _ = run_counted(ts, metrics, sql)
        want, jchunks, _ = run_counted(js, jmetrics, sql)
    assert chunks == jchunks == -(-ROWS // chunk_rows)
    assert got == want


def test_sorted_accumulator_overflow_restarts_in_both(sessions, streamed, monkeypatch):
    """Clamp the sorted accumulator to 4 slots: the (sv, w) groups overflow
    it, the fold doubles and re-folds until it fits — in both packages,
    with the same number of restarts and the same rows."""
    js, ts = sessions
    sql = "SELECT sv, w, COUNT(*) n, SUM(v) s FROM t GROUP BY sv, w ORDER BY sv, w, n"
    j_orig = jstreaming.StreamRunner._ensure_step
    j_state = {"clamped": False}

    def j_clamped(self, source, params):
        j_orig(self, source, params)
        if not j_state["clamped"] and self.keys and self.agg.strategy == "sorted" \
                and self.acc_cap > 4:
            j_state["clamped"] = True
            self.acc_cap = 4
            self._jit_step = None
            j_orig(self, source, params)

    t_orig = streaming.StreamRunner._size

    def t_clamped(self, cs):
        t_orig(self, cs)
        self.acc_cap = min(self.acc_cap, 4)

    monkeypatch.setattr(jstreaming.StreamRunner, "_ensure_step", j_clamped)
    monkeypatch.setattr(streaming.StreamRunner, "_size", t_clamped)
    r0, jr0 = metrics.stream_restarts.value, jmetrics.stream_restarts.value
    got, chunks, _ = run_counted(ts, metrics, sql)
    want, jchunks, _ = run_counted(js, jmetrics, sql)
    restarts = metrics.stream_restarts.value - r0
    assert j_state["clamped"]
    assert restarts >= 1 and restarts == jmetrics.stream_restarts.value - jr0
    assert chunks == jchunks == N_CHUNKS * (restarts + 1)
    assert_parity(got, want, sql, 1e-9)
    with flags(streaming_scan=False):
        assert_parity(got, ts.query(sql), sql, 1e-9)


@pytest.mark.parametrize("drops", [1, 2, 3, 4])
def test_coldfs_get_drops_retry_then_raise(sessions, streamed, drops):
    """``coldfs.get`` drops are retried up to ``stream_retry_max`` (3) with
    backoff; a fourth drop of one read raises, in both packages."""
    js, ts = sessions
    sql = "SELECT g, SUM(w) s FROM t WHERE id < 640 GROUP BY g ORDER BY g"
    want = ts.query(sql)                  # builds the chunk sets outside the faults
    js.query(sql)
    t0, jt0 = metrics.stream_retries.value, jmetrics.stream_retries.value
    try:
        with flags(stream_retry_max=3, stream_backoff_ms=0.1):
            failpoint.set_failpoint("coldfs.get", f"{drops}*drop")
            jfailpoint.set_failpoint("coldfs.get", f"{drops}*drop")
            if drops <= 3:
                assert ts.query(sql) == want
                assert js.query(sql) == want
            else:
                with pytest.raises(FileNotFoundError):
                    ts.query(sql)
                with pytest.raises(FileNotFoundError):
                    js.query(sql)
    finally:
        failpoint.clear_all()
        jfailpoint.clear_all()
    assert metrics.stream_retries.value - t0 == jmetrics.stream_retries.value - jt0 \
        == min(drops, 3)


@pytest.mark.parametrize("rows", [(1 << 18) - 1, 1 << 18])
def test_default_flags_stream_from_262144_rows(tmp_path, rows):
    """With the defaults (``streaming_min_rows`` 262144, 65536-row chunks) a
    scan -> filter -> aggregate over at least 262144 rows streams in both
    packages; one row fewer stays resident."""
    rng = np.random.default_rng(5)
    data = pa.table({"g": pa.array(rng.integers(0, 16, rows, dtype=np.int32)),
                     "v": pa.array(rng.integers(0, 100, rows).astype(np.float64))})
    js = JSession(JDatabase(cold_dir=str(tmp_path / "jax")))
    ts = Session(Database("cpu", cold_dir=str(tmp_path / "port")))
    for s in (js, ts):
        s.execute("CREATE TABLE big (g INT, v DOUBLE)")
        s.load_arrow("big", data)
    assert FLAGS.streaming_min_rows == JFLAGS.streaming_min_rows == 1 << 18
    assert FLAGS.streaming_chunk_rows == 1 << 16 and FLAGS.streaming_scan
    sql = "SELECT g, COUNT(*) n, SUM(v) s FROM big WHERE v > 10 GROUP BY g ORDER BY g"
    got, chunks, _ = run_counted(ts, metrics, sql)
    want, jchunks, _ = run_counted(js, jmetrics, sql)
    assert chunks == jchunks == (4 if rows >= 1 << 18 else 0)
    assert got == want


@pytest.fixture(scope="module")
def tpch_pair(tmp_path_factory):
    tables = tpch.generate(scale=0.01, seed=3)
    root = tmp_path_factory.mktemp("tpch_cold")
    js = JSession(JDatabase(cold_dir=str(root / "jax")))
    ts = Session(Database("cpu", cold_dir=str(root / "port")))
    for s in (js, ts):
        for name, ddl in tpch.DDL.items():
            s.execute(ddl)
            s.load_arrow(name, tables[name])
    return js, ts, tables["lineitem"].num_rows


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_tpch_streamed_matches_jax_and_resident(tpch_pair, q):
    js, ts, lineitem_rows = tpch_pair
    sql = tpch.QUERIES[q]
    with flags(streaming_scan=True, streaming_min_rows=1, streaming_chunk_rows=8192):
        got, chunks, skipped = run_counted(ts, metrics, sql)
        want, jchunks, jskipped = run_counted(js, jmetrics, sql)
    assert chunks + skipped == -(-lineitem_rows // 8192) and chunks >= 1
    assert (chunks, skipped) == (jchunks, jskipped)
    assert_parity(got, want, sql, 1e-9)
    with flags(streaming_scan=False):
        assert_parity(got, ts.query(sql), sql, 1e-9)


# -- the partial-aggregate protocol against the JAX functions ------------

SPEC_SETS = {
    "count_sum": [("count_star", None, "n"), ("sum", "v", "s")],
    "avg": [("avg", "v", "a"), ("count", "v", "c")],
    "stddev_family": [("stddev", "v", "sd"), ("variance", "w", "vr"),
                      ("stddev_samp", "v", "ss"), ("var_samp", "w", "vs")],
    "shared_partials": [("avg", "v", "a"), ("sum", "v", "s"), ("count", "v", "c"),
                        ("stddev", "v", "sd")],
    "min_max": [("min", "v", "mn"), ("max", "w", "mx"), ("min", "w", "mw")],
    "distinct": [("count", "v", "cd", True), ("sum", "v", "s")],
}


def _specs(mod, rows):
    return [mod.AggSpec(op, inp, out, *rest) for op, inp, out, *rest in rows]


def _as_tuples(specs):
    return [(s.op, s.input, s.out_name, s.distinct) for s in specs]


@pytest.mark.parametrize("name", list(SPEC_SETS))
def test_partial_specs_and_merge_specs_match_jax(name):
    tp, tfin = hashagg.partial_specs(_specs(hashagg, SPEC_SETS[name]))
    jp, jfin = jhashagg.partial_specs(_specs(jhashagg, SPEC_SETS[name]))
    assert _as_tuples(tp) == _as_tuples(jp)
    assert tfin == jfin
    assert _as_tuples(agg.merge_partial_agg_specs(tp)) == \
        _as_tuples(jagg.merge_partial_agg_specs(jp))
    assert hashagg.MERGE_OP == jhashagg.MERGE_OP


@pytest.mark.parametrize("op", sorted(hashagg.ROW_AGGS))
def test_row_aggregates_have_no_partial_form(op):
    for mod in (hashagg, jhashagg):
        with pytest.raises(ValueError):
            mod.partial_specs([mod.AggSpec(op, "v", "x")])


def _partial_input(seed=3, n=300):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 9, n).astype(np.int64)
    v = rng.integers(-50, 50, n).astype(np.float64)
    w = rng.standard_normal(n)
    wv = rng.random(n) > 0.2
    sel = rng.random(n) > 0.1
    cols = [(key, None, "int64", None), (v, None, "float64", None), (w, wv, "float64", None)]
    return ("k", "v", "w"), cols, sel


def _jax_batch(names, cols, sel):
    import jax.numpy as jnp
    from baikaldb_tpu.column.batch import Column as JColumn
    from baikaldb_tpu.types import LType as JLType

    jc = [JColumn(jnp.asarray(d), None if m is None else jnp.asarray(m), JLType(lt))
          for d, m, lt, _ in cols]
    return JBatch(tuple(names), jc, jnp.asarray(sel), None)


def _rows(batch):
    return sorted(batch.to_pylist(), key=lambda r: tuple((v is None, v or 0) for v in r.values()))


def _close_rows(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert list(a) == list(b)
        for key in b:
            if isinstance(b[key], float) and a[key] is not None:
                assert a[key] == pytest.approx(b[key], rel=1e-12, abs=1e-9), key
            else:
                assert a[key] == b[key], key


@pytest.mark.parametrize("name", ["count_sum", "avg", "stddev_family", "shared_partials",
                                  "min_max"])
def test_partials_merge_and_finalize_match_jax(name):
    """Partial group-by of two halves, merged under the merge specs and
    finalized: the same rows as the JAX functions, and as one aggregate of
    the whole input."""
    names, cols, sel = _partial_input()
    n = len(sel)
    out = {}
    for mod, hmod, amod, make in (
            ("port", hashagg, agg,
             lambda c, s: ColumnBatch.from_numpy(names, c, s, device="cpu")),
            ("jax", jhashagg, jagg, lambda c, s: _jax_batch(names, c, s))):
        specs = _specs(hmod, SPEC_SETS[name])
        parts, fin = hmod.partial_specs(specs)
        halves = []
        for lo, hi in ((0, n // 2), (n // 2, n)):
            sub = [(d[lo:hi], None if m is None else m[lo:hi], lt, dv) for d, m, lt, dv in cols]
            b = make(sub, sel[lo:hi])
            halves.append(amod.rewrap_partial(hmod.group_aggregate_sorted(b, ["k"], parts, 16)))
        if mod == "port":
            from baikaldb_tpu_torch.column.batch import concat_batches
        else:
            from baikaldb_tpu.column.batch import concat_batches
        merged = hmod.group_aggregate_sorted(concat_batches(halves), ["k"],
                                             amod.merge_partial_agg_specs(parts), 16)
        out[mod] = _rows(hmod.finalize_partials(merged, fin, ["k"]))
    _close_rows(out["port"], out["jax"])
    whole = hashagg.group_aggregate_sorted(
        ColumnBatch.from_numpy(names, cols, sel, device="cpu"), ["k"],
        _specs(hashagg, SPEC_SETS[name]), 16)
    _close_rows(out["port"], _rows(whole))


@pytest.mark.parametrize("cap", [4, 8, 9, 16])
def test_sorted_group_by_overflow_flag_matches_jax(cap):
    """9 distinct keys: ``with_overflow`` is true below 9 slots, false from
    9, in both packages, and the 0-d flag stays on the batch's device."""
    names, cols, sel = _partial_input()
    sel = np.ones_like(sel)
    specs = [("count_star", None, "n")]
    out, ovf = hashagg.group_aggregate_sorted(
        ColumnBatch.from_numpy(names, cols, sel, device="cpu"), ["k"],
        _specs(hashagg, specs), cap, with_overflow=True)
    jout, jovf = jhashagg.group_aggregate_sorted(
        _jax_batch(names, cols, sel), ["k"], _specs(jhashagg, specs), cap,
        with_overflow=True)
    assert isinstance(ovf, torch.Tensor) and ovf.ndim == 0 and ovf.dtype is torch.bool
    assert bool(ovf) == bool(jovf) == (cap < 9)
    assert _rows(out) == _rows(jout)


# -- zone maps, predicates, chunk sets -----------------------------------

ZONE_VALUES = [
    (5, "INT64"), (2.5, "FLOAT64"), (True, "INT64"), ("2024-02-03", "DATE"),
    ("2024-02-03 04:05:06", "DATETIME"), ("not a date", "DATE"), ("abc", "INT64"),
    (datetime.date(2024, 1, 2), "DATE"), (datetime.date(2024, 1, 2), "DATETIME"),
    (datetime.datetime(2024, 1, 2, 3, 4, 5), "DATETIME"), (19000, "DATE"), (None, "INT64"),
]


@pytest.mark.parametrize("value,lt", ZONE_VALUES, ids=[f"{lt}-{v}" for v, lt in ZONE_VALUES])
def test_zone_scalar_matches_jax(value, lt):
    from baikaldb_tpu.types import LType as JLType
    from baikaldb_tpu_torch.types import LType

    assert column_store._zone_scalar(value, LType[lt]) == \
        jcolumn_store._zone_scalar(value, JLType[lt])


PREDICATES = [
    "id >= 5 AND id < 10", "5 < id", "id = 7 AND id >= 3", "v > 1.5 AND w <= 2",
    "d >= '2024-02-01'", "id > 3 OR id < 1", "sv = 'a' AND id < 4", "id + 1 > 3",
    "id >= 5 AND id >= 9 AND id <= 20 AND id <= 15",
]


@pytest.mark.parametrize("pred", PREDICATES)
def test_analyze_conjuncts_matches_jax(pred):
    from baikaldb_tpu.sql.parser import parse_sql as jparse

    t = selector.analyze_conjuncts(parse_sql(f"SELECT * FROM t WHERE {pred}")[0].where)
    j = jselector.analyze_conjuncts(jparse(f"SELECT * FROM t WHERE {pred}")[0].where)
    assert (t.eq, t.ranges) == (j.eq, j.ranges)


def test_chunk_set_zones_and_pruning_match_jax(streamed):
    snap = stream_table(n=300)
    cs = streamchunks.StreamChunkSet("db.t", 1, snap, None, "cpu")
    jcs = jstreamchunks.StreamChunkSet("db.t", 1, snap, None)
    assert (cs.n_chunks, cs.live, cs.names) == (jcs.n_chunks, jcs.live, jcs.names)
    assert cs.zones == jcs.zones
    for ranges in ({}, {"id": [70, 130]}, {"id": [None, 10]}, {"id": [1000, None]},
                   {"d": ["2024-01-05", "2024-01-09"]}, {"gn": [3, 4], "id": [0, 200]},
                   {"v": [200.0, None]}):
        assert cs.pruned(ranges) == jcs.pruned(ranges), ranges


@pytest.mark.parametrize("chunk", [CHUNK, 100, 7])
def test_chunk_loader_ring_reuses_slots_and_keeps_every_chunk(chunk):
    """Columns whose values are their chunk id and row number, decoded by
    the stager into the ring and uploaded by the consumer: every chunk
    arrives whole and padded with dead rows while its slot is reused, and a
    dead load keeps the data with every row dead."""
    n = 1000
    cid = (np.arange(n) // chunk).astype(np.int64)
    snap = pa.table({"cid": cid, "x": pa.array(np.arange(n, dtype=np.float32),
                                               mask=np.arange(n) % 4 == 0),
                     "s": pa.array(np.array(["p", "q", None], dtype=object)[np.arange(n) % 3])})
    with flags(streaming_chunk_rows=chunk):
        cs = streamchunks.StreamChunkSet("db.r", 1, snap, None, "cpu")
    loader = streamchunks.ChunkLoader(cs)
    seen = []
    for i, slot in prefetch.staged(range(cs.n_chunks), loader.stage):
        b = loader.upload(slot).batch
        live = cs.live[i]
        rows = np.arange(i * chunk, i * chunk + live)
        assert len(b) == chunk and int(b.sel.sum()) == live and bool(b.sel[:live].all())
        assert torch.equal(b.column("cid").data[:live], torch.full((live,), i))
        assert int(b.column("cid").data[live:].abs().sum()) == 0
        x = b.column("x")
        assert torch.equal(x.data[:live][torch.from_numpy(rows % 4 != 0)],
                           torch.from_numpy(rows[rows % 4 != 0].astype(np.float32)))
        assert torch.equal(x.validity[:live], torch.from_numpy(rows % 4 != 0))
        assert not bool(x.validity[live:].any())
        sc = b.column("s")
        assert sc.dictionary is cs._dicts["s"]
        assert sc.dictionary.decode(sc.data[:live].numpy()[rows % 3 != 2]).tolist() == \
            [["p", "q"][r % 3] for r in rows if r % 3 != 2]
        seen.append(slot)
    assert seen == [i % loader.SLOTS for i in range(cs.n_chunks)]
    dead = loader.upload(loader.stage(0, dead=True)).batch
    assert not bool(dead.sel.any()) and torch.equal(dead.column("cid").data[:cs.live[0]],
                                                    torch.zeros(cs.live[0], dtype=torch.int64))


def test_chunk_set_is_cached_per_version_and_chunk_size(sessions, streamed):
    js, ts = sessions
    store = ts.db.stores["default.t"]
    ts.query("SELECT COUNT(*) n FROM t")
    first = store._stream_chunks
    ts.query("SELECT SUM(v) s FROM t")
    assert store._stream_chunks is first
    with flags(streaming_chunk_rows=128):
        ts.query("SELECT SUM(v) s FROM t")
        assert store._stream_chunks is not first and store._stream_chunks.capacity == 128


def test_stage_failure_falls_back_resident_and_is_counted(sessions, streamed, monkeypatch):
    """A failing host encode falls back to the resident path, counted in
    ``swallowed.session.stream_stage`` — and only the encode is caught."""
    js, ts = sessions
    store = ts.db.stores["default.t"]
    monkeypatch.setattr(store, "_stream_chunks", None)

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(streamchunks, "StreamChunkSet", boom)
    counter = metrics.REGISTRY.counter("swallowed.session.stream_stage")
    c0 = counter.value
    sql = "SELECT g, SUM(v) s FROM t GROUP BY g ORDER BY g"
    got, chunks, _ = run_counted(ts, metrics, sql)
    assert chunks == 0 and counter.value == c0 + 1
    assert got == js.query(sql)


# -- prefetch, failpoints, the cold tier -----------------------------------


def test_staged_yields_in_order_and_reraises_at_the_failed_item():
    assert list(prefetch.staged(range(5), lambda i: i * i)) == [(i, i * i) for i in range(5)]

    def stage(i):
        if i == 3:
            raise ValueError("bad chunk")
        return i
    got = []
    with pytest.raises(ValueError, match="bad chunk"):
        for i, _ in prefetch.staged(range(6), stage):
            got.append(i)
    assert got == [0, 1, 2]


def test_staged_stops_its_stager_when_abandoned():
    before = {t.ident for t in threading.enumerate()}
    it = prefetch.staged(range(1000), lambda i: i, name="abandoned-stager")
    assert next(it) == (0, 0)
    it.close()
    assert not [t for t in threading.enumerate()
                if t.name == "abandoned-stager" and t.ident not in before and t.is_alive()]


@pytest.mark.parametrize("spec", ["3*drop", "50%drop", "2*return(no disk)", "25%1*drop"])
def test_failpoint_schedule_matches_jax(spec):
    def schedule(mod):
        mod.set_failpoint("coldfs.get", spec)
        out = []
        try:
            for _ in range(12):
                try:
                    out.append(mod.hit("coldfs.get"))
                except mod.FailpointError:
                    out.append("error")
        finally:
            mod.clear_all()
        return out
    assert schedule(failpoint) == schedule(jfailpoint)
    assert not failpoint.ENABLED or FLAGS.chaos_enable


def test_unknown_failpoint_is_refused():
    with pytest.raises(ValueError, match="unknown failpoint"):
        failpoint.set_failpoint("coldfs.gte", "drop")


def test_external_fs_roundtrip_and_put_drop(tmp_path):
    fs = ExternalFS(str(tmp_path / "afs"))
    fs.put("stream/a/b", b"payload")
    assert fs.get("stream/a/b") == b"payload" and fs.exists("stream/a/b")
    assert fs.list() == ["stream_a_b"]
    try:
        failpoint.set_failpoint("coldfs.put", "1*drop")
        fs.put("lost", b"x")
    finally:
        failpoint.clear_all()
    assert not fs.exists("lost")
    fs.delete("stream/a/b")
    fs.delete("stream/a/b")
    assert fs.list() == []
    with pytest.raises(FileNotFoundError):
        fs.get("stream/a/b")


def test_put_drop_keeps_the_chunk_in_memory(tmp_path, streamed):
    """A dropped segment write leaves the chunk's bytes in host memory, so
    the scan cannot lose it."""
    snap = stream_table(n=200)
    fs = ExternalFS(str(tmp_path / "afs"))
    try:
        failpoint.set_failpoint("coldfs.put", "1*drop")
        cs = streamchunks.StreamChunkSet("db.t", 1, snap, fs, "cpu")
    finally:
        failpoint.clear_all()
    # the chunks build in parallel: the one dropped write is any chunk's
    assert len(cs._ram) == 1 and len(fs.list()) == cs.n_chunks - 1
    assert not fs.exists(cs._seg_name(next(iter(cs._ram))))
    total = sum(int(cs.decode(i)["id"][0].sum()) for i in range(cs.n_chunks))
    assert total == sum(range(200))


def test_staging_bench_refuses_without_a_card(monkeypatch):
    """``bench/stream_staging.py`` times staging variants on the card only."""
    from baikaldb_tpu_torch.bench import stream_staging

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["stream_staging", "--rows", "10"])
    assert stream_staging.main() == 1
