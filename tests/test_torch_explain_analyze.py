"""The port's EXPLAIN ANALYZE against the JAX package's, for the shapes of
tests/test_sql.py:438-480, tests/test_mvcc.py:329-340 and
tests/test_streaming_scan.py:241.

Both sessions get the same DDL and rows; the operator lines (each plan
node's label and live output rows; a Shrink's capacity aside, which only
the JAX join-retry loop sets) must be equal, and so must the
``-- params``, ``-- snapshot`` (but its timestamps) and ``-- stream`` (but
its timings) lines.  Every line renders from the trace's span records.
"""

import re

import pytest

from baikaldb_tpu.exec.session import Database as JDatabase
from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.utils.flags import FLAGS as JFLAGS
from baikaldb_tpu_torch.exec.session import Database as TDatabase
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.utils.flags import FLAGS


def _lines(s, sql):
    return [r["plan"] for r in s.query("EXPLAIN ANALYZE " + sql)]


def _ops(lines):
    # the JAX join-retry loop settles a Shrink's capacity; the port's
    # Shrink passes its child through (exact joins), so its cap stays None
    return [re.sub(r"Shrink\(cap=\w+\)", "Shrink(cap)", ln) for ln in lines
            if not ln.startswith("-- ")]


def _line(lines, prefix):
    return next((ln for ln in lines if ln.startswith(prefix)), None)


@pytest.fixture
def sql_pair():
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, g VARCHAR(16), v DOUBLE, d DATE)")
        s.execute("INSERT INTO t (id, g, v, d) VALUES "
                  "(1,'a',10.0,'2024-01-01'),(2,'b',20.0,'2024-01-02'),"
                  "(3,'a',30.0,'2024-02-01'),(4,NULL,40.0,'2024-03-05'),"
                  "(5,'b',NULL,'2024-01-01')")
        s.execute("CREATE TABLE r (g VARCHAR(16), label VARCHAR(32))")
        s.execute("INSERT INTO r VALUES ('a','alpha'),('b','beta')")
        s.execute("CREATE TABLE ea (k BIGINT)")
        s.execute("CREATE TABLE eb (k BIGINT, v BIGINT)")
        s.execute("INSERT INTO ea VALUES (1), (2)")
        s.execute("INSERT INTO eb VALUES (1,1),(1,2),(1,3),(1,4),(2,5),(2,6),(2,7),(2,8)")
        out.append(s)
    return out


SHAPES = [
    "SELECT g, SUM(v) s FROM t WHERE v > 0 GROUP BY g",
    "SELECT ea.k, v FROM ea JOIN eb ON ea.k = eb.k",
    "SELECT t.id, r.label FROM t JOIN r ON t.g = r.g WHERE t.v > 15 ORDER BY t.id",
    "SELECT COUNT(*) c FROM t WHERE d >= '2024-01-02'",
    "SELECT id FROM t WHERE g = 'a' ORDER BY id DESC LIMIT 1",
]


@pytest.mark.parametrize("sql", SHAPES)
def test_operator_lines_and_counts_match_jax(sql_pair, sql):
    js, ts = sql_pair
    jl, tl = _lines(js, sql), _lines(ts, sql)
    assert _ops(tl) == _ops(jl)
    assert "rows=" in "\n".join(tl) and _line(tl, "-- run:")
    assert _line(tl, "-- params:") == _line(jl, "-- params:").split(" param_hits_total")[0] + \
        " param_hits_total=" + _line(tl, "-- params:").split("param_hits_total=")[1]
    for prefix in ("-- batch:", "-- dispatch:", "-- exchange:", "-- trace:", "-- guards:"):
        assert _line(tl, prefix), prefix
    # the guards line is the JAX session's text; its trip counts are each
    # package's process-wide counters (tests/test_torch_guards.py equalizes
    # them to compare the numbers too)
    assert re.sub(r"\d+", "N", _line(tl, "-- guards:")) == \
        re.sub(r"\d+", "N", _line(jl, "-- guards:"))
    for gone in ("-- xla:", "-- aot:", "-- device", "-- view:", "-- fragments:"):
        assert _line(tl, gone) is None


def test_join_counts_are_the_join_output(sql_pair):
    js, ts = sql_pair
    txt = "\n".join(_lines(ts, "SELECT ea.k, v FROM ea JOIN eb ON ea.k = eb.k"))
    assert "rows=8" in txt


def test_lines_render_from_the_trace(sql_pair):
    """The EXPLAIN ANALYZE result is a rendering of its trace's span
    records: the ``-- trace`` line counts them, and the run line carries
    the exec.steady span's duration."""
    from baikaldb_tpu_torch.obs import trace

    js, ts = sql_pair
    sql = SHAPES[0]
    lines = _lines(ts, sql)
    rec = [t for t in trace.TRACER.list() if t["kind"] == "explain_analyze"][-1]
    spans = [s for s in rec["spans"] if s["name"] != "explain_analyze"]
    assert _line(lines, "-- trace:").startswith(f"-- trace: spans={len(spans)} ")
    steady = [s for s in spans if s["name"] == "exec.steady"][-1]
    assert f"-- run: {steady['dur_ms']:.2f} ms" in _line(lines, "-- run:")
    ops = [s["attrs"] for s in spans if s["name"] == "op"]
    assert [a["label"] + (f"  rows={a['rows']}" if "rows" in a else "") for a in ops] == \
        _ops(lines)


def _mvcc_pair():
    out = []
    for Db, S in ((JDatabase, JSession), (TDatabase, TSession)):
        db = Db() if Db is JDatabase else Db("cpu")
        s = S(db, "t")
        s.execute("CREATE DATABASE t")
        s.execute("CREATE TABLE r (id BIGINT, g BIGINT, v BIGINT, PRIMARY KEY (id))")
        for i in range(8):
            s.execute(f"INSERT INTO r VALUES ({i}, {i % 2}, {i * 10})")
        out.append((db, s))
    return out


def test_snapshot_line_matches_jax():
    got = []
    for db, s in _mvcc_pair():
        s.execute("SET SNAPSHOT = 'now'")
        w = type(s)(db, "t")
        w.execute("UPDATE r SET v = v + 1 WHERE id = 0")     # one history version
        lines = _lines(s, "SELECT SUM(v) FROM r")
        line = _line(lines, "-- snapshot:")
        assert f"ts={s._snapshot[1]}" in line and "gc_watermark=" in line
        got.append((re.sub(r"ts=\d+|gc_watermark=\d+", "", line), _ops(lines)))
        s.execute("SET SNAPSHOT = 0")
        assert _line(_lines(s, "SELECT id FROM r WHERE id = 3"), "-- snapshot:") is None
    assert got[1] == got[0]
    assert "versions_scanned=1" in got[1][0]


STREAM = {"streaming_scan": True, "streaming_min_rows": 1, "streaming_chunk_rows": 64}


@pytest.fixture
def stream_pair(tmp_path):
    prev = [(reg, k, getattr(reg, k)) for k in STREAM for reg in (FLAGS, JFLAGS)]
    for reg in (FLAGS, JFLAGS):
        for k, v in STREAM.items():
            reg.set_flag(k, v)
    out = []
    for i, (Db, S) in enumerate(((JDatabase, JSession), (TDatabase, TSession))):
        cold = str(tmp_path / f"afs{i}")
        s = S(Db(cold_dir=cold) if Db is JDatabase else Db("cpu", cold_dir=cold))
        s.execute("CREATE TABLE t (id BIGINT, g BIGINT, sv VARCHAR(8), v DOUBLE, w DOUBLE, "
                  "PRIMARY KEY (id))")
        svs = ["'a'", "'b'", "'c'", "'d'", "NULL"]
        for lo in range(0, 500, 100):
            s.execute("INSERT INTO t VALUES " + ", ".join(
                f"({k}, {k % 7}, {svs[k % 5]}, {float(k % 101)}, {float((k * 3) % 53)})"
                for k in range(lo, lo + 100)))
        out.append(s)
    try:
        yield out
    finally:
        for reg, k, v in prev:
            reg.set_flag(k, v)


def test_stream_line_matches_jax(stream_pair):
    js, ts = stream_pair
    sql = "SELECT g, SUM(v) s FROM t WHERE id < 400 GROUP BY g"
    jl, tl = _lines(js, sql), _lines(ts, sql)
    pat = re.compile(r"-- stream: chunks=(\d+)/(\d+) skipped=(\d+) bytes_h2d=(\d+) "
                     r"prefetch_wait_ms=([\d.]+) stage_ms=([\d.]+) restarts=(\d+)")
    jm, tm = pat.search(_line(jl, "-- stream:")), pat.search(_line(tl, "-- stream:"))
    assert tm and jm
    assert tm.group(1, 2, 3, 7) == jm.group(1, 2, 3, 7)
    assert int(tm.group(4)) > 0
    assert _ops(tl) == _ops(jl)                 # uncounted: a fold has no single run
    assert "stream(" in "\n".join(tl)
