"""The port's SHOW PROFILES / SHOW PROFILE [FOR QUERY n] over its kept
traces (obs/trace.py) against the JAX package's, with the unknown-id error,
``information_schema.trace_spans`` and the query log's plan-cache column.

Each case runs the same statements through a JAX ``Session`` (CPU, x64) and
a port ``Session(device="cpu")`` with ``tracing`` on in both registries and
each package's trace store cleared.  Span names, the tree's indentation,
query texts, kinds, nodes, cache outcomes and error types are compared
exactly; durations for sign and order only (the root spans its children).
The span tree of the port's executor is its own: the cases compare the
stages both packages record (``query``, ``parse``, ``plan.cache``,
``exec.batches``, ``exec.run``, ``egress.arrow``).  The cases mirror
tests/test_tracing.py's but for its RPC stitching and fleet cases.
"""

import pytest

from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.obs import trace as jtrace
from baikaldb_tpu.utils.flags import FLAGS as JFLAGS
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.obs import trace as ttrace
from baikaldb_tpu_torch.utils.flags import FLAGS as TFLAGS

SHARED = ("query", "parse", "plan.cache", "exec.batches", "exec.run", "egress.arrow")


@pytest.fixture
def traced():
    """tracing on in both packages, clean stores, flags restored."""
    saved = [(f, f.trace_sample_n, f.slow_query_ms) for f in (JFLAGS, TFLAGS)]
    for f in (JFLAGS, TFLAGS):
        f.set_flag("tracing", True)
    jtrace.TRACER.clear()
    ttrace.TRACER.clear()
    yield
    for f, n, slow in saved:
        f.set_flag("tracing", False)
        f.set_flag("trace_sample_n", n)
        f.set_flag("slow_query_ms", slow)
    jtrace.TRACER.clear()
    ttrace.TRACER.clear()


def _pair():
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute("CREATE TABLE tt (id BIGINT, v DOUBLE)")
        s.execute("INSERT INTO tt VALUES (1, 1.5), (2, 2.5), (3, 0.5)")
        out.append(s)
    return out


def _clear():
    jtrace.TRACER.clear()
    ttrace.TRACER.clear()


def _shared_stages(rows):
    """(indent, name) of the stages both packages record, in tree order."""
    out = []
    for r in rows:
        name = r[0].strip()
        if name in SHARED:
            out.append((len(r[0]) - len(r[0].lstrip(" ")), name))
    return out


def test_show_profile_round_trip_matches_jax(traced):
    outs = []
    for s in _pair():
        _clear()
        s.query("SELECT SUM(v) FROM tt")
        profiles = s.execute("SHOW PROFILES")
        qid = profiles.rows[0][0]
        prof = s.execute(f"SHOW PROFILE FOR QUERY {qid}")
        raw = [r[0] for r in prof.rows]
        durs = [r[1] for r in prof.rows]
        bare = s.execute("SHOW PROFILE")
        again = s.execute("SHOW PROFILES")
        outs.append({
            "columns": (profiles.columns, prof.columns),
            "profiles": [(r[2], r[3]) for r in profiles.rows],
            "durations": profiles.rows[0][1] > 0.0 and all(d >= 0.0 for d in durs)
            and durs[0] == max(durs),
            "stages": _shared_stages(prof.rows),
            "root": raw[0],
            "nodes": sorted({r[2] for r in prof.rows}),
            # bare SHOW PROFILE = the newest kept trace, and the SHOW
            # statements never pollute the store they read
            "bare": [r[0] for r in bare.rows] == raw,
            "kept": len(again.rows),
        })
    assert outs[1] == outs[0]
    o = outs[1]
    assert o["columns"] == (["Query_ID", "Duration_ms", "Kind", "Query"],
                            ["Status", "Duration_ms", "Node"])
    assert o["profiles"] == [("query", "SELECT SUM(v) FROM tt")]
    assert o["durations"] and o["bare"] and o["kept"] == 1 and o["root"] == "query"
    assert [n for _, n in o["stages"]] == list(SHARED)
    assert o["nodes"] == ["frontend"]


@pytest.mark.parametrize("sql", ["SHOW PROFILE FOR QUERY 999999", "SHOW PROFILE"])
def test_show_profile_without_a_kept_trace_fails_as_jax(traced, sql):
    outs = []
    for s in _pair():
        _clear()
        try:
            s.execute(sql)
            outs.append(None)
        except Exception as e:      # noqa: BLE001 — compared across packages
            outs.append((type(e).__name__, str(e)))
    assert outs[1] == outs[0] and outs[1][0] == "PlanError"
    assert "no kept trace" in outs[1][1]


def test_show_profiles_lists_each_kept_query_as_jax(traced):
    sqls = ["SELECT COUNT(*) FROM tt", "SELECT v FROM tt WHERE id = 2",
            "INSERT INTO tt VALUES (4, 4.5)", "SELECT MAX(v) FROM tt"]
    outs = []
    for s in _pair():
        _clear()
        for q in sqls:
            s.execute(q)
        rows = s.execute("SHOW PROFILES").rows
        ids = [r[0] for r in rows]
        outs.append(([(r[2], r[3]) for r in rows], ids == sorted(ids),
                     [_shared_stages(s.execute(f"SHOW PROFILE FOR QUERY {i}").rows)
                      for i in ids]))
    assert outs[1] == outs[0]
    assert [q for _, q in outs[1][0]] == sqls and outs[1][1]


def test_tracing_off_keeps_no_profile_as_jax():
    outs = []
    for s, f in zip(_pair(), (JFLAGS, TFLAGS)):
        f.set_flag("tracing", False)
        _clear()
        s.query("SELECT COUNT(*) FROM tt")
        outs.append(s.execute("SHOW PROFILES").rows)
    assert outs[1] == outs[0] == []


def test_trace_spans_virtual_table_matches_jax(traced):
    outs = []
    for s in _pair():
        _clear()
        s.query("SELECT COUNT(*) FROM tt")
        rows = s.query("SELECT name, node, duration_ms FROM information_schema.trace_spans")
        names = {r["name"] for r in rows}
        outs.append((sorted(names & set(SHARED)), {r["node"] for r in rows},
                     all(r["duration_ms"] >= 0.0 for r in rows)))
    assert outs[1] == outs[0]
    assert outs[1] == (sorted(SHARED), {"frontend"}, True)


def test_query_log_enriched_with_cache_outcome_as_jax(traced):
    outs = []
    for s in _pair():
        s.query("SELECT v FROM tt WHERE id = 1")
        s.query("SELECT v FROM tt WHERE id = 2")     # a param-cache variant
        s.query("SELECT v FROM tt WHERE id = 1")     # the same text again
        rows = s.query("SELECT query, cache, capacity_bucket FROM information_schema.query_log")
        mine = [r for r in rows if "FROM tt WHERE id" in r["query"]]
        outs.append(([(r["query"], r["cache"]) for r in mine],
                     all("default.tt=" in r["capacity_bucket"] for r in mine)))
    assert outs[1] == outs[0]
    assert [c for _, c in outs[1][0]] == ["miss", "param_hit", "hit"] and outs[1][1]
