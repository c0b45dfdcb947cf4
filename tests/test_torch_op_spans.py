"""The executor's operator spans and the host-read spans and counter, on the
CPU over the 22 TPC-H queries at tests/test_torch_tpch.py's scale
(``generate(scale=0.002, seed=7)``), and the tracer's clock, its drop
counter and its device intervals (with stand-in events: the card's case is
in tests/test_torch_cuda.py).

- every executed plan node is exactly one ``op.*`` span, a child of
  ``exec.run``: a ``ShrinkNode``, a memoised copy of a derived table and a
  streamed scan's result are none;
- no span of the 22 queries is dropped under the default
  ``trace_max_spans``;
- every ``host_read`` of a tensor adds one to ``metrics.host_reads`` and,
  traced, is one ``host.read`` span naming its calling line; the counter
  moves alike with tracing on and off, so the spans read nothing more;
- with tracing off no span object is built.
"""

import collections
import re
import time

import pytest

from baikaldb_tpu_torch.exec import executor
from baikaldb_tpu_torch.exec.session import Session
from baikaldb_tpu_torch.models import tpch
from baikaldb_tpu_torch.obs import trace
from baikaldb_tpu_torch.plan import nodes as pn
from baikaldb_tpu_torch.utils import metrics
from baikaldb_tpu_torch.utils.flags import FLAGS

SCALE, SEED = 0.002, 7

OP = {pn.ScanNode: "op.scan", pn.FilterNode: "op.filter", pn.ProjectNode: "op.project",
      pn.JoinNode: "op.join", pn.MultiJoinNode: "op.join",
      pn.MembershipNode: "op.membership", pn.ScalarSourceNode: "op.scalar",
      pn.AggNode: "op.agg", pn.DistinctNode: "op.distinct", pn.SortNode: "op.sort",
      pn.LimitNode: "op.limit", pn.WindowNode: "op.window", pn.UnionNode: "op.union",
      pn.ValuesNode: "op.values"}

# the node kinds TPC-H does not run, each in a shape of its own
SHAPES = {
    "distinct": ("SELECT DISTINCT n_regionkey FROM nation", "op.distinct"),
    "limit": ("SELECT n_name FROM nation LIMIT 3", "op.limit"),
    "window": ("SELECT n_name, ROW_NUMBER() OVER (PARTITION BY n_regionkey "
               "ORDER BY n_nationkey) AS rn FROM nation", "op.window"),
    "union": ("SELECT n_name FROM nation UNION ALL SELECT r_name FROM region", "op.union"),
    "values": ("SELECT 1 + 1 AS two", "op.values"),
}


@pytest.fixture(scope="module")
def sess():
    s = Session(device="cpu")
    tables = tpch.generate(scale=SCALE, seed=SEED)
    for name, ddl in tpch.DDL.items():
        s.execute(ddl)
        s.load_arrow(name, tables[name])
    return s


@pytest.fixture
def traced():
    saved = (FLAGS.tracing, FLAGS.trace_sample_n, FLAGS.trace_store_max)
    FLAGS.set_flag("tracing", True)
    trace.TRACER.clear()
    yield
    for k, v in zip(("tracing", "trace_sample_n", "trace_store_max"), saved):
        FLAGS.set_flag(k, v)
    trace.TRACER.clear()


def _expected_ops(plan) -> collections.Counter:
    """The op spans one run of ``plan`` should record, from the plan alone."""
    out: collections.Counter = collections.Counter()
    memo: set = set()

    def walk(n):
        if isinstance(n, pn.ProjectNode) and n.derived:
            key = executor.derived_key(n)
            if key in memo:
                return
            memo.add(key)
        if isinstance(n, pn.StreamResultNode):
            return
        if not isinstance(n, pn.ShrinkNode):
            out[OP[type(n)]] += 1
        for c in n.children:
            walk(c)

    walk(plan)
    return out


def _traced_run(sess, monkeypatch, sql):
    """Run ``sql`` traced -> (its kept trace, the plans it ran)."""
    plans = []
    real = executor.compile_plan
    monkeypatch.setattr(executor, "compile_plan",
                        lambda plan, *a, **k: plans.append(plan) or real(plan, *a, **k))
    trace.TRACER.clear()
    sess.query(sql)
    recs = [t for t in trace.TRACER.list() if t["text"] == sql]
    assert len(recs) == 1
    return recs[0], plans


CASES = {**{k: (q, None) for k, q in tpch.QUERIES.items()}, **SHAPES}


@pytest.mark.parametrize("name", list(CASES))
def test_every_executed_node_is_one_op_span(sess, traced, monkeypatch, name):
    sql, kind = CASES[name]
    rec, plans = _traced_run(sess, monkeypatch, sql)
    assert plans and rec["dropped"] == 0
    by_id = {s["span_id"]: s for s in rec["spans"]}
    ops = [s for s in rec["spans"] if s["name"].startswith("op.")]
    assert all(by_id[s["parent_id"]]["name"] == "exec.run" for s in ops)
    assert sum(s["name"] == "exec.run" for s in rec["spans"]) == len(plans)
    want = sum((_expected_ops(p) for p in plans), collections.Counter())
    assert collections.Counter(s["name"] for s in ops) == want
    if kind is not None:
        assert want[kind] >= 1, kind
    # attributes are what the host knows; none is a tensor
    for s in ops:
        assert all(isinstance(v, (int, str)) for v in s["attrs"].values()), s
        if s["name"] == "op.agg":
            assert s["attrs"]["strategy"] in ("dense", "sorted", "scalar")
            # the CPU takes K1-K3's plain versions or the scatter, never a card route
            assert ("route" in s["attrs"]) == (s["attrs"]["strategy"] == "dense")
            assert s["attrs"].get("route", "scatter") in ("k123", "scatter")
        if s["name"] == "op.join":
            assert s["attrs"]["strategy"] in ("cross", "neq", "dense", "radix", "sort",
                                              "multiway")
        assert "dev_ts_us" not in s["attrs"]        # no device interval on the CPU


def _all_queries(sess) -> int:
    h0 = metrics.host_reads.value
    for q in tpch.QUERIES.values():
        sess.query(q)
    return metrics.host_reads.value - h0


def test_host_reads_are_spans_naming_their_site(sess, traced):
    moved = _all_queries(sess)
    spans = [s for t in trace.TRACER.list() for s in t["spans"] if s["name"] == "host.read"]
    assert moved == len(spans) > 0
    sites = collections.Counter(s["attrs"]["site"] for s in spans)
    assert all(re.fullmatch(r"[a-z_]+(/[a-z_]+)*\.py:\d+", k) for k in sites), sites
    # the joins' match totals and the scalar subqueries' live counts
    assert any(k.startswith("ops/join.py:") for k in sites)
    assert any(k.startswith("exec/executor.py:") for k in sites)
    assert all(t["dropped"] == 0 for t in trace.TRACER.list())


def test_tracing_adds_no_host_read(sess):
    _all_queries(sess)                  # plans cached
    off = _all_queries(sess)
    FLAGS.set_flag("tracing", True)
    try:
        on = _all_queries(sess)
    finally:
        FLAGS.set_flag("tracing", False)
        trace.TRACER.clear()
    assert on == off > 0


def test_tracing_off_builds_no_span(sess, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a span was built with tracing off")

    FLAGS.set_flag("tracing", False)
    trace.TRACER.clear()
    monkeypatch.setattr(trace, "_Span", boom)
    monkeypatch.setattr(trace, "_Root", boom)
    for q in list(tpch.QUERIES.values())[:6]:
        sess.query(q)
    assert trace.TRACER.list() == []


def test_spans_share_the_wall_clock(sess, traced):
    """Starts and ends come from ``time.time_ns``: every span of a query lies
    inside the wall-clock readings around it, and inside its parent."""
    t0 = time.time_ns() / 1e3
    sess.query(tpch.QUERIES["q3"])
    t1 = time.time_ns() / 1e3
    (rec,) = trace.TRACER.list()
    by_id = {s["span_id"]: s for s in rec["spans"]}
    slack = 1.0                                     # us: float rounding
    for s in rec["spans"]:
        end = s["ts_us"] + s["dur_ms"] * 1e3
        assert t0 - slack <= s["ts_us"] <= end <= t1 + slack, s["name"]
        p = by_id.get(s["parent_id"])
        if p is not None:
            assert p["ts_us"] - slack <= s["ts_us"]
            assert end <= p["ts_us"] + p["dur_ms"] * 1e3 + slack, s["name"]


def test_traces_dropped_counts_sampled_out_and_evicted(sess, traced):
    q = "SELECT COUNT(*) FROM nation"
    FLAGS.set_flag("trace_sample_n", 2)
    d0, k0 = metrics.traces_dropped.value, metrics.traces_sampled.value
    for _ in range(6):
        sess.query(q)
    kept = metrics.traces_sampled.value - k0
    assert kept == 3 and metrics.traces_dropped.value - d0 == 3
    FLAGS.set_flag("trace_sample_n", 1)
    FLAGS.set_flag("trace_store_max", 2)
    trace.TRACER.clear()
    d0 = metrics.traces_dropped.value
    for _ in range(5):
        sess.query(q)
    assert len(trace.TRACER.list()) == 2 and metrics.traces_dropped.value - d0 == 3


class _Event:
    """A stand-in CUDA event: its time is the host's wall clock in ms at
    record, ``delay_ms`` late (a queue of work ahead of it)."""

    made: list = []
    delay_ms = 0.0

    def __init__(self):
        self.t_ms = time.time_ns() / 1e6 + _Event.delay_ms
        _Event.made.append(self)

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms


class _Stream:
    """A stand-in CUDA stream."""

    device_index = 0


@pytest.fixture
def stand_in_events(monkeypatch):
    """Stand-in events, and a pool of free events of the test's own."""
    monkeypatch.setattr(trace, "_device_event", lambda stream: _Event())
    monkeypatch.setattr(trace, "_EVENTS", {})
    _Event.made.clear()
    _Event.delay_ms = 0.0
    return _Stream()


def test_device_intervals_resolve_at_the_root_of_a_kept_trace(traced, stand_in_events):
    card = stand_in_events
    with trace.root("query", "q"):
        _Event.delay_ms = 5.0                   # the ops queue behind 5 ms of work
        with trace.span("op.agg", card, strategy="dense"):
            time.sleep(0.002)
        with trace.span("op.sort", card):
            pass
        with trace.span("exec.egress"):
            pass
        _Event.delay_ms = 0.0                   # drained by the root's close
    rec = trace.TRACER.last()
    assert len(_Event.made) == 5                # two pairs and one anchor
    spans = {s["name"]: s for s in rec["spans"]}
    agg, srt = spans["op.agg"]["attrs"], spans["op.sort"]["attrs"]
    assert agg["strategy"] == "dense" and "dev_ts_us" not in spans["exec.egress"]["attrs"]
    assert agg["dev_ms"] == pytest.approx(spans["op.agg"]["dur_ms"], abs=0.5)
    # the anchor is reached when it is recorded: the intervals sit on the
    # wall clock 5 ms after their host spans, in stream order
    assert agg["dev_ts_us"] == pytest.approx(spans["op.agg"]["ts_us"] + 5e3, abs=500)
    assert agg["dev_ts_us"] + agg["dev_ms"] * 1e3 <= srt["dev_ts_us"] + 1.0
    # every event goes back to the free events once read
    assert sorted(map(id, trace._EVENTS[0])) == sorted(map(id, _Event.made))


def test_device_intervals_of_a_sampled_out_trace_stay_unread(traced, stand_in_events):
    FLAGS.set_flag("trace_sample_n", 1_000_000)
    trace.root("query", "warm").__enter__().__exit__(None, None, None)
    d0 = metrics.traces_dropped.value
    with trace.root("query", "q"):
        with trace.span("op.agg", stand_in_events):
            pass
    assert len(_Event.made) == 2                # the pair, and no anchor
    assert metrics.traces_dropped.value - d0 == 1
    assert len(trace._EVENTS[0]) == 2           # back to the free events, unread


def test_annotate_sets_the_innermost_open_span(traced):
    trace.annotate(route="none")                # no trace live: nothing happens
    with trace.root("query", "q"):
        trace.annotate(route="root")            # no span open: nothing happens
        with trace.span("op.agg", strategy="dense"):
            with trace.span("host.read"):
                trace.annotate(route="inner")
            trace.annotate(route="wide")
        with trace.span("op.sort"):
            pass
    spans = {s["name"]: s["attrs"] for s in trace.TRACER.last()["spans"]}
    assert spans["op.agg"] == {"strategy": "dense", "route": "wide"}
    assert spans["host.read"] == {"route": "inner"}
    assert spans["op.sort"] == {} and "route" not in spans["query"]


@pytest.mark.parametrize("q", ["q1", "q10", "q18"])
def test_dense_agg_route_is_the_route_taken(sess, traced, monkeypatch, q):
    """The ``route`` of an ``op.agg[dense]`` span is what ops/hashagg.py's
    ``group_aggregate_dense`` took, call for call."""
    from baikaldb_tpu_torch.ops import hashagg

    taken = []
    real = hashagg.dense_route

    def spy(*args, **kw):
        taken.append(real(*args, **kw))
        return taken[-1]

    monkeypatch.setattr(hashagg, "dense_route", spy)
    sess.query(tpch.QUERIES[q])
    spans = [s for s in trace.TRACER.last()["spans"]
             if s["name"] == "op.agg" and s["attrs"]["strategy"] == "dense"]
    assert taken and [s["attrs"]["route"] for s in spans] == taken
