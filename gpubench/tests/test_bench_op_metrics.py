"""The readers of the executor's spans and counters (``agg_device_ms``,
``join_device_ms``, ``host_read_ms``, ``exec_host_ms``, ``host_reads``) on
a hand-made ``Run``: known spans, busy intervals and counters give known
numbers, and a run of a program without them gives None."""

import pytest

from gpubench.core.cell import Run
from gpubench.core.device import Slice
from gpubench.core.loop import Record
from gpubench.core.spec import module

T0 = 1_700_000_000_000_000_000       # the slice's start on the wall clock, ns
# a span's microseconds since the epoch are a float: a quarter of a
# microsecond apart at this date, so device intervals read to about 1 us
US = 1e-3


def span(sid, parent, name, ts_ms, dur_ms, **attrs):
    return {"span_id": sid, "parent_id": parent, "name": name,
            "ts_us": (T0 + ts_ms * 1e6) / 1e3, "dur_ms": dur_ms, "node": "", "attrs": attrs}


def dev(start_ms, ms):
    """The device interval attributes of an op span starting ``start_ms``
    into the slice."""
    return {"dev_ts_us": (T0 + start_ms * 1e6) / 1e3, "dev_ms": ms}


def make_slice(busy_ms: list) -> Slice:
    sl = Slice()
    sl.t0_ns, sl.t1_ns = T0, T0 + 100_000_000          # 100 ms
    sl.p0, sl.p1 = 10.0, 10.1
    sl.ops = [("kernel", T0 + int(a * 1e6), T0 + int(b * 1e6)) for a, b in busy_ms]
    return sl


def traces():
    """Two statements.  The first: exec.run 0-40 ms holding a join (device
    5-15 ms) whose host read takes 2 ms, an agg (device 20-30 ms) and a
    scalar subquery's read of 1 ms.  The second: exec.run 50-60 ms holding
    an agg (device 52-58 ms) and no read."""
    a = [span("r", "", "query", 0, 45),
         span("e", "r", "exec.run", 0, 40),
         span("j", "e", "op.join", 4, 12, strategy="sort", **dev(5, 10)),
         span("h1", "j", "host.read", 10, 2.0, site="ops/join.py:346"),
         span("g", "e", "op.agg", 18, 12, strategy="sorted", **dev(20, 10)),
         span("s", "e", "op.scalar", 31, 2),
         span("h2", "s", "host.read", 31.5, 1.0, site="exec/executor.py:428"),
         span("h3", "r", "host.read", 41, 0.5, site="exec/session.py:3686")]
    b = [span("r2", "", "query", 50, 12),
         span("e2", "r2", "exec.run", 50, 10),
         span("g2", "e2", "op.agg", 51, 8, strategy="dense", **dev(52, 6))]
    return [{"spans": a}, {"spans": b}]


def make_run(busy_ms, spans=None, counters=None, answered=2, done=(10.05, 10.06)):
    recs = [Record(0, None, d - 0.01, d) for d in done]
    return Run(cell=None, records=recs, window_s=20.0, answered=answered, setup_s=1.0,
               mem_peak_window=0, tables={}, counters=counters or {},
               traces=traces() if spans is None else spans, slice=make_slice(busy_ms))


def read(name, run):
    return module("metrics", name).read(run)


def test_device_ms_inside_the_op_intervals():
    # busy 0-8 (3 ms inside the join's 5-15), 12-25 (3 ms join, 5 ms agg),
    # 28-40 (2 ms agg), 53-54 (1 ms agg); two statements came back in the slice
    run = make_run([(0, 8), (12, 25), (28, 40), (53, 54)])
    assert read("join_device_ms", run) == pytest.approx((3 + 3) / 2, abs=US)
    assert read("agg_device_ms", run) == pytest.approx((5 + 2 + 1) / 2, abs=US)


def test_overlapping_op_intervals_count_once():
    spans = traces()
    spans[1]["spans"].append(span("g3", "e2", "op.agg", 52, 8, **dev(53, 6)))
    run = make_run([(50, 60)], spans=spans)
    # busy 50-60 holds the second statement's aggs, 52-58 and 53-59: 7 ms
    assert read("agg_device_ms", run) == pytest.approx(7 / 2, abs=US)


def test_host_read_ms_and_exec_host_ms():
    run = make_run([(0, 1)])
    assert read("host_read_ms", run) == pytest.approx((2.0 + 1.0 + 0.5 + 0) / 2)
    # exec.run less the reads under it: (40 - 3) and 10; the read outside
    # exec.run (the session's) is not the executor's
    assert read("exec_host_ms", run) == pytest.approx((37 + 10) / 2)


def test_host_reads_over_statements_answered():
    run = make_run([(0, 1)], counters={"host_reads": 12}, answered=4)
    assert read("host_reads", run) == 3.0


def test_nothing_to_read_gives_none():
    # the parent's program: no op spans, no device intervals, no counter
    bare = [{"spans": [span("r", "", "query", 0, 5), span("e", "r", "exec.run", 0, 4)]}]
    run = make_run([(0, 1)], spans=bare)
    for name in ("agg_device_ms", "join_device_ms", "host_read_ms", "exec_host_ms",
                 "host_reads"):
        assert read(name, run) is None, name
    # op spans without device intervals (a CPU run), and no slice at all
    cpu = [{"spans": [dict(sp, attrs={}) for sp in traces()[0]["spans"]]}]
    assert read("agg_device_ms", make_run([(0, 1)], spans=cpu)) is None
    run = make_run([(0, 1)])
    run.slice = None
    assert read("join_device_ms", run) is None and read("agg_device_ms", run) is None
    # no statement came back inside the slice
    assert read("agg_device_ms", make_run([(0, 1)], done=(9.0, 11.0))) is None
    assert read("host_reads", make_run([(0, 1)], counters={"host_reads": 3},
                                       answered=0)) is None
