"""The port's flag registry (utils/flags.py) and metrics counters
(utils/metrics.py) against the JAX package's: registry semantics, the
file / argv channel, the change listeners, the counter / latency / gauge
instruments, and their SQL surfaces (SET GLOBAL, SHOW VARIABLES / STATUS,
``information_schema.metrics`` / ``flags``) through a JAX ``Session``
(CPU, x64) and a port ``Session(device="cpu")``.

The cases mirror tests/test_flags_metrics.py but for its meta push (the
replicated tier) and its Pallas integration case (the kernels' parity is in
tests/test_torch_group_kernels.py).  Values, errors and rows are compared
exactly; counters by their deltas over the same statements, since each
package's registry is process-wide.
"""

import pytest

from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu.utils import flags as jflags
from baikaldb_tpu.utils import metrics as jmet
from baikaldb_tpu_torch.exec.session import Session as TSession
from baikaldb_tpu_torch.utils import flags as tflags
from baikaldb_tpu_torch.utils import metrics as tmet


def _reg(flags_mod):
    r = flags_mod.FlagRegistry()
    r.define("rate", 100.0, "a float")
    r.define("retries", 3, "an int")
    r.define("verbose", False, "a bool")
    r.define("tag", "hot", "a string")
    return r


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:      # noqa: BLE001 — compared across packages
        return ("error", type(e).__name__)


def test_defaults_and_types_match_jax():
    def run(f):
        r = _reg(f)
        out = [(r.rate, r.retries, r.verbose, r.tag)]
        r.set_flag("rate", "250")
        r.set_flag("verbose", "on")
        out.append((r.rate, r.verbose))
        out += [_outcome(lambda: r.set_flag("retries", "abc")),
                _outcome(lambda: r.set_flag("nope", 1)),
                _outcome(lambda: r.define("rate", 999.0))]
        return out
    j, t = run(jflags), run(tflags)
    assert t == j
    assert t[:2] == [(100.0, 3, False, "hot"), (250.0, True)]
    assert t[2:] == [("error", "FlagError")] * 3


def test_load_args_and_file_match_jax(tmp_path):
    conf = tmp_path / "gflags.conf"
    conf.write_text("# comment\n--rate=9\n--verbose=true\n\n--unknown=1\n")

    def run(f):
        r = _reg(f)
        rest = r.load_args(["--rate=1.5", "--noverbose", "--retries", "7", "pos"])
        out = [(r.rate, r.verbose, r.retries, rest),
               _outcome(lambda: r.load_file(str(conf)))]
        r.load_file(str(conf), ignore_unknown=True)
        return out + [(r.rate, r.verbose)]
    j, t = run(jflags), run(tflags)
    assert t == j == [(1.5, False, 7, ["pos"]), ("error", "FlagError"), (9.0, True)]


def test_listeners_fire_on_change_match_jax():
    def run(f):
        r = _reg(f)
        seen = []
        r.on_change("retries", seen.append)
        r.set_flag("retries", 5)
        r.set_flag("retries", "6")
        return seen
    assert run(jflags) == run(tflags) == [5, 6]


def test_metrics_counter_latency_gauge_match_jax():
    def run(m):
        reg = m.Registry()
        c = m.Counter("reqs", registry=reg)
        for _ in range(5):
            c.add(2)
        lat = m.LatencyRecorder("lat", registry=reg)
        for ms in (1.0, 2.0, 3.0, 100.0):
            lat.observe(ms)
        with lat.time():
            pass
        st = lat.stats()
        m.Gauge("depth", lambda: 42, registry=reg)
        exposed = reg.expose()
        dump = [line.split(" : ")[0] for line in reg.dump().splitlines()]
        return (c.value, c.per_second() > 0, st["count"], st["max_ms"],
                st["p50_ms"] <= st["p95_ms"] <= st["p99_ms"], exposed["reqs"]["value"],
                exposed["depth"]["value"], dump)
    j, t = run(jmet), run(tmet)
    assert t == j
    assert t[:7] == (10, True, 5, 100.0, True, 10, 42)
    assert "lat.p99_ms" in t[7]


def test_set_global_and_show_match_jax():
    outs = []
    for s, f in ((JSession(), jflags.FLAGS), (TSession(device="cpu"), tflags.FLAGS)):
        old = f.slow_query_ms
        try:
            s.execute("SET GLOBAL slow_query_ms = 123")
            out = [f.slow_query_ms, s.query("SHOW VARIABLES LIKE 'slow_query_ms'"),
                   _outcome(lambda: s.execute("SET GLOBAL no_such_flag = 1"))[0]]
            s.execute("SET @mine = 7")
            s.execute("SET autocommit = 1")
            out.append(s.session_vars["@mine"])
            outs.append(out)
        finally:
            f.set_flag("slow_query_ms", old)
    assert outs[1] == outs[0] == [
        123.0, [{"Variable_name": "slow_query_ms", "Value": "123.0"}], "error", 7]


def test_metrics_flow_through_sql_match_jax():
    outs = []
    for s, m in ((JSession(), jmet), (TSession(device="cpu"), tmet)):
        s.execute("CREATE TABLE m (id BIGINT PRIMARY KEY, v DOUBLE)")
        s.execute("INSERT INTO m VALUES (1, 2.0), (2, 3.0)")
        q0, h0, l0 = (m.queries_total.value, m.plan_cache_hits.value,
                      m.query_latency.stats()["count"])
        s.query("SELECT SUM(v) FROM m")
        s.query("SELECT SUM(v) FROM m")         # the second run hits the plan cache
        counts = (m.queries_total.value - q0, m.plan_cache_hits.value - h0,
                  m.query_latency.stats()["count"] - l0)
        lat = s.query("SELECT field, value FROM information_schema.metrics "
                      "WHERE name = 'query_latency' AND field = 'count'")
        flags = {r["name"] for r in s.query("SELECT name FROM information_schema.flags")}
        st = s.query("SHOW STATUS LIKE 'queries_total.value'")
        # join_retry_max has no counterpart (the port's joins emit exactly
        # their matched rows); the flags of this plane are in both
        want = {"slow_query_ms", "progress_tracking", "flightrec_max", "watchdog_stall_s",
                "watchdog_interval_s"}
        outs.append((counts, lat[0]["value"] >= 2, want <= flags,
                     int(st[0]["Value"]) >= 2, [r["Variable_name"] for r in st]))
    assert outs[1] == outs[0]
    assert outs[1][0] == (2, 1, 2) and outs[1][1:4] == (True, True, True)


@pytest.mark.parametrize("sql,field", [
    ("INSERT INTO d VALUES (3, 1.0), (4, 2.0)", "dml_rows"),
    ("UPDATE d SET v = v + 1 WHERE id > 0", "dml_rows"),
    ("SELECT * FROM d", "rows_returned"),
])
def test_statement_counters_move_as_in_jax(sql, field):
    """dml_rows, rows_returned, queries_total and query_latency move by the
    same amounts over the same statement."""
    outs = []
    for s, m in ((JSession(), jmet), (TSession(device="cpu"), tmet)):
        s.execute("CREATE TABLE d (id BIGINT PRIMARY KEY, v DOUBLE)")
        s.execute("INSERT INTO d VALUES (1, 0.5), (2, 1.5)")
        names = (field, "queries_total", "queries_failed")
        before = [getattr(m, n).value for n in names] + [m.query_latency.stats()["count"]]
        s.execute(sql)
        after = [getattr(m, n).value for n in names] + [m.query_latency.stats()["count"]]
        outs.append([a - b for a, b in zip(after, before)])
    assert outs[1] == outs[0]
    assert outs[1][1:] == [1, 0, 1] and outs[1][0] == 2
