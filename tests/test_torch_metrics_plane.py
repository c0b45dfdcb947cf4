"""The port's metrics plane (utils/metrics.py) and the local half of its
telemetry (obs/telemetry.py) against the JAX package's.

Every case of tests/test_metrics_plane.py runs the same inputs through both
packages' functions and holds the outputs equal: the labelled families, the
fixed-bucket Histogram and its quantile estimate, the window rate, the gauge
dump guard (through SHOW STATUS and ``information_schema.metrics`` of a JAX
``Session`` and a port ``Session(device="cpu")``), the registry under
concurrent snapshots, the deterministic fleet merge, and the Prometheus
text.  Values are compared exactly; the per-second rates, which read the
clock, are compared with the reference's analytic value (rel 0.1, as the
JAX test does) and with each other.
"""

import itertools
import math
import re
import threading
import time

import pytest

from baikaldb_tpu.obs import telemetry as jtel
from baikaldb_tpu.utils import metrics as jmet
from baikaldb_tpu_torch.obs import telemetry as ttel
from baikaldb_tpu_torch.utils import metrics as tmet

PKGS = [(jmet, jtel), (tmet, ttel)]


def _no_rates(snap: dict) -> dict:
    """A snapshot without the clock-dependent ``per_second`` fields."""
    return {name: {**ent, "rows": [{k: v for k, v in row.items() if k != "per_second"}
                                   for row in ent["rows"]]}
            for name, ent in snap.items()}


def _both(fn):
    """``fn(metrics, telemetry)`` for each package -> (jax, port)."""
    return tuple(fn(m, t) for m, t in PKGS)


def _nan_eq(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_nan_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_nan_eq(x, y) for x, y in zip(a, b))
    return a == b


# ---- Histogram -------------------------------------------------------------

def test_histogram_bucket_semantics_match_jax():
    def run(m, _t):
        r = m.Registry()
        h = r.histogram("lat", buckets=(1.0, 10.0, 100.0))
        for v in (0.5, 1.0, 5.0, 10.0, 99.0, 1000.0):
            h.observe(v)
        return h.snapshot_fields(), h.stats()
    j, t = _both(run)
    assert t == j
    snap, st = t
    assert snap["le"] == [1.0, 10.0, 100.0] and snap["buckets"] == [2, 2, 1, 1]
    assert snap["count"] == 6.0 and snap["sum"] == pytest.approx(1115.5)
    assert 0 < st["p50"] <= 10.0 <= st["p99"]


def test_histogram_quantile_interpolation_matches_jax():
    cases = [(0.5, [10.0, 20.0], [0, 4, 0]), (0.5, [10.0, 20.0], [0, 0, 0]),
             (0.99, [10.0, 20.0], [0, 0, 5]), (0.3, [1.0, 2.0, 4.0], [3, 1, 2, 1])]
    j, t = _both(lambda m, _t: [m.histogram_quantile(q, le, b) for q, le, b in cases])
    assert t == j
    assert t[:3] == [pytest.approx(15.0), 0.0, 20.0]


# ---- labelled families -----------------------------------------------------

def test_families_label_discipline_and_rows_match_jax():
    def run(m, _t):
        r = m.Registry()
        f = r.counter_family("rpc_requests", ("method", "peer"))
        f.labels(method="ping", peer="a").add(2)
        f.labels(peer="a", method="ping").add(1)
        f.labels(method="propose", peer="b").add(5)
        errs = []
        for kw in ({"method": "ping"}, {"method": "ping", "peer": "a", "extra": "x"}):
            try:
                f.labels(**kw)
            except ValueError as e:
                errs.append(str(e))
        before = _no_rates(r.snapshot())
        f.remove(method="ping", peer="a")
        expose = {k: v for k, v in r.expose()["rpc_requests"].items()
                  if not k.endswith("per_second")}
        return before, errs, _no_rates(r.snapshot()), expose
    j, t = _both(run)
    assert t == j
    before, errs, after, expose = t
    assert {tuple(row["labels"]): row["value"] for row in before["rpc_requests"]["rows"]} \
        == {("ping", "a"): 3, ("propose", "b"): 5}
    assert len(errs) == 2 and len(after["rpc_requests"]["rows"]) == 1
    assert expose["{method=propose,peer=b}.value"] == 5


def test_gauge_family_settable_and_add_match_jax():
    def run(m, _t):
        r = m.Registry()
        g = r.gauge_family("inflight", ("method",))
        for d in (1, 1, -1):
            g.labels(method="scan").add(d)
        first = r.snapshot()["inflight"]["rows"][0]["value"]
        g.labels(method="scan").set(7)
        return first, r.snapshot()
    j, t = _both(run)
    assert t == j and t[0] == 1.0 and t[1]["inflight"]["rows"][0]["value"] == 7.0


# ---- Counter.per_second window semantics ----------------------------------

def test_per_second_window_semantics_match_jax():
    def run(m, _t):
        c = m.Counter("reqs", registry=m.Registry())
        now = time.monotonic()
        c._value = 40
        c._window.clear()
        c._window.extend([(now - 30, 10), (now - 20, 20), (now - 5, 30), (now - 2, 40)])
        r10, r60 = c.per_second(window_s=10.0), c.per_second(window_s=60.0)
        c._window.clear()
        empty = c.per_second()
        c._window.append((now, 40))
        return r10, r60, empty, c.per_second()
    j, t = _both(run)
    for got, want in ((t, j), (j, j)):
        assert got[0] == pytest.approx((40 - 20) / 20.0, rel=0.1)
        assert got[1] == pytest.approx((40 - 10) / 30.0, rel=0.1)
        assert got[2:] == (0.0, 0.0)
    assert t[0] == pytest.approx(j[0], rel=1e-3) and t[1] == pytest.approx(j[1], rel=1e-3)


def test_per_second_live_matches_jax():
    def run(m, _t):
        c = m.Counter("live", registry=m.Registry())
        for _ in range(50):
            c.add(2)
        return c.value, c.per_second() > 0
    assert _both(run) == ((100, True), (100, True))


# ---- the gauge dump guard --------------------------------------------------

def test_raising_gauge_does_not_break_expose_in_either_package():
    def run(m, _t):
        r = m.Registry()
        m.Gauge("boom", fn=lambda: 1 / 0, registry=r)
        r.counter("ok").add(3)
        before = m.REGISTRY.counter("swallowed.metrics.gauge").value
        exposed = r.expose()
        return (math.isnan(exposed["boom"]["value"]), exposed["ok"]["value"],
                "boom.value" in r.dump(),
                m.REGISTRY.counter("swallowed.metrics.gauge").value > before)
    assert _both(run) == ((True, 3, True, True),) * 2


def test_raising_gauge_does_not_break_show_status_in_either_package():
    from baikaldb_tpu.exec.session import Database as JDatabase
    from baikaldb_tpu.exec.session import Session as JSession
    from baikaldb_tpu_torch.exec.session import Database as TDatabase
    from baikaldb_tpu_torch.exec.session import Session as TSession

    outs = []
    for m, s in ((jmet, JSession(JDatabase())), (tmet, TSession(TDatabase("cpu")))):
        m.REGISTRY.gauge("test_boom_gauge", fn=lambda: 1 / 0)
        status = s.query("SHOW STATUS LIKE 'test_boom_gauge%'")
        info = s.query("SELECT * FROM information_schema.metrics "
                       "WHERE name = 'test_boom_gauge'")
        outs.append((status, [(r["name"], r["field"], math.isnan(r["value"])) for r in info]))
    assert outs[1] == outs[0]
    assert outs[1][0] == [{"Variable_name": "test_boom_gauge.value", "Value": "nan"}]
    assert outs[1][1] == [("test_boom_gauge", "value", True)]


# ---- registry thread-safety ------------------------------------------------

def test_registry_thread_safety_under_concurrent_snapshot_matches_jax():
    N, PER = 8, 500

    def run(m, _t):
        r = m.Registry()
        errs = []
        stop = threading.Event()

        def worker(i):
            try:
                c = r.counter("w_total")
                f = r.histogram_family("w_lat", ("worker",))
                g = r.gauge_family("w_gauge", ("worker",))
                for k in range(PER):
                    c.add(1)
                    f.labels(worker=str(i)).observe(float(k % 7))
                    g.labels(worker=str(i)).set(k)
            except Exception as e:  # noqa: BLE001 — collected for the assert
                errs.append(e)

        def poller():
            try:
                while not stop.is_set():
                    r.snapshot()
                    r.expose()
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(N)]
        pt = threading.Thread(target=poller)
        pt.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        pt.join(timeout=60)
        return errs, _no_rates(r.snapshot())
    j, t = _both(run)
    assert t[0] == [] and j[0] == []
    assert t[1] == j[1]
    snap = t[1]
    assert snap["w_total"]["rows"][0]["value"] == N * PER
    assert sum(row["count"] for row in snap["w_lat"]["rows"]) == N * PER
    assert all(sum(row["buckets"]) == row["count"] for row in snap["w_lat"]["rows"])


# ---- merge determinism -----------------------------------------------------

def _snap_with(m, obs, adds):
    r = m.Registry()
    h = r.histogram("lat")
    for v in obs:
        h.observe(v)
    r.counter("writes").add(adds)
    r.counter_family("per_table", ("table",)).labels(table="t1").add(adds * 2)
    r.gauge_family("w_gauge", ("worker",)).labels(worker="0").set(adds)
    return _no_rates(r.snapshot())


def test_merge_bucketwise_order_independent_and_exact_matches_jax():
    def run(m, t):
        a = _snap_with(m, [0.2, 3.0, 700.0], 5)
        b = _snap_with(m, [0.2, 0.2], 7)
        c = _snap_with(m, [90000.0], 11)
        return [t.merge_snapshots(dict(perm))
                for perm in itertools.permutations([("x", a), ("y", b), ("z", c)])]
    j, t = _both(run)
    assert t == j
    assert all(mm == t[0] for mm in t[1:])
    m = t[0]
    assert m["writes"]["rows"][0]["value"] == 23
    assert m["lat"]["rows"][0]["count"] == 6.0 and sum(m["lat"]["rows"][0]["buckets"]) == 6
    assert m["lat"]["rows"][0]["sum"] == pytest.approx(0.2 * 3 + 3.0 + 700.0 + 90000.0)
    assert m["per_table"]["rows"][0]["value"] == 46
    assert "w_gauge" not in m


def test_merge_skips_mismatched_buckets_matches_jax():
    def run(m, t):
        r1, r2 = m.Registry(), m.Registry()
        r1.histogram("h", buckets=(1.0, 2.0)).observe(1.5)
        r2.histogram("h", buckets=(5.0, 6.0)).observe(5.5)
        before = m.REGISTRY.counter("swallowed.telemetry.bucket_mismatch").value
        merged = t.merge_snapshots({"a": r1.snapshot(), "b": r2.snapshot()})
        return merged, m.REGISTRY.counter("swallowed.telemetry.bucket_mismatch").value - before
    j, t = _both(run)
    assert t == j and t[0]["h"]["rows"][0]["count"] == 1.0 and t[1] == 1


# ---- Prometheus exposition -------------------------------------------------

def test_prometheus_exact_format_matches_jax():
    def run(m, t):
        r = m.Registry()
        r.counter("queries_total").add(42)
        r.gauge("queue_depth", fn=lambda: 3)
        h = r.histogram("op_ms", buckets=(1.0, 10.0))
        for v in (0.5, 5.0, 5.0, 100.0):
            h.observe(v)
        r.counter_family("rows_read", ("table",)).labels(table="t1").add(7)
        return t.render_prometheus(r.snapshot(), prefix="baikal_")
    j, t = _both(run)
    assert t == j == (
        "# TYPE baikal_op_ms histogram\n"
        'baikal_op_ms_bucket{le="1"} 1\n'
        'baikal_op_ms_bucket{le="10"} 3\n'
        'baikal_op_ms_bucket{le="+Inf"} 4\n'
        "baikal_op_ms_sum 110.5\n"
        "baikal_op_ms_count 4\n"
        "# TYPE baikal_queries_total counter\n"
        "baikal_queries_total 42\n"
        "# TYPE baikal_queue_depth gauge\n"
        "baikal_queue_depth 3\n"
        "# TYPE baikal_rows_read counter\n"
        'baikal_rows_read{table="t1"} 7\n')


def test_prometheus_fleet_grouping_and_sanitization_match_jax():
    def run(m, t):
        r1, r2 = m.Registry(), m.Registry()
        r1.counter("swallowed.rpc.bad_frame").add(1)
        r2.counter("swallowed.rpc.bad_frame").add(2)
        return t.render_fleet_prometheus({"s1": r1.snapshot(), "s2": r2.snapshot()})
    j, t = _both(run)
    assert t == j
    lines = t.splitlines()
    assert lines[0] == "# TYPE baikal_swallowed_rpc_bad_frame counter"
    assert 'baikal_swallowed_rpc_bad_frame{daemon="s1"} 1' in lines
    assert 'baikal_swallowed_rpc_bad_frame{daemon="s2"} 2' in lines
    assert sum(1 for ln in lines if ln.startswith("# TYPE")) == 1


def test_prometheus_output_parses_and_matches_jax():
    def run(m, t):
        r = m.Registry()
        r.histogram("h").observe(2.0)
        r.latency("l").observe(3.0)
        r.gauge("g", fn=lambda: float("nan"))
        r.counter_family("c", ("a", "b")).labels(a="x", b='q"uo\\te').add(1)
        return t.render_prometheus(r.snapshot())
    j, t = _both(run)
    assert t == j
    sample = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
        r'(\{[a-zA-Z0-9_]+="(?:[^"\\]|\\.)*"'
        r'(,[a-zA-Z0-9_]+="(?:[^"\\]|\\.)*")*\})? '
        r'(NaN|[-+0-9.e]+)$')
    for line in t.splitlines():
        if line and not line.startswith("#"):
            assert sample.match(line), f"unparseable sample line: {line!r}"


def test_latency_recorder_stats_match_jax():
    """The ring's quantiles and fields, which SHOW STATUS renders."""
    def run(m, _t):
        lat = m.LatencyRecorder("lat", registry=m.Registry())
        empty = lat.stats()
        for ms in (1.0, 2.0, 3.0, 100.0, 7.5, 0.25):
            lat.observe(ms)
        return empty, lat.stats()
    j, t = _both(run)
    assert t == j and t[1]["count"] == 6 and t[1]["max_ms"] == 100.0


def test_cluster_rows_without_daemons_match_jax():
    """A frontend with no daemons: cluster_metrics renders its own registry
    and the merged ``fleet`` rows, the same rows in both packages."""
    def run(m, t):
        r = m.Registry()
        r.counter("writes").add(3)
        r.histogram("lat", buckets=(1.0, 10.0)).observe(2.0)
        r.latency("ring").observe(4.0)
        tel = t.Telemetry(registry=r, device_gauges=False)
        rows = [row for row in tel.cluster_rows() if row[3] != "per_second"]
        status = {k: v for k, v in tel.status_rows().items() if "per_second" not in k}
        return tel.has_daemons(), rows, status
    j, t = _both(run)
    assert _nan_eq(t, j)
    assert ("fleet", "writes", "", "value", 3.0, 0, 0.0) in t[1]
