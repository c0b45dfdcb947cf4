"""The port's batched dispatcher (exec/dispatch.py, exec/lanes.py) against
tests/test_batch_dispatch.py's shapes.

Concurrent sessions on threads behind a barrier send parameterized
statements of one shape; a wide tick makes them coalesce.  Every client's
Arrow result equals its serial run on one session bit for bit
(``Table.equals``), and equals the JAX package's rows for the same
statement (the ROADMAP parity contract: exact here, the sums are of exact
binary fractions or compared as float32-rounded kernel sums to rtol 1e-4
where the port's group-by kernels take them).  Beyond the reference's
shapes: the D-a / D-b / D-c statements of ``chip_smoke.py`` phase 12 at a
small size, and a kernel error inside a tick reaching every client instead
of the inline valve.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from baikaldb_tpu.exec.session import Session as JSession
from baikaldb_tpu_torch.chaos import failpoint
from baikaldb_tpu_torch.exec.dispatch import CombineFallback, DispatchOverload
from baikaldb_tpu_torch.exec.session import Database, Session
from baikaldb_tpu_torch.obs.trace import TRACER
from baikaldb_tpu_torch.sql.parser import parse_sql
from baikaldb_tpu_torch.utils import metrics
from baikaldb_tpu_torch.utils.flags import FLAGS, set_flag
from baikaldb_tpu_torch.utils.qos import QosManager, RejectedError


@pytest.fixture
def ticked():
    """A wide tick so a barrier of threads lands in one group."""
    prev = (float(FLAGS.batch_dispatch_tick_ms), bool(FLAGS.batch_dispatch))
    set_flag("batch_dispatch_tick_ms", 60.0)
    set_flag("batch_dispatch", True)
    yield
    set_flag("batch_dispatch_tick_ms", prev[0])
    set_flag("batch_dispatch", prev[1])


BD_DDL = "CREATE TABLE bd (id BIGINT, v DOUBLE, name VARCHAR(16), maybe BIGINT)"


def _bd_rows():
    return "INSERT INTO bd VALUES " + ", ".join(
        f"({i}, {i * 0.25}, 'n{i % 7}', {'NULL' if i % 3 == 0 else i * 11})" for i in range(500))


def _mkdb():
    db = Database("cpu")
    s = Session(db)
    s.execute(BD_DDL)
    s.execute(_bd_rows())
    return db, s


@pytest.fixture(scope="module")
def jbd():
    s = JSession()
    s.execute(BD_DDL)
    s.execute(_bd_rows())
    return s


@contextlib.contextmanager
def _slow_inline(ms: float = 50.0):
    """Hold each inline run ``ms`` longer, so the first arrival is still in
    flight when the others arrive and they queue behind it (a small CPU
    query can finish before the next thread is scheduled)."""
    real = Session._run_plan

    def slow(self, plan, batches):
        time.sleep(ms / 1e3)
        return real(self, plan, batches)
    Session._run_plan = slow
    try:
        yield
    finally:
        Session._run_plan = real


def _concurrent(db, sqls: list[str], threads: int, sessions=None):
    """``sqls`` spread over ``threads`` sessions behind one barrier ->
    {sql: Result.arrow}; re-raises the first worker error."""
    out: dict = {}
    errs: list = []
    start = threading.Barrier(threads)
    chunks = [sqls[t::threads] for t in range(threads)]
    if sessions is None:
        sessions = [Session(db) for _ in range(threads)]

    def worker(s, chunk):
        start.wait()
        for sql in chunk:
            try:
                out[sql] = s.execute(sql).arrow
            except Exception as e:      # noqa: BLE001 — surfaced below
                errs.append((sql, e))

    ts = [threading.Thread(target=worker, args=(sessions[i], c)) for i, c in enumerate(chunks)]
    with _slow_inline():
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    if errs:
        raise errs[0][1]
    return out


def test_scatter_back_bit_identical_to_serial_and_jax(ticked, jbd):
    db, boot = _mkdb()
    sqls = []
    for i in range(24):
        sqls.append(f"SELECT id, v, name, maybe FROM bd WHERE id = {i * 7}")
        sqls.append(f"SELECT id, maybe FROM bd WHERE v = '{i * 0.25}'")
        sqls.append(f"SELECT id, name FROM bd WHERE name = 'n{i % 7}' AND id < 40")
    serial = {sql: boot.execute(sql).arrow for sql in sqls}
    g0 = metrics.batched_groups.value
    got = _concurrent(db, sqls, threads=8)
    assert metrics.batched_groups.value > g0, "nothing batched"
    for sql in sqls:
        assert got[sql].equals(serial[sql]), sql
        assert got[sql].to_pylist() == jbd.query(sql), sql


def test_mixed_table_shapes_group_separately(ticked):
    db = Database("cpu")
    s = Session(db)
    s.execute("CREATE TABLE small (id BIGINT, v BIGINT)")
    s.execute("CREATE TABLE big (id BIGINT, v BIGINT)")
    s.execute("INSERT INTO small VALUES " + ", ".join(f"({i}, {i + 100})" for i in range(50)))
    s.execute("INSERT INTO big VALUES " + ", ".join(f"({i}, {i + 900})" for i in range(3000)))
    sqls = [f"SELECT v FROM small WHERE id = {i}" for i in range(20)] + \
           [f"SELECT v FROM big WHERE id = {i * 17}" for i in range(20)]
    serial = {sql: s.execute(sql).arrow for sql in sqls}
    got = _concurrent(db, sqls, threads=10)
    for sql in sqls:
        assert got[sql].equals(serial[sql]), sql


@pytest.mark.parametrize("members", [2, 3, 4, 5, 8])
def test_padding_edges(ticked, members):
    """Groups across the power-of-two padding edges: the first arrival runs
    inline and the other ``members`` coalesce; the pad lanes repeat lane 0
    and never reach a client."""
    db, boot = _mkdb()
    pool = [Session(db) for _ in range(members + 1)]
    for salt in (0, 200):
        sqls = [f"SELECT v FROM bd WHERE id = {salt + i}" for i in range(members + 1)]
        serial = {sql: boot.execute(sql).arrow for sql in sqls}
        got = _concurrent(db, sqls, threads=members + 1, sessions=pool)
        for sql in sqls:
            assert got[sql].equals(serial[sql]), sql
    assert db.dispatcher.occupancy and max(db.dispatcher.occupancy) >= 2
    assert all(s._plan_cache for s in pool)


def test_single_query_bypasses_queue(ticked):
    db, s = _mkdb()
    g0, i0 = metrics.batched_groups.value, metrics.dispatch_inline.value
    for i in range(5):
        s.query(f"SELECT v FROM bd WHERE id = {i}")
    assert metrics.batched_groups.value == g0
    assert metrics.dispatch_inline.value >= i0 + 5
    assert db.dispatcher.queue_depth() == 0


def test_dispatcher_off_restores_inline(ticked):
    set_flag("batch_dispatch", False)
    db, boot = _mkdb()
    sqls = [f"SELECT v FROM bd WHERE id = {i}" for i in range(16)]
    serial = {sql: boot.execute(sql).arrow for sql in sqls}
    g0 = metrics.batched_groups.value
    got = _concurrent(db, sqls, threads=8)
    assert metrics.batched_groups.value == g0
    for sql in sqls:
        assert got[sql].equals(serial[sql])


@pytest.mark.parametrize("spec,falls_back", [("delay(5)", False), ("drop", True),
                                             ("panic", True), ("return(injected)", True)])
def test_combine_failpoint_falls_back_exactly_once(ticked, spec, falls_back):
    """delay stalls the tick (still exactly once); drop, panic and return
    abandon it: every member re-runs inline, each result delivered once."""
    db, boot = _mkdb()
    sqls = [f"SELECT v, maybe FROM bd WHERE id = {i}" for i in range(24)]
    serial = {sql: boot.execute(sql).arrow for sql in sqls}
    f0 = metrics.dispatch_fallbacks.value
    try:
        failpoint.set_failpoint("dispatch.combine", spec)
        got = _concurrent(db, sqls, threads=8)
    finally:
        failpoint.clear("dispatch.combine")
    assert sorted(got) == sorted(sqls)
    for sql in sqls:
        assert got[sql].equals(serial[sql]), (spec, sql)
    assert (metrics.dispatch_fallbacks.value > f0) == falls_back


def test_kernel_error_in_a_tick_reaches_every_client(ticked, monkeypatch):
    """Only CombineFallback sends members inline: an error inside the lane
    run (a kernel's build, launch or shape check) reaches each client of
    the tick, and nothing re-runs inline."""
    from baikaldb_tpu_torch.exec import lanes

    db, boot = _mkdb()
    sqls = [f"SELECT v FROM bd WHERE id = {i}" for i in range(8)]
    boot.query(sqls[0])

    def broken(self, batches, params, cap):
        raise RuntimeError("segment_reduce_lanes: CUDA kernel launch failed with error 700")
    monkeypatch.setattr(lanes.LaneProgram, "run", broken)
    f0, g0 = metrics.dispatch_fallbacks.value, metrics.batched_groups.value
    errs, done = [], []
    start = threading.Barrier(8)

    def worker(sql):
        s = Session(db)
        start.wait()
        try:
            done.append(s.execute(sql).arrow)
        except RuntimeError as e:
            errs.append(str(e))

    ts = [threading.Thread(target=worker, args=(q,)) for q in sqls]
    with _slow_inline():
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert metrics.dispatch_fallbacks.value == f0
    assert metrics.batched_groups.value > g0
    # every member of the failed tick got the error; only inline runs answered
    assert len(errs) >= 2 and all("CUDA kernel launch failed" in e for e in errs)
    assert len(errs) + len(done) == 8


def test_expr_error_in_a_tick_skips_the_param_valve(ticked, monkeypatch):
    """An ExprError is what the session's param valve replans with baked
    literals; raised inside a tick it still reaches every client of the
    tick, and neither valve counts it."""
    from baikaldb_tpu_torch.exec import lanes
    from baikaldb_tpu_torch.expr.compile import ExprError

    db, boot = _mkdb()
    sqls = [f"SELECT v FROM bd WHERE id = {i}" for i in range(8)]
    boot.query(sqls[0])

    def broken(self, batches, params, cap):
        raise ExprError("lane program: unsupported operand")
    monkeypatch.setattr(lanes.LaneProgram, "run", broken)
    f0, g0 = metrics.dispatch_fallbacks.value, metrics.batched_groups.value
    p0 = metrics.plan_cache_param_fallbacks.value
    errs, done = [], []
    start = threading.Barrier(8)

    def worker(sql):
        s = Session(db)
        start.wait()
        try:
            done.append(s.execute(sql).arrow)
        except ExprError as e:
            errs.append(str(e))

    ts = [threading.Thread(target=worker, args=(q,)) for q in sqls]
    with _slow_inline():
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert metrics.batched_groups.value > g0
    assert metrics.dispatch_fallbacks.value == f0
    assert metrics.plan_cache_param_fallbacks.value == p0
    assert len(errs) >= 2 and all("unsupported operand" in e for e in errs)
    assert len(errs) + len(done) == 8


def test_unexpressible_plan_falls_back_before_any_launch(ticked, monkeypatch):
    """An ORDER BY (a Sort node) is outside the lane lowering: the program
    raises CombineFallback when built, before any lane run."""
    from baikaldb_tpu_torch.exec import lanes

    db, boot = _mkdb()
    ran = []
    real = lanes.LaneProgram.run
    monkeypatch.setattr(lanes.LaneProgram, "run", lambda *a: ran.append(1) or real(*a))
    sqls = [f"SELECT id, v FROM bd WHERE id < {i + 3} ORDER BY v DESC" for i in range(8)]
    serial = {sql: boot.execute(sql).arrow for sql in sqls}
    f0 = metrics.dispatch_fallbacks.value
    got = _concurrent(db, sqls, threads=8)
    for sql in sqls:
        assert got[sql].equals(serial[sql])
    assert not ran
    assert metrics.dispatch_fallbacks.value > f0
    with pytest.raises(CombineFallback):
        lanes.LaneProgram(boot._plan_select(parse_sql(sqls[0])[0]), "cpu")


def test_queue_bound_rejects_typed(ticked):
    db, boot = _mkdb()
    boot.query("SELECT v FROM bd WHERE id = 0")
    prev = int(FLAGS.batch_dispatch_queue_max)
    set_flag("batch_dispatch_queue_max", 1)
    rejected, fine = [], []
    start = threading.Barrier(10)

    def worker(tid):
        s = Session(db)
        start.wait()
        try:
            s.query(f"SELECT v FROM bd WHERE id = {tid}")
            fine.append(tid)
        except DispatchOverload as e:
            assert isinstance(e, RejectedError)
            rejected.append(tid)

    try:
        failpoint.set_failpoint("dispatch.combine", "delay(60)")
        ts = [threading.Thread(target=worker, args=(t,)) for t in range(10)]
        with _slow_inline():
            for t in ts:
                t.start()
            for t in ts:
                t.join()
    finally:
        failpoint.clear("dispatch.combine")
        set_flag("batch_dispatch_queue_max", prev)
    assert rejected, "the queue bound never tripped"
    assert fine, "every query rejected"
    assert db.dispatcher.queue_depth() == 0


def test_qos_user_and_table_buckets():
    class FakeClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

    clock = FakeClock()
    q = QosManager(sign_rate=1000, sign_burst=1000, global_rate=1000, global_burst=1000,
                   user_rate=1, user_burst=2, table_rate=1, table_burst=2, clock=clock)
    q.admit("SELECT 1 FROM a", user="alice", tables=("d.a",))
    q.admit("SELECT 2 FROM b", user="alice", tables=("d.b",))
    with pytest.raises(RejectedError, match="per-user"):
        q.admit("SELECT 3 FROM c", user="alice", tables=("d.c",))
    q.admit("SELECT 4 FROM d", user="bob", tables=("d.d",))
    q.admit("SELECT 5 FROM a", user="bob", tables=("d.a",))
    with pytest.raises(RejectedError, match="per-table"):
        q.admit("SELECT 6 FROM a", user="carol", tables=("d.a",))
    assert {"qos_global", "qos_sign", "qos_user", "qos_table"} <= {r[0] for r in q.state()}
    rej0 = q.rejected
    clock.t += 5.0
    q.admit("SELECT 7 FROM a", user="alice", tables=("d.a",))
    assert q.rejected == rej0


def test_session_admission_gate_sheds_by_table():
    db, s = _mkdb()
    db.qos = QosManager(table_rate=0.001, table_burst=2)
    r0 = metrics.qos_rejections.value
    s.query("SELECT v FROM bd WHERE id = 1")
    s.query("SELECT v FROM bd WHERE id = 2")
    with pytest.raises(RejectedError, match="per-table rate exceeded .*default.bd"):
        s.query("SELECT v FROM bd WHERE id = 3")
    s.execute("COMMIT")                           # exempt
    assert metrics.qos_rejections.value == r0 + 1


def test_information_schema_dispatcher(ticked):
    db, boot = _mkdb()
    db.qos = QosManager()
    db.qos.admit("SELECT 1", user="root", tables=("default.bd",))
    _concurrent(db, [f"SELECT v FROM bd WHERE id = {i}" for i in range(12)], threads=6)
    rows = boot.query("SELECT kind, name, value FROM information_schema.dispatcher")
    kinds = {r["kind"] for r in rows}
    assert {"queue", "tick", "queue_wait", "occupancy", "counter", "executables"} <= kinds
    assert {"qos_global", "qos_user", "qos_table"} <= kinds
    by = {(r["kind"], r["name"]): r["value"] for r in rows}
    assert by[("queue", "depth")] == 0.0
    occ = {r["name"]: r["value"] for r in rows if r["kind"] == "occupancy"}
    assert occ and sum(occ.values()) >= 1


def test_explain_analyze_dispatch_line(ticked):
    db, s = _mkdb()
    txt = s.execute("EXPLAIN ANALYZE SELECT v FROM bd WHERE id = 5").plan_text
    line = [ln for ln in txt.splitlines() if ln.startswith("-- dispatch:")]
    assert line and "enabled=1" in line[0]
    set_flag("batch_dispatch", False)
    txt = s.execute("EXPLAIN ANALYZE SELECT v FROM bd WHERE id = 6").plan_text
    line = [ln for ln in txt.splitlines() if ln.startswith("-- dispatch:")]
    assert line and "enabled=0" in line[0]


def test_trace_spans_for_batch_seams(ticked):
    db, boot = _mkdb()
    sqls = [f"SELECT v FROM bd WHERE id = {i}" for i in range(12)]
    _concurrent(db, sqls, threads=6)
    TRACER.clear()
    prev = bool(FLAGS.tracing)
    try:
        set_flag("tracing", True)
        _concurrent(db, sqls, threads=6)
    finally:
        set_flag("tracing", prev)
    spans = [sp for rec in TRACER.list() for sp in rec["spans"]]
    names = {sp["name"] for sp in spans}
    assert {"batch.enqueue", "batch.combine", "batch.scatter"} <= names
    waits = [sp["attrs"]["queue_wait_ms"] for sp in spans if sp["name"] == "batch.enqueue"]
    assert waits and all(w >= 0 for w in waits)
    assert all("group" in sp["attrs"] and "padded" in sp["attrs"]
               for sp in spans if sp["name"] == "batch.combine")
    TRACER.clear()
    _concurrent(db, sqls, threads=6)
    assert not TRACER.list()


def test_strcmp_dictionary_params_group_correctly(ticked):
    db = Database("cpu")
    s = Session(db)
    s.execute("CREATE TABLE sd (k VARCHAR(8), n BIGINT)")
    s.execute("INSERT INTO sd VALUES " + ", ".join(f"('k{i}', {i * 5})" for i in range(64)))
    sqls = [f"SELECT n FROM sd WHERE k = 'k{i}'" for i in range(32)]
    serial = {sql: s.execute(sql).arrow for sql in sqls}
    g0 = metrics.batched_groups.value
    got = _concurrent(db, sqls, threads=8)
    assert metrics.batched_groups.value > g0
    for sql in sqls:
        assert got[sql].equals(serial[sql]), sql


# -- chip_smoke.py phase 12's shapes at a small size ---------------------------

D_SHAPES = {
    "D-a": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > {x} GROUP BY g16",
    "D-b": ("SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > {x} AND g >= {lo} "
            "AND g < {hi} GROUP BY g"),
    "D-c": "SELECT g, SUM(w), AVG(w) FROM t WHERE w > {x} AND g >= {lo} AND g < {hi} GROUP BY g",
}


def _t_table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({"g": pa.array(rng.integers(0, 2048, n, dtype=np.int32)),
                     "v": pa.array(rng.standard_normal(n, dtype=np.float32)),
                     "w": pa.array(rng.standard_normal(n)),
                     "g16": pa.array(rng.integers(0, 16, n, dtype=np.int32))})


@pytest.fixture(scope="module")
def d_tables():
    data = _t_table(40_000, 11)
    out = []
    for s in (JSession(), Session(device="cpu")):
        s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
        s.load_arrow("t", data)
        out.append(s)
    return out


def _d_sqls(name, clients=8, per=2):
    rng = np.random.default_rng(len(name))
    out = []
    for c in range(clients):
        for k in range(per):
            lo = int(rng.integers(0, 1900))
            width = 200 if (name == "D-b" and c == 0 and k == 0) else int(rng.integers(20, 100))
            out.append(D_SHAPES[name].format(x=round(float(rng.normal()) * 0.5, 3), lo=lo,
                                             hi=lo + width))
    return out


def _close(got, want, rtol):
    key = list(want[0]) if want else []
    got = sorted(got, key=lambda r: r[key[0]])
    want = sorted(want, key=lambda r: r[key[0]])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in b:
            if isinstance(b[k], float):
                assert math.isclose(a[k], b[k], rel_tol=rtol, abs_tol=1e-6), (k, a[k], b[k])
            else:
                assert a[k] == b[k], (k, a[k], b[k])


@pytest.mark.parametrize("name", list(D_SHAPES))
def test_phase12_shapes_batch_and_match_serial_and_jax(ticked, d_tables, name):
    """D-a (17 slots: the segment route), D-b (2049 slots: K3 + K2) and D-c
    (K3 + K1) from 8 clients: ticks form, every client's rows equal its
    serial run bit for bit and the JAX rows (rtol 1e-4 where the port's
    group-by kernels give float32 sums, 1e-9 on the segment route); the D-b
    client over 200 groups overflows the scatter budget and re-runs
    inline."""
    js, ts = d_tables
    sqls = _d_sqls(name)
    serial = {q: ts.execute(q).arrow for q in sqls}
    db = ts.db
    g0, f0 = metrics.batched_groups.value, metrics.dispatch_fallbacks.value
    got = _concurrent(db, sqls, threads=8)
    assert metrics.batched_groups.value > g0
    overflow = sum(1 for q in sqls if serial[q].num_rows > int(FLAGS.batch_dispatch_scatter_rows))
    assert metrics.dispatch_fallbacks.value - f0 <= overflow
    for q in sqls:
        assert got[q].equals(serial[q]), q
        _close(got[q].to_pylist(), js.query(q), 1e-9 if name == "D-a" else 1e-4)


def test_params_line_shows_the_phase12_literals_hoisted(d_tables):
    js, ts = d_tables
    for name, hoisted in (("D-a", 3), ("D-b", 5), ("D-c", 3)):
        q = D_SHAPES[name].format(x=0.25, lo=10, hi=60)
        txt = ts.execute("EXPLAIN ANALYZE " + q).plan_text
        line = next(ln for ln in txt.splitlines() if ln.startswith("-- params:"))
        jline = next(r["plan"] for r in js.query("EXPLAIN ANALYZE " + q)
                     if r["plan"].startswith("-- params:"))
        assert line.split(" param_hits_total")[0] == jline.split(" param_hits_total")[0]
        assert f"hoisted={hoisted} pinned=0" in line, line


def test_lane_uniform_params_bind_as_one_value():
    """The 2 and the 1 of ``v*2+1 > ?`` are hoisted in every client's
    statement with the same values: they bind as one value, so the
    arithmetic runs once over ``[n]`` and only the comparison is per lane."""
    from baikaldb_tpu_torch.exec.lanes import _lane_slot

    same = np.array([[2], [2], [2]], dtype=np.int64)
    varying = np.array([[0.5], [0.25], [0.5]])
    bounds = np.array([[3, 4], [3, 4]], dtype=np.int32)
    assert _lane_slot(same).shape == () and int(_lane_slot(same)) == 2
    assert _lane_slot(varying) is varying
    assert _lane_slot(bounds).tolist() == [3, 4]
    assert _lane_slot(np.array([[3, 4], [3, 5]], dtype=np.int32)).shape == (2, 2)
