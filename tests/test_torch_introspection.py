"""The port's live-query introspection against the JAX package's: the
progress registry (obs/progress.py), KILL, SHOW [FULL] PROCESSLIST,
``information_schema.processlist`` / ``flight_recorder``, the query log's
phase columns, SHOW STATUS's health rows, the flight recorder
(obs/flightrec.py), the watchdog (obs/watchdog.py) and the process gauges.

Each case runs the same statements, or the same calls, through a JAX
``Session`` (CPU, x64) and a port ``Session(device="cpu")``, each package
with its own registry, and holds the outcomes equal: rows, states, names,
statuses and counter deltas exactly; durations for sign and order only.
Connection and query ids come from each package's own counters and are
compared where they are the ones the case chose.  The cases mirror the
embedded ones of tests/test_introspection.py (its meta RPC, wire and
cluster cases wait for the server and the replicated tier, its offline
viewer for ``tools/flightrec.py``).  Beyond them: a KILL lands at the next
beat at each seam the JAX package beats at (a phase, a staged scan, a
streamed chunk, a mesh round, the dispatcher's queued wait), and the next
query gives the JAX rows.  Every wait on a thread has a timeout.
"""

import json
import math
import os
import threading

import numpy as np
import pyarrow as pa
import pytest

import baikaldb_tpu.exec.dispatch as jdispatch
import baikaldb_tpu.exec.session as jsession
import baikaldb_tpu.obs.progress as jprogress
import baikaldb_tpu.plan.distribute as jdist
import baikaldb_tpu.utils.metrics as jmetrics
import baikaldb_tpu.utils.flags as jflags
import baikaldb_tpu_torch.exec.dispatch as tdispatch
import baikaldb_tpu_torch.exec.session as tsession
import baikaldb_tpu_torch.obs.progress as tprogress
import baikaldb_tpu_torch.plan.distribute as tdist
import baikaldb_tpu_torch.utils.metrics as tmetrics
import baikaldb_tpu_torch.utils.flags as tflags

JOIN_TIMEOUT = 60.0


class Pkg:
    """One package's session, progress, metrics and flag modules."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.S, self.progress, self.metrics, self.flags = \
                jsession, jprogress, jmetrics, jflags
            self.dispatch, self.dist = jdispatch, jdist
        else:
            self.S, self.progress, self.metrics, self.flags = \
                tsession, tprogress, tmetrics, tflags
            self.dispatch, self.dist = tdispatch, tdist
        self.FLAGS = self.flags.FLAGS
        self.PROGRESS = self.progress.PROGRESS

    def database(self):
        return self.S.Database() if self.name == "jax" else self.S.Database("cpu")

    def session(self, db=None, **kw):
        return self.S.Session(db if db is not None else self.database(), **kw)


PKGS = [Pkg("jax"), Pkg("port")]


def _both(fn):
    """``fn(pkg)`` for the JAX package, then the port -> (jax, port)."""
    return tuple(fn(p) for p in PKGS)


def _sess(p):
    s = p.session()
    s.execute("CREATE TABLE t (id BIGINT, v DOUBLE)")
    s.execute("INSERT INTO t VALUES (1, 1.5), (2, 2.5), (3, NULL)")
    return s


@pytest.fixture()
def flags():
    """Set flags in both registries; restored after the test."""
    saved = []

    def set_both(name, value):
        for p in PKGS:
            saved.append((p.FLAGS, name, p.FLAGS.get(name)))
            p.FLAGS.set_flag(name, value)
    yield set_both
    for reg, name, value in reversed(saved):
        reg.set_flag(name, value)


_VOLATILE = ("query_id", "elapsed_ms", "time_s", "Time")


def _stable(row: dict) -> dict:
    return {k: v for k, v in row.items() if k not in _VOLATILE}


# ---- the progress registry and the cancel token ---------------------------

def test_track_registers_live_row_as_jax():
    def run(p):
        s = _sess(p)
        with p.progress.track("SELECT 1", conn_id=42, user="alice", db=s.db,
                              dbname="default") as qp:
            qp.beat(phase="exec.batches", operator="scan default.t", batches_done=2,
                    batches_total=8, rows_done=100, rows_est=400)
            live = [q.query_id for q in p.PROGRESS.live(s.db)] == [qp.query_id]
            out = (live, _stable(qp.row()), qp.state())
        return out + (p.PROGRESS.live(s.db),)
    j, t = _both(run)
    assert t == j
    assert t[0] and t[1]["id"] == 42 and t[1]["user"] == "alice"
    assert t[2] == "exec.batches scan default.t batch 2/8 rows 100/400" and t[3] == []


def test_state_shows_exchange_rounds_as_jax():
    def run(p):
        s = _sess(p)
        with p.progress.track("SELECT 1", db=s.db) as qp:
            qp.beat(phase="exec.run", round_no=2, rounds_total=4)
            return qp.state()
    assert _both(run) == ("exec.run round 2/4",) * 2


def test_flag_off_is_noop_as_jax(flags):
    flags("progress_tracking", False)

    def run(p):
        s = _sess(p)
        with p.progress.track("SELECT 1", db=s.db) as qp:
            qp.beat(phase="exec.run", rows_done=5)
            out = (qp.query_id, p.PROGRESS.live(s.db), p.progress.current() is qp)
        # KILL cannot find a query that has no record
        err = None
        try:
            s.execute("KILL QUERY 999998")
        except Exception as e:       # noqa: BLE001 — compared across packages
            err = type(e).__name__
        return out + (err, s.query("SELECT COUNT(*) AS n FROM t"))
    j, t = _both(run)
    assert t == j and t[:3] == (0, [], True) and t[3] == "SqlError"


def test_kill_raises_at_next_beat_as_jax():
    def run(p):
        s = _sess(p)
        before = p.metrics.queries_killed.value
        out = []
        with p.progress.track("SELECT 1", conn_id=7, db=s.db) as qp:
            out.append(p.PROGRESS.kill(conn_id=7, db=s.db))
            out.append(p.metrics.queries_killed.value - before)
            out.append(qp.token.killed())
            try:
                qp.beat()
            except p.progress.QueryKilled as e:
                out.append(str(e))
        with p.progress.track("SELECT 1", db=s.db) as qp:
            out.append(p.PROGRESS.kill(query_id=qp.query_id, db=p.database()))
            out.append(p.PROGRESS.kill(query_id=qp.query_id, db=s.db))
        return out
    j, t = _both(run)
    assert t == j == [1, 1, True, "Query execution was interrupted", 0, 1]


def test_cancel_token_standalone_as_jax():
    def run(p):
        tok = p.progress.CancelToken()
        tok.check()
        tok.kill("test")
        try:
            tok.check()
            raised = False
        except p.progress.QueryKilled:
            raised = True
        return raised, tok.reason, isinstance(p.progress.QueryKilled("x"), RuntimeError)
    assert _both(run) == ((True, "test", True),) * 2


@pytest.mark.parametrize("sql", ["KILL 999999", "KILL QUERY 999999",
                                 "KILL CONNECTION 999999"])
def test_kill_unknown_id_as_jax(sql):
    def run(p):
        s = _sess(p)
        try:
            s.execute(sql)
        except Exception as e:      # noqa: BLE001 — compared across packages
            return type(e).__name__, str(e)
    assert _both(run) == (("SqlError", "Unknown thread id: 999999"),) * 2


def test_kill_of_the_own_connection_is_known_as_jax():
    """A KILL of the session's own id finds no live statement to flip but
    is no error (the JAX rule: the id is a known connection)."""
    def run(p):
        s = _sess(p)
        r = s.execute(f"KILL QUERY {s.connection_id()}")
        return r.affected_rows, s.query("SELECT COUNT(*) AS n FROM t")
    j, t = _both(run)
    assert t == j and t[1] == [{"n": 3}]


# ---- SQL surfaces ----------------------------------------------------------

# a connection id no session of the test process reaches: each package's
# ids count every Session the process made, and a record under a session's
# own id would render as that session's row
FOREIGN_ID = 1_000_077


def test_show_processlist_merges_live_queries_as_jax():
    long_sql = "SELECT waits FROM elsewhere WHERE pad = '" + "x" * 100 + "'"

    def run(p):
        s = _sess(p)
        own = s.connection_id()

        def rows(sql):
            return [{**_stable(r), "Id": "own" if r["Id"] == own else r["Id"]}
                    for r in s.query(sql)]
        with p.progress.track(long_sql, conn_id=FOREIGN_ID, user="bob", db=s.db,
                              dbname="default"):
            during = rows("SHOW PROCESSLIST"), rows("SHOW FULL PROCESSLIST")
        return during, [r for r in rows("SHOW PROCESSLIST") if r["Id"] == FOREIGN_ID]
    j, t = _both(run)
    assert t == j
    (short, full), after = t
    mine = [r for r in short if r["Id"] == FOREIGN_ID][0]
    assert mine["User"] == "bob" and mine["Command"] == "Query" and mine["db"] == "default"
    # the SHOW inside the open record shares it (a nested open degrades to
    # the outer record, as a wire query does): one row, in the SHOW's phase
    assert mine["State"] == "parse" and len(mine["Info"]) == 100
    assert [r for r in full if r["Id"] == FOREIGN_ID][0]["Info"] == long_sql
    assert [r["Id"] for r in short] == [FOREIGN_ID] and after == []


def test_information_schema_processlist_as_jax():
    def run(p):
        s = _sess(p)
        own = s.connection_id()
        with p.progress.track("SELECT 1", conn_id=FOREIGN_ID + 11, user="carol",
                              db=s.db, dbname="default") as qp:
            qp.beat(phase="exec.run", operator="scan default.t", rows_done=3)
            rows = s.query("SELECT * FROM information_schema.processlist")
            ids = [(r["id"], r["query_id"] == qp.query_id) for r in rows]
        return ([_stable(r) for r in rows if r["id"] == FOREIGN_ID + 11],
                [("own" if i == own else i, mine) for i, mine in ids],
                all(r["elapsed_ms"] >= 0.0 for r in rows))
    j, t = _both(run)
    assert t == j
    # the SELECT inside the open record shares it: one row
    assert t[1] == [(FOREIGN_ID + 11, True)] and t[2]
    assert t[0][0]["state"] == "exec.batches scan default.t batch 0/1"
    assert t[0][0]["user"] == "carol"


def test_information_schema_processlist_filters_and_orders_as_jax():
    """WHERE and ORDER BY over the live table: only this database's
    records, the reading statement's own row among them."""
    def run(p):
        s = _sess(p)
        other = _sess(p)
        # live records of other threads' statements, one on each database
        recs = [p.progress.QueryProgress("SELECT elsewhere", conn_id=100005, db=other.db),
                p.progress.QueryProgress("SELECT here", conn_id=100006, user="u", db=s.db)]
        for qp in recs:
            p.PROGRESS.register(qp)
        try:
            return (s.query("SELECT id, user, info, phase FROM information_schema.processlist "
                            "WHERE id >= 100000 ORDER BY id"),
                    [r["Id"] for r in s.query("SHOW PROCESSLIST")
                     if r["Id"] != s.connection_id()])
        finally:
            for qp in recs:
                p.PROGRESS.unregister(qp)
    j, t = _both(run)
    assert t == j == ([{"id": 100006, "user": "u", "info": "SELECT here",
                        "phase": "starting"}], [100006])


def test_query_log_phase_columns_as_jax():
    def run(p):
        s = _sess(p)
        s.query("SELECT COUNT(*) FROM t")
        log = s.query("SELECT query, parse_ms, plan_ms, exec_ms, egress_ms "
                      "FROM information_schema.query_log")
        mine = [r for r in log if "COUNT(*)" in r["query"]][-1]
        return sorted(mine), [mine[c] >= 0.0 for c in ("parse_ms", "plan_ms", "egress_ms")], \
            mine["exec_ms"] > 0.0
    j, t = _both(run)
    assert t == j and t[1] == [True] * 3 and t[2]


def test_show_status_health_rows_as_jax():
    def run(p):
        return _sess(p).query("SHOW STATUS LIKE 'health.%'")
    j, t = _both(run)
    assert t == j == [{"Variable_name": "health.stalls_detected", "Value": "0"},
                      {"Variable_name": "health.stalls_live", "Value": "0"},
                      {"Variable_name": "health.status", "Value": "ok"},
                      {"Variable_name": "health.watchdog", "Value": "frontend"}]


# ---- the flight recorder ---------------------------------------------------

def _last_record(s, needle):
    rows = s.query("SELECT * FROM information_schema.flight_recorder")
    return [r for r in rows if needle in r["query"]][-1]


def test_slow_query_gets_forensic_bundle_as_jax(flags):
    flags("slow_query_ms", 0.0)

    def run(p):
        s = _sess(p)
        s.query("SELECT v FROM t WHERE id = 2")
        mine = _last_record(s, "WHERE id = 2")
        rec = s.db.flightrec.get(mine["rec_id"])
        b = rec["bundle"]
        return ({k: mine[k] for k in ("status", "has_bundle", "rows", "user", "db", "error")},
                sorted(mine), mine["duration_ms"] > 0.0, sorted(b), b["plan"],
                sorted(json.loads(mine["phase_ms"])), b["exchange"],
                [sorted(d) for d in b["device_stats"]][:1])
    j, t = _both(run)
    assert t == j
    assert t[0]["status"] == "ok" and t[0]["has_bundle"] and t[0]["rows"] == 1
    assert t[3] == ["device_stats", "exchange", "metric_delta", "plan", "spans"]
    assert "Scan" in t[4]


def test_fast_clean_query_summary_only_as_jax(flags):
    flags("slow_query_ms", 1e9)

    def run(p):
        s = _sess(p)
        s.query("SELECT COUNT(*) FROM t")
        mine = _last_record(s, "COUNT(*)")
        return mine["has_bundle"], s.db.flightrec.get(mine["rec_id"])["bundle"], mine["status"]
    assert _both(run) == ((False, None, "ok"),) * 2


def test_failed_query_recorded_with_error_as_jax():
    def run(p):
        s = _sess(p)
        try:
            s.query("SELECT nope_no_such_column FROM t")
        except Exception as e:      # noqa: BLE001 — compared across packages
            kind = type(e).__name__
        mine = _last_record(s, "nope_no_such_column")
        return kind, mine["status"], mine["error"].split(":")[0], mine["has_bundle"]
    j, t = _both(run)
    assert t == j and t[1] == "error" and t[3]


def test_ring_is_bounded_as_jax(flags):
    flags("flightrec_max", 4)

    def run(p):
        s = _sess(p)
        for i in range(10):
            s.db.flightrec.record({"text": f"q{i}", "status": "ok"})
        rows = s.db.flightrec.rows()
        s.db.flightrec.clear()
        return len(rows), [r["text"] for r in rows], [r["rec_id"] for r in rows][-1] \
            - [r["rec_id"] for r in rows][0]
    j, t = _both(run)
    assert t == j and t[0] == 4 and t[1][-1] == "q9"


def test_dump_and_clear_as_jax(flags, tmp_path):
    def run(p):
        s = _sess(p)
        flags("slow_query_ms", 0.0)
        s.query("SELECT SUM(v) FROM t")
        flags("slow_query_ms", 1000.0)
        path = str(tmp_path / f"{p.name}.jsonl")
        n = s.execute(f"HANDLE flightrec dump '{path}'").affected_rows
        recs = [json.loads(line) for line in open(path)]
        one = s.execute(f"HANDLE flightrec dump '{path}' {recs[-1]['rec_id']}").affected_rows
        s.execute("HANDLE flightrec clear")
        left = [r["text"] for r in s.db.flightrec.rows()]
        return (n, [r["text"] for r in recs], [r["status"] for r in recs],
                [sorted(r["bundle"]) if r["bundle"] else None for r in recs], one, left,
                os.path.getsize(path) > 0)
    j, t = _both(run)
    assert t == j
    assert t[0] == len(t[1]) and "SELECT SUM(v) FROM t" in t[1] and t[4] == 1
    # the ring holds the clear statement's own record at most
    assert all("SUM(v)" not in x for x in t[5])


# ---- the watchdog ----------------------------------------------------------

def test_watchdog_stall_episode_dedup_as_jax():
    def run(p):
        s = _sess(p)
        wd = s.db.watchdog
        base = wd.health()["stalls_detected"]
        out = []
        with p.progress.track("SELECT wedge", db=s.db) as qp:
            qp.beat_mono -= 2 * float(p.FLAGS.watchdog_stall_s) + 1
            wd.scan_now()
            h = wd.health()
            out += [h["status"], h["stalls_detected"] - base, qp.stalled, qp.state()]
            wd.scan_now()
            out.append(wd.health()["stalls_detected"] - base)
            qp.beat()
            wd.scan_now()
            out += [wd.health()["status"], qp.stalled]
            qp.beat_mono -= 2 * float(p.FLAGS.watchdog_stall_s) + 1
            wd.scan_now()
            out.append(wd.health()["stalls_detected"] - base)
            out.append(s.query("SHOW STATUS LIKE 'health.stall%'"))
        return out
    j, t = _both(run)
    assert t == j
    assert t[:8] == ["stalled", 1, True, "starting STALLED", 1, "ok", False, 2]


def test_watchdog_counter_in_registry_as_jax():
    def run(p):
        s = _sess(p)
        before = p.metrics.watchdog_stalls_detected.value
        with p.progress.track("SELECT wedge", db=s.db) as qp:
            qp.beat_mono -= 2 * float(p.FLAGS.watchdog_stall_s) + 1
            s.db.watchdog.scan_now()
        return p.metrics.watchdog_stalls_detected.value - before
    assert _both(run) == (1, 1)


def test_watchdog_thread_starts_and_stops():
    """The background scan (cluster mode's) runs and stops on close; the
    embedded Database starts none."""
    db = tsession.Database("cpu")
    assert db.watchdog._thread is None
    db.watchdog.start(interval_s=0.05)
    assert db.watchdog._thread.is_alive()
    db.close()
    assert db.watchdog._thread is None


def test_process_gauges_installed_as_jax():
    def run(p):
        p.database()
        snap = p.metrics.REGISTRY.snapshot()
        names = ("process_rss_bytes", "process_threads", "process_open_fds",
                 "process_uptime_s", "process_gc_collections", "device_hbm_in_use_bytes",
                 "device_hbm_peak_bytes", "device_hbm_limit_bytes")
        return ([(n, snap[n]["kind"]) for n in names],
                snap["process_rss_bytes"]["rows"][0]["value"] > 1e6)
    j, t = _both(run)
    assert t == j and t[1]


def test_device_gauges_and_stats_on_the_cpu_as_jax():
    """Without a card the device gauges are NaN and device_stats gives one
    row a device with no memory keys, as the JAX package's CPU backend."""
    from baikaldb_tpu.obs.flightrec import device_stats as jds
    from baikaldb_tpu_torch.obs.flightrec import device_stats as tds

    tmetrics.REGISTRY.get("device_hbm_in_use_bytes") or tsession.Database("cpu")
    for name in ("device_hbm_in_use_bytes", "device_hbm_peak_bytes", "device_hbm_limit_bytes"):
        assert math.isnan(tmetrics.REGISTRY.get(name).stats()["value"])
        assert math.isnan(jmetrics.REGISTRY.get(name).stats()["value"])
    j, t = jds(), tds()
    assert [sorted(r) for r in t] == [["device"]]
    assert all(sorted(r) == ["device"] for r in j)


# ---- KILL at each seam the JAX package beats at ---------------------------

def _fact(n=1000):
    rng = np.random.default_rng(5)
    return pa.table({"id": pa.array(np.arange(n, dtype=np.int64)),
                     "g": pa.array(rng.integers(0, 9, n).astype(np.int32)),
                     "v": pa.array(rng.normal(size=n))})


def _kill_when(p, s, cond):
    """Patch ``p``'s QueryProgress.beat so that the first beat of ``s``'s
    database for which ``cond(qp)`` holds issues ``KILL QUERY <conn>`` from
    another session on its own thread (joined, with a timeout); -> (restore,
    snapshots of the killer's processlist reads)."""
    QP = p.progress.QueryProgress
    real = QP.beat
    fired = []
    seen = []
    killer = p.session(s.db)

    def beat(self, phase=None, operator=None, **counts):
        real(self, phase, operator, **counts)
        if not fired and self.db is s.db and cond(self):
            fired.append(True)

            def kill():
                seen.append(killer.query(
                    "SELECT id, operator, chunk_no, chunks_total, phase FROM "
                    f"information_schema.processlist WHERE id = {self.conn_id}"))
                killer.execute(f"KILL QUERY {self.conn_id}")
            th = threading.Thread(target=kill)
            th.start()
            th.join(JOIN_TIMEOUT)
            assert not th.is_alive()
    QP.beat = beat

    def restore():
        QP.beat = real
    return restore, seen, fired


SITES = {
    # the phase seam after planning
    "phase": ("SELECT g, COUNT(*) AS n, SUM(v) AS s FROM f GROUP BY g ORDER BY g",
              lambda qp: qp.phase == "plan"),
    # a staged scan (between table loads)
    "scan": ("SELECT a.g, COUNT(*) AS n FROM f a JOIN f b ON a.id = b.id GROUP BY a.g "
             "ORDER BY a.g", lambda qp: qp.operator.startswith("scan")),
    # a streamed chunk: the KILL lands before chunk 4's copy is issued
    "chunk": ("SELECT g, COUNT(*) AS n, SUM(v) AS s FROM f WHERE v > -1 GROUP BY g",
              lambda qp: qp.chunk_no == 3 and qp.chunks_total > 0),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_kill_lands_at_the_next_beat_as_jax(flags, site):
    sql, cond = SITES[site]
    if site == "chunk":
        flags("streaming_min_rows", 1)
        flags("streaming_chunk_rows", 64)
    data = _fact()

    def run(p):
        s = p.session()
        s.execute("CREATE TABLE f (id BIGINT, g INT, v DOUBLE)")
        s.load_arrow("f", data)
        killed0 = p.metrics.queries_killed.value
        chunks0 = p.metrics.stream_chunks.value
        restore, seen, fired = _kill_when(p, s, cond)
        try:
            s.execute(sql)
            outcome = "ran"
        except p.progress.QueryKilled as e:
            outcome = str(e)
        finally:
            restore()
        rec = s.db.flightrec.rows()[-1]
        after = (p.metrics.queries_killed.value - killed0,
                 p.metrics.stream_chunks.value - chunks0,
                 rec["status"], rec["bundle"] is not None, p.PROGRESS.live(s.db),
                 [t.name for t in threading.enumerate() if t.name == "stream-prefetch"])
        seen = [[{k: v for k, v in r.items() if k != "id"} for r in rows] for rows in seen]
        return outcome, fired, seen, after, s.query(sql + (" ORDER BY g" if site == "chunk"
                                                           else ""))
    j, t = _both(run)
    assert t[:4] == j[:4]
    assert t[0] == "Query execution was interrupted" and t[1] == [True]
    assert t[3][0] == 1 and t[3][2] == "killed" and t[3][3] and t[3][4] == [] and t[3][5] == []
    if site == "chunk":
        assert t[2] == [[{"operator": "StreamScan(default.f)", "chunk_no": 3,
                          "chunks_total": 16, "phase": "exec.run"}]]
        # the KILL at chunk 3's beat lands at chunk 4's: chunks 0-3 folded
        assert t[3][1] == 4
    got, want = t[4], j[4]
    assert [r["g"] for r in got] == [r["g"] for r in want]
    for a, b in zip(got, want):
        assert a["n"] == b["n"]
        if "s" in b:
            assert math.isclose(a["s"], b["s"], rel_tol=1e-9)


def test_kill_lands_at_a_mesh_round_as_jax(flags, monkeypatch):
    """A shuffle join on 8 shards: KILL after the rounds are known lands at
    the seam before the device work, in both packages."""
    from baikaldb_tpu.parallel.mesh import make_mesh as jmake_mesh
    from baikaldb_tpu_torch.parallel.mesh import make_mesh as tmake_mesh

    monkeypatch.setattr(jdist, "BROADCAST_ROWS", 0)
    monkeypatch.setattr(tdist, "BROADCAST_ROWS", 0)
    flags("slow_query_ms", 0.0)
    data = _fact(400)
    meshes = {"jax": jmake_mesh(8), "port": tmake_mesh(8, device="cpu")}
    sql = "SELECT a.g, COUNT(*) AS n FROM f a JOIN f b ON a.g = b.id GROUP BY a.g ORDER BY a.g"

    def run(p):
        s = p.session(mesh=meshes[p.name])
        s.execute("CREATE TABLE f (id BIGINT, g INT, v DOUBLE)")
        s.load_arrow("f", data)
        rows = s.query(sql)
        rec = s.db.flightrec.rows()[-1]
        done = (rec["rounds"], rec["bundle"]["exchange"])
        restore, _seen, fired = _kill_when(p, s, lambda qp: qp.rounds_total > 0)
        try:
            s.execute(sql)
            outcome = "ran"
        except p.progress.QueryKilled as e:
            outcome = str(e)
        finally:
            restore()
        rec = s.db.flightrec.rows()[-1]
        return rows, done, outcome, fired, rec["status"], rec["bundle"]["exchange"], \
            s.query(sql) == rows
    j, t = _both(run)
    assert t == j
    assert t[1][0] == t[1][1]["rounds"] == 1
    assert t[2] == "Query execution was interrupted" and t[4] == "killed" and t[6]


def test_kill_lands_in_the_dispatchers_queued_wait_as_jax(flags):
    """A member waiting for its tick beats each slice with its queue wait;
    a KILL from another session makes the wait raise at the next slice
    (the tick carries the member's lane unread)."""
    flags("batch_dispatch_wait_s", 30.0)

    def run(p):
        s = _sess(p)
        w = p.dispatch._Waiter(None)
        out = {}

        def member():
            with p.progress.track("SELECT queued", conn_id=4242, db=s.db) as qp:
                try:
                    s.db.dispatcher._wait(w, lambda: None)
                    out["outcome"] = "returned"
                except p.progress.QueryKilled as e:
                    out["outcome"] = str(e)
                out["phase"], out["waited"] = qp.phase, qp.queue_wait_ms > 0.0
        th = threading.Thread(target=member)
        th.start()
        for _ in range(2000):
            rows = s.query("SELECT phase FROM information_schema.processlist WHERE id = 4242")
            if rows and rows[0]["phase"] == "exec.queued":
                break
            threading.Event().wait(0.005)
        out["seen"] = rows
        s.execute("KILL QUERY 4242")
        th.join(JOIN_TIMEOUT)
        assert not th.is_alive()
        return out
    j, t = _both(run)
    assert t == j
    assert t["outcome"] == "Query execution was interrupted"
    assert t["seen"] == [{"phase": "exec.queued"}] and t["waited"]


def test_a_queued_member_shows_exec_queued_from_its_first_slice():
    """A port difference (ROADMAP §3): the port's member beats exec.queued
    as it queues; the JAX member keeps its previous phase through its first
    wait slice (50 ms), longer than a short tick.  Both raise a KILL at the
    next beat."""
    class Done:
        """A rendezvous already met: records the phase each wait saw."""

        def __init__(self, qp_of):
            self.qp_of, self.seen = qp_of, []

        def wait(self, timeout=None):
            self.seen.append(self.qp_of().phase)
            return True

    seen = {}
    for p in PKGS:
        s = _sess(p)
        w = p.dispatch._Waiter(None)
        w.done = Done(p.progress.current)
        w.out = "rows"
        with p.progress.track("SELECT queued", db=s.db) as qp:
            qp.beat(phase="exec.run")
            try:
                s.db.dispatcher._wait(w, lambda: None)
            except Exception:       # noqa: BLE001 — the member's result, not the point here
                pass
            seen[p.name] = (w.done.seen, qp.phase)
    assert seen["port"] == (["exec.queued"], "exec.queued")
    assert seen["jax"] == (["exec.run"], "exec.queued")


def test_kill_before_an_overflow_refold_stops_it_as_jax(flags, monkeypatch):
    """A sorted accumulator clamped to 4 slots overflows and the fold
    restarts; a KILL at the first fold's last beat lands at the re-fold's
    first chunk, before any chunk folds again, in both packages."""
    import baikaldb_tpu.exec.streaming as jstreaming
    import baikaldb_tpu_torch.exec.streaming as tstreaming

    flags("streaming_min_rows", 1)
    flags("streaming_chunk_rows", 64)
    j_orig = jstreaming.StreamRunner._ensure_step

    def j_clamped(self, source, params):
        j_orig(self, source, params)
        # once a runner: a restart doubles the capacity from there
        if not getattr(self, "_clamped", False) and self.keys \
                and self.agg.strategy == "sorted" and self.acc_cap > 4:
            self._clamped = True
            self.acc_cap = 4
            self._jit_step = None
            j_orig(self, source, params)

    t_orig = tstreaming.StreamRunner._size

    def t_clamped(self, cs):
        t_orig(self, cs)
        self.acc_cap = min(self.acc_cap, 4)

    monkeypatch.setattr(jstreaming.StreamRunner, "_ensure_step", j_clamped)
    monkeypatch.setattr(tstreaming.StreamRunner, "_size", t_clamped)
    data = _fact()
    sql = "SELECT id % 97 AS k, COUNT(*) AS n FROM f GROUP BY k ORDER BY k"

    def run(p):
        s = p.session()
        s.execute("CREATE TABLE f (id BIGINT, g INT, v DOUBLE)")
        s.load_arrow("f", data)
        c0, r0 = p.metrics.stream_chunks.value, p.metrics.stream_restarts.value
        restore, _seen, fired = _kill_when(
            p, s, lambda qp: qp.chunks_total and qp.chunk_no == qp.chunks_total)
        try:
            s.execute(sql)
            outcome = "ran"
        except p.progress.QueryKilled as e:
            outcome = str(e)
        finally:
            restore()
        return (outcome, fired, p.metrics.stream_chunks.value - c0,
                p.metrics.stream_restarts.value - r0, s.query(sql))
    j, t = _both(run)
    assert t == j
    assert t[0] == "Query execution was interrupted" and t[1] == [True]
    assert t[2] == 16 and t[3] == 1           # one fold of 16 chunks, no chunk re-folded
    assert len(t[4]) == 97 and sum(r["n"] for r in t[4]) == 1000
