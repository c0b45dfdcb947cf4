"""Fleet watchdogs: detect wedged queries and stuck daemons, loudly.

The port of ``baikaldb_tpu/obs/watchdog.py``.  A query wedged on the card
(a kernel that never returns) or on a dead peer's RPC, and a raft apply
loop that stopped draining, have one observable signature: SOMETHING THAT
SHOULD ADVANCE STOPPED ADVANCING.  So the watchdog is one generic scanner
with pluggable probes:

- :class:`QueryWatchdog` (frontend): a live query whose last progress beat
  (obs/progress.py) is older than ``watchdog_stall_s`` is stalled.  A
  query blocked in a device call shows here too: it sits in its exec phase
  with no beat, because the one thread that would beat is blocked.
- :class:`StoreWatchdog` (store daemon, server/store_server.py): the raft
  tick loop going silent (elections stop, every region freezes), and a
  region whose apply lag is nonzero while applied_index stopped moving.

Detections count ONCE per continuous stall episode in
``metrics.watchdog_stalls_detected`` and surface as the daemon ``health``
RPC, ``SHOW STATUS`` ``health.*`` rows and the stalled query's SHOW
PROCESSLIST State cell (flagged STALLED).  Scans run on a detached thread
(``watchdog_interval_s``, started in cluster mode only, as in the JAX
package) or synchronously via ``scan_now()``: never on a query path, never
touching device state.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..utils import metrics
from ..utils.flags import FLAGS, define
from .progress import PROGRESS

define("watchdog_stall_s", 5.0,
       "a live query with no progress beat (or a raft apply lag with no "
       "applied_index movement) for this many seconds is a stall")
define("watchdog_interval_s", 1.0,
       "watchdog scan period for the background thread; scans are a "
       "registry walk, no locks shared with the query path")


class Watchdog:
    """Generic stall scanner.  Subclasses implement ``probe() ->
    [(subject, detail), ...]`` returning everything CURRENTLY stalled;
    the base class handles episode dedup, counters, the background
    thread, and the health/status renderings."""

    def __init__(self, name: str = "frontend"):
        self.name = name
        # lock rank 8 in the JAX package's order: below store.table_lock
        # (10); nothing is taken while holding it
        self._mu = threading.Lock()
        self._live: dict[str, dict] = {}      # subject -> stall record
        self._detected_total = 0
        self._last_scan = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- override point ----------------------------------------------------
    def probe(self) -> list[tuple[str, str]]:
        return []

    # -- scanning ----------------------------------------------------------
    def scan_now(self) -> list[dict]:
        """One synchronous scan; -> the currently-live stall records.
        The probe runs under _mu too: the background thread and a SHOW
        STATUS can scan concurrently."""
        with self._mu:
            found = dict(self.probe())
            now = time.time()
            self._last_scan = now
            for subject, detail in found.items():
                rec = self._live.get(subject)
                if rec is not None:
                    rec["detail"] = detail
                else:
                    # new episode: count once, hold until it recovers
                    self._live[subject] = {"subject": subject,
                                           "detail": detail, "since": now}
                    self._detected_total += 1
                    metrics.watchdog_stalls_detected.add(1)
            for subject in list(self._live):
                if subject not in found:      # recovered: a later re-stall
                    del self._live[subject]   # is a new episode
            return [dict(r) for r in self._live.values()]

    def health(self) -> dict:
        """The health verdict (the JAX package's ``health`` RPC body)."""
        stalls = self.scan_now()
        with self._mu:
            total = self._detected_total
        return {"daemon": self.name,
                "status": "stalled" if stalls else "ok",
                "stalls": stalls, "stalls_detected": total,
                "ts": time.time()}

    def status_rows(self) -> dict:
        """SHOW STATUS rows (string values, ``health.`` prefixed)."""
        h = self.health()
        return {"health.status": h["status"],
                "health.stalls_live": str(len(h["stalls"])),
                "health.stalls_detected": str(h["stalls_detected"]),
                "health.watchdog": self.name}

    # -- lifecycle ---------------------------------------------------------
    def start(self, interval_s: Optional[float] = None) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.scan_now()
                except Exception:                       # noqa: BLE001 — the
                    # watchdog must never die of what it watches
                    metrics.count_swallowed(f"watchdog.{self.name}")
                self._stop.wait(max(0.05, float(
                    interval_s if interval_s is not None
                    else FLAGS.watchdog_interval_s)))

        self._thread = threading.Thread(
            target=loop, daemon=True, name=f"watchdog-{self.name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None


class QueryWatchdog(Watchdog):
    """Frontend: wedged-query detection over the live progress registry
    (filtered to one Database identity — engines coexist in-process)."""

    def __init__(self, db=None, name: str = "frontend"):
        super().__init__(name=name)
        self.db = db

    def probe(self) -> list[tuple[str, str]]:
        stall_s = max(0.1, float(FLAGS.watchdog_stall_s))
        now = time.monotonic()
        out = []
        for qp in PROGRESS.live(self.db):
            age = now - qp.beat_mono
            if age > stall_s:
                qp.stalled = True     # SHOW PROCESSLIST State flags it
                out.append((f"query:{qp.query_id}",
                            f"no progress beat for {age:.1f}s "
                            f"(conn {qp.conn_id}, phase {qp.phase}"
                            f"{', op ' + qp.operator if qp.operator else ''})"
                            ))
            elif qp.stalled:          # beating again: drop the flag so the
                qp.stalled = False    # State cell reflects the recovery
        return out

class StoreWatchdog(Watchdog):
    """Store daemon: raft-clock liveness + apply-lag drain.  Reads the
    region map under the store's core lock exactly like the telemetry
    scrape does; per-scan cost is a few fields per region."""

    def __init__(self, store):
        super().__init__(name=f"store-{store.store_id}")
        self.store = store
        # region -> (applied_index, first seen stuck at, monotonic ts)
        self._apply_seen: dict[int, tuple[int, float]] = {}

    def probe(self) -> list[tuple[str, str]]:
        stall_s = max(0.1, float(FLAGS.watchdog_stall_s))
        now = time.monotonic()
        out: list[tuple[str, str]] = []
        last_tick = getattr(self.store, "_last_tick", None)
        if last_tick is not None and not self.store._stop.is_set() \
                and now - last_tick > stall_s:
            out.append(("tick",
                        f"raft clock silent for {now - last_tick:.1f}s"))
        with self.store._mu:
            snap = [(rid, r.core.commit_index, r.applied_index)
                    for rid, r in self.store.regions.items()]
        for rid, commit, applied in snap:
            lag = max(0, commit - applied)
            if lag <= 0:
                self._apply_seen.pop(rid, None)
                continue
            prev = self._apply_seen.get(rid)
            if prev is None or applied > prev[0]:
                self._apply_seen[rid] = (applied, now)   # still draining
                continue
            if now - prev[1] > stall_s:
                out.append((f"region:{rid}",
                            f"apply lag {lag} stuck for "
                            f"{now - prev[1]:.1f}s (applied={applied})"))
        stale = set(self._apply_seen) - {rid for rid, _, _ in snap}
        for rid in stale:                     # dropped/migrated region
            self._apply_seen.pop(rid, None)
        return out

