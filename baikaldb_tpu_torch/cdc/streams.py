"""Change streams: durable SUBSCRIBE cursors over the commit_ts binlog.

The port of ``baikaldb_tpu/cdc/streams.py`` without its distributed half:
the JAX package also registers each hold with the binlog regions' GC
(``storage/binlog_regions``) when ``db.cluster`` is set, and the port's
Database has no cluster, so the hold here is the local binlog's alone.

The reference ships a capturer SDK (src/tools/baikal_capturer.h:104-123)
that k-way-merges per-region binlog streams by commit_ts into ONE ordered
event stream and resumes from a saved checkpoint.  Here a
:class:`Subscription` is that cursor, made first-class:

- **resume token = last acked commit_ts**, persisted in the binlog's own
  durable cursor table (``b"c" + "sub!" + name``) — a restarted frontend
  resumes exactly where the consumer last acked, no gap, no loss.
- **fetch/ack protocol**: ``fetch()`` returns events with
  ``commit_ts > acked`` without moving the cursor; ``ack(ts)`` moves it
  durably.  A consumer that applies-then-acks and dedupes replays by
  commit_ts gets exactly-once application — a crash between apply and ack
  redelivers, the dedupe absorbs it (cdc/views.py is the in-tree consumer
  doing exactly this).
- **GC discipline**: every subscription holds the binlog ring's trim
  behind its acked ts (storage/binlog.py ``hold_gc``).  A cursor silent past ``cdc_cursor_max_lag_s``
  is force-expired; its NEXT fetch raises the typed
  :class:`CursorLagging` naming the lost range — never silent loss —
  then resumes from the oldest retained event.
- **merge**: :func:`merge_by_commit_ts` is the fan-in — feeds already
  ordered by commit_ts merge into one stream with a deterministic
  (commit_ts, feed id, arrival index) tiebreak, so equal-ts events from
  different regions always interleave the same way.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Iterable, Iterator, Optional

from ..chaos import failpoint
from ..meta.tso import Tso
from ..utils import metrics
from ..utils.flags import FLAGS, define

define("cdc_fetch_batch", 512,
       "default FETCH batch size for subscription cursors")

# binlog cursor-table namespace for subscriptions — keeps SQL-created
# cursor names from colliding with raw Capturer names
SUB_CURSOR_PREFIX = "sub!"


def _phys_ms(ts: int) -> int:
    """Physical milliseconds of a hybrid TSO timestamp."""
    return int(ts) >> Tso.LOGICAL_BITS


class CursorLagging(RuntimeError):
    """A subscription cursor was force-expired past cdc_cursor_max_lag_s
    and binlog GC moved on; events in (lost_from, lost_to] are gone for
    this subscription.  Raised ONCE by the next fetch — the cursor then
    stands at the oldest retained event and fetch continues from there."""

    def __init__(self, name: str, lost_from: int, lost_to: int):
        super().__init__(
            f"subscription {name!r} lagged past cdc_cursor_max_lag_s: "
            f"events in ({lost_from}, {lost_to}] were GC'd before it "
            f"acked them")
        self.subscription = name
        self.lost_from = lost_from
        self.lost_to = lost_to


def merge_by_commit_ts(feeds: Iterable[tuple[int, Iterable]]) -> Iterator:
    """K-way merge of ``(feed_id, events)`` pairs, each already ordered by
    commit_ts, into one ordered stream.  Ties on commit_ts break
    deterministically on feed id, then arrival index within the feed —
    equal-ts events from different regions interleave identically on
    every replay (the resumable-stream requirement)."""
    heap: list = []
    for fid, feed in feeds:
        it = iter(feed)
        for seq, ev in enumerate(it):
            ts = ev.commit_ts if hasattr(ev, "commit_ts") \
                else ev["commit_ts"]
            heapq.heappush(heap, (int(ts), int(fid), seq, id(ev), ev, it))
            break
    while heap:
        _ts, fid, seq, _tie, ev, it = heapq.heappop(heap)
        yield ev
        for nxt in it:
            ts = nxt.commit_ts if hasattr(nxt, "commit_ts") \
                else nxt["commit_ts"]
            heapq.heappush(heap, (int(ts), fid, seq + 1, id(nxt), nxt, it))
            break


class Subscription:
    """One durable named cursor over the binlog (SQL: CREATE SUBSCRIPTION
    / FETCH; library: :meth:`stream`)."""

    def __init__(self, db, name: str, table_key: Optional[str] = None,
                 internal: bool = False, since_ts: Optional[int] = None):
        self.db = db
        self.name = name
        self.table_key = table_key      # "db.table" filter, None = all
        self.internal = internal        # matview-owned, hidden from DROP
        self.cursor_key = SUB_CURSOR_PREFIX + name
        saved = db.binlog._cursors.get(self.cursor_key)
        if saved is not None:
            self.acked = int(saved)     # exact resume across restart
        elif since_ts is not None:
            self.acked = int(since_ts)
        else:
            # new subscriptions deliver changes from NOW — a dashboard
            # cursor wants the live tail, not table history
            self.acked = db.binlog.current_ts()
        self.delivered = 0
        self.created_ms = int(time.time() * 1000)
        self._mu = threading.RLock()
        self._persist_ack()

    # -- cursor persistence + GC hold -------------------------------------
    def _persist_ack(self):
        self.db.binlog._save_cursor(self.cursor_key, self.acked)
        self.db.binlog.hold_gc(self.cursor_key, self.acked)

    def _release(self):
        self.db.binlog.release_gc(self.cursor_key)

    def _match(self, ev) -> bool:
        return (self.table_key is None
                or f"{ev.database}.{ev.table}" == self.table_key)

    # -- fetch/ack ---------------------------------------------------------
    def fetch(self, limit: int = 0) -> list:
        """Events with commit_ts > acked, in commit_ts order, WITHOUT
        moving the cursor (call :meth:`ack` after applying).  Raises
        CursorLagging once if GC ran past this cursor."""
        from ..obs import trace

        limit = int(limit) or int(FLAGS.cdc_fetch_batch)
        metrics.cdc_fetches.add(1)
        with trace.span("cdc.fetch", subscription=self.name,
                        since=self.acked):
            with self._mu:
                expired_at = self.db.binlog.take_expired(self.cursor_key)
                if expired_at is None \
                        and self.acked < self.db.binlog._oldest_ts:
                    # restart edge: GC moved while no hold was registered
                    expired_at = self.acked
                if expired_at is not None:
                    lost_to = self.db.binlog._oldest_ts
                    self.acked = max(self.acked, lost_to)
                    self._persist_ack()
                    raise CursorLagging(self.name, expired_at, lost_to)
                if failpoint.ENABLED:
                    if failpoint.hit("cdc.fetch", subscription=self.name):
                        return []       # deferred, not lost: acked unmoved
                # the ring can hold MORE than capacity while cursors pin
                # GC — the window must cover all of it, not just capacity
                window = self.db.binlog.read(self.acked, 1 << 30)
                with trace.span("cdc.merge", feeds=1, events=len(window)):
                    out = [e for e in
                           merge_by_commit_ts([(0, window)])
                           if self._match(e)][:limit]
                if not out and window:
                    # the whole window is foreign-table traffic this
                    # subscription will never see: advance past it so the
                    # cursor doesn't pin GC on events it filters out
                    self.acked = window[-1].commit_ts
                    self._persist_ack()
                self.delivered += len(out)
                metrics.cdc_events_delivered.add(len(out))
                hw = self.db.binlog.current_ts()
                pos = out[-1].commit_ts if out else self.acked
                if hw > pos:
                    metrics.cdc_cursor_lag_ms.observe(
                        max(0, _phys_ms(hw) - _phys_ms(pos)))
                return out

    def ack(self, ts: int) -> None:
        """Durably advance the resume token to ``ts`` (monotonic; a stale
        ack is a no-op).  The cdc.apply failpoint models a consumer that
        crashed between applying a batch and acking it — the batch
        redelivers and the consumer's commit_ts dedupe must absorb it."""
        with self._mu:
            if int(ts) <= self.acked:
                return
            if failpoint.ENABLED:
                if failpoint.hit("cdc.apply", subscription=self.name):
                    return
            self.acked = int(ts)
            self._persist_ack()

    def seek(self, ts: int) -> None:
        """Force the cursor to ``ts`` (forward OR backward) — the matview
        re-seed path: after a full rebuild at high-water ts0, everything
        at or below ts0 is already reflected in the seeded state."""
        with self._mu:
            self.acked = int(ts)
            self._persist_ack()
            self.db.binlog.take_expired(self.cursor_key)  # stale mark

    def lag_ms(self) -> int:
        hw = self.db.binlog.current_ts()
        return max(0, _phys_ms(hw) - _phys_ms(self.acked)) if hw else 0

    # -- client-library iterator -------------------------------------------
    def stream(self, timeout: float = 1.0) -> Iterator:
        """Blocking exactly-once iterator: each event is acked when the
        consumer comes back for the next one (apply-then-ack).  Stops when
        no event arrives within ``timeout`` seconds."""
        while True:
            got = self.fetch()
            if not got:
                with self.db.binlog._cv:
                    timed_out = not self.db.binlog._cv.wait(timeout)
                if timed_out:
                    got = self.fetch()      # lost-wakeup re-check
                    if not got:
                        return
                else:
                    continue
            for ev in got:
                yield ev
                self.ack(ev.commit_ts)


class ChangeStreams:
    """Per-database subscription registry (attached as ``db.cdc``).
    Non-internal subscriptions persist in the catalog and are re-attached
    on recovery with their durable cursor position."""

    def __init__(self, db):
        self.db = db
        self.subs: dict[str, Subscription] = {}
        self._mu = threading.RLock()

    def create(self, name: str, table_key: Optional[str] = None,
               internal: bool = False, if_not_exists: bool = False,
               since_ts: Optional[int] = None) -> Subscription:
        with self._mu:
            sub = self.subs.get(name)
            if sub is not None:
                if if_not_exists:
                    return sub
                raise ValueError(f"subscription {name!r} already exists")
            sub = Subscription(self.db, name, table_key,
                               internal=internal, since_ts=since_ts)
            self.subs[name] = sub
            return sub

    def get(self, name: str) -> Subscription:
        with self._mu:
            sub = self.subs.get(name)
            if sub is None:
                raise KeyError(f"unknown subscription {name!r}")
            return sub

    def drop(self, name: str, if_exists: bool = False) -> bool:
        with self._mu:
            sub = self.subs.pop(name, None)
            if sub is None:
                if if_exists:
                    return False
                raise KeyError(f"unknown subscription {name!r}")
            sub._release()
            return True

    def wants_rows(self, table_key: str) -> bool:
        """True when some subscription (or matview stream) needs row
        images for ``table_key`` — the UPDATE/DELETE capture gate."""
        with self._mu:
            return any(s.table_key is None or s.table_key == table_key
                       for s in self.subs.values())

    def describe(self) -> list[dict]:
        with self._mu:
            subs = list(self.subs.values())
        return [{"name": s.name,
                 "table_key": s.table_key or "*",
                 "internal": s.internal,
                 "acked_ts": s.acked,
                 "cursor_lag_ms": s.lag_ms(),
                 "events_delivered": s.delivered}
                for s in sorted(subs, key=lambda s: s.name)]

    # -- catalog persistence ----------------------------------------------
    def to_meta(self) -> list[dict]:
        with self._mu:
            return [{"name": s.name, "table_key": s.table_key}
                    for s in self.subs.values() if not s.internal]

    def recover(self, meta: list[dict]) -> None:
        for m in meta or []:
            # the durable binlog cursor (recovered before us) carries the
            # exact resume position; since_ts=0 only seeds a cursor whose
            # binlog entry vanished entirely
            self.create(m["name"], m.get("table_key"), if_not_exists=True,
                        since_ts=0)
