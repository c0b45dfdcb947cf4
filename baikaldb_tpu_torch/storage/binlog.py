"""Binlog / CDC: ordered change capture with commit timestamps, durable.

The port of ``baikaldb_tpu/storage/binlog.py`` (copied): its TSO is the
port's ``meta/tso.py`` and its durable log the port's
``storage/rowstore.RowTable`` over ``native/engine.cpp``, so a
``binlog.wal`` written by either package opens in the other.  The
distributed binlog over binlog regions belongs to the replicated tier and is
not here.

The reference writes binlog through special binlog-table regions with
two-phase (prewrite/commit) TSO timestamps and recovers them from storage
after restart (src/store/region_binlog.cpp:1420 read_binlog, :1670 recover,
:449 oldest-ts checkpoint tracking), and ships a capturer SDK that merges
per-region streams by commit_ts into one ordered stream, resuming from a
saved checkpoint (baikal_capturer.h:104-123).  Here:

- events live in a commit_ts-ordered ring for hot reads AND — when a path
  is given — in a native WAL-backed table (storage.rowstore.RowTable over
  native/engine.cpp).  An event is persisted BEFORE it becomes readable,
  so nothing a capturer ever saw can be lost by a process crash.  (The
  durability unit is the OS page cache — a kill-9 loses nothing; a power
  loss can drop the tail, the same contract as a WAL without per-write
  fsync.)
- the ring trims at ``capacity`` and the backing log COMPACTS (rewrites to
  live state) once the trimmed backlog reaches ``capacity`` again, so
  memory, disk, and recovery time stay O(capacity), not O(total appends),
- the TSO high-water mark rides recovery, so post-restart timestamps stay
  strictly monotonic (no reissued commit_ts),
- capturers can be NAMED: their positions persist in the same table.  A
  restarted process resumes exactly after the last polled batch — no gap
  and no duplicate ACROSS RESTARTS; within one process the contract is
  at-most-once (poll persists the cursor before returning, so a consumer
  that crashes after poll() but before applying the batch has skipped it).
  A cursor that falls behind GC raises ``BinlogGapError`` once — with the
  lost range — and resumes from the oldest retained event.

Key layout in the durable table (raw memcomparable bytes):
``b"e" + big-endian ts`` -> event JSON; ``b"c" + name`` -> cursor position;
``b"g"`` -> GC watermark.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from bisect import bisect_right, insort
from dataclasses import asdict, dataclass, field
from typing import Iterator, Optional

from ..chaos import failpoint
from ..meta.tso import Tso
from ..utils.flags import FLAGS, define

define("cdc_cursor_max_lag_s", 3600.0,
       "a subscription cursor that has not acked for this many seconds "
       "stops holding binlog GC; the next fetch on it raises CursorLagging "
       "with the lost range instead of silently skipping events")

_EVT = b"e"
_CUR = b"c"
_GCW = b"g"      # GC watermark: commit_ts of the newest trimmed event


def _ekey(ts: int) -> bytes:
    return _EVT + struct.pack(">Q", ts)


class BinlogGapError(RuntimeError):
    """The log was GC'd past a capturer's position; events were lost to it.
    The capturer has been advanced to the oldest retained event — the next
    poll() continues from there."""

    def __init__(self, lost_from: int, lost_to: int):
        super().__init__(f"binlog GC'd ({lost_from}, {lost_to}]: events in "
                         f"that range are gone for this capturer")
        self.lost_from = lost_from
        self.lost_to = lost_to


@dataclass
class BinlogEvent:
    commit_ts: int
    event_type: str               # insert | update | delete | truncate | ddl
    database: str
    table: str
    rows: list = field(default_factory=list)     # row images (insert)
    statement: str = ""                          # statement image
    affected: int = 0


def _schema():
    from ..types import Field as F, LType, Schema

    # codecs are unused — the binlog writes raw keys/values; the table
    # supplies ordered storage + WAL + recovery
    return Schema((F("k", LType.STRING, False), F("v", LType.STRING, True)))


class Binlog:
    """Append-only ordered event log + subscription cursors."""

    def __init__(self, capacity: int = 100_000, path: Optional[str] = None):
        self.capacity = capacity
        self._events: list[BinlogEvent] = []
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self.tso = Tso()
        self._oldest_ts = 0       # checkpoint/GC watermark (reference:
        #                           oldest-ts tracking, region_binlog.cpp:449)
        self._table = None
        # serializes backend file writes against compaction's rewrite+swap:
        # _persist runs OUTSIDE _mu by design (durable-before-visible with
        # no readers stalled behind disk I/O), so without this a concurrent
        # _compact_log_locked could os.replace the log while an append is
        # mid-write_batch to the old table — that append's event would
        # vanish from the post-swap file (lost on recovery).  Order: _mu is
        # taken first when both are held; nothing takes _mu under _wal_mu.
        self._wal_mu = threading.Lock()
        self._path = path
        self._cursors: dict[str, int] = {}
        self._trimmed_since_compact = 0
        # subscription GC holds: holder name -> (acked commit_ts, wall time
        # of the last ack).  Trim never drops an event a holder has not
        # acked — unless the holder's ack is older than
        # cdc_cursor_max_lag_s, in which case it is force-expired and the
        # lost-from ts is parked in _gc_expired for the holder's next fetch
        # to surface as a typed CursorLagging (never silent loss).
        self._gc_holds: dict[str, tuple[int, float]] = {}
        self._gc_expired: dict[str, int] = {}
        if path:
            from .rowstore import RowTable

            self._table = RowTable(_schema(), ["k"], wal_path=path)
            self._recover()

    # -- durable backend ---------------------------------------------------
    def _recover(self):
        """Rebuild the ring + cursors from the WAL-replayed table; commit_ts
        order IS key order (big-endian).  The TSO resumes past the highest
        recovered ts so restart never reissues a commit_ts."""
        max_ts = 0
        for k, v in self._table.scan_raw():
            if k[:1] == _EVT:
                (ts,) = struct.unpack(">Q", k[1:9])
                self._events.append(BinlogEvent(**json.loads(v.decode())))
                max_ts = max(max_ts, ts)
            elif k[:1] == _CUR:
                self._cursors[k[1:].decode()] = int(
                    struct.unpack("<Q", v)[0])
            elif k[:1] == _GCW:
                self._oldest_ts = int(struct.unpack("<Q", v)[0])
        if max_ts:
            # restore() takes the PHYSICAL clock part; +1 guarantees every
            # post-restart timestamp sorts after every recovered one even
            # when the old logical counter was mid-batch
            self.tso.restore((max_ts >> Tso.LOGICAL_BITS) + 1)

    def _persist(self, ops: list[tuple[int, bytes, bytes]]):
        if self._path is None or not ops:
            return
        with self._wal_mu:      # the swap (compaction) can't run mid-write
            if self._table is not None:
                self._table.write_batch(ops)   # appends + flushes the WAL

    def _compact_log_locked(self):
        """Rewrite the backing log to live state only (ring + cursors +
        watermark), then atomically swap it in — the raft-snapshot-style
        compaction that keeps recovery O(capacity).  Caller holds _mu."""
        from .rowstore import RowTable

        with self._wal_mu:      # no append may be mid-write to the old log
            tmp = self._path + ".compact"
            if os.path.exists(tmp):
                os.remove(tmp)
            nt = RowTable(_schema(), ["k"], wal_path=tmp)
            ops = [(0, _ekey(e.commit_ts),
                    json.dumps(asdict(e), default=str).encode())
                   for e in self._events]
            ops += [(0, _CUR + n.encode(), struct.pack("<Q", p))
                    for n, p in self._cursors.items()]
            if self._oldest_ts:
                ops.append((0, _GCW, struct.pack("<Q", self._oldest_ts)))
            if ops:
                nt.write_batch(ops)
            # POSIX rename: nt keeps writing the (renamed) file; the old
            # table's file handle dies with the object
            os.replace(tmp, self._path)
            self._table = nt
            self._trimmed_since_compact = 0

    # -- writes ------------------------------------------------------------
    def append(self, event_type: str, database: str, table: str,
               rows: Optional[list] = None, statement: str = "",
               affected: int = 0) -> int:
        from ..obs import trace

        with trace.span("binlog.append", table=f"{database}.{table}",
                        event=event_type):
            return self._append(event_type, database, table, rows,
                                statement, affected)

    def _append(self, event_type: str, database: str, table: str,
                rows: Optional[list], statement: str, affected: int) -> int:
        if failpoint.ENABLED:
            # before the TSO draw and before durability: a panic here is
            # the mid-transaction crash window (the append was never
            # acked, so recovery owes the caller nothing for it); drop
            # loses the event outright
            if failpoint.hit("binlog.append", table=f"{database}.{table}",
                             event=event_type):
                return 0
        # durable-before-visible, and the write I/O happens OUTSIDE the
        # lock: readers are never stalled behind another append's disk
        # write (only ring insertion and the rare trim hold it)
        with self._mu:
            ts = self.tso.gen()
        ev = BinlogEvent(ts, event_type, database, table,
                         rows or [], statement, affected)
        if self._table is not None:
            payload = json.dumps(asdict(ev), default=str).encode()
            # canonicalize through JSON so live consumers see exactly the
            # types a post-restart consumer would (no Decimal-before /
            # str-after drift in the stream)
            ev = BinlogEvent(**json.loads(payload))
            self._persist([(0, _ekey(ts), payload)])
        with self._cv:
            insort(self._events, ev, key=lambda e: e.commit_ts)
            if len(self._events) > self.capacity:
                self._trim_locked()
            self._cv.notify_all()
            return ts

    def _trim_locked(self):
        """Trim the ring down to capacity, clamped at the oldest unacked
        subscription cursor (reference: the capturer checkpoint holds the
        binlog-region GC safepoint).  Caller holds _mu."""
        from ..utils import metrics

        want = len(self._events) - self.capacity
        if want <= 0:
            return
        drop = want
        if self._gc_holds:
            now = time.monotonic()
            max_lag = float(FLAGS.cdc_cursor_max_lag_s)
            for name, (acked, last_ack) in list(self._gc_holds.items()):
                if now - last_ack > max_lag:
                    # force-expire: stop holding, remember where the hole
                    # starts so the holder's next fetch raises CursorLagging
                    self._gc_expired[name] = acked
                    del self._gc_holds[name]
                    metrics.cdc_cursors_expired.add(1)
        if self._gc_holds:
            min_hold = min(ts for ts, _ in self._gc_holds.values())
            # every holder has acked events with commit_ts <= its hold ts;
            # anything newer than the slowest hold is pinned
            allowed = bisect_right(
                [e.commit_ts for e in self._events], min_hold)
            if allowed < want:
                metrics.binlog_gc_held_by_cursor.add(want - allowed)
            drop = min(want, allowed)
        if drop <= 0:
            return
        self._oldest_ts = self._events[drop - 1].commit_ts
        self._persist(
            [(1, _ekey(e.commit_ts), b"")
             for e in self._events[:drop]] +
            [(0, _GCW, struct.pack("<Q", self._oldest_ts))])
        del self._events[:drop]
        self._trimmed_since_compact += drop
        if self._table is not None and \
                self._trimmed_since_compact >= self.capacity:
            self._compact_log_locked()

    def current_ts(self) -> int:
        with self._mu:
            return self._events[-1].commit_ts if self._events else 0

    # -- reads -------------------------------------------------------------
    def read(self, start_ts: int = 0, limit: int = 1000) -> list[BinlogEvent]:
        """Events with commit_ts > start_ts, ordered (read_binlog analog)."""
        with self._mu:
            if start_ts < self._oldest_ts:
                raise ValueError(
                    f"binlog GC'd past requested ts {start_ts} "
                    f"(oldest retained: {self._oldest_ts})")
            out = [e for e in self._events if e.commit_ts > start_ts]
            return out[:limit]

    def subscribe(self, start_ts: int = 0,
                  name: Optional[str] = None) -> "Capturer":
        """``name`` makes the cursor durable: a restarted process calling
        subscribe(name=...) resumes after the last polled batch."""
        if name is not None:
            with self._mu:
                start_ts = self._cursors.get(name, start_ts)
        return Capturer(self, start_ts, name)

    def _save_cursor(self, name: str, position: int):
        with self._mu:
            self._cursors[name] = position
        self._persist([(0, _CUR + name.encode(),
                        struct.pack("<Q", position))])

    # -- subscription GC holds --------------------------------------------
    def hold_gc(self, name: str, acked_ts: int):
        """Pin GC behind ``acked_ts`` for holder ``name`` (call on every
        ack — the wall time of the newest call feeds force-expiry)."""
        with self._mu:
            self._gc_holds[name] = (acked_ts, time.monotonic())

    def release_gc(self, name: str):
        with self._mu:
            self._gc_holds.pop(name, None)
            self._gc_expired.pop(name, None)

    def take_expired(self, name: str) -> Optional[int]:
        """If ``name`` was force-expired past cdc_cursor_max_lag_s, return
        the commit_ts its hold stood at (events after it may be gone) and
        clear the mark; else None."""
        with self._mu:
            return self._gc_expired.pop(name, None)

    def min_hold(self) -> Optional[int]:
        """Oldest held commit_ts across active subscription cursors."""
        with self._mu:
            if not self._gc_holds:
                return None
            return min(ts for ts, _ in self._gc_holds.values())


class Capturer:
    """Cursor over the binlog (the baikal_capturer SDK analog): pull batches
    in commit_ts order, resume from the last seen timestamp.  Named cursors
    persist their position at every poll — at-most-once delivery relative
    to consumer crashes, exact resume relative to process restarts.  A
    cursor that fell behind GC gets one BinlogGapError naming the lost
    range, then continues from the oldest retained event."""

    def __init__(self, binlog: Binlog, start_ts: int = 0,
                 name: Optional[str] = None):
        self.binlog = binlog
        self.position = start_ts
        self.name = name

    def poll(self, limit: int = 1000) -> list[BinlogEvent]:
        try:
            events = self.binlog.read(self.position, limit)
        except ValueError:
            lost_from, self.position = self.position, self.binlog._oldest_ts
            if self.name is not None:
                self.binlog._save_cursor(self.name, self.position)
            raise BinlogGapError(lost_from, self.position) from None
        if events:
            self.position = events[-1].commit_ts
            if self.name is not None:
                self.binlog._save_cursor(self.name, self.position)
        return events

    def stream(self, timeout: float = 1.0) -> Iterator[BinlogEvent]:
        """Blocking iterator; stops when no event arrives within timeout."""
        while True:
            got = self.poll()
            if not got:
                with self.binlog._cv:
                    timed_out = not self.binlog._cv.wait(timeout)
                if timed_out:
                    # re-poll once: an append between poll() and wait() would
                    # otherwise be a lost wakeup
                    got = self.poll()
                    if not got:
                        return
                else:
                    continue
            yield from got
