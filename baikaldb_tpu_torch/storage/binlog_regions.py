"""Distributed binlog: replicated binlog regions with TSO two-phase commit.

The reference's binlog IS region data: writes prewrite into dedicated binlog
regions with a TSO start_ts, commit with a TSO commit_ts, a ``read_binlog``
RPC serves ordered events, and capturers merge multiple binlog regions by
commit_ts (src/store/region_binlog.cpp:1420, recover at
:1670, checkpoint/oldest-ts at :449-451; capturer merge at
src/tools/baikal_capturer.h:104-123).  A frontend-local WAL binlog
(storage/binlog.py) is durable, but two frontends writing one fleet would
produce two disjoint logs.

The design on the daemon plane, reusing the replication machinery outright:

- Binlog events are rows of a dedicated raft-replicated table
  (``__binlog__.events`` via RemoteRowTier): leader kill-9 loses nothing,
  splits/recovery/routing all inherited.
- Ordering: every event carries a meta-TSO ``commit_ts``; capturers sort by
  it, so N frontends produce ONE totally-ordered stream.
- Gaplessness: a writer first PREWRITES a marker at start_ts, then commits
  the event row at commit_ts (> start_ts, TSO monotonicity).  A capturer
  only emits events below the oldest ACTIVE prewrite's start_ts — nothing
  can later commit below that watermark.
- Atomicity with data: for autocommit DML the binlog commit row (and the
  prewrite tombstone) ride the SAME cross-tier 2PC as the data ops
  (storage.remote_tier.write_ops_atomic_remote — the global-index DML
  path), so the event exists iff the data committed.  A crash leaves at
  worst an orphan prewrite, which the capturer expires after a grace
  window (the data 2PC for it either never decided or rolls back through
  the tiers' own in-doubt recovery).

A copy of ``baikaldb_tpu/storage/binlog_regions.py`` (host-only Python).
"""

from __future__ import annotations

import json
import time
import weakref
from typing import Optional

from ..chaos import failpoint
from ..types import Field, LType, Schema
from ..utils.flags import FLAGS, define
from .column_store import ROWID
from ..utils import metrics

define("binlog_regions", True,
       "cluster mode: replicate DML binlog events through dedicated "
       "binlog regions with TSO ordering (the region_binlog analog)")
define("binlog_prewrite_grace_s", 30.0,
       "capturer: an active prewrite older than this with no decided "
       "outcome is expired (its writer died mid-2PC)")

BINLOG_TABLE_KEY = "__binlog__.events"

# subscription GC holds, per cluster: cursor name -> acked commit_ts.  gc()
# never tombstones a committed event a registered cursor has not acked
# (reference: the capturer checkpoint is the binlog-region GC safepoint).
_GC_HOLDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def register_gc_hold(cluster, name: str, acked_ts: int) -> None:
    _GC_HOLDS.setdefault(cluster, {})[name] = int(acked_ts)


def release_gc_hold(cluster, name: str) -> None:
    _GC_HOLDS.get(cluster, {}).pop(name, None)


def min_gc_hold(cluster) -> Optional[int]:
    holds = _GC_HOLDS.get(cluster)
    return min(holds.values()) if holds else None

_FIELDS = (Field("ts", LType.INT64, False),
           Field("state", LType.INT64, False),      # 0 prewrite, 1 commit
           Field("start_ts", LType.INT64, True),    # commit rows: their P
           Field("table_key", LType.STRING, True),
           Field("events", LType.STRING, True),     # JSON event list
           Field("src", LType.STRING, True))

ROW_SCHEMA = Schema((Field(ROWID, LType.INT64, False),
                     Field("__del", LType.BOOL, True)) + _FIELDS)


_KC = None


def _key_codec():
    global _KC
    if _KC is None:
        from .rowstore import KeyCodec

        _KC = KeyCodec(ROW_SCHEMA, [ROWID])
    return _KC


def encode_op(tier, row: dict):
    """One binlog-tier write op (shared by writer, capturer expiry, gc —
    one encoding, no drift)."""
    return (0, _key_codec().encode_one(row), tier.row_codec.encode(row))


def tombstone_op(tier, rowid: int, ts: int, state: int):
    return encode_op(tier, {ROWID: int(rowid), "__del": True,
                            "ts": int(ts), "state": int(state)})


def _json_safe(v):
    import datetime

    if isinstance(v, (datetime.date, datetime.datetime)):
        return str(v)
    return v


class DistributedBinlog:
    """Writer handle: prewrite/commit protocol over the binlog tier."""

    def __init__(self, cluster, src: str = ""):
        from .remote_tier import RemoteRowTier

        self.cluster = cluster
        self.src = src or f"frontend-{id(cluster) & 0xffff:x}"
        self.tier = RemoteRowTier.get_or_create(
            cluster, BINLOG_TABLE_KEY, ROW_SCHEMA, [ROWID])

    # -- TSO --------------------------------------------------------------
    def tso(self) -> int:
        return int(self.cluster.meta.call("tso")["ts"])

    # -- writer protocol --------------------------------------------------
    def _encode(self, row: dict):
        return encode_op(self.tier, row)

    def prewrite(self, table_key: str) -> tuple[int, tuple]:
        """Reserve ordering: P row at start_ts.  Returns (start_ts,
        delete-op) — the delete op rides the commit batch."""
        start_ts = self.tso()
        rowid = self.tier.alloc_rowids(1)
        row = {ROWID: rowid, "ts": start_ts, "state": 0,
               "table_key": table_key, "src": self.src}
        self.tier.write_ops([self._encode(row)])
        tomb = tombstone_op(self.tier, rowid, start_ts, 0)
        return start_ts, tomb

    def commit_ops(self, start_ts: int, tomb, table_key: str,
                   events: list) -> tuple[int, list]:
        """(commit_ts, binlog-tier ops) for the atomic data batch: the C
        row plus the prewrite tombstone."""
        commit_ts = self.tso()
        rowid = self.tier.alloc_rowids(1)
        row = {ROWID: rowid, "ts": commit_ts, "state": 1,
               "start_ts": start_ts, "table_key": table_key,
               "events": json.dumps(events, default=str),
               "src": self.src}
        return commit_ts, [self._encode(row), tomb]

    def abort(self, tomb) -> None:
        """Retire a prewrite whose data write failed (best effort: the
        capturer's grace expiry is the backstop)."""
        try:
            self.tier.write_ops([tomb])
        except Exception:   # grace expiry is the backstop; keep it visible
            metrics.count_swallowed("binlog_regions.abort")

    def write_with_data(self, data_tier, data_ops: list, table_key: str,
                        events: list) -> None:
        """Autocommit DML: binlog C row + P tombstone join the data ops in
        ONE cross-tier transaction (write_ops_atomic_remote) — the event
        exists iff the data committed."""
        from ..obs import trace
        from .remote_tier import write_ops_atomic_remote

        with trace.span("binlog.dist_append", table=table_key,
                        events=len(events), with_data=True):
            if failpoint.ENABLED:
                if failpoint.hit("binlog.dist_append", table=table_key):
                    # drop: the CDC append is skipped but the DATA still
                    # commits — the lost-binlog-event chaos the scenario
                    # assertions exist to catch
                    data_tier.write_ops(data_ops)
                    return
            start_ts, tomb = self.prewrite(table_key)
            try:
                _ts, bops = self.commit_ops(start_ts, tomb, table_key,
                                            events)
                write_ops_atomic_remote([(data_tier, data_ops),
                                         (self.tier, bops)])
            except Exception:
                self.abort(tomb)
                raise

    def append(self, table_key: str, events: list) -> int:
        """Standalone event append (txn-commit flush, DDL): full protocol
        without data ops.  Returns the commit_ts."""
        from ..obs import trace

        with trace.span("binlog.dist_append", table=table_key,
                        events=len(events)):
            if failpoint.ENABLED:
                if failpoint.hit("binlog.dist_append", table=table_key):
                    return 0        # drop: the events are lost
            start_ts, tomb = self.prewrite(table_key)
            try:
                commit_ts, bops = self.commit_ops(start_ts, tomb, table_key,
                                                  events)
                self.tier.write_ops(bops)
                return commit_ts
            except Exception:
                self.abort(tomb)
                raise

    # past this many row images, one statement-summary event replaces the
    # per-row images (mirrors the local binlog's bulk guard)
    MAX_ROW_EVENTS = 1000

    @classmethod
    def events_of(cls, recs: list[dict]) -> list:
        """Row images -> JSON-safe CDC events (inserts/updates carry the
        row; deletes carry the rowid + key image).  Bulk batches degrade
        to a single summary event — a 1M-row INSERT..SELECT must not
        serialize 1M python dicts into one raft proposal."""
        if len(recs) > cls.MAX_ROW_EVENTS:
            dels = sum(1 for r in recs if r.get("__del"))
            return [{"kind": "bulk", "writes": len(recs) - dels,
                     "deletes": dels}]
        out = []
        for r in recs:
            kind = "delete" if r.get("__del") else "write"
            out.append({"kind": kind,
                        "row": {k: _json_safe(v) for k, v in r.items()
                                if k != "__del"}})
        return out

    @classmethod
    def events_from_statement(cls, event_type: str, rows, statement: str,
                              affected: int) -> list:
        """Buffered statement-level events (the txn-commit flush) in the
        SAME shape as events_of, so subscribers see one schema regardless
        of which write path produced the event."""
        if rows and len(rows) <= cls.MAX_ROW_EVENTS:
            kind = "delete" if event_type == "delete" else "write"
            return [{"kind": kind,
                     "row": {k: _json_safe(v) for k, v in r.items()}}
                    for r in rows]
        return [{"kind": "statement", "statement": statement or event_type,
                 "affected": int(affected or 0)}]


class BinlogCapturer:
    """Merge the binlog regions into one gapless commit_ts-ordered stream
    (the baikal_capturer analog)."""

    def __init__(self, cluster, since_ts: int = 0):
        from .remote_tier import RemoteRowTier

        self.tier = RemoteRowTier.get_or_create(
            cluster, BINLOG_TABLE_KEY, ROW_SCHEMA, [ROWID])
        self.cluster = cluster
        self.checkpoint = int(since_ts)
        self._prewrite_seen: dict[int, float] = {}   # start_ts -> first seen

    def _rows(self) -> list[dict]:
        frag = {"v": 1, "mode": "rows",
                "filter": ["f", "or",
                           [["f", "eq", [["c", "state"], ["l", 0]]],
                            ["f", "gt", [["c", "ts"],
                                         ["l", self.checkpoint]]]]],
                "outputs": [["ts", ["c", "ts"]],
                            ["state", ["c", "state"]],
                            ["start_ts", ["c", "start_ts"]],
                            ["table_key", ["c", "table_key"]],
                            ["events", ["c", "events"]],
                            ["src", ["c", "src"]],
                            [ROWID, ["c", ROWID]]],
                "limit": None}
        try:
            payloads = self.tier.exec_fragment(frag)
            names = [n for n, _ in frag["outputs"]]
            out = []
            for p in payloads:
                for r in p["rows"]:
                    out.append(dict(zip(names, r)))
            return out
        except Exception:       # noqa: BLE001 — raw fallback path
            return [r for r in self.tier.scan_rows()
                    if not r.get("__del")
                    and (r["state"] == 0 or r["ts"] > self.checkpoint)]

    def poll(self) -> list[dict]:
        """New committed events with commit_ts <= the safe watermark, in
        commit_ts order.  The watermark is min(active prewrite start_ts):
        TSO gives every future commit a ts above its own start_ts, so
        nothing can later appear below it."""
        rows = self._rows()
        now = time.monotonic()
        grace = float(FLAGS.binlog_prewrite_grace_s)
        active = []
        expired = []
        for r in rows:
            if r["state"] == 0:
                first = self._prewrite_seen.setdefault(int(r["ts"]), now)
                if now - first <= grace:
                    active.append(int(r["ts"]))
                else:
                    expired.append(r)
        if expired:
            # resolve expired prewrites DURABLY (tombstone) so they stop
            # stalling every future capturer: their writer died before the
            # commit decision; the data tiers' own in-doubt recovery rolls
            # the matching prepares back.  (A writer stalled longer than
            # the grace window is the documented resolution boundary —
            # the reference expires binlog prewrites on a timer too.)
            ops = [tombstone_op(self.tier, r[ROWID], r["ts"], 0)
                   for r in expired]
            try:
                self.tier.write_ops(ops)
            except Exception:       # noqa: BLE001 — next poll retries
                active.extend(int(r["ts"]) for r in expired)
        watermark = min(active) if active else None
        out = []
        for r in sorted((r for r in rows if r["state"] == 1),
                        key=lambda r: int(r["ts"])):
            ts = int(r["ts"])
            if ts <= self.checkpoint:
                continue
            if watermark is not None and ts >= watermark:
                break
            out.append({"commit_ts": ts,
                        "start_ts": int(r["start_ts"] or 0),
                        "table": r["table_key"],
                        "src": r["src"],
                        "events": json.loads(r["events"] or "[]")})
            self.checkpoint = ts
        # forget resolved prewrites so the seen-map stays bounded
        live = {int(r["ts"]) for r in rows if r["state"] == 0}
        self._prewrite_seen = {t: v for t, v in
                               self._prewrite_seen.items() if t in live}
        return out

    def gc(self, before_ts: Optional[int] = None) -> int:
        """Tombstone emitted commit rows below ``before_ts`` (default: the
        capturer checkpoint) — the binlog's bounded-retention story.  The
        limit is clamped at the oldest unacked subscription cursor
        (register_gc_hold), so a slow subscriber never has events GC'd out
        from under it silently."""
        limit = self.checkpoint if before_ts is None else int(before_ts)
        hold = min_gc_hold(self.cluster)
        if hold is not None and hold < limit:
            metrics.binlog_gc_held_by_cursor.add(1)
            limit = hold
        victims = [r for r in self.tier.scan_rows()
                   if not r.get("__del") and r["state"] == 1
                   and int(r["ts"]) <= limit]
        ops = [tombstone_op(self.tier, r[ROWID], r["ts"], 1)
               for r in victims]
        if ops:
            self.tier.write_ops(ops)
        return len(ops)
