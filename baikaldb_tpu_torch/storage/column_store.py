"""Columnar table storage: regions of Arrow rows, their device image, and the
MVCC row tier behind them for durability and transactions.

The port of ``baikaldb_tpu/storage/column_store.py``.  ``purge_expired`` is
the TTL delete.

- **Regions**: the table's rows, cut by row count into regions of at most
  ``region_rows`` rows (``DEFAULT_REGION_ROWS`` = 2^20).  Each region holds
  an Arrow table, the rows' hidden ``__rowid``s and their MVCC commit stamps
  (storage/mvcc.py).  Every query reads the device image of the current
  version: one batch with table-wide string dictionaries, staged on the
  store's device and cached per version (a write re-stages it at the next
  read), its row-sharded copy for the mesh, and the host column statistics
  the planner reads.
- **Row tier**: every SQL write also goes to the native MVCC row engine
  (storage/rowstore.py) keyed by ``__rowid``; with a WAL attached
  (``Database(data_dir=...)``) committed DML is durable, and on restart the
  WAL replays over the last Parquet checkpoint.  ``insert_arrow`` (bulk
  load) lands in the regions only and is durable at the next checkpoint.
- **Replicated tier** (``attach_replicated``; storage/replicated.py over
  the in-process Raft fleet): a fleet-bound table's writes quorum-commit
  before its regions change.  An autocommit statement is one replicated
  write (1PC within a region, 2PC across regions), a bulk load one write
  of all its rows, a COMMIT the transaction's buffered write set, and
  ``commit_group`` one 2PC over every replicated table it touches;
  TRUNCATE and ALTER replicate too.  Rowids come from cluster-wide ranges
  the meta service hands out, and a new Database over the fleet rebuilds
  the regions from the replicas, after the cold segments' rows
  (``cold_rows``), so a SELECT spans hot and cold.  On the daemon plane
  (storage/remote_tier.py) the tier is a ``RemoteRowTier`` and the attach
  may be deferred (``attach_replicated_lazy``): the first access to
  ``regions`` pulls the image, so a frontend whose reads all push down to
  the stores never pays it.  ``commit_group`` spans the in-process and the
  remote tables in one 2PC each, and an autocommit write of a binlogged
  remote table carries its change event in the data's own 2PC
  (``binlog_sink``, storage/binlog_regions.py).
- **Presort permutations** (``sort_permutation``, ``agg_sort_permutation``):
  host argsorts of the device image's key columns that let a join's build
  side and a sorted GROUP BY skip their device sort, cached per version
  with their device copies.
- **Transactions**: a ``TxnContext`` holds the table's writer lease, row
  locks and buffered row-tier writes, and region pre-image references
  (Arrow tables and the stamp arrays are never mutated in place, so capture
  copies nothing); rollback restores them.  ``commit_group`` commits several
  tables under one commit timestamp.
- **Partitions**: a table declared ``PARTITION BY RANGE`` / ``HASH``
  (``partition_spec``) routes each row into its partition's own regions
  (``Region.part``, ``partition_ids``); an unroutable row is refused before
  any durable write, an UPDATE of the partition column moves its rows
  (``_rehome_partition_rows``), and the tags survive a checkpoint in the
  region files' names.  ``partitions_for`` / ``prune_parts`` give the
  regions a predicate on the partition column can touch.
- **Access paths**: per-region zone maps (``prune_regions``), partition
  pruning, the primary key index (``point_lookup``, ``lookup_by_pks``) and
  sorted secondary orders (``secondary_scan``), which index/selector.py
  chooses among.
- **Snapshots**: ``versioned_batch`` is the device batch of a pinned read:
  the live image and the history versions alive at the snapshot, with
  ``visibility_mask`` ANDed into ``sel`` on the device.

``_zone_scalar`` canonicalizes zone-map bounds for region pruning and the
streamed scan's chunk pruning (storage/streamchunks.py).

Lock order (the JAX package's ranks): a table's lock (rank 10) comes first;
under it a commit takes the snapshot registry's (12) and the TSO client's
(15).
"""

from __future__ import annotations

import bisect
import datetime
import os
import threading
from dataclasses import replace
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import torch

from ..analysis.runtime import LOCK_RANKS, GuardedLock
from ..column.batch import ColumnBatch, concat_batches
from ..column.dictionary import NULL_CODE, Dictionary
from ..index.stats import collect
from ..meta.catalog import TableInfo
from ..types import Field, LType, Schema
from ..utils.flags import FLAGS
from . import mvcc as mv
from .rowstore import ConflictError, KeyCodec, RowTable, Txn

DEFAULT_REGION_ROWS = 1 << 20  # split threshold on the row axis
ROWID = "__rowid"              # hidden parquet column carrying row identity


def _fnv64(b: bytes) -> int:
    """FNV-1a 64-bit: the hash partition of a string key (the JAX package's
    ``storage/replicated._fnv64``)."""
    h = 0xcbf29ce484222325
    for x in b:
        h = ((h ^ x) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return h


def check_cold_readable(tier, fs, label: str) -> None:
    """A frontend that cannot read the cold tier must refuse the table:
    rebuilding from the (evicted) hot tier alone would silently lose rows.
    Shared by eager attach (exec/session.make_store) and the deferred
    materialization path."""
    if fs is None and tier.has_cold():
        raise ValueError(
            f"table {label!r} has cold segments but no cold storage "
            f"is configured (set cold_dir or the cold_fs_dir flag)")


def schema_to_arrow(schema: Schema) -> pa.Schema:
    m = {
        LType.BOOL: pa.bool_(), LType.INT8: pa.int8(), LType.INT16: pa.int16(),
        LType.INT32: pa.int32(), LType.INT64: pa.int64(),
        LType.UINT32: pa.uint32(), LType.UINT64: pa.uint64(),
        LType.FLOAT32: pa.float32(), LType.FLOAT64: pa.float64(),
        LType.DECIMAL: pa.float64(), LType.DATE: pa.date32(),
        LType.DATETIME: pa.timestamp("us"), LType.TIMESTAMP: pa.timestamp("us"),
        LType.STRING: pa.string(),
    }
    return pa.schema([pa.field(f.name, m[f.ltype], nullable=f.nullable)
                      for f in schema.fields])


def _coerce(table: pa.Table, schema: pa.Schema) -> pa.Table:
    """``table`` in the types of ``schema``.  A dictionary-encoded column of
    the field's type stays encoded, so that a bulk load of codes never
    becomes a string a row; ``_concat`` decodes where such a region meets
    one of plain strings."""
    if table.schema == schema:
        return table
    cols, fields = [], []
    for f in schema:
        if f.name not in table.column_names:
            c = pa.nulls(table.num_rows, f.type)
        else:
            c = table.column(f.name)
            if not (pa.types.is_dictionary(c.type) and c.type.value_type == f.type):
                c = c.cast(f.type)
        cols.append(c)
        fields.append(pa.field(f.name, c.type, nullable=f.nullable))
    return pa.table(cols, schema=pa.schema(fields))


def _plain(table: pa.Table) -> pa.Table:
    """``table`` with every dictionary-encoded column decoded."""
    if not any(pa.types.is_dictionary(t) for t in table.schema.types):
        return table
    return table.cast(pa.schema([
        pa.field(f.name, f.type.value_type if pa.types.is_dictionary(f.type) else f.type,
                 nullable=f.nullable) for f in table.schema]))


def _concat(tables: list) -> pa.Table:
    """``pa.concat_tables`` of region tables, some of whose string columns
    may be dictionary-encoded (``_coerce``): decoded where they differ."""
    if all(t.schema == tables[0].schema for t in tables[1:]):
        return pa.concat_tables(tables)
    return pa.concat_tables([_plain(t) for t in tables])


def _zone_scalar(x, ltype):
    """Normalize a zone-map bound or predicate literal to one comparable
    number in the COLUMN's unit (DATE: epoch days; DATETIME/TIMESTAMP: epoch
    seconds; numerics: as-is).  None = unbounded/incomparable — pruning
    treats it as 'keep the region'.  The JAX store's function of the same
    name, copied."""
    if x is None:
        return None
    if isinstance(x, str):
        try:
            if ltype is LType.DATE:
                d = datetime.date.fromisoformat(x[:10])
                return (d - datetime.date(1970, 1, 1)).days
            if ltype.is_temporal:
                dt = datetime.datetime.fromisoformat(x)
                return dt.replace(tzinfo=datetime.timezone.utc).timestamp()
        except ValueError:
            return None
        return None
    if isinstance(x, datetime.datetime):
        return x.replace(tzinfo=datetime.timezone.utc).timestamp()
    if isinstance(x, datetime.date):
        if ltype.is_temporal and ltype is not LType.DATE:
            return datetime.datetime(x.year, x.month, x.day,
                                     tzinfo=datetime.timezone.utc).timestamp()
        return (x - datetime.date(1970, 1, 1)).days
    if isinstance(x, bool) or isinstance(x, (int, float)):
        if ltype is LType.DATE and isinstance(x, int):
            return x                       # already epoch days
        return x
    return None


class Region:
    """One row-range shard of a table: its rows, their rowids and their
    MVCC commit stamps (int64, aligned with the rows; 0 = visible to every
    snapshot).  The arrays are replaced, never written in place, so a
    transaction's pre-image is a set of references.  ``part`` is the table
    partition the region holds (-1: unpartitioned, or unknown)."""

    __slots__ = ("region_id", "data", "rowids", "_cts", "_cts_max", "version", "part")

    def __init__(self, region_id: int, data: pa.Table, rowids=None, cts=None,
                 part: int = -1):
        n = data.num_rows
        self.region_id = region_id
        self.part = part
        self.data = data
        self.rowids = np.zeros(n, np.int64) if rowids is None else rowids
        self.cts = np.zeros(n, np.int64) if cts is None else cts
        self.version = 1

    @property
    def num_rows(self) -> int:
        return self.data.num_rows

    @property
    def cts(self) -> np.ndarray:
        return self._cts

    @cts.setter
    def cts(self, v: np.ndarray) -> None:
        self._cts = v
        self._cts_max = None

    def cts_max(self) -> int:
        """The newest stamp in the region (PENDING while a transaction's rows
        are in it), cached until the stamps are replaced."""
        if self._cts_max is None:
            self._cts_max = int(self._cts.max()) if len(self._cts) else 0
        return self._cts_max


class TxnContext:
    """One table's open-transaction state: the writer lease, buffered
    row-tier writes with row locks (rowstore.Txn), and the region pre-image
    references plus the MVCC history length for rollback."""

    def __init__(self, store: "TableStore"):
        self.store = store
        self.row_txn: Txn = store.row_table.begin()
        self._snap = None
        self._mvcc_pre = None

    def _capture(self):
        """Called by the store (under its lock) before the first mutation."""
        if self._snap is None:
            st = self.store
            self._snap = (list(st.regions),
                          [(r, r.data, r.rowids, r.cts, r.version) for r in st.regions])
            self._mvcc_pre = st._mvcc.capture()

    def commit(self, commit_ts: int | None = None):
        """``commit_ts``: the decide-time MVCC stamp (commit_group passes one
        for the whole transaction); None allocates one for this table."""
        try:
            if self.store.replicated is not None:
                # a replicated table's write set becomes raft proposals (1PC
                # in one region, primary-first 2PC across regions); the local
                # buffer only held the row locks
                ops = self.row_txn.pending_ops()
                self.row_txn.rollback()
                try:
                    self.store.replicated.write_ops(ops)
                except Exception:
                    # quorum lost at COMMIT: the regions already hold this
                    # transaction's statements, so restore the pre-image
                    self._restore_preimage()
                    raise
            elif self.store.wal_path is not None:
                self.row_txn.commit()   # one atomic WAL batch + flush
            else:
                # non-durable store: nothing reads the buffered rows; the
                # row locks are released
                self.row_txn.rollback()
            self._stamp_commit(commit_ts)
        finally:
            # the lease goes even on a failed WAL write, or every later
            # statement on this table would conflict
            self.store._end_txn(self)

    def _stamp_commit(self, commit_ts: int | None = None):
        """Replace this transaction's PENDING stamps with the decide-time
        commit_ts, after the write is durable and before the lease goes."""
        if not FLAGS.mvcc:
            return
        st = self.store
        with st._lock:
            if commit_ts is None:
                commit_ts = st._mvcc_ts()
            st._mvcc.restamp_pending(st.regions, int(commit_ts))
            st._mvcc_maybe_gc(int(commit_ts))

    def _restore_preimage(self):
        st = self.store
        with st._lock:
            if self._snap is not None:
                regions, states = self._snap
                st.regions = list(regions)
                for r, data, rowids, cts, version in states:
                    r.data = data
                    r.rowids = rowids
                    r.cts = cts
                    # versions stay monotonic: a stale cache never aliases
                    # a rolled-back state
                    r.version = max(r.version, version) + 1
                st._bump()
                st._pk_stale = True
                st._distinct = {}
            if self._mvcc_pre is not None:
                st._mvcc.restore(self._mvcc_pre)

    def rollback(self):
        self.row_txn.rollback()
        self._restore_preimage()
        self.store._end_txn(self)


def commit_group(tctxs: list[TxnContext]) -> None:
    """Commit several tables' buffered writes as one transaction: one
    decide-time commit timestamp for all of them, so a snapshot sees all of
    the transaction or none of it.  Two or more replicated tables of one
    kind (the in-process fleet's, or the daemon plane's) commit through one
    primary-first 2PC over every region group they touch: either every
    table's writes replicate or none do, and on failure every table's
    regions return to their pre-image."""
    from .remote_tier import RemoteRowTier, write_ops_atomic_remote
    from .replicated import ReplicatedRowTier, write_ops_atomic

    commit_ts = None
    if FLAGS.mvcc and tctxs:
        commit_ts = tctxs[0].store._mvcc_ts()
    fleet = [t for t in tctxs if isinstance(t.store.replicated, ReplicatedRowTier)]
    remote = [t for t in tctxs if isinstance(t.store.replicated, RemoteRowTier)]
    others = [t for t in tctxs if t not in fleet and t not in remote]
    groups = [(fleet, write_ops_atomic), (remote, write_ops_atomic_remote)]
    for g_i, (group, atomic) in enumerate(groups):
        if len(group) <= 1:
            others.extend(group)    # nothing to span: per-table commit
            continue
        try:
            pairs = []
            for t in group:
                pairs.append((t.store.replicated, t.row_txn.pending_ops()))
                t.row_txn.rollback()  # the buffer only held the row locks
            try:
                atomic(pairs, commit_ts=commit_ts or 0)
            except Exception:
                for t in group:
                    t._restore_preimage()
                raise
        except BaseException:
            # the remaining tables must not keep their leases and
            # uncommitted region changes: roll them back too
            for t in group:
                t.store._end_txn(t)
            for later_group, _ in groups[g_i + 1:]:
                if len(later_group) > 1:
                    for t in later_group:
                        t.rollback()
                else:
                    others.extend(later_group)
            for t in others:
                t.rollback()
            raise
        for t in group:
            t._stamp_commit(commit_ts)
            t.store._end_txn(t)
    for t in others:
        t.commit(commit_ts=commit_ts)


class TableStore:
    """All regions of one table, their device image, and DML on the host
    tier mirrored into the row tier."""

    RANK = 10   # the table lock is taken first on the write path

    def __init__(self, info: TableInfo, device: torch.device,
                 region_rows: int = DEFAULT_REGION_ROWS, wal_path: str | None = None):
        self.info = info
        self.device = device
        self.region_rows = region_rows
        self.arrow_schema = schema_to_arrow(info.schema)
        # rank 10 — acquired FIRST on the write path; the statically-derived
        # order (tools/lint.py --lock-order), asserted when debug_guards is on
        self._lock = GuardedLock("store.table_lock", rank=self.RANK,
                                 reentrant=True)
        self._mutations = 0
        self._next_region = 1
        self._next_rowid = 1
        # deferred cluster attach (attach_replicated_lazy): the remote
        # tier's full-region pull happens at the first access to
        # ``regions``, so a frontend whose reads all push down never pays it
        self._attach_pending = None
        self._attaching = False
        self.regions: list[Region] = [Region(self._alloc_region_id(),
                                             self.arrow_schema.empty_table())]
        self.wal_path = None
        self.durable_dir: Optional[str] = None   # Parquet checkpoint home
        # the raft-replicated row tier (storage/replicated.py or
        # storage/remote_tier.py) and the cluster-wide rowid range drawn
        # from it (attach_replicated)
        self.replicated = None
        # distributed binlog writer (storage/binlog_regions.py): autocommit
        # DML events join the data's cross-tier 2PC when set; binlog_db is
        # the Database whose per-table retry queue orders them
        self.binlog_sink = None
        self.binlog_db = None
        self._rowid_pool = 0
        self._rowid_pool_left = 0
        self._writer: Optional[TxnContext] = None
        self._auto_incr: Optional[int] = None
        # MVCC (storage/mvcc.py): the history beside the regions; the TSO
        # client and pin registry are the Database's (attach_mvcc), or a
        # process-local oracle made at first stamp
        self._mvcc = mv.MvccState()
        self._tso = None
        self._snap_reg = None
        self._build_row_tier(None)
        pk = info.primary_key()
        self._pk_cols = list(pk.columns) if pk else None
        self._pk_codec = KeyCodec(info.schema, self._pk_cols) if pk else None
        self._pk_index: Optional[dict] = None
        self._pk_stale = True
        # caches, each keyed on the version (or freed when it moves)
        self._device_batch = None        # (version, ColumnBatch)
        self._sharded = None             # (version, Mesh, ShardedBatch)
        self._versioned = None           # ((version, epoch, snap), (batch, n))
        self._stream_chunks = None
        self._stats: tuple = (-1, {})    # (version, {column: stats})
        self._distinct: dict = {}        # string column -> {value: count}
        self._zones: tuple = (-1, {})
        self._sec: tuple = (-1, {})
        # presort permutations: (version, {(kind, *cols): [host, device]})
        self._perm: tuple = (-1, {})
        if wal_path:
            self.attach_wal(wal_path)

    # every data access inside TableStore goes through ``self.regions``
    # (reads, writes, stats, the pk index), so the property is the one
    # place where a deferred cluster attach materializes
    @property
    def regions(self) -> list:
        if self._attach_pending is not None:
            # double-checked under the store lock: concurrent first readers
            # either perform the attach or wait for it (a bare read during
            # the pull would see the empty initial region).  _attach_pending
            # stays set until the pull succeeds; _attaching breaks the
            # same-thread re-entrancy of the replay, which reads .regions
            with self._lock:
                if self._attach_pending is not None and not self._attaching:
                    self._ensure_attached()
        return self._regions

    @regions.setter
    def regions(self, v: list) -> None:
        self._regions = v

    @property
    def attach_pending(self) -> bool:
        """True while the cluster image is deferred (nothing pulled yet)."""
        return self._attach_pending is not None

    def attach_replicated_lazy(self, tier, fs) -> None:
        """Bind to a daemon-plane tier without pulling any rows.  Eligible
        SELECTs push fragments to the store daemons (exec/session
        ``_try_pushdown``); the first access that needs the local image
        (DML, other plans, point lookups) triggers the pull."""
        self.replicated = tier
        self._attach_pending = (tier, fs)

    def _ensure_attached(self) -> None:
        tier, fs = self._attach_pending
        self._attaching = True
        try:
            # re-checked at materialization: another frontend may have
            # flushed cold segments since make_store
            check_cold_readable(tier, fs, self.info.name)
            cold = tier.cold_rows(fs) if fs is not None else None
            self.attach_replicated(tier, cold_rows=cold)
            self._attach_pending = None      # only a complete pull clears it
        finally:
            self._attaching = False

    # -- version ----------------------------------------------------------
    @property
    def version(self) -> int:
        """Monotonic mutation counter: device images, statistics, zone maps
        and chunk sets key on it.  Not derived from region versions: a
        rollback rebuilds regions, and a derived version could revisit an
        old value."""
        with self._lock:
            return self._mutations

    def _bump(self) -> None:
        """A mutation (caller holds the lock): the version moves on and the
        images and the chunk set of the old version are freed now, not at
        the next read."""
        self._mutations += 1
        self._device_batch = None
        self._sharded = None
        self._versioned = None
        self._stream_chunks = None
        self._perm = (-1, {})

    @property
    def num_rows(self) -> int:
        with self._lock:
            return sum(r.num_rows for r in self.regions)

    def snapshot(self) -> pa.Table:
        with self._lock:
            tabs = [r.data for r in self.regions if r.num_rows]
            return _concat(tabs) if tabs else self.arrow_schema.empty_table()

    # -- row tier ---------------------------------------------------------
    def _row_schema(self) -> Schema:
        return Schema((Field(ROWID, LType.INT64, False), Field("__del", LType.BOOL, True))
                      + self.info.schema.fields)

    def _build_row_tier(self, wal_path: str | None):
        self.row_table = RowTable(self._row_schema(), [ROWID], wal_path=wal_path)
        self.wal_path = wal_path

    def attach_wal(self, path: str):
        """Open (and replay) the WAL: the committed deltas since the last
        checkpoint apply over the current regions."""
        self._build_row_tier(path)
        self._replay_hot(self.row_table.scan_rows())

    def attach_replicated(self, tier, cold_rows: Optional[list] = None,
                          hot_rows: Optional[list] = None):
        """Bind this table to its raft-replicated row tier and recover: the
        replicas' committed rows (``hot_rows``, a follower read, or the
        leaders' ``tier.scan_rows()``) replay over the regions as a WAL
        would, from a log that survives any one store.  ``cold_rows``
        (manifest-ordered rows of the cold segments, storage/coldfs.py)
        replay first, the hot tier's newer versions winning per rowid, so a
        SELECT spans hot and cold."""
        self.replicated = tier
        rows = hot_rows if hot_rows is not None else tier.scan_rows()
        if cold_rows:
            merged: dict[int, dict] = {}
            for r in cold_rows:
                merged[int(r[ROWID])] = r
            for r in rows:
                merged[int(r[ROWID])] = r
            rows = [merged[k] for k in sorted(merged)]
        self._replay_hot(rows)

    def _replay_hot(self, rows: list[dict]):
        if rows:
            self._apply_deltas(rows)
        with self._lock:
            for r in rows:
                self._next_rowid = max(self._next_rowid, int(r[ROWID]) + 1)

    def _apply_deltas(self, rows: list[dict]):
        """Replay WAL rows (inserts, updates, ``__del`` markers) over the
        regions: a row whose rowid is present replaces it in place (or
        removes it), the rest append in WAL order."""
        names = [f.name for f in self.arrow_schema]
        with self._lock:
            rids = np.fromiter((int(r[ROWID]) for r in rows), np.int64, len(rows))
            order = np.argsort(rids, kind="stable")
            srids = rids[order]
            seen = np.zeros(len(rows), bool)
            for reg in self.regions:
                if not reg.num_rows:
                    continue
                pos = np.searchsorted(srids, reg.rowids)
                pos = np.minimum(pos, len(srids) - 1)
                hit = srids[pos] == reg.rowids
                if not hit.any():
                    continue
                hit_at = np.nonzero(hit)[0]
                deltas = [rows[int(order[p])] for p in pos[hit_at]]
                seen[order[pos[hit_at]]] = True
                keep = np.ones(reg.num_rows, bool)
                patch_at, patch = [], []
                for off, row in zip(hit_at, deltas):
                    if row.get("__del"):
                        keep[off] = False
                    else:
                        patch_at.append(off)
                        patch.append(row)
                data = reg.data
                if patch:
                    repl = pa.table({n: [r.get(n) for r in patch] for n in names},
                                    schema=self.arrow_schema)
                    idx = np.arange(reg.num_rows, dtype=np.int64)
                    idx[np.asarray(patch_at)] = reg.num_rows + np.arange(len(patch))
                    data = _concat([data, repl]).take(pa.array(idx))
                reg.data = data.filter(pa.array(keep)).combine_chunks()
                reg.rowids = reg.rowids[keep]
                reg.cts = reg.cts[keep]
                reg.version += 1
            if self.partition_spec() is not None:
                # a replayed UPDATE of the partition column moves its row
                self._rehome_partition_rows()
            appends = [r for r, s in zip(rows, seen) if not s and not r.get("__del")]
            if appends:
                rowids = np.asarray([int(r[ROWID]) for r in appends], np.int64)
                self._append_table(pa.table({n: [r.get(n) for r in appends] for n in names},
                                            schema=self.arrow_schema),
                                   rowids, np.zeros(len(appends), np.int64))
            self._bump()
            self._pk_stale = True
            self._distinct = {}

    def checkpoint(self, directory: str):
        """Flush the live state to Parquet and reset the WAL."""
        with self._lock:
            self.save_parquet(directory)
            self._reset_wal()

    def _reset_wal(self):
        path = self.wal_path
        if path and os.path.exists(path):
            self.row_table = None
            os.remove(path)
        self._build_row_tier(path)

    def _write_hot(self, recs: list[dict], tctx: Optional[TxnContext]):
        if not recs:
            return
        if tctx is not None:
            # in-transaction rows always buffer: that is where the row locks
            # live; a non-durable store drops the buffer at commit
            tctx.row_txn.put_rows(recs)
            return
        if self.wal_path is None and self.replicated is None:
            return      # non-durable autocommit: nothing would read it
        kc, rc = self.row_table.key_codec, self.row_table.row_codec
        keys = kc.encode_rows([np.fromiter((r[ROWID] for r in recs), np.int64, len(recs))],
                              [None])
        ops = [(0, k, rc.encode(rec)) for k, rec in zip(keys, recs)]
        if self.replicated is not None:
            # autocommit DML on a replicated table: the batch quorum-commits
            # before the regions change (the 1PC path); no quorum fails the
            # statement
            if self.binlog_sink is None:
                self.replicated.write_ops(ops)
            else:
                self._write_with_binlog(recs, ops)
            return
        self.row_table.write_batch(ops)

    def _write_with_binlog(self, recs: list[dict], ops: list) -> None:
        """Autocommit DML of a binlogged remote table: the change event
        rides the data's own cross-tier 2PC (storage/binlog_regions.py), so
        it exists iff the data committed.  This table's retry lock is held
        across the drain-check and the append: queued events of earlier
        (transaction-path) commits land first, or, while this table's
        binlog region is still down, this event queues behind them."""
        from .binlog_regions import DistributedBinlog

        sink, guard = self.binlog_sink, self.binlog_db
        table_key = f"{self.info.database}.{self.info.name}"
        events = DistributedBinlog.events_of(recs)
        if guard is None:
            sink.write_with_data(self.replicated, ops, table_key, events)
            return
        rq = guard.binlog_retry_queue(table_key)
        with rq.mu:
            if rq.q:
                guard._drain_rq_locked(rq, table_key, sink)
            if rq.q:
                # the region is still down: commit the data and queue the
                # event behind the older batch (the transaction path's
                # discipline, session._flush_txn_binlog)
                self.replicated.write_ops(ops)
                guard._queue_rq_locked(rq, events)
                return
            sink.write_with_data(self.replicated, ops, table_key, events)

    def _bulk_ops(self, table: pa.Table, rowids: np.ndarray) -> Optional[list]:
        """A bulk load's row-tier writes, encoded a column at a time (the
        bytes ``_write_hot`` would write), or None where a column is a
        string, a temporal one or partly NULL."""
        cols: dict = {ROWID: rowids, "__del": None}
        for f in self.arrow_schema:
            c = table.column(f.name)
            if c.null_count == len(c):
                cols[f.name] = None
            elif c.null_count:
                return None
            else:
                cols[f.name] = c.to_numpy()
        vals = self.row_table.row_codec.encode_columns(cols, len(rowids))
        if vals is None:
            return None
        keys = self.row_table.key_codec.encode_rows([rowids], [None])
        return [(0, k, v) for k, v in zip(keys, vals)]

    # -- transactions -----------------------------------------------------
    def begin_txn(self) -> TxnContext:
        with self._lock:
            if self._writer is not None:
                raise ConflictError(f"table {self.info.name} locked by an open transaction")
            tctx = TxnContext(self)
            self._writer = tctx
            return tctx

    def _end_txn(self, tctx: TxnContext):
        with self._lock:
            if self._writer is tctx:
                self._writer = None

    def _writer_check(self, tctx: Optional[TxnContext]):
        """Statement-level write admission: an open transaction holds the
        table's writer lease, and another writer conflicts.  A deferred
        cluster image is pulled first: pulled after the write, it would
        already hold the written rows and the write would add them again
        (the JAX package's ``load_arrow`` into an unattached table does)."""
        if self._attach_pending is not None:
            self.regions    # noqa: B018 — the property pulls the image
        if self._writer is not None and self._writer is not tctx:
            raise ConflictError(f"table {self.info.name} locked by an open transaction")
        if tctx is not None:
            tctx._capture()

    # -- MVCC (storage/mvcc.py) ------------------------------------------
    def attach_mvcc(self, runtime) -> None:
        """Share the Database's MVCC plane: one TSO client and one pin
        registry across every table, so commit order is one total order."""
        self._tso = runtime.tso
        self._snap_reg = runtime.snapshots

    def _mvcc_ts(self) -> int:
        if self._tso is None:
            self._tso = mv.TsoClient()
        return self._tso.next_ts()

    def _new_stamp(self, tctx) -> int:
        """The commit stamp of rows appended now: PENDING inside a
        transaction (restamped at commit), a fresh ts in autocommit, 0 with
        MVCC off."""
        if not FLAGS.mvcc:
            return 0
        return mv.PENDING if tctx is not None else self._mvcc_ts()

    def _dead_stamp(self, tctx) -> int:
        return mv.PENDING if tctx is not None else self._mvcc_ts()

    def _mvcc_maybe_gc(self, now_ts: int, threshold: int = 512) -> None:
        """Commit-seam sweep once the history holds ``threshold`` versions
        (caller holds the table lock; the registry lock nests inside it)."""
        if self._mvcc.history_rows() < threshold:
            return
        wm = self._snap_reg.watermark(now_ts) if self._snap_reg is not None else now_ts
        self._mvcc.gc(self.regions, wm)

    def mvcc_gc(self, watermark: int) -> int:
        with self._lock:
            return self._mvcc.gc(self.regions, int(watermark))

    def mvcc_needs_versioned(self, snap_ts: int) -> bool:
        """True when a read pinned at ``snap_ts`` cannot be served by the
        current image: a commit (or a pending write) landed after it, or a
        version alive at it has since died."""
        snap_ts = int(snap_ts)
        with self._lock:
            return self._mvcc.any_alive(snap_ts) or \
                any(r.cts_max() > snap_ts for r in self.regions)

    def versioned_batch(self, snap_ts: int):
        """The device batch of a read pinned at ``snap_ts``: the live image
        and the history versions alive at it, with ``visibility_mask`` ANDed
        into ``sel`` on the device -> ``(batch, versions_scanned)``; None
        when the current image already equals the snapshot (its fast paths
        stay).  The live part is the cached device image; the history and
        the stamps are staged beside it.  Cached per (version, MVCC epoch,
        snapshot), one entry."""
        snap_ts = int(snap_ts)
        with self._lock:
            if not self.mvcc_needs_versioned(snap_ts):
                return None
            key = (self._mutations, self._mvcc.epoch, snap_ts)
            if self._versioned is not None and self._versioned[0] == key:
                return self._versioned[1]
            self._versioned = None            # free the old one first
            live = self._image()
            # the stamps of this instant (a commit replaces the arrays)
            stamps = [(r.cts, r.cts_max()) for r in self.regions if r.num_rows]
            hist = self._mvcc.versions_at(snap_ts)
        dev = self.device
        cts = [torch.zeros(len(c), dtype=torch.int64, device=dev) if mx == 0
               else torch.from_numpy(c).to(dev) for c, mx in stamps]
        dts = [torch.full((len(live),), mv.MAX_TS, dtype=torch.int64, device=dev)]
        parts = [live]
        for rows, hc, hd in hist:
            parts.append(ColumnBatch.from_arrow(rows, dev))
            cts.append(torch.from_numpy(hc).to(dev))
            dts.append(torch.full((len(hc),), hd, dtype=torch.int64, device=dev))
        b = _concat_versions(parts) if len(parts) > 1 else live
        cts_t = torch.cat(cts) if cts else torch.zeros(0, dtype=torch.int64, device=dev)
        mask = mv.visibility_mask(cts_t, torch.cat(dts), snap_ts)
        out = (b.and_sel(mask), sum(len(hc) for _, hc, _ in hist))
        with self._lock:
            if (self._mutations, self._mvcc.epoch, snap_ts) == key:
                self._versioned = (key, out)
        return out

    # -- reads ------------------------------------------------------------
    def _alloc_region_id(self) -> int:
        rid = self._next_region
        self._next_region += 1
        return rid

    def _alloc_rowids(self, n: int) -> np.ndarray:
        """Rowids: a replicated table draws cluster-wide ranges from the
        meta service (at least 512 at a time; a burnt remainder is never
        reused), so two frontends over one fleet never mint the same one;
        any other table counts up locally."""
        if self.replicated is not None:
            if self._rowid_pool_left < n:
                grab = max(n, 512)
                self._rowid_pool = self.replicated.alloc_rowids(grab, floor=self._next_rowid)
                self._rowid_pool_left = grab
            start = self._rowid_pool
            self._rowid_pool += n
            self._rowid_pool_left -= n
            self._next_rowid = max(self._next_rowid, start + n)
            return np.arange(start, start + n, dtype=np.int64)
        start = self._next_rowid
        self._next_rowid += n
        return np.arange(start, start + n, dtype=np.int64)

    def device_table_batch(self) -> ColumnBatch:
        """Whole-table batch on the store's device with table-wide string
        dictionaries, cached per version."""
        with self._lock:
            return self._image()

    def _image(self) -> ColumnBatch:
        """``device_table_batch`` with the lock held."""
        v = self._mutations
        if self._device_batch is None or self._device_batch[0] != v:
            self._device_batch = None     # free the old image first
            self._device_batch = (v, ColumnBatch.from_arrow(self.snapshot(), self.device))
        return self._device_batch[1]

    def sharded_batch(self, mesh):
        """The table row-sharded across ``mesh`` (parallel/mesh.shard_batch),
        cached per version and mesh beside the device image."""
        from ..parallel.mesh import shard_batch

        with self._lock:
            v = self._mutations
            hit = self._sharded
            if hit is None or hit[0] != v or hit[1] != mesh:
                self._sharded = None          # free the old shards first
                self._sharded = (v, mesh, shard_batch(self._image(), mesh))
            return self._sharded[2]

    def release(self) -> None:
        """Drop the device image, its sharded and versioned copies and the
        chunk set (DROP TABLE / DATABASE)."""
        with self._lock:
            self._device_batch = None
            self._sharded = None
            self._versioned = None
            self._stream_chunks = None
            self._perm = (-1, {})

    def _cache(self, name: str) -> dict:
        """A per-version cache dict (``_stats``, ``_zones``, ``_sec``)."""
        v, d = getattr(self, name)
        if v != self._mutations:
            d = {}
            setattr(self, name, (self._mutations, d))
        return d

    def column_stats(self, column: str) -> "ColumnStats":
        """Host-side statistics for planner decisions, with the JAX
        package's values: ``dict_size`` for strings (the number of distinct
        values, which is the size of the image's dictionary), ``min``/``max``
        for integer, BOOL and DATE columns, and the histogram/MCV/ndv payload
        of index/stats.  Cached per version.  The bounds are computed at
        once and cheaply (the distinct count is kept up to date across
        writes); the histogram payload when a planner first reads it."""
        with self._lock:
            cache = self._cache("_stats")
            if column in cache:
                return cache[column]
            data = self.snapshot()
            f = self.info.schema.field(column)
            bounds: dict = {}
            if f.ltype is LType.STRING:
                bounds["dict_size"] = self._distinct_count(column)
        col = data.column(column)
        if f.ltype is not LType.STRING and data.num_rows:
            mm = pc.min_max(col).as_py()
            mn, mx = mm["min"], mm["max"]
            if hasattr(mn, "toordinal") and not hasattr(mn, "hour"):
                epoch = datetime.date(1970, 1, 1)
                mn, mx = (mn - epoch).days, (mx - epoch).days
            if isinstance(mn, int) or f.ltype.is_integer or f.ltype is LType.DATE:
                bounds["min"], bounds["max"] = mn, mx
        st = ColumnStats(bounds, lambda: _histogram_stats(col, f))
        with self._lock:
            self._cache("_stats")[column] = st
        return st

    # -- distinct values of string columns, kept across writes ---------------
    def _distinct_count(self, column: str) -> int:
        """How many distinct non-NULL values ``column`` holds (caller holds
        the lock).  Counted once from the snapshot, then kept by every write
        (``_distinct_move``), so a write costs its own rows, not the table."""
        tr = self._distinct.get(column)
        if tr is None:
            col = self.snapshot().column(column)
            if pa.types.is_dictionary(col.type):
                # one dictionary across regions, which may hold one value
                # under two codes: the counts add up by value
                vc = pc.value_counts(col.combine_chunks())
                tr = {}
                for v, k in zip(vc.field("values").to_pylist(), vc.field("counts").to_pylist()):
                    tr[v] = tr.get(v, 0) + k
            else:
                vc = pc.value_counts(col)
                tr = dict(zip(vc.field("values").to_pylist(), vc.field("counts").to_pylist()))
            tr.pop(None, None)
            self._distinct[column] = tr
        return len(tr)

    def _distinct_move(self, removed: Optional[pa.Table], added: Optional[pa.Table]) -> None:
        for column, tr in self._distinct.items():
            if removed is not None:
                for v in removed.column(column).to_pylist():
                    if v is not None:
                        n = tr[v] - 1
                        if n:
                            tr[v] = n
                        else:
                            del tr[v]
            if added is not None:
                for v in added.column(column).to_pylist():
                    if v is not None:
                        tr[v] = tr.get(v, 0) + 1

    def snapshot_stats(self, column: str, snap_ts: int) -> dict:
        """``column_stats`` for a read pinned at ``snap_ts``.  When that read
        takes the versioned batch, the value bounds the planner's dense
        GROUP BY relies on widen to that batch: a string column's dictionary
        size is the merged dictionary's (the history may hold strings the
        live rows no longer do), an integer column's min / max cover the
        history rows."""
        st = self.column_stats(column)
        got = self.versioned_batch(snap_ts)
        if got is None:
            return st
        bounds = {k: dict.__getitem__(st, k) for k in ColumnStats.BOUNDS
                  if dict.__contains__(st, k)}
        c = got[0].column(column)
        if c.ltype is LType.STRING:
            bounds["dict_size"] = 0 if c.dictionary is None else len(c.dictionary)
        elif bounds.get("min") is not None and len(c):
            d = c.data if c.validity is None else c.data[c.validity]
            if len(d):
                bounds["min"] = min(bounds["min"], int(d.min()))
                bounds["max"] = max(bounds["max"], int(d.max()))
        return ColumnStats(bounds, st.payload)

    def next_auto_incr(self, col: str, n: int) -> list[int]:
        """n consecutive AUTO_INCREMENT ids (monotonic; a rolled-back range
        is never reused)."""
        with self._lock:
            if self._auto_incr is None:
                mx = 0
                for r in self.regions:
                    if r.num_rows:
                        m = pc.max(r.data.column(col)).as_py()
                        if m is not None:
                            mx = max(mx, int(m))
                self._auto_incr = mx
            start = self._auto_incr + 1
            self._auto_incr += n
            return list(range(start, start + n))

    # -- access paths (index/selector.py chooses) -------------------------
    def zone_map_column(self, column: str):
        """Per-region (min, max, has_null) of a numeric or temporal column,
        None for a region without rows; None for a type that cannot range-
        prune.  Cached per version."""
        f = self.info.schema.field(column)
        if not (f.ltype.is_integer or f.ltype.is_float
                or f.ltype is LType.DATE or f.ltype.is_temporal):
            return None
        with self._lock:
            cache = self._cache("_zones")
            if column in cache:
                return cache[column]
            zones = []
            for r in self.regions:
                if not r.num_rows:
                    zones.append(None)
                    continue
                col = r.data.column(column)
                if col.null_count == len(col):
                    zones.append((None, None, True))
                    continue
                mm = pc.min_max(col).as_py()
                zones.append((_zone_scalar(mm["min"], f.ltype),
                              _zone_scalar(mm["max"], f.ltype), col.null_count > 0))
            cache[column] = zones
            return zones

    def prune_regions(self, ranges: dict):
        """Regions whose zone maps can satisfy every closed [lo, hi]
        constraint -> (kept region indexes, regions with rows).  Any
        uncertainty keeps the region."""
        with self._lock:
            keep = []
            for i, r in enumerate(self.regions):
                if not r.num_rows:
                    continue
                alive = True
                for col, (lo, hi) in ranges.items():
                    zones = self.zone_map_column(col)
                    if zones is None or zones[i] is None:
                        continue
                    zmin, zmax, _ = zones[i]
                    if zmin is None:              # all-NULL region: no row
                        alive = False             # passes a comparison
                        break
                    lt = self.info.schema.field(col).ltype
                    lo_c, hi_c = _zone_scalar(lo, lt), _zone_scalar(hi, lt)
                    try:
                        if (lo_c is not None and zmax < lo_c) or \
                                (hi_c is not None and zmin > hi_c):
                            alive = False
                            break
                    except TypeError:
                        continue                  # incomparable literal: keep
                if alive:
                    keep.append(i)
            return keep, sum(1 for r in self.regions if r.num_rows)

    def regions_table(self, keep: list[int]) -> pa.Table:
        with self._lock:
            tabs = [self.regions[i].data for i in keep]
            return _concat(tabs) if tabs else self.arrow_schema.empty_table()

    # -- presort permutations (the session's walk over plan.presort) -------
    def sort_permutation(self, cols: tuple) -> np.ndarray:
        """Host permutation (int32) sorting the device image's ``cols`` packed
        as the join kernels pack them (one column as is; two as
        ``k0 << 32 | k1 & 0xFFFFFFFF``), stably: the build side of a join
        over the whole table then needs no device sort.  Cached per
        version."""
        def compute(host):
            arrs = [d.astype(np.int64) for d, _ in host]
            keys = arrs[0] if len(arrs) == 1 else \
                (arrs[0] << 32) | (arrs[1] & 0xFFFFFFFF)
            return np.argsort(keys, kind="stable")
        return self._presort("join", cols, compute)

    def agg_sort_permutation(self, cols: tuple) -> np.ndarray:
        """Host permutation (int32) with ``group_aggregate_sorted``'s key
        order exactly (0 under a NULL lane, a stable sort per key from the
        last, NULLs first): the sorted GROUP BY then keeps only its liveness
        partition on the device.  Cached per version."""
        def compute(host):
            perm = np.arange(len(host[0][0]) if host else 0)
            for d, vmask in reversed(host):
                if d.dtype == np.bool_:
                    d = d.astype(np.int32)
                if vmask is not None:
                    d = np.where(vmask, d, np.zeros((), d.dtype))
                perm = perm[np.argsort(d[perm], kind="stable")]
                if vmask is not None:
                    perm = perm[np.argsort(vmask[perm], kind="stable")]
            return perm
        return self._presort("agg", cols, compute)

    def presort_order(self, kind: str, cols: tuple, version: int):
        """The device copy of the ``kind`` ("join" or "agg") permutation of
        ``cols`` for the image at ``version``, uploaded once per version
        (outside the lock); None once the table has moved past
        ``version``."""
        ck = (kind,) + tuple(cols)
        (self.sort_permutation if kind == "join" else self.agg_sort_permutation)(cols)
        with self._lock:
            entry = self._perm[1].get(ck) if self._perm[0] == version else None
            if entry is None or entry[1] is not None:
                return None if entry is None else entry[1]
            host = entry[0]
        dev = torch.from_numpy(host).to(self.device)
        with self._lock:
            entry = self._perm[1].get(ck) if self._perm[0] == version else None
            if entry is None:
                return None
            if entry[1] is None:
                entry[1] = dev
            return entry[1]

    def _presort(self, kind: str, cols: tuple, compute) -> np.ndarray:
        """The cached permutation, or ``compute`` over the key columns'
        (data, validity) arrays.  They are read off the device image outside
        the lock (a blocking copy under it would stall every writer), one
        ``.cpu()`` each; the result is kept only while the table still sits
        at the version it was read at, so a permutation over older data
        never serves newer."""
        ck = (kind,) + tuple(cols)
        with self._lock:
            v = self._mutations
            if self._perm[0] != v:
                self._perm = (v, {})
            hit = self._perm[1].get(ck)
            if hit is not None:
                return hit[0]
            batch = self._image()
        host = []
        for c in cols:
            col = batch.column(c)
            host.append((col.data.cpu().numpy(),
                         None if col.validity is None else col.validity.cpu().numpy()))
        perm = compute(host).astype(np.int32)
        with self._lock:
            if self._perm[0] == v and self._mutations == v:
                self._perm[1][ck] = [perm, None]
        return perm

    def _secondary_order(self, column: str):
        """(sorted values, row positions) over the snapshot, NULLs excluded;
        cached per version."""
        with self._lock:
            cache = self._cache("_sec")
            if column in cache:
                return cache[column]
            col = self.snapshot().column(column)
            if self.info.schema.field(column).ltype is LType.STRING:
                vals = np.asarray(col.to_pylist(), dtype=object)
            else:
                vals = col.to_numpy(zero_copy_only=False)
            if col.null_count:
                mask = ~np.asarray(col.is_null())
                pos = np.nonzero(mask)[0]
                vals = vals[mask]
            else:
                pos = np.arange(len(vals))
            order = np.argsort(vals, kind="stable")
            cache[column] = (vals[order], pos[order])
            return cache[column]

    def secondary_count(self, column: str, value):
        """How many rows have column = value (None if unindexable)."""
        try:
            svals, _ = self._secondary_order(column)
        except Exception:       # noqa: BLE001 — an unsortable column: no index path
            return None
        # a literal the column's values cannot be compared with raises here,
        # as in the JAX package: the EXPLAIN annotation swallows it (no
        # access=), and execution falls back to the full scan
        return int(np.searchsorted(svals, value, "right")
                   - np.searchsorted(svals, value, "left"))

    def secondary_positions(self, column: str, value) -> np.ndarray:
        svals, spos = self._secondary_order(column)
        lo = np.searchsorted(svals, value, "left")
        hi = np.searchsorted(svals, value, "right")
        return np.sort(spos[lo:hi])

    def secondary_scan(self, column: str, value) -> pa.Table:
        """Rows with column = value, positions and snapshot taken under one
        lock (a write between them would gather from another table)."""
        with self._lock:
            return self.snapshot().take(self.secondary_positions(column, value))

    def point_lookup(self, values: dict):
        """Primary-key point read from the host tier -> row dict or None."""
        if self._pk_codec is None:
            return None
        one = {n: pa.array([values[n]]).cast(self.arrow_schema.field(n).type)
               for n in self._pk_cols}
        key = self._encode_pk_table(pa.table(one))[0]
        with self._lock:
            rid = self._ensure_pk_index().get(key)
            if rid is None:
                return None
            for r in self.regions:
                hit = np.nonzero(r.rowids == rid)[0]
                if hit.size:
                    return r.data.slice(int(hit[0]), 1).to_pylist()[0]
        return None

    # -- table partitions (the reference's range / hash partitions in
    # SchemaInfo, schema_factory.h:427-533; PartitionAnalyze prunes) ------
    def partition_spec(self) -> Optional[dict]:
        """{"kind": "range", "column": c, "names": [...], "uppers": [...]}
        (a last upper of None is MAXVALUE), {"kind": "hash", "column": c,
        "n": N}, or None."""
        return (self.info.options or {}).get("partition")

    @staticmethod
    def _norm_part_scalar(v, f):
        """One partition-column literal -> a comparable value (temporal to
        its epoch integer, everything else as it is)."""
        if v is None or not f.ltype.is_temporal:
            return v
        if isinstance(v, str):
            from ..expr.compile import parse_temporal

            return parse_temporal(v, f.ltype)
        if isinstance(v, datetime.datetime):
            return int((v - datetime.datetime(1970, 1, 1)).total_seconds() * 1e6)
        if isinstance(v, datetime.date):
            return (v - datetime.date(1970, 1, 1)).days
        return v

    @staticmethod
    def _norm_part_array(arr, f) -> np.ndarray:
        if f.ltype is LType.DATE:
            return np.asarray(arr.cast(pa.int32()).to_numpy(zero_copy_only=False), np.int64)
        if f.ltype.is_temporal:
            return np.asarray(arr.cast(pa.timestamp("us")).cast(pa.int64())
                              .to_numpy(zero_copy_only=False), np.int64)
        if f.ltype is LType.STRING:
            return np.asarray(arr.to_pylist(), dtype=object)
        return arr.to_numpy(zero_copy_only=False)

    def partition_ids(self, table: pa.Table) -> np.ndarray:
        """The partition id of each row.  A value past the last range bound
        of a table without MAXVALUE raises MySQL's "no partition for value".
        NULL keys route to partition 0 (MySQL's lowest partition); no
        comparison matches NULL, so pruning stays correct."""
        spec = self.partition_spec()
        f = self.info.schema.field(spec["column"])
        arr = table.column(spec["column"])
        null_mask = np.asarray(arr.is_null()) if arr.null_count else None
        if null_mask is not None:
            if f.ltype is LType.STRING:
                fill = ""
            elif f.ltype is LType.DATE:
                fill = datetime.date(1970, 1, 1)
            elif f.ltype.is_temporal:
                fill = datetime.datetime(1970, 1, 1)
            else:
                fill = 0
            arr = pc.fill_null(arr, fill)
        vals = self._norm_part_array(arr, f)
        if spec["kind"] == "hash":
            n = int(spec["n"])
            if vals.dtype == object:
                pids = np.fromiter((_fnv64(str(v).encode()) % n for v in vals),
                                   dtype=np.int64, count=len(vals))
            else:
                pids = (vals.astype(np.int64) % n + n) % n
            if null_mask is not None:
                pids[null_mask] = 0
            return pids
        uppers = [self._norm_part_scalar(u, f) for u in spec["uppers"]]
        has_max = bool(uppers) and uppers[-1] is None
        finite = np.array([u for u in uppers if u is not None],
                          dtype=object if vals.dtype == object else None)
        pids = np.searchsorted(finite, vals, side="right")
        if null_mask is not None:
            pids[null_mask] = 0
        if not has_max and len(finite):
            over = pids >= len(finite)
            if null_mask is not None:
                over = over & ~null_mask
            if over.any():
                raise ValueError(f"table {self.info.name!r} has no partition for value "
                                 f"{vals[over][0]!r} in column {spec['column']!r}")
        return pids

    def partitions_for(self, eq_value=None, range_=None) -> Optional[set]:
        """The partition ids a predicate on the partition column can touch,
        or None when it cannot prune (a range on a hash partitioning)."""
        spec = self.partition_spec()
        if spec is None:
            return None
        f = self.info.schema.field(spec["column"])
        if eq_value is not None:
            t = pa.table({spec["column"]: pa.array([eq_value]).cast(
                self.arrow_schema.field(spec["column"]).type)})
            try:
                return {int(self.partition_ids(t)[0])}
            except ValueError:
                return set()          # a value past every bound matches none
        if spec["kind"] != "range" or range_ is None:
            return None
        lo, hi = range_
        finite = [u for u in (self._norm_part_scalar(u, f) for u in spec["uppers"])
                  if u is not None]
        nparts = len(spec["uppers"])
        lo_n = self._norm_part_scalar(lo, f) if lo is not None else None
        hi_n = self._norm_part_scalar(hi, f) if hi is not None else None
        # the selector's ranges are closed ([lo, hi]): the partition that
        # holds hi itself stays (bisect_right routes as partition_ids does)
        first = bisect.bisect_right(finite, lo_n) if lo_n is not None else 0
        last = bisect.bisect_right(finite, hi_n) if hi_n is not None else nparts - 1
        return set(range(first, min(last, nparts - 1) + 1))

    def _rehome_partition_rows(self, only_ids: Optional[set] = None) -> None:
        """Move rows whose partition-column value no longer matches their
        region's tag into their partition's regions (after an UPDATE; the
        caller holds the lock and has checked that every row routes).
        ``only_ids``: id()s of the regions the update staged, the only ones
        that can hold moved rows."""
        moved_tabs, moved_ids, moved_cts = [], [], []
        for r in self.regions:
            if r.part < 0 or not r.num_rows or (only_ids is not None
                                                and id(r) not in only_ids):
                continue
            wrong = self.partition_ids(r.data) != r.part
            if not wrong.any():
                continue
            moved_tabs.append(r.data.filter(pa.array(wrong)))
            moved_ids.append(r.rowids[wrong])
            moved_cts.append(r.cts[wrong])
            r.data = r.data.filter(pa.array(~wrong))
            r.rowids = r.rowids[~wrong]
            r.cts = r.cts[~wrong]
            r.version += 1
        if moved_tabs:
            self._pk_stale = True
            self._append_table(_concat(moved_tabs).combine_chunks(),
                               np.concatenate(moved_ids), np.concatenate(moved_cts),
                               track=False)

    def prune_parts(self, parts: set) -> tuple[list[int], int]:
        """(kept region indexes, as ``regions_table`` addresses them; regions
        with rows): regions of a pruned partition drop; an untagged region
        (part -1) always stays, so pruning is conservative."""
        with self._lock:
            keep = [i for i, r in enumerate(self.regions)
                    if r.num_rows and (r.part == -1 or r.part in parts)]
            return keep, sum(1 for r in self.regions if r.num_rows)

    def lookup_by_pks(self, pk_table: pa.Table) -> pa.Table:
        """Full rows matching the given primary-key values, in table order
        (a missing key is absent): the main-table half of a global index's
        lookup join (the reference's select_manager_node.cpp:1081)."""
        with self._lock:
            if self._pk_codec is None or not pk_table.num_rows:
                return self.snapshot().slice(0, 0)
            wanted = self.pk_rowids(pk_table)
            parts = [r.data.filter(pa.array(np.isin(r.rowids, wanted)))
                     for r in self.regions if r.num_rows]
            parts = [p for p in parts if p.num_rows]
            if not parts:
                return self.snapshot().slice(0, 0)
            return _concat(parts).combine_chunks()

    def pk_rowids(self, pk_table: pa.Table) -> np.ndarray:
        """The rowids of the rows holding the given primary-key values (a
        missing key is absent)."""
        with self._lock:
            idx = self._ensure_pk_index()
            rids = {idx[k] for k in self._encode_pk_table(pk_table) if k in idx}
            return np.fromiter(rids, dtype=np.int64, count=len(rids))

    # -- primary-key index -------------------------------------------------
    def _ensure_pk_index(self):
        if self._pk_codec is None:
            return None
        with self._lock:
            if self._pk_index is None or self._pk_stale:
                idx: dict = {}
                for reg in self.regions:
                    if reg.num_rows:
                        idx.update(zip(self._encode_pk_table(reg.data), reg.rowids.tolist()))
                self._pk_index = idx
                self._pk_stale = False
            return self._pk_index

    def _encode_pk_table(self, table: pa.Table) -> list[bytes]:
        cols, valids = [], []
        for name in self._pk_cols:
            arr = table.column(name)
            f = self.info.schema.field(name)
            if f.ltype is LType.STRING:
                cols.append(np.asarray(arr.to_pylist(), dtype=object))
            elif f.ltype is LType.DATE:
                cols.append(np.asarray(arr.cast(pa.int32()).to_numpy(zero_copy_only=False),
                                       np.int64))
            elif f.ltype.is_temporal:
                cols.append(np.asarray(arr.cast(pa.timestamp("us")).cast(pa.int64())
                                       .to_numpy(zero_copy_only=False), np.int64))
            elif f.ltype.is_float:
                cols.append(arr.to_numpy(zero_copy_only=False))
            else:
                work = arr.fill_null(0) if arr.null_count else arr
                cols.append(np.asarray(work.to_numpy(zero_copy_only=False), np.int64))
            valids.append(~np.asarray(arr.is_null()) if arr.null_count else None)
        return self._pk_codec.encode_rows(cols, valids) if table.num_rows else []

    def _check_duplicates(self, table: pa.Table):
        """INSERT-time primary-key uniqueness -> the new rows' keys."""
        if self._pk_codec is None or not table.num_rows:
            return None
        idx = self._ensure_pk_index()
        keys = self._encode_pk_table(table)
        seen = set()
        for k in keys:
            if k in idx or k in seen:
                raise ConflictError(f"Duplicate entry for key 'PRIMARY' in table "
                                    f"{self.info.name!r}")
            seen.add(k)
        return keys

    # -- writes -----------------------------------------------------------
    def _append_table(self, table: pa.Table, rowids: np.ndarray, cts: np.ndarray,
                      split: bool = True, track: bool = True):
        """Append rows to the last region (a partitioned table: to the last
        region of each row's partition).  ``track``: the rows are new to the
        table (a re-home moves rows the table already holds)."""
        if track:
            # every ingest path moves the AUTO_INCREMENT watermark past
            # explicit ids, so later automatic ids never collide with loaded
            # ones
            self._distinct_move(None, table)
            auto_col = (self.info.options or {}).get("auto_increment")
            if auto_col and auto_col in table.column_names and table.num_rows:
                mx = pc.max(table.column(auto_col)).as_py()
                if mx is not None:
                    self._auto_incr = int(mx) if self._auto_incr is None \
                        else max(self._auto_incr, int(mx))
        if self.partition_spec() is not None:
            # each partition's rows land in that partition's own regions
            pids = self.partition_ids(table)
            for pid in np.unique(pids).tolist():
                m = pids == pid
                reg = next((r for r in reversed(self.regions) if r.part == pid), None)
                if reg is None:
                    reg = Region(self._alloc_region_id(), self.arrow_schema.empty_table(),
                                 part=pid)
                    self.regions.append(reg)
                self._append_to(reg, table.filter(pa.array(m)), rowids[m], cts[m], split)
            return
        self._append_to(self.regions[-1], table, rowids, cts, split)

    def _append_to(self, last: Region, table: pa.Table, rowids: np.ndarray,
                   cts: np.ndarray, split: bool) -> None:
        if last.num_rows:
            last.data = _concat([last.data, table]).combine_chunks()
            last.rowids = np.concatenate([last.rowids, rowids])
            last.cts = np.concatenate([last.cts, cts])
        else:
            last.data, last.rowids, last.cts = table, rowids, cts
        last.version += 1
        if split:
            self._maybe_split(last)
        elif last.data.column(0).num_chunks > 1:
            last.data = last.data.combine_chunks()

    def _maybe_split(self, region: Region):
        """Row-count split into regions of ``region_rows`` rows (zero-copy
        slices of the appended table)."""
        data, rowids, cts = region.data, region.rowids, region.cts
        rr = self.region_rows
        if data.num_rows <= rr:
            if data.num_rows and data.column(0).num_chunks > 1:
                region.data = data.combine_chunks()
            return
        region.data = data.slice(0, rr).combine_chunks()
        region.rowids, region.cts = rowids[:rr], cts[:rr]
        region.version += 1
        for lo in range(rr, data.num_rows, rr):
            self.regions.append(Region(self._alloc_region_id(),
                                       data.slice(lo, rr).combine_chunks(),
                                       rowids[lo:lo + rr], cts[lo:lo + rr],
                                       part=region.part))

    def insert_arrow(self, table: pa.Table, tctx: Optional[TxnContext] = None,
                     check_dups: bool = False):
        """Bulk append (``Session.load_arrow``, a large INSERT ... SELECT):
        the rows land in the regions only, durable at the next checkpoint;
        ``check_dups`` checks the primary key.  One commit stamp for the
        whole load."""
        table = _coerce(table, self.arrow_schema)
        with self._lock:
            self._writer_check(tctx)
            if check_dups:
                self._check_duplicates(table)
            if self.partition_spec() is not None:
                self.partition_ids(table)   # refuse an unroutable row first
            rowids = self._alloc_rowids(table.num_rows)
            if self.replicated is not None:
                # a rebuild from the replicas is a replicated table's only
                # recovery, so the bulk load replicates as one write
                ops = self._bulk_ops(table, rowids) if tctx is None else None
                if ops is not None:
                    self.replicated.write_ops(ops)
                else:
                    self._write_hot([dict(row, **{ROWID: int(rid)})
                                     for row, rid in zip(table.to_pylist(), rowids)], tctx)
            self._bump()
            self._pk_stale = True
            stamp = self._new_stamp(tctx)
            self._append_table(table, rowids, np.full(table.num_rows, stamp, np.int64))
            if stamp and tctx is None:
                self._mvcc_maybe_gc(stamp)

    def insert_rows(self, rows: list[dict], tctx: Optional[TxnContext] = None):
        """``INSERT ... VALUES``: primary-key checked, written to the row tier
        (WAL-durable, or buffered with row locks in a transaction) and to the
        regions."""
        table = pa.table({f.name: [r.get(f.name) for r in rows] for f in self.arrow_schema},
                         schema=self.arrow_schema)
        with self._lock:
            self._writer_check(tctx)
            new_keys = self._check_duplicates(table)
            if self.partition_spec() is not None:
                # before the WAL write: a replay must never meet an
                # unroutable row
                self.partition_ids(table)
            self._bump()
            rowids = self._alloc_rowids(len(rows))
            self._write_hot([dict(r, **{ROWID: int(rid)}) for r, rid in zip(rows, rowids)],
                            tctx)
            stamp = self._new_stamp(tctx)
            self._append_table(table, rowids, np.full(len(rows), stamp, np.int64))
            if stamp and tctx is None:
                self._mvcc_maybe_gc(stamp)
            if new_keys and self._pk_index is not None and not self._pk_stale:
                self._pk_index.update(zip(new_keys, rowids.tolist()))

    def delete_where(self, host_mask_fn, tctx: Optional[TxnContext] = None,
                     collect_cols: Optional[list[str]] = None,
                     rowids: Optional[np.ndarray] = None):
        """Delete the rows where ``host_mask_fn(region table) -> bool array``
        (or, with ``rowids``, the rows of those rowids): the regions filter,
        the row tier records ``__del`` markers, and with MVCC on the outgoing
        versions enter the history.  With ``collect_cols``: (count, the
        deleted rows' projection), what a global index's maintenance
        deletes."""
        with self._lock:
            self._writer_check(tctx)
            # phase 1: masks only, so a failed row-tier write leaves the
            # regions as they were
            masks: list[tuple[Region, np.ndarray]] = []
            for r in self.regions:
                if r.num_rows:
                    mask = np.isin(r.rowids, rowids) if rowids is not None \
                        else np.asarray(host_mask_fn(r.data), dtype=bool)
                    if mask.any():
                        masks.append((r, mask))
            if not masks:
                if collect_cols is not None:
                    return 0, self.arrow_schema.empty_table().select(collect_cols)
                return 0
            fresh = self._pk_codec is not None and self._pk_index is not None \
                and not self._pk_stale
            n = sum(int(m.sum()) for _, m in masks)
            if tctx is not None or self.wal_path is not None or \
                    self.replicated is not None:
                # the row tier's __del markers (a non-durable autocommit
                # delete has no reader for them: a partition's millions of
                # rows build none)
                self._write_hot([{ROWID: rid, "__del": True}
                                 for r, m in masks for rid in r.rowids[m].tolist()], tctx)
            # phase 2: the delete is durable; apply it to the regions
            self._bump()
            dts = self._dead_stamp(tctx) if FLAGS.mvcc else 0
            gone = []
            for r, mask in masks:
                dead = r.data.filter(pa.array(mask))
                if collect_cols is not None:
                    gone.append(dead.select(collect_cols))
                self._distinct_move(dead, None)
                if fresh:
                    for k in self._encode_pk_table(dead):
                        self._pk_index.pop(k, None)
                if FLAGS.mvcc:
                    self._mvcc.record_dead(dead, r.cts[mask], dts)
                r.data = r.data.filter(pa.array(~mask))
                r.rowids = r.rowids[~mask]
                r.cts = r.cts[~mask]
                r.version += 1
            if not fresh:
                self._pk_stale = True
            if collect_cols is not None:
                return n, _concat(gone).combine_chunks()
            return n

    def update_where(self, host_mask_fn, assign_fn, tctx: Optional[TxnContext] = None,
                     changed_cols: Optional[list[str]] = None,
                     collect_cols: Optional[list[str]] = None, dry_run: bool = False):
        """Update rows in place: ``assign_fn(region table, mask) -> table``.
        The row tier records the new row versions under the same rowids; with
        MVCC on, the old versions close and the new ones open at one stamp.
        ``changed_cols`` (the assignment targets) keeps the primary-key index
        when no key column changes.  Rows whose partition column changes
        move to their partition's regions; a value no partition takes fails
        the statement before any write.  With ``collect_cols``: (count, old
        rows' projection, new rows' projection), what a global index's
        maintenance reads; ``dry_run`` computes them and changes nothing
        (a global UNIQUE check before the write)."""
        with self._lock:
            self._writer_check(tctx)
            staged: list[tuple[Region, np.ndarray, pa.Table]] = []
            hot: list[dict] = []
            for r in self.regions:
                if not r.num_rows:
                    continue
                mask = np.asarray(host_mask_fn(r.data), dtype=bool)
                if mask.any():
                    new_data = _coerce(assign_fn(r.data, mask), self.arrow_schema)
                    staged.append((r, mask, new_data))
                    if dry_run:
                        continue
                    new_rows = new_data.filter(pa.array(mask)).to_pylist()
                    hot.extend(dict(row, **{ROWID: rid})
                               for row, rid in zip(new_rows, r.rowids[mask].tolist()))
            n = sum(int(m.sum()) for _, m, _ in staged)
            out = n
            if collect_cols is not None:
                if staged:
                    old = _concat([r.data.filter(pa.array(m)).select(collect_cols)
                                            for r, m, _ in staged]).combine_chunks()
                    new = _concat([d.filter(pa.array(m)).select(collect_cols)
                                            for _, m, d in staged]).combine_chunks()
                else:
                    old = new = self.arrow_schema.empty_table().select(collect_cols)
                out = (n, old, new)
            if dry_run or not staged:
                return out
            spec = self.partition_spec()
            part_moved = spec is not None and (changed_cols is None
                                               or spec["column"] in changed_cols)
            if part_moved:
                for _, _, new_data in staged:
                    self.partition_ids(new_data)   # before the durable write
            self._write_hot(hot, tctx)
            self._bump()
            if FLAGS.mvcc:
                dts = self._dead_stamp(tctx)
                for r, mask, _ in staged:
                    # the dying versions close where the new ones open
                    self._mvcc.record_dead(r.data.filter(pa.array(mask)), r.cts[mask], dts)
                    r.cts = np.where(mask, np.int64(dts), r.cts)
            if self._pk_cols is not None and (
                    changed_cols is None or any(c in self._pk_cols for c in changed_cols)):
                self._pk_stale = True
            for r, mask, new_data in staged:
                if self._distinct:
                    m = pa.array(mask)
                    self._distinct_move(r.data.filter(m), new_data.filter(m))
                r.data = new_data
                r.version += 1
            if part_moved:
                # a stale tag would let pruning drop the moved rows
                self._rehome_partition_rows({id(r) for r, _, _ in staged})
            return out

    def truncate(self):
        """Every row goes, with the row tier and the WAL (TRUNCATE is never
        part of a transaction); a durable store rewrites its checkpoint, or
        the rows would come back at restart."""
        with self._lock:
            if self._writer is not None:
                raise ConflictError("TRUNCATE while a transaction is open")
            if self.replicated is not None:
                # the wipe replicates (by retiring the regions), or a
                # rebuild from the replicas would bring the rows back
                self.replicated.truncate()
            self._bump()
            self._pk_stale = True
            self._distinct = {}
            self.regions = [Region(self._alloc_region_id(), self.arrow_schema.empty_table())]
            self._stream_chunks = None
            self._mvcc.reset()
            self._reset_wal()
            if self.durable_dir:
                self.save_parquet(self.durable_dir)

    def alter_schema(self, new_schema: Schema):
        """ADD / DROP COLUMN: the regions rewrite to the new schema (added
        columns NULL).  The row tier's encoding is schema-bound, so ALTER is
        a checkpoint boundary; snapshots pinned before it read the new
        image, as in the JAX package."""
        with self._lock:
            if self._writer is not None:
                raise ConflictError("ALTER while a transaction is open")
            self._bump()
            self._pk_stale = True
            self._distinct = {}
            self._mvcc.reset()
            self.info.schema = new_schema
            self.info.version += 1
            self.arrow_schema = schema_to_arrow(new_schema)
            for r in self.regions:
                r.data = _coerce(r.data, self.arrow_schema)
                r.version += 1
            if self.durable_dir:
                self.save_parquet(self.durable_dir)
            self._reset_wal()
            if self.replicated is not None:
                # the replicated encoding is schema-bound too: the regions
                # retire and the rewritten rows replicate anew
                kc, rc = self.row_table.key_codec, self.row_table.row_codec
                ops = [(0, kc.encode_one({ROWID: int(rid)}),
                        rc.encode(dict(row, **{ROWID: int(rid)})))
                       for r in self.regions
                       for row, rid in zip(r.data.to_pylist(), r.rowids)]
                self.replicated.reset_schema(self._row_schema(), ops)
            if self._pk_cols:
                if any(c not in new_schema for c in self._pk_cols):
                    self._pk_cols = self._pk_codec = None
                else:
                    self._pk_codec = KeyCodec(new_schema, self._pk_cols)
                self._pk_index = None

    def purge_expired(self, ttl_column: str, expire_before) -> int:
        """TTL purge (reference: TTL delete loops, store.cpp:46-48 timers +
        ttl_delete_node): delete rows whose ttl_column < expire_before."""
        def mask_fn(t: pa.Table):
            col = t.column(ttl_column)
            return np.asarray(pc.less(col, pa.scalar(expire_before)).fill_null(False))

        return self.delete_where(mask_fn)

    # -- persistence ------------------------------------------------------
    def save_parquet(self, directory: str):
        """One Parquet file per region, rowids in ``__rowid`` (the JAX
        package's checkpoint layout)."""
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            for f in os.listdir(directory):
                if f.endswith(".parquet"):
                    os.remove(os.path.join(directory, f))
            for r in self.regions:
                t = r.data.append_column(ROWID, pa.array(r.rowids, pa.int64()))
                suffix = f"_p{r.part}" if r.part >= 0 else ""
                pq.write_table(t, os.path.join(directory,
                                               f"region_{r.region_id}{suffix}.parquet"))

    def load_parquet(self, directory: str):
        files = sorted(f for f in os.listdir(directory) if f.endswith(".parquet"))
        with self._lock:
            self._bump()
            self._pk_stale = True
            self._distinct = {}
            self._mvcc.reset()
            self.regions = []
            for f in files:
                t = pq.read_table(os.path.join(directory, f))
                if ROWID in t.column_names:
                    rowids = np.asarray(t.column(ROWID).to_numpy(zero_copy_only=False),
                                        np.int64)
                    t = t.drop_columns([ROWID])
                else:
                    rowids = self._alloc_rowids(t.num_rows)
                if len(rowids):
                    self._next_rowid = max(self._next_rowid, int(rowids.max()) + 1)
                stem = f[:-len(".parquet")]
                tag = stem.rsplit("_p", 1)[1] if "_p" in stem else ""
                self.regions.append(Region(self._alloc_region_id(),
                                           _coerce(t, self.arrow_schema).combine_chunks(),
                                           rowids, part=int(tag) if tag.isdigit() else -1))
            if not self.regions:
                self.regions = [Region(self._alloc_region_id(),
                                       self.arrow_schema.empty_table())]


class ColumnStats(dict):
    """One column's planner statistics: the value bounds (``min``, ``max``,
    ``dict_size``) at once, the histogram / MCV / ndv payload of index/stats
    computed on the first read of any other key (or of the whole dict).  A
    planner that only sizes a dense GROUP BY never pays for the histogram;
    one that reads it gets the JAX package's values."""

    BOUNDS = frozenset(("min", "max", "dict_size"))

    def __init__(self, bounds: dict, payload):
        super().__init__(bounds)
        self.payload = payload           # () -> dict, or None once merged
        self._merged = False

    def _full(self) -> "ColumnStats":
        if not self._merged:
            self._merged = True
            super().update(self.payload() or {})
        return self

    def __getitem__(self, k):
        if k not in self.BOUNDS:
            self._full()
        return super().__getitem__(k)

    def get(self, k, default=None):
        if k not in self.BOUNDS:
            self._full()
        return super().get(k, default)

    def __contains__(self, k):
        if k not in self.BOUNDS:
            self._full()
        return super().__contains__(k)

    def __bool__(self):
        return True

    def __iter__(self):
        return super().__iter__() if self._full() else iter(())

    def __len__(self):
        return super().__len__() if self._full() else 0

    def keys(self):
        return self._full() and super().keys()

    def items(self):
        return self._full() and super().items()

    def values(self):
        return self._full() and super().values()

    def copy(self) -> dict:
        return dict(self._full().items())

    def __eq__(self, other):
        return dict(self.items()) == (dict(other.items()) if isinstance(other, dict) else other)

    __hash__ = None

    def __repr__(self):
        return repr(dict(self.items()))


def _union_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The sorted union of two sorted unique string arrays; ``a`` itself
    when ``b`` adds nothing (the live image's dictionary then stays)."""
    if not len(b):
        return a
    pos = np.searchsorted(a, b)
    new = np.ones(len(b), bool)
    inside = pos < len(a)
    new[inside] = a[pos[inside]] != b[inside]
    if not new.any():
        return a
    wide = a.astype(np.promote_types(a.dtype, b.dtype), copy=False)   # no truncation
    return np.insert(wide, pos[new], b[new])


def _concat_versions(parts: list[ColumnBatch]) -> ColumnBatch:
    """The live image and the history batches concatenated on the device.
    A string column's dictionaries merge into their sorted union, which is
    the dictionary one encode of the concatenated rows would build, and each
    part's codes translate into it.  The parts are left as they were (the
    first is the cached live image)."""
    cols: list[list] = [list(p.columns) for p in parts]
    for i, c in enumerate(parts[0].columns):
        if c.ltype is not LType.STRING:
            continue
        dicts = [p.columns[i].dictionary for p in parts]
        vals = None
        for d in dicts:
            if d is not None and len(d):
                vals = d.values if vals is None else _union_sorted(vals, d.values)
        if vals is None:
            continue
        owner = next((d for d in dicts if d is not None and d.values is vals), None)
        merged = owner if owner is not None else Dictionary(vals)
        for j, (p, d) in enumerate(zip(parts, dicts)):
            if d is merged:
                continue
            pcol = p.columns[i]
            old = d.values if d is not None and len(d) else np.empty(0, str)
            remap = np.searchsorted(vals, old).astype(np.int32) if len(old) \
                else np.zeros(1, np.int32)
            remap = torch.from_numpy(remap).to(pcol.data.device)
            codes = torch.where(pcol.data >= 0,
                                remap[pcol.data.clamp(0, len(remap) - 1).long()],
                                torch.full_like(pcol.data, NULL_CODE)).to(pcol.data.dtype)
            cols[j][i] = replace(pcol, data=codes, dictionary=merged)
    return concat_batches([ColumnBatch(p.names, cs, p.sel, None, device=p.device)
                           for p, cs in zip(parts, cols)])


def _histogram_stats(col, f) -> dict | None:
    """Equi-depth histogram + MCVs of one column (index/stats), or None when
    the flag is off or the column is empty."""
    if not FLAGS.histogram_stats:
        return None
    n_total = len(col)
    if n_total == 0:
        return None
    vals = pc.drop_null(col).combine_chunks().to_numpy(zero_copy_only=False)
    kind = None
    if f.ltype is LType.STRING:
        vals = np.asarray(vals, dtype=object)
        numeric = False
    else:
        if vals.dtype.kind == "M":        # date/datetime
            if f.ltype is LType.DATE:
                vals = vals.astype("datetime64[D]")
                kind = "date"
            else:
                vals = vals.astype("datetime64[us]")
                kind = "datetime"
            vals = vals.astype(np.int64)
        elif vals.dtype.kind == "O":
            return None                   # no numeric view of the column
        numeric = True
    st = collect(vals, n_total, col.null_count, numeric)
    if kind:
        st["kind"] = kind
    return st


# the declared rank is visible to the static<->runtime check from import
LOCK_RANKS.setdefault("store.table_lock", TableStore.RANK)
