"""Online DDL: ADD INDEX with asynchronous backfill.

The port of ``baikaldb_tpu/meta/ddl.py``.  The reference runs index DDL as
a global state machine on the meta service (src/meta_server/ddl_manager.cpp:
per-region work items handed to frontend TaskManagers) with region-granular
backfill (src/exec/index_ddl_manager_node.cpp) and a versioned schema
broadcast so queries only use the index once every region is done.  A
secondary "index" here is a per-version sorted-order artifact the store
derives from its columnar state (column_store._secondary_order), so backfill
means: validate + warm that artifact region by region in the background,
then atomically PUBLISH the index so the selector starts choosing it.  A
global index's backfill fills its backing table from a snapshot of the main
table and publishes under the main table's lock.

States (ddl_manager.cpp's IndexState analog):
``backfilling`` -> ``public`` | ``failed``; the selector only ever uses
``public`` indexes (declared-at-CREATE indexes carry no state and are
public from birth).  Concurrent DML during backfill stays correct by
construction — the sorted-order cache is keyed by store version, so any
write invalidates and the next reader rebuilds; the final unique-validation
+ publish happens under the store lock, where no write can interleave.
Publishing moves the table's catalog version, which every cached plan keys
on.

The worker is one daemon thread a Database, started by the first
submission; ``stop()`` (``Database.close``) ends it.  The per-region
sortability check sorts each region's column with Arrow; a column Arrow
cannot sort goes through Python's ``sorted``, which raises the JAX
package's error for it.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..utils import metrics


@dataclass
class DdlWork:
    work_id: int
    table_key: str               # "db.table"
    index_name: str
    kind: str                    # key | unique
    columns: list[str]
    state: str = "backfilling"   # backfilling | public | failed | suspended
    regions_done: int = 0
    regions_total: int = 0
    error: str = ""
    done = None                  # threading.Event, set at terminal state

    def __post_init__(self):
        self.done = threading.Event()


class DdlManager:
    """The Database's DDL work queue + one background worker thread."""

    def __init__(self, db):
        self.db = db
        self._ids = itertools.count(1)
        self.works: dict[int, DdlWork] = {}
        self._queue: list[DdlWork] = []
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._suspended = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None

    # -- submission --------------------------------------------------------
    def submit(self, table_key: str, ix) -> DdlWork:
        """Queue the backfill for an index already registered on the table
        (state=backfilling).  Returns immediately — the ALTER statement's
        contract (reference: DDL returns once meta accepts the work)."""
        w = DdlWork(next(self._ids), table_key, ix.name, ix.kind,
                    list(ix.columns))
        with self._cv:
            self.works[w.work_id] = w
            self._queue.append(w)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run,
                                                daemon=True,
                                                name="ddl-backfill")
                self._thread.start()
            self._cv.notify_all()
        return w

    def wait(self, work_id: int, timeout: float = 30.0) -> DdlWork:
        w = self.works[work_id]
        w.done.wait(timeout)
        return w

    def suspend(self):
        """HANDLE ddl suspend: finish the current region, then hold."""
        with self._cv:
            self._suspended = True

    def resume(self):
        with self._cv:
            self._suspended = False
            self._cv.notify_all()

    def stop(self, timeout: float = 5.0) -> None:
        """End the worker (the Database closes): the region in progress
        finishes, queued work stays queued and unpublished."""
        with self._cv:
            self._stopped = True
            t = self._thread
            self._cv.notify_all()
        if t is not None and t is not threading.current_thread():
            t.join(timeout)

    def _hold(self) -> bool:
        """Wait out a suspension; False once the manager is stopped.
        Caller holds ``_cv``."""
        while self._suspended and not self._stopped:
            self._cv.wait(1.0)
        return not self._stopped

    # -- worker ------------------------------------------------------------
    def _run(self):
        # the thread retires only at stop(): a thread retiring on an empty
        # queue races submit()'s is_alive() check and can strand queued
        # work — idling on the condition variable is cheap
        while True:
            with self._cv:
                while not self._stopped and (self._suspended or not self._queue):
                    self._cv.wait(1.0)
                if self._stopped:
                    return
                w = self._queue.pop(0)
            try:
                self._backfill(w)
            except Exception as e:      # noqa: BLE001 — surfaced on the work
                self._fail(w, f"{type(e).__name__}: {e}")

    def _index_entry(self, info, w: DdlWork):
        for ix in info.indexes:
            if ix.name == w.index_name:
                return ix
        return None

    def _fail(self, w: DdlWork, msg: str):
        w.state = "failed"
        w.error = msg
        db, name = w.table_key.split(".", 1)
        try:
            info = self.db.catalog.get_table(db, name)
            ix = self._index_entry(info, w)
            if ix is not None:
                ix.params["state"] = "failed"
                ix.params["error"] = msg
            self.db.save_catalog()
        except Exception:
            # the work record still flips to failed; catalog persistence
            # is retried by the next DDL
            metrics.count_swallowed("ddl.fail_persist")
        w.done.set()

    def _backfill(self, w: DdlWork):
        if w.kind in ("global", "global_unique"):
            self._backfill_global(w)
            return
        store = self.db.stores[w.table_key]
        col = w.columns[0]
        # phase 1: region-granular validation walk (the per-region work
        # items of ddl_manager.cpp).  Sortability problems surface here
        # with partial progress, before any global artifact exists.
        with store._lock:
            regions = list(store.regions)
        w.regions_total = max(1, len(regions))
        for r in regions:
            with self._cv:
                if not self._hold():
                    return
            rcol = r.data.column(col) if col in r.data.column_names else None
            if rcol is None:
                raise ValueError(f"column {col!r} missing in region")
            _check_sortable(rcol)
            w.regions_done += 1
            time.sleep(0)        # yield: DML interleaves between regions
        # phase 2: build + (for unique) validate the global artifact, then
        # publish — all under the store lock so no write interleaves
        # between the uniqueness check and the index becoming choosable
        db, name = w.table_key.split(".", 1)
        info = self.db.catalog.get_table(db, name)
        with store._lock:
            svals, _ = store._secondary_order(col)
            if w.kind == "unique" and len(svals) > 1:
                dup = svals[:-1] == svals[1:]
                ndup = int(np.sum(dup)) if hasattr(dup, "__len__") else 0
                if ndup:
                    first = svals[:-1][np.asarray(dup)][0]
                    raise ValueError(
                        f"duplicate value {first!r} in column {col!r}: "
                        f"cannot add UNIQUE index")
            ix = self._index_entry(info, w)
            if ix is None:
                raise RuntimeError("index dropped during backfill")
            ix.params["state"] = "public"
            ix.params.pop("error", None)
            # cached plans key on the catalog version: they re-plan (the
            # reference's versioned schema broadcast); the access path is
            # chosen at each execution
            info.version += 1
        w.state = "public"
        self.db.save_catalog()
        self.db.binlog.append(
            "ddl", db, name,
            statement=f"ADD {'UNIQUE ' if w.kind == 'unique' else ''}INDEX "
                      f"{w.index_name} ({', '.join(w.columns)}) backfilled")
        w.done.set()

    def _backfill_global(self, w: DdlWork):
        """Fill a global index's backing table from the main table, then
        publish (reference: region-granular index backfill driven by
        DDLManager work items, ddl_manager.cpp; the backing rows land in
        the index's OWN region groups through the normal replicated write
        path).  The fill is idempotent — it truncates and re-fills — so a
        killed/restarted backfill resumes by simply re-running; the catalog
        keeps state=backfilling until publish, and Database._recover
        resubmits unfinished works."""
        from ..index import globalindex as gi

        store = self.db.stores[w.table_key]
        db, name = w.table_key.split(".", 1)
        info = self.db.catalog.get_table(db, name)
        ix = self._index_entry(info, w)
        if ix is None:
            raise RuntimeError("index dropped during backfill")
        bname = gi.backing_table_name(name, ix.name)
        bkey = f"{db}.{bname}"
        bstore = self.db.stores.get(bkey)
        if bstore is None:
            binfo = self.db.catalog.get_table(db, bname)
            bstore = self.db.stores[bkey] = self.db.make_store(binfo)
        with store._lock:
            regions = list(store.regions)
        w.regions_total = max(1, len(regions))
        # phase 1: region-granular validation walk (observability + early
        # failure before any backing write)
        for r in regions:
            with self._cv:
                if not self._hold():
                    return
            for c in w.columns:
                if c not in r.data.column_names:
                    raise ValueError(f"column {c!r} missing in region")
            w.regions_done += 1
            time.sleep(0)
        # phase 2: fill + publish under the MAIN store's lock so no DML
        # interleaves between the snapshot and the index becoming live
        # (DML only maintains PUBLIC indexes)
        with store._lock:
            snap = store.snapshot()
            entries = gi.entry_table(info, ix, snap)
            if w.kind == "global_unique" and entries.num_rows:
                nn = entries
                for c in ix.columns:
                    nn = nn.filter(pc.is_valid(nn.column(c)))
                if nn.num_rows:
                    counts = nn.group_by(list(ix.columns)).aggregate(
                        [(ix.columns[0], "count")])
                    cname = f"{ix.columns[0]}_count"
                    dups = counts.filter(
                        pc.greater(counts.column(cname), 1))
                    if dups.num_rows:
                        first = dups.slice(0, 1).to_pylist()[0]
                        val = tuple(first[c] for c in ix.columns)
                        raise ValueError(
                            f"duplicate value {val!r} in columns "
                            f"{list(ix.columns)}: cannot add global "
                            f"UNIQUE index")
            bstore.truncate()
            if entries.num_rows:
                bstore.insert_arrow(entries)
            ix.params["state"] = "public"
            ix.params.pop("error", None)
            info.version += 1
        w.state = "public"
        self.db.save_catalog()
        self.db.binlog.append(
            "ddl", db, name,
            statement=f"ADD GLOBAL "
                      f"{'UNIQUE ' if w.kind == 'global_unique' else ''}"
                      f"INDEX {w.index_name} ({', '.join(w.columns)}) "
                      f"backfilled")
        w.done.set()


def _check_sortable(col) -> None:
    """Raise as ``sorted`` of the column's non-NULL values would, without
    building them as Python objects when Arrow can sort the column."""
    try:
        pc.sort_indices(col)
    except (pa.ArrowNotImplementedError, pa.ArrowInvalid, pa.ArrowTypeError):
        sorted([v for v in col.to_pylist() if v is not None])
