"""MVCC and snapshot reads: the TSO client, version state, pins and GC.

The port of ``baikaldb_tpu/storage/mvcc.py``.  Every committed row version
carries a ``commit_ts``, a delete or update closes the old version at a
``delete_ts``, and a pinned analytical read sees exactly the versions with
``commit_ts <= snap < delete_ts``.

- ``TsoClient``: the cached-range allocator over a grant source (by default
  the process-local oracle of meta/tso.py).  One grant covers
  ``tso_batch_size`` timestamps; allocation is an in-memory bump.
- ``MvccState``: a table's version bookkeeping, kept beside the resident
  Arrow image.  Where the JAX package keeps one dict entry per stamped row
  (``live_cts``: rowid -> commit_ts) and one Python dict per dead version,
  the port is vectorised: each region carries an int64 stamp array aligned
  with its rows (``Region.cts``; 0 = visible to every snapshot, as a missing
  dict entry is there), and the history is a list of Arrow tables of dead
  versions, each with its commit stamps and one delete stamp.  A bulk load
  of n rows is one ``np.full``; the versioned read concatenates arrays.  The
  visibility answers, ``versions_scanned`` and the GC counts are the JAX
  package's.  Uncommitted rows carry ``PENDING`` (MAX_TS) and are restamped
  with one decide-time commit_ts when their transaction commits.
- ``SnapshotRegistry``: live pins (``SET SNAPSHOT`` and automatic analytical
  pins) feeding the GC watermark; nothing at or above the oldest unexpired
  pin is reclaimed.
- ``visibility_mask``: the visibility predicate, one elementwise torch pass
  on the batch's device; the versioned batch ANDs it into its ``sel``.
- ``MvccGcThread``: the optional background sweeper; the store also sweeps
  at commit seams.

Locks, in the JAX package's rank order: a table's lock (10) is taken before
the registry's (12), which is taken before the TSO client's (15); the GC
computes its watermark under the registry lock, releases it, then sweeps
each table under that table's lock.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass

import numpy as np
import pyarrow as pa
import torch

from ..analysis.runtime import LOCK_RANKS, GuardedLock
from ..chaos import failpoint
from ..utils import metrics
from ..utils.flags import FLAGS, define

define("mvcc", True,
       "stamp commit timestamps on DML and serve pinned snapshot reads "
       "(SET SNAPSHOT / automatic analytical pins); 0 = versionless "
       "stores, bit-identical to the pre-MVCC engine")
define("tso_batch_size", 64,
       "timestamps granted per TSO range: the client bumps in memory "
       "inside the granted range and asks the oracle once per refill")
define("mvcc_gc_interval_s", 30.0,
       "background MVCC GC sweep period (MvccGcThread; the store also "
       "sweeps at commit seams)")
define("snapshot_max_age_s", 300.0,
       "pins older than this stop holding the GC watermark: a forgotten "
       "SET SNAPSHOT session bounds version retention")

failpoint.register("tso.allocate", "TSO grant response lost (drop: the "
                   "granted range is burned and the client asks again)")
failpoint.register("mvcc.gc", "MVCC GC sweep wedged (drop: the sweep is "
                   "skipped)")
failpoint.register("snapshot.pin", "snapshot pin refused (drop: an "
                   "automatic pin degrades to an unpinned read)")

tso_allocations = metrics.Counter("tso.allocations")
tso_batch_refills = metrics.Counter("tso.batch_refills")
mvcc_gc_reclaimed = metrics.Counter("mvcc.gc_reclaimed")

#: commit_ts sentinel of uncommitted (in-transaction) rows: above every real
#: timestamp, so no snapshot admits a pending version.
MAX_TS = (1 << 63) - 1
PENDING = MAX_TS


def visibility_mask(cts: torch.Tensor, dts: torch.Tensor, snap_ts) -> torch.Tensor:
    """``commit_ts <= snap_ts < delete_ts`` over int64 tensors, on their
    device.  Newest-wins is structural: an update closes the old version's
    interval where the new version's opens, so each row has one version
    alive at any snapshot."""
    return (cts <= snap_ts) & (dts > snap_ts)


class TsoError(RuntimeError):
    """A timestamp could not be allocated (grant source unavailable)."""


class TsoClient:
    """Monotonic timestamp allocator over batched grants.

    ``gen``: ``(count) -> first_ts`` granting ``count`` contiguous
    timestamps, or None for a process-local oracle (meta/tso.Tso).  The
    ``tso.allocate`` failpoint models a grant lost in flight: that range is
    burned and the client asks again."""

    RANK = 15   # above the table lock (10): commits stamp under it

    def __init__(self, gen=None):
        if gen is None:
            from ..meta.tso import Tso
            gen = Tso().gen
        self._gen = gen
        self._mu = GuardedLock("mvcc.tso_mu", rank=self.RANK)
        self._next = 0      # next ts to hand out
        self._limit = 0     # one past the granted range
        self._last = 0      # newest ts handed out

    def next_ts(self, count: int = 1) -> int:
        """First of ``count`` contiguous timestamps (count=1: the ts)."""
        count = max(1, int(count))
        with self._mu:
            if self._next + count > self._limit:
                self._refill(count)
            ts = self._next
            self._next += count
            tso_allocations.add(count)
            self._last = self._next - 1
            return ts

    def last_ts(self) -> int:
        """Newest timestamp handed out (0 = none yet)."""
        with self._mu:
            return self._last

    def _refill(self, count: int) -> None:
        batch = max(count, int(FLAGS.tso_batch_size))
        first = self._gen(batch)
        if failpoint.ENABLED and failpoint.hit("tso.allocate", batch=batch):
            first = self._gen(batch)      # the first grant never arrived
        if first is None:
            raise TsoError("TSO grant source returned no range")
        first = int(first)
        if first < self._limit:
            raise TsoError(f"TSO range regressed: granted {first} below consumed "
                           f"limit {self._limit}")
        self._next = first
        self._limit = first + batch
        tso_batch_refills.add(1)


@dataclass
class History:
    """Dead versions of one statement: the rows, their commit stamps and
    the one delete stamp that closed them."""
    rows: pa.Table
    cts: np.ndarray
    dts: int

    def alive(self, snap_ts: int) -> np.ndarray:
        return (self.cts <= snap_ts) & (snap_ts < self.dts)


class MvccState:
    """A table's history of dead versions; its live stamps ride its regions
    (``Region.cts``).  Mutated only under the owning store's table lock."""

    __slots__ = ("history", "epoch", "__weakref__")

    def __init__(self):
        self.history: list[History] = []
        # moves whenever a visibility answer may change without a write to
        # the image (restamp at commit, GC, rollback): versioned batches
        # are cached per (table version, epoch, snapshot)
        self.epoch = 0
        _STATES.add(self)

    # -- write-path hooks (caller holds the table lock) -----------------
    def record_dead(self, rows: pa.Table, cts: np.ndarray, dts: int) -> None:
        if rows.num_rows:
            self.history.append(History(rows, np.asarray(cts, np.int64), int(dts)))
            self.epoch += 1

    def restamp_pending(self, regions, commit_ts: int) -> int:
        """Replace every PENDING stamp (live and delete stamps) with the
        decide-time commit_ts: one timestamp per transaction.  The writer
        lease makes every pending stamp the committing transaction's."""
        n = 0
        for r in regions:
            if r.cts_max() == PENDING:
                hit = r.cts == PENDING
                n += int(hit.sum())
                r.cts = np.where(hit, np.int64(commit_ts), r.cts)
        for i, h in enumerate(self.history):
            if h.dts == PENDING:
                self.history[i] = History(h.rows, h.cts, int(commit_ts))
                n += h.rows.num_rows
        self.epoch += 1
        return n

    # -- rollback --------------------------------------------------------
    def capture(self) -> int:
        return len(self.history)

    def restore(self, hist_len: int) -> None:
        del self.history[hist_len:]
        self.epoch += 1

    def reset(self) -> None:
        """The image was replaced wholesale (truncate, load, ALTER): the
        history describes rows that no longer exist."""
        self.history.clear()
        self.epoch += 1

    # -- read-path helpers -----------------------------------------------
    def history_rows(self) -> int:
        return sum(h.rows.num_rows for h in self.history)

    def versions_at(self, snap_ts: int) -> list[tuple[pa.Table, np.ndarray, int]]:
        """The history versions alive at ``snap_ts``, as (rows, cts, dts)."""
        out = []
        for h in self.history:
            m = h.alive(snap_ts)
            if m.all():
                out.append((h.rows, h.cts, h.dts))
            elif m.any():
                out.append((h.rows.filter(pa.array(m)), h.cts[m], h.dts))
        return out

    def any_alive(self, snap_ts: int) -> bool:
        return any(bool(h.alive(snap_ts).any()) for h in self.history)

    def gc(self, regions, watermark: int) -> int:
        """Drop history at or below the watermark and settle old live stamps
        to 0.  A dead version is reclaimable iff its delete_ts <= watermark
        (visibility needs ``dts > snap`` and the watermark bounds every pin
        from below); a live stamp at or below it is visible to every pin that
        can still be taken.  Returns the reclaimed version count."""
        if failpoint.ENABLED and failpoint.hit("mvcc.gc", watermark=watermark):
            return 0
        before = self.history_rows()
        self.history = [h for h in self.history if h.dts > watermark]
        for r in regions:
            if r.cts_max() > 0:
                settle = (r.cts > 0) & (r.cts <= watermark)
                if settle.any():
                    r.cts = np.where(settle, np.int64(0), r.cts)
        self.epoch += 1
        reclaimed = before - self.history_rows()
        if reclaimed:
            mvcc_gc_reclaimed.add(reclaimed)
        return reclaimed


class SnapshotRefused(RuntimeError):
    """A snapshot pin was refused (the ``snapshot.pin`` failpoint)."""


class SnapshotRegistry:
    """Live snapshot pins: the GC watermark source."""

    RANK = 12   # between the table lock (10) and the TSO client (15)

    def __init__(self):
        self._mu = GuardedLock("mvcc.registry_mu", rank=self.RANK)
        self._pins: dict[int, dict] = {}
        self._seq = 0
        _REGISTRIES.add(self)

    def pin(self, ts: int, query: str = "", holder: str = "") -> int:
        """Register a pin at ``ts``; returns its id for ``unpin``."""
        if failpoint.ENABLED and failpoint.hit("snapshot.pin", ts=ts):
            raise SnapshotRefused("snapshot.pin dropped by failpoint")
        with self._mu:
            self._seq += 1
            pid = self._seq
            self._pins[pid] = {"ts": int(ts), "pinned_at": time.time(),
                               "query": query, "holder": holder}
            return pid

    def unpin(self, pin_id: int) -> None:
        with self._mu:
            self._pins.pop(pin_id, None)

    def _unexpired(self) -> list[dict]:
        horizon = time.time() - float(FLAGS.snapshot_max_age_s)
        return [p for p in self._pins.values() if p["pinned_at"] >= horizon]

    def oldest(self) -> int:
        """Oldest unexpired pinned ts (0 = no live pins)."""
        with self._mu:
            return min((p["ts"] for p in self._unexpired()), default=0)

    def watermark(self, now_ts: int) -> int:
        """Everything strictly below it is dead to every current and future
        pin (future pins get a ts above ``now_ts``)."""
        with self._mu:
            return min((p["ts"] for p in self._unexpired()), default=int(now_ts))

    def describe(self) -> list[dict]:
        """The pins, oldest first."""
        now = time.time()
        with self._mu:
            return sorted(({"snapshot_ts": p["ts"],
                            "age_ms": int((now - p["pinned_at"]) * 1e3),
                            "query": p["query"], "holder": p["holder"]}
                           for p in self._pins.values()),
                          key=lambda r: r["snapshot_ts"])


class MvccRuntime:
    """A Database's MVCC plane: one TSO client and the pin registry."""

    def __init__(self, gen=None):
        self.tso = TsoClient(gen)
        self.snapshots = SnapshotRegistry()
        self._gc_thread: MvccGcThread | None = None

    def now_ts(self) -> int:
        """A fresh timestamp: everything committed so far is below it."""
        return self.tso.next_ts()

    def gc(self, stores) -> int:
        """One watermark-driven sweep over ``stores``: the watermark under
        the registry lock alone, then each table under its own lock."""
        wm = self.snapshots.watermark(self.tso.last_ts())
        return sum(st.mvcc_gc(wm) for st in list(stores))

    def start_gc(self, db) -> "MvccGcThread":
        if self._gc_thread is None:
            self._gc_thread = MvccGcThread(self, db)
            self._gc_thread.start()
        return self._gc_thread

    def stop_gc(self) -> None:
        if self._gc_thread is not None:
            self._gc_thread.stop()
            self._gc_thread = None


class MvccGcThread(threading.Thread):
    """Periodic watermark-driven GC (``mvcc_gc_interval_s``), started only
    by ``MvccRuntime.start_gc``."""

    def __init__(self, runtime: MvccRuntime, db):
        super().__init__(name="mvcc-gc", daemon=True)
        self._runtime = runtime
        self._db = weakref.ref(db)
        self._stop = threading.Event()

    def run(self) -> None:
        while not self._stop.wait(float(FLAGS.mvcc_gc_interval_s)):
            db = self._db()
            if db is None:
                return
            try:
                self._runtime.gc(db.stores.values())
            except Exception:   # noqa: BLE001 — the sweep must not die
                metrics.count_swallowed("mvcc.gc")

    def stop(self) -> None:
        self._stop.set()
        self.join(timeout=2.0)


_STATES: "weakref.WeakSet[MvccState]" = weakref.WeakSet()
_REGISTRIES: "weakref.WeakSet[SnapshotRegistry]" = weakref.WeakSet()


def _live_versions() -> int:
    return sum(s.history_rows() for s in list(_STATES))


def _oldest_pin() -> int:
    return min((ts for ts in (r.oldest() for r in list(_REGISTRIES)) if ts), default=0)


metrics.Gauge("mvcc.live_versions", fn=_live_versions)
metrics.Gauge("mvcc.oldest_pin", fn=_oldest_pin)

LOCK_RANKS.setdefault("mvcc.tso_mu", TsoClient.RANK)
LOCK_RANKS.setdefault("mvcc.registry_mu", SnapshotRegistry.RANK)
