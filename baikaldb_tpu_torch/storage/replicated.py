"""Raft-replicated hot row tier, reachable from SQL.

In the reference every DML is a raft apply on a Region
(/root/reference/src/store/region.cpp:2301 dml_1pc, :1961 dml_2pc; on_apply
include/store/region.h:626) and COMMIT is primary-first 2PC driven from the
frontend (/root/reference/src/exec/fetcher_store.cpp:1848-1904).  This module
puts the same discipline under the Session's DML path:

- each replicated table owns raft region groups (3 replicas each) hosted by
  a ``raft.fleet.StoreFleet`` whose placement came from the meta service;
  regions own contiguous [start_key, end_key) slices of the memcomparable
  keyspace (the reference's RegionInfo ranges) — a new table starts as ONE
  region spanning everything and SPLITS by size, exactly the reference's
  lifecycle (region.cpp:4472 split init, :7198 log catch-up, :4864
  add_version finalize),
- a single-region statement commits as ONE replicated write batch — the 1PC
  path — acked only after quorum commit,
- a statement or SQL transaction spanning regions runs through
  ``raft.twopc.TwoPhaseCoordinator`` (PREPARE everywhere, decision record +
  COMMIT on the primary first),
- reads consult the meta routing table for the leader replica (the
  fetcher_store choose_opt_instance analog) and fall back to a live election.

The authoritative state is the raft groups' row tables: a new Database over
the same fleet rebuilds its columnar cache from the replicas (the restart
recovery path, include/store/region.h:644), so killing a leader mid-workload
loses nothing committed.

The port's copy of ``baikaldb_tpu/storage/replicated.py``.  The tier's lock
is a plain reentrant lock where the JAX package has its lockset witness
(``analysis/runtime.py``, which has no counterpart); its rank, 30, the
innermost of the write path, stays in the comment at ``self._mu``.  A
pushed fragment's cold fold (``region_fragment_rows``) encodes a segment's
keys in one batch, and a cold flush's value hashes come from
``_fnv64_many``, where the JAX package works a row at a time.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np

from ..chaos import failpoint
from ..meta.service import SERVING
from ..raft.cluster import CMD_COLD, RaftGroup
from ..raft.core import LEADER
from ..raft.twopc import TwoPhaseCoordinator, TwoPhaseError, next_txn_id
from ..types import Schema
from ..utils.flags import FLAGS, define
from ..utils import metrics

if TYPE_CHECKING:  # pragma: no cover
    from ..raft.fleet import StoreFleet

define("region_split_rows", 200_000,
       "auto-split a replicated region when it exceeds this many keys "
       "(reference: region_split_lines)")
define("learner_read_fallback", True,
       "when a region has no electable quorum, serve reads from the most "
       "advanced LIVE replica (learners included) instead of failing — a "
       "bounded-staleness degradation, counted in "
       "metrics.learner_fallback_reads; off restores fail-fast reads")


def _fnv64(data: bytes) -> int:
    """FNV-1a (storage.remote_tier derives stable table ids from it)."""
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _fnv64_many(values: list) -> list[int]:
    """``_fnv64`` of each bytes value, the values of one length hashed side
    by side as a uint64 column (numpy wraps the multiply mod 2^64, as the
    mask does): a cold flush hashes every row of a region."""
    out = [0] * len(values)
    by_len: dict[int, list[int]] = {}
    for i, v in enumerate(values):
        by_len.setdefault(len(v), []).append(i)
    prime = np.uint64(0x100000001B3)
    for n, idx in by_len.items():
        h = np.full(len(idx), 0xCBF29CE484222325, np.uint64)
        if n:
            cols = np.frombuffer(b"".join(values[i] for i in idx),
                                 np.uint8).reshape(len(idx), n).astype(np.uint64)
            with np.errstate(over="ignore"):
                for j in range(n):
                    h = (h ^ cols[:, j]) * prime
        for i, x in zip(idx, h.tolist()):
            out[i] = x
    return out


class ReplicationError(RuntimeError):
    """A replicated write could not reach quorum (region unavailable)."""


class SplitError(RuntimeError):
    """A region split/merge could not complete (aborted, state unchanged)."""


def _schema_arrow(schema: Schema):
    from .column_store import schema_to_arrow   # lazy: avoids module cycle

    return schema_to_arrow(schema)


def write_ops_atomic(pairs: list[tuple["ReplicatedRowTier", list]],
                     commit_ts: int = 0) -> None:
    """Commit several tiers' write batches as ONE transaction: a single
    primary-first 2PC across the union of every touched region group (the
    reference's global-index DML, where LockPrimaryNode/LockSecondaryNode
    span main-table and index regions — separate.cpp:653).  All tiers must
    belong to the same fleet (region ids are fleet-unique, allocated by
    meta).  Raises ReplicationError on quorum loss; nothing applies unless
    the decision record commits.

    ``commit_ts``: the transaction's MVCC decide-time stamp, persisted in
    the decision record's log entry (raft/twopc.py) — 0 = unstamped."""
    pairs = [(t, ops) for t, ops in pairs if ops]
    if not pairs:
        return
    if len(pairs) == 1:
        pairs[0][0].write_ops(pairs[0][1])
        return
    import contextlib

    # lock every tier in table_key order (deadlock-free against concurrent
    # coupled writes taking the same set)
    tiers = sorted({t.table_key: t for t, _ in pairs}.values(),
                   key=lambda t: t.table_key)
    with contextlib.ExitStack() as stack:
        for t in tiers:
            stack.enter_context(t._mu)
        by_region: dict[int, list] = {}
        groups: list = []
        for t, ops in pairs:
            for i, batch in sorted(t._split_ops(ops).items()):
                g = t.groups[i]
                if g.region_id not in by_region:
                    by_region[g.region_id] = []
                    groups.append(g)
                by_region[g.region_id].extend(batch)
        if len(groups) == 1:
            if not groups[0].write(by_region[groups[0].region_id]):
                raise ReplicationError(
                    f"region {groups[0].region_id} has no quorum")
        else:
            try:
                TwoPhaseCoordinator(groups).write(by_region,
                                                  txn_id=next_txn_id(),
                                                  commit_ts=commit_ts)
            except TwoPhaseError as e:
                raise ReplicationError(str(e)) from None
        for t in tiers:
            t.maybe_split()


class ReplicatedRowTier:
    """One table's raft-replicated row tier: range-routed region groups."""

    # rank 30 — the INNERMOST lock of the write path (see __init__ comment)
    RANK = 30

    def __init__(self, fleet: "StoreFleet", table_id: int, table_key: str,
                 row_schema: Schema, key_columns: list[str],
                 split_rows: int = 0):
        self.fleet = fleet
        self.table_id = table_id
        self.table_key = table_key
        self.row_schema = row_schema
        self.key_columns = list(key_columns)
        # 0 = read the live flag at each check (SET GLOBAL takes effect)
        self.split_rows = split_rows
        self.metas = fleet.create_table_regions(
            table_id, 1, schema=row_schema, key_columns=key_columns)
        self.groups: list[RaftGroup] = [fleet.group(m.region_id)
                                        for m in self.metas]
        # range bookkeeping lives in the tier (sorted, parallel to
        # metas/groups) so routing survives meta leader failover: the lists
        # of RegionMeta objects above may become stale references after a
        # meta snapshot install, but region_ids and ranges do not change
        # except through this tier's own split/merge
        self._starts: list[bytes] = [b""]
        self._ends: list[bytes] = [b""]
        # the tier is SHARED across every Session over this fleet: writes
        # and split/merge bookkeeping serialize here (two threads mid-split
        # would interleave the parallel list updates).  Rank 30: the
        # INNERMOST lock of the write path — TableStore._lock (10) and the
        # binlog retry lock (20) are both held when write_ops lands here,
        # and code under this lock never takes either of them back
        self._mu = threading.RLock()

    @classmethod
    def get_or_create(cls, fleet: "StoreFleet", table_id: int, table_key: str,
                      row_schema: Schema, key_columns: list[str],
                      split_rows: int = 0) -> "ReplicatedRowTier":
        """The fleet keeps one tier per table so a NEW Database over the same
        fleet recovers the existing replicated state instead of allocating
        fresh (empty) regions."""
        with fleet.tier_lock:
            tier = fleet.row_tiers.get(table_key)
            if tier is None:
                tier = cls(fleet, table_id, table_key, row_schema,
                           key_columns, split_rows)
                fleet.row_tiers[table_key] = tier
                return tier
        if tier.row_schema != row_schema or \
                list(tier.key_columns) != list(key_columns):
            # silent column-by-name replay against a mismatched schema would
            # corrupt data (extra columns vanish, missing ones read NULL),
            # and different key columns would decode keys with the wrong
            # codec (ADVICE r03 low #5) — recover the catalog first
            raise ValueError(
                f"table {table_key!r}: requested schema/key columns do not "
                f"match the fleet's replicated row encoding (recover the "
                f"catalog — post-ALTER schema — before attaching)")
        return tier

    # -- routing ----------------------------------------------------------
    def _route(self, key: bytes) -> int:
        """Key -> index of the owning region (rightmost start <= key —
        the reference's SchemaFactory range lookup)."""
        return max(bisect.bisect_right(self._starts, key) - 1, 0)

    def _split_ops(self, ops: list[tuple[int, bytes, bytes]]):
        per: dict[int, list] = {}
        for op in ops:
            per.setdefault(self._route(op[1]), []).append(op)
        return per

    # -- writes -----------------------------------------------------------
    def write_ops(self, ops: list[tuple[int, bytes, bytes]]) -> None:
        """Replicate a write batch.  Single region -> 1PC (one CMD_WRITE in
        that group's log); multiple regions -> 2PC with the first touched
        group as primary.  Raises ReplicationError when quorum is gone.
        After a successful commit, oversized regions split (the store-side
        size trigger, region.cpp:733-787)."""
        if not ops:
            return
        from ..obs import trace

        with self._mu, trace.span("replicated.write", table=self.table_key,
                                  ops=len(ops)):
            per = self._split_ops(ops)
            if len(per) == 1:
                idx, batch = next(iter(per.items()))
                g = self.groups[idx]
                if not g.write(batch):
                    raise ReplicationError(
                        f"region {g.region_id} of {self.table_key} "
                        f"has no quorum")
            else:
                groups = [self.groups[i] for i in sorted(per)]
                by_rid = {self.groups[i].region_id: b
                          for i, b in per.items()}
                try:
                    TwoPhaseCoordinator(groups).write(by_rid,
                                                      txn_id=next_txn_id())
                except TwoPhaseError as e:
                    raise ReplicationError(str(e)) from None
            self.maybe_split()

    # -- reads ------------------------------------------------------------
    def _leader_node(self, meta, group: RaftGroup):
        """Leader replica for one region, meta routing consulted first
        (reference: frontend replica selection, fetcher_store.cpp:351).
        Falls back to a live election when meta has no entry (e.g. a region
        mid-retirement after an aborted merge) or its hint is stale."""
        try:
            rm = self.fleet.meta.regions.get(meta.region_id)
        except RuntimeError:       # meta itself quorumless: reads go on
            rm = None
        addr = rm.leader if rm is not None else ""
        nid = self.fleet._ids.get(addr)
        if nid is not None and nid in group.bus.nodes and \
                nid not in group.bus.down and \
                group.bus.nodes[nid].core.role == LEADER:
            node = group.bus.nodes[nid]
        else:
            node = group.bus.nodes[group.leader()]
        # Raft §8 read barrier: a just-elected leader may not have applied
        # entries the OLD leader committed until its election no-op commits;
        # pump the bus until a current-term entry is committed so a read
        # right after a leader kill never misses acknowledged writes
        for _ in range(400):
            if node.core.read_safe:
                break
            group.bus.advance(1)
        node.apply_committed()
        return node

    def follower_rows(self, max_lag: int = 0,
                      resource_tag: str = "") -> list[dict]:
        """Bounded-staleness read served by a FOLLOWER or LEARNER replica
        per region (reference: replica selection with resource-isolated
        learner reads, fetcher_store.cpp:351 choose_opt_instance).

        Replica choice: a non-leader replica whose meta instance carries
        ``resource_tag`` (when given) and whose applied index is within
        ``max_lag`` entries of the leader's commit index — the applied-
        index staleness bound.  Falls back to the leader for a region with
        no qualifying replica (never fails the read, never returns rows
        staler than the bound)."""
        with self._mu:
            out: list[dict] = []
            for m, g in zip(self.metas, self.groups):
                node = self._pick_read_replica(g, max_lag, resource_tag)
                out.extend(node.rows_in_range())
            return out

    def _pick_read_replica(self, g: RaftGroup, max_lag: int,
                           resource_tag: str):
        ldr_id = g.leader()
        ldr = g.bus.nodes[ldr_id]
        commit = ldr.core.commit_index
        meta_insts = getattr(self.fleet.meta, "instances", {})
        for nid, node in sorted(g.bus.nodes.items()):
            if nid == ldr_id or nid in g.bus.down:
                continue
            if resource_tag:
                addr = self.fleet._addr.get(nid, "")
                inst = meta_insts.get(addr)
                if inst is None or inst.resource_tag != resource_tag:
                    continue
            node.apply_committed()       # drain anything already delivered
            if commit - node.applied_index <= max_lag:
                return node
        return ldr                        # no qualifying replica: leader read

    def _stale_read_node(self, g: RaftGroup):
        """Leaderless degradation (reference: learner replicas keep serving
        reads when the voting quorum is gone): the most advanced LIVE
        replica — learners included, they replicate everything — serves a
        best-effort stale read.  None when every replica is down or the
        fallback flag is off."""
        if not bool(FLAGS.learner_read_fallback):
            return None
        best = None
        for nid, node in sorted(g.bus.nodes.items()):
            if nid in g.bus.down:
                continue
            node.apply_committed()      # drain anything already delivered
            if best is None or node.applied_index > best.applied_index:
                best = node
        return best

    def scan_rows(self) -> list[dict]:
        """Latest committed row versions across all regions (leader reads,
        each filtered to the range the region OWNS so mid-split copies are
        never read twice).  Includes ``__del`` marker rows — recovery replay
        needs them; callers counting LIVE rows use num_rows().  Serializes
        with writes/splits: a recovery scan mid-split would double- or
        under-read moved rows, and reads can pump a group bus a writer is
        also pumping.  A quorumless region degrades to a learner/stale read
        (learner_read_fallback) instead of failing the whole scan."""
        with self._mu:
            out: list[dict] = []
            for m, g in zip(self.metas, self.groups):
                try:
                    node = self._leader_node(m, g)
                except RuntimeError:
                    node = self._stale_read_node(g)
                    if node is None:
                        raise
                    metrics.learner_fallback_reads.add(1)
                out.extend(node.rows_in_range())
            return out

    def num_rows(self) -> int:
        """Live (non-deleted) replicated rows."""
        return sum(1 for r in self.scan_rows() if not r.get("__del"))

    # -- split / merge -----------------------------------------------------
    def _threshold(self) -> int:
        return self.split_rows or int(FLAGS.region_split_rows)

    def maybe_split(self) -> int:
        """Split every region exceeding the size threshold (checked after
        each committed write — the reference's store-side split trigger).
        Returns how many splits happened."""
        threshold = self._threshold()
        done = 0
        if threshold <= 0:
            return done
        with self._mu:
            return self._maybe_split_locked(threshold)

    def _maybe_split_locked(self, threshold: int) -> int:
        done = 0
        i = 0
        while i < len(self.groups):
            rm = self.fleet.meta.regions.get(self.metas[i].region_id)
            if rm is not None and rm.state != SERVING:
                i += 1      # mid live-split/migration: the fleet owns it
                continue
            node = self._leader_node(self.metas[i], self.groups[i])
            if node.table.num_live_keys() >= threshold:
                try:
                    self._split_region_locked(i)
                    done += 1
                    continue       # the left half may still be oversized
                except SplitError:
                    pass           # e.g. all rows share one key: unsplittable
            i += 1
        return done

    def split_region(self, idx: int):
        """Split one region at its median key, under consensus — the
        reference's lifecycle (region.cpp:4472 split init, :6573 data copy,
        :7198 catch-up, :4864 add_version finalize):

        1. meta registers the child on the parent's peers (routing version
           bumps on both sides),
        2. the fleet materializes the child raft group and the parent's
           upper half replicates into it (one committed write = copy +
           catch-up, which is exact here because the tier serializes writes),
        3. both sides raft-commit their new range (after this, stale-routed
           writes are filtered — the version_old rejection analog),
        4. the parent trims moved rows (the split-aware compaction filter).

        On abort the child retires and the parent's meta range is restored.
        """
        with self._mu:
            return self._split_region_locked(idx)

    def _split_region_locked(self, idx: int):
        g, m = self.groups[idx], self.metas[idx]
        try:
            node = self._leader_node(m, g)
        except RuntimeError:
            raise SplitError(
                f"region {m.region_id} has no electable quorum") from None
        pairs = [(k, v) for k, v in node.table.scan_raw()
                 if node._covers(k)]
        if len(pairs) < 2:
            raise SplitError(f"region {m.region_id} too small to split")
        mid = pairs[len(pairs) // 2][0]
        if mid == pairs[0][0]:
            raise SplitError(f"region {m.region_id} has no usable split key")
        old_start, old_end = self._starts[idx], self._ends[idx]
        meta = self.fleet.meta
        new_m = meta.split_region_key(m.region_id, mid.hex())
        new_g = self.fleet.materialize_region(
            new_m, schema=self.row_schema, key_columns=self.key_columns)
        moved = [(0, k, v) for k, v in pairs if k >= mid]
        ok = (not moved) or new_g.write(moved)
        ok = ok and new_g.set_range(new_m.version, mid, old_end)
        ok = ok and g.set_range(new_m.version, old_start, mid)
        if ok:
            # past the point of no return: both sides committed their new
            # ranges.  Trim is GC, not correctness (reads filter by
            # ownership) — a quorum blip here must not "abort" a split
            # that already happened, or the restored meta range would
            # route writes the parent now rejects.
            g.trim()
        if not ok:
            self.fleet.groups.pop(new_m.region_id, None)
            try:
                meta.merge_regions_key(m.region_id, new_m.region_id)
            except Exception:  # meta may itself be quorumless
                metrics.count_swallowed("replicated.split_unwind")
            raise SplitError(
                f"split of region {m.region_id} aborted (no quorum)")
        self.metas.insert(idx + 1, new_m)
        self.groups.insert(idx + 1, new_g)
        self._starts.insert(idx + 1, mid)
        self._ends[idx] = mid
        self._ends.insert(idx + 1, old_end)
        metrics.region_splits.add(1)
        return new_m

    def split_region_online(self, region_id: int,
                            chaos_hook: Optional[Callable[[str], None]]
                            = None):
        """Live, fenced split of one region — the tick-driven path (the
        reference's full lifecycle: region.cpp:4472 split init, :6573
        no-stop-write data copy, :7198 log catch-up, :4864 add_version
        finalize).  Unlike :meth:`split_region` (write-path size trigger,
        copy under the tier lock), the bulk copy here runs with the tier
        lock RELEASED — the parent keeps serving reads and writes:

        1. under the lock: pick the median split key, snapshot the upper
           half, register the child in meta (``begin_split`` — state
           SPLITTING, ROUTING UNCHANGED) and materialize its raft group
           on the parent's peers,
        2. outside the lock: bulk-replicate the snapshot into the child
           (``region.handoff`` failpoint) while writes keep landing in
           the parent,
        3. under the lock again (the fence — writers are briefly held):
           replicate the delta the parent absorbed meanwhile, raft-commit
           both sides' new ranges (``region.split_fence`` failpoint fires
           before the fence), then flip routing atomically — meta
           ``commit_split`` + the tier's parallel lists in one critical
           section — and trim the parent.

        Any failure before the routing flip aborts cleanly: the child
        retires, ``abort_split`` restores the parent to SERVING, routing
        was never touched — a half-routed region cannot exist.
        ``chaos_hook(phase)`` ("begin", "copied") runs with the lock
        released so scenarios can inject writes/partitions mid-split.
        """
        meta = self.fleet.meta
        t0 = time.perf_counter()
        with self._mu:
            idx = next((i for i, m in enumerate(self.metas)
                        if m.region_id == region_id), None)
            if idx is None:
                meta.set_region_state(region_id, SERVING)
                raise SplitError(f"region {region_id} not in tier "
                                 f"{self.table_key}")
            g, m = self.groups[idx], self.metas[idx]
            try:
                node = self._leader_node(m, g)
            except RuntimeError:
                meta.set_region_state(region_id, SERVING)
                raise SplitError(f"region {region_id} has no electable "
                                 f"quorum") from None
            pairs = [(k, v) for k, v in node.table.scan_raw()
                     if node._covers(k)]
            mid = pairs[len(pairs) // 2][0] if len(pairs) >= 2 else None
            if mid is None or mid == pairs[0][0]:
                meta.set_region_state(region_id, SERVING)
                raise SplitError(f"region {region_id} has no usable "
                                 f"split key")
            snap = {k: v for k, v in pairs if k >= mid}
            if failpoint.ENABLED:
                if failpoint.hit("region.split_fence", region=region_id):
                    meta.set_region_state(region_id, SERVING)
                    raise SplitError(f"region {region_id}: split fence "
                                     f"failed (injected)")
            child = meta.begin_split(region_id, mid.hex())
            new_g = self.fleet.materialize_region(
                child, schema=self.row_schema, key_columns=self.key_columns)
        # -- phase 2: bulk handoff, tier lock RELEASED (parent serves) ----
        ok = True
        if chaos_hook is not None:
            chaos_hook("begin")
        if failpoint.ENABLED:
            if failpoint.hit("region.handoff", region=region_id,
                             child=child.region_id):
                ok = False
        moved = [(0, k, v) for k, v in sorted(snap.items())]
        ok = ok and ((not moved) or new_g.write(moved))
        if ok and chaos_hook is not None:
            chaos_hook("copied")
        # -- phase 3: fence + delta catch-up + atomic routing switch ------
        if ok:
            with self._mu:
                idx = next((i for i, mm in enumerate(self.metas)
                            if mm.region_id == region_id), None)
                ok = idx is not None
                node = None
                if ok:
                    g = self.groups[idx]
                    try:
                        node = self._leader_node(self.metas[idx], g)
                    except RuntimeError:
                        ok = False
                if ok:
                    # writes that landed >= mid since the snapshot: new or
                    # changed values copy over, vanished keys delete —
                    # exact because the lock now excludes further writes
                    upper = {k: v for k, v in node.table.scan_raw()
                             if k >= mid and node._covers(k)}
                    delta = [(0, k, v) for k, v in sorted(upper.items())
                             if snap.get(k) != v]
                    delta += [(1, k, b"")
                              for k in sorted(set(snap) - set(upper))]
                    ok = (not delta) or new_g.write(delta)
                    old_end = self._ends[idx]
                    ok = ok and new_g.set_range(child.version, mid, old_end)
                    ok = ok and g.set_range(child.version,
                                            self._starts[idx], mid)
                    if ok:
                        meta.commit_split(region_id, child.region_id)
                        self.metas.insert(idx + 1, child)
                        self.groups.insert(idx + 1, new_g)
                        self._starts.insert(idx + 1, mid)
                        self._ends[idx] = mid
                        self._ends.insert(idx + 1, old_end)
                        g.trim()    # GC of moved rows; reads filter by
                        #             ownership either way
                        metrics.region_splits.add(1)
                        metrics.region_handoff_ms.observe(
                            (time.perf_counter() - t0) * 1e3)
                        return child
        # -- abort: routing never switched, parent unchanged --------------
        self.fleet.retire_region(child.region_id)
        meta.abort_split(region_id, child.region_id)
        metrics.region_split_aborts.add(1)
        raise SplitError(f"live split of region {region_id} aborted "
                         f"(no quorum on copy/fence)")

    def maybe_merge(self) -> int:
        """Merge adjacent undersized regions (combined keys under a quarter
        of the split threshold), so a shrunken table does not keep paying
        per-region quorum costs forever.  Returns merges performed."""
        floor = max(2, self._threshold() // 4)
        with self._mu:
            return self._maybe_merge_locked(floor)

    def _maybe_merge_locked(self, floor: int) -> int:
        done = 0
        i = 0
        while i + 1 < len(self.groups):
            a = self._leader_node(self.metas[i], self.groups[i])
            b = self._leader_node(self.metas[i + 1], self.groups[i + 1])
            if a.table.num_live_keys() + b.table.num_live_keys() < floor:
                try:
                    self._merge_region_locked(i)
                    done += 1
                    continue       # the survivor may absorb further
                except SplitError:
                    pass
            i += 1
        return done

    def merge_region(self, idx: int):
        """Merge region idx+1 into its left neighbor, under consensus:
        meta retires the right region from routing, the left raft-commits
        the widened range, then the right's rows replicate into it.  Until
        the copy commits, readers still reach the right's group (local
        routing is untouched), so no failure window loses or double-reads
        rows."""
        with self._mu:
            return self._merge_region_locked(idx)

    def _merge_region_locked(self, idx: int):
        if idx + 1 >= len(self.groups):
            raise SplitError("no right neighbor to merge")
        left_g, right_g = self.groups[idx], self.groups[idx + 1]
        left_m, right_m = self.metas[idx], self.metas[idx + 1]
        try:
            right_node = self._leader_node(right_m, right_g)
        except RuntimeError:
            raise SplitError(
                f"region {right_m.region_id} has no electable quorum") \
                from None
        pairs = [(k, v) for k, v in right_node.table.scan_raw()
                 if right_node._covers(k)]
        merged = self.fleet.meta.merge_regions_key(left_m.region_id,
                                                   right_m.region_id)
        ok = left_g.set_range(merged.version, self._starts[idx],
                              self._ends[idx + 1])
        ok = ok and ((not pairs) or left_g.write([(0, k, v)
                                                  for k, v in pairs]))
        if ok and right_node.cold_manifest:
            # the right's cold segments must survive the merge: fold its
            # manifest into the left's (raft-committed), or the evicted
            # rows would vanish from every future read and rebuild
            import json as _json

            left_node = self._leader_node(left_m, left_g)
            combined = sorted(set(map(tuple, left_node.cold_manifest)) |
                              set(map(tuple, right_node.cold_manifest)))
            ok = left_g.propose_cmd(CMD_COLD, 0, _json.dumps(
                {"op": "reset",
                 "entries": [list(e) for e in combined]}).encode())
        if not ok:
            raise SplitError(
                f"merge of region {right_m.region_id} aborted (no quorum)")
        # merge_regions_key already retired the right from meta routing;
        # retire_region drops the raft group too (idempotent on meta) so
        # neither registry leaks a group the other no longer routes to
        self.fleet.retire_region(right_m.region_id)
        self._ends[idx] = self._ends[idx + 1]
        for lst in (self.metas, self.groups, self._starts, self._ends):
            del lst[idx + 1]
        metrics.region_merges.add(1)
        return merged

    # -- maintenance -------------------------------------------------------
    # -- cold tier (reference: region_olap.cpp:445 flush_to_cold; manifest
    # raft-synced, bytes on the external FS) ------------------------------
    def flush_cold(self, fs, upto: Optional[int] = None) -> int:
        """Flush each region's hot rows (rowid <= watermark) into one
        immutable Parquet segment on ``fs``, then raft-commit the manifest
        entry + eviction.  The segment is written BEFORE the proposal: a
        crash in between leaves an orphan file (GC'able), never a manifest
        entry without bytes.  Returns rows flushed."""
        import json as _json

        from .coldfs import segment_bytes

        arrow = _schema_arrow(self.row_schema)
        rowid_col = self.key_columns[0]
        flushed = 0
        with self._mu:
            for m, g in zip(self.metas, self.groups):
                node = self._leader_node(m, g)
                rows = [r for r in self._decode_all(node)
                        if upto is None or r[rowid_col] <= upto]
                if not rows:
                    continue
                watermark = max(r[rowid_col] for r in rows)
                seq = self.alloc_rowids(1)
                seg = (f"{self.table_key}.r{m.region_id}"
                       f".s{seq}.parquet")
                fs.put(seg, segment_bytes(rows, arrow))
                payload = _json.dumps({"op": "add", "seq": int(seq),
                                       "file": seg,
                                       "watermark": int(watermark)}).encode()
                if not g.propose_cmd(CMD_COLD, 0, payload):
                    raise ReplicationError(
                        f"region {g.region_id}: cold manifest propose "
                        f"failed")
                flushed += len(rows)
        return flushed

    def _decode_all(self, node) -> list[dict]:
        """Every row-tier entry the region OWNS, del markers included —
        cold segments must carry the exact replayable state."""
        return [node.table.row_codec.decode(v)
                for k, v in node.table.scan_raw() if node._covers(k)]

    def region_ids(self) -> list[int]:
        """The regions' ids, in key order."""
        with self._mu:
            return [m.region_id for m in self.metas]

    def cold_manifest(self, i: int) -> list:
        """Region ``i``'s cold manifest, read on its leader replica."""
        with self._mu:
            return list(self._leader_node(self.metas[i], self.groups[i]).cold_manifest)

    def has_cold(self) -> bool:
        """True when any region's manifest references cold segments."""
        with self._mu:
            for m, g in zip(self.metas, self.groups):
                if self._leader_node(m, g).cold_manifest:
                    return True
            return False

    def cold_rows(self, fs) -> list[dict]:
        """All cold rows across regions in GLOBAL manifest order (entries
        carry a cluster-monotonic seq so replay order is well-defined even
        after splits/merges moved rowid ranges between regions)."""
        from .coldfs import segment_rows

        entries = []
        with self._mu:
            for m, g in zip(self.metas, self.groups):
                node = self._leader_node(m, g)
                entries.extend(node.cold_manifest)
        out: list[dict] = []
        seen = set()
        for seq, f, _w in sorted(entries):
            if f in seen:           # split copies may reference one file
                continue
            seen.add(f)
            out.extend(segment_rows(fs.get(f)))
        return out

    def cold_gc(self, fs) -> int:
        """Merge each region's segments into one (latest version per rowid,
        del-marked rows dropped) and reset the manifest; orphan files are
        deleted AFTER the reset commits.  Returns segments reclaimed."""
        import json as _json

        from .coldfs import segment_bytes, segment_rows

        arrow = _schema_arrow(self.row_schema)
        rowid_col = self.key_columns[0]
        candidates: set[str] = set()
        with self._mu:
            for m, g in zip(self.metas, self.groups):
                node = self._leader_node(m, g)
                if not node.cold_manifest:
                    continue
                latest: dict[int, dict] = {}
                raw_rows = 0
                for seq, f, _w in sorted(node.cold_manifest):
                    for r in segment_rows(fs.get(f)):
                        raw_rows += 1
                        latest[int(r[rowid_col])] = r
                live = [r for _, r in sorted(latest.items())
                        if not r.get("__del")]
                if len(node.cold_manifest) == 1 and len(live) == raw_rows:
                    continue    # single clean segment: nothing to reclaim
                old_files = [f for _, f, _w in node.cold_manifest]
                entries = []
                if live:
                    # keep the MAX of the merged segments' seqs: a fresh
                    # (higher) seq would re-order this region's old row
                    # versions ABOVE newer segments from sibling regions in
                    # the global replay, resurrecting stale values
                    seq = max(sq for sq, _f, _w in node.cold_manifest)
                    seg = (f"{self.table_key}.r{m.region_id}"
                           f".s{seq}.gc{len(old_files)}.parquet")
                    fs.put(seg, segment_bytes(live, arrow))
                    entries = [[int(seq), seg,
                                max(r[rowid_col] for r in live)]]
                payload = _json.dumps({"op": "reset",
                                       "entries": entries}).encode()
                if not g.propose_cmd(CMD_COLD, 0, payload):
                    raise ReplicationError(
                        f"region {g.region_id}: cold gc propose failed")
                candidates.update(old_files)
            # delete only files NO region still references: split children
            # can share a parent segment file across their manifests
            still_used: set[str] = set()
            for m, g in zip(self.metas, self.groups):
                node = self._leader_node(m, g)
                still_used.update(f for _s, f, _w in node.cold_manifest)
            reclaimed = 0
            for f in candidates - still_used:
                fs.delete(f)
                reclaimed += 1
        return reclaimed

    def hot_bytes(self) -> int:
        """Approximate live bytes held by the hot row tier (leader view) —
        the number cold eviction exists to shrink."""
        with self._mu:
            total = 0
            for m, g in zip(self.metas, self.groups):
                node = self._leader_node(m, g)
                total += sum(len(k) + len(v)
                             for k, v in node.table.scan_raw())
            return total

    def truncate(self) -> None:
        """TRUNCATE: retire the regions and create fresh (empty) ones —
        O(regions), vs per-row tombstones that would live in every replica
        and every future recovery scan forever."""
        self.reset_schema(self.row_schema, [])

    def reset_schema(self, row_schema: Schema,
                     ops: list[tuple[int, bytes, bytes]]) -> None:
        """ALTER TABLE boundary: the replicated row encoding is schema-bound
        (like the WAL), so the old-encoding regions retire and fresh groups
        replicate the rewritten rows in the new encoding.  Mirrors the
        reference where column DDL rewrites region state through raft
        (ddl_manager.cpp + region apply)."""
        self.release_regions()
        metas = self.fleet.create_table_regions(
            self.table_id, 1, schema=row_schema,
            key_columns=self.key_columns)
        groups = [self.fleet.group(m.region_id) for m in metas]
        # fleet calls stay outside the lock; the five routing attrs swap
        # together under it so a concurrent reader never sees new metas
        # with old starts (torn routing mid-ALTER)
        with self._mu:
            self.row_schema = row_schema
            self.metas = metas
            self.groups = groups
            self._starts, self._ends = [b""], [b""]
        if ops:
            self.write_ops(ops)

    def release_regions(self) -> None:
        """Retire this tier's raft groups from the fleet and the meta
        routing table (DROP TABLE / schema reset — without this, dropped
        tables' replicas would heartbeat and balance forever)."""
        with self._mu:
            metas = list(self.metas)
        for m in metas:
            self.fleet.retire_region(m.region_id)

    def alloc_rowids(self, n: int, floor: int = 0) -> int:
        """Cluster-wide rowid range from meta (auto-incr FSM shape): two
        frontends over the same fleet can never mint colliding keys."""
        return self.fleet.meta.alloc_ids(self.table_id, n, floor)

    def compact_all(self) -> None:
        """Snapshot every replica's state into its core, truncating logs."""
        with self._mu:
            groups = list(self.groups)
        for g in groups:
            for node in g.bus.nodes.values():
                node.compact()

    def available(self) -> bool:
        with self._mu:
            try:
                for g in self.groups:
                    g.leader()
            except RuntimeError:
                return False
            return True


def region_fragment_rows(pairs, manifest, fs, row_codec, key_codec,
                         lo, hi, stats):
    """Yield one region's LIVE rows — hot tier over cold tier — inside the
    byte range [``lo``, ``hi``) (``hi`` falsy = unbounded), for a store
    daemon executing a pushed-down fragment in place.

    Ordering/precedence mirrors ``column_store.attach_replicated``: the hot
    row tier is authoritative (its keys — *including* ``__del`` tombstones —
    mask every cold version of the same key), then cold segments replay
    newest-seq-first with a seen-key set so only the latest cold version of
    a key survives.  Cold rows are re-keyed via ``key_codec.encode_one`` and
    range-checked per row: split children can share a parent segment file,
    so two daemons folding sibling regions must each take only their slice
    or the merged partials would double-count.

    ``stats`` accumulates ``raw_bytes`` (hot key+value bytes scanned) and
    ``cold_bytes`` (segment blob bytes fetched) — the numerator of the
    fragment bytes-saved accounting.  Segment fetches are double-buffered
    through :func:`utils.prefetch.staged` so the network/disk read of
    segment N+1 overlaps the fold of segment N.
    """
    from ..utils.prefetch import staged
    from .coldfs import segment_rows

    seen: set[bytes] = set()
    for k, v in pairs:
        if k < lo or (hi and k >= hi):
            continue
        stats["raw_bytes"] = stats.get("raw_bytes", 0) + len(k) + len(v)
        seen.add(k)
        row = row_codec.decode(v)
        if not row.get("__del"):
            yield row
    if not manifest:
        return
    files, dedup = [], set()
    for _seq, f, _w in sorted(manifest, reverse=True):
        if f not in dedup:
            dedup.add(f)
            files.append(f)
    stats["cold_segments"] = stats.get("cold_segments", 0) + len(files)
    for _f, blob in staged(files, fs.get, name="fragment-cold"):
        stats["cold_bytes"] = stats.get("cold_bytes", 0) + len(blob)
        rows = segment_rows(blob)
        # one key batch a segment (the bytes of encode_one a row)
        for row, k in zip(rows, key_codec.encode_dicts(rows)):
            if k < lo or (hi and k >= hi) or k in seen:
                continue
            seen.add(k)
            if not row.get("__del"):
                yield row

