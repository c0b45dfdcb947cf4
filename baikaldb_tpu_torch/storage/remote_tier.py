"""Frontend side of the multi-process cluster: SQL DML over real store
daemons.

The reference frontend fans per-region plans out to store processes over
brpc with leader routing and NOT_LEADER redirect retries
(src/exec/fetcher_store.cpp:123,351) and commits multi-region
transactions primary-first (fetcher_store.cpp:1848-1904).  ``RemoteRowTier``
implements the same tier contract as ``storage.replicated.ReplicatedRowTier``
— so it plugs into the identical ``TableStore.attach_replicated`` seam — but
every operation is an RPC to store daemons (server/store_server.py) placed by
the meta daemon (server/meta_server.py).

A copy of ``baikaldb_tpu/storage/remote_tier.py`` (host-only Python); a
cold flush hashes a region's values in one batch (``_fnv64_many``).
"""

from __future__ import annotations

import time
from bisect import bisect_right
from typing import Optional

from ..chaos import failpoint
from ..raft.cluster import (CMD_COLD, CMD_COMMIT, CMD_DECIDE, CMD_PREPARE,
                            CMD_ROLLBACK,
                            CMD_SET_RANGE, CMD_TRIM, CMD_WRITE, encode_cmd,
                            encode_ops, encode_range)
from ..types import Schema
from ..utils.flags import FLAGS
from ..utils.net import RpcClient, RpcError, RpcTimeout
from .replicated import ReplicationError, SplitError, _fnv64
from .rowstore import RowCodec


from ..utils.flags import define
from ..utils import metrics

define("pushdown_reads", "auto",
       "daemon-plane fragment pushdown: 'auto' (push eligible SELECTs of "
       "not-yet-attached tables to the store daemons), 'always' (push every "
       "eligible SELECT), 'off' (raw-pull + local image only)")


class PushdownUnsupported(RuntimeError):
    """The store daemons cannot serve this fragment (cold tier present,
    unsupported expression, group-cap overflow): fall back to the raw-scan
    + columnar-image path."""


class StaleRoutingError(RuntimeError):
    """A store rejected a write routed with pre-split ranges (the
    reference's version_old response): refresh routing and re-send."""

    def __init__(self, region_id: int):
        super().__init__(f"stale routing for region {region_id}")
        self.region_id = region_id


class ClusterClient:
    """Frontend handle on one deployment: the meta daemon + store daemons."""

    def __init__(self, meta_address: str):
        import threading
        self.meta = RpcClient(meta_address)
        self._stores: dict[str, RpcClient] = {}
        self.tiers: dict[str, "RemoteRowTier"] = {}
        self.tier_lock = threading.Lock()

    def store(self, address: str) -> RpcClient:
        c = self._stores.get(address)
        if c is None:
            c = self._stores[address] = RpcClient(address, timeout=8.0)
        return c


def stable_table_id(table_key: str) -> int:
    """Frontends come and go; the cluster-wide table id must not depend on a
    process-local catalog counter."""
    return _fnv64(table_key.encode()) % (1 << 31)


def _twopc_remote(parts: list, txn: int, deadline_s: float) -> None:
    """Primary-first 2PC over daemon-hosted regions, possibly spanning
    SEVERAL tiers (the reference's global-index DML: lock nodes across
    main-table and index regions, separate.cpp:653).  ``parts`` is
    [(tier, region, op_batch)]; parts[0] is the primary — its region holds
    the commit-decision record.  After the decision commits, the record is
    also hinted onto every other participant region so each TIER's in-doubt
    recovery can resolve locally (recover_in_doubt additionally consults
    sibling tiers for the uncommon window where the hints never landed)."""
    prepared: list = []
    try:
        for t, r, batch in parts:
            if failpoint.ENABLED:
                if failpoint.hit("2pc.prepare", txn=txn,
                                 region=r.region_id):
                    raise ReplicationError(
                        f"2pc.prepare dropped by failpoint "
                        f"(region {r.region_id})")
            t._propose(r, encode_cmd(CMD_PREPARE, txn, encode_ops(batch)))
            prepared.append((t, r))
    except (ReplicationError, StaleRoutingError):
        for t, r in prepared:
            try:
                t._propose(r, encode_cmd(CMD_ROLLBACK, txn))
            except (ReplicationError, StaleRoutingError):
                pass            # region will resolve in-doubt via primary
        raise
    pt, pr, _ = parts[0]
    # the decision propose is the commit point: it must succeed or the
    # txn is NOT committed.  A propose FAILURE is not proof the record
    # missed the log (a timeout loses the ack, not the entry), so rolling
    # prepares back directly could tear the txn.  Replicate an explicit
    # ABORT decision instead (apply is first-writer-wins), then act on the
    # WINNING decision read back from the primary.
    try:
        if failpoint.ENABLED:
            if failpoint.hit("2pc.decide", txn=txn):
                raise ReplicationError("2pc.decide dropped by failpoint")
        pt._propose(pr, encode_cmd(CMD_DECIDE, txn, bytes([CMD_COMMIT])))
    except ReplicationError:
        try:
            pt._propose(pr, encode_cmd(CMD_DECIDE, txn,
                                       bytes([CMD_ROLLBACK])))
            st = pt._leader_call(pr, "txn_status", deadline_s)
            # a missing record is NOT evidence of abort: txn_status may
            # have been answered by a deposed leader that applied neither
            # DECIDE entry — treat it as in-doubt
            w = st["decisions"].get(str(txn)) if st else None
            winner = int(w) if w is not None else None
        except ReplicationError:
            winner = None
        if winner is None:
            # abort record unconfirmed: leave prepares in doubt for
            # recovery to resolve from whatever decision exists
            raise
        if winner != CMD_COMMIT:
            for t, r, _ in parts:
                try:
                    t._propose(r, encode_cmd(CMD_ROLLBACK, txn))
                except (ReplicationError, StaleRoutingError):
                    pass        # recovery rolls back from the abort record
            raise ReplicationError(f"2PC decision failed for txn {txn}")
        # the commit decision actually landed: fall through — committed
    # past the decision the txn IS committed: completion failures must not
    # surface as txn failure (the frontend would roll its cache back while
    # the replicas hold the commit) — best-effort from here; in-doubt
    # prepares resolve from the decision record
    for t, r, _ in parts[1:]:
        try:
            t._propose(r, encode_cmd(CMD_DECIDE, txn, bytes([CMD_COMMIT])))
        except (ReplicationError, StaleRoutingError):
            pass                # recovery consults sibling tiers instead
    for t, r, _ in parts:
        try:
            t._propose(r, encode_cmd(CMD_COMMIT, txn))
        except (ReplicationError, StaleRoutingError):
            pass


def write_ops_atomic_remote(pairs: list, commit_ts: int = 0) -> None:
    """Commit several RemoteRowTiers' write batches as ONE daemon-plane
    transaction (the cross-tier analog of ReplicatedRowTier's
    write_ops_atomic; reference: global-index DML 2PC).  ``pairs`` is
    [(tier, ops)]; the first tier with ops holds the primary region.
    ``commit_ts`` is the fleet writer's argument: the daemons' decision
    record keeps no stamp, as in the JAX package, so it goes unused."""
    pairs = [(t, ops) for t, ops in pairs if ops]
    if not pairs:
        return
    if len(pairs) == 1:
        pairs[0][0].write_ops(pairs[0][1])
        return
    tiers = list({t.table_key: t for t, _ in pairs}.values())
    for attempt in range(3):
        try:
            parts: list = []
            for t, ops in pairs:
                per = t._route_ops(ops)
                by_id = {r.region_id: r for r in t.regions}
                for rid in sorted(per):
                    parts.append((t, by_id[rid], per[rid]))
            if len(parts) == 1:
                t, r, batch = parts[0]
                t._propose(r, encode_cmd(CMD_WRITE, 0, encode_ops(batch)))
            else:
                _twopc_remote(parts, pairs[0][0].alloc_rowids(1),
                              max(t.propose_deadline for t in tiers))
            break
        except StaleRoutingError:
            if attempt == 2:
                raise ReplicationError("atomic write: routing kept going "
                                       "stale")
            for t in tiers:
                t.refresh_routing()
    for t in tiers:
        try:
            t.maybe_split()
        except Exception:       # split is maintenance; count, don't die
            metrics.count_swallowed("remote_tier.maybe_split")


class _RemoteRegion:
    """One region's routing state: peers as (store_id, address) plus the
    [start_key, end_key) slice it owns (b"" = unbounded)."""

    def __init__(self, region_id: int, peers: list[tuple[int, str]],
                 leader: str, start_key: bytes = b"", end_key: bytes = b"",
                 version: int = 1):
        self.region_id = region_id
        self.peers = peers
        self.leader_addr = leader or (peers[0][1] if peers else "")
        self.start_key = start_key
        self.end_key = end_key
        self.version = version

    def addr_of(self, store_id: int) -> Optional[str]:
        for sid, addr in self.peers:
            if sid == store_id:
                return addr
        return None


class RemoteRowTier:
    """Same API as ReplicatedRowTier, over the cluster RPC plane.

    Row keys are hidden rowids allocated as CLUSTER-WIDE ranges from the
    meta daemon (``alloc_rowids`` — the auto-incr range discipline), so
    concurrent frontends never mint colliding keys.  Concurrent UPDATEs
    of the same row resolve by raft apply order (last writer wins); each
    frontend reads its own attach-time columnar image plus its own
    writes."""

    def __init__(self, cluster: ClusterClient, table_key: str,
                 row_schema: Schema, key_columns: list[str],
                 split_rows: int = 0, propose_deadline: float = 12.0):
        self.cluster = cluster
        self.table_key = table_key
        self.table_id = stable_table_id(table_key)
        self.row_schema = row_schema
        self.key_columns = list(key_columns)
        self.row_codec = RowCodec(row_schema)
        self.propose_deadline = propose_deadline
        # 0 = read the live region_split_rows flag at each check
        self.split_rows = split_rows
        self._writes_since_check = 0
        # fragment bodies already pushed to this table's stores by content
        # hash: a published fragment re-dispatches as hash-only, so its
        # plan bytes cross the wire exactly once per frontend
        self._frag_published: set[str] = set()
        existing = cluster.meta.call("table_regions", table_id=self.table_id)
        if existing:
            self.regions = sorted((self._from_wire(w) for w in existing),
                                  key=lambda r: r.start_key)
            starts = [r.start_key for r in self.regions]
            if len(starts) != len(set(starts)):
                # pre-range (hash-routed) layouts have multiple unbounded
                # regions: range routing over them would double-serve keys
                raise ValueError(
                    f"table {table_key!r}: legacy hash-routed region layout "
                    f"(overlapping ranges); drop and reload the table")
        else:
            created = cluster.meta.call("create_regions",
                                        table_id=self.table_id, n_regions=1)
            self.regions = [self._from_wire(w) for w in created]
            self._materialize()
            return
        # attaching to an EXISTING table: resolve any in-doubt 2PC state a
        # crashed frontend left behind before serving reads from it
        # (bounded deadline: this runs under the cluster's tier lock)
        try:
            self.recover_in_doubt()
        except (ReplicationError, StaleRoutingError, RpcError, OSError):
            pass    # daemons unreachable: reads will surface the error

    @classmethod
    def get_or_create(cls, cluster: ClusterClient, table_key: str,
                      row_schema: Schema, key_columns: list[str],
                      split_rows: int = 0) -> "RemoteRowTier":
        with cluster.tier_lock:
            tier = cluster.tiers.get(table_key)
            if tier is None:
                tier = cls(cluster, table_key, row_schema, key_columns,
                           split_rows)
                cluster.tiers[table_key] = tier
                return tier
        if tier.row_schema != row_schema or \
                list(tier.key_columns) != list(key_columns):
            raise ValueError(
                f"table {table_key!r}: requested schema does not match the "
                f"cluster's replicated row encoding (recover the catalog — "
                f"post-ALTER schema — before attaching)")
        return tier

    def _from_wire(self, w: dict) -> _RemoteRegion:
        return _RemoteRegion(int(w["region_id"]),
                             [(int(sid), addr) for sid, addr in w["peers"]],
                             w.get("leader", ""),
                             bytes.fromhex(w.get("start_key", "") or ""),
                             bytes.fromhex(w.get("end_key", "") or ""),
                             int(w.get("version", 1)))

    def _materialize(self, regions: Optional[list] = None) -> None:
        """init_region fan-out (store.interface.proto:425): every peer store
        instantiates its replica."""
        from ..server.store_server import schema_to_wire

        fields = schema_to_wire(self.row_schema)
        for r in (regions if regions is not None else self.regions):
            for _, addr in r.peers:
                self.cluster.store(addr).try_call(
                    "create_region", region_id=r.region_id,
                    peers=[[sid, a] for sid, a in r.peers],
                    fields=fields, key_columns=self.key_columns)

    # -- leader routing ---------------------------------------------------
    def _propose(self, region: _RemoteRegion, payload: bytes) -> None:
        """Propose to the region's leader, following NOT_LEADER hints and
        riding out elections (fetcher_store's retry loop).  Every round
        tries the hinted leader first, then EVERY peer — a round-robin that
        can never starve a replica (a hint pointing at a dead or stale
        leader must not pin the retry loop to one follower)."""
        from ..obs import trace

        with trace.span("region.propose", region=region.region_id,
                        table=self.table_key):
            self._propose_routed(region, payload)

    def _propose_routed(self, region: _RemoteRegion,
                        payload: bytes) -> None:
        deadline = time.monotonic() + self.propose_deadline
        hint = region.leader_addr
        while time.monotonic() < deadline:
            tried = []
            for addr in [hint] + [a for _, a in region.peers if a != hint]:
                if not addr or addr in tried:
                    continue
                tried.append(addr)
                resp = self.cluster.store(addr).try_call(
                    "propose", region_id=region.region_id, payload=payload,
                    wait_s=3.0)
                if resp is None:
                    continue
                status = resp.get("status")
                if status == "ok":
                    region.leader_addr = addr
                    return
                if status == "version_old":
                    # this frontend's cached ranges predate a split by
                    # another frontend: refresh and let the caller re-route
                    raise StaleRoutingError(region.region_id)
                if status == "not_leader":
                    new_hint = region.addr_of(int(resp.get("leader", -1)))
                    if new_hint and new_hint not in tried and \
                            time.monotonic() < deadline:
                        resp2 = self.cluster.store(new_hint).try_call(
                            "propose", region_id=region.region_id,
                            payload=payload, wait_s=3.0)
                        tried.append(new_hint)
                        if resp2 is not None and resp2.get("status") == "ok":
                            region.leader_addr = new_hint
                            return
                elif status == "no_region":
                    # the store lost the replica (daemon restart) OR the
                    # region was merged/dropped away; meta decides — blind
                    # re-materialization would resurrect a retired region
                    # as an unrouted zombie that swallows acked writes
                    wire = self.cluster.meta.call("table_regions",
                                                  table_id=self.table_id)
                    if any(int(w["region_id"]) == region.region_id
                           for w in wire):
                        self._materialize([region])
                    else:
                        raise StaleRoutingError(region.region_id)
            hint = region.leader_addr
            time.sleep(0.15)        # election in progress: next round
        raise ReplicationError(
            f"region {region.region_id} of {self.table_key}: no leader "
            f"accepted the write within {self.propose_deadline}s")

    # -- tier API ----------------------------------------------------------

    def _leader_call(self, region: _RemoteRegion, method: str,
                     deadline_s: Optional[float] = None, **kw):
        """One leader-routed RPC: try the hinted leader, rotate through
        every peer, update the hint on success.  None on timeout (the
        shared retry policy of scans / size checks / txn status)."""
        deadline = time.monotonic() + (deadline_s if deadline_s is not None
                                       else self.propose_deadline)
        candidates = [region.leader_addr] + \
            [a for _, a in region.peers if a != region.leader_addr]
        i = 0
        while time.monotonic() < deadline:
            addr = candidates[i % len(candidates)]
            i += 1
            resp = self.cluster.store(addr).try_call(
                method, region_id=region.region_id, **kw)
            if resp is not None and resp.get("status") == "ok":
                region.leader_addr = addr
                return resp
            time.sleep(0.1)
        return None

    # how long a prepare must sit undecided before attach-time recovery may
    # roll it back: a LIVE coordinator's prepare->decide window is bounded
    # by its propose deadline, so anything older is a dead coordinator
    IN_DOUBT_GRACE_S = 60.0

    def recover_in_doubt(self, deadline_s: float = 2.0) -> dict:
        """Attach-time resolution of prepared-but-undecided transactions a
        crashed frontend left behind (the reference's in-doubt recovery:
        secondaries query the primary's decision, region.cpp:598/684;
        TransactionPool restart recovery).

        A txn COMPLETES as committed iff some region holds its CMD_DECIDE
        commit record (always safe: the record means the coordinator
        passed the decision point, and a duplicate COMMIT is a no-op).
        ROLLBACK requires three safeguards: the prepare is OLDER than the
        grace window (never abort a live coordinator mid-2PC), txn ids are
        cluster-allocated (a fresh frontend's counter cannot alias an old
        decision record), and EVERY region answered (an unreachable
        primary might hold the commit decision — rolling back a secondary
        then would split the txn)."""
        statuses = {r.region_id: self._leader_call(r, "txn_status",
                                                   deadline_s)
                    for r in self.regions}
        all_known = all(st is not None for st in statuses.values())
        decided: set[int] = set()
        aborted: set[int] = set()
        for st in statuses.values():
            if st:
                decided.update(int(t) for t, d in st["decisions"].items()
                               if d == CMD_COMMIT)
                aborted.update(int(t) for t, d in st["decisions"].items()
                               if d == CMD_ROLLBACK)
        # cross-TIER transactions (global-index DML) record their decision
        # on the primary region, which may belong to another table's tier:
        # before treating a prepare as undecided, consult the sibling tiers
        # attached to this cluster (an RPC per sibling region, but only
        # when an unresolved prepare actually exists)
        unresolved = set()
        for st in statuses.values():
            if st:
                unresolved.update(int(t) for t in st["prepared"]
                                  if int(t) not in decided and
                                  int(t) not in aborted)
        if unresolved:
            for sib in list(getattr(self.cluster, "tiers", {}).values()):
                if sib is self:
                    continue
                for r in sib.regions:
                    st = sib._leader_call(r, "txn_status", deadline_s)
                    if not st:
                        all_known = False   # an unreachable sibling region
                        continue            # might hold the commit decision
                    decided.update(int(t) for t, d in
                                   st["decisions"].items()
                                   if d == CMD_COMMIT and int(t) in
                                   unresolved)
                    aborted.update(int(t) for t, d in
                                   st["decisions"].items()
                                   if d == CMD_ROLLBACK and int(t) in
                                   unresolved)
        out: dict[int, str] = {}
        for r in self.regions:
            st = statuses.get(r.region_id)
            if not st:
                continue
            for txn in st["prepared"]:
                txn = int(txn)
                try:
                    if txn in decided:
                        self._propose(r, encode_cmd(CMD_COMMIT, txn))
                        out[txn] = "committed"
                    elif txn in aborted:
                        # explicit abort record: authoritative — no grace
                        # window needed
                        self._propose(r, encode_cmd(CMD_ROLLBACK, txn))
                        out.setdefault(txn, "rolled_back")
                    elif all_known and \
                            float(st["prepared_age"].get(str(txn), 0.0)) \
                            > self.IN_DOUBT_GRACE_S:
                        self._propose(r, encode_cmd(CMD_ROLLBACK, txn))
                        out.setdefault(txn, "rolled_back")
                    else:
                        out.setdefault(txn, "deferred")
                except (ReplicationError, StaleRoutingError):
                    out[txn] = "unresolved"   # next attach retries
        return out

    # -- cold tier (daemon plane; apply logic is shared ReplicatedRegion
    # code — see raft/cluster.py CMD_COLD) -------------------------------
    def _region_manifest(self, region: _RemoteRegion) -> list:
        resp = self._leader_call(region, "cold_manifest", 2.0)
        if resp is None:
            raise ReplicationError(
                f"region {region.region_id}: cold manifest unavailable")
        return [(int(s), f, int(w)) for s, f, w in resp["entries"]]

    def _with_routing_retry(self, fn):
        """The cold entry points retry stale routing like scan_rows and
        write_ops do (another frontend may have split regions)."""
        for attempt in range(3):
            try:
                return fn()
            except StaleRoutingError:
                if attempt == 2:
                    raise ReplicationError(
                        f"{self.table_key}: routing kept going stale")
                self.refresh_routing()

    def region_ids(self) -> list[int]:
        """The regions' ids, in key order."""
        return [r.region_id for r in list(self.regions)]

    def cold_manifest(self, i: int) -> list:
        """Region ``i``'s cold manifest, asked of its leader daemon."""
        return self._region_manifest(self.regions[i])

    def has_cold(self) -> bool:
        """True when any region's manifest references cold segments;
        propagates unavailability (a transiently leaderless region must
        surface as the REAL error, not as phantom cold state)."""
        def go():
            return any(self._region_manifest(r) for r in self.regions)
        return self._with_routing_retry(go)

    def flush_cold(self, fs, upto: Optional[int] = None) -> int:
        """Flush daemon-hosted hot rows into immutable segments on ``fs``;
        manifest + eviction raft-commit on each region.  Eviction is
        per-key compare-and-swap ([key, value-hash] pairs ride the
        manifest op): a row another frontend rewrote between this scan and
        the apply keeps its newer hot version — concurrent frontends
        cannot lose writes to a flush."""
        from ..obs import trace

        with trace.span("cold.flush", table=self.table_key):
            return self._with_routing_retry(
                lambda: self._flush_cold(fs, upto))

    def _flush_cold(self, fs, upto: Optional[int]) -> int:
        import json as _json

        from .coldfs import segment_bytes
        from .column_store import schema_to_arrow
        from .replicated import _fnv64_many

        arrow = schema_to_arrow(self.row_schema)
        rowid_col = self.key_columns[0]
        flushed = 0
        for region in list(self.regions):
            pairs = self._scan_region(region)
            rows, kept = [], []
            for k, v in pairs:
                r = self.row_codec.decode(v)
                if upto is not None and r[rowid_col] > upto:
                    continue
                rows.append(r)
                kept.append((k, v))
            keys = [[k.hex(), h] for (k, _), h in
                    zip(kept, _fnv64_many([v for _, v in kept]))]
            if not rows:
                continue
            watermark = max(r[rowid_col] for r in rows)
            seq = self.alloc_rowids(1)
            seg = f"{self.table_key}.r{region.region_id}.s{seq}.parquet"
            fs.put(seg, segment_bytes(rows, arrow))
            payload = _json.dumps({"op": "add", "seq": int(seq),
                                   "file": seg, "keys": keys,
                                   "watermark": int(watermark)}).encode()
            self._propose(region, encode_cmd(CMD_COLD, 0, payload))
            flushed += len(rows)
        return flushed

    def cold_rows(self, fs) -> list[dict]:
        from .coldfs import segment_rows

        def go():
            entries: list = []
            for r in self.regions:
                entries.extend(self._region_manifest(r))
            out: list[dict] = []
            seen: set[str] = set()
            for seq, f, _w in sorted(entries):
                if f in seen:
                    continue
                seen.add(f)
                out.extend(segment_rows(fs.get(f)))
            return out
        return self._with_routing_retry(go)

    def cold_gc(self, fs) -> int:
        return self._with_routing_retry(lambda: self._cold_gc(fs))

    def _cold_gc(self, fs) -> int:
        import json as _json

        from .coldfs import segment_bytes, segment_rows
        from .column_store import schema_to_arrow

        arrow = schema_to_arrow(self.row_schema)
        rowid_col = self.key_columns[0]
        candidates: set[str] = set()
        for region in list(self.regions):
            manifest = self._region_manifest(region)
            if not manifest:
                continue
            latest: dict[int, dict] = {}
            raw_rows = 0
            for seq, f, _w in sorted(manifest):
                for r in segment_rows(fs.get(f)):
                    raw_rows += 1
                    latest[int(r[rowid_col])] = r
            live = [r for _, r in sorted(latest.items())
                    if not r.get("__del")]
            if len(manifest) == 1 and len(live) == raw_rows:
                continue
            entries = []
            if live:
                seq = max(sq for sq, _f, _w in manifest)
                seg = (f"{self.table_key}.r{region.region_id}"
                       f".s{seq}.gc{len(manifest)}.parquet")
                fs.put(seg, segment_bytes(live, arrow))
                entries = [[int(seq), seg,
                            max(r[rowid_col] for r in live)]]
            # "expect" makes the reset a no-op when a concurrent flush
            # added a segment after this manifest read — the reset can
            # never orphan it
            payload = _json.dumps({"op": "reset", "entries": entries,
                                   "expect": [f for _s, f, _w in manifest]
                                   }).encode()
            self._propose(region, encode_cmd(CMD_COLD, 0, payload))
            candidates.update(f for _s, f, _w in manifest)
        still: set[str] = set()
        for region in self.regions:
            still.update(f for _s, f, _w in self._region_manifest(region))
        reclaimed = 0
        for f in candidates - still:
            fs.delete(f)
            reclaimed += 1
        return reclaimed

    def hot_bytes(self) -> int:
        def go():
            return sum(len(k) + len(v)
                       for region in self.regions
                       for k, v in self._scan_region(region))
        return self._with_routing_retry(go)

    def alloc_rowids(self, n: int, floor: int = 0) -> int:
        """Cluster-wide rowid range from the meta daemon: concurrent
        frontends never mint colliding keys.  The meta daemon is the
        allocation root: restarting IT resets counters (and the routing
        registry) — in this deployment shape a meta restart means a
        cluster restart; the in-process ReplicatedMeta carries the
        counters in its raft snapshots instead."""
        return int(self.cluster.meta.call("alloc_ids",
                                          table_id=self.table_id, n=n,
                                          floor=floor)["start"])

    def refresh_routing(self) -> None:
        """Re-pull this table's region ranges from meta (after another
        frontend split/merged them)."""
        wire = self.cluster.meta.call("table_regions",
                                      table_id=self.table_id)
        self.regions = sorted((self._from_wire(w) for w in wire),
                              key=lambda r: r.start_key)

    def write_ops(self, ops: list[tuple[int, bytes, bytes]]) -> None:
        if not ops:
            return
        for attempt in range(3):
            try:
                self._write_ops_routed(ops)
                break
            except StaleRoutingError:
                if attempt == 2:
                    raise ReplicationError(
                        f"{self.table_key}: routing kept going stale")
                self.refresh_routing()
        # size check every few batches (an RPC per region — not per write)
        self._writes_since_check += 1
        if self._writes_since_check >= 8:
            self._writes_since_check = 0
            try:
                self.maybe_split()
            except Exception:
                # split is maintenance (meta down, quorum loss, anything):
                # the write already ACKed — count so stalled splits show up
                metrics.count_swallowed("remote_tier.split_after_write")

    def _route_ops(self, ops: list[tuple[int, bytes, bytes]]) -> dict:
        """region_id -> op batch.  Rightmost start <= key over the sorted
        range list (the SchemaFactory range lookup); starts hoisted once
        per batch."""
        starts = [r.start_key for r in self.regions]
        per: dict[int, list] = {}
        for op in ops:
            rid = self.regions[max(bisect_right(starts, op[1]) - 1,
                                   0)].region_id
            per.setdefault(rid, []).append(op)
        return per

    def _write_ops_routed(self, ops: list[tuple[int, bytes, bytes]]) -> None:
        per = self._route_ops(ops)
        by_id = {r.region_id: r for r in self.regions}
        if len(per) == 1:
            rid, batch = next(iter(per.items()))
            self._propose(by_id[rid],
                          encode_cmd(CMD_WRITE, 0, encode_ops(batch)))
            return
        _twopc_remote([(self, by_id[rid], per[rid]) for rid in sorted(per)],
                      self.alloc_rowids(1), self.propose_deadline)

    def _scan_region(self, region: _RemoteRegion):
        """Leader scan, filtered by the INTERSECTION of the replica's
        committed range and this frontend's routed range: during
        split/merge a replica can briefly hold (or still claim) keys
        outside its final range, and either filter alone could double- or
        under-read (the staleness half of the contract lives in
        _leader_read_loop)."""
        resp = self._leader_read_loop(region, "scan_raw")
        rs, re_ = resp.get("start", b""), resp.get("end", b"")
        cs, ce = region.start_key, region.end_key
        s = max(cs, rs)                     # both lower bounds
        e = ce if not re_ else (re_ if not ce else min(ce, re_))
        return [(k, v) for k, v in resp["pairs"]
                if (not s or k >= s) and (not e or k < e)]

    def _leader_read_loop(self, region: _RemoteRegion, method: str,
                          handler_error=None, **kw) -> dict:
        """The shared leader-read protocol of the range-validated read
        RPCs (raw scans AND pushed fragments): rotate hinted-leader-first
        through every peer until one answers ok, adopt it as the hint, and
        verify the replica's COMMITTED range still covers what we route to
        it — narrower means a split this frontend has not seen
        (StaleRoutingError, the read-side version_old).

        ``handler_error``: exception type raised on a handler-side RPC
        failure (every retry would fail identically); None retries it like
        a transport failure."""
        deadline = time.monotonic() + self.propose_deadline
        candidates = [region.leader_addr] + \
            [a for _, a in region.peers if a != region.leader_addr]
        i = 0
        while time.monotonic() < deadline:
            if i and i % len(candidates) == 0:
                # one pause per full rotation: a dead peer is skipped
                # immediately, but instant-refusal failures (rolling
                # restart, ECONNREFUSED) must not busy-spin the loop
                time.sleep(0.1)
            addr = candidates[i % len(candidates)]
            i += 1
            try:
                resp = self.cluster.store(addr).call(
                    method, region_id=region.region_id, **kw)
            except RpcTimeout:
                # transport-level, not handler-level: rotate to the next
                # peer exactly like any other connection failure
                continue
            except RpcError as exc:
                if handler_error is not None:
                    raise handler_error(str(exc)) from None
                resp = None
            except OSError:
                continue
            if resp is not None and resp.get("status") == "ok":
                region.leader_addr = addr
                rs, re_ = resp.get("start", b""), resp.get("end", b"")
                cs, ce = region.start_key, region.end_key
                below = bool(rs) and (not cs or cs < rs)
                above = bool(re_) and (not ce or ce > re_)
                if below or above:
                    raise StaleRoutingError(region.region_id)
                return resp
        raise ReplicationError(
            f"region {region.region_id} of {self.table_key}: no leader "
            f"served {method}")

    # -- pushed-down fragments (the reference's store-side plan execution,
    # region.cpp:2671) ----------------------------
    def exec_fragment(self, frag: dict) -> list[dict]:
        """Run one fragment on every region leader; returns the per-region
        payloads for plan.fragment.merge_push_results.  Raises
        PushdownUnsupported when any region cannot serve it (cold tier,
        unsupported expr, cap overflow) — callers fall back to scan_rows."""
        def go():
            return [self._exec_region_fragment(r, frag)
                    for r in self.regions]
        return self._with_routing_retry(go)

    def _exec_region_fragment(self, region: _RemoteRegion,
                              frag: dict) -> dict:
        resp = self._leader_read_loop(
            region, "exec_fragment", handler_error=PushdownUnsupported,
            frag=frag, route_start=region.start_key,
            route_end=region.end_key)
        if resp.get("cold"):
            raise PushdownUnsupported(
                f"region {region.region_id} has cold segments")
        return resp

    def frag_publish(self, frag_key: str, frag: dict) -> None:
        """Push one fragment body (canonical encoding, content-addressed)
        to EVERY store hosting a region of this table — the AOT-publish
        step of the pushed dispatch.  Idempotent and best-effort: a store
        the publish missed answers ``need_frag`` and gets the body inline
        (counted as a warm-compile miss)."""
        from ..plan.fragment import frag_canonical

        data = frag_canonical(frag)
        for addr in sorted({a for r in self.regions for _, a in r.peers}):
            self.cluster.store(addr).try_call("frag_put", key=frag_key,
                                              data=data)
        self._frag_published.add(frag_key)

    def fragment_execute_region(self, region: _RemoteRegion, frag_key: str,
                                frag: dict) -> dict:
        """One region's pushed fragment: leader-routed ``fragment_execute``
        carrying ONLY the content hash; the daemon warm-starts the program
        from its artifact tier (memory -> disk blob -> peer).  When every
        warm source misses (``need_frag``: daemon restarted after the
        publish, or joined late), the body ships inline once — the only
        path that compiles, so ``fragment_warm_compiles`` stays 0 for any
        re-dispatch of a published fragment.  Range staleness raises
        StaleRoutingError exactly like raw scans; the dispatcher
        (exec/fragments.py) refreshes routing and re-targets."""
        kw = dict(frag_key=frag_key,
                  peers=[[sid, a] for sid, a in region.peers],
                  route_start=region.start_key, route_end=region.end_key)
        resp = self._leader_read_loop(
            region, "fragment_execute",
            handler_error=PushdownUnsupported, **kw)
        if resp.get("need_frag"):
            metrics.fragment_warm_compiles.add(1)
            resp = self._leader_read_loop(
                region, "fragment_execute",
                handler_error=PushdownUnsupported, frag=frag, **kw)
        if resp.get("need_frag") or "mode" not in resp:
            # cold manifest present but the daemon has no cold-FS handle
            # (no --cold-dir), or the body retry still missed: this region
            # cannot be served in place
            raise PushdownUnsupported(
                f"region {region.region_id}: store cannot execute the "
                f"fragment in place")
        return resp

    def scan_rows(self) -> list[dict]:
        for attempt in range(3):
            try:
                out: list[dict] = []
                for r in self.regions:
                    for _, v in self._scan_region(r):
                        out.append(self.row_codec.decode(v))
                return out
            except StaleRoutingError:
                if attempt == 2:
                    raise ReplicationError(
                        f"{self.table_key}: routing kept going stale")
                self.refresh_routing()
        return []

    # -- split / merge -----------------------------------------------------
    def _threshold(self) -> int:
        return self.split_rows or int(FLAGS.region_split_rows)

    def _region_size(self, region: _RemoteRegion) -> Optional[int]:
        resp = self._leader_call(region, "region_size", deadline_s=2.0)
        return int(resp["live"]) if resp is not None else None

    def maybe_split(self) -> int:
        """Split oversized regions (the store-side size trigger run from
        the frontend — one RPC per region per check)."""
        threshold = self._threshold()
        done = 0
        if threshold <= 0:
            return done
        i = 0
        while i < len(self.regions):
            size = self._region_size(self.regions[i])
            if size is not None and size >= threshold:
                try:
                    self.split_region(i)
                    done += 1
                    continue       # left half may still be oversized
                except SplitError:
                    pass
            i += 1
        return done

    def split_region(self, idx: int) -> None:
        """The in-process tier's lifecycle over the RPC plane: meta
        registers the child on the parent's peers, every peer store
        materializes it, the upper half replicates in (copy+catch-up as
        one committed write — the tier serializes writes), both sides
        raft-commit their range, the parent trims."""
        parent = self.regions[idx]
        pairs = self._scan_region(parent)
        if len(pairs) < 2:
            raise SplitError(f"region {parent.region_id} too small to split")
        mid = pairs[len(pairs) // 2][0]
        if mid == pairs[0][0]:
            raise SplitError(f"region {parent.region_id} has no usable "
                             f"split key")
        w = self.cluster.meta.call("split_region_key",
                                   region_id=parent.region_id,
                                   split_key_hex=bytes(mid).hex())
        child = self._from_wire(w)
        try:
            self._materialize([child])
            moved = [(0, k, v) for k, v in pairs if k >= mid]
            if moved:
                self._propose(child,
                              encode_cmd(CMD_WRITE, 0, encode_ops(moved)))
            self._propose(child, encode_cmd(
                CMD_SET_RANGE, 0,
                encode_range(child.version, mid, parent.end_key)))
        except Exception:
            # abort: restore the parent's meta range and retire the child —
            # a registered-but-empty child would mis-route fresh frontends.
            # Dropping the child's replicas is decisive even if its
            # SET_RANGE committed after our timeout (no replica, no serve);
            # the in-process tier keeps the same invariant
            try:
                self.cluster.meta.call("merge_regions_key",
                                       left_id=parent.region_id,
                                       right_id=child.region_id)
            except Exception:
                metrics.count_swallowed("remote_tier.merge_regions")
            for _, addr in child.peers:
                self.cluster.store(addr).try_call(
                    "drop_region", region_id=child.region_id)
            raise SplitError(
                f"split of region {parent.region_id} aborted") from None
        # past this point the split is NOT abortable: the child owns
        # [mid, end) in meta and in its committed range.  A parent
        # SET_RANGE timeout may still commit later — reverting meta then
        # would permanently hide [mid, end) behind a narrowed parent —
        # so failures here surface but the split stands (readers filter
        # by the intersection of routed and committed ranges, so the
        # not-yet-narrowed parent cannot double-serve)
        try:
            self._propose(parent, encode_cmd(
                CMD_SET_RANGE, 0,
                encode_range(child.version, parent.start_key, mid)))
            self._propose(parent, encode_cmd(CMD_TRIM, 0))
        finally:
            # local routing honors the split even if the parent narrow
            # failed to ack — the child is authoritative for [mid, end)
            parent.end_key = mid
            parent.version = child.version
            self.regions.insert(idx + 1, child)

    def merge_region(self, idx: int) -> None:
        """Merge region idx+1 into its left neighbor.  Ordering keeps every
        failure window readable and retryable: (1) the left raft-commits
        the widened range, (2) the right's rows replicate into it, (3) the
        right commits an EMPTY range — from here it serves nothing and no
        reader can double-count — then (4) meta retires it from routing and
        (5) its replicas drop.  A failure between (1) and (2) leaves the
        right authoritative (left holds nothing in the overlap); retrying
        re-runs the idempotent steps.  Failures are RAISED, never
        swallowed — merge is an explicit maintenance operation."""
        if idx + 1 >= len(self.regions):
            raise SplitError("no right neighbor to merge")
        left, right = self.regions[idx], self.regions[idx + 1]
        pairs = self._scan_region(right)
        version = max(left.version, right.version) + 1
        self._propose(left, encode_cmd(
            CMD_SET_RANGE, 0,
            encode_range(version, left.start_key, right.end_key)))
        if pairs:
            self._propose(left, encode_cmd(
                CMD_WRITE, 0, encode_ops([(0, k, v) for k, v in pairs])))
        right_cold = self._region_manifest(right)
        if right_cold:
            # the right's cold segments must survive the merge: fold its
            # manifest into the left's (raft-committed) before the right's
            # replicas drop, or the evicted rows would vanish from every
            # read and rebuild (mirrors the fleet plane's merge)
            import json as _json

            left_cold = self._region_manifest(left)
            combined = sorted(set(map(tuple, left_cold)) |
                              set(map(tuple, right_cold)))
            self._propose(left, encode_cmd(CMD_COLD, 0, _json.dumps(
                {"op": "reset",
                 "entries": [list(e) for e in combined],
                 "expect": [f for _s, f, _w in left_cold]}).encode()))
        # (X, X) with non-empty X covers nothing: the right now owns — and
        # serves — the empty range
        self._propose(right, encode_cmd(
            CMD_SET_RANGE, 0, encode_range(version, b"\x00", b"\x00")))
        self.cluster.meta.call("merge_regions_key",
                               left_id=left.region_id,
                               right_id=right.region_id)
        for _, addr in right.peers:
            self.cluster.store(addr).try_call("drop_region",
                                              region_id=right.region_id)
        left.end_key = right.end_key
        left.version = version
        del self.regions[idx + 1]

    def maybe_merge(self) -> int:
        floor = max(2, self._threshold() // 4)
        done = 0
        i = 0
        while i + 1 < len(self.regions):
            a = self._region_size(self.regions[i])
            b = self._region_size(self.regions[i + 1])
            if a is not None and b is not None and a + b < floor:
                self.merge_region(i)      # failures surface to the caller
                done += 1
                continue
            i += 1
        return done

    def num_rows(self) -> int:
        return sum(1 for r in self.scan_rows() if not r.get("__del"))

    def available(self) -> bool:
        try:
            for r in self.regions:
                self._scan_region(r)
        except ReplicationError:
            return False
        return True

    # -- maintenance -------------------------------------------------------
    def truncate(self) -> None:
        """TRUNCATE by region retirement (see ReplicatedRowTier.truncate)."""
        self.reset_schema(self.row_schema, [])

    def release_regions(self) -> None:
        rids = [r.region_id for r in self.regions]
        for r in self.regions:
            for _, addr in r.peers:
                self.cluster.store(addr).try_call("drop_region",
                                                  region_id=r.region_id)
        self.cluster.meta.try_call("drop_regions", region_ids=rids)

    def reset_schema(self, row_schema: Schema,
                     ops: list[tuple[int, bytes, bytes]]) -> None:
        self.release_regions()
        self.row_schema = row_schema
        self.row_codec = RowCodec(row_schema)
        created = self.cluster.meta.call("create_regions",
                                         table_id=self.table_id, n_regions=1)
        self.regions = [self._from_wire(w) for w in created]
        self._materialize()
        if ops:
            self.write_ops(ops)
