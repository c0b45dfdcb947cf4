"""Raft runtime: transport, replicated regions, group management.

The reference hosts one braft::StateMachine per Region inside baikalStore
processes connected by brpc (include/store/region.h:445).  Here the same
roles split differently: the native core (native/raft.cpp) decides, this
module moves bytes and applies commits.  ``LocalBus`` is an in-process
transport with deterministic delivery plus partition/kill controls — the
multi-node-without-a-cluster test pattern the reference uses by faking
topology into SchemaFactory (SURVEY §4), but covering election/failover
paths braft-based tests cannot drive deterministically.

A ``ReplicatedRegion`` applies committed write batches to its own MVCC row
table (native/engine.cpp), so each peer holds a real storage replica; a
snapshot is the serialized row table (install replaces the replica's state —
the reference's SST-streaming install_snapshot analog).

The port's copy of ``baikaldb_tpu/raft/cluster.py``, unchanged but for its
imports: the regions' row tables are the port's storage/rowstore.py."""

from __future__ import annotations

import struct
from typing import Callable, Optional

from ..chaos import failpoint
from ..storage.rowstore import RowTable
from ..types import Field, LType, Schema
from .core import CONFIG, DATA, LEADER, SNAPSHOT_KIND, Committed, RaftCore


# -- write-batch / snapshot codecs ------------------------------------------

# replicated command kinds (the store-side op_type dispatch, region.cpp:1680)
CMD_WRITE = 0        # apply ops immediately
CMD_PREPARE = 1      # buffer ops under txn_id (2PC phase 1)
CMD_COMMIT = 2       # apply buffered txn_id (2PC phase 2)
CMD_ROLLBACK = 3     # drop buffered txn_id
CMD_DECIDE = 4       # primary-region commit decision record
CMD_SET_RANGE = 5    # split/merge finalize: shrink/grow key range + version
CMD_TRIM = 6         # drop keys outside the region's range (post-split GC)
CMD_COLD = 7         # cold-tier manifest op + hot eviction (region_olap
#                      flush_to_cold analog: segment bytes live on the
#                      external FS, the manifest and the eviction watermark
#                      replicate here)


def encode_range(version: int, start: bytes, end: bytes) -> bytes:
    return struct.pack("<II", version, len(start)) + start + \
        struct.pack("<I", len(end)) + end


def decode_range(data: bytes) -> tuple[int, bytes, bytes]:
    version, slen = struct.unpack_from("<II", data, 0)
    pos = 8
    start = data[pos:pos + slen]
    pos += slen
    (elen,) = struct.unpack_from("<I", data, pos)
    pos += 4
    return version, start, data[pos:pos + elen]


def encode_cmd(cmd: int, txn_id: int, ops_bytes: bytes = b"") -> bytes:
    return struct.pack("<BQ", cmd, txn_id) + ops_bytes


def decode_cmd(data: bytes) -> tuple[int, int, bytes]:
    cmd, txn_id = struct.unpack_from("<BQ", data, 0)
    return cmd, txn_id, data[9:]


def encode_ops(ops: list[tuple[int, bytes, bytes]]) -> bytes:
    parts = [struct.pack("<I", len(ops))]
    for op, k, v in ops:
        parts.append(struct.pack("<BI", op, len(k)))
        parts.append(k)
        parts.append(struct.pack("<I", len(v)))
        parts.append(v)
    return b"".join(parts)


def decode_ops(data: bytes) -> list[tuple[int, bytes, bytes]]:
    (n,) = struct.unpack_from("<I", data, 0)
    pos = 4
    out = []
    for _ in range(n):
        op, klen = struct.unpack_from("<BI", data, pos)
        pos += 5
        k = data[pos:pos + klen]
        pos += klen
        (vlen,) = struct.unpack_from("<I", data, pos)
        pos += 4
        v = data[pos:pos + vlen]
        pos += vlen
        out.append((op, k, v))
    return out


def _ops_size(data: bytes) -> int:
    """Byte length of the leading encode_ops section."""
    (n,) = struct.unpack_from("<I", data, 0)
    pos = 4
    for _ in range(n):
        _, klen = struct.unpack_from("<BI", data, pos)
        pos += 5 + klen
        (vlen,) = struct.unpack_from("<I", data, pos)
        pos += 4 + vlen
    return pos


class ReplicatedRegion:
    """One peer's replica of one region: Raft core + MVCC row table."""

    def __init__(self, node_id: int, peers: list[int], seed: int = 1,
                 schema: Optional[Schema] = None,
                 key_columns: Optional[list[str]] = None):
        self.core = RaftCore(node_id, peers, seed=seed)
        self.node_id = node_id
        self.schema = schema or Schema((Field("k", LType.INT64, False),
                                        Field("v", LType.STRING, True)))
        self.key_columns = key_columns or [self.schema.fields[0].name]
        self.table = RowTable(self.schema, self.key_columns)
        self.applied_index = 0
        # 2PC replicated state: prepared-but-undecided txns and the primary
        # region's decision log (reference: prepared-txn recovery from
        # METAINFO_CF, transaction_pool.cpp)
        self.prepared: dict[int, bytes] = {}
        self.decisions: dict[int, int] = {}   # txn -> CMD_COMMIT|CMD_ROLLBACK
        # replica-local wall time a prepare was applied: in-doubt RECOVERY
        # only rolls back prepares older than a grace window, so it cannot
        # abort a live coordinator mid-2PC (the reference's txn timeout)
        self.prepared_at: dict[int, float] = {}
        # cold-tier manifest: ordered (seq, file, watermark) entries.  The
        # segment FILES live on the external FS; this list is the raft-
        # replicated truth about which segments exist and which rowid range
        # was evicted from the hot table (region_olap.cpp:727-882)
        self.cold_manifest: list[tuple[int, str, int]] = []
        # key-range ownership: [start_key, end_key) with b"" = unbounded;
        # range_version bumps at every split/merge finalize (the reference's
        # region version used to reject stale-routed requests,
        # region.cpp:4864 add_version)
        self.start_key: bytes = b""
        self.end_key: bytes = b""
        self.range_version: int = 1

    def apply_committed(self) -> list[Committed]:
        """Drain the core's committed entries into the row table (the
        braft on_apply analog, with the store's op_type dispatch)."""
        if failpoint.ENABLED:
            if failpoint.hit("raft.commit", node=self.node_id):
                return []       # drop: defer applying this round — commits
                #                 stay in the core and apply when cleared
        commits = self.core.drain_commits()
        for c in commits:
            if c.kind == DATA:
                cmd, txn_id, body = decode_cmd(c.data)
                if cmd == CMD_WRITE:
                    self.table.write_batch(self._in_range(decode_ops(body)))
                elif cmd == CMD_PREPARE:
                    self.prepared[txn_id] = body
                    import time as _time
                    self.prepared_at[txn_id] = _time.time()
                elif cmd == CMD_COMMIT:
                    ops = self.prepared.pop(txn_id, None)
                    self.prepared_at.pop(txn_id, None)
                    if ops is not None:
                        self.table.write_batch(self._in_range(decode_ops(ops)))
                elif cmd == CMD_ROLLBACK:
                    self.prepared.pop(txn_id, None)
                    self.prepared_at.pop(txn_id, None)
                elif cmd == CMD_DECIDE:
                    # first writer wins: a coordinator whose COMMIT decision
                    # propose timed out (but actually committed) may later
                    # replicate an ABORT decision — the abort must not
                    # overwrite a commit some region already resolved from
                    # (the torn-transaction window, ADVICE r03 medium)
                    self.decisions.setdefault(txn_id, body[0])
                elif cmd == CMD_SET_RANGE:
                    v, s, e = decode_range(body)
                    self.start_key, self.end_key = s, e
                    self.range_version = max(self.range_version, v)
                elif cmd == CMD_TRIM:
                    # drop rows that moved to another region at split
                    # finalize — deterministic on every replica (the
                    # split-aware compaction-filter analog)
                    dead = [(1, k, b"") for k, _ in self.table.scan_raw()
                            if not self._covers(k)]
                    if dead:
                        self.table.write_batch(dead)
                elif cmd == CMD_COLD:
                    self._apply_cold(body)
                self.applied_index = c.index
            elif c.kind == SNAPSHOT_KIND:
                self._install_snapshot(c.data)
                self.applied_index = c.index
            else:
                self.applied_index = c.index
        return commits

    def _apply_cold(self, body: bytes) -> None:
        """Cold-tier manifest op, deterministic on every replica.
        add:   record (seq, file, watermark) and EVICT the flushed hot rows
               (the bytes already sit immutably on the external FS —
               written by the flush coordinator BEFORE this committed).
               Eviction is not deletion: the rows live on in the segment
               and recovery replays cold-then-hot.  With a "keys" list
               ([hex key, value hash] pairs), eviction is per-key
               compare-and-swap — a row another frontend rewrote between
               the coordinator's scan and this apply keeps its NEWER hot
               version (the segment's stale copy is shadowed at replay).
               Without it (a coordinator that serializes flushes itself),
               everything at rowid <= watermark evicts.
        reset: replace this region's manifest (cold GC/merge); with
               "expect" (the file list the reset was computed from), a
               mismatch — a concurrent flush added a segment — makes the
               reset a deterministic no-op instead of orphaning it."""
        import json as _json

        m = _json.loads(body.decode())
        if m["op"] == "add":
            self.cold_manifest.append((int(m["seq"]), m["file"],
                                       int(m["watermark"])))
            if "keys" in m:
                from ..storage.replicated import _fnv64

                snap = dict(self.table.scan_raw())
                dead = []
                for khex, vh in m["keys"]:
                    k = bytes.fromhex(khex)
                    v = snap.get(k)
                    if v is not None and _fnv64(v) == int(vh):
                        dead.append((1, k, b""))
                if dead:
                    self.table.write_batch(dead)
                return
            wkey = self.table.key_codec.encode_one(
                {self.key_columns[0]: int(m["watermark"])})
            dead = [(1, k, b"") for k, _ in self.table.scan_raw()
                    if k <= wkey]
            if dead:
                self.table.write_batch(dead)
        elif m["op"] == "reset":
            if "expect" in m:
                current = sorted(f for _s, f, _w in self.cold_manifest)
                if current != sorted(m["expect"]):
                    return      # stale gc: a flush raced it — no-op
            self.cold_manifest = [(int(s), f, int(w))
                                  for s, f, w in m["entries"]]

    def _covers(self, key: bytes) -> bool:
        if self.start_key and key < self.start_key:
            return False
        if self.end_key and key >= self.end_key:
            return False
        return True

    def _in_range(self, ops: list[tuple[int, bytes, bytes]]):
        """After a split finalize, writes routed with a stale range must not
        land here (the reference rejects them with version_old; the router
        re-resolves and re-sends to the owning region)."""
        if not self.start_key and not self.end_key:
            return ops
        return [op for op in ops if self._covers(op[1])]

    # -- snapshots --------------------------------------------------------
    def snapshot_bytes(self) -> bytes:
        """Full replica state: rows + prepared txns + decisions + key range
        (install must not lose 2PC or ownership state)."""
        pairs = self.table.scan_raw()
        out = [encode_ops([(0, k, v) for k, v in pairs])]
        out.append(struct.pack("<I", len(self.prepared)))
        for txn, ops in sorted(self.prepared.items()):
            out.append(struct.pack("<QI", txn, len(ops)) + ops)
        out.append(struct.pack("<I", len(self.decisions)))
        for txn, d in sorted(self.decisions.items()):
            out.append(struct.pack("<QB", txn, d))
        rng = encode_range(self.range_version, self.start_key, self.end_key)
        out.append(struct.pack("<I", len(rng)) + rng)
        import json as _json

        cold = _json.dumps(self.cold_manifest).encode()
        out.append(struct.pack("<I", len(cold)) + cold)
        return b"".join(out)

    def _install_snapshot(self, data: bytes):
        self.table = RowTable(self.schema, self.key_columns)
        ops = decode_ops(data)
        self.table.write_batch(ops)
        pos = _ops_size(data)
        self.prepared = {}
        self.prepared_at = {}
        self.decisions = {}
        self.start_key = b""
        self.end_key = b""
        self.range_version = 1
        if pos >= len(data):
            return                      # pre-2PC snapshot format
        (np_,) = struct.unpack_from("<I", data, pos)
        pos += 4
        import time as _time

        now = _time.time()
        for _ in range(np_):
            txn, ln = struct.unpack_from("<QI", data, pos)
            pos += 12
            self.prepared[txn] = data[pos:pos + ln]
            pos += ln
            # prepare wall-times are replica-local and not in the snapshot;
            # stamp install time so the in-doubt grace window RESTARTS
            # instead of never starting (prepared_age would otherwise read
            # ~0 forever and recovery would defer the txn indefinitely —
            # ADVICE r03 low #1)
            self.prepared_at[txn] = now
        (nd,) = struct.unpack_from("<I", data, pos)
        pos += 4
        for _ in range(nd):
            txn, d = struct.unpack_from("<QB", data, pos)
            pos += 9
            self.decisions[txn] = d
        self.cold_manifest = []
        if pos < len(data):
            (rlen,) = struct.unpack_from("<I", data, pos)
            pos += 4
            v, s, e = decode_range(data[pos:pos + rlen])
            self.start_key, self.end_key, self.range_version = s, e, v
            pos += rlen
        if pos < len(data):
            import json as _json

            (clen,) = struct.unpack_from("<I", data, pos)
            pos += 4
            self.cold_manifest = [
                (int(sq), f, int(w))
                for sq, f, w in _json.loads(data[pos:pos + clen].decode())]

    def compact(self):
        """Snapshot own state into the core, truncating the log (the
        space-efficient snapshot scheme: state, not log history)."""
        self.core.compact(self.core.commit_index, self.snapshot_bytes())

    # -- reads ------------------------------------------------------------
    def rows(self) -> list[dict]:
        return self.table.scan_rows()

    def rows_in_range(self) -> list[dict]:
        """Rows this region OWNS.  During split/merge a replica can briefly
        hold keys outside its committed range (copied but not yet trimmed,
        or trimmed on another replica first); readers must never see them
        twice, so ownership — not possession — decides visibility."""
        return [self.table.row_codec.decode(v)
                for k, v in self.table.scan_raw() if self._covers(k)]


class LocalBus:
    """Deterministic in-process transport with fault injection."""

    def __init__(self):
        self.nodes: dict[int, ReplicatedRegion] = {}
        self.down: set[int] = set()
        self.blocked: set[tuple[int, int]] = set()   # (src, dst) pairs

    def add(self, region: ReplicatedRegion):
        self.nodes[region.node_id] = region

    def kill(self, node_id: int):
        self.down.add(node_id)

    def revive(self, node_id: int):
        self.down.discard(node_id)

    def partition(self, group_a: list[int], group_b: list[int]):
        for a in group_a:
            for b in group_b:
                self.blocked.add((a, b))
                self.blocked.add((b, a))

    def heal(self):
        self.blocked.clear()

    # -- drive ------------------------------------------------------------
    def pump(self, max_rounds: int = 200):
        """Deliver messages until quiescent; apply commits as they appear."""
        for _ in range(max_rounds):
            moved = False
            for nid, node in list(self.nodes.items()):
                if nid in self.down:
                    node.core.drain_messages()   # drop a dead node's output
                    continue
                for dest, msg in node.core.drain_messages():
                    moved = True
                    if dest in self.down or dest not in self.nodes:
                        continue
                    if (nid, dest) in self.blocked:
                        continue
                    self.nodes[dest].core.receive(msg)
            for nid, node in self.nodes.items():
                if nid not in self.down:
                    node.apply_committed()
            if not moved:
                return
        raise RuntimeError("bus did not quiesce")

    def advance(self, ticks: int = 1):
        """ticks x (tick every live node, then deliver to quiescence)."""
        for _ in range(ticks):
            for nid, node in self.nodes.items():
                if nid not in self.down:
                    node.core.tick()
            self.pump()

    def elect(self, max_ticks: int = 400) -> int:
        """Advance until some live node is leader; returns its id."""
        for _ in range(max_ticks):
            ldr = self.leader()
            if ldr is not None:
                return ldr
            self.advance(1)
        raise RuntimeError("no leader elected")

    def leader(self) -> Optional[int]:
        """The leader a quorum actually follows.  A leader partitioned from
        the majority still THINKS it leads (it cannot learn otherwise until
        healed); counting it would route writes into a black hole, so a
        candidate only qualifies when a quorum of its config is live and at
        its term following it."""
        if failpoint.ENABLED and failpoint.hit("raft.leader_step"):
            return None         # drop: report leaderless — election churn
        best = None
        for nid, node in self.nodes.items():
            if nid in self.down or node.core.role != LEADER:
                continue
            peers = node.core.peers()
            follows = 0
            for p in peers:
                if p == nid:
                    follows += 1
                    continue
                other = self.nodes.get(p)
                if other is None or p in self.down or \
                        (nid, p) in self.blocked or (p, nid) in self.blocked:
                    continue    # unreachable: cannot sustain this leader
                if other.core.term == node.core.term and \
                        other.core.leader == nid:
                    follows += 1
            if follows >= len(peers) // 2 + 1:
                if best is None or node.core.term > \
                        self.nodes[best].core.term:
                    best = nid
        return best


class RaftGroup:
    """One replicated region group — the store-fleet view the meta service
    balances (region -> peers, leader)."""

    def __init__(self, region_id: int, peer_ids: list[int], seed: int = 1,
                 schema: Optional[Schema] = None,
                 key_columns: Optional[list[str]] = None,
                 bus: Optional[LocalBus] = None):
        self.region_id = region_id
        self.schema = schema
        self.key_columns = key_columns
        self.seed = seed
        self.bus = bus or LocalBus()
        for pid in peer_ids:
            self.bus.add(ReplicatedRegion(pid, peer_ids, seed=seed,
                                          schema=schema,
                                          key_columns=key_columns))

    # -- client API -------------------------------------------------------
    def leader(self) -> int:
        ldr = self.bus.leader()
        if ldr is None:
            ldr = self.bus.elect()
        return ldr

    def write(self, ops: list[tuple[int, bytes, bytes]],
              max_ticks: int = 400) -> bool:
        """Propose a write batch; returns True once COMMITTED on the leader
        (the ack the reference gives after braft on_apply).  Retries through
        elections like FetcherStore's leader-redirect loop."""
        return self.propose_cmd(CMD_WRITE, 0, encode_ops(ops), max_ticks)

    def propose_cmd(self, cmd: int, txn_id: int, ops_bytes: bytes = b"",
                    max_ticks: int = 400) -> bool:
        """Propose a replicated command and wait for leader commit.  False
        when no quorum exists (the region is unavailable)."""
        from ..obs import trace

        with trace.span("raft.append", region=self.region_id, cmd=int(cmd)):
            if failpoint.ENABLED:
                if failpoint.hit("raft.append", region=self.region_id,
                                 cmd=int(cmd)):
                    return False    # drop: the append never happens —
                    #                 callers see it as quorum loss
            return self._propose_cmd(cmd, txn_id, ops_bytes, max_ticks)

    def _propose_cmd(self, cmd: int, txn_id: int, ops_bytes: bytes,
                     max_ticks: int) -> bool:
        payload = encode_cmd(cmd, txn_id, ops_bytes)
        for _ in range(max_ticks):
            try:
                ldr = self.leader()
            except RuntimeError:
                return False               # no electable quorum
            idx = self.bus.nodes[ldr].core.propose(payload)
            if idx < 0:
                self.bus.advance(1)
                continue
            for _ in range(max_ticks):
                self.bus.pump()
                if self.bus.nodes[ldr].core.commit_index >= idx:
                    return True
                if self.bus.nodes[ldr].core.role != LEADER:
                    break
                self.bus.advance(1)
            else:
                return False
        return False

    def set_range(self, version: int, start: bytes, end: bytes,
                  max_ticks: int = 400) -> bool:
        """Replicated range finalize (the add_version analog,
        region.cpp:4864): after commit, replicas reject out-of-range
        writes and TRIM drops moved rows."""
        return self.propose_cmd(CMD_SET_RANGE, 0,
                                encode_range(version, start, end), max_ticks)

    def trim(self, max_ticks: int = 400) -> bool:
        return self.propose_cmd(CMD_TRIM, 0, b"", max_ticks)

    def put_row(self, region: ReplicatedRegion, row: dict) -> bool:
        key = region.table.key_codec.encode_one(row)
        val = region.table.row_codec.encode(row)
        return self.write([(0, key, val)])

    # -- membership (meta balance orders execute through these) -----------
    def add_peer(self, new_id: int, max_ticks: int = 400) -> bool:
        """Single-server membership add (reference: raft_control add_peer).
        The config change is proposed FIRST; the replica only joins the bus
        once accepted (a rejected propose must not leave a ghost node whose
        election timeouts would depose real leaders forever)."""
        ldr = self.leader()
        if ldr is None:
            ldr = self.bus.elect()
        peers = self.bus.nodes[ldr].core.peers()
        payload = struct.pack("<Bq", 0, new_id)
        idx = self.bus.nodes[ldr].core.propose(payload, kind=CONFIG)
        if idx < 0:
            return False
        replica = ReplicatedRegion(new_id, peers + [new_id], seed=self.seed,
                                   schema=self.schema,
                                   key_columns=self.key_columns)
        self.bus.add(replica)
        for _ in range(max_ticks):
            self.bus.pump()
            if replica.core.commit_index >= idx:
                return True
            self.bus.advance(1)
        self.bus.nodes.pop(new_id, None)    # never caught up: no ghost
        return False

    def add_learner(self, new_id: int, max_ticks: int = 400) -> bool:
        """Add a NON-VOTING learner replica (reference: learner replicas,
        region.h:261-267): it receives full log replication and applies
        commits — a read-serving replica — but never counts toward quorum
        and never elects."""
        ldr = self.leader()
        if ldr is None:
            ldr = self.bus.elect()
        peers = self.bus.nodes[ldr].core.peers()
        payload = struct.pack("<Bq", 2, new_id)
        idx = self.bus.nodes[ldr].core.propose(payload, kind=CONFIG)
        if idx < 0:
            return False
        replica = ReplicatedRegion(new_id, peers, seed=self.seed,
                                   schema=self.schema,
                                   key_columns=self.key_columns)
        self.bus.add(replica)
        for _ in range(max_ticks):
            self.bus.pump()
            if replica.core.commit_index >= idx:
                return True
            self.bus.advance(1)
        self.bus.nodes.pop(new_id, None)
        return False

    def promote_learner(self, learner_id: int, max_ticks: int = 400) -> bool:
        """Promote an EXISTING caught-up learner replica to voter (the
        learner-first migration finalize).  The native core treats an
        add-voter config entry for a known learner as a promotion (it
        leaves the learner set and joins the voter set on every replica);
        unlike ``add_peer`` no new replica is created — the learner already
        holds the replicated state."""
        if learner_id not in self.bus.nodes:
            return False
        ldr = self.leader()
        if learner_id not in self.bus.nodes[ldr].core.learners():
            return False
        payload = struct.pack("<Bq", 0, learner_id)
        idx = self.bus.nodes[ldr].core.propose(payload, kind=CONFIG)
        if idx < 0:
            return False
        for _ in range(max_ticks):
            self.bus.pump()
            if self.bus.nodes[ldr].core.commit_index >= idx:
                return True
            self.bus.advance(1)
        return False

    def remove_learner(self, learner_id: int, max_ticks: int = 400) -> bool:
        ldr = self.leader()
        payload = struct.pack("<Bq", 3, learner_id)
        idx = self.bus.nodes[ldr].core.propose(payload, kind=CONFIG)
        if idx < 0:
            return False
        for _ in range(max_ticks):
            self.bus.pump()
            if self.bus.nodes[ldr].core.commit_index >= idx:
                self.bus.nodes.pop(learner_id, None)
                return True
            self.bus.advance(1)
        return False

    def remove_peer(self, dead_id: int, max_ticks: int = 400) -> bool:
        ldr = self.leader()
        if ldr == dead_id:
            raise ValueError("transfer leadership before removing the leader")
        payload = struct.pack("<Bq", 1, dead_id)
        idx = self.bus.nodes[ldr].core.propose(payload, kind=CONFIG)
        if idx < 0:
            return False
        for _ in range(max_ticks):
            self.bus.pump()
            if self.bus.nodes[ldr].core.commit_index >= idx:
                self.bus.nodes.pop(dead_id, None)
                return True
            self.bus.advance(1)
        return False

    def peers(self) -> list[int]:
        return sorted(self.bus.nodes[self.leader()].core.peers())
