"""Meta service: cluster topology, region registry, heartbeats, balancing, TSO.

The reference's meta server (src/meta_server) is a Raft-replicated set of
manager singletons: ClusterManager (instances/rooms/placement,
cluster_manager.cpp), RegionManager (peer/leader balance, dead-store
migration, region_manager.cpp), TableManager (schema + region ranges), and a
TSO state machine (tso_state_machine.cpp — hybrid physical/logical
timestamps).  Round-1 build: the same control loops as an in-process service
with explicit request/response dataclasses (the proto contract), so the
frontends/stores interact with it exactly the way they would over RPC; the
Raft replication of the meta state itself lands with the multi-host tier.

Balancing mirrors the reference's decisions (not its code): instances are
marked FAULTY after missing `faulty_after` seconds of heartbeats and DEAD
after `dead_after`; dead peers migrate to the least-loaded healthy instance
in the same resource tag (room-diverse when possible); peer/leader counts
rebalance toward the mean.

The port's copy of ``baikaldb_tpu/meta/service.py``, unchanged but for its
imports; its ``Tso`` is meta/tso.py's, the one clock of every Database on a
fleet.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..chaos import failpoint
from ..utils.flags import FLAGS, define
from .tso import Tso

NORMAL, FAULTY, DEAD, MIGRATE = "NORMAL", "FAULTY", "DEAD", "MIGRATE"

# region lifecycle (reference: RegionStatus IDLE/DOING — region.h:254):
# SERVING regions route + balance; SPLITTING/MIGRATING regions are mid-
# membership-change and are skipped by further balance decisions until the
# fleet commits or aborts the change
SERVING, SPLITTING, MIGRATING = "SERVING", "SPLITTING", "MIGRATING"

# same name+default as storage/replicated.py (define() dedupes): meta's
# load-driven trigger and the store-side size trigger share one threshold
define("region_split_rows", 200_000,
       "auto-split a replicated region when it exceeds this many keys "
       "(reference: region_split_lines)")
define("region_split_skew", 4.0,
       "load-driven split trigger: a region whose per-heartbeat write rate "
       "exceeds this multiple of its table's mean region write rate is a "
       "hotspot and splits even below region_split_rows (0 disables the "
       "skew trigger)")
define("region_split_min_rows", 512,
       "floor for the write-skew split trigger: a hot region below this "
       "many rows never load-splits (splitting a tiny region cannot shed "
       "load)")


@dataclass
class InstanceInfo:
    """A store node (reference: pb::InstanceInfo, meta.interface.proto)."""
    address: str
    resource_tag: str = ""
    logical_room: str = ""
    capacity: int = 100_000
    status: str = NORMAL
    last_heartbeat: float = 0.0
    used: int = 0


@dataclass
class RegionMeta:
    """One region's metadata (reference: pb::RegionInfo,
    meta.interface.proto:353)."""
    region_id: int
    table_id: int
    start_row: int = 0            # row-range partitioning of the row axis
    end_row: int = -1             # -1 = unbounded
    peers: list[str] = field(default_factory=list)
    leader: str = ""
    version: int = 1
    num_rows: int = 0
    # memcomparable key-range ownership (hex; "" = unbounded) for the
    # replicated row tier's split/merge (reference: RegionInfo start/end key)
    start_key: str = ""
    end_key: str = ""
    # non-voting read replicas (reference: learner list, region.h:261-267;
    # learner_load_balance, region_manager.cpp:197).  Older code constructs
    # RegionMeta positionally up to here — fields below are keyword-only in
    # practice (defaults, appended later)
    learners: list[str] = field(default_factory=list)
    # lifecycle (SERVING/SPLITTING/MIGRATING): non-SERVING regions are mid-
    # membership-change, skipped by balance/split decisions
    state: str = SERVING
    # load gauges from the leader's heartbeats (PR 8 telemetry): raft
    # commit-applied gap, proposal backlog, and rows written since the
    # previous leader heartbeat (the write-rate unit is rows/heartbeat —
    # interval-free, so the trigger is deterministic under FakeClock)
    apply_lag: int = 0
    proposal_queue: int = 0
    write_rate: int = 0


@dataclass
class HeartbeatRequest:
    """store -> meta (reference: StoreHeartBeatRequest,
    meta.interface.proto:743)."""
    address: str
    regions: dict[int, tuple] = field(default_factory=dict)
    # region_id -> (version, num_rows[, apply_lag, proposal_queue]):
    # the gauge tail is optional — old stores send 2-tuples, new stores
    # append their per-region raft gauges (PR 8 telemetry)
    leader_ids: list[int] = field(default_factory=list)


@dataclass
class BalanceOrder:
    # add_peer | remove_peer | trans_leader | migrate | split.
    # "migrate" is the learner-first live move (source -> target replica,
    # writes flowing throughout); "split" asks the owning tier for a fenced
    # live split (no target/source).  Dead-store migration still emits the
    # add_peer/remove_peer pair — a dead source has nothing to snapshot
    # from, learner-first catch-up happens against the surviving quorum.
    kind: str
    region_id: int
    target: str = ""
    source: str = ""


@dataclass
class HeartbeatResponse:
    orders: list[BalanceOrder] = field(default_factory=list)
    schema_version: int = 0
    # dynamic config pushed to this instance (reference:
    # update_instance_param, cluster_manager.h:128,141-143 — flags changed
    # cluster-wide at runtime ride the heartbeat response)
    param_overrides: dict = field(default_factory=dict)


class MetaService:
    def __init__(self, faulty_after: float = 15.0, dead_after: float = 60.0,
                 peer_count: int = 3, balance_threshold: int = 2,
                 clock=time.monotonic):
        self.clock = clock
        self.faulty_after = faulty_after
        self.dead_after = dead_after
        self.peer_count = peer_count
        self.balance_threshold = balance_threshold
        self.instances: dict[str, InstanceInfo] = {}
        self.regions: dict[int, RegionMeta] = {}
        self.tso = Tso()
        self.schema_version = 1
        self._region_ids = itertools.count(1)
        # allocation high-water mark: region ids are never reused, even
        # after drop_regions (a reused id could alias a dead raft group)
        self._last_region_id = 0
        # address (or "*") -> {flag: value} dynamic overrides
        self._params: dict[str, dict] = {}
        # table_id -> next cluster-wide row/auto-incr id (alloc_ids)
        self._id_alloc: dict[int, int] = {}
        # region_id -> rows at the last LEADER heartbeat: the write-rate
        # differencing state (rows/heartbeat, see RegionMeta.write_rate)
        self._hb_rows: dict[int, int] = {}
        self._mu = threading.RLock()

    # -- cluster ---------------------------------------------------------
    def add_instance(self, address: str, resource_tag: str = "",
                     logical_room: str = "") -> InstanceInfo:
        with self._mu:
            inst = InstanceInfo(address, resource_tag, logical_room,
                                last_heartbeat=self.clock())
            self.instances[address] = inst
            return inst

    def drop_instance(self, address: str):
        """Operator drain (reference: handle migrate / cluster_manager
        migrate handling): mark MIGRATE, future balancing moves peers away."""
        with self._mu:
            if address in self.instances:
                self.instances[address].status = MIGRATE

    def _healthy(self, tag: str = "") -> list[InstanceInfo]:
        return [i for i in self.instances.values()
                if i.status == NORMAL and (not tag or i.resource_tag == tag)]

    def _peer_counts(self) -> dict[str, int]:
        counts = {a: 0 for a in self.instances}
        for r in self.regions.values():
            for p in r.peers:
                if p in counts:
                    counts[p] += 1
        return counts

    def select_instance(self, exclude: set[str], tag: str = "",
                        prefer_rooms_not_in: set[str] = frozenset()) -> Optional[str]:
        """Least-loaded placement (reference: select_instance_min,
        cluster_manager.h:165-173, with logical-room diversity)."""
        with self._mu:
            counts = self._peer_counts()
            cands = [i for i in self._healthy(tag) if i.address not in exclude]
            if not cands:
                return None
            diverse = [i for i in cands if i.logical_room not in prefer_rooms_not_in]
            pool = diverse or cands
            return min(pool, key=lambda i: counts[i.address]).address

    # -- regions ---------------------------------------------------------
    def create_regions(self, table_id: int, n_regions: int,
                       rows_per_region: int = 1 << 20,
                       resource_tag: str = "") -> list[RegionMeta]:
        with self._mu:
            out = []
            for i in range(n_regions):
                rid = next(self._region_ids)
                self._last_region_id = max(self._last_region_id, rid)
                peers: list[str] = []
                rooms: set[str] = set()
                for _ in range(min(self.peer_count, max(1, len(self._healthy(resource_tag))))):
                    a = self.select_instance(set(peers), resource_tag, rooms)
                    if a is None:
                        break
                    peers.append(a)
                    rooms.add(self.instances[a].logical_room)
                r = RegionMeta(rid, table_id, i * rows_per_region,
                               (i + 1) * rows_per_region, peers,
                               peers[0] if peers else "")
                self.regions[rid] = r
                out.append(r)
            return out

    def report_split(self, region_id: int, split_row: int) -> RegionMeta:
        """Region split finalize (reference: split state machine,
        region.cpp:4472/4864 — here only the meta-side registration)."""
        with self._mu:
            old = self.regions[region_id]
            rid = next(self._region_ids)
            self._last_region_id = max(self._last_region_id, rid)
            new = RegionMeta(rid, old.table_id, split_row, old.end_row,
                             list(old.peers), old.leader)
            old.end_row = split_row
            old.version += 1
            new.version = old.version
            self.regions[rid] = new
            return new

    def split_region_key(self, region_id: int, split_key_hex: str) -> RegionMeta:
        """Key-range split finalize in one step (the legacy store-side size
        split, where copy + fence happen under the tier lock): begin +
        commit back-to-back."""
        with self._mu:
            new = self.begin_split(region_id, split_key_hex)
            return self.commit_split(region_id, new.region_id)

    def begin_split(self, region_id: int, split_key_hex: str) -> RegionMeta:
        """Open a fenced live split: register the child region on the
        parent's peers with state SPLITTING, ROUTING UNCHANGED — the parent
        keeps serving its whole range while the fleet bulk-copies rows into
        the child (region.cpp:4472 split init).  ``commit_split`` flips the
        routing atomically; ``abort_split`` retires the child with the
        parent untouched, so no failure leaves a half-routed region."""
        with self._mu:
            old = self.regions[region_id]
            # SPLITTING is allowed: the tick trigger marks the region when
            # it emits the order, before the fleet executes it here
            if old.state == MIGRATING:
                raise ValueError(
                    f"region {region_id} is {old.state}, cannot split")
            rid = next(self._region_ids)
            self._last_region_id = max(self._last_region_id, rid)
            new = RegionMeta(rid, old.table_id, peers=list(old.peers),
                             leader=old.leader, start_key=split_key_hex,
                             end_key=old.end_key)
            new.version = old.version + 1
            new.state = SPLITTING
            old.state = SPLITTING
            self.regions[rid] = new
            return new

    def commit_split(self, region_id: int, child_id: int) -> RegionMeta:
        """Atomic routing switch (the add_version finalize,
        region.cpp:4864): the parent's range shrinks to end at the child's
        start key and both sides return to SERVING with a bumped version,
        in one registry mutation — a router sees either the old world or
        the new, never a gap or an overlap."""
        with self._mu:
            old = self.regions[region_id]
            new = self.regions[child_id]
            old.end_key = new.start_key
            old.version = new.version = max(old.version + 1, new.version)
            old.state = new.state = SERVING
            return new

    def abort_split(self, region_id: int, child_id: int) -> None:
        """Abandon an open split: the child retires, the parent (whose
        routing never changed) returns to SERVING."""
        with self._mu:
            self.regions.pop(child_id, None)
            self._hb_rows.pop(child_id, None)
            old = self.regions.get(region_id)
            if old is not None and old.state == SPLITTING:
                old.state = SERVING

    def set_region_state(self, region_id: int, state: str) -> None:
        """Fleet-side lifecycle marking (a live migration brackets itself
        with MIGRATING/SERVING so balance ticks skip the region mid-move)."""
        with self._mu:
            r = self.regions.get(region_id)
            if r is not None:
                r.state = state

    def merge_regions_key(self, left_id: int, right_id: int) -> RegionMeta:
        """Merge the right region into its left neighbor: the survivor
        absorbs the range; the right retires from routing."""
        with self._mu:
            left = self.regions[left_id]
            right = self.regions.pop(right_id)
            self._hb_rows.pop(right_id, None)
            left.end_key = right.end_key
            left.version = max(left.version, right.version) + 1
            left.state = SERVING
            return left

    def drop_regions(self, region_ids: list[int]) -> None:
        """Retire regions from the routing table (DROP TABLE / tier reset)."""
        with self._mu:
            for rid in region_ids:
                self.regions.pop(int(rid), None)
                self._hb_rows.pop(int(rid), None)

    def alloc_ids(self, table_id: int, n: int, floor: int = 0) -> int:
        """Allocate ``n`` cluster-wide monotonic ids for a table (the
        auto_incr_state_machine shape: range allocation, burned ranges
        never reused).  ``floor`` lifts the counter past ids already
        observed in recovered data — a restarted meta must never re-issue
        below what the stores hold."""
        with self._mu:
            cur = self._id_alloc.get(table_id, 1)
            cur = max(cur, int(floor))
            self._id_alloc[table_id] = cur + int(n)
            return cur

    def update_region_membership(self, region_id: int,
                                 peers: Optional[list[str]] = None,
                                 leader: Optional[str] = None,
                                 learners: Optional[list[str]] = None
                                 ) -> RegionMeta:
        """Record an executed membership change (operator add/remove peer/
        learner, leadership transfer) so routing and balancing see the real
        raft state — membership has ONE owner: this registry."""
        with self._mu:
            rm = self.regions[region_id]
            if peers is not None:
                rm.peers = list(peers)
            if leader is not None:
                rm.leader = leader
            if learners is not None:
                rm.learners = list(learners)
            return rm

    def route(self, table_id: int, row: int) -> Optional[RegionMeta]:
        """Row -> region (reference: SchemaFactory region routing)."""
        with self._mu:
            for r in self.regions.values():
                if r.table_id == table_id and r.start_row <= row and \
                        (r.end_row < 0 or row < r.end_row):
                    return r
            return None

    # -- heartbeats + control loop ---------------------------------------
    def heartbeat(self, req: HeartbeatRequest) -> HeartbeatResponse:
        with self._mu:
            inst = self.instances.get(req.address)
            if inst is None:
                inst = self.add_instance(req.address)
            inst.last_heartbeat = self.clock()
            if inst.status == FAULTY:
                inst.status = NORMAL
            for rid in req.leader_ids:
                r = self.regions.get(rid)
                if r is not None and req.address in r.peers:
                    r.leader = req.address
            for rid, stats in req.regions.items():
                r = self.regions.get(rid)
                if r is None:
                    continue
                version, num_rows = int(stats[0]), int(stats[1])
                r.version = max(r.version, version)
                r.num_rows = num_rows
                if r.leader and req.address != r.leader:
                    continue    # load gauges are leader-authoritative
                if len(stats) >= 4:
                    r.apply_lag = int(stats[2])
                    r.proposal_queue = int(stats[3])
                prev = self._hb_rows.get(rid)
                if prev is not None:
                    r.write_rate = max(0, num_rows - prev)
                self._hb_rows[rid] = num_rows
            resp = HeartbeatResponse(schema_version=self.schema_version)
            resp.orders.extend(self._orders_for(req.address))
            resp.param_overrides = dict(self._params.get("*", {}))
            resp.param_overrides.update(self._params.get(req.address, {}))
            return resp

    def set_instance_param(self, address: str, name: str, value) -> None:
        """Stage a dynamic config override for one instance (or "*" for the
        whole cluster); delivered on every subsequent heartbeat (reference:
        cluster_manager update_instance_param)."""
        with self._mu:
            self._params.setdefault(address, {})[name] = value

    def tick(self) -> list[BalanceOrder]:
        """Health check + global balancing (reference: meta background
        threads store_healthy_check_function + *_load_balance).  Iteration
        is sorted by region id everywhere, so a fixed heartbeat sequence
        yields an identical order list across runs (the chaos-digest
        determinism contract)."""
        if failpoint.ENABLED:
            if failpoint.hit("meta.balance_tick"):
                return []    # drop: the control loop misses this beat —
                #              the fleet must stay correct without orders
        with self._mu:
            now = self.clock()
            for inst in self.instances.values():
                if inst.status in (DEAD, MIGRATE):
                    continue
                age = now - inst.last_heartbeat
                if age > self.dead_after:
                    inst.status = DEAD
                elif age > self.faulty_after:
                    inst.status = FAULTY
            orders = []
            orders.extend(self._migrate_dead_peers())
            orders.extend(self._split_check())
            orders.extend(self._peer_balance())
            orders.extend(self._leader_balance())
            return orders

    def _regions_sorted(self) -> list[RegionMeta]:
        return [self.regions[rid] for rid in sorted(self.regions)]

    def _split_check(self) -> list[BalanceOrder]:
        """Load-driven split trigger: a SERVING region splits when it
        crosses the row threshold, or when its write rate is a
        ``region_split_skew`` outlier against its table's other regions
        (the hotspot case — rows alone never catch a skewed key range).
        The region is marked SPLITTING here so consecutive ticks don't
        stack duplicate orders; the fleet's split commit/abort returns it
        to SERVING."""
        split_rows = int(FLAGS.region_split_rows)
        skew = float(FLAGS.region_split_skew)
        min_rows = int(FLAGS.region_split_min_rows)
        if split_rows <= 0:
            return []
        by_table: dict[int, list[RegionMeta]] = {}
        for r in self._regions_sorted():
            by_table.setdefault(r.table_id, []).append(r)
        orders = []
        for _tid, rs in sorted(by_table.items()):
            total_rate = sum(r.write_rate for r in rs)
            for r in rs:
                if r.state != SERVING:
                    continue
                hot_rows = r.num_rows >= split_rows
                others = max(1.0, (total_rate - r.write_rate)
                             / max(1, len(rs) - 1))
                hot_skew = (skew > 0 and r.num_rows >= min_rows
                            and r.write_rate >= skew * others)
                if hot_rows or hot_skew:
                    orders.append(BalanceOrder("split", r.region_id))
                    r.state = SPLITTING
        return orders

    def _migrate_dead_peers(self) -> list[BalanceOrder]:
        orders = []
        for r in self._regions_sorted():
            bad = [p for p in r.peers
                   if self.instances.get(p) is None
                   or self.instances[p].status in (DEAD, MIGRATE)]
            for p in bad:
                rooms = {self.instances[q].logical_room for q in r.peers
                         if q in self.instances and q not in bad}
                tgt = self.select_instance(set(r.peers), prefer_rooms_not_in=rooms)
                if tgt is None:
                    continue
                orders.append(BalanceOrder("add_peer", r.region_id, target=tgt,
                                           source=p))
                orders.append(BalanceOrder("remove_peer", r.region_id, source=p))
                r.peers = [q for q in r.peers if q != p] + [tgt]
                if r.leader == p:
                    r.leader = r.peers[0]
        return orders

    def _peer_balance(self) -> list[BalanceOrder]:
        """Move peers off overloaded instances (region_manager.cpp:189) via
        ONE ``migrate`` order per move: the fleet executes it learner-first
        (add learner -> snapshot catch-up -> promote -> remove old peer)
        with writes flowing throughout.  The registry is updated eagerly —
        meta owns intent; the fleet records the real membership back when
        (and only when) the move commits."""
        counts = self._peer_counts()
        healthy = sorted(i.address for i in self._healthy())
        if len(healthy) < 2:
            return []
        avg = sum(counts[a] for a in healthy) / len(healthy)
        orders = []
        for addr in healthy:
            while counts[addr] > avg + self.balance_threshold:
                region = next((r for r in self._regions_sorted()
                               if addr in r.peers and r.state == SERVING),
                              None)
                if region is None:
                    break
                rooms = {self.instances[q].logical_room for q in region.peers
                         if q in self.instances and q != addr}
                tgt = self.select_instance(set(region.peers),
                                           prefer_rooms_not_in=rooms)
                if tgt is None or counts[tgt] + 1 > avg + self.balance_threshold:
                    break
                orders.append(BalanceOrder("migrate", region.region_id,
                                           target=tgt, source=addr))
                region.peers = [q for q in region.peers if q != addr] + [tgt]
                if region.leader == addr:
                    region.leader = region.peers[0]
                counts[addr] -= 1
                counts[tgt] += 1
        return orders

    def _leader_balance(self) -> list[BalanceOrder]:
        """Spread leaders evenly (region_manager.cpp:159)."""
        healthy = {i.address for i in self._healthy()}
        if len(healthy) < 2:
            return []
        lcount = {a: 0 for a in sorted(healthy)}
        for r in self.regions.values():
            if r.leader in lcount:
                lcount[r.leader] += 1
        avg = sum(lcount.values()) / len(lcount)
        orders = []
        for r in self._regions_sorted():
            if r.state != SERVING:
                continue
            if r.leader in lcount and lcount[r.leader] > avg + self.balance_threshold:
                cands = [p for p in r.peers if p in healthy and
                         lcount.get(p, 1 << 30) < avg]
                if cands:
                    tgt = min(cands, key=lambda a: lcount[a])
                    orders.append(BalanceOrder("trans_leader", r.region_id,
                                               target=tgt, source=r.leader))
                    lcount[r.leader] -= 1
                    lcount[tgt] += 1
                    r.leader = tgt
        return orders

    def _orders_for(self, address: str) -> list[BalanceOrder]:
        return []   # per-heartbeat piggyback orders reserved for round 2
