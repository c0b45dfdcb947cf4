"""Store fleet: named store nodes hosting Raft-replicated regions, wired to
the meta service's control loop.

The reference's loop (SURVEY §3.5): stores heartbeat instance + region state
to meta; meta's health checks and balancers answer with add_peer /
remove_peer / trans_leader orders; stores execute them through braft
(region_manager.cpp:159-197, raft_control.cpp).  This module closes the same
loop in-process: ``StoreFleet`` reports REAL raft state (leaders, versions,
row counts) in heartbeats and executes meta's orders as REAL membership
changes / leadership transfers on the underlying RaftGroups — the round-1
gap where balance orders commanded nothing.

The port's copy of ``baikaldb_tpu/raft/fleet.py``, unchanged but for its
imports; its region counters are the port's unregistered ones
(utils/metrics.py)."""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..chaos import failpoint
from ..meta.service import (MIGRATING, SERVING, BalanceOrder,
                            HeartbeatRequest, MetaService)
from ..types import Schema
from ..utils import metrics
from .cluster import RaftGroup, ReplicatedRegion
from .core import LEADER


class MigrateError(RuntimeError):
    """A live replica migration failed and was rolled back (membership
    unchanged — learner torn down, meta registry restored)."""


class StoreFleet:
    """All store nodes of one deployment (addresses are the instance names
    registered with meta; raft node ids are derived stably from them)."""

    def __init__(self, meta: MetaService, addresses: list[str],
                 schema: Optional[Schema] = None,
                 key_columns: Optional[list[str]] = None, seed: int = 7):
        self.meta = meta
        self.schema = schema
        self.key_columns = key_columns
        self.seed = seed
        self.addresses = list(addresses)
        self._ids = {a: i + 1 for i, a in enumerate(addresses)}
        self._addr = {i: a for a, i in self._ids.items()}
        self.groups: dict[int, RaftGroup] = {}     # region_id -> group
        # table_key -> storage.replicated.ReplicatedRowTier: SQL-visible
        # replicated tables survive Database restarts through this registry;
        # tier_lock serializes check-then-create so two frontends creating
        # the same table never mint duplicate region sets
        self.row_tiers: dict = {}
        import threading
        self.tier_lock = threading.Lock()
        for a in addresses:
            meta.add_instance(a)

    def _id_of(self, address: str) -> int:
        if address not in self._ids:
            nid = max(self._addr) + 1 if self._addr else 1
            self._ids[address] = nid
            self._addr[nid] = address
            # late-joining stores (e.g. OLAP learner hosts) must heartbeat
            # like everyone else, or meta's health check marks them DEAD
            self.addresses.append(address)
        return self._ids[address]

    # -- region lifecycle -------------------------------------------------
    def create_table_regions(self, table_id: int, n_regions: int = 1,
                             schema: Optional[Schema] = None,
                             key_columns: Optional[list[str]] = None):
        """Meta assigns placement; the fleet materializes raft groups on the
        chosen peers (init_region fan-out, store.interface.proto:425).
        ``schema``/``key_columns`` override the fleet defaults so each SQL
        table's regions replicate rows in that table's own row encoding."""
        metas = self.meta.create_regions(table_id, n_regions)
        for rm in metas:
            peer_ids = [self._id_of(a) for a in rm.peers]
            g = RaftGroup(rm.region_id, peer_ids, seed=self.seed,
                          schema=schema or self.schema,
                          key_columns=key_columns or self.key_columns)
            self.groups[rm.region_id] = g
            ldr = g.leader()
            rm.leader = self._addr[ldr]
        return metas

    def group(self, region_id: int) -> RaftGroup:
        return self.groups[region_id]

    def materialize_region(self, rm, schema: Optional[Schema] = None,
                           key_columns: Optional[list[str]] = None) -> RaftGroup:
        """Instantiate a raft group for an already-registered RegionMeta —
        the split path: meta registered the child region on the parent's
        peers; the stores now host it (region.cpp:4472 init of the new
        region on the same instances)."""
        peer_ids = [self._id_of(a) for a in rm.peers]
        g = RaftGroup(rm.region_id, peer_ids, seed=self.seed,
                      schema=schema or self.schema,
                      key_columns=key_columns or self.key_columns)
        self.groups[rm.region_id] = g
        rm.leader = self._addr[g.leader()]
        return g

    def replica(self, region_id: int, address: str) -> ReplicatedRegion:
        return self.groups[region_id].bus.nodes[self._ids[address]]

    # -- control loop -----------------------------------------------------
    def heartbeat_all(self):
        """Every live store reports its REAL raft state to meta — version,
        rows, and the PR 8 per-region load gauges (apply lag, proposal
        backlog) meta's load-driven split trigger consumes."""
        for a in self.addresses:
            nid = self._ids[a]
            regions: dict[int, tuple] = {}
            leader_ids = []
            dead = False
            for rid, g in sorted(self.groups.items()):
                node = g.bus.nodes.get(nid)
                if node is None:
                    continue
                if nid in g.bus.down:
                    dead = True
                    continue
                regions[rid] = (1, len(node.rows()),
                                max(0, node.core.commit_index
                                    - node.applied_index),
                                max(0, node.core.last_index
                                    - node.core.commit_index))
                if node.core.role == LEADER:
                    leader_ids.append(rid)
            if not dead:
                resp = self.meta.heartbeat(
                    HeartbeatRequest(a, regions, leader_ids))
                self._apply_params(resp.param_overrides)

    def _apply_params(self, overrides: dict):
        """Apply meta-pushed dynamic config (reference: stores applying
        update_instance_param from heartbeat responses).  Unknown names are
        ignored — meta may be newer than this store."""
        from ..utils.flags import FLAGS, FlagError
        for name, value in overrides.items():
            try:
                FLAGS.set_flag(name, value)   # no-op (no listeners) when
            except FlagError:                  # the value is unchanged
                pass

    def kill_store(self, address: str):
        """Hard-fail one store node across every region it hosts."""
        nid = self._ids[address]
        for g in self.groups.values():
            if nid in g.bus.nodes:
                g.bus.kill(nid)

    def revive_store(self, address: str):
        """Bring a killed store back across every region it hosts."""
        nid = self._ids[address]
        for g in self.groups.values():
            if nid in g.bus.nodes:
                g.bus.revive(nid)

    def partition_store(self, address: str):
        """Partition one store away from the rest of the fleet on EVERY
        region bus it participates in (a split/migration spans multiple
        raft groups — parent + child — so a fleet partition must cover
        them all, not just one group)."""
        nid = self._ids[address]
        for g in self.groups.values():
            if nid in g.bus.nodes:
                rest = [n for n in g.bus.nodes if n != nid]
                if rest:
                    g.bus.partition([nid], rest)

    def heal_all(self):
        """Heal every region bus in the fleet."""
        for g in self.groups.values():
            g.bus.heal()

    # -- elastic regions ---------------------------------------------------
    def tier_of_region(self, region_id: int):
        """The SQL row tier hosting a region, if any (bare test regions
        created straight through create_table_regions have none)."""
        with self.tier_lock:
            tiers = list(self.row_tiers.values())
        for tier in tiers:
            if any(m.region_id == region_id for m in tier.metas):
                return tier
        return None

    def retire_region(self, region_id: int) -> None:
        """Tear one region fully down: raft group out of the fleet, meta
        entry out of routing.  The single teardown seam — split aborts,
        merges and tier release all funnel here so neither registry can
        leak a dead group the other still routes to."""
        self.groups.pop(region_id, None)
        try:
            self.meta.drop_regions([region_id])
        except Exception:       # meta itself quorumless: group is gone,
            metrics.count_swallowed("fleet.retire_region")  # routing entry
            #                         dies with the next meta recovery

    def migrate_replica(self, region_id: int, source: str, target: str,
                        chaos_hook: Optional[Callable[[str], None]] = None
                        ) -> bool:
        """Move one replica ``source`` -> ``target`` LIVE, learner-first
        (reference: peer balance through braft learner catch-up;
        region_manager.cpp:189 + raft_control):

        1. the leader compacts, so the new learner bootstraps from ONE
           snapshot install (the PR 10 artifact-replication bulk-copy
           shape) instead of replaying the whole log,
        2. add learner on ``target`` -> snapshot + log catch-up
           (``migrate.snapshot`` failpoint),
        3. promote the caught-up learner to voter (``migrate.promote``),
        4. transfer leadership away from ``source`` if it leads,
        5. remove the ``source`` peer; meta records the real membership.

        Writes flow throughout — the group keeps a quorum at every step
        (3 voters -> 3 voters + learner -> 4 voters -> 3 voters).  On any
        failure before promotion the learner is torn down and membership
        is restored unchanged (MigrateError); ``chaos_hook(phase)`` lets
        scenarios inject kills/writes between phases deterministically.
        """
        rm = self.meta.regions.get(region_id)
        g = self.groups.get(region_id)
        if rm is None or g is None:
            raise ValueError(f"unknown region {region_id}")
        src_id, tgt_id = self._ids.get(source), self._id_of(target)
        if src_id is None or src_id not in g.bus.nodes:
            raise ValueError(f"{source!r} hosts no replica of "
                             f"region {region_id}")
        if tgt_id in g.bus.nodes:
            raise ValueError(f"{target!r} already hosts a replica of "
                             f"region {region_id}")
        t0 = time.perf_counter()
        self.meta.set_region_state(region_id, MIGRATING)
        learner_added = promoted = False
        try:
            if chaos_hook is not None:
                chaos_hook("start")
            # bulk copy: one snapshot install, not a log replay from 1
            ldr = g.bus.nodes[g.leader()]
            ldr.compact()
            if failpoint.ENABLED:
                if failpoint.hit("migrate.snapshot", region=region_id,
                                 target=target):
                    raise MigrateError(
                        f"region {region_id}: snapshot transfer to "
                        f"{target} failed (injected)")
            if not g.add_learner(tgt_id):
                raise MigrateError(f"region {region_id}: add_learner "
                                   f"{target} did not commit")
            learner_added = True
            if chaos_hook is not None:
                chaos_hook("learner")
            # catch-up gate: the learner must have applied everything the
            # leader has committed before it may count toward quorum
            learner = g.bus.nodes[tgt_id]
            for _ in range(400):
                learner.apply_committed()
                if learner.applied_index >= \
                        g.bus.nodes[g.leader()].core.commit_index:
                    break
                g.bus.pump()
                g.bus.advance(1)
            else:
                raise MigrateError(f"region {region_id}: learner {target} "
                                   f"never caught up")
            if failpoint.ENABLED:
                if failpoint.hit("migrate.promote", region=region_id,
                                 target=target):
                    raise MigrateError(
                        f"region {region_id}: promotion of {target} "
                        f"failed (injected)")
            if not g.promote_learner(tgt_id):
                raise MigrateError(f"region {region_id}: promote "
                                   f"{target} did not commit")
            promoted = True
            if chaos_hook is not None:
                chaos_hook("promoted")
            # leadership must leave the outgoing peer BEFORE removal
            if g.leader() == src_id:
                if g.bus.nodes[src_id].core.transfer_leader(tgt_id):
                    g.bus.pump()
                    g.bus.elect()
                if g.leader() == src_id:
                    raise MigrateError(
                        f"region {region_id}: could not transfer "
                        f"leadership off {source}")
            if not g.remove_peer(src_id):
                raise MigrateError(f"region {region_id}: remove_peer "
                                   f"{source} did not commit")
            if chaos_hook is not None:
                chaos_hook("removed")
        except MigrateError:
            # pre-promotion failure: tear the learner down — membership is
            # exactly what it was.  Post-promotion failure (remove_peer of
            # the source did not commit): the target IS a raft voter now;
            # tearing it down would fight the committed config, so the
            # region stays at 4 voters and meta records that real state —
            # a consistent (if temporarily wide) membership, never a
            # half-routed one.
            if learner_added and not promoted and tgt_id in g.bus.nodes:
                g.remove_learner(tgt_id)
            self._record_membership(region_id, g)
            metrics.region_migrate_aborts.add(1)
            raise
        finally:
            self.meta.set_region_state(region_id, SERVING)
        self._record_membership(region_id, g)
        metrics.region_migrations.add(1)
        metrics.region_handoff_ms.observe((time.perf_counter() - t0) * 1e3)
        return True

    def _record_membership(self, region_id: int, g: RaftGroup) -> None:
        """Write the raft group's REAL membership back into meta's registry
        (the one owner of routing state)."""
        try:
            ldr = g.leader()
        except RuntimeError:
            return                      # quorumless: nothing to record
        peers = sorted(self._addr[n] for n in g.bus.nodes[ldr].core.peers()
                       if n in self._addr)
        learners = sorted(self._addr[n]
                          for n in g.bus.nodes[ldr].core.learners()
                          if n in self._addr)
        self.meta.update_region_membership(
            region_id, peers=peers, leader=self._addr.get(ldr, ""),
            learners=learners)

    def apply_orders(self, orders: list[BalanceOrder]) -> int:
        """Execute meta's balance orders as real raft operations
        (reference: store applying heartbeat-response orders,
        region.h:654-665)."""
        done = 0
        for o in orders:
            g = self.groups.get(o.region_id)
            if g is None:
                continue
            if o.kind == "split":
                tier = self.tier_of_region(o.region_id)
                if tier is None:
                    # bare (tierless) region: nothing can execute a split —
                    # clear the SPLITTING mark so balancing resumes
                    self.meta.set_region_state(o.region_id, SERVING)
                    continue
                from ..storage.replicated import SplitError
                try:
                    tier.split_region_online(o.region_id)
                    done += 1
                except SplitError:
                    pass           # aborted cleanly; next tick retries
            elif o.kind == "migrate":
                try:
                    if self.migrate_replica(o.region_id, o.source,
                                            o.target):
                        done += 1
                except (MigrateError, ValueError):
                    # rolled back (or stale order): meta re-learns real
                    # membership from heartbeats and may retry
                    self._record_membership(o.region_id, g)
            elif o.kind == "add_peer":
                if g.add_peer(self._id_of(o.target)):
                    done += 1
            elif o.kind == "remove_peer":
                nid = self._ids.get(o.source)
                if nid is None or nid not in g.bus.nodes:
                    continue
                if g.bus.leader() == nid:
                    continue       # meta must transfer leadership first
                if g.remove_peer(nid):
                    done += 1
            elif o.kind == "trans_leader":
                src, tgt = self._ids.get(o.source), self._ids.get(o.target)
                if src is None or tgt is None or src not in g.bus.nodes:
                    continue
                if not g.bus.nodes[src].core.transfer_leader(tgt):
                    continue       # source no longer leads: stale order
                g.bus.pump()
                if g.bus.elect() == tgt:
                    done += 1      # count only a transfer that took effect
        return done

    def operator_order(self, kind: str, region_id: int,
                       address: str) -> None:
        """Operator membership op (reference: raft_control add/remove/
        transfer-leader RPCs): validates against meta, executes on the raft
        group, and records the result in meta's region registry — so
        routing and balancing never drift from real membership.  Raises
        ValueError on bad input, RuntimeError when the raft op fails."""
        rm = self.meta.regions.get(region_id)
        g = self.groups.get(region_id)
        if rm is None or g is None:
            raise ValueError(f"unknown region {region_id}")
        if address not in self.meta.instances:
            raise ValueError(f"unknown store {address!r}")
        if kind == "add_peer":
            if address in rm.peers:
                raise ValueError(f"{address} is already a peer")
            if not g.add_peer(self._id_of(address)):
                raise RuntimeError(f"add_peer {address} did not commit")
            self.meta.update_region_membership(
                region_id, peers=list(rm.peers) + [address])
        elif kind == "remove_peer":
            if address not in rm.peers:
                raise ValueError(f"{address} is not a peer")
            nid = self._ids.get(address)
            if nid is not None and g.bus.leader() == nid:
                raise ValueError("transfer leadership away first")
            if not g.remove_peer(nid):
                raise RuntimeError(f"remove_peer {address} did not commit")
            self.meta.update_region_membership(
                region_id, peers=[p for p in rm.peers if p != address])
        elif kind == "add_learner":
            if address in rm.peers or address in rm.learners:
                raise ValueError(f"{address} already hosts a replica")
            if not g.add_learner(self._id_of(address)):
                raise RuntimeError(f"add_learner {address} did not commit")
            self.meta.update_region_membership(
                region_id, learners=list(rm.learners) + [address])
        elif kind == "remove_learner":
            if address not in rm.learners:
                raise ValueError(f"{address} is not a learner")
            if not g.remove_learner(self._ids.get(address)):
                raise RuntimeError(f"remove_learner {address} did not "
                                   f"commit")
            self.meta.update_region_membership(
                region_id,
                learners=[a for a in rm.learners if a != address])
        elif kind == "trans_leader":
            src = g.leader()
            tgt = self._ids.get(address)
            if tgt is None or tgt not in g.bus.nodes:
                raise ValueError(f"{address} hosts no replica of "
                                 f"region {region_id}")
            if src == tgt:
                return
            if not g.bus.nodes[src].core.transfer_leader(tgt):
                raise RuntimeError("current leader rejected the transfer")
            g.bus.pump()
            if g.bus.elect() != tgt:
                raise RuntimeError("leadership transfer did not take effect")
            self.meta.update_region_membership(region_id, leader=address)
        else:
            raise ValueError(f"unknown operator order {kind!r}")

    def control_tick(self) -> int:
        """One full control-loop turn: heartbeats in, orders out, orders
        executed.  Returns how many orders were applied."""
        self.heartbeat_all()
        orders = self.meta.tick()
        return self.apply_orders(orders)
