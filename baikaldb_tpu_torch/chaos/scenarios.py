"""Seeded chaos scenarios: kill / partition / latency scripts with
exactly-once and convergence assertions.

The port of ``baikaldb_tpu/chaos/scenarios.py``: the same ten scenarios,
each taking a ``device`` (None: the CUDA card; the CPU tests pass
``"cpu"``) on which every ``Database`` it builds runs.

Two planes, two guarantees:

- **fleet plane** (``kill_leader``, ``partition``, ``split_chaos``,
  ``migrate_chaos``, ``snapshot_chaos``, ``cdc_chaos``): StoreFleet regions
  on the deterministic in-process LocalBus.  Everything — the fault
  schedule, raft elections, apply order, the final table AND binlog state —
  is a pure function of the seed, so a run replays **bit-identically**
  (``state_digest`` equality across runs is the acceptance check;
  wall-clock TSO timestamps are excluded from the digest by design).  The
  Raft core and the LocalBus are the JAX package's, byte for byte, so the
  five fleet-plane scenarios give the JAX package's schedule and digest at
  the same seed.
- **daemon plane** (``rpc_chaos``, ``fragment_chaos``): real in-process
  meta + store daemons (server/{meta,store}_server.py, which import no
  torch) over TCP sockets, seeded ``store.handler`` latency and
  ``rpc.recv`` response drops from chaos/failpoint.py, plus a mid-run crash
  of the region leader's daemon.  Thread/socket timing is not replayable,
  but the OUTCOME contract is: every client write lands exactly once
  (RpcClient retry + idempotency-token dedupe at the daemons), and the
  final row state digest is seed-deterministic.

Every scenario returns a JSON-able dict: ``fault_schedule`` (the injected
faults, in order), ``state_digest`` (sha256 over the deterministic final
state), assertion results, and observed counters (retries, dedupe hits,
latency percentiles).  ``python -m baikaldb_tpu_torch.tools.chaos_run
--seed N`` drives them.
"""

from __future__ import annotations

import hashlib
import json
import random
import time

from . import failpoint


def _digest(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()[:16]


def _p(lat_ms: list, q: float) -> float:
    if not lat_ms:
        return 0.0
    s = sorted(lat_ms)
    return round(s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))], 3)


def _fleet_session(seed: int, stores: int = 3, device=None):
    from ..exec.session import Database, Session
    from ..meta.service import MetaService
    from ..raft.fleet import StoreFleet

    fleet = StoreFleet(MetaService(peer_count=3),
                       [f"c{i + 1}:1" for i in range(stores)], seed=7 + seed)
    db = Database(device, fleet=fleet)
    s = Session(db)
    s.execute("CREATE DATABASE chaos")
    s.execute("USE chaos")
    s.execute("CREATE TABLE ck (k BIGINT, v BIGINT, PRIMARY KEY (k))")
    return fleet, db, s


def _check_exactly_once(rows: list[dict], events, writes: int) -> list[str]:
    """Shared assertions: every acked write visible exactly once in the
    table AND in the binlog stream (no lost, no duplicated)."""
    problems = []
    got = {r["k"]: r["v"] for r in rows}
    want = {i: i * i for i in range(writes)}
    if len(rows) != len(got):
        problems.append("duplicate keys in final table state")
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(k for k in set(got) & set(want)
                       if got[k] != want[k])
        problems.append(f"table state diverged (missing={missing[:5]} "
                        f"extra={extra[:5]} wrong={wrong[:5]})")
    seen_keys: list[int] = []
    for e in events:
        for r in e.rows or []:
            seen_keys.append(int(r["k"]))
    if sorted(seen_keys) != sorted(want):
        problems.append(
            f"binlog events diverged: {len(seen_keys)} row images for "
            f"{writes} writes (lost="
            f"{sorted(set(want) - set(seen_keys))[:5]}, dup="
            f"{sorted(k for k in set(seen_keys) if seen_keys.count(k) > 1)[:5]})")
    return problems


def kill_leader(seed: int = 1, writes: int = 30, device=None) -> dict:
    """Seeded leader kill/revive churn on the fleet plane while SQL
    INSERTs flow.  The write path retries through elections
    (RaftGroup.propose_cmd); 2-of-3 quorum keeps committing.  Asserts
    exactly-once table rows and binlog events; fully deterministic."""
    rng = random.Random((seed << 8) ^ 0x6B696C)
    fleet, db, s = _fleet_session(seed, device=device)
    tier = fleet.row_tiers["chaos.ck"]
    g = tier.groups[0]
    schedule: list[list] = []
    killed = None
    for i in range(writes):
        if killed is not None and rng.random() < 0.5:
            g.bus.revive(killed)
            schedule.append([i, "revive", killed])
            killed = None
        if killed is None and rng.random() < 0.35:
            try:
                victim = g.leader()
            except RuntimeError:
                victim = None
            if victim is not None:
                g.bus.kill(victim)
                schedule.append([i, "kill_leader", victim])
                killed = victim
        s.execute(f"INSERT INTO ck VALUES ({i}, {i * i})")
    if killed is not None:
        g.bus.revive(killed)
        schedule.append([writes, "revive", killed])
    rows = s.query("SELECT k, v FROM ck ORDER BY k")
    events = [e for e in db.binlog.read(0, 1 << 20)
              if e.table == "ck" and e.event_type == "insert"]
    problems = _check_exactly_once(rows, events, writes)
    state = {"rows": rows,
             # commit_ts is wall-clock (TSO): excluded from the digest
             "binlog": [[e.event_type, e.rows] for e in events]}
    return {"writes": writes, "fault_schedule": schedule,
            "faults": len(schedule),
            "state_digest": _digest({"schedule": schedule, "state": state}),
            "problems": problems}


def partition(seed: int = 2, writes: int = 24, device=None) -> dict:
    """Seeded network partitions on the fleet plane: the current leader is
    repeatedly isolated from the majority, which elects around it; heals
    re-join it.  Asserts exactly-once plus full replica convergence after
    the final heal (every live replica holds identical rows)."""
    rng = random.Random((seed << 8) ^ 0x706172)
    fleet, db, s = _fleet_session(seed, device=device)
    tier = fleet.row_tiers["chaos.ck"]
    g = tier.groups[0]
    schedule: list[list] = []
    partitioned = False
    for i in range(writes):
        if partitioned and rng.random() < 0.5:
            g.bus.heal()
            schedule.append([i, "heal"])
            partitioned = False
        if not partitioned and rng.random() < 0.3:
            try:
                ldr = g.leader()
            except RuntimeError:
                ldr = None
            if ldr is not None:
                rest = [n for n in g.bus.nodes if n != ldr]
                g.bus.partition([ldr], rest)
                schedule.append([i, "partition_leader", ldr])
                partitioned = True
        s.execute(f"INSERT INTO ck VALUES ({i}, {i * i})")
    if partitioned:
        g.bus.heal()
        schedule.append([writes, "heal"])
    g.bus.advance(30)               # let the isolated replica catch up
    rows = s.query("SELECT k, v FROM ck ORDER BY k")
    events = [e for e in db.binlog.read(0, 1 << 20)
              if e.table == "ck" and e.event_type == "insert"]
    problems = _check_exactly_once(rows, events, writes)
    replica_states = []
    for nid in sorted(g.bus.nodes):
        node = g.bus.nodes[nid]
        node.apply_committed()
        replica_states.append(
            sorted((r["k"], r["v"]) for r in node.rows_in_range()))
    if any(st != replica_states[0] for st in replica_states[1:]):
        problems.append("replicas did not converge after heal")
    state = {"rows": rows,
             "binlog": [[e.event_type, e.rows] for e in events],
             "replicas": replica_states}
    return {"writes": writes, "fault_schedule": schedule,
            "faults": len(schedule),
            "state_digest": _digest({"schedule": schedule, "state": state}),
            "problems": problems}


def rpc_chaos(seed: int = 3, writes: int = 16, delay_ms: float = 10.0,
              delay_pct: int = 30, drop_pct: int = 15,
              crash_leader: bool = True, device=None) -> dict:
    """Daemon plane: 1 in-process meta + 3 in-process store daemons over
    real TCP, with seeded handler latency (``store.handler`` delay) and
    lost responses (``rpc.recv`` drop — the server executed, the reply
    died), plus a mid-run crash of the region leader's daemon.  Client
    writes ride RpcClient's backoff+jitter retries; lost-response resends
    dedupe at the daemons by idempotency token.  Asserts every write
    landed exactly once; reports retry/dedupe/timeout counters and write
    latency percentiles.  The writes go straight to the daemons' row tier:
    no engine runs, so ``device`` is accepted and unused."""
    from ..server.meta_server import MetaServer
    from ..server.store_server import StoreServer
    from ..storage.remote_tier import ClusterClient, RemoteRowTier
    from ..storage.rowstore import KeyCodec
    from ..types import Field, LType, Schema
    from ..utils import metrics
    from ..utils.flags import FLAGS, set_flag

    prev_seed = int(FLAGS.chaos_seed)
    set_flag("chaos_seed", int(seed))
    meta = MetaServer("127.0.0.1:0")
    meta.start()
    stores: list[StoreServer] = []
    schedule: list[list] = []
    lat_ms: list[float] = []
    r0 = metrics.rpc_retries.value
    d0 = metrics.rpc_dedup_hits.value
    t0 = metrics.rpc_timeouts.value
    try:
        meta_addr = f"127.0.0.1:{meta.rpc.port}"
        for sid in (1, 2, 3):
            st = StoreServer(sid, "127.0.0.1:0", meta_addr,
                             tick_interval=0.02, seed=seed * 11 + sid)
            st.address = f"127.0.0.1:{st.rpc.port}"
            st.start()
            stores.append(st)
        schema = Schema((Field("k", LType.INT64, False),
                         Field("v", LType.INT64, True)))
        cluster = ClusterClient(meta_addr)
        tier = RemoteRowTier.get_or_create(
            cluster, f"chaos.rpc_s{seed}", schema, ["k"])
        kc = KeyCodec(schema, ["k"])
        crash_at = writes // 3
        try:
            failpoint.set_failpoint("store.handler",
                                    f"{delay_pct}%delay({delay_ms})")
            failpoint.set_failpoint("rpc.recv", f"{drop_pct}%drop")
            for i in range(writes):
                if crash_leader and i == crash_at:
                    victim_addr = tier.regions[0].leader_addr
                    for st in stores:
                        if st.address == victim_addr:
                            st.crash()  # SIGKILL analog: 2/3 quorum remains
                            schedule.append([i, "crash_store", st.store_id])
                row = {"k": i, "v": i * i}
                w0 = time.perf_counter()
                tier.write_ops([(0, kc.encode_one(row),
                                 tier.row_codec.encode(row))])
                lat_ms.append((time.perf_counter() - w0) * 1e3)
        finally:
            failpoint.clear("store.handler")
            failpoint.clear("rpc.recv")
            set_flag("chaos_seed", prev_seed)
        problems = []
        got = {r["k"]: r["v"] for r in tier.scan_rows()
               if not r.get("__del")}
        want = {i: i * i for i in range(writes)}
        if got != want:
            problems.append(
                f"writes lost or corrupted (missing="
                f"{sorted(set(want) - set(got))[:5]})")
    finally:
        # a failed write mid-run must NOT leak daemon tick threads and
        # ports into the process (bench / repeated runs share it)
        for st in stores:
            st.stop()
        meta.stop()
    return {"writes": writes, "fault_schedule": schedule,
            "faults": len(schedule),
            # rows only: WHICH store led at crash time is thread-timing,
            # so the schedule is informational here — the seed-stable
            # contract on the daemon plane is the final row state
            "state_digest": _digest({"rows": sorted(got.items())}),
            "problems": problems,
            "rpc_retries": metrics.rpc_retries.value - r0,
            "rpc_dedup_hits": metrics.rpc_dedup_hits.value - d0,
            "rpc_timeouts": metrics.rpc_timeouts.value - t0,
            "p50_ms": _p(lat_ms, 0.50), "p99_ms": _p(lat_ms, 0.99),
            "max_ms": round(max(lat_ms), 3) if lat_ms else 0.0}


def dispatch_overload(seed: int = 4, clients: int = 12, queries: int = 8,
                      writes: int | None = None, delay_ms: float = 8.0,
                      delay_pct: int = 60, queue_max: int = 4,
                      device=None) -> dict:
    """Overload the cross-query batched dispatcher (exec/dispatch.py) while
    the combiner is stalled by a seeded ``dispatch.combine`` delay: many
    client threads hammer one statement group through the qos gate with the
    per-group queue bound cranked down.

    Outcome contract (thread timing owns the interleaving, so this is the
    rpc_chaos-style contract, not bit-identical replay): every query either
    returns ITS OWN correct row exactly once or raises a typed
    ``RejectedError`` (qos bucket / ``DispatchOverload`` queue bound) —
    never a wrong row, never a hang, never an untyped failure; the observed
    queue depth stays within the configured bound; combiner stalls degrade
    to inline fallback, not loss."""
    import threading

    from ..exec.session import Database, Session
    from ..utils import metrics
    from ..utils.flags import FLAGS, set_flag
    from ..utils.qos import QosManager, RejectedError

    if writes is not None:              # chaos_run --writes compatibility
        queries = max(1, int(writes) // clients)
    prev_seed = int(FLAGS.chaos_seed)
    prev_on = bool(FLAGS.batch_dispatch)
    prev_qmax = int(FLAGS.batch_dispatch_queue_max)
    prev_tick = float(FLAGS.batch_dispatch_tick_ms)
    set_flag("chaos_seed", int(seed))
    set_flag("batch_dispatch", True)    # the combiner IS the scenario
    set_flag("batch_dispatch_queue_max", int(queue_max))
    set_flag("batch_dispatch_tick_ms", 2.0)
    t0 = metrics.failpoint_trips.value
    f0 = metrics.dispatch_fallbacks.value
    g0 = metrics.batched_groups.value
    db = Database(device)
    boot = Session(db)
    boot.execute("CREATE TABLE dq (id BIGINT, v BIGINT)")
    boot.execute("INSERT INTO dq VALUES " + ", ".join(
        f"({i}, {i * 3})" for i in range(clients * queries)))
    boot.query("SELECT v FROM dq WHERE id = 0")        # settle the plan
    # generous user/sign rates, tight per-table bucket: the overload sheds
    # AT the hot table, which is the dimension this scenario drives
    db.qos = QosManager(table_rate=30.0, table_burst=float(
        clients * queries // 2))
    ok: list[tuple[int, int]] = []
    rejected: list[str] = []
    problems: list[str] = []
    mu = threading.Lock()
    depth_seen = [0]
    stop = threading.Event()

    def sampler():
        while not stop.is_set():
            depth_seen[0] = max(depth_seen[0], db.dispatcher.queue_depth())
            time.sleep(0.0005)

    def worker(tid: int):
        s = Session(db)
        for q in range(queries):
            i = tid * queries + q
            try:
                r = s.query(f"SELECT v FROM dq WHERE id = {i}")
            except RejectedError as e:
                with mu:
                    rejected.append(type(e).__name__)
                continue
            except Exception as e:      # noqa: BLE001 — the report IS the point
                with mu:
                    problems.append(
                        f"untyped failure for id {i}: "
                        f"{type(e).__name__}: {e}")
                continue
            if r != [{"v": i * 3}]:
                with mu:
                    problems.append(f"wrong result for id {i}: {r!r}")
            else:
                with mu:
                    ok.append((tid, i))
    try:
        failpoint.set_failpoint("dispatch.combine",
                                f"{delay_pct}%delay({delay_ms})")
        smp = threading.Thread(target=sampler, daemon=True)
        smp.start()
        ts = [threading.Thread(target=worker, args=(t,))
              for t in range(clients)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        stop.set()
        smp.join(timeout=1)
    finally:
        failpoint.clear("dispatch.combine")
        set_flag("chaos_seed", prev_seed)
        set_flag("batch_dispatch", prev_on)
        set_flag("batch_dispatch_queue_max", prev_qmax)
        set_flag("batch_dispatch_tick_ms", prev_tick)
    total = clients * queries
    if len(ok) + len(rejected) != total:
        problems.append(f"accounting hole: {len(ok)} ok + {len(rejected)} "
                        f"rejected != {total} issued")
    if metrics.batched_groups.value == g0:
        problems.append("combiner never engaged — the scenario exercised "
                        "nothing")
    if depth_seen[0] > queue_max:
        problems.append(f"queue depth {depth_seen[0]} exceeded the "
                        f"{queue_max} bound")
    return {"clients": clients, "queries": total,
            "succeeded": len(ok), "rejected": len(rejected),
            "faults": metrics.failpoint_trips.value - t0,
            "fault_schedule": [],     # thread timing owns hit order; the
            #                           per-hit trigger schedule is still a
            #                           pure fn of (seed, hit index)
            "combiner_fallbacks": metrics.dispatch_fallbacks.value - f0,
            "batched_groups": metrics.batched_groups.value - g0,
            "max_queue_depth": depth_seen[0],
            "state_digest": _digest(
                {"rows": [[i, i * 3] for i in range(total)]}),
            "problems": problems}


def _region_invariants(fleet, tier) -> list[str]:
    """Never-half-routed checks shared by the elastic-region scenarios:
    the tier's ranges tile the keyspace with no gap or overlap, every tier
    region is SERVING in meta, and the meta registry / fleet group table /
    tier routing lists agree exactly on which regions exist."""
    problems = []
    if tier._starts[0] != b"" or tier._ends[-1] != b"":
        problems.append("tier range endpoints no longer span the keyspace")
    for i in range(len(tier.metas) - 1):
        if tier._ends[i] != tier._starts[i + 1]:
            problems.append(
                f"range gap/overlap between regions "
                f"{tier.metas[i].region_id} and {tier.metas[i + 1].region_id}")
    tier_rids = {m.region_id for m in tier.metas}
    meta_rids = {rid for rid, r in fleet.meta.regions.items()
                 if r.table_id == tier.table_id}
    if tier_rids != meta_rids:
        problems.append(f"meta/tier region sets diverged "
                        f"(tier={sorted(tier_rids)} meta={sorted(meta_rids)})")
    for m in tier.metas:
        rm = fleet.meta.regions.get(m.region_id)
        if rm is not None and rm.state != "SERVING":
            problems.append(f"region {m.region_id} stuck {rm.state}")
        if m.region_id not in fleet.groups:
            problems.append(f"region {m.region_id} routed but its raft "
                            f"group left the fleet")
    for rid in fleet.groups:
        if fleet.meta.regions.get(rid) is None:
            problems.append(f"raft group {rid} leaked (no meta entry)")
    return problems


def _replica_convergence(tier) -> tuple[list, list[str]]:
    """Per-region replica states after a settle; diverged replicas are
    problems.  Returns (states for the digest, problems)."""
    problems = []
    states = []
    for m, g in zip(tier.metas, tier.groups):
        g.bus.advance(30)
        per = []
        for nid in sorted(g.bus.nodes):
            node = g.bus.nodes[nid]
            node.apply_committed()
            per.append(sorted((r["k"], r["v"])
                              for r in node.rows_in_range()))
        if any(st != per[0] for st in per[1:]):
            problems.append(f"replicas of region {m.region_id} did not "
                            f"converge after heal")
        states.append(per[0])
    return states, problems


def split_chaos(seed: int = 5, writes: int = 40, device=None) -> dict:
    """Partition the fleet mid-split (the tentpole contract): a live
    fenced split runs while SQL INSERTs keep flowing, and the seeded fault
    is one of — partition the leader's store away from the fleet at the
    bulk-copy or catch-up phase (the split must COMPLETE through elections
    on the majority side), or drop the ``region.handoff`` /
    ``region.split_fence`` seam (the split must ABORT cleanly and a retry
    must complete).  Ends with exactly-once rows, key-ordered binlog,
    converged replicas, and a fully-routed region table — then a lowered
    ``region_split_rows`` proves the meta-tick -> split-order -> online
    split path end to end.  Fleet plane: bit-identical replay."""
    from ..storage.replicated import SplitError
    from ..utils.flags import FLAGS, set_flag

    rng = random.Random((seed << 8) ^ 0x73706C)
    fleet, db, s = _fleet_session(seed, device=device)
    tier = fleet.row_tiers["chaos.ck"]
    schedule: list[list] = []
    problems: list[str] = []
    next_key = 0

    def put(n: int):
        nonlocal next_key
        for _ in range(min(n, writes - next_key)):
            s.execute(f"INSERT INTO ck VALUES ({next_key}, "
                      f"{next_key * next_key})")
            next_key += 1

    put(writes // 2)
    parent = tier.metas[0].region_id
    fault = rng.choice(["partition_begin", "partition_copied",
                        "handoff_drop", "fence_drop"])
    mid_writes = 3 + rng.randrange(4)
    schedule.append(["fault_plan", fault, mid_writes])

    def hook(phase: str):
        schedule.append(["phase", phase])
        put(mid_writes)             # writes continue during the live split
        if fault == f"partition_{phase}":
            ldr = fleet.meta.regions[parent].leader
            fleet.partition_store(ldr)
            schedule.append(["partition", ldr, phase])

    try:
        if fault == "handoff_drop":
            failpoint.set_failpoint("region.handoff", "1*drop")
        elif fault == "fence_drop":
            failpoint.set_failpoint("region.split_fence", "1*drop")
        try:
            child = tier.split_region_online(parent, chaos_hook=hook)
            schedule.append(["split_ok", parent, child.region_id])
        except SplitError:
            schedule.append(["split_abort", parent])
            fleet.heal_all()
            try:                    # aborted cleanly -> a retry completes
                child = tier.split_region_online(parent)
                schedule.append(["split_retry_ok", parent, child.region_id])
            except SplitError as e:
                problems.append(f"split retry failed: {e}")
    finally:
        failpoint.clear("region.handoff")
        failpoint.clear("region.split_fence")
        fleet.heal_all()
    put(writes - next_key)          # lands across BOTH sides of the split
    # tick-driven path: with the threshold lowered, heartbeats feed the
    # load gauges and meta's next tick emits split orders the fleet
    # executes as further online splits
    prev_rows = int(FLAGS.region_split_rows)
    set_flag("region_split_rows", max(4, writes // 4))
    try:
        fleet.heartbeat_all()
        fleet.heartbeat_all()
        orders = fleet.meta.tick()
        applied = fleet.apply_orders(orders)
        schedule.append(["tick", sorted([o.kind, o.region_id]
                                        for o in orders), applied])
        if not any(o.kind == "split" for o in orders):
            problems.append("meta tick emitted no split order despite "
                            "rows over threshold")
    finally:
        set_flag("region_split_rows", prev_rows)
    rows = s.query("SELECT k, v FROM ck ORDER BY k")
    events = [e for e in db.binlog.read(0, 1 << 20)
              if e.table == "ck" and e.event_type == "insert"]
    problems += _check_exactly_once(rows, events, writes)
    seen = [int(r["k"]) for e in events for r in (e.rows or [])]
    if seen != sorted(seen):
        problems.append("binlog order diverged from write order")
    if len(tier.metas) < 2:
        problems.append("no split happened")
    problems += _region_invariants(fleet, tier)
    replicas, conv = _replica_convergence(tier)
    problems += conv
    state = {"rows": rows,
             "binlog": [[e.event_type, e.rows] for e in events],
             "regions": [[m.region_id, tier._starts[i].hex(),
                          tier._ends[i].hex()]
                         for i, m in enumerate(tier.metas)],
             "replicas": replicas}
    return {"writes": writes, "fault_schedule": schedule,
            "faults": len(schedule),
            "regions": len(tier.metas),
            "state_digest": _digest({"schedule": schedule, "state": state}),
            "problems": problems}


def migrate_chaos(seed: int = 6, writes: int = 36, device=None) -> dict:
    """Kill the leader mid-migration (the tentpole contract): a learner-
    first live migration moves a replica off the region's current leader
    store to the fleet's idle fourth store while SQL INSERTs keep flowing.
    The seeded fault is one of — kill the leader's node at the start or
    at learner catch-up (the migration must COMPLETE through elections),
    or drop the ``migrate.snapshot`` / ``migrate.promote`` seam (clean
    rollback, then a retry completes).  Ends with exactly-once rows,
    key-ordered binlog, converged replicas, and meta's membership exactly
    equal to the raft group's — completed or rolled back, never half-
    moved.  Fleet plane: bit-identical replay."""
    from ..raft.fleet import MigrateError

    rng = random.Random((seed << 8) ^ 0x6D6967)
    fleet, db, s = _fleet_session(seed, stores=4, device=device)
    tier = fleet.row_tiers["chaos.ck"]
    rid = tier.metas[0].region_id
    g = tier.groups[0]
    schedule: list[list] = []
    problems: list[str] = []
    next_key = 0

    def put(n: int):
        nonlocal next_key
        for _ in range(min(n, writes - next_key)):
            s.execute(f"INSERT INTO ck VALUES ({next_key}, "
                      f"{next_key * next_key})")
            next_key += 1

    put(writes // 2)
    rm = fleet.meta.regions[rid]
    source = rm.leader              # move the LEADER's replica: the move
    #                                 must transfer leadership away first
    target = next(a for a in sorted(fleet.addresses) if a not in rm.peers)
    fault = rng.choice(["kill_leader_start", "kill_leader_learner",
                        "snapshot_drop", "promote_drop"])
    mid_writes = 3 + rng.randrange(4)
    schedule.append(["fault_plan", fault, source, target, mid_writes])
    killed: list[int] = []

    def hook(phase: str):
        schedule.append(["phase", phase])
        put(mid_writes)         # writes continue during the live migration
        if fault == f"kill_leader_{phase}":
            try:
                victim = g.leader()
            except RuntimeError:
                return
            g.bus.kill(victim)
            killed.append(victim)
            schedule.append(["kill_leader", victim, phase])

    try:
        if fault == "snapshot_drop":
            failpoint.set_failpoint("migrate.snapshot", "1*drop")
        elif fault == "promote_drop":
            failpoint.set_failpoint("migrate.promote", "1*drop")
        try:
            fleet.migrate_replica(rid, source, target, chaos_hook=hook)
            schedule.append(["migrate_ok", source, target])
        except MigrateError:
            schedule.append(["migrate_abort", source, target])
            for nid in killed:
                g.bus.revive(nid)
            killed.clear()
            try:                # rolled back cleanly -> a retry completes
                fleet.migrate_replica(rid, source, target)
                schedule.append(["migrate_retry_ok", source, target])
            except MigrateError as e:
                problems.append(f"migration retry failed: {e}")
    finally:
        failpoint.clear("migrate.snapshot")
        failpoint.clear("migrate.promote")
        for nid in killed:
            g.bus.revive(nid)
    put(writes - next_key)
    rows = s.query("SELECT k, v FROM ck ORDER BY k")
    events = [e for e in db.binlog.read(0, 1 << 20)
              if e.table == "ck" and e.event_type == "insert"]
    problems += _check_exactly_once(rows, events, writes)
    seen = [int(r["k"]) for e in events for r in (e.rows or [])]
    if seen != sorted(seen):
        problems.append("binlog order diverged from write order")
    # membership: completed-or-rolled-back, never half-moved — meta's
    # registry must equal the raft group's real voter set
    rm = fleet.meta.regions[rid]
    raft_peers = sorted(fleet._addr[n] for n in g.peers())
    if sorted(rm.peers) != raft_peers:
        problems.append(f"meta peers {sorted(rm.peers)} != raft voters "
                        f"{raft_peers}")
    if g.bus.nodes[g.leader()].core.learners():
        problems.append("migration left a dangling learner behind")
    if source in raft_peers:
        problems.append(f"replica never left {source} (migration neither "
                        f"completed nor cleanly retried)")
    if target not in raft_peers:
        problems.append(f"replica never reached {target}")
    if rm.state != "SERVING":
        problems.append(f"region stuck {rm.state}")
    problems += _region_invariants(fleet, tier)
    replicas, conv = _replica_convergence(tier)
    problems += conv
    state = {"rows": rows,
             "binlog": [[e.event_type, e.rows] for e in events],
             "membership": raft_peers,
             "replicas": replicas}
    return {"writes": writes, "fault_schedule": schedule,
            "faults": len(schedule),
            "membership": raft_peers,
            "state_digest": _digest({"schedule": schedule, "state": state}),
            "problems": problems}


def stream_chaos(seed: int = 7, rows: int = 384, chunk_rows: int = 64,
                 writes: int | None = None, drop_pct: int = 25,
                 delay_ms: float = 1.0, device=None) -> dict:
    """Out-of-core streaming scan under cold-tier faults: a streamed
    scan->filter->GROUP BY folds the table's Parquet chunk segments while
    the ``coldfs.get`` seam is armed — first with a hard ``2*drop`` (the
    first two segment reads fail, proving the bounded-backoff retry
    path), then with a seeded ``P%drop`` + a second pass of pure latency
    (``delay``).  The retry policy is the streamed scan's: doubling backoff with full
    jitter, ``stream_retry_max`` attempts, counted in ``stream_retries``.

    Invariants: every armed run returns BIT-IDENTICAL rows to the
    unfaulted resident path, and every chunk folds exactly once per scan
    (``stream_chunks`` moves by exactly the chunk count — a retried read
    re-stages bytes, never re-folds a chunk).  The fold is single-scan
    deterministic data, so the digest (rows + fault plan) pins per seed
    across runs."""
    import shutil
    import tempfile

    from ..exec.session import Database, Session
    from ..utils import metrics
    from ..utils.flags import FLAGS, set_flag

    if writes is not None:              # chaos_run --writes compatibility
        rows = max(chunk_rows, int(writes))
    prev = {k: getattr(FLAGS, k) for k in
            ("chaos_seed", "streaming_scan", "streaming_min_rows",
             "streaming_chunk_rows", "stream_backoff_ms")}
    set_flag("chaos_seed", int(seed))
    set_flag("streaming_scan", True)
    set_flag("streaming_min_rows", 1)
    set_flag("streaming_chunk_rows", int(chunk_rows))
    set_flag("stream_backoff_ms", 0.5)      # keep retry sleeps cheap
    cold = tempfile.mkdtemp(prefix="stream_chaos_")
    schedule: list[list] = []
    problems: list[str] = []
    sql = ("SELECT g, COUNT(*) n, SUM(v) s, AVG(v) a FROM sc "
           "WHERE id >= 0 GROUP BY g ORDER BY g")
    try:
        s = Session(Database(device, cold_dir=cold))
        s.execute("CREATE TABLE sc (id BIGINT, g BIGINT, v DOUBLE, "
                  "PRIMARY KEY (id))")
        for lo in range(0, rows, 128):
            vals = ", ".join(f"({i}, {i % 5}, {float(i % 97)})"
                             for i in range(lo, min(lo + 128, rows)))
            s.execute(f"INSERT INTO sc VALUES {vals}")
        set_flag("streaming_scan", False)
        want = s.query(sql)             # unfaulted resident ground truth
        set_flag("streaming_scan", True)
        n_chunks = -(-rows // chunk_rows)

        def streamed_run(tag: str, spec: str | None):
            c0 = metrics.stream_chunks.value
            r0 = metrics.stream_retries.value
            if spec is not None:
                failpoint.set_failpoint("coldfs.get", spec)
            try:
                got = s.query(sql)
            finally:
                if spec is not None:
                    failpoint.clear("coldfs.get")
            folded = metrics.stream_chunks.value - c0
            retried = metrics.stream_retries.value - r0
            schedule.append([tag, spec, folded, retried])
            if got != want:
                problems.append(f"{tag}: streamed rows diverged from the "
                                f"resident path")
            if folded != n_chunks:
                problems.append(f"{tag}: {folded} chunk folds for "
                                f"{n_chunks} chunks — not exactly-once")
            return retried

        # pass 1 (unfaulted): builds + persists the chunk segments, and
        # pins the fault-free fold
        streamed_run("clean", None)
        # pass 2: hard drop — the first two segment reads FAIL, retries
        # must recover mid-streamed-scan
        retried = streamed_run("hard_drop", "2*drop")
        if retried < 2:
            problems.append(f"hard_drop: only {retried} retries for a "
                            f"2*drop (the failpoint never bit)")
        # pass 3: seeded probabilistic drops — the schedule is a pure
        # function of (chaos_seed, hit index)
        streamed_run("seeded_drop", f"{drop_pct}%drop")
        # pass 4: pure latency — staging slows, results must not change
        streamed_run("latency", f"delay({delay_ms})")
    finally:
        failpoint.clear("coldfs.get")
        for k, v in prev.items():
            set_flag(k, v)
        shutil.rmtree(cold, ignore_errors=True)
    return {"rows": rows, "chunks": n_chunks,
            "fault_schedule": schedule, "faults": len(schedule) - 1,
            "state_digest": _digest({"schedule": schedule,
                                     "rows": [sorted(r.items())
                                              for r in want]}),
            "problems": problems}


def fragment_chaos(seed: int = 8, rows: int = 240,
                   writes: int | None = None, drop_pct: int = 35,
                   queries: int = 5, device=None) -> dict:
    """Pushed-down fragment dispatch (exec/fragments.py) under daemon
    faults and a forced mid-query split, on the daemon plane (in-process
    meta + 3 store daemons over real TCP).

    Passes, each compared against the frontend-pulled ground truth
    (``pushdown_reads`` off — the bit-identity the off-switch guarantees):

    1. ``clean`` — pushed dispatch, no faults.
    2. ``exec_drop`` × ``queries`` — ``fragment.exec`` armed with a seeded
       ``P%drop``: a tripped daemon dies before reading any region row,
       the pushed attempt fails, and the query falls back to the pulled
       image path (``fragment_fallbacks``).  Results never change.
    3. ``split_retarget`` — ANOTHER frontend live-splits the region, so
       this frontend's routing is stale when its dispatch is in flight:
       the range-validated read raises StaleRoutingError, the dispatcher
       throws the whole attempt away, refreshes routing and re-slices
       over both children (``fragment_retargets``).
    4. ``dispatch_drop`` — ``fragment.dispatch`` armed ``1*drop`` (the
       attempt is abandoned frontend-side, the bounded retry loop lands
       the next one), then ``drop`` (every attempt dies → image fallback).

    The exactly-once contract is audited on every successful dispatch via
    the per-daemon ``scanned`` counts riding the payloads: their sum must
    equal the table's row count — a retarget or retry that double-folded
    a region (or dropped one) cannot sum to it.  Thread/socket timing is
    not replayable, but the outcome schedule (which passes fell back,
    how many partials) is a pure function of the seed, so the digest
    pins per seed."""
    from ..exec.fragments import recent_dispatches
    from ..exec.session import Database, Session
    from ..server.meta_server import MetaServer
    from ..server.store_server import StoreServer
    from ..utils import metrics
    from ..utils.flags import FLAGS, set_flag

    if writes is not None:              # chaos_run --writes compatibility
        rows = max(40, int(writes))
    prev = {k: getattr(FLAGS, k) for k in
            ("chaos_seed", "pushdown_reads", "fragment_pushdown",
             "fragment_retry_max")}
    set_flag("chaos_seed", int(seed))
    set_flag("fragment_pushdown", True)
    meta = MetaServer("127.0.0.1:0")
    meta.start()
    stores: list = []
    dbs: list = []                  # closed at the end: their poller and
    #                                 watchdog threads stop with the run
    schedule: list[list] = []
    problems: list[str] = []
    sql = ("SELECT g, COUNT(*) n, SUM(v) s, MIN(v) lo, MAX(v) hi "
           "FROM fc WHERE v >= 0 GROUP BY g ORDER BY g")
    ddl = ("CREATE TABLE fc (id BIGINT NOT NULL, g BIGINT, v BIGINT, "
           "PRIMARY KEY (id))")
    try:
        meta_addr = f"127.0.0.1:{meta.rpc.port}"
        for sid in (1, 2, 3):
            st = StoreServer(sid, "127.0.0.1:0", meta_addr,
                             tick_interval=0.02, seed=seed * 13 + sid)
            st.address = f"127.0.0.1:{st.rpc.port}"
            st.start()
            stores.append(st)
        writer = Session(Database(device, cluster=meta_addr))
        dbs.append(writer.db)
        writer.db.telemetry.stop()
        writer.execute(ddl)
        for lo in range(0, rows, 120):
            vals = ", ".join(f"({i}, {i % 7}, {(i * 37) % 101})"
                             for i in range(lo, min(lo + 120, rows)))
            writer.execute(f"INSERT INTO fc VALUES {vals}")
        set_flag("pushdown_reads", "off")
        want = writer.query(sql)        # frontend-pulled ground truth
        set_flag("pushdown_reads", "always")
        reader = Session(Database(device, cluster=meta_addr))
        dbs.append(reader.db)
        reader.db.telemetry.stop()
        reader.execute(ddl)

        def pushed_run(tag: str):
            f0 = metrics.fragment_fallbacks.value
            got = reader.query(sql)
            fell = metrics.fragment_fallbacks.value - f0
            ring = recent_dispatches()
            last = ring[-1] if ring else {}
            schedule.append([tag, last.get("status", "none"),
                             int(last.get("dispatched", 0)),
                             int(last.get("retargeted", 0)), int(fell)])
            if got != want:
                problems.append(f"{tag}: pushed rows diverged from the "
                                f"pulled ground truth")
            if last.get("status") == "ok" \
                    and int(last.get("scanned", 0)) != rows:
                problems.append(
                    f"{tag}: {last.get('scanned')} rows folded for {rows} "
                    f"live rows — partials not exactly-once")
            return last, fell

        # pass 1: clean pushed dispatch
        last, fell = pushed_run("clean")
        if fell or last.get("status") != "ok":
            problems.append("clean: pushed dispatch fell back unfaulted")
        # pass 2: seeded daemon-side execution drops -> image fallback
        failpoint.set_failpoint("fragment.exec", f"{drop_pct}%drop")
        try:
            for q in range(int(queries)):
                pushed_run(f"exec_drop{q}")
        finally:
            failpoint.clear("fragment.exec")
        # pass 3: live split by ANOTHER frontend mid-flight -> re-target
        writer.db.stores["default.fc"].replicated.split_region(0)
        last, fell = pushed_run("split_retarget")
        if not last.get("retargeted"):
            problems.append("split_retarget: dispatch never re-targeted "
                            "after the live split")
        if fell:
            problems.append("split_retarget: re-target fell back instead "
                            "of re-slicing")
        # pass 4: frontend-side dispatch drops — one abandoned attempt
        # (retry lands), then all attempts (image fallback)
        t0 = metrics.failpoint_trips.value
        failpoint.set_failpoint("fragment.dispatch", "1*drop")
        try:
            last, fell = pushed_run("dispatch_retry")
        finally:
            failpoint.clear("fragment.dispatch")
        if metrics.failpoint_trips.value - t0 < 1:
            problems.append("dispatch_retry: the failpoint never bit")
        if fell or last.get("status") != "ok":
            problems.append("dispatch_retry: bounded retry did not land "
                            "the second attempt")
        failpoint.set_failpoint("fragment.dispatch", "drop")
        try:
            last, fell = pushed_run("dispatch_exhaust")
        finally:
            failpoint.clear("fragment.dispatch")
        if not fell:
            problems.append("dispatch_exhaust: exhausted dispatch did "
                            "not fall back to the pulled path")
    finally:
        failpoint.clear("fragment.exec")
        failpoint.clear("fragment.dispatch")
        for k, v in prev.items():
            set_flag(k, v)
        for db in dbs:
            db.close()
        for st in stores:
            st.stop()
        meta.stop()
    return {"rows": rows, "fault_schedule": schedule,
            "faults": len(schedule) - 2,
            "state_digest": _digest({"schedule": schedule,
                                     "rows": [sorted(r.items())
                                              for r in want]}),
            "problems": problems,
            "retargets": sum(s[3] for s in schedule),
            "fallbacks": sum(s[4] for s in schedule)}


def snapshot_chaos(seed: int = 7, writes: int = 48, device=None) -> dict:
    """Hammer writes + a forced live split during a pinned-snapshot
    aggregate (the tentpole contract): a session pins an explicit MVCC
    snapshot, records a GROUP BY aggregate, and that aggregate must stay
    BIT-IDENTICAL while seeded insert/update/delete traffic rewrites the
    table, a live region split runs mid-query (checked at every split
    phase via the chaos hook), a ``tso.allocate`` grant is lost (burned
    range — monotonicity must survive the re-propose), one GC sweep is
    failpoint-wedged and the next must still respect the oldest pin, and
    a fresh session re-pinning the RECORDED ts reproduces the aggregate
    (quiesced replay).  Also: an explicit pin refusal (``snapshot.pin``)
    must surface to the client, the ``mvcc=0`` off-switch must read
    bit-identically to the unpinned read, and TSO timestamps must stay
    strictly monotonic across a meta raft leader kill.  Fleet plane:
    bit-identical replay (wall-clock timestamps excluded from the
    digest by design)."""
    from ..exec.session import Session
    from ..meta.replicated_meta import ReplicatedMeta
    from ..storage.mvcc import TsoClient
    from ..utils.flags import FLAGS, set_flag

    rng = random.Random((seed << 8) ^ 0x736E70)
    fleet, db, s = _fleet_session(seed, device=device)
    s.execute("CREATE TABLE sv (k BIGINT, g BIGINT, v BIGINT, "
              "PRIMARY KEY (k))")
    tier = fleet.row_tiers["chaos.sv"]
    schedule: list[list] = []
    problems: list[str] = []
    next_key = 0

    def put(n: int):
        nonlocal next_key
        for _ in range(n):
            k = next_key
            s.execute(f"INSERT INTO sv VALUES ({k}, {k % 4}, {k * k})")
            next_key += 1

    def hammer(n: int):
        nonlocal next_key
        for _ in range(n):
            r = rng.random()
            if r < 0.5 or next_key < 4:
                put(1)
            elif r < 0.8:
                k = rng.randrange(next_key)
                s.execute(f"UPDATE sv SET v = v + 7 WHERE k = {k}")
                schedule.append(["update", k])
            else:
                k = rng.randrange(next_key)
                s.execute(f"DELETE FROM sv WHERE k = {k}")
                schedule.append(["delete", k])

    put(writes // 2)
    AGG = "SELECT g, COUNT(*), SUM(v) FROM sv GROUP BY g ORDER BY g"
    s.execute("SET SNAPSHOT = 'now'")
    snap_ts = s._snapshot[1]
    base = s.query(AGG)
    schedule.append(["pin", next_key])

    def check(tag: str):
        if s.query(AGG) != base:
            problems.append(f"{tag}: pinned aggregate diverged under "
                            f"writes")
        schedule.append(["agg", tag])

    parent = tier.metas[0].region_id

    def hook(phase: str):
        schedule.append(["phase", phase])
        hammer(4)                   # writes flow during the live split
        check(f"mid_split_{phase}")  # ... while the pinned agg re-runs

    failpoint.set_failpoint("tso.allocate", "1*drop")
    failpoint.set_failpoint("mvcc.gc", "1*drop")
    try:
        try:
            child = tier.split_region_online(parent, chaos_hook=hook)
            schedule.append(["split_ok", parent, child.region_id])
        except Exception as e:      # noqa: BLE001 — report, don't die
            problems.append(f"live split under pinned snapshot failed: "
                            f"{type(e).__name__}: {e}")
        hammer(max(writes - next_key, 8))
        check("after_split")
        # GC respects the pin: the watermark must not pass it, the first
        # sweep is failpoint-wedged (skipped), the second really sweeps —
        # and the pinned aggregate must still reproduce afterwards
        if db.mvcc.snapshots.watermark(db.mvcc.tso.last_ts()) > snap_ts:
            problems.append("gc watermark passed the oldest pin")
        db.mvcc.gc(db.stores.values())      # wedged by mvcc.gc 1*drop
        reclaimed = db.mvcc.gc(db.stores.values())
        schedule.append(["gc", reclaimed >= 0])
        check("after_gc")
        # quiesced replay: a FRESH session pins the RECORDED ts and must
        # read the exact aggregate the original pin saw
        s2 = Session(db, "chaos")
        s2.execute(f"SET SNAPSHOT = {snap_ts}")
        replay_ok = s2.query(AGG) == base
        if not replay_ok:
            problems.append("quiesced replay at the recorded ts diverged")
        s2.execute("SET SNAPSHOT = 0")
        schedule.append(["replay", replay_ok])
    finally:
        failpoint.clear("tso.allocate")
        failpoint.clear("mvcc.gc")
    # off-switch: mvcc=0 must read bit-identically to the unpinned read
    s.execute("SET SNAPSHOT = 0")
    live = s.query(AGG)
    prev_mvcc = bool(FLAGS.mvcc)
    set_flag("mvcc", 0)
    try:
        if s.query(AGG) != live:
            problems.append("mvcc=0 off-switch diverged from the "
                            "unpinned read")
    finally:
        set_flag("mvcc", 1 if prev_mvcc else 0)
    # explicit pin refusal surfaces; the next attempt lands
    failpoint.set_failpoint("snapshot.pin", "1*drop")
    try:
        refused = False
        try:
            s.execute("SET SNAPSHOT = 'now'")
        except Exception:           # noqa: BLE001 — the refusal IS the test
            refused = True
        if not refused:
            problems.append("refused explicit pin did not surface")
        s.execute("SET SNAPSHOT = 'now'")
        s.execute("SET SNAPSHOT = 0")
        schedule.append(["pin_refused", refused])
    finally:
        failpoint.clear("snapshot.pin")
    # TSO strict monotonicity across a meta raft leader kill: enough
    # allocations after the kill to force batched-range refills through
    # the NEW leader (the save-ahead lease covers the failover)
    rm = ReplicatedMeta(seed=5 + seed)
    cli = TsoClient(rm.tso_gen)
    seq = [cli.next_ts() for _ in range(5)]
    rm.kill_leader()
    seq += [cli.next_ts() for _ in range(3 * int(FLAGS.tso_batch_size))]
    if any(b <= a for a, b in zip(seq, seq[1:])):
        problems.append("TSO regressed across meta leader failover")
    schedule.append(["tso_failover", len(seq)])
    rows = s.query("SELECT k, g, v FROM sv ORDER BY k")
    state = {"rows": rows, "pinned": base,
             "regions": len(tier.metas)}
    return {"writes": next_key, "fault_schedule": schedule,
            "faults": len(schedule),
            "regions": len(tier.metas),
            "state_digest": _digest({"schedule": schedule, "state": state}),
            "problems": problems}


def cdc_chaos(seed: int = 9, writes: int = 60, device=None) -> dict:
    """CDC change streams + matview maintenance under seeded faults (the
    tentpole contract): INSERT/UPDATE/DELETE traffic flows while
    ``cdc.fetch`` drops/delays defer delivery, ``cdc.apply`` drops lose
    acks (forced redelivery), ``view.fold`` drops abandon maintenance
    rounds, and one store daemon is killed and revived mid-stream.

    Invariants checked:

    - **exactly-once**: an audit subscription applies every event with a
      commit_ts dedupe; replaying the applied row images reconstructs the
      final table EXACTLY (no lost event, no double-apply) even though
      lost acks redelivered batches (``redeliveries`` > 0 is the witness
      that the fault actually fired and was absorbed);
    - **view exactness at quiesce**: at failpoint-cleared checkpoints the
      materialized-view answer is BIT-IDENTICAL to the recompute
      (``matview_answer=0``) over the same data;
    - fleet plane: the run digest is a pure function of the seed
      (wall-clock commit_ts excluded by design)."""
    from ..cdc.streams import CursorLagging
    from ..utils.flags import FLAGS, set_flag

    rng = random.Random((seed << 8) ^ 0x636463)
    prev_seed = int(FLAGS.chaos_seed)
    set_flag("chaos_seed", seed)
    fleet, db, s = _fleet_session(seed, device=device)
    s.execute("CREATE TABLE cv (k BIGINT, g BIGINT, v BIGINT, "
              "PRIMARY KEY (k))")
    s.execute("CREATE MATERIALIZED VIEW cv_mv AS SELECT g, COUNT(*), "
              "SUM(v), MIN(v), MAX(v) FROM cv GROUP BY g")
    audit = db.cdc.create("audit", table_key="chaos.cv")
    AGG = ("SELECT g, COUNT(*), SUM(v), MIN(v), MAX(v) FROM cv "
           "GROUP BY g ORDER BY g")
    schedule: list[list] = []
    problems: list[str] = []
    applied: dict[int, bool] = {}       # commit_ts -> seen (the dedupe)
    replica: dict[int, tuple] = {}      # k -> (g, v) rebuilt from events
    redeliveries = 0
    lost_ranges = 0
    next_key = 0

    def consume(drain: bool = False):
        """The audit consumer: apply-then-ack with commit_ts dedupe."""
        nonlocal redeliveries, lost_ranges
        for _ in range(64 if drain else 2):
            try:
                evs = audit.fetch(32)
            except CursorLagging:
                lost_ranges += 1        # typed loss surfaced, never silent
                continue
            if not evs:
                if drain:
                    continue
                return
            for e in evs:
                if e.commit_ts in applied:
                    redeliveries += 1   # lost ack redelivered: absorbed
                    continue
                applied[e.commit_ts] = True
                if not e.rows:
                    problems.append(f"{e.event_type} event without row "
                                    f"images (capture fell back)")
                    continue
                if e.event_type == "insert":
                    for r in e.rows:
                        replica[int(r["k"])] = (r["g"], r["v"])
                elif e.event_type == "update":
                    for pair in e.rows:
                        n = pair["new"]
                        replica[int(n["k"])] = (n["g"], n["v"])
                elif e.event_type == "delete":
                    for r in e.rows:
                        replica.pop(int(r["k"]), None)
            audit.ack(evs[-1].commit_ts)    # cdc.apply may drop this

    def checkpoint(tag: str):
        """Quiesced: faults off, maintenance drains, view == recompute."""
        for n in ("cdc.fetch", "cdc.apply", "view.fold"):
            failpoint.clear(n)
        view = s.query(AGG)
        set_flag("matview_answer", 0)
        try:
            base = s.query(AGG)
        finally:
            set_flag("matview_answer", 1)
        if view != base:
            problems.append(f"{tag}: view answer diverged from recompute")
        schedule.append(["checkpoint", tag, view == base])
        return view

    tier = fleet.row_tiers["chaos.cv"]
    g0 = tier.groups[0]
    failpoint.set_failpoint("cdc.fetch", "25%drop")
    failpoint.set_failpoint("cdc.apply", "25%drop")
    failpoint.set_failpoint("view.fold", "20%drop")
    killed = None
    try:
        for i in range(writes):
            r = rng.random()
            if r < 0.55 or next_key < 4:
                s.execute(f"INSERT INTO cv VALUES ({next_key}, "
                          f"{next_key % 3}, {next_key * next_key})")
                next_key += 1
            elif r < 0.8:
                k = rng.randrange(next_key)
                s.execute(f"UPDATE cv SET v = v + 11 WHERE k = {k}")
                schedule.append(["update", k])
            else:
                k = rng.randrange(next_key)
                s.execute(f"DELETE FROM cv WHERE k = {k}")
                schedule.append(["delete", k])
            consume()
            if i % 5 == 4:
                s.query(AGG)            # exercise fold under the faults
            if killed is None and i == writes // 3:
                killed = g0.leader()
                g0.bus.kill(killed)
                schedule.append([i, "kill_daemon", killed])
            if killed is not None and i == (2 * writes) // 3:
                g0.bus.revive(killed)
                schedule.append([i, "revive", killed])
                killed = None
            if i == writes // 2:
                # switch fetch faults from drops to seeded delays (slow
                # consumer phase), then the checkpoint re-arms drops
                checkpoint("mid_run")
                failpoint.set_failpoint("cdc.fetch", "30%delay(1)")
                failpoint.set_failpoint("cdc.apply", "25%drop")
                failpoint.set_failpoint("view.fold", "20%drop")
        if killed is not None:
            g0.bus.revive(killed)
            schedule.append([writes, "revive", killed])
    finally:
        for n in ("cdc.fetch", "cdc.apply", "view.fold"):
            failpoint.clear(n)
        set_flag("chaos_seed", prev_seed)
    view = checkpoint("quiesce")
    consume(drain=True)
    rows = s.query("SELECT k, g, v FROM cv ORDER BY k")
    got = {int(r["k"]): (r["g"], r["v"]) for r in rows}
    if got != replica:
        missing = sorted(set(got) - set(replica))
        extra = sorted(set(replica) - set(got))
        wrong = sorted(k for k in set(got) & set(replica)
                       if got[k] != replica[k])
        problems.append(f"audit replay diverged from the table (lost="
                        f"{missing[:5]} extra={extra[:5]} "
                        f"wrong={wrong[:5]})")
    if redeliveries == 0:
        problems.append("no redelivery observed: the cdc.apply fault "
                        "never fired (chaos did not exercise the seam)")
    mv = db.matviews.get("chaos", "cv_mv")
    state = {"rows": rows, "view": view,
             "groups": len(mv.state or {})}
    return {"writes": writes, "fault_schedule": schedule,
            "faults": len(schedule),
            "events_applied": len(applied),
            "redeliveries": redeliveries,
            "lost_ranges": lost_ranges,
            "deltas_folded": mv.deltas_folded,
            "view_rescans": mv.rescans,
            "state_digest": _digest({"schedule": schedule, "state": state}),
            "problems": problems}


SCENARIOS = {
    "kill_leader": kill_leader,
    "partition": partition,
    "rpc_chaos": rpc_chaos,
    "dispatch_overload": dispatch_overload,
    "split_chaos": split_chaos,
    "migrate_chaos": migrate_chaos,
    "stream_chaos": stream_chaos,
    "fragment_chaos": fragment_chaos,
    "snapshot_chaos": snapshot_chaos,
    "cdc_chaos": cdc_chaos,
}


def run_scenario(name: str, seed: int, device=None, **kw) -> dict:
    """Run one scenario on ``device`` (None: the CUDA card); assertion
    failures and crashes land in the result (``ok`` False +
    ``problems``/``error``), never as an unhandled raise — the harness must
    report a broken invariant, not die of it."""
    fn = SCENARIOS[name]
    try:
        out = fn(seed=seed, device=device, **kw)
    except Exception as e:          # noqa: BLE001 — the report IS the point
        out = {"fault_schedule": [], "problems": [],
               "error": f"{type(e).__name__}: {e}"}
    out["scenario"] = name
    out["seed"] = seed
    out["ok"] = not out.get("problems") and "error" not in out
    return out
