"""baikalStore-analog daemon: one process hosting raft-replicated regions.

The reference's store binary (src/store/main.cpp:76) hosts many
Region : braft::StateMachine objects over brpc; here a StoreServer hosts
``raft.cluster.ReplicatedRegion`` replicas, exchanges raft messages with peer
stores over the TCP RPC plane (utils/net.py), drives elections/heartbeats
from a tick thread, and reports region state to the meta daemon
(store→meta heartbeats, SURVEY §3.5).

All raft-core access is serialized under one lock (the native core is a
single-threaded deterministic state machine by design); the tick loop is the
only place messages move, so delivery order stays deterministic per store.

The port of ``baikaldb_tpu/server/store_server.py``.  The daemon runs
host-only: pushed fragments fold row by row on this host
(plan/fragment.py), and nothing here touches a card
(tools/deploy_cluster.py spawns it with ``CUDA_VISIBLE_DEVICES`` empty).
The blob tier holds the fragment bodies (``frag_put`` / ``frag_fetch``,
durable under ``aot_dir``); the JAX package's XLA-executable blobs
(``aot_put`` / ``aot_fetch`` / ``aot_put_xla`` / ``aot_fetch_xla`` /
``aot_list``) have no counterpart.  The heartbeat and ``region_status``
count a region's rows with the engine's live-key counter where the JAX
daemon scans the region (the same number).

Run: python -m baikaldb_tpu_torch.server.store_server --store-id 1 \
         --address 127.0.0.1:9101 --meta 127.0.0.1:9100
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Optional

from ..chaos import failpoint
from ..raft.cluster import ReplicatedRegion
from ..raft.core import LEADER
from ..types import Field, LType, Schema
from ..obs.telemetry import install_process_gauges
from ..obs.watchdog import StoreWatchdog
from ..utils.metrics import Registry
from ..utils.net import RpcClient, RpcServer, handler_deadline_s


def schema_to_wire(schema: Schema) -> list:
    return [[f.name, f.ltype.value, f.nullable] for f in schema.fields]


def schema_from_wire(fields: list) -> Schema:
    return Schema(tuple(Field(n, LType(v), nullable)
                        for n, v, nullable in fields))


class StoreServer:
    def __init__(self, store_id: int, address: str, meta_address: str = "",
                 tick_interval: float = 0.05, seed: Optional[int] = None,
                 aot_dir: Optional[str] = None,
                 cold_dir: Optional[str] = None):
        self.store_id = store_id
        self.address = address
        host, port = address.rsplit(":", 1)
        self.rpc = RpcServer(host, int(port))
        self.meta = RpcClient(meta_address) if meta_address else None
        self.tick_interval = tick_interval
        self.seed = seed if seed is not None else store_id * 7 + 1
        self._mu = threading.Lock()          # guards every raft-core touch
        self.regions: dict[int, ReplicatedRegion] = {}
        self._peer_addr: dict[int, str] = {}           # store_id -> address
        self._peer_clients: dict[int, RpcClient] = {}
        self._stop = threading.Event()
        # fragment-body blobs this store holds for the fleet (frontends
        # publish them with frag_put; peers fetch).  ``aot_dir`` makes the
        # tier crash-durable through the cold-FS abstraction (a restarted
        # daemon re-serves the same bodies); without it the blobs are
        # in-memory only.  Namespaced: frag_<key>.
        self._aot_mu = threading.Lock()
        self._aot_blobs: dict[str, bytes] = {}
        self._aot_fs = None
        if aot_dir:
            from ..storage.coldfs import ExternalFS
            self._aot_fs = ExternalFS(aot_dir)
        # cold-tier FS handle: with it, pushed fragments fold a region's
        # evicted Parquet segments IN PLACE (the streamed-fold data, but
        # scanned next to the bytes); without it, a cold region makes
        # the daemon answer cold:True and the frontend falls back
        self._cold_fs = None
        if cold_dir:
            from ..storage.coldfs import ExternalFS
            self._cold_fs = ExternalFS(cold_dir)
        # compiled fragment programs keyed by the frag body's content hash
        # (plan/fragment.frag_key): the warm tier of the fragment artifact
        # ladder — in-mem program -> frag blob (disk via aot_dir) -> peer
        # fetch -> inline body from the frontend (counted as a compile)
        self._frag_mu = threading.Lock()
        self._frag_programs: dict[str, object] = {}
        for name in ("create_region", "drop_region", "raft_msg", "propose",
                     "scan_raw", "region_status", "region_size", "ping",
                     "txn_status", "cold_manifest", "exec_fragment",
                     "fragment_execute", "frag_put", "frag_fetch",
                     "metrics", "prometheus", "health"):
            self.rpc.register(name, getattr(self, "rpc_" + name))
        # the failpoint `panic` action crashes THIS daemon, not just the
        # serving thread (the chaos harness's kill-9 analog)
        self.rpc.on_panic = self.crash
        # daemon-SCOPED metrics registry (the telemetry plane's unit of
        # aggregation): several in-process StoreServers must never share
        # rows, so this is NOT utils.metrics.REGISTRY.  The frontend polls
        # it through rpc_metrics; raft/region gauges refresh per scrape.
        self.metrics = Registry()
        self.rpc.attach_metrics(self.metrics)
        install_process_gauges(self.metrics)
        self._started = time.time()
        # raft-clock liveness beat for the watchdog; None until the tick
        # thread runs (a never-started daemon is not "stalled")
        self._last_tick: Optional[float] = None
        self.watchdog = StoreWatchdog(self)
        self.metrics.gauge("uptime_s", fn=lambda: time.time() - self._started)
        self.metrics.gauge("regions_hosted", fn=lambda: len(self.regions))
        self._c_proposals = self.metrics.counter("raft_proposals")
        self._c_redirects = self.metrics.counter("raft_not_leader")
        # pushed-fragment execution plane (scraped into cluster_metrics):
        # fragments run here, programs warm-started from the frag blob
        # tier (disk) or a peer store, programs compiled from an inline
        # body because every warm source missed, and cold segments folded
        # in place instead of shipping to the frontend
        self._c_frag_execs = self.metrics.counter("fragment_execs")
        self._c_frag_warm_loads = self.metrics.counter("fragment_warm_loads")
        self._c_frag_peer_fetches = self.metrics.counter(
            "fragment_peer_fetches")
        self._c_frag_compiles = self.metrics.counter(
            "fragment_warm_compiles")
        self._c_frag_cold_segments = self.metrics.counter(
            "fragment_cold_segments")
        region_labels = ("region",)
        self._region_gauges = {
            # 1 when this replica leads the region (sum over the fleet per
            # region should be exactly 1 — a cheap split-brain dashboard)
            "raft_leader": self.metrics.gauge_family("raft_leader",
                                                     region_labels),
            "raft_term": self.metrics.gauge_family("raft_term",
                                                   region_labels),
            "raft_commit_index": self.metrics.gauge_family(
                "raft_commit_index", region_labels),
            "raft_applied_index": self.metrics.gauge_family(
                "raft_applied_index", region_labels),
            # commit-vs-applied lag: committed entries the apply loop has
            # not executed yet (a stuck tick loop shows here first)
            "raft_apply_lag": self.metrics.gauge_family(
                "raft_apply_lag", region_labels),
            # proposal queue depth: appended-but-uncommitted suffix on the
            # leader (quorum backpressure)
            "raft_proposal_queue": self.metrics.gauge_family(
                "raft_proposal_queue", region_labels),
            # rows = keys whose newest version is live (the visible row
            # count); keys_total additionally counts tombstoned keys — the
            # gap between the two is GC/compaction debt
            "region_rows": self.metrics.gauge_family("region_rows",
                                                     region_labels),
            "region_keys_total": self.metrics.gauge_family(
                "region_keys_total", region_labels),
            "region_cold_segments": self.metrics.gauge_family(
                "region_cold_segments", region_labels),
            "region_prepared_txns": self.metrics.gauge_family(
                "region_prepared_txns", region_labels),
        }

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self.rpc.start()
        threading.Thread(target=self._tick_loop, daemon=True).start()
        self.watchdog.start()
        if self.meta is not None:
            self.meta.try_call("register_store", address=self.address,
                               store_id=self.store_id)
            threading.Thread(target=self._heartbeat_loop, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
        self.watchdog.stop()
        self.rpc.stop()

    def crash(self) -> None:
        """Abrupt in-process death: stop the raft clock and HARD-stop the
        RPC server (live connections severed, so an in-flight handler can
        never ack after the crash) — what SIGKILL does to a daemon
        process.  In-memory region state stays with the object; a
        'restarted' daemon is a NEW StoreServer whose replicas catch up
        from peers."""
        self._stop.set()
        self.watchdog.stop()
        self.rpc.stop(hard=True)

    # -- RPC surface ------------------------------------------------------
    def rpc_ping(self):
        return {"store_id": self.store_id}

    # -- fragment blob store ----------------------------------------------
    # Dumb named-bytes storage, the cold-tier discipline (storage/coldfs):
    # this store only holds and returns bytes; the key is the body's
    # content hash (plan/fragment.frag_wire_key).
    def _aot_name(self, ns: str, key: str) -> str:
        return f"{ns}_{key}"

    def _aot_put(self, ns: str, key: str, data: bytes) -> None:
        with self._aot_mu:
            if self._aot_fs is not None:
                self._aot_fs.put(self._aot_name(ns, key), data)
            else:
                self._aot_blobs[self._aot_name(ns, key)] = bytes(data)

    def _aot_get(self, ns: str, key: str) -> Optional[bytes]:
        name = self._aot_name(ns, key)
        with self._aot_mu:
            if self._aot_fs is not None:
                try:
                    return self._aot_fs.get(name)
                except (OSError, FileNotFoundError):
                    return None
            return self._aot_blobs.get(name)

    def rpc_frag_put(self, key: str, data: bytes):
        """Publish a serialized fragment body under its content hash (the
        ``frag`` namespace of the artifact blob tier).  The frontend
        pre-publishes to every owning store before the first dispatch so a
        re-dispatched fragment never ships its body again — the daemon
        warm-starts from this blob (or a peer's)."""
        self._aot_put("frag", str(key), data)
        return {"stored": True}

    def rpc_frag_fetch(self, key: str):
        return {"data": self._aot_get("frag", str(key))}

    # -- telemetry plane --------------------------------------------------
    def _refresh_region_gauges(self) -> None:
        """Re-sample per-region raft/size gauges from live core state;
        called under ``self._mu`` (every read below touches the raft core
        or the replicated table)."""
        seen: set[str] = set()
        g = self._region_gauges
        for rid, region in self.regions.items():
            lab = str(rid)
            seen.add(lab)
            core = region.core
            commit = core.commit_index
            g["raft_leader"].labels(region=lab).set(
                1.0 if core.role == LEADER else 0.0)
            g["raft_term"].labels(region=lab).set(core.term)
            g["raft_commit_index"].labels(region=lab).set(commit)
            g["raft_applied_index"].labels(region=lab).set(
                region.applied_index)
            g["raft_apply_lag"].labels(region=lab).set(
                max(0, commit - region.applied_index))
            g["raft_proposal_queue"].labels(region=lab).set(
                max(0, core.last_index - commit))
            # num_live_keys/num_keys are O(1) in the C lib; a materializing
            # scan_raw() here would copy every key/value byte per scrape
            # while holding self._mu
            g["region_rows"].labels(region=lab).set(
                region.table.num_live_keys())
            g["region_keys_total"].labels(region=lab).set(
                region.table.num_keys())
            g["region_cold_segments"].labels(region=lab).set(
                len(region.cold_manifest))
            g["region_prepared_txns"].labels(region=lab).set(
                len(region.prepared))
        for fam in g.values():
            for key, _child in fam.rows():
                if key[0] not in seen:      # dropped/migrated region: the
                    fam.remove(region=key[0])   # row must not linger

    def rpc_metrics(self):
        """One telemetry snapshot of THIS daemon — the scrape unit the
        frontend's obs/telemetry poller merges into
        information_schema.cluster_metrics.  Gauges refresh under the core
        lock; serialization happens outside it."""
        with self._mu:
            self._refresh_region_gauges()
        return {"daemon": self.address, "role": "store",
                "store_id": self.store_id, "ts": time.time(),
                "metrics": self.metrics.snapshot()}

    def rpc_health(self):
        """Watchdog-backed health probe (idempotent, deadline-friendly):
        one synchronous stall scan over the raft clock and per-region
        apply lag, plus the daemon identity a fleet prober wants in the
        same answer."""
        h = self.watchdog.health()
        with self._mu:
            n_regions = len(self.regions)
        h.update(daemon=self.address, role="store", store_id=self.store_id,
                 uptime_s=round(time.time() - self._started, 3),
                 regions=n_regions)
        return h

    def rpc_prometheus(self):
        """Prometheus text exposition of this daemon's registry, served
        in-band on the RPC plane (``--metrics-port`` serves it over
        HTTP)."""
        from ..obs.telemetry import render_prometheus
        with self._mu:
            self._refresh_region_gauges()
        return {"text": render_prometheus(
            self.metrics.snapshot(),
            const_labels={"daemon": self.address, "role": "store"})}

    def rpc_create_region(self, region_id: int, peers: list, fields: list,
                          key_columns: list):
        """peers: [[store_id, address], ...] including this store."""
        with self._mu:
            for sid, addr in peers:
                sid = int(sid)
                self._peer_addr[sid] = addr
            if int(region_id) in self.regions:
                return {"created": False}
            region = ReplicatedRegion(
                self.store_id, [int(sid) for sid, _ in peers],
                seed=self.seed + int(region_id),
                schema=schema_from_wire(fields),
                key_columns=list(key_columns))
            self.regions[int(region_id)] = region
        return {"created": True}

    def rpc_drop_region(self, region_id: int):
        with self._mu:
            self.regions.pop(int(region_id), None)
        return {}

    def rpc_raft_msg(self, region_id: int, msg: bytes):
        with self._mu:
            region = self.regions.get(int(region_id))
            if region is not None:
                region.core.receive(msg)
        return {}

    def rpc_propose(self, region_id: int, payload: bytes,
                    wait_s: float = 5.0):
        """Leader-side propose + wait-for-commit (the braft apply + closure
        ack, store-side of region.cpp:1961/2301).  Non-leaders answer with a
        redirect hint (the reference's NOT_LEADER + leader_id response)."""
        from ..obs import trace

        with trace.span("raft.append", region=int(region_id)):
            return self._rpc_propose(region_id, payload, wait_s)

    def _rpc_propose(self, region_id: int, payload: bytes, wait_s: float):
        from ..raft.cluster import (CMD_PREPARE, CMD_WRITE, decode_cmd,
                                    decode_ops)

        region = self._region(region_id)
        if region is None:
            return {"status": "no_region"}
        if failpoint.ENABLED:
            if failpoint.hit("raft.leader_step", region=int(region_id)):
                # drop: pretend leadership just moved — the client's
                # leader-routing retry loop absorbs it
                return {"status": "not_leader", "leader": -1}
            if failpoint.hit("raft.append", region=int(region_id)):
                return {"status": "timeout"}    # drop: append never lands
        # never wait past the caller's propagated deadline budget: a reply
        # after the client gave up is work nobody reads
        budget = handler_deadline_s()
        if budget is not None:
            wait_s = min(float(wait_s), budget)
        self._c_proposals.add(1)
        with self._mu:
            if region.core.role != LEADER:
                self._c_redirects.add(1)
                return {"status": "not_leader",
                        "leader": int(region.core.leader)}
            # stale-routed writes (a frontend whose cached ranges predate a
            # split) are REJECTED here, not silently filtered at apply —
            # the reference's version_old response (region.cpp add_version
            # check); the frontend refreshes routing and re-sends.  Drain
            # applies first: a just-committed SET_RANGE must be visible to
            # this check (the ack races the tick-loop apply otherwise)
            region.apply_committed()
            if region.start_key or region.end_key:
                cmd, _, body = decode_cmd(payload)
                if cmd in (CMD_WRITE, CMD_PREPARE) and \
                        any(not region._covers(k)
                            for _, k, _ in decode_ops(body)):
                    return {"status": "version_old"}
            idx = region.core.propose(payload)
            if idx < 0:
                return {"status": "not_leader",
                        "leader": int(region.core.leader)}
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            with self._mu:
                if region.core.commit_index >= idx:
                    return {"status": "ok", "index": int(idx)}
                if region.core.role != LEADER:
                    return {"status": "lost_leadership"}
            time.sleep(self.tick_interval / 2)
        return {"status": "timeout"}

    def _read_gate(self, region):
        """None when this replica may serve a linearizable read, else the
        retryable routing response.  Beyond leadership, this is the Raft §8
        read barrier: a FRESH leader cannot have applied entries the old
        leader committed until its own election no-op commits — serving a
        read in that window would silently drop acknowledged writes (the
        clients' _leader_call retry loop absorbs the short wait)."""
        if region.core.role != LEADER or not region.core.read_safe:
            return {"status": "not_leader",
                    "leader": int(region.core.leader)}
        return None

    def rpc_scan_raw(self, region_id: int):
        region = self._region(region_id)
        if region is None:
            return {"status": "no_region"}
        with self._mu:
            gate = self._read_gate(region)
            if gate is not None:
                return gate
            # propose acks at COMMIT; the tick loop applies on its next
            # turn — drain here so a read right after a write sees it
            # (read-your-writes on the leader)
            region.apply_committed()
            pairs = region.table.scan_raw()
            start, end = region.start_key, region.end_key
        # the replica's COMMITTED range rides along so readers can filter
        # by OWNERSHIP (mid-split copies must never be read twice)
        return {"status": "ok", "pairs": [[k, v] for k, v in pairs],
                "start": start, "end": end}

    def rpc_exec_fragment(self, region_id: int, frag: dict,
                          route_start: bytes = b"", route_end: bytes = b""):
        """Execute a pushed-down plan fragment against this region and
        return only qualifying rows / partial aggregates — the reference's
        store-side select execution (region.cpp:2671 over the pb::Plan of
        store.interface.proto:418), replacing full-region raw pulls for
        eligible reads.

        ``route_start``/``route_end`` is the FRONTEND's routed range; rows
        are filtered to its intersection with this replica's committed
        range (the same double filter the raw-scan path applies) so
        mid-split copies are never double-served.  The committed range
        rides back for the caller's staleness check.  A fragment the
        row evaluator cannot run raises — the RPC layer returns the error
        and the frontend falls back to the raw path."""
        from ..obs import trace
        from ..plan.fragment import run_fragment

        region = self._region(region_id)
        if region is None:
            return {"status": "no_region"}
        with self._mu, trace.span("store.fragment",
                                  region=int(region_id)):
            gate = self._read_gate(region)
            if gate is not None:
                return gate
            region.apply_committed()
            pairs = region.table.scan_raw()
            start, end = region.start_key, region.end_key
            cold = bool(region.cold_manifest)
        if cold:
            # cold segments live on the external FS the frontend reads;
            # this store cannot see those rows — the fragment result would
            # silently miss them
            return {"status": "ok", "cold": True, "start": start,
                    "end": end}
        s = max(route_start or b"", start or b"")
        if not route_end:
            e = end
        elif not end:
            e = route_end
        else:
            e = min(route_end, end)
        codec = region.table.row_codec

        def rows():
            for k, v in pairs:
                if (s and k < s) or (e and k >= e):
                    continue
                row = codec.decode(v)
                if row.get("__del"):
                    continue
                yield row

        payload = run_fragment(rows(), frag)     # heavy work off the lock
        payload.update(status="ok", cold=False, start=start, end=end)
        return payload

    # -- pushed-down fragment execution (exec/fragments.py dispatcher) -----
    def _frag_program(self, frag_key: str, frag, peers):
        """Resolve a compiled FragmentProgram for ``frag_key`` down the
        warm ladder: in-memory cache -> frag blob tier (disk when aot_dir
        is set) -> peer store fetch -> the inline body (counted as a
        warm-compile miss).  Returns ``(program, error_response)`` — with
        no inline body and every warm source missed, the error asks the
        frontend to re-publish (``need_frag``)."""
        import json as _json

        from ..plan.fragment import compile_fragment, frag_canonical

        with self._frag_mu:
            prog = self._frag_programs.get(frag_key)
        if prog is not None:
            return prog, None
        data = self._aot_get("frag", frag_key)
        if data is not None:
            prog = compile_fragment(_json.loads(bytes(data).decode()))
            self._c_frag_warm_loads.add(1)
        else:
            for _sid, addr in list(peers or ()):
                if addr == self.address:
                    continue
                resp = RpcClient(addr, timeout=2.0).try_call(
                    "frag_fetch", key=frag_key)
                blob = resp.get("data") if resp else None
                if blob:
                    blob = bytes(blob)
                    prog = compile_fragment(_json.loads(blob.decode()))
                    self._aot_put("frag", frag_key, blob)
                    self._c_frag_peer_fetches.add(1)
                    break
        if prog is None:
            if frag is None:
                return None, {"status": "need_frag"}
            prog = compile_fragment(frag)
            self._aot_put("frag", frag_key, frag_canonical(frag))
            self._c_frag_compiles.add(1)
        with self._frag_mu:
            self._frag_programs[frag_key] = prog
        return prog, None

    def rpc_fragment_execute(self, region_id: int, frag_key: str,
                             frag: Optional[dict] = None, peers: list = (),
                             route_start: bytes = b"",
                             route_end: bytes = b""):
        """Execute a pushed-down fragment IN PLACE over this region — hot
        tier AND (with ``cold_dir``) its evicted cold segments — and return
        only the partial result.  The N-daemon analog of
        ``rpc_exec_fragment``: the body travels by content hash
        (``frag_key``) and warm-starts from the frag blob tier, so a
        re-dispatched fragment ships no plan bytes and compiles nothing.

        Rows are filtered to the intersection of the frontend's routed
        range and this replica's committed range, and cold rows are
        re-keyed + range-checked per row (split children share segment
        files) — two daemons folding sibling regions each take exactly
        their slice, which is what makes the merged partials exactly-once.
        ``scanned``/``raw_bytes``/``cold_bytes`` ride back for the
        frontend's bytes-saved accounting and the chaos scenario's
        exactly-once audit."""
        from ..obs import trace
        from ..storage.replicated import region_fragment_rows

        region = self._region(region_id)
        if region is None:
            return {"status": "no_region"}
        if failpoint.ENABLED:
            if failpoint.hit("fragment.exec", region=int(region_id),
                             store=self.store_id):
                # drop: the handler dies before any region row is read —
                # the frontend rotates peers / re-dispatches, and since
                # only RETURNED payloads are merged, partials stay
                # exactly-once
                raise RuntimeError(
                    f"failpoint fragment.exec (region {int(region_id)})")
        with self._mu:
            gate = self._read_gate(region)
            if gate is not None:
                return gate
            region.apply_committed()
            pairs = region.table.scan_raw()
            start, end = region.start_key, region.end_key
            manifest = list(region.cold_manifest)
            row_codec = region.table.row_codec
            key_codec = region.table.key_codec
        prog, err = self._frag_program(str(frag_key), frag, peers)
        if err is not None:
            # answered by the LEADER with its committed range: the
            # frontend's read loop adopts this daemon as the hint, so the
            # inline-body retry lands here without another rotation
            err.update(status="ok", need_frag=True, start=start, end=end)
            return err
        if manifest and self._cold_fs is None:
            # evicted rows live on an FS this daemon cannot reach:
            # answering from the hot tier alone would silently drop them
            return {"status": "ok", "cold": True, "start": start,
                    "end": end}
        s = max(route_start or b"", start or b"")
        if not route_end:
            e = end
        elif not end:
            e = route_end
        else:
            e = min(route_end, end)
        stats: dict = {}
        scanned = [0]

        def rows():
            for row in region_fragment_rows(pairs, manifest, self._cold_fs,
                                            row_codec, key_codec, s or b"",
                                            e, stats):
                scanned[0] += 1
                yield row

        with trace.span("fragment.exec", region=int(region_id),
                        store=self.store_id):
            payload = prog.run(rows())       # heavy work off the lock
        self._c_frag_execs.add(1)
        if stats.get("cold_segments"):
            self._c_frag_cold_segments.add(int(stats["cold_segments"]))
        payload.update(status="ok", cold=bool(manifest), start=start,
                       end=end, store_id=self.store_id,
                       scanned=int(scanned[0]),
                       raw_bytes=int(stats.get("raw_bytes", 0)),
                       cold_bytes=int(stats.get("cold_bytes", 0)))
        return payload

    def rpc_txn_status(self, region_id: int):
        """Prepared (in-doubt) txns + decision records of one region — the
        reference's in-doubt recovery query (region.cpp:684
        exec_txn_query_primary_region)."""
        region = self._region(region_id)
        if region is None:
            return {"status": "no_region"}
        with self._mu:
            gate = self._read_gate(region)
            if gate is not None:
                return gate
            region.apply_committed()
            now = time.time()
            return {"status": "ok",
                    "prepared": sorted(region.prepared),
                    "prepared_age": {str(t): now - region.prepared_at.get(t,
                                                                          now)
                                     for t in region.prepared},
                    "decisions": {str(t): int(d)
                                  for t, d in region.decisions.items()}}

    def rpc_cold_manifest(self, region_id: int):
        """This region's raft-committed cold-tier manifest (segment files
        live on the external FS; the manifest is the consensus truth —
        region_olap.cpp:727-882)."""
        region = self._region(region_id)
        if region is None:
            return {"status": "no_region"}
        with self._mu:
            gate = self._read_gate(region)
            if gate is not None:
                return gate
            region.apply_committed()
            return {"status": "ok",
                    "entries": [[int(s), f, int(w)]
                                for s, f, w in region.cold_manifest]}

    def rpc_region_size(self, region_id: int):
        """Live-key count + committed range of this region (the split
        trigger's size signal; leaders only so the count is current)."""
        region = self._region(region_id)
        if region is None:
            return {"status": "no_region"}
        with self._mu:
            gate = self._read_gate(region)
            if gate is not None:
                return gate
            region.apply_committed()
            return {"status": "ok",
                    "live": int(region.table.num_live_keys()),
                    "start": region.start_key, "end": region.end_key}

    def rpc_region_status(self):
        with self._mu:
            return {str(rid): {"role": r.core.role,
                               "term": r.core.term,
                               "commit": r.core.commit_index,
                               "rows": r.table.num_live_keys()}
                    for rid, r in self.regions.items()}

    # -- background loops -------------------------------------------------
    def _tick_loop(self) -> None:
        # the tick thread IS the raft clock: if it dies, elections stop and
        # every region on this store freezes — so any per-iteration failure
        # is logged and survived, never fatal (the reference store's
        # SIGSEGV-handler-keeps-serving discipline, src/store/main.cpp:50)
        while not self._stop.is_set():
            try:
                self._tick_once()
            except Exception as e:  # noqa: BLE001
                print(f"store {self.store_id}: tick error "
                      f"{type(e).__name__}: {e}", flush=True)
            # liveness beat AFTER the tick: a tick wedged inside
            # _tick_once stops the beat, which is what the watchdog's
            # raft-clock probe fires on
            self._last_tick = time.monotonic()
            time.sleep(self.tick_interval)

    def _tick_once(self) -> None:
        outbound: list[tuple[int, int, bytes]] = []
        with self._mu:
            for rid, region in list(self.regions.items()):
                region.core.tick()
                for dest, msg in region.core.drain_messages():
                    outbound.append((rid, dest, msg))
                region.apply_committed()
        for rid, dest, msg in outbound:
            client = self._client_of(dest)
            if client is not None:
                client.try_call("raft_msg", region_id=rid, msg=msg)

    def _region(self, region_id: int):
        """Region lookup under the core lock — rpc_create_region /
        rpc_drop_region mutate the map from other serve threads, and a
        dict read racing a resize is exactly the torn lookup GUARDEDBY
        exists for.  Handlers re-take _mu for the region's state."""
        with self._mu:
            return self.regions.get(int(region_id))

    def _client_of(self, store_id: int) -> Optional[RpcClient]:
        if store_id == self.store_id:
            return None
        with self._mu:
            c = self._peer_clients.get(store_id)
            if c is None:
                addr = self._peer_addr.get(store_id)
                if addr is None:
                    return None
                c = self._peer_clients[store_id] = RpcClient(addr,
                                                             timeout=2.0)
            return c

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            with self._mu:
                regions = {}
                leaders = []
                for rid, r in self.regions.items():
                    commit = r.core.commit_index
                    # the live-key count is O(1) in the engine: a scan
                    # here copied every region's bytes each second under
                    # the core lock, stalling the raft clock at 1M rows
                    regions[str(rid)] = [
                        1, r.table.num_live_keys(),
                        max(0, commit - r.applied_index),
                        max(0, r.core.last_index - commit),
                    ]
                    if r.core.role == LEADER:
                        leaders.append(rid)
            self.meta.try_call("heartbeat", address=self.address,
                               regions=regions, leader_ids=leaders)
            time.sleep(1.0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store-id", type=int, required=True)
    ap.add_argument("--address", required=True)
    ap.add_argument("--meta", default="")
    ap.add_argument("--tick", type=float, default=0.05)
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve Prometheus exposition over HTTP on this "
                         "port (0 = RPC-plane rpc_prometheus only)")
    ap.add_argument("--aot-dir", default="",
                    help="directory for hosted fragment bodies "
                         "(empty = in-memory only; set it to survive "
                         "daemon restarts)")
    ap.add_argument("--cold-dir", default="",
                    help="cold-tier segment directory (the frontend's "
                         "cold_fs_dir); set it so pushed fragments fold "
                         "evicted segments in place instead of falling "
                         "back to the frontend")
    args = ap.parse_args()
    srv = StoreServer(args.store_id, args.address, args.meta,
                      tick_interval=args.tick,
                      aot_dir=args.aot_dir or None,
                      cold_dir=args.cold_dir or None)
    # port 0 binds a free port: register and report the bound one
    srv.address = f"{srv.rpc.host}:{srv.rpc.port}"
    srv.start()
    if args.metrics_port:
        from ..obs.telemetry import start_http_exporter
        start_http_exporter(lambda: srv.rpc_prometheus()["text"],
                            args.metrics_port)
    print(f"store {args.store_id} serving on {srv.rpc.host}:{srv.rpc.port}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
