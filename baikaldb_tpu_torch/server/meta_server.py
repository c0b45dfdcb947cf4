"""baikalMeta-analog daemon: the meta service behind the TCP RPC plane.

Wraps ``meta.service.MetaService`` (topology, region registry, heartbeats,
TSO) the way src/meta_server/main.cpp:38 serves MetaService RPCs over brpc.
Region placement, health transitions and the balance loop are the in-process
service's — this daemon only adds the process boundary and the stable
store-id registry the raft transport needs.

The port of ``baikaldb_tpu/server/meta_server.py``, host-only.  The JAX
package's XLA-executable manifest (``aot_publish`` / ``aot_lookup`` /
``aot_manifest``) has no counterpart.

Run: python -m baikaldb_tpu_torch.server.meta_server --address 127.0.0.1:9100
"""

from __future__ import annotations

import argparse
import threading
import time

from ..meta.service import HeartbeatRequest, MetaService
from ..obs.telemetry import install_process_gauges
from ..obs.watchdog import Watchdog
from ..utils.metrics import Registry
from ..utils.net import RpcServer


class MetaServer:
    def __init__(self, address: str, peer_count: int = 3):
        self.address = address
        host, port = address.rsplit(":", 1)
        self.rpc = RpcServer(host, int(port))
        self.service = MetaService(peer_count=peer_count)
        self._store_ids: dict[str, int] = {}        # address -> store_id
        self._mu = threading.Lock()
        for name in ("register_store", "create_regions", "table_regions",
                     "drop_regions", "heartbeat", "tso", "instances", "ping",
                     "split_region_key", "merge_regions_key", "alloc_ids",
                     "metrics", "prometheus", "health"):
            self.rpc.register(name, getattr(self, "rpc_" + name))
        # daemon-scoped registry (see StoreServer): handler latency via the
        # RpcServer hook, topology gauges sampled live at scrape time
        self.metrics = Registry()
        self.rpc.attach_metrics(self.metrics)
        install_process_gauges(self.metrics)
        self.watchdog = Watchdog(name=f"meta@{address}")
        self._started = time.time()
        self.metrics.gauge("uptime_s", fn=lambda: time.time() - self._started)
        self.metrics.gauge("meta_instances",
                           fn=lambda: len(self.service.instances))
        self.metrics.gauge("meta_regions",
                           fn=lambda: len(self.service.regions))
        self.metrics.gauge(
            "meta_instances_faulty",
            fn=lambda: sum(1 for i in self.service.instances.values()
                           if i.status != "NORMAL"))
        self._c_heartbeats = self.metrics.counter("meta_heartbeats")
        self._c_orders = self.metrics.counter("meta_balance_orders")

    def start(self) -> None:
        self.rpc.start()

    def stop(self) -> None:
        self.rpc.stop()

    # -- RPC surface ------------------------------------------------------
    def rpc_ping(self):
        return {}

    def rpc_metrics(self):
        """Telemetry snapshot of the meta daemon (obs/telemetry scrape
        unit)."""
        return {"daemon": self.address, "role": "meta", "ts": time.time(),
                "metrics": self.metrics.snapshot()}

    def rpc_prometheus(self):
        from ..obs.telemetry import render_prometheus
        return {"text": render_prometheus(
            self.metrics.snapshot(),
            const_labels={"daemon": self.address, "role": "meta"})}

    def rpc_health(self):
        """Health probe: the meta daemon has no raft clock of its own, so
        this reports watchdog status (no probes registered = ok), uptime,
        and topology health counts."""
        h = self.watchdog.health()
        h.update(daemon=self.address, role="meta",
                 uptime_s=round(time.time() - self._started, 3),
                 instances=len(self.service.instances),
                 instances_faulty=sum(
                     1 for i in self.service.instances.values()
                     if i.status != "NORMAL"))
        return h

    def rpc_register_store(self, address: str, store_id: int):
        with self._mu:
            self._store_ids[address] = int(store_id)
            if address not in self.service.instances:
                self.service.add_instance(address)
        return {}

    def rpc_instances(self):
        with self._mu:
            return {a: {"store_id": sid,
                        "status": self.service.instances[a].status}
                    for a, sid in self._store_ids.items()
                    if a in self.service.instances}

    def _region_wire(self, r):
        with self._mu:
            return {"region_id": r.region_id, "table_id": r.table_id,
                    "leader": r.leader, "version": r.version,
                    "start_key": r.start_key, "end_key": r.end_key,
                    "peers": [[self._store_ids.get(p, 0), p]
                              for p in r.peers]}

    def rpc_create_regions(self, table_id: int, n_regions: int):
        metas = self.service.create_regions(int(table_id), int(n_regions))
        return [self._region_wire(r) for r in metas]

    def rpc_table_regions(self, table_id: int):
        with self._mu:
            regions = [r for r in self.service.regions.values()
                       if r.table_id == int(table_id)]
        return [self._region_wire(r) for r in sorted(regions,
                                                     key=lambda r: r.region_id)]

    def rpc_drop_regions(self, region_ids: list):
        self.service.drop_regions(region_ids)
        return {}

    def rpc_heartbeat(self, address: str, regions: dict, leader_ids: list):
        req = HeartbeatRequest(
            address,
            {int(rid): tuple(int(x) for x in stats)
             for rid, stats in regions.items()},
            [int(x) for x in leader_ids])
        resp = self.service.heartbeat(req)
        self._c_heartbeats.add(1)
        if resp.orders:
            self._c_orders.add(len(resp.orders))
        return {"orders": len(resp.orders)}

    def rpc_tso(self, count: int = 1):
        return {"ts": self.service.tso.gen(int(count))}

    def rpc_alloc_ids(self, table_id: int, n: int, floor: int = 0):
        return {"start": self.service.alloc_ids(int(table_id), int(n),
                                                int(floor))}

    def rpc_split_region_key(self, region_id: int, split_key_hex: str):
        """Key-range split finalize in the routing table: the child
        inherits the parent's peers, both sides bump version
        (region.cpp:4864 add_version)."""
        new = self.service.split_region_key(int(region_id), split_key_hex)
        return self._region_wire(new)

    def rpc_merge_regions_key(self, left_id: int, right_id: int):
        merged = self.service.merge_regions_key(int(left_id), int(right_id))
        return self._region_wire(merged)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--address", required=True)
    ap.add_argument("--peer-count", type=int, default=3)
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve Prometheus exposition over HTTP on this "
                         "port (0 = RPC-plane rpc_prometheus only)")
    args = ap.parse_args()
    srv = MetaServer(args.address, peer_count=args.peer_count)
    srv.address = f"{srv.rpc.host}:{srv.rpc.port}"   # port 0: the bound one
    srv.start()
    if args.metrics_port:
        from ..obs.telemetry import start_http_exporter
        start_http_exporter(lambda: srv.rpc_prometheus()["text"],
                            args.metrics_port)
    print(f"meta serving on {srv.rpc.host}:{srv.rpc.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
