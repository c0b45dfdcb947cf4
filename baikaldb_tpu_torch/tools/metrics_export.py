"""Fleet Prometheus exporter: scrape daemons over the RPC plane, serve the
merged exposition over HTTP.

The daemons speak the engine's length-prefixed-JSON RPC (utils/net.py), not
HTTP; this tool is the bridge a real Prometheus server scrapes.  Each
``--scrape`` address is polled for its ``metrics`` snapshot; the output is
one exposition with every daemon's samples labeled ``daemon=...`` plus the
merged rows under ``daemon="fleet"`` (counters summed, histograms summed
bucket-wise — obs/telemetry.py semantics).  A daemon that does not answer
is reported as ``up 0`` and its samples are simply absent; the exporter
never fails the scrape for one dead peer.

The port's copy of the repo's ``tools/metrics_export.py``, over the port's
``utils/net.py`` and ``obs/telemetry.py``; it imports no torch and scrapes
either package's daemons (their RPC and snapshot layout are the same).

Usage:
  python -m baikaldb_tpu_torch.tools.metrics_export \
      --scrape 127.0.0.1:9100,127.0.0.1:9101 --port 9464
                             # serve http://127.0.0.1:9464/metrics
  python -m baikaldb_tpu_torch.tools.metrics_export --scrape ... --once

Daemons can also serve their own process directly with ``--metrics-port``
(server/store_server.py, server/meta_server.py) — this tool adds the
fleet-merged view.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..obs.telemetry import (merge_snapshots, render_fleet_prometheus,
                             start_http_exporter)
from ..utils.net import RpcClient, RpcError


def scrape(addresses: list[str], timeout: float = 2.0) -> str:
    """One fleet scrape round -> Prometheus text."""
    snaps: dict[str, dict] = {}
    up: dict[str, dict] = {"kind": "gauge", "label_names": ["daemon"],
                           "rows": []}
    for addr in sorted(addresses):
        client = RpcClient(addr, timeout=timeout)
        try:
            resp = client.call("metrics")
            snap = resp.get("metrics") if isinstance(resp, dict) else None
            if not isinstance(snap, dict):
                raise RpcError("malformed metrics response")
            snaps[addr] = snap
            up["rows"].append({"labels": [addr], "value": 1.0})
        except (OSError, RpcError):
            up["rows"].append({"labels": [addr], "value": 0.0})
        finally:
            client.close()    # a 15 s-period scraper must not leave socket
            #   teardown to GC — one fresh connect per daemon per round
    out = dict(snaps)
    out["fleet"] = merge_snapshots(snaps)
    text = render_fleet_prometheus(out)
    return text + render_fleet_prometheus({"": {"up": up}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scrape", required=True,
                    help="comma-separated daemon host:port list")
    ap.add_argument("--port", type=int, default=9464,
                    help="HTTP port to serve /metrics on")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-daemon scrape deadline budget (s)")
    ap.add_argument("--once", action="store_true",
                    help="print one scrape to stdout and exit")
    args = ap.parse_args(argv)
    addresses = [a.strip() for a in args.scrape.split(",") if a.strip()]
    if args.once:
        sys.stdout.write(scrape(addresses, timeout=args.timeout))
        return 0
    srv = start_http_exporter(
        lambda: scrape(addresses, timeout=args.timeout),
        args.port, host=args.host)
    print(f"serving fleet metrics on http://{args.host}:"
          f"{srv.server_address[1]}/metrics", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
