"""`python -m baikaldb_tpu_torch.server` — the `baikaldb` frontend binary
analog (reference: src/protocol/main.cpp startup sequence).

    python -m baikaldb_tpu_torch.server --port N [--qos-rate R]
        [--meta host:port] [--data-dir D] [--device cpu]

The engine runs on the CUDA card unless ``--device`` names another device;
without a card and without ``--device cpu`` the server refuses to start.
"""

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="baikaldb_tpu_torch MySQL-protocol server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=28000,
                    help="TCP port (0 binds a free one; the log line names it)")
    ap.add_argument("--qos-rate", type=float, default=0.0,
                    help="global queries/sec admission limit (0 = off)")
    ap.add_argument("--meta", default="",
                    help="meta daemon host:port — DML replicates to the "
                         "store daemon cluster it places")
    ap.add_argument("--data-dir", default="",
                    help="durable single-node mode (WAL + Parquet)")
    ap.add_argument("--cold-dir", default="",
                    help="the cold tier's directory (shared with the daemons)")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..exec.session import Database
    from .mysql_server import MySQLServer

    qos = None
    if args.qos_rate > 0:
        from ..utils.qos import QosManager

        qos = QosManager(global_rate=args.qos_rate,
                         global_burst=2 * args.qos_rate,
                         sign_rate=args.qos_rate / 4,
                         sign_burst=args.qos_rate / 2)
    try:
        db = Database(args.device, data_dir=args.data_dir or None,
                      cluster=args.meta or None, cold_dir=args.cold_dir or None)
    except RuntimeError as e:           # no card and no --device
        print(f"baikaldb_tpu_torch.server: {e}", file=sys.stderr, flush=True)
        return 2
    srv = MySQLServer(db, host=args.host, port=args.port, qos=qos).start()
    print(f"baikaldb_tpu_torch listening on {args.host}:{srv.port} "
          f"(device {db.device})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
