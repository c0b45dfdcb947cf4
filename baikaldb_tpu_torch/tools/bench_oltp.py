"""sysbench-analog OLTP harness (the port of
``baikaldb_tpu/tools/bench_oltp.py``).

The reference publishes one OLTP number: 92,287 QPS point-select (avg 2.77 ms,
p95 6.21 ms) from the patched sysbench lua suite over a 1-meta + 3-store +
N-frontend deploy (sysbench/sysbench.md:29-56,
sysbench/lua/oltp_common_baikaldb.lua).  This harness runs the same
workload shapes against the port so the two can sit side by side:

- ``point_select`` — ``SELECT c FROM sbtest1 WHERE id = ?`` with uniformly
  random ids (the OLTP fast path: host-tier point lookup)
- ``insert``       — single-row autocommit INSERTs with fresh ids
- ``update``       — ``UPDATE sbtest1 SET k = k + 1 WHERE id = ?`` (the
  write path through the columnar merge + row tier)

Modes:
- wire (default): the port's MySQLServer on a loopback socket, N client
  threads of the port's client speaking the binary protocol with prepared
  statements — the sysbench topology, protocol cost included.
- ``--inproc``: N threads calling Session.execute directly — engine cost
  only (what the wire tax subtracts from).
- ``--meta ADDR --ports P1,P2``: point_select over N real frontend
  processes (``spawn_cluster(mysql_port=...)``), one client process each.

The engine runs on the CUDA card unless ``--device`` names another.
Prints ONE JSON line: qps, latency avg/p95/p99 (ms), thread count, mode.
A package tool, not the port's benchmark: it reads no BENCHMARK.json.
"""

from __future__ import annotations

import argparse
import json
import random
import string
import threading
import time

import pyarrow as pa

TABLE = "sbtest1"


def _pad(rng: random.Random, n: int) -> str:
    return "".join(rng.choices(string.ascii_lowercase, k=n))


def load(session, rows: int, seed: int = 7, create: bool = True) -> None:
    """sysbench prepare: id PK, secondary-ish k, payload c/pad columns."""
    rng = random.Random(seed)
    if create:
        session.execute(
            f"CREATE TABLE {TABLE} (id BIGINT, k BIGINT, c VARCHAR(120), "
            f"pad VARCHAR(60), PRIMARY KEY (id))")
    session.load_arrow(TABLE, pa.table({
        "id": list(range(1, rows + 1)),
        "k": [rng.randrange(1, rows + 1) for _ in range(rows)],
        "c": [_pad(rng, 32) for _ in range(rows)],
        "pad": [_pad(rng, 16) for _ in range(rows)],
    }))


def _percentile(sorted_ms: list[float], p: float) -> float:
    if not sorted_ms:
        return 0.0
    i = min(len(sorted_ms) - 1, int(p * len(sorted_ms)))
    return sorted_ms[i]


class _Worker(threading.Thread):
    def __init__(self, op, deadline: float):
        super().__init__(daemon=True)
        self.op = op
        self.deadline = deadline
        self.lat_ms: list[float] = []
        self.errors = 0

    def run(self):
        while time.perf_counter() < self.deadline:
            t0 = time.perf_counter()
            try:
                self.op()
            except Exception:
                self.errors += 1
                continue
            self.lat_ms.append((time.perf_counter() - t0) * 1e3)


def _run_threads(make_op, threads: int, seconds: float):
    # build every op FIRST (connections, prepares, table attach): setup
    # cost must not eat the measured window
    ops = [make_op(i) for i in range(threads)]
    deadline = time.perf_counter() + seconds
    ws = [_Worker(op, deadline) for op in ops]
    t0 = time.perf_counter()
    for w in ws:
        w.start()
    for w in ws:
        w.join()
    wall = time.perf_counter() - t0
    lats = sorted(x for w in ws for x in w.lat_ms)
    n = len(lats)
    return {
        "queries": n,
        "errors": sum(w.errors for w in ws),
        "qps": round(n / wall, 1),
        "avg_ms": round(sum(lats) / n, 3) if n else 0.0,
        "p95_ms": round(_percentile(lats, 0.95), 3),
        "p99_ms": round(_percentile(lats, 0.99), 3),
        "max_ms": round(lats[-1], 3) if n else 0.0,
    }


def bench(mode: str = "point_select", threads: int = 8, seconds: float = 5.0,
          rows: int = 100_000, wire: bool = True, device=None) -> dict:
    from ..exec.session import Database, Session

    db = Database(device)
    setup = Session(db)
    load(setup, rows)
    # ids already taken; insert workload allocates above them, sharded by
    # worker so two threads never collide on a key
    next_id = [rows + 1 + i * 10_000_000 for i in range(threads)]

    if wire:
        from ..client.mysql_client import Connection
        from ..server.mysql_server import MySQLServer

        srv = MySQLServer(db, port=0)
        srv.start()

        def make_op(i: int):
            rng = random.Random(100 + i)
            conn = Connection("127.0.0.1", srv.port)
            if mode == "point_select":
                sid = conn.prepare(f"SELECT c FROM {TABLE} WHERE id = ?")
                return lambda: conn.execute(sid,
                                            (rng.randrange(1, rows + 1),))
            if mode == "insert":
                sid = conn.prepare(
                    f"INSERT INTO {TABLE} VALUES (?, ?, ?, ?)")

                def op():
                    next_id[i] += 1
                    conn.execute(sid, (next_id[i], rng.randrange(1, rows),
                                       "cccc", "pppp"))
                return op
            if mode == "update":
                sid = conn.prepare(
                    f"UPDATE {TABLE} SET k = k + 1 WHERE id = ?")
                return lambda: conn.execute(sid,
                                            (rng.randrange(1, rows + 1),))
            raise ValueError(f"unknown mode {mode!r}")

        try:
            out = _run_threads(make_op, threads, seconds)
        finally:
            srv.stop()
    else:
        def make_op(i: int):
            rng = random.Random(100 + i)
            s = Session(db)
            if mode == "point_select":
                return lambda: s.execute(
                    f"SELECT c FROM {TABLE} WHERE id = "
                    f"{rng.randrange(1, rows + 1)}")
            if mode == "insert":
                def op():
                    next_id[i] += 1
                    s.execute(f"INSERT INTO {TABLE} VALUES ({next_id[i]}, "
                              f"{rng.randrange(1, rows)}, 'cccc', 'pppp')")
                return op
            if mode == "update":
                return lambda: s.execute(
                    f"UPDATE {TABLE} SET k = k + 1 WHERE id = "
                    f"{rng.randrange(1, rows + 1)}")
            raise ValueError(f"unknown mode {mode!r}")

        out = _run_threads(make_op, threads, seconds)

    out.update({"mode": mode, "threads": threads, "rows": rows,
                "transport": "wire" if wire else "inproc",
                "device": str(db.device),
                "ref_qps_point_select": 92287.54})
    db.close()
    return out


_DDL = (f"CREATE TABLE IF NOT EXISTS {TABLE} (id BIGINT, k BIGINT, "
        f"c VARCHAR(120), pad VARCHAR(60), PRIMARY KEY (id))")


def _client_proc_main(port: int, threads: int, seconds: float, rows: int):
    """One CLIENT PROCESS hammering one frontend (sysbench is a native
    multi-process client; a single CPython client would bottleneck on its
    own GIL before the servers did)."""
    from ..client.mysql_client import Connection

    def make_op(i: int):
        # port*1000 spacing keeps seeds collision-free across processes
        # for any per-process thread count below 1000
        rng = random.Random(1000 + port * 1000 + i)
        conn = Connection("127.0.0.1", port)
        conn.query(_DDL)       # attach the table in that frontend process
        sid = conn.prepare(f"SELECT c FROM {TABLE} WHERE id = ?")
        return lambda: conn.execute(sid, (rng.randrange(1, rows + 1),))

    out = _run_threads(make_op, threads, seconds)
    print(json.dumps(out), flush=True)


def bench_cluster(threads: int, seconds: float, rows: int,
                  meta_addr: str, ports: list[int], device=None) -> dict:
    """point_select over N REAL frontend processes (the reference's
    N-baikaldb deploy), one client PROCESS per frontend.  Reads only —
    the remote tier is single-writer (rowid allocation; see
    RemoteRowTier)."""
    import subprocess
    import sys as _sys

    from ..exec.session import Database, Session
    from .deploy_cluster import _ENV, _repo_root

    loader = Session(Database(device, cluster=meta_addr))
    loader.execute(_DDL)
    tier = loader.db.cluster.tiers[f"default.{TABLE}"]
    existing = sum(1 for r in tier.scan_rows() if not r.get("__del"))
    if existing == 0:
        load(loader, rows, create=False)
    elif existing != rows:
        raise ValueError(
            f"cluster already holds {existing} sbtest rows (wanted {rows}):"
            f" restart the cluster or pass --rows {existing}")
    # pre-attach the table on every frontend OUTSIDE the timed window
    # (the first CREATE rebuilds that process's columnar cache)
    from ..client.mysql_client import Connection
    for p in ports:
        c = Connection("127.0.0.1", p)
        c.query(_DDL)
        c.close()
    per = max(1, threads // len(ports))
    procs = [subprocess.Popen(
        [_sys.executable, "-c",
         "from baikaldb_tpu_torch.tools.bench_oltp import _client_proc_main; "
         f"_client_proc_main({p}, {per}, {seconds}, {rows})"],
        stdout=subprocess.PIPE, text=True, env=_ENV,
        cwd=_repo_root()) for p in ports]
    parts = [json.loads(pr.communicate(timeout=seconds + 120)[0])
             for pr in procs]
    lat_w = sum(p["queries"] for p in parts) or 1
    out = {
        "queries": sum(p["queries"] for p in parts),
        "errors": sum(p["errors"] for p in parts),
        "qps": round(sum(p["qps"] for p in parts), 1),
        "avg_ms": round(sum(p["avg_ms"] * p["queries"]
                            for p in parts) / lat_w, 3),
        # tail latencies are the max over client processes: UPPER BOUNDS
        # on the combined percentiles, not exact merges
        "p95_ms": max(p["p95_ms"] for p in parts),
        "p99_ms": max(p["p99_ms"] for p in parts),
        "max_ms": max(p["max_ms"] for p in parts),
        "mode": "point_select", "threads": per * len(ports), "rows": rows,
        "transport": f"wire x{len(ports)} frontends x{len(ports)} clients",
        "ref_qps_point_select": 92287.54,
    }
    loader.db.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="point_select",
                    choices=["point_select", "insert", "update"])
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--inproc", action="store_true",
                    help="skip the wire protocol; measure the engine only")
    ap.add_argument("--meta", default="",
                    help="cluster mode: meta daemon address")
    ap.add_argument("--ports", default="",
                    help="cluster mode: comma-separated frontend ports")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.meta and args.ports:
        if args.mode != "point_select" or args.inproc:
            ap.error("cluster mode (--meta/--ports) supports point_select "
                     "over the wire only (the remote tier is single-writer)")
        out = bench_cluster(args.threads, args.seconds, args.rows,
                            args.meta,
                            [int(p) for p in args.ports.split(",")],
                            device=args.device)
    else:
        out = bench(args.mode, args.threads, args.seconds, args.rows,
                    wire=not args.inproc, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
