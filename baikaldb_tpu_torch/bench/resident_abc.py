"""Queries (a)-(c) of ``chip_smoke.py`` on one resident ``Session``: warm
wall p50 and p67 under each ``debug_guards`` mode asked for, with the trips
of the run.  To compare two commits on one card, run this file against
each checkout's package in turns (parent, change, change, parent), the
checkout first on ``PYTHONPATH``:

    PYTHONPATH=CHECKOUT python baikaldb_tpu_torch/bench/resident_abc.py
        [--rows N] [--seed S] [--reps R] [--modes off,disallow] [--tag NAME]

The table is ``chip_smoke.py``'s (``t (g INT, v FLOAT, w DOUBLE, g16
INT)``, ``--rows`` rows from ``--seed``, default 100M and 0), loaded with
``streaming_scan = 0``; each query runs once first, then ``--reps`` warm
runs (default 30) a mode, the modes in turns run by run.  The last line of
standard output is one JSON object with the card's name and power limit.
Needs a CUDA device.  A package without the analysis plane runs
``--modes off`` only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import pyarrow as pa
import torch

QUERIES = {
    "a": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
         "WHERE v*2+1 > 0.5 GROUP BY g16 ORDER BY g16",
    "b": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
         "WHERE v*2+1 > 0.5 GROUP BY g ORDER BY g",
    "c": "SELECT g, SUM(w), AVG(w) FROM t WHERE w > -1 GROUP BY g ORDER BY g",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--modes", default="off")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("resident_abc: no CUDA device", file=sys.stderr)
        return 1
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.utils.flags import set_flag

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    modes = [m for m in args.modes.split(",") if m]
    rng = np.random.default_rng(args.seed)
    n = args.rows
    table = pa.table({"g": rng.integers(0, 2048, n, dtype=np.int32),
                      "v": rng.standard_normal(n, dtype=np.float32),
                      "w": rng.standard_normal(n),
                      "g16": rng.integers(0, 16, n, dtype=np.int32)})
    s = Session(device="cuda")
    s.execute("SET GLOBAL streaming_scan = 0")
    s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
    s.load_arrow("t", table)
    del table
    trips = None
    if modes != ["off"]:
        from baikaldb_tpu_torch.analysis import runtime as rt

        def trips() -> int:
            return (rt.guard_transfer_trips.value + rt.guard_lock_trips.value
                    + rt.guard_owner_trips.value)
    out = {"card": card, "tag": args.tag, "rows": n, "reps": args.reps, "queries": {}}
    for q, sql in QUERIES.items():
        s.query(sql)
        walls = {m: [] for m in modes}
        t0 = trips() if trips else 0
        for _ in range(args.reps):
            for m in modes:
                if trips:
                    set_flag("debug_guards", m)
                torch.cuda.synchronize()
                t = time.perf_counter()
                s.query(sql)
                torch.cuda.synchronize()
                walls[m].append((time.perf_counter() - t) * 1e3)
        if trips:
            set_flag("debug_guards", "off")
        res = {}
        for m, w in walls.items():
            w.sort()
            res[m] = {"p50_ms": statistics.median(w), "p67_ms": w[(2 * len(w)) // 3]}
        res["trips"] = (trips() - t0) if trips else 0
        out["queries"][q] = res
        print(f"({q}) " + ", ".join(f"{m} p50 {r['p50_ms']:.3f} ms"
                                    for m, r in res.items() if m != "trips"),
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
