"""Where a streamed scan's staging time goes on the card: time queries (b)
and (c) of ``chip_smoke.py`` streamed under three ways of staging chunks,
in turns, and time a pinned host->device copy with and without a busy
Python thread beside it.

    python -m baikaldb_tpu_torch.bench.stream_staging [--rows N] [--seed S]

Variants (the fold is the shipped one in all three):

- ``thread``: the shipped staging — a stager thread decodes chunks into the
  pinned ring while the folding thread folds (exec/streaming.py).
- ``switch0.2ms``: the same with the interpreter's switch interval at
  0.2 ms instead of 5 ms (``sys.setswitchinterval``).
- ``sync``: no stager thread; the folding thread decodes each chunk itself.

Each variant runs each query twice plus once traced (the ``stream`` event's
``stage_ms`` and ``prefetch_wait_ms``), in two rounds of opposite order;
the medians of the untraced walls are printed per (variant, query).  Then
``copy_`` of a 2 MiB pinned buffer to the card on a side stream, alone and
with a thread spinning in Python.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import torch

from ..exec import streaming
from ..exec.session import Database, Session
from ..obs import trace

QUERIES = {
    "b": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > 0.5 "
         "GROUP BY g ORDER BY g",
    "c": "SELECT g, SUM(w), AVG(w) FROM t WHERE w > -1 GROUP BY g ORDER BY g",
}


def _sync_staged(items, stage, name=""):
    for i in items:
        yield i, stage(i)


def _stream_event(s, sql: str) -> dict:
    s.execute("SET GLOBAL tracing = 1")
    try:
        s.query(sql)
    finally:
        s.execute("SET GLOBAL tracing = 0")
    rec = [t for t in trace.TRACER.list() if t["text"] == sql][-1]
    return next((sp["attrs"] for sp in rec["spans"] if sp["name"] == "stream"), {})


def _copies(src, stream, n: int) -> float:
    t = time.perf_counter()
    for _ in range(n):
        with torch.cuda.stream(stream):
            d = torch.empty(src.shape, dtype=torch.uint8, device="cuda")
            d.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=20_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_staging: no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), flush=True)
    rng = np.random.default_rng(args.seed)
    n = args.rows
    s = Session(Database(device="cuda"))
    s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
    s.load_arrow("t", pa.table({"g": rng.integers(0, 2048, n, dtype=np.int32),
                                "v": rng.standard_normal(n, dtype=np.float32),
                                "w": rng.standard_normal(n),
                                "g16": rng.integers(0, 16, n, dtype=np.int32)}))
    t0 = time.perf_counter()
    s.query(QUERIES["b"])
    torch.cuda.synchronize()
    print("first (b), the chunk-set build in it, s", time.perf_counter() - t0, flush=True)

    shipped = streaming.staged
    walls: dict = {}
    try:
        for order in (("thread", "switch0.2ms", "sync", "thread"),
                      ("thread", "sync", "switch0.2ms", "thread")):
            for name in order:
                streaming.staged = _sync_staged if name == "sync" else shipped
                sys.setswitchinterval(0.0002 if name == "switch0.2ms" else 0.005)
                for q, sql in QUERIES.items():
                    w = []
                    for _ in range(2):
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        s.query(sql)
                        torch.cuda.synchronize()
                        w.append((time.perf_counter() - t) * 1e3)
                    ev = _stream_event(s, sql)
                    walls.setdefault((name, q), []).extend(w)
                    print(name, q, [round(x) for x in w],
                          {k: ev.get(k) for k in ("stage_ms", "prefetch_wait_ms")}, flush=True)
    finally:
        streaming.staged = shipped
        sys.setswitchinterval(0.005)
    for k, v in sorted(walls.items()):
        print("median", k, round(statistics.median(v), 1))

    src = torch.zeros(1 << 21, dtype=torch.uint8, pin_memory=True)
    side = torch.cuda.Stream()
    print("copy_ alone ms", _copies(src, side, 300), flush=True)
    stop = threading.Event()

    def spin():
        x = 0
        while not stop.is_set():
            x += 1

    th = threading.Thread(target=spin)
    th.start()
    try:
        print("copy_ with a busy Python thread ms", _copies(src, side, 100), flush=True)
    finally:
        stop.set()
        th.join(timeout=10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
