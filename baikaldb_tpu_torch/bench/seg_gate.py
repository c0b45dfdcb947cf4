"""The dense GROUP BY's gates on the card: where the segment kernel, K1-K3
and the scatter each win, by segment count.

    python -m baikaldb_tpu_torch.bench.seg_gate [--rows N] [--seed S]
        [--segments 1,16,...] [--gates 16,512,4096] [--out FILE]

At ``--rows`` rows (default 100M, about 60% live) and each segment count of
``--segments`` (default 1, 16, 64, 512, 2048, 4096, 16384) it times, per
call (``device_ms``: CUDA events around back-to-back calls, over the calls):

- the segment kernel (``ops/segments.py`` ``segment_reduce``) for SUM of a
  float64 column, SUM of int32 ones (a count) and MIN of a float32 column,
  dead rows routed past the last segment as the dense GROUP BY does, with
  the table layout chosen by segment count (``auto``) and with each layout
  forced (``private``, ``warp``, ``block``) for the float64 SUM;
- K1 (float64 values), K2 (float32) and K3 where the count is at most
  ``MAX_GROUPS``;
- the scatter that ``seg_sum`` / ``seg_min`` take above the gate
  (``index_add_`` / ``scatter_reduce_``, ids routed in the call).

Then queries (a) (16 groups, 17 slots) and (b) (2048 groups, 2049 slots) of
``chip_smoke.py`` end to end on one resident ``Session`` under each
``onehot_max_segments`` of ``--gates``: warm wall p50 of 10 runs, device
milliseconds of one profiled run, the kernel launches of one run; the rows
of every gate must agree with the first gate's (``models/parity.py``, rtol
1e-4: the kernels' float32 sums).  Each timing comes with its byte bound:
ids (4 B) and values read once, the outputs written once, over 3.35 TB/s.

The last line of standard output is one JSON object (also written to
``--out``); a table goes to standard error.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import group_kernels as gk
from ..ops import segments as seg
from ..utils.flags import FLAGS

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
QUERIES = {
    "a": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
         "WHERE v*2+1 > 0.5 GROUP BY g16 ORDER BY g16",
    "b": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
         "WHERE v*2+1 > 0.5 GROUP BY g ORDER BY g",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_ms(fn) -> float:
    """Device milliseconds a call: events around back-to-back calls over
    their number (20 calls, median of 3 windows; 2 calls, one window, when
    one call takes more than 20 ms, as the scatter can at few segments)."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    slow = a.elapsed_time(b) > 20.0
    launches, runs = (2, 1) if slow else (20, 3)
    per_call = []
    for _ in range(runs):
        torch.cuda.synchronize()
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / launches)
    return statistics.median(per_call)


@contextlib.contextmanager
def gate(value: int):
    prev = FLAGS.onehot_max_segments
    FLAGS.set_flag("onehot_max_segments", value)
    try:
        yield
    finally:
        FLAGS.set_flag("onehot_max_segments", prev)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def sweep(rows: int, S: int, gen: torch.Generator) -> dict:
    """One segment count: every timing of the module docstring."""
    dev = torch.device("cuda")
    codes = torch.randint(0, S, (rows,), generator=gen, device=dev, dtype=torch.int32)
    mask = torch.rand(rows, generator=gen, device=dev) < 0.6
    v = torch.randn(rows, generator=gen, device=dev)
    w = v.to(torch.float64)
    ones = torch.ones(rows, dtype=torch.int32, device=dev)
    gid = torch.where(mask, codes, S)               # dead rows past the last segment
    live = int(mask.sum())
    cases = {   # name: (x, op, output bytes)
        "sum_f64": (w, "sum", 8), "sum_i32": (ones, "sum", 4), "min_f32": (v, "min", 4)}
    out: dict = {"segments": S, "live": live, "segment_kernel": {}, "layouts": {},
                 "scatter": {}, "group_kernels": {}}
    head = slice(0, 1 << 20)      # the plain version costs rows x S: check a prefix
    for name, (x, op, ob) in cases.items():
        want = seg.segment_reduce_plain(x[head], gid[head], S, op)
        got = seg.segment_reduce(x[head], gid[head], S, op)
        if not torch.allclose(got.double(), want.double(), rtol=1e-9, atol=1e-9):
            raise AssertionError(f"segment kernel {name} at S={S} differs from its plain version")
        b = bound_ms(rows * (4 + x.element_size()) + S * ob)
        out["segment_kernel"][name] = {
            "device_ms": device_ms(lambda: seg.segment_reduce(x, gid, S, op)), "bound_ms": b}
        f = {"sum": seg.seg_sum, "min": seg.seg_min}[op]
        with gate(0):                                # seg_sum / seg_min take the scatter
            out["scatter"][name] = {"device_ms": device_ms(lambda: f(x, gid, S)),
                                    "bound_ms": b}
    for mode in ("private", "warp", "block"):
        try:
            ms = device_ms(lambda: seg.segment_reduce(w, gid, S, "sum", mode=mode))
        except RuntimeError as e:                    # the layout's table does not fit
            ms = None
            log(f"[seg_gate] S={S} layout {mode}: {e}")
        out["layouts"][mode] = ms
    if S <= gk.MAX_GROUPS:
        for name, fn, nbytes in (
                ("K1_filtered_group_sum", lambda: gk.filtered_group_sum(codes, w, mask, S),
                 rows * 5 + live * 8 + S * 12),
                ("K2_fused_group_aggregate",
                 lambda: gk.fused_group_aggregate(codes, v, mask, S),
                 rows * 5 + live * 4 + S * 20),
                ("K3_partition_histogram", lambda: gk.partition_histogram(codes, mask, S),
                 rows * 5 + S * 8)):
            out["group_kernels"][name] = {"device_ms": device_ms(fn),
                                          "bound_ms": bound_ms(nbytes)}
    return out


def sql_table(rows: int, seed: int):
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    return pa.table({"g": rng.integers(0, 2048, rows, dtype=np.int32),
                     "v": rng.standard_normal(rows, dtype=np.float32),
                     "w": rng.standard_normal(rows),
                     "g16": rng.integers(0, 16, rows, dtype=np.int32)})


def launches() -> dict:
    return {**{k: c.value for k, c in gk.LAUNCHES.items()},
            **{k: c.value for k, c in seg.LAUNCHES.items()}}


def end_to_end(rows: int, seed: int, gates: list[int]) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..exec.session import Session
    from ..models.parity import mismatch

    s = Session(device="cuda")
    s.execute("SET GLOBAL streaming_scan = 0")
    try:
        s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
        s.load_arrow("t", sql_table(rows, seed))
        s.db.stores["default.t"].device_table_batch()
        out: dict = {}
        first: dict = {}
        for g in gates:
            s.execute(f"SET GLOBAL onehot_max_segments = {g}")
            for q, sql in QUERIES.items():
                before = launches()
                got = s.query(sql)
                torch.cuda.synchronize()
                ran = {k: v - before[k] for k, v in launches().items() if v != before[k]}
                if q in first:
                    diff = mismatch(got, first[q], sql, 1e-4)
                    if diff is not None:
                        raise AssertionError(f"({q}) under gate {g} differs: {diff}")
                else:
                    first[q] = got
                walls = []
                for _ in range(10):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    s.query(sql)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t) * 1e3)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    s.query(sql)
                    torch.cuda.synchronize()
                dev = sorted(((e.key[:50], e.self_device_time_total / 1e3)
                              for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                             key=lambda kv: -kv[1])
                out[f"{q}@{g}"] = {"warm_ms_p50": statistics.median(walls),
                                   "device_ms": sum(ms for _, ms in dev),
                                   "top_kernels": dev[:4], "launches": ran}
                log(f"[seg_gate] ({q}) gate {g}: wall p50 {out[f'{q}@{g}']['warm_ms_p50']:.3f} "
                    f"ms, device {out[f'{q}@{g}']['device_ms']:.3f} ms, launches {ran}")
        return out
    finally:
        s.execute(f"SET GLOBAL onehot_max_segments = {FLAGS._default_of('onehot_max_segments')}")
        s.execute("SET GLOBAL streaming_scan = 1")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--segments", default="1,16,64,512,2048,4096,16384")
    ap.add_argument("--gates", default="16,512,4096")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("seg_gate: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gk.build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    per_s = []
    for S in (int(x) for x in args.segments.split(",")):
        r = sweep(args.rows, S, gen)
        per_s.append(r)
        torch.cuda.empty_cache()
        times = [f"{kind} {name} {v['device_ms']:.3f}"
                 for kind in ("segment_kernel", "scatter", "group_kernels")
                 for name, v in r[kind].items()]
        log(f"[seg_gate] S={S} device ms: " + "; ".join(times) + f"; layouts {r['layouts']}")
    e2e = end_to_end(args.rows, args.seed, [int(x) for x in args.gates.split(",")])
    result = {"card": card, "rows": args.rows, "sweep": per_s, "end_to_end": e2e}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
