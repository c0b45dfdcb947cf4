"""GPU smoke run of baikaldb_tpu_torch: build the kernels, hold each against
its plain torch version, drive single-table SQL at real size, and run the 22
TPC-H queries on the card.

    python3 chip_smoke.py [--rows N] [--seed S] [--tpch-scale S]
                          [--compare-with DIR]

Phases (any failure ends the run with a non-zero exit; nothing is caught):

1. the card: ``nvidia-smi`` name and power limit; CUDA is required.
2. kernels: build ``baikaldb_tpu_torch/ops/csrc/group_agg.cu`` with nvcc for
   sm_90a, then hold K1 ``filtered_group_sum``, K2 ``fused_group_aggregate``
   and K3 ``partition_histogram`` against their plain versions on the card:
   at the SQL path's shape (``--rows`` rows, 2049 groups), at 2^24 and at a
   ragged row count with 513/2049/4096 groups, and on edge cases (all rows
   masked, codes < 0 and >= ng, an empty group, +NaN and -NaN in a group,
   inputs that are views at element offsets 1-3).  Counts and min/max match
   exactly (NaN equal to NaN, and a group holding a NaN must give NaN);
   each group's sum within 1e-5 * sum(|v|) over the group.  Each kernel is
   timed at the SQL path's shape two ways: ``ms``, the median over single
   CUDA-event-timed calls (host work of the wrapper included), and
   ``device_ms``, events around 20 back-to-back calls over 20.  With
   ``--compare-with DIR`` (a checkout of another commit, e.g. from
   ``git archive``), that commit's kernels are timed too, in turns with
   this one's (theirs, ours, ours, theirs).
3. SQL: ``Session(device="cuda")`` over ``--rows`` rows (default 100M, the
   BASELINE.json size) of ``t (g INT, v FLOAT, w DOUBLE, g16 INT)``:
   (a) the bench headline over 16 groups (segment path, no kernel),
   (b) the same over 2048 groups (K3 + K2), (c) SUM/AVG of a DOUBLE over
   2048 groups (K1).  Each result is checked against numpy in float64, and
   the kernels' launch counters must show that (b) and (c) went through them.
   Each query's warm wall time (median and 67th percentile of 30 runs,
   rows/s at the median) is printed beside its device time from one run
   under torch.profiler (kernels and copies) and the top kernels; load
   time and peak device memory beside them.
4. TPC-H (``baikaldb_tpu_torch/models/tpch.py``): (i) the tables at SF 0.05
   (seed 0) go into ``Session(device="cuda")`` and ``Session(device="cpu")``;
   all 22 queries and ``VARIANTS`` (q20's shape with rows) run on both and
   must agree by the parity contract of ``models/parity.py``.  (ii) At ``--tpch-scale`` (default 1.0, the smallest
   official scale: 6M lineitem rows; seed ``--seed``) on the card: generation
   time, load + stage time and peak device memory; per query the warm wall
   time (median and 67th percentile of 10 runs after one warm-up run), the
   device time, idle share and top 4 kernels of one torch.profiler run, the
   session's spans of one traced run (host milliseconds of parse, plan,
   execution and egress), and the launches of K1-K3 (the TPC-H dense domains
   miss the kernels' gate, so 0 is expected and reported, not required).
   q1 and q6 are checked against numpy in float64 (rtol 1e-9), and every
   query must return finite values.

Each phase's seconds are printed on a line of their own, and in the JSON line
of measurements (redirect standard output to keep it).  The last two
lines of standard output are the ``kernels`` JSON line and the
``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # H100 SXM, float32 outside the tensor cores
NG_SQL = 2049                    # 2048 dense group slots + the NULL slot
WARM_REPS = 30
TPCH_REPS = 10
TPCH_CHECK_SCALE = 0.05
REPLACES = {
    "filtered_group_sum": "baikaldb_tpu/ops/pallas_kernels.py:184",
    "fused_group_aggregate": "baikaldb_tpu/ops/pallas_kernels.py:210",
    "partition_histogram": "baikaldb_tpu/ops/pallas_kernels.py:238",
}
QUERIES = {
    "a": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
         "WHERE v*2+1 > 0.5 GROUP BY g16 ORDER BY g16",
    "b": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
         "WHERE v*2+1 > 0.5 GROUP BY g ORDER BY g",
    "c": "SELECT g, SUM(w), AVG(w) FROM t WHERE w > -1 GROUP BY g ORDER BY g",
}
EXPECTED_LAUNCHES = {
    "a": {},
    "b": {"partition_histogram": 1, "fused_group_aggregate": 1},
    "c": {"filtered_group_sum": 1},
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed calls,
    after one warm-up call.  Each call is timed alone, so its host work (the
    wrapper's checks, allocation and launch) is in the number."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, launches: int = 20, runs: int = 3) -> float:
    """Device milliseconds per call: CUDA events around ``launches``
    back-to-back calls, over ``launches``, after a warm-up call; the median
    of ``runs`` such windows."""
    fn()
    per_call = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / launches)
    return statistics.median(per_call)


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions

PLUS_NAN = 0x7FC00000                  # numpy's and torch's NaN
MINUS_NAN = -0x00400000                # int32 bits of 0xFFC00000, x86's default NaN
NAN_GROUPS = {5: PLUS_NAN, 9: MINUS_NAN}


def make_inputs(n, ng, gen, dev, *, live=0.6, spread=0, empty=None, masked=False,
                offset=(0, 0, 0), nans=False):
    """Seeded inputs on the card.  ``offset``: codes, values and mask are
    contiguous views at these element offsets of larger tensors.  ``nans``:
    live rows of group 5 get a +NaN and of group 9 a -NaN; a NaN also sits in
    a masked-out row of group 11 and in a row whose code is out of range;
    group 13 holds only +inf and group 17 only -inf."""
    oc, ov, om = offset
    codes = torch.randint(-spread, ng + spread, (n + oc,), generator=gen, device=dev,
                          dtype=torch.int32)[oc:]
    if empty is not None:
        codes = torch.where(codes == empty, empty + 1, codes)
    values = torch.randn(n + ov, generator=gen, device=dev, dtype=torch.float32)[ov:]
    if masked:
        mask = torch.zeros(n + om, dtype=torch.bool, device=dev)[om:]
    else:
        mask = (torch.rand(n + om, generator=gen, device=dev) < live)[om:]
    if nans:
        bits = values.view(torch.int32)
        for i, (g, nan) in enumerate(NAN_GROUPS.items()):
            rows = slice(100 + 10 * i, 103 + 10 * i)
            codes[rows], mask[rows], bits[rows] = g, True, nan
        codes[200], mask[200], bits[200] = 11, False, PLUS_NAN
        codes[201], mask[201], bits[201] = ng, True, PLUS_NAN
        codes[120:123], mask[120:123] = 13, True
        codes[130:133], mask[130:133] = 17, True
        values[codes == 13] = float("inf")
        values[codes == 17] = float("-inf")
    return codes, values, mask


def same(got, want) -> bool:
    """Exact equality, NaN equal to NaN."""
    return (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0)))


def check_case(gk, codes, values, mask, ng) -> float:
    """Hold K1-K3 against the plain versions on one input; -> max |err|."""
    live = mask & (codes >= 0) & (codes < ng)
    gid = torch.where(live, codes, ng).to(torch.int64)
    sabs = torch.zeros(ng + 1, dtype=torch.float64, device=codes.device)
    sabs.index_add_(0, gid, values.abs().to(torch.float64))
    tol = 1e-5 * sabs[:ng]
    k1 = gk.filtered_group_sum(codes, values, mask, ng)
    k2 = gk.fused_group_aggregate(codes, values, mask, ng)
    k3 = gk.partition_histogram(codes, mask, ng)
    torch.cuda.synchronize()
    p1 = gk.filtered_group_sum_plain(codes, values, mask, ng)
    p2 = gk.fused_group_aggregate_plain(codes, values, mask, ng)
    p3 = gk.partition_histogram_plain(codes, mask, ng)
    where = f"(ng={ng}, n={codes.shape[0]})"
    for name, got, want in (("partition_histogram counts", k3, p3),
                            ("filtered_group_sum counts", k1[0], p1[0]),
                            ("fused_group_aggregate counts", k2[0], p2[0]),
                            ("fused_group_aggregate mins", k2[2], p2[2]),
                            ("fused_group_aggregate maxs", k2[3], p2[3])):
        if not same(got, want):
            raise AssertionError(f"{name} differ from the plain version {where}")
    # a group holding a NaN: MIN and MAX are NaN on the card, asserted
    # directly and not only against the plain version
    nan_rows = live & values.isnan()
    has_nan = torch.zeros(ng + 1, dtype=torch.int64, device=codes.device)
    has_nan.index_add_(0, gid, nan_rows.to(torch.int64))
    has_nan = has_nan[:ng] > 0
    for name, got in (("mins", k2[2]), ("maxs", k2[3]), ("sums", k2[1])):
        if not torch.equal(got.isnan(), has_nan):
            raise AssertionError(f"fused_group_aggregate {name}: NaN where the input has "
                                 f"none, or a NaN lost {where}")
    # K1 also takes DOUBLE columns (contracted as float32)
    k1d = gk.filtered_group_sum(codes, values.to(torch.float64), mask, ng)
    if not torch.equal(k1d[0], p1[0]):
        raise AssertionError(f"filtered_group_sum float64 counts differ {where}")
    err = 0.0
    for name, got, want in (("filtered_group_sum", k1[1], p1[1]),
                            ("filtered_group_sum float64", k1d[1], p1[1]),
                            ("fused_group_aggregate", k2[1], p2[1])):
        ok = torch.isfinite(want)
        if not same(got[~ok], want[~ok]):
            raise AssertionError(f"{name} sums: NaN or inf differs from the plain version "
                                 f"{where}")
        d = (got[ok].to(torch.float64) - want[ok].to(torch.float64)).abs()
        if bool((d > tol[ok]).any()):
            raise AssertionError(f"{name} sums beyond 1e-5*sum|v| {where}: "
                                 f"max diff {float(d.max())}")
        if d.numel():
            err = max(err, float(d.max()))
    return err


def load_port(root: str):
    """``ops/group_kernels`` of the port checked out under ``root`` (another
    commit), imported beside this one under its own package name; its
    kernels build from its own sources into its own ``_build/``."""
    pkg = os.path.join(os.path.abspath(root), "baikaldb_tpu_torch")
    alias = "baikaldb_tpu_torch_compared"
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops.group_kernels")


def kernel_phase(gk, rows: int, seed: int, before=None) -> dict:
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    so = gk.build()
    log(f"[kernels] built {so} in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    max_err = 0.0
    cases = [(rows, NG_SQL, {}), (1 << 24, 513, {}), (1 << 24, 2049, {}),
             (1 << 24, 4096, {}), (1_000_003, 513, {}), (1_000_003, 2049, {}),
             (1_000_003, 4096, {}), (777_777, 4096, {"spread": 5, "empty": 17}),
             (123_457, 2049, {"masked": True}), (3, 4096, {}), (0, 600, {}),
             (1_000_003, 2049, {"nans": True}), (1 << 20, 700, {"nans": True}),
             (1_000_003, 2049, {"offset": (0, 1, 0)}),
             (1_000_002, 2049, {"offset": (0, 2, 0)}),
             (1_000_001, 2049, {"offset": (0, 3, 0)}),
             (1_000_001, 4096, {"offset": (1, 1, 1)}),
             (999_999, 513, {"offset": (3, 3, 3), "nans": True}),
             (1_000_003, 2049, {"offset": (2, 0, 1)})]
    for n, ng, kw in cases:
        max_err = max(max_err, check_case(gk, *make_inputs(n, ng, gen, dev, **kw), ng))
        log(f"[kernels] n={n} ng={ng} {kw or ''}: match")

    # times at the SQL path's shape
    codes, values, mask = make_inputs(rows, NG_SQL, gen, dev)
    w64 = values.to(torch.float64)        # query (c) feeds K1 a DOUBLE column
    live = int((mask & (codes >= 0) & (codes < NG_SQL)).sum())
    gid = torch.where(mask, codes, NG_SQL).to(torch.int64)
    ones = torch.ones(rows, dtype=torch.float32, device=dev)
    acc32 = torch.zeros(NG_SQL + 1, dtype=torch.float32, device=dev)
    acc64 = torch.zeros(NG_SQL + 1, dtype=torch.float64, device=dev)
    specs = {
        # name: (kernel arguments, library call or None,
        #        bytes the function must move, operations per live row)
        "filtered_group_sum": ((codes, w64, mask, NG_SQL),
                               lambda: acc64.index_add_(0, gid, w64),
                               rows * 5 + live * 8 + NG_SQL * 8, 2),
        "fused_group_aggregate": ((codes, values, mask, NG_SQL), None,
                                  rows * 5 + live * 4 + NG_SQL * 16, 4),
        "partition_histogram": ((codes, mask, NG_SQL),
                                lambda: acc32.index_add_(0, gid, ones),
                                rows * 5 + NG_SQL * 4, 1),
    }

    def timed(mod, name, args):
        fn = getattr(mod, name)
        return cuda_ms(lambda: fn(*args), 20), device_ms(lambda: fn(*args))

    out = {}
    for name, (args, lib, nbytes, ops) in specs.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = live * ops / F32_OPS_PER_S * 1e3
        if before is None:
            ms, dev_ms = timed(gk, name, args)
        else:
            # in turns: the compared commit, this one, this one, the compared one
            b1, t1, t2, b2 = (timed(m, name, args) for m in (before, gk, gk, before))
            ms, dev_ms = (t1[0] + t2[0]) / 2, (t1[1] + t2[1]) / 2
        plain = getattr(gk, f"{name}_plain")
        out[name] = {
            "ms": ms,
            "device_ms": dev_ms,
            "plain_ms": cuda_ms(lambda: plain(*args), 5),
            "library_ms": None if lib is None else cuda_ms(lib, 5),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": max_err,
        }
        if before is not None:
            out[name]["before"] = {"ms": [b1[0], b2[0]], "device_ms": [b1[1], b2[1]],
                                   "this_ms": [t1[0], t2[0]],
                                   "this_device_ms": [t1[1], t2[1]]}
        log(f"[kernels] {name}: {ms:.4f} ms a call, {dev_ms:.4f} ms on the device "
            f"(plain {out[name]['plain_ms']:.4f} ms, bound {out[name]['bound_ms']:.4f} ms) "
            f"at n={rows} ng={NG_SQL}" + ("" if before is None else
                                          f"; compared commit {out[name]['before']}"))
    return out


# ----------------------------------------------------------------------
# phase 3: SQL at real size


def reference(keys, vals, mask, ng):
    """numpy float64 group-by: counts, sums, sum|v|, mins (f32 values)."""
    k = keys[mask]
    v = vals[mask]
    counts = np.bincount(k, minlength=ng)
    sums = np.bincount(k, weights=v.astype(np.float64), minlength=ng)
    sabs = np.bincount(k, weights=np.abs(v).astype(np.float64), minlength=ng)
    mins = np.full(ng, np.inf)
    np.minimum.at(mins, k, v.astype(np.float64))
    return counts, sums, sabs, mins


def check_rows(name, rows, ref, has_count=True, has_min=True):
    """Against the numpy reference: group keys and counts exact, each SUM
    within 1e-5 * sum(|v|) over its group, AVG within that over the count,
    MIN exact."""
    counts, sums, sabs, mins = ref
    keys = [int(i) for i in np.nonzero(counts)[0]]
    cols = list(rows[0]) if rows else []
    if [r[cols[0]] for r in rows] != keys:
        raise AssertionError(f"query ({name}): group keys differ from numpy")
    for r in rows:
        g, *vals = (r[c] for c in cols)
        if has_count:
            if vals[0] != counts[g]:
                raise AssertionError(f"query ({name}) group {g}: count {vals[0]} != {counts[g]}")
            vals = vals[1:]
        sm, avg = vals[0], vals[1]
        tol = 1e-5 * sabs[g] + 1e-12
        if abs(sm - sums[g]) > tol or abs(avg - sums[g] / counts[g]) > tol / counts[g]:
            raise AssertionError(f"query ({name}) group {g}: sum/avg {sm}/{avg} vs "
                                 f"{sums[g]}/{sums[g] / counts[g]}")
        if has_min and vals[2] != mins[g]:
            raise AssertionError(f"query ({name}) group {g}: min {vals[2]} != {mins[g]}")


def device_breakdown(run, wall_ms: float) -> dict:
    """One profiled run: device time summed over CUDA kernels and copies,
    the idle share of the unprofiled wall time, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(ms for _, ms in dev)
    top = sorted(dev, key=lambda kv: -kv[1])[:4]
    return {"device_ms": busy, "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "top_kernels": [[k[:60], ms] for k, ms in top]}


def sql_phase(gk, rows: int, seed: int) -> tuple[dict, dict]:
    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Session

    rng = np.random.default_rng(seed)
    g = rng.integers(0, 2048, rows, dtype=np.int32)
    v = rng.standard_normal(rows, dtype=np.float32)
    w = rng.standard_normal(rows)
    g16 = rng.integers(0, 16, rows, dtype=np.int32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = Session(device="cuda")
    s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
    s.load_arrow("t", pa.table({"g": g, "v": v, "w": w, "g16": g16}))
    s.db.stores["default.t"].device_table_batch()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"[sql] {rows} rows loaded and staged on the card in {load_s:.2f} s")

    # numpy float64 references
    keep_v = (v * np.float32(2) + np.float32(1)).astype(np.float64) > 0.5
    ref_a = reference(g16, v, keep_v, 16)
    ref_b = reference(g, v, keep_v, 2048)
    keep_w = w > -1
    ref_c = reference(g, w, keep_w, 2048)

    # the main path: counters at 0 just before, read just after
    for c in gk.LAUNCHES.values():
        c.reset()
    results, per_query = {}, {}
    for q, sql in QUERIES.items():
        before = {k: c.value for k, c in gk.LAUNCHES.items()}
        results[q] = s.query(sql)
        torch.cuda.synchronize()
        per_query[q] = {k: c.value - before[k] for k, c in gk.LAUNCHES.items()
                        if c.value != before[k]}
    launches = {k: c.value for k, c in gk.LAUNCHES.items()}
    for q, want in EXPECTED_LAUNCHES.items():
        if per_query[q] != want:
            raise AssertionError(f"query ({q}) launched {per_query[q]}, expected {want}")

    check_rows("a", results["a"], ref_a)
    check_rows("b", results["b"], ref_b)
    check_rows("c", results["c"], ref_c, has_count=False, has_min=False)
    log(f"[sql] results match numpy; launches {per_query}")

    # warm wall times: median and the highest percentile with ten samples
    # beyond it (the 20th of 30)
    sql_stats = {"load_s": load_s}
    for q, sql in QUERIES.items():
        walls = []
        for _ in range(WARM_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.query(sql)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        walls.sort()
        med = statistics.median(walls)
        sql_stats[q] = {"warm_ms_p50": med, "warm_ms_p67": walls[WARM_REPS - 11],
                        "rows_per_s": rows / (med / 1e3),
                        **device_breakdown(lambda: s.query(sql), med)}
        log(f"[sql] ({q}) warm wall p50 {med:.2f} ms p67 {walls[WARM_REPS - 11]:.2f} ms "
            f"over {WARM_REPS} runs, device busy {sql_stats[q]['device_ms']:.2f} ms: {sql}")
    sql_stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return launches, sql_stats


# ----------------------------------------------------------------------
# phase 4: TPC-H


def load_tpch(session, tables: dict):
    from baikaldb_tpu_torch.models import tpch

    for name, ddl in tpch.DDL.items():
        session.execute(ddl)
        session.load_arrow(name, tables[name])
    return session


def launch_counts(gk) -> dict:
    return {k: c.value for k, c in gk.LAUNCHES.items()}


def tpch_card_vs_cpu(gk) -> None:
    """(i): all 22 queries on the card and on the CPU, equal by the parity
    contract (rtol 1e-4 where a group-by kernel ran on the card)."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models import tpch
    from baikaldb_tpu_torch.models.parity import mismatch

    tables = tpch.generate(scale=TPCH_CHECK_SCALE, seed=0)
    gpu = load_tpch(Session(device="cuda"), tables)
    cpu = load_tpch(Session(device="cpu"), tables)
    for q, sql in {**tpch.QUERIES, **tpch.VARIANTS}.items():
        before = launch_counts(gk)
        got = gpu.query(sql)
        ran = launch_counts(gk) != before
        diff = mismatch(got, cpu.query(sql), sql, 1e-4 if ran else 1e-9)
        if diff is not None:
            raise AssertionError(f"TPC-H {q} at SF {TPCH_CHECK_SCALE}: the card differs "
                                 f"from the CPU: {diff}")
        if q in tpch.VARIANTS and not got:
            raise AssertionError(f"TPC-H {q} at SF {TPCH_CHECK_SCALE}: no rows")
    log(f"[tpch] SF {TPCH_CHECK_SCALE}: all {len(tpch.QUERIES)} queries and "
        f"{len(tpch.VARIANTS)} variant equal on the card and the CPU")


def _arrow_np(table, col):
    return table.column(col).combine_chunks().to_numpy(zero_copy_only=False)


def check_q1_q6(rows_q1: list, rows_q6: list, lineitem) -> None:
    """q1 and q6 against numpy in float64: keys and counts exact, sums and
    averages to rtol 1e-9."""
    import datetime

    import pyarrow.compute as pc

    def days(iso):
        return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days

    ship = _arrow_np(lineitem, "l_shipdate").astype("datetime64[D]").astype(np.int64)
    qty, price = _arrow_np(lineitem, "l_quantity"), _arrow_np(lineitem, "l_extendedprice")
    disc, tax = _arrow_np(lineitem, "l_discount"), _arrow_np(lineitem, "l_tax")

    def close(a, b):
        return abs(a - b) <= 1e-9 * abs(b) + 1e-9

    keep = ship <= days("1998-09-02")
    rf = pc.dictionary_encode(lineitem.column("l_returnflag").combine_chunks())
    ls = pc.dictionary_encode(lineitem.column("l_linestatus").combine_chunks())
    rf_code, ls_code = rf.indices.to_numpy(), ls.indices.to_numpy()
    n_ls = len(ls.dictionary)
    gid = (rf_code * n_ls + ls_code)[keep]
    ng = len(rf.dictionary) * n_ls

    def gsum(x):
        return np.bincount(gid, weights=x[keep], minlength=ng)

    cnt = np.bincount(gid, minlength=ng)
    sums = {"sum_qty": gsum(qty), "sum_base_price": gsum(price),
            "sum_disc_price": gsum(price * (1 - disc)),
            "sum_charge": gsum(price * (1 - disc) * (1 + tax))}
    avgs = {"avg_qty": sums["sum_qty"] / np.maximum(cnt, 1),
            "avg_price": sums["sum_base_price"] / np.maximum(cnt, 1),
            "avg_disc": gsum(disc) / np.maximum(cnt, 1)}
    want = []
    for g in np.nonzero(cnt)[0]:
        r, l_ = divmod(int(g), n_ls)
        want.append((rf.dictionary[r].as_py(), ls.dictionary[l_].as_py(), int(g)))
    want.sort()
    if [(r["l_returnflag"], r["l_linestatus"]) for r in rows_q1] != [w[:2] for w in want]:
        raise AssertionError("TPC-H q1: group keys differ from numpy")
    for r, (_, _, g) in zip(rows_q1, want):
        if r["count_order"] != cnt[g]:
            raise AssertionError(f"TPC-H q1 {r['l_returnflag']}{r['l_linestatus']}: count "
                                 f"{r['count_order']} != {cnt[g]}")
        for k, v in list(sums.items()) + list(avgs.items()):
            if not close(r[k], float(v[g])):
                raise AssertionError(f"TPC-H q1 {r['l_returnflag']}{r['l_linestatus']}: "
                                     f"{k} {r[k]} != numpy {float(v[g])}")
    keep6 = ((ship >= days("1994-01-01")) & (ship < days("1995-01-01"))
             & (disc >= 0.05) & (disc <= 0.07) & (qty < 24))
    rev = float(np.sum(price[keep6] * disc[keep6]))
    if len(rows_q6) != 1 or not close(rows_q6[0]["revenue"], rev):
        raise AssertionError(f"TPC-H q6: {rows_q6} != numpy {rev}")


def finite_rows(q: str, rows: list) -> None:
    for r in rows:
        for k, v in r.items():
            if isinstance(v, float) and not np.isfinite(v):
                raise AssertionError(f"TPC-H {q}: {k} = {v}")


def span_ms(s, sql: str) -> dict:
    """Milliseconds of each session span in one traced run: ``query`` is the
    whole ``execute`` (the rest of the wall is the rows' conversion to
    dicts); ``parse`` and ``plan.build`` are host work alone, while
    ``exec.run`` and ``egress.arrow`` also wait for the card where they read
    from it."""
    from baikaldb_tpu_torch.obs import trace

    s.execute("SET GLOBAL tracing = 1")
    try:
        s.query(sql)
        torch.cuda.synchronize()
    finally:
        s.execute("SET GLOBAL tracing = 0")
    rec = [t for t in trace.TRACER.list() if t["text"] == sql][-1]
    out: dict = {}
    for sp in rec["spans"]:
        out[sp["name"]] = out.get(sp["name"], 0.0) + sp["dur_ms"]
    return out


def tpch_on_the_card(gk, scale: float, seed: int) -> dict:
    """(ii): the 22 queries at ``scale`` on the card, timed."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models import tpch

    t0 = time.perf_counter()
    tables = tpch.generate(scale=scale, seed=seed)
    gen_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = load_tpch(Session(device="cuda"), tables)
    for store in s.db.stores.values():
        store.device_table_batch()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"[tpch] SF {scale}: generated in {gen_s:.2f} s, loaded and staged on the card "
        f"in {load_s:.2f} s ({tables['lineitem'].num_rows} lineitem rows)")

    # the TPC-H path: counters at 0 just before, read just after
    for c in gk.LAUNCHES.values():
        c.reset()
    per_query, first = {}, {}
    for q, sql in tpch.QUERIES.items():
        before = launch_counts(gk)
        t = time.perf_counter()
        first[q] = s.query(sql)         # the warm-up run (plans, collects statistics)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        launched = {k: v - before[k] for k, v in launch_counts(gk).items()}
        finite_rows(q, first[q])
        walls = []
        for _ in range(TPCH_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.query(sql)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        med = statistics.median(walls)
        per_query[q] = {"rows": len(first[q]), "first_ms": first_ms, "warm_ms_p50": med,
                        "warm_ms_p67": float(np.percentile(walls, 67)),
                        "kernel_launches": launched,
                        **device_breakdown(lambda: s.query(sql), med),
                        "spans_ms": span_ms(s, sql)}
        log(f"[tpch] {q}: {len(first[q])} rows, first run {first_ms:.1f} ms, warm p50 "
            f"{med:.2f} ms p67 {per_query[q]['warm_ms_p67']:.2f} ms, device "
            f"{per_query[q]['device_ms']:.2f} ms, idle {per_query[q]['idle_share']:.3f}, "
            f"K1-K3 launches {launched}, spans "
            + " ".join(f"{k} {v:.2f}" for k, v in per_query[q]["spans_ms"].items()))
    check_q1_q6(first["q1"], first["q6"], tables["lineitem"])
    log(f"[tpch] SF {scale}: q1 and q6 match numpy")
    return {"scale": scale, "seed": seed, "gen_s": gen_s, "load_s": load_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "queries": per_query}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tpch-scale", type=float, default=1.0,
                    help="TPC-H scale factor of the timed run on the card")
    ap.add_argument("--compare-with", metavar="DIR",
                    help="a checkout of another commit: time its kernels too, in turns "
                         "with this one's, on the same inputs")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    name_power = card()
    print(name_power, flush=True)

    from baikaldb_tpu_torch.ops import group_kernels as gk

    before = None if args.compare_with is None else load_port(args.compare_with)
    phase_s = {}
    t0 = time.perf_counter()
    times = kernel_phase(gk, args.rows, args.seed, before)
    phase_s["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, sql_stats = sql_phase(gk, args.rows, args.seed)
    phase_s["sql"] = time.perf_counter() - t0
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tpch_card_vs_cpu(gk)
    phase_s["tpch_card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tpch_stats = tpch_on_the_card(gk, args.tpch_scale, args.seed)
    phase_s["tpch_timed"] = time.perf_counter() - t0
    print("phase seconds: " + json.dumps(phase_s), flush=True)

    kernels = [{"name": k, "route": "cuda",
                "source": "baikaldb_tpu_torch/ops/csrc/group_agg.cu",
                "replaces": REPLACES[k], "launches": launches[k], **times[k]}
               for k in REPLACES]
    print(json.dumps({"card": name_power, "rows": args.rows, "phase_s": phase_s,
                      "sql": sql_stats, "tpch": tpch_stats}), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
