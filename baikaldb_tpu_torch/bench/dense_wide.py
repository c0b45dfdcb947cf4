"""The wide dense GROUP BY kernel on the card, at the shapes of TPC-H's q10
and of q18's inner GROUP BY at SF1.

    python -m baikaldb_tpu_torch.bench.dense_wide [--seed S] [--out FILE]

Shapes (``shape``): ``q10`` is 6M rows, 2% live in no order, 150,001 slots
(the customer keys), SUM of a float64 column and MIN of six columns that
depend on the key (four dictionary codes, a float64 and an int32);
``q18_inner`` is 6M rows, all live, 6,000,001 slots (the sparse order keys
of 1.5M orders, eight of every 32), one to seven rows a key in key order
(four on average), SUM of a float64 column.

For each it times, as ``ms`` (the median of 20 single calls, each between
two CUDA events), ``device_ms`` (20 back-to-back calls over 20, which the
host's launches bound where the device work is shorter) and ``busy_ms``
(the device operations of a call, from torch.profiler; ``kernel_ms`` the
wide kernel's alone):

- ``kernel``: ``ops/hashagg.py`` ``dense_group_agg`` on the card, the
  wide route: its fills, one launch, the columns;
- ``plain``: ``dense_group_agg_plain`` on the card, the route the port
  took before: the drop-slot ids, one scatter per aggregate, the casts;
- ``library``: the library passes of that route alone (``index_add_`` /
  ``scatter_reduce_`` over ids routed beforehand: ``present``, and each
  aggregate's pass and its live count);

beside ``bound_ms``: the bytes the group-by needs (ids and selection read
once a row, each column's value and validity once a live row, every output
written once) over 3.35 TB/s.  The kernel is held against the plain version
(counts, integers and MIN/MAX exactly, float64 sums to 1e-12 relative).

The last line of standard output is one JSON object (also written to
``--out``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..column.batch import Column
from ..ops import dense_agg, group_kernels as gk
from ..ops import hashagg
from ..ops.hashagg import AggSpec
from ..types import LType

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
ROWS = 6_000_000


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def shape(name: str, dev, seed: int = 0):
    """-> (gid int32, sel or None, {name: Column}, specs, ng) of one shape."""
    rng = np.random.default_rng(seed)
    if name == "q10":
        ng = 150_001
        gid = rng.integers(0, ng - 1, ROWS).astype(np.int32)
        sel = rng.random(ROWS) < 0.02
        fd = rng.permutation(ng)          # columns that depend on the key alone
        data = {"revenue": (rng.uniform(900.0, 105_000.0, ROWS), LType.FLOAT64),
                "c_name": (fd[gid].astype(np.int32), LType.STRING),
                "c_address": ((fd[gid] * 7 % ng).astype(np.int32), LType.STRING),
                "n_name": ((gid % 25).astype(np.int32), LType.STRING),
                "c_phone": ((fd[gid] * 13 % ng).astype(np.int32), LType.STRING),
                "c_acctbal": (fd[gid] / 10.0 - 999.99, LType.FLOAT64),
                "c_custkey": ((gid + 1).astype(np.int32), LType.INT32)}
        specs = [AggSpec("sum", "revenue", "revenue")] + [
            AggSpec("min", c, c) for c in data if c != "revenue"]
    elif name == "q18_inner":
        orders = 1_500_000
        ng = 6_000_001
        keys = (np.arange(orders) // 8) * 32 + np.arange(orders) % 8 + 1
        per = rng.integers(1, 8, orders)
        gid = np.repeat(keys, per)[:ROWS].astype(np.int32)
        sel = None
        data = {"l_quantity": (rng.integers(1, 51, gid.shape[0]).astype(np.float64),
                               LType.FLOAT64)}
        specs = [AggSpec("sum", "l_quantity", "sum_qty")]
    else:
        raise ValueError(f"unknown shape {name!r}")
    cols = {k: Column(torch.from_numpy(np.ascontiguousarray(v)).to(dev), None, lt)
            for k, (v, lt) in data.items()}
    return (torch.from_numpy(gid).to(dev), None if sel is None else torch.from_numpy(sel).to(dev),
            cols, specs, ng)


def compare(got, want, specs) -> float:
    """Assert the kernel's (present, columns) equal the plain version's:
    float64 SUM and AVG to 1e-12 relative (the atomics add in another
    order), the rest exactly -> the largest relative gap of those sums."""
    assert torch.equal(got[0], want[0]), "present"
    worst = 0.0
    for s, g, w in zip(specs, got[1], want[1]):
        assert g.data.dtype == w.data.dtype and g.ltype == w.ltype, s
        assert (g.validity is None) == (w.validity is None), s
        assert w.validity is None or torch.equal(g.validity, w.validity), s
        if s.op in ("sum", "avg") and w.data.dtype is torch.float64:
            torch.testing.assert_close(g.data, w.data, rtol=1e-12, atol=0.0, equal_nan=True)
            gap = ((g.data - w.data).abs() / w.data.abs()).nan_to_num(0.0, posinf=0.0)
            worst = max(worst, float(gap.max()) if gap.numel() else 0.0)
        else:
            torch.testing.assert_close(g.data, w.data, rtol=0.0, atol=0.0, equal_nan=True)
    return worst


def library_chain(gid, sel, cols, specs, ng):
    """The library passes of the scatter route, over ids and values made
    beforehand: -> a function that runs them."""
    dev = gid.device
    sel = torch.ones_like(gid, dtype=torch.bool) if sel is None else sel
    ids = torch.where(sel, gid, ng).to(torch.int64)
    ones = torch.ones_like(gid)
    vals = {}
    for s in specs:
        c = cols[s.input]
        vals[s.out_name] = c.data.to(torch.float64) if s.op == "sum" else c.data

    def run():
        torch.zeros(ng + 1, dtype=torch.int32, device=dev).index_add_(0, ids, ones)
        for s in specs:
            x = vals[s.out_name]
            if s.op == "sum":
                torch.zeros(ng + 1, dtype=x.dtype, device=dev).index_add_(0, ids, x)
            else:
                ident = dense_agg._identity(x.dtype, s.op == "min")
                torch.full((ng + 1,), ident, dtype=x.dtype, device=dev).scatter_reduce_(
                    0, ids, x, reduce="amin" if s.op == "min" else "amax", include_self=True)
            torch.zeros(ng + 1, dtype=torch.int32, device=dev).index_add_(0, ids, ones)
    return run


def call_ms(fn, calls: int = 20) -> float:
    """The median of ``calls`` single calls, each between two events."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def device_ms(fn, calls: int = 20) -> float:
    """``calls`` back-to-back calls between two events, over ``calls``."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def busy_ms(fn, calls: int = 20) -> dict:
    """The device time a call from torch.profiler's CUDA activity over
    ``calls`` calls: ``busy_ms`` of every device operation, ``kernel_ms`` of
    the wide kernel alone (0 where it does not run)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {e.key: e.device_time_total for e in prof.key_averages()}
    return {"busy_ms": sum(us.values()) / calls / 1e3,
            "kernel_ms": sum(v for k, v in us.items() if "dense_agg_kernel" in k) / calls / 1e3}


def bound_ms(gid, sel, cols, specs, ng) -> float:
    n = gid.shape[0]
    live = n if sel is None else int(sel.sum())
    nbytes = n * (4 + (0 if sel is None else 1))
    for name in {s.input for s in specs}:
        c = cols[name]
        nbytes += live * (c.data.element_size() + (0 if c.validity is None else 1))
    nbytes += ng * 4                           # the live counts
    for a in dense_agg.wide_plan(specs, cols):
        dtype = dense_agg.DTYPES.get(a.kind, cols[a.input].data.dtype)
        nbytes += ng * torch.empty((), dtype=dtype).element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3


def measure(name: str, seed: int) -> dict:
    gid, sel, cols, specs, ng = shape(name, "cuda", seed)
    kernel = lambda: hashagg.dense_group_agg(gid, sel, cols, specs, ng)      # noqa: E731
    plain = lambda: hashagg.dense_group_agg_plain(gid, sel, cols, specs, ng)  # noqa: E731
    rel = compare(kernel(), plain(), specs)
    before = dense_agg.LAUNCHES["dense_group_agg"].value
    kernel()
    launches = dense_agg.LAUNCHES["dense_group_agg"].value - before
    library = library_chain(gid, sel, cols, specs, ng)
    out = {"shape": name, "rows": gid.shape[0], "slots": ng,
           "live": gid.shape[0] if sel is None else int(sel.sum()),
           "aggregates": [f"{s.op}({s.input})" for s in specs],
           "launches_a_call": launches, "sum_rel_err": rel,
           "bound_ms": bound_ms(gid, sel, cols, specs, ng)}
    for k, fn in (("kernel", kernel), ("plain", plain), ("library", library)):
        out[k] = {"ms": call_ms(fn), "device_ms": device_ms(fn), **busy_ms(fn)}
    out["share_of_bound"] = out["bound_ms"] / out["kernel"]["busy_ms"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("dense_wide: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gk.build_all()
    shapes = []
    for name in ("q10", "q18_inner"):
        r = measure(name, args.seed)
        shapes.append(r)
        torch.cuda.empty_cache()
        log(f"[dense_wide] {name}: " + "; ".join(
            f"{k} {r[k]['ms']:.3f} ms / {r[k]['device_ms']:.3f} device ms / "
            f"{r[k]['busy_ms']:.4f} busy ms"
            for k in ("kernel", "plain", "library")) + f"; bound {r['bound_ms']:.4f} ms")
    line = json.dumps({"card": card, "seed": args.seed, "shapes": shapes})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
