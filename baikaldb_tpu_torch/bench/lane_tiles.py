"""The lane kernels' tile on the card: how many lanes a block should carry.

    python -m baikaldb_tpu_torch.bench.lane_tiles [--rows N] [--lanes 8,64]
        [--live 0.6,D-b] [--kernels NAME,...] [--seed S] [--compare-with DIR ...]
        [--out FILE]

At ``--rows`` rows and each lane count of ``--lanes`` it times, per call
(``device_ms``: CUDA events around 5 back-to-back calls, over 5, the median
of 3 windows), every tile the kernels take (the launchers with the tile
forced, for k from 1 to the most lanes whose tables fit a block,
``lane_plan(...).fit``):

- the segment kernel's lane path (``ops/segments.py``
  ``segment_reduce_lanes``): SUM of a float64 column over query (a)'s 17
  slots, private tables (34,816 bytes a lane), in clusters of up to 8
  blocks that share one read of the column and the ids;
- K1's and K3's lane path (``ops/group_kernels.py``) over the dense GROUP
  BY's 2049 slots;
- K2's lane path (``fused_group_aggregate_lanes``, COUNT / SUM / MIN / MAX
  of a float32 column over 2049 slots, 20 bytes a slot and lane beside the
  block's bucket counts).

``--live`` lists the masks: a share draws each lane's rows at random with
that probability (default 0.6); ``D-b`` draws the dispatcher's D-b masks
(each lane keeps the rows of a random range of 20 to 100 of the 2048 groups
whose value passes ``v*2+1 > x``, x ~ N(0, 0.5): about 2% live).  Every
kernel of ``--kernels`` (default all four entries) runs at the first
entry, K2 alone at the others.  K2 is also timed at its planned tile on a
skewed input (every code in one slot, 60% live).

Each row carries the byte bound (the lanes' masks plus one read of ids or
codes and values, the outputs written once, over 3.35 TB/s), the tile
``lane_plan`` picks by itself, the live share and the bytes one call of the
entry allocates (outputs and workspace).  ``--compare-with DIR``
(repeatable; a checkout of another commit or of another design of the
kernels, e.g. from ``git archive``, its ``baikaldb_tpu_torch`` imported
under its own name and built from its own sources) times that checkout's
lane entries with their own plans on the same inputs, in turns with this
tree's (theirs, ours, ours, theirs), with the bytes they allocate; every
compared output must equal this tree's bit for bit (counts, and the segment
kernel's float64 sums) or, for float32 sums, mins and maxs, within 1e-5.
The last line of standard output is one JSON object (also written to
``--out``).  Needs a CUDA device.
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

import torch

from .. import ops as this_ops
from ..ops import group_kernels as gk
from ..ops import segments as seg

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
NG = 2049                        # the dense GROUP BY's 2048 slots + NULL
S = 17                           # query (a): 16 groups + NULL
K2 = "fused_group_aggregate_lanes"
ENTRIES = ("segment_reduce_lanes", "filtered_group_sum_lanes", "partition_histogram_lanes", K2)


def device_ms(fn, launches: int = 5, runs: int = 3) -> float:
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


def load_checkout(root: str, alias: str):
    """The ``ops`` package of the port checked out under ``root``, imported
    under ``alias``."""
    pkg = os.path.join(os.path.abspath(root), "baikaldb_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    for name in ("group_kernels", "segments"):
        importlib.import_module(f"{alias}.ops.{name}")
    return importlib.import_module(f"{alias}.ops")


def masks(kind: str, n: int, G: int, codes, values, gen):
    """[G, n] masks of one ``--live`` entry (see the module's docstring)."""
    dev = codes.device
    mask = torch.empty((G, n), dtype=torch.bool, device=dev)
    for g in range(G):
        if kind == "D-b":
            width = int(torch.randint(20, 101, (1,), generator=gen, device=dev))
            lo = int(torch.randint(0, 2048 - width, (1,), generator=gen, device=dev))
            x = float(torch.randn(1, generator=gen, device=dev)) * 0.5
            mask[g] = (values * 2 + 1 > x) & (codes >= lo) & (codes < lo + width)
        else:
            mask[g] = torch.rand(n, generator=gen, device=dev) < float(kind)
    return mask


def lane_rows(mask) -> int:
    """The live rows of a [G, n] mask, a lane at a time: a count over the
    whole of it widens it to int64 first (51 GB at 64 lanes of 100M rows)."""
    return sum(int(torch.count_nonzero(m)) for m in mask)


def alloc_bytes(fn) -> int:
    """Device bytes one call of ``fn`` allocates (its outputs and
    workspace), from the allocator's peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def compare(name: str, mine, theirs, root: str) -> None:
    for a, b in zip(mine if isinstance(mine, tuple) else (mine,),
                    theirs if isinstance(theirs, tuple) else (theirs,)):
        if a.dtype is torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        elif not torch.equal(a, b):
            raise AssertionError(f"{name}: {root} differs from this tree")


def sweep(n: int, G: int, live: str, gen, compared: dict, kernels) -> dict:
    dev = torch.device("cuda")
    codes = torch.randint(0, NG, (n,), generator=gen, device=dev, dtype=torch.int32)
    w64 = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    v32 = w64.float()
    mask = masks(live, n, G, codes, v32, gen)
    share = lane_rows(mask) / (G * n)
    gid = torch.remainder(codes, S).to(torch.int32)
    out = {}
    plans = {
        "segment_reduce_lanes": (seg.lane_plan("sum", torch.float64, S, G), 8, S * 8,
                                 lambda k: seg._launch(w64, gid, S, "sum", seg.MODES["auto"],
                                                       mask, k),
                                 lambda ops: ops.segments.segment_reduce_lanes(w64, gid, mask,
                                                                               S, "sum")),
        "filtered_group_sum_lanes": (gk.lane_plan(gk.KIND_SUM, NG, G), 8, NG * 12,
                                     lambda k: gk._launch_lanes("filtered_group_sum",
                                                                gk.KIND_SUM, codes, w64, mask,
                                                                NG, k),
                                     lambda ops: ops.group_kernels.filtered_group_sum_lanes(
                                         codes, w64, mask, NG)),
        "partition_histogram_lanes": (gk.lane_plan(gk.KIND_HIST, NG, G), 0, NG * 8,
                                      lambda k: gk._launch_lanes("partition_histogram",
                                                                 gk.KIND_HIST, codes, None,
                                                                 mask, NG, k),
                                      lambda ops: ops.group_kernels.partition_histogram_lanes(
                                          codes, mask, NG)),
        "fused_group_aggregate_lanes": (gk.lane_plan(gk.KIND_AGG, NG, G), 4, NG * 20,
                                        lambda k: gk._launch_agg_lanes(codes, v32, mask, NG, k),
                                        lambda ops: ops.group_kernels.fused_group_aggregate_lanes(
                                            codes, v32, mask, NG)),
    }
    for name, (plan, vbytes, obytes, call, entry) in plans.items():
        if name not in kernels:
            continue
        nbytes = G * n + n * (4 + vbytes) + G * obytes
        row = {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "planned_tile": plan.tile,
               "live_share": share, "alloc_bytes": alloc_bytes(lambda: entry(this_ops)),
               "device_ms_by_tile": {}}
        for k in range(1, plan.fit + 1):
            row["device_ms_by_tile"][k] = device_ms(lambda: call(k))
            print(f"{name} n={n} G={G} live={live} tile {k}: "
                  f"{row['device_ms_by_tile'][k]:.3f} ms (bound {row['bound_ms']:.3f})",
                  file=sys.stderr, flush=True)
        mine = entry(this_ops)
        for root, ops in compared.items():
            compare(name, mine, entry(ops), root)
            b1, t1, t2, b2 = (device_ms(lambda: entry(m)) for m in (ops, this_ops, this_ops, ops))
            row.setdefault("compared", {})[root] = {
                "device_ms": [b1, b2], "this_device_ms": [t1, t2],
                "alloc_bytes": alloc_bytes(lambda: entry(ops))}
            print(f"{name} n={n} G={G} live={live}: {root} {b1:.3f} / {b2:.3f} ms, this tree "
                  f"{t1:.3f} / {t2:.3f}", file=sys.stderr, flush=True)
        out[name] = row
    return out


def skewed(n: int, G: int, gen, compared: dict) -> dict:
    """K2's lane entry at its planned tile with every code in one slot."""
    dev = torch.device("cuda")
    codes = torch.full((n,), 7, dtype=torch.int32, device=dev)
    v32 = torch.randn(n, generator=gen, device=dev)
    mask = masks("0.6", n, G, codes, v32, gen)

    def entry(ops):
        return ops.group_kernels.fused_group_aggregate_lanes(codes, v32, mask, NG)

    def timer(ops):
        return device_ms(lambda: entry(ops), launches=1, runs=1)

    row = {"device_ms": timer(this_ops), "planned_tile": gk.lane_plan(gk.KIND_AGG, NG, G).tile}
    mine = entry(this_ops)
    for root, ops in compared.items():
        compare("fused_group_aggregate_lanes (skewed)", mine, entry(ops), root)
        b1, t1, t2, b2 = (timer(m) for m in (ops, this_ops, this_ops, ops))
        row.setdefault("compared", {})[root] = {"device_ms": [b1, b2], "this_device_ms": [t1, t2]}
    print(f"fused_group_aggregate_lanes n={n} G={G} skewed: {row}", file=sys.stderr, flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--lanes", default="8,64")
    ap.add_argument("--live", default="0.6",
                    help="comma list of masks: a live share, or D-b (the dispatcher's masks)")
    ap.add_argument("--kernels", default=",".join(ENTRIES),
                    help="comma list of the lane entries to sweep at the first --live entry")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-with", metavar="DIR", action="append", default=[],
                    help="a checkout of another commit or design: time its lane entries too")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lane_tiles: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gk.build_all()
    compared = {root: load_checkout(root, f"baikaldb_tpu_torch_compared{i}")
                for i, root in enumerate(args.compare_with)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    res = {"card": card, "rows": args.rows}
    for G in (int(x) for x in args.lanes.split(",")):
        for i, live in enumerate(args.live.split(",")):
            kernels = args.kernels.split(",") if i == 0 else [K2]
            res[f"G{G}" if i == 0 else f"G{G}_{live}"] = sweep(args.rows, G, live, gen,
                                                               compared, kernels)
            torch.cuda.empty_cache()
        if K2 in args.kernels.split(","):
            res[f"G{G}_skewed"] = skewed(args.rows, G, gen, compared)
        torch.cuda.empty_cache()
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
